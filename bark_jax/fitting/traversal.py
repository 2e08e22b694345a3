"""Fixed-shape tree traversal: node masks and node subspaces.

Parity targets: src/bark/fitting/tree_traversal.py:28-86. The reference
returns variable-length index arrays (``terminal_nodes`` /
``singly_internal_nodes``) and walks parent chains with a Python while loop
(``get_node_subspace``); here both become fixed-shape masked computations so
they vectorize over trees and chains.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from bark_jax.fitting.bits import next_power_of_2
from bark_jax.forest import FEAT_CAT, FEAT_INT, Forest


def terminal_mask(tree: Forest) -> jax.Array:
    """Boolean mask of active leaves (src/bark/fitting/tree_traversal.py:28-33)."""
    return tree.active & tree.is_leaf


def singly_internal_mask(tree: Forest) -> jax.Array:
    """Active decision nodes whose both children are leaves.

    Parity: src/bark/fitting/tree_traversal.py:36-46.
    """
    both_children_leaves = tree.is_leaf[tree.left] & tree.is_leaf[tree.right]
    return tree.active & (~tree.is_leaf) & both_children_leaves


def node_subspace(
    tree: Forest,
    node_idx: jax.Array,
    bounds: jax.Array,
    feat_types: jax.Array,
    max_depth: int,
) -> jax.Array:
    """Sub-domain of points that reach ``node_idx``: ``(D, 2)``.

    Walks the parent chain to the root, intersecting bounds at every split:
    bitmask AND for categoricals (with the complement mask computed against
    the next power of two of the *current* subspace upper bound), min/max for
    numerics with a +1 delta on the lower bound of integer right-children.
    Parity: src/bark/fitting/tree_traversal.py:49-86.

    The walk is a fixed ``max_depth``-trip loop masked on reaching the root.
    """
    lower = bounds[:, 0]
    upper = bounds[:, 1]

    def body(_, carry):
        node, lower, upper = carry
        at_root = node == 0
        parent = tree.parent[node]
        f = tree.feature[parent]
        thr = tree.threshold[parent]
        is_left = node == tree.left[parent]

        f_is_cat = feat_types[f] == FEAT_CAT
        f_is_int = feat_types[f] == FEAT_INT

        ub_f = upper[f]
        lb_f = lower[f]

        # categorical: left keeps mask & thr; right keeps mask & ~thr
        # (complement against next_power_of_2(current ub) - 1)
        thr_i = thr.astype(jnp.int32)
        ub_i = ub_f.astype(jnp.int32)
        max_thr = next_power_of_2(ub_i) - 1
        neg_thr = max_thr - thr_i
        cat_ub = jnp.where(is_left, thr_i & ub_i, neg_thr & ub_i).astype(upper.dtype)

        # numeric: left tightens ub to thr; right tightens lb to thr (+1 int)
        int_delta = jnp.where(f_is_int, 1.0, 0.0).astype(lower.dtype)
        num_ub = jnp.where(is_left, jnp.minimum(thr, ub_f), ub_f)
        num_lb = jnp.where(is_left, lb_f, jnp.maximum(thr + int_delta, lb_f))

        new_ub = jnp.where(f_is_cat, cat_ub, num_ub)
        new_lb = jnp.where(f_is_cat, lb_f, num_lb)

        upper = jnp.where(at_root, upper, upper.at[f].set(new_ub))
        lower = jnp.where(at_root, lower, lower.at[f].set(new_lb))
        node = jnp.where(at_root, node, parent)
        return node, lower, upper

    _, lower, upper = jax.lax.fori_loop(
        0, max_depth, body, (node_idx.astype(jnp.int32), lower, upper)
    )
    return jnp.stack([lower, upper], axis=1)


def node_subspace_packed(
    packed: jax.Array,
    node_idx: jax.Array,
    bounds: jax.Array,
    feat_types: jax.Array,
    max_depth: int,
) -> jax.Array:
    """:func:`node_subspace` on a packed ``(node_limit, 8)`` tree with a
    gather/scatter-free body (the "select" hot style).

    Semantically identical to the Forest walk; the per-trip bound update is
    a ``(D,)`` one-hot select instead of a dynamic scatter, per-feature
    reads are one-hot masked sums, and each trip reads two whole packed
    rows (node + parent) instead of five scalar field gathers. Small-shape
    dynamic scatters carried a large fixed cost on the accelerator this was
    first tuned on; at the proposal batch's shapes the selects fuse into
    the surrounding elementwise work.
    """
    D = bounds.shape[0]
    iota_d = jnp.arange(D, dtype=jnp.int32)
    lower = bounds[:, 0]
    upper = bounds[:, 1]
    ft_f32 = feat_types.astype(jnp.float32)

    def body(_, carry):
        node, lower, upper = carry
        at_root = node == 0
        row = packed[node]
        parent = row[5]
        prow = packed[parent]
        f = prow[1]
        thr = jax.lax.bitcast_convert_type(prow[2], jnp.float32)
        is_left = node == prow[3]

        onehot = iota_d == f
        ub_f = jnp.sum(jnp.where(onehot, upper, 0.0))
        lb_f = jnp.sum(jnp.where(onehot, lower, 0.0))
        ftype = jnp.sum(jnp.where(onehot, ft_f32, 0.0))
        f_is_cat = ftype == FEAT_CAT
        f_is_int = ftype == FEAT_INT

        thr_i = thr.astype(jnp.int32)
        ub_i = ub_f.astype(jnp.int32)
        max_thr = next_power_of_2(ub_i) - 1
        neg_thr = max_thr - thr_i
        cat_ub = jnp.where(is_left, thr_i & ub_i, neg_thr & ub_i).astype(
            upper.dtype
        )

        int_delta = jnp.where(f_is_int, 1.0, 0.0).astype(lower.dtype)
        num_ub = jnp.where(is_left, jnp.minimum(thr, ub_f), ub_f)
        num_lb = jnp.where(is_left, lb_f, jnp.maximum(thr + int_delta, lb_f))

        new_ub = jnp.where(f_is_cat, cat_ub, num_ub)
        new_lb = jnp.where(f_is_cat, lb_f, num_lb)

        upd = onehot & ~at_root
        upper = jnp.where(upd, new_ub, upper)
        lower = jnp.where(upd, new_lb, lower)
        node = jnp.where(at_root, node, parent)
        return node, lower, upper

    _, lower, upper = jax.lax.fori_loop(
        0, max_depth, body, (node_idx.astype(jnp.int32), lower, upper)
    )
    return jnp.stack([lower, upper], axis=1)


def node_subspace_doubling(
    packed: jax.Array,
    node_idx: jax.Array,
    bounds: jax.Array,
    feat_types: jax.Array,
    max_depth: int,
) -> jax.Array:
    """:func:`node_subspace` via pointer doubling + parallel reduction.

    The walk's bound intersections are order-independent (min over
    left-ancestor thresholds, max over right-ancestor thresholds, bitwise
    AND of category masks — with the complement taken against the domain's
    power-of-two ceiling, valid by the same ``(M − thr) & U == U & ~thr``
    identity as :func:`child_subspaces`). So instead of a ``max_depth``-trip
    sequential walk, compute the full ancestor chain in ``log2(max_depth)``
    pointer-doubling steps and reduce all contributions at once. Bit-exact
    with the walk.
    """
    nl = packed.shape[0]
    D = bounds.shape[0]
    parent = packed[:, 5]
    parent = jnp.where(jnp.arange(nl, dtype=jnp.int32) == 0, 0, parent)

    # chain[i] = parent^i(node): doubling — chain of length L extends to 2L
    # via one batched gather through parent^L
    chain = node_idx.astype(jnp.int32)[None]
    P = parent
    length = 1
    while length < max_depth:
        chain = jnp.concatenate([chain, P[chain]])
        if 2 * length < max_depth:
            P = P[P]
        length *= 2
    chain = chain[:max_depth]

    anc = chain[1:]  # (max_depth-1,) ancestors (self-looped at root)
    prev = chain[:-1]  # the on-path child of each ancestor
    valid = prev != 0  # contributions stop once the path hits the root

    rows = packed[anc]  # (max_depth-1, 8)
    thr = jax.lax.bitcast_convert_type(rows[:, 2], jnp.float32)
    is_left = prev == rows[:, 3]
    onehot = rows[:, 1:2] == jnp.arange(D, dtype=jnp.int32)[None, :]
    contrib = onehot & valid[:, None]  # (max_depth-1, D)

    lower = bounds[:, 0]
    upper = bounds[:, 1]
    is_int = feat_types == FEAT_INT
    is_cat = feat_types == FEAT_CAT

    big = jnp.float32(jnp.inf)
    ub_cand = jnp.where(contrib & is_left[:, None], thr[:, None], big)
    num_ub = jnp.minimum(upper, jnp.min(ub_cand, axis=0))
    int_delta = jnp.where(is_int, 1.0, 0.0).astype(lower.dtype)
    lb_cand = jnp.where(
        contrib & ~is_left[:, None], thr[:, None] + int_delta[None, :], -big
    )
    num_lb = jnp.maximum(lower, jnp.max(lb_cand, axis=0))

    # categorical: AND of thr (left) / domain-ceiling complement (right)
    M_d = next_power_of_2(upper.astype(jnp.int32)) - 1  # (D,)
    thr_i = thr.astype(jnp.int32)[:, None]
    cat_c = jnp.where(is_left[:, None], thr_i, M_d[None, :] - thr_i)
    cat_c = jnp.where(contrib, cat_c, -1)  # identity for AND
    # tree-reduce the AND in log2 steps (pad to a power of two with -1)
    n_rows = cat_c.shape[0]
    pow2 = 1
    while pow2 < n_rows:
        pow2 *= 2
    cat_c = jnp.concatenate(
        [cat_c, jnp.full((pow2 - n_rows, D), -1, jnp.int32)], axis=0
    )
    while cat_c.shape[0] > 1:
        half = cat_c.shape[0] // 2
        cat_c = cat_c[:half] & cat_c[half:]
    cat_ub = (upper.astype(jnp.int32) & cat_c[0]).astype(upper.dtype)

    new_ub = jnp.where(is_cat, cat_ub, num_ub)
    new_lb = jnp.where(is_cat, lower, num_lb)
    return jnp.stack([new_lb, new_ub], axis=1)


def child_subspaces(
    subspace: jax.Array,
    feat: jax.Array,
    thr: jax.Array,
    feat_types: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Left/right child subspaces of a node with subspace ``(D, 2)`` split by
    ``(feat, thr)`` — one application of the walk body of
    :func:`node_subspace`, top-down.

    Exactness note: the categorical complement is computed against
    ``next_power_of_2(parent ub) - 1``; since the split mask is a subset of
    the parent mask, ``(M - thr) & U == U & ~thr`` for any ``M ⊇ U``, so
    top-down application agrees bit-for-bit with the bottom-up walk (and
    min/max intersection is exactly associative for numerics). This is the
    basis of the sampler's O(1) incremental subspace maintenance.
    """
    lower, upper = subspace[:, 0], subspace[:, 1]
    thr = jnp.asarray(thr).astype(subspace.dtype)
    f_is_cat = feat_types[feat] == FEAT_CAT
    f_is_int = feat_types[feat] == FEAT_INT
    ub_f = upper[feat]
    lb_f = lower[feat]

    thr_i = thr.astype(jnp.int32)
    ub_i = ub_f.astype(jnp.int32)
    max_thr = next_power_of_2(ub_i) - 1
    cat_left_ub = (thr_i & ub_i).astype(upper.dtype)
    cat_right_ub = ((max_thr - thr_i) & ub_i).astype(upper.dtype)

    int_delta = jnp.where(f_is_int, 1.0, 0.0).astype(lower.dtype)
    num_left_ub = jnp.minimum(thr, ub_f)
    num_right_lb = jnp.maximum(thr + int_delta, lb_f)

    left_ub = jnp.where(f_is_cat, cat_left_ub, num_left_ub)
    right_ub = jnp.where(f_is_cat, cat_right_ub, ub_f)
    right_lb = jnp.where(f_is_cat, lb_f, num_right_lb)

    left = subspace.at[feat, 1].set(left_ub)
    right = subspace.at[feat, 0].set(right_lb).at[feat, 1].set(right_ub)
    return left, right


def all_node_subspaces(
    tree: Forest,
    bounds: jax.Array,
    feat_types: jax.Array,
    max_depth: int,
) -> jax.Array:
    """Subspaces of every node slot: ``(node_limit, D, 2)``.

    One-time initialization for the sampler's incremental subspace carry
    (rows of inactive slots are whatever the walk returns for them and are
    never read — proposals only target active nodes, and grow overwrites
    the rows of newly activated slots).
    """
    node_limit = tree.is_leaf.shape[-1]
    return jax.vmap(
        lambda n: node_subspace(tree, n, bounds, feat_types, max_depth)
    )(jnp.arange(node_limit, dtype=jnp.int32))
