"""Vectorized grow/prune/change proposals over fixed-shape trees.

Parity target: src/bark/fitting/tree_proposals.py:21-256. The reference's
jitclass + Python-branch machinery becomes one branch-free function
:func:`propose_tree` computing, under masks:

  - the move type (weighted categorical draw),
  - a uniform pick from the valid node set (terminal nodes for grow,
    singly-internal nodes for prune/change),
  - a splitting rule sampled inside the node's subspace (bitmask subset for
    categoricals, integer/uniform draw otherwise),
  - the transition ratio ``tree_q_ratio`` and depth-prior ratio
    ``tree_prior_ratio`` in closed form (the post-grow singly-internal count
    is derived analytically instead of re-growing the tree), and
  - the structural edit as masked scatter updates.

Invalid proposals (empty valid set, degenerate categorical/integer split,
tree at node capacity, node at the depth cap) yield ``log_q_prior = -inf``,
exactly mirroring the reference's early returns
(tree_proposals.py:207-236) plus the two fixed-shape capacity rejections
(the reference raises OverflowError at capacity instead,
tree_proposals.py:58).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bark_jax.fitting.bits import popcount, sample_binary_mask, scatter_bits
from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.traversal import (
    child_subspaces,
    node_subspace,
    node_subspace_doubling,
    node_subspace_packed,
    singly_internal_mask,
    terminal_mask,
)
from bark_jax.forest import FEAT_CAT, FEAT_INT, Forest

GROW, PRUNE, CHANGE = 0, 1, 2


class ProposalNoise(NamedTuple):
    """All randomness one tree proposal consumes, pre-drawn.

    The sampler's scan is latency-bound on sequential op count; every
    ``jax.random`` call inside the loop costs threefry rounds on the
    critical path. Pre-drawing the noise for all m moves before the scan
    (one vectorized batch) and feeding it through scan xs leaves only
    cheap arithmetic (cdf compare, masked argmax, affine transforms) in
    the loop. Distributions are identical to the keyed path; bitstreams
    differ (RNG parity with the reference is statistical anyway,
    SURVEY.md 7.1.8).
    """

    u_move: jax.Array  # uniform [0,1) — move-type cdf draw
    g_node: jax.Array  # (node_limit,) gumbel — masked categorical via argmax
    u_feat: jax.Array  # uniform — feature index
    u_cat: jax.Array  # uniform — categorical subset rank
    u_int: jax.Array  # uniform — integer threshold
    u_cont: jax.Array  # uniform — continuous threshold
    u_accept: jax.Array  # uniform — MH accept draw (consumed by the sampler)


def make_proposal_noise(
    key: jax.Array, num_moves: int, node_limit: int
) -> ProposalNoise:
    """Draw the full noise bundle for ``num_moves`` proposals (leading axis)."""
    ks = jax.random.split(key, 7)
    shape = (num_moves,)
    return ProposalNoise(
        u_move=jax.random.uniform(ks[0], shape),
        g_node=jax.random.gumbel(ks[1], (num_moves, node_limit)),
        u_feat=jax.random.uniform(ks[2], shape),
        u_cat=jax.random.uniform(ks[3], shape),
        u_int=jax.random.uniform(ks[4], shape),
        u_cont=jax.random.uniform(ks[5], shape),
        u_accept=jax.random.uniform(ks[6], shape),
    )


def masked_choice(key: jax.Array, mask: jax.Array) -> jax.Array:
    """Uniform draw from the True entries of mask (0 if mask is empty)."""
    logits = jnp.where(mask, 0.0, -jnp.inf)
    return jax.random.categorical(key, logits).astype(jnp.int32)


def masked_choice_gumbel(gumbel: jax.Array, mask: jax.Array) -> jax.Array:
    """Uniform draw from mask via pre-drawn gumbel noise (argmax trick)."""
    return jnp.argmax(jnp.where(mask, gumbel, -jnp.inf)).astype(jnp.int32)


def sample_splitting_rule(
    key: jax.Array, subspace: jax.Array, feat_types: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Sample (feature_idx, threshold) uniformly within a subspace.

    Parity: src/bark/fitting/tree_proposals.py:78-97. All three feature-type
    branches are computed and selected (no data-dependent control flow).
    Degenerate results (0 for categoricals, the upper bound for integers) are
    the caller's rejection indicators, as in the reference.
    """
    k_feat, k_cat, k_int, k_cont = jax.random.split(key, 4)
    d = subspace.shape[0]
    feat = jax.random.randint(k_feat, (), 0, d)
    lb = subspace[feat, 0]
    ub = subspace[feat, 1]

    cat_thr = sample_binary_mask(k_cat, ub.astype(jnp.int32)).astype(subspace.dtype)

    lb_i = lb.astype(jnp.int32)
    ub_i = ub.astype(jnp.int32)
    int_draw = jax.random.randint(k_int, (), lb_i, jnp.maximum(ub_i, lb_i + 1))
    int_thr = jnp.where(lb_i == ub_i, ub_i, int_draw).astype(subspace.dtype)

    cont_thr = jax.random.uniform(
        k_cont, (), dtype=subspace.dtype, minval=lb, maxval=ub
    )

    ftype = feat_types[feat]
    thr = jnp.where(
        ftype == FEAT_CAT, cat_thr, jnp.where(ftype == FEAT_INT, int_thr, cont_thr)
    )
    return feat.astype(jnp.int32), thr


def sample_splitting_rule_noise(
    noise: ProposalNoise, subspace: jax.Array, feat_types: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """:func:`sample_splitting_rule` from pre-drawn uniforms — same
    distributions, zero in-loop RNG."""
    d = subspace.shape[0]
    feat = jnp.minimum(
        (noise.u_feat * d).astype(jnp.int32), jnp.int32(d - 1)
    )
    lb = subspace[feat, 0]
    ub = subspace[feat, 1]
    ftype = feat_types[feat]
    thr = _sample_split_from_bounds(noise, lb, ub, ftype, subspace.dtype)
    return feat, thr


def _sample_split_from_bounds(
    noise: ProposalNoise, lb: jax.Array, ub: jax.Array, ftype: jax.Array, dtype
) -> jax.Array:
    """Threshold draw given the chosen feature's (lb, ub, type) scalars —
    the bounds-read-free core of :func:`sample_splitting_rule_noise`."""
    # categorical: uniform proper non-empty subset of the available mask
    # (bit_operations.py:34-58 semantics: rank r uniform in [1, 2^c - 2])
    ub_mask = ub.astype(jnp.int32)
    c = popcount(ub_mask)
    max_sample = jnp.left_shift(jnp.int32(1), c) - 1
    span = jnp.maximum(max_sample - 1, 1)
    r = jnp.int32(1) + jnp.minimum(
        (noise.u_cat * span.astype(jnp.float32)).astype(jnp.int32), span - 1
    )
    cat_thr = scatter_bits(r, ub_mask, c).astype(dtype)

    lb_i = lb.astype(jnp.int32)
    ub_i = ub.astype(jnp.int32)
    ispan = (ub_i - lb_i).astype(jnp.float32)
    int_draw = lb_i + jnp.minimum(
        (noise.u_int * ispan).astype(jnp.int32), jnp.maximum(ub_i - lb_i - 1, 0)
    )
    int_thr = jnp.where(lb_i == ub_i, ub_i, int_draw).astype(dtype)

    cont_thr = lb + noise.u_cont * (ub - lb)

    return jnp.where(
        ftype == FEAT_CAT, cat_thr, jnp.where(ftype == FEAT_INT, int_thr, cont_thr)
    )


def _first_two_inactive(active: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Indices of the first two inactive node slots, and whether two exist.

    Parity: src/bark/fitting/tree_proposals.py:45-58 (free-list allocation).
    """
    inactive = ~active
    i1 = jnp.argmax(inactive).astype(jnp.int32)
    inactive2 = inactive.at[i1].set(False)
    i2 = jnp.argmax(inactive2).astype(jnp.int32)
    has_two = jnp.sum(inactive.astype(jnp.int32)) >= 2
    return i1, i2, has_two


def _first_two_inactive_select(
    active: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Scatter-free :func:`_first_two_inactive` (the "select" hot style)."""
    inactive = ~active
    iota = jnp.arange(active.shape[0], dtype=jnp.int32)
    i1 = jnp.argmax(inactive).astype(jnp.int32)
    i2 = jnp.argmax(inactive & (iota != i1)).astype(jnp.int32)
    has_two = jnp.sum(inactive.astype(jnp.int32)) >= 2
    return i1, i2, has_two


def _grow(tree: Forest, n: jax.Array, i1, i2, feat, thr) -> Forest:
    """Grow leaf ``n`` into an internal node with two fresh leaf children.

    Parity: src/bark/fitting/tree_proposals.py:146-166.
    """
    d = tree.depth[n]
    return Forest(
        is_leaf=tree.is_leaf.at[i1].set(True).at[i2].set(True).at[n].set(False),
        feature=tree.feature.at[i1].set(0).at[i2].set(0).at[n].set(feat),
        threshold=tree.threshold.at[i1].set(0.0).at[i2].set(0.0).at[n].set(thr),
        left=tree.left.at[i1].set(0).at[i2].set(0).at[n].set(i1),
        right=tree.right.at[i1].set(0).at[i2].set(0).at[n].set(i2),
        parent=tree.parent.at[i1].set(n).at[i2].set(n),
        depth=tree.depth.at[i1].set(d + 1).at[i2].set(d + 1),
        active=tree.active.at[i1].set(True).at[i2].set(True),
    )


def _prune(tree: Forest, n: jax.Array) -> Forest:
    """Collapse singly-internal node ``n`` back into a leaf.

    Parity: src/bark/fitting/tree_proposals.py:169-176.
    """
    l, r = tree.left[n], tree.right[n]
    return tree._replace(
        active=tree.active.at[l].set(False).at[r].set(False),
        is_leaf=tree.is_leaf.at[n].set(True),
    )


def _change(tree: Forest, n: jax.Array, feat, thr) -> Forest:
    """Resample the splitting rule at node ``n``.

    Parity: src/bark/fitting/tree_proposals.py:179-183.
    """
    return tree._replace(
        feature=tree.feature.at[n].set(feat),
        threshold=tree.threshold.at[n].set(thr),
    )


def _select_tree(pred: jax.Array, a: Forest, b: Forest) -> Forest:
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def propose_tree_packed(
    key: jax.Array,
    packed: jax.Array,
    bounds: jax.Array,
    feat_types: jax.Array,
    params: SamplerParams,
    subspace_tree: jax.Array | None = None,
    noise: ProposalNoise | None = None,
):
    """One grow/prune/change proposal on a packed ``(node_limit, 8)`` tree.

    The hot-loop variant: decision logic reads unpacked field views (fused
    slices), structural edits are whole-row scatters on the packed array —
    a handful of ops per move instead of dozens (the sampler scan is
    latency-bound on op count).

    ``subspace_tree`` (``(node_limit, D, 2)``, optional) enables O(1)
    incremental subspace maintenance: the target node's subspace is one
    gather instead of a ``max_depth``-trip parent-chain walk (the walk costs
    ~32 sequential scatters per move), and
    the two affected child rows are recomputed top-down
    (:func:`bark_jax.fitting.traversal.child_subspaces` — bit-exact with
    the walk). Returns ``(new_packed, new_subspace_tree, log_q_prior, move,
    node_idx)`` when given, else ``(new_packed, log_q_prior, move,
    node_idx)``.
    Parity: src/bark/fitting/tree_proposals.py:186-256.
    """
    from bark_jax.forest import unpack_forest

    tree = unpack_forest(packed)
    if noise is None:
        k_noise, _ = jax.random.split(key)
        noise = jax.tree.map(
            lambda a: a[0], make_proposal_noise(k_noise, 1, packed.shape[0])
        )

    weights = jnp.array(params.proposal_weights, dtype=jnp.float32)
    cdf = jnp.cumsum(weights) / jnp.sum(weights)
    move = jnp.sum((noise.u_move >= cdf[:2]).astype(jnp.int32))

    term = terminal_mask(tree)
    si = singly_internal_mask(tree)
    is_grow = move == GROW
    is_prune = move == PRUNE

    # "select" hot style: gather/scatter-free reads and edits (one-hot
    # selects); "scatter" keeps dynamic slices + scatters. "walk_select"
    # switches only the subspace walk. Trajectory-identical — only the
    # lowering differs.
    select_walk = params.hot_style in ("walk_select", "select")
    select_edit = params.hot_style == "select"
    doubling_walk = params.hot_style == "doubling"

    valid = jnp.where(is_grow, term, si)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    n = masked_choice_gumbel(noise.g_node, valid)

    if subspace_tree is None:
        if doubling_walk:
            subspace = node_subspace_doubling(
                packed, n, bounds, feat_types, params.max_depth
            )
        elif select_walk:
            subspace = node_subspace_packed(
                packed, n, bounds, feat_types, params.max_depth
            )
        else:
            subspace = node_subspace(
                tree, n, bounds, feat_types, params.max_depth
            )
    else:
        subspace = subspace_tree[n]

    d = bounds.shape[0]
    feat = jnp.minimum((noise.u_feat * d).astype(jnp.int32), jnp.int32(d - 1))
    if select_edit:
        onehot_d = jnp.arange(d, dtype=jnp.int32) == feat
        lb = jnp.sum(jnp.where(onehot_d, subspace[:, 0], 0.0))
        ub = jnp.sum(jnp.where(onehot_d, subspace[:, 1], 0.0))
        ftype = jnp.sum(jnp.where(onehot_d, feat_types, 0))
    else:
        lb, ub, ftype = subspace[feat, 0], subspace[feat, 1], feat_types[feat]
    thr = _sample_split_from_bounds(noise, lb, ub, ftype, subspace.dtype)

    invalid_split = ((ftype == FEAT_CAT) & (thr == 0)) | (
        (ftype == FEAT_INT) & (thr == ub)
    )

    if select_edit:
        row_n = packed[n]
        parent_n, depth_n = row_n[5], row_n[6]
        l, r = row_n[3], row_n[4]
        i1, i2, has_two = _first_two_inactive_select(tree.active)
    else:
        parent_n, depth_n = tree.parent[n], tree.depth[n]
        l, r = tree.left[n], tree.right[n]
        i1, i2, has_two = _first_two_inactive(tree.active)
    depth_ok = depth_n + 1 <= params.max_depth

    reject = (
        (n_valid == 0)
        | ((~is_prune) & invalid_split)
        | (is_grow & (~has_two | ~depth_ok))
    )

    # --- transition ratio (tree_proposals.py:100-117) ---------------------
    w0 = jnp.sum(term.astype(jnp.float32))
    w1 = jnp.sum(si.astype(jnp.float32))
    if select_edit:
        iota_nodes = jnp.arange(packed.shape[0], dtype=jnp.int32)
        parent_si = jnp.any((iota_nodes == parent_n) & si)
    else:
        parent_si = si[parent_n]
    parent_was_si = (n != 0) & parent_si
    w1_star = w1 + 1.0 - parent_was_si.astype(jnp.float32)
    grow_q = jnp.log(w0) - jnp.log(w1_star)
    prune_q = jnp.log(w1) - jnp.log(jnp.maximum(w0 - 1.0, 1.0))
    log_q_ratio = jnp.where(is_grow, grow_q, jnp.where(is_prune, prune_q, 0.0))

    # --- depth-prior ratio (tree_proposals.py:120-143) --------------------
    alpha, beta = params.alpha, params.beta
    d_f = depth_n.astype(jnp.float32)
    pr = (
        jnp.log(alpha)
        + 2.0 * jnp.log(1.0 - alpha / (2.0 + d_f) ** beta)
        - jnp.log((1.0 + d_f) ** beta - alpha)
    )
    log_prior_ratio = jnp.where(is_grow, pr, jnp.where(is_prune, -pr, 0.0))

    # --- structural edit: whole-row scatters on the packed tree -----------
    thr_bits = jax.lax.bitcast_convert_type(
        thr.astype(jnp.float32), jnp.int32
    )
    zero = jnp.int32(0)
    one = jnp.int32(1)
    d1 = depth_n + 1
    child_row = jnp.stack([one, zero, zero, zero, zero, n, d1, one])
    parent_row = jnp.stack(
        [zero, feat, thr_bits, i1, i2, parent_n, depth_n, one]
    )
    if select_edit:
        iota = jnp.arange(packed.shape[0], dtype=jnp.int32)[:, None]
        col = jnp.arange(8, dtype=jnp.int32)[None, :]
        is_n = iota == n
        grown = jnp.where((iota == i1) | (iota == i2), child_row[None, :], packed)
        grown = jnp.where(is_n, parent_row[None, :], grown)
        pruned = jnp.where(((iota == l) | (iota == r)) & (col == 7), 0, packed)
        pruned = jnp.where(is_n & (col == 0), 1, pruned)
        changed = jnp.where(is_n & (col == 1), feat, packed)
        changed = jnp.where(is_n & (col == 2), thr_bits, changed)
    else:
        grown = packed.at[i1].set(child_row).at[i2].set(child_row).at[n].set(
            parent_row
        )
        pruned = packed.at[l, 7].set(0).at[r, 7].set(0).at[n, 0].set(1)
        changed = packed.at[n, 1].set(feat).at[n, 2].set(thr_bits)

    proposed = jnp.where(
        is_grow, grown, jnp.where(is_prune, pruned, changed)
    )
    new_packed = jnp.where(reject, packed, proposed)

    log_q_prior = jnp.where(reject, -jnp.inf, log_q_ratio + log_prior_ratio)
    if subspace_tree is None:
        return new_packed, log_q_prior, move, n

    # --- incremental subspace rows for the (re)split children --------------
    left_sub, right_sub = child_subspaces(subspace, feat, thr, feat_types)
    # grow writes fresh slots i1/i2; change rewrites the existing children;
    # prune deactivates children (their stale rows are never read).
    ci1 = jnp.where(is_grow, i1, l)
    ci2 = jnp.where(is_grow, i2, r)
    touch = (~reject) & (~is_prune)
    sub_updated = subspace_tree.at[ci1].set(left_sub).at[ci2].set(right_sub)
    new_subspace_tree = jnp.where(touch, sub_updated, subspace_tree)
    return new_packed, new_subspace_tree, log_q_prior, move, n


def propose_tree(
    key: jax.Array,
    tree: Forest,
    bounds: jax.Array,
    feat_types: jax.Array,
    params: SamplerParams,
    return_move: bool = False,
):
    """Forest-typed wrapper around :func:`propose_tree_packed`.

    ``tree`` fields have shape ``(node_limit,)``. Returns the proposed tree
    and ``log_q_prior = log q-ratio + log prior-ratio`` (-inf on rejection);
    with ``return_move=True`` also the move code and target node index.
    Parity: src/bark/fitting/tree_proposals.py:186-256.
    """
    from bark_jax.forest import pack_forest, unpack_forest

    new_packed, log_q_prior, move, n = propose_tree_packed(
        key, pack_forest(tree), bounds, feat_types, params
    )
    new_tree = unpack_forest(new_packed)
    if return_move:
        return new_tree, log_q_prior, move, n
    return new_tree, log_q_prior
