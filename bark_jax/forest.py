"""Fixed-shape forest encoding and leaf-agreement kernel.

A forest is a struct-of-arrays of ``(..., m, node_limit)`` int32/float32 fields
(:class:`Forest`), designed so that every operation on it — leaf routing, Gram
matrix evaluation, structural MCMC edits — is a fixed-shape, branch-free JAX
program amenable to ``jit``/``vmap``/``scan`` and XLA fusion.

Behavioral parity with the reference implementation (TobyBoyne/bark):
  - node record fields mirror ``src/bark/forest.py:8-19`` (NODE_RECORD_DTYPE),
    but as separate arrays instead of a structured numpy dtype;
  - categorical splits are bitmask tests ``(1 << x) & threshold``
    (``src/bark/forest.py:38-40``); continuous/integer splits are
    ``x <= threshold`` (``src/bark/forest.py:42``);
  - the agreement kernel is the fraction of trees in which two points share a
    leaf (``src/bark/forest.py:78-89``), with an optional "no-null-tree"
    rescaling (``src/bark/forest.py:101-111``).

Design deltas (not a port):
  - routing is a fixed-trip-count gather loop (``max_depth`` iterations)
    instead of a data-dependent while loop;
  - the Gram matrix is a one-hot × one-hot matmul (a dense GEMM for the
    matrix units) instead of an O(N·M·m) elementwise comparison loop;
  - trees deeper than ``max_depth`` are excluded by construction (the sampler
    rejects grow moves past the cap), so the fixed trip count is exact.

Categorical features are capped at 24 categories so that bitmask thresholds
are exactly representable in float32 (the reference shares this implicit cap
by storing bitmasks in a float32 threshold field).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Feature type codes, matching the reference enum
# (src/bark/forest.py:22-25: Cat=0, Int=1, Cont=2).
FEAT_CAT = 0
FEAT_INT = 1
FEAT_CONT = 2

DEFAULT_NODE_LIMIT = 64
DEFAULT_MAX_DEPTH = 16
MAX_CATEGORIES = 24


class Forest(NamedTuple):
    """Struct-of-arrays forest with leading shape ``(..., m, node_limit)``.

    Fields mirror the reference's NODE_RECORD_DTYPE (src/bark/forest.py:8-19).
    ``threshold`` doubles as a categorical bitmask (exact in float32 for up to
    24 categories). ``parent`` of the root is 0 (the reference stores -1 but
    never reads it; we guard explicitly where it matters).
    """

    is_leaf: jax.Array  # bool
    feature: jax.Array  # int32
    threshold: jax.Array  # float32
    left: jax.Array  # int32
    right: jax.Array  # int32
    parent: jax.Array  # int32
    depth: jax.Array  # int32
    active: jax.Array  # bool

    @property
    def num_trees(self) -> int:
        return self.is_leaf.shape[-2]

    @property
    def node_limit(self) -> int:
        return self.is_leaf.shape[-1]

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return self.is_leaf.shape[:-2]


def create_empty_forest(
    m: int, node_limit: int = DEFAULT_NODE_LIMIT, batch_shape: tuple[int, ...] = ()
) -> Forest:
    """All-stump forest: each tree is a single active root leaf.

    Parity: src/bark/forest.py:114-117 (root node ``(1,0,0,0,0,-1,0,1)``).
    """
    shape = (*batch_shape, m, node_limit)
    zeros_i = jnp.zeros(shape, jnp.int32)
    zeros_f = jnp.zeros(shape, jnp.float32)
    root = jnp.zeros(shape, jnp.bool_).at[..., 0].set(True)
    return Forest(
        is_leaf=root,
        feature=zeros_i,
        threshold=zeros_f,
        left=zeros_i,
        right=zeros_i,
        parent=zeros_i,
        depth=zeros_i,
        active=root,
    )


def _split_decision(
    x_feat: jax.Array, threshold: jax.Array, is_cat: jax.Array
) -> jax.Array:
    """Per-node split decision; True -> go left.

    Parity: src/bark/forest.py:37-42 — categorical: ``(1 << x) & mask``;
    numeric: ``x <= threshold``.
    """
    bit = jnp.left_shift(jnp.int32(1), x_feat.astype(jnp.int32))
    cat_cond = (bit & threshold.astype(jnp.int32)) != 0
    num_cond = x_feat <= threshold
    return jnp.where(is_cat, cat_cond, num_cond)


@functools.partial(jax.jit, static_argnames=("max_depth",))
def route_tree(
    tree: Forest,
    X: jax.Array,
    feat_types: jax.Array,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> jax.Array:
    """Route data through one tree; returns leaf node index per row.

    ``tree`` fields have shape ``(node_limit,)``; ``X`` is ``(N, D)``.
    Parity: src/bark/forest.py:28-55 (``_pass_one_through_tree`` /
    ``pass_through_tree``), as a fixed-trip-count gather loop.
    """
    n = X.shape[0]
    is_cat = feat_types == FEAT_CAT

    def body(_, node_idx):
        feat = tree.feature[node_idx]  # (N,)
        thr = tree.threshold[node_idx]
        x_val = jnp.take_along_axis(X, feat[:, None], axis=1)[:, 0]
        go_left = _split_decision(x_val, thr, is_cat[feat])
        child = jnp.where(go_left, tree.left[node_idx], tree.right[node_idx])
        return jnp.where(tree.is_leaf[node_idx], node_idx, child)

    return jax.lax.fori_loop(0, max_depth, body, jnp.zeros((n,), jnp.int32))


@functools.partial(jax.jit, static_argnames=("max_depth",))
def route_forest(
    forest: Forest,
    X: jax.Array,
    feat_types: jax.Array,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> jax.Array:
    """Route data through every tree; returns ``(N, m)`` leaf indices.

    Parity: src/bark/forest.py:58-67 (``pass_through_forest``).
    Forest fields must have shape ``(m, node_limit)``.
    """
    routed = jax.vmap(lambda t: route_tree(t, X, feat_types, max_depth))(forest)
    return routed.T  # (m, N) -> (N, m)


@functools.partial(jax.jit, static_argnames=("max_depth",))
def route_forest_select(
    forest: Forest,
    X: jax.Array,
    feat_types: jax.Array,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> jax.Array:
    """``route_forest`` lowered as one-hot transition matmuls (big batches).

    The gather-loop walk (:func:`route_tree`) lowers each trip as several
    dynamic gathers; where gathers carry a large fixed cost this form wins.
    Here every split decision is precomputed with one bulk gather per tree,
    and the walk itself advances a one-hot node distribution through
    per-tree left/right transition matrices:

        next = oh * is_leaf + (oh * dec) @ Lmat + (oh * (1 - dec)) @ Rmat

    — all matmuls, no gathers in the loop. Identical results to
    ``route_forest`` (tested; the 0/1 operands are exact at any matmul
    precision). Forest fields must be ``(m, node_limit)``; returns
    ``(N, m)`` leaf indices. Which router a platform uses is
    :func:`router_for`'s choice.
    """
    m, L = forest.feature.shape
    b = X.shape[0]

    is_cat = (feat_types == FEAT_CAT)[forest.feature]  # (m, L)
    stay = forest.is_leaf.astype(jnp.float32)[None]  # (1, m, L)
    Lmat = jax.nn.one_hot(forest.left, L, dtype=jnp.float32)  # (m, L, L)
    Rmat = jax.nn.one_hot(forest.right, L, dtype=jnp.float32)

    def walk(Xb):
        # one bulk gather, NOT a one-hot matmul: a default-precision
        # matmul may round its operands (bf16 passes, TF32 on the H100),
        # which would round the feature VALUES before the threshold
        # comparison and misroute points near split boundaries (observed
        # as a silently degraded BO trajectory). The 0/1 transition
        # matmuls below are exact; data values must never pass through a
        # matmul here.
        xval = jnp.take(Xb, forest.feature, axis=1)  # (Bb, m, L)
        dec = _split_decision(
            xval, forest.threshold[None], is_cat[None]
        ).astype(jnp.float32)  # (Bb, m, L)
        oh0 = jnp.zeros((Xb.shape[0], m, L), jnp.float32)
        oh0 = oh0.at[:, :, 0].set(1.0)

        def body(_, oh):
            go = oh * (1.0 - stay)
            left_next = jnp.einsum("bml,mln->bmn", go * dec, Lmat)
            right_next = jnp.einsum("bml,mln->bmn", go * (1.0 - dec), Rmat)
            return oh * stay + left_next + right_next

        oh = jax.lax.fori_loop(0, max_depth, body, oh0)
        return jnp.argmax(oh, axis=-1).astype(jnp.int32)  # (Bb, m)

    # The walk's live transients are several (B, m, L) f32 buffers; at
    # large B (x a chains vmap on top) they blow device memory — (128
    # chains, 4096, 50, 64) compiled to 4 x 6.25 GB temps. Chunk the
    # rows through a lax.map past 2048 so the transient is one block's
    # (blocks are independent: the walk carries nothing across rows).
    if b <= 2048:
        return walk(X)
    blk = 1024
    pad = (-b) % blk
    Xp = jnp.pad(X, ((0, pad), (0, 0)))
    leaves = jax.lax.map(walk, Xp.reshape(-1, blk, X.shape[1]))
    return leaves.reshape(-1, m)[:b]


def leaf_onehot(leaves: jax.Array, node_limit: int, dtype=jnp.float32) -> jax.Array:
    """One-hot of leaf indices over node slots: ``(..., node_limit)``.

    Columns of empty leaf slots are identically zero, so
    ``leaf_onehot @ leaf_onehot.T`` equals the leaf co-occurrence matrix used
    by the reference's ``get_leaf_vectors`` (src/bark/forest.py:70-75), which
    enumerates only occupied leaves — zero columns contribute nothing.
    """
    return jax.nn.one_hot(leaves, node_limit, dtype=dtype)


def leaf_rank_targets(
    forest_sample: Forest,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Per-tree dense leaf ranks: ``(tmask, ranks, counts)``.

    ``ranks[j, l]`` is the node-order rank of leaf slot ``l`` among tree
    j's active leaves (junk at non-leaf slots — mask with ``tmask``);
    ``counts[j]`` the tree's leaf count. The shared first stage of every
    compact-indicator packing (sampler budget packing and the per-tree
    block packing below).
    """
    tmask = forest_sample.active & forest_sample.is_leaf  # (m, node_limit)
    ranks = jnp.cumsum(tmask, axis=-1).astype(jnp.int32) - 1
    counts = jnp.sum(tmask, axis=-1).astype(jnp.int32)
    return tmask, ranks, counts


def indicator_from_targets(
    leaves: jax.Array, target: jax.Array, out_dim: int
) -> jax.Array:
    """(B, out_dim) 0/1 indicators: point i, tree j lights column
    ``target[j, leaves[i, j]]`` (targets >= out_dim project to nothing).

    Lowered as the per-node one-hot against a (m * node_limit, out_dim)
    0/1 projection — one matmul, no gathers, no scatters (bf16 operands
    with f32 accumulation keep counts exact; the gather/scatter lowerings
    measured slower at batch scale in the first tuning round).
    """
    m, node_limit = target.shape
    P = jax.nn.one_hot(target.reshape(-1), out_dim, dtype=jnp.bfloat16)
    E = leaf_onehot(leaves, node_limit, jnp.bfloat16).reshape(
        leaves.shape[0], m * node_limit
    )
    return jax.lax.dot_general(
        E, P,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def compact_leaf_indicator(
    forest_sample: Forest,
    leaves: jax.Array,
    max_leaves: int,
) -> jax.Array:
    """(B, m * max_leaves) 0/1 leaf indicators with per-tree DENSE ranks.

    Tree j's active leaves get ranks 0..L_j-1 (node order) packed into the
    block ``[j * max_leaves, (j+1) * max_leaves)``; with
    ``max_leaves = (node_limit + 1) // 2`` (the exact per-tree leaf cap of
    a binary tree on node_limit slots) the packing is always injective, so
    ``Z Z^T`` equals ``m * gram`` exactly for ANY forest — no budget
    assumption, unlike the sampler's guarded global packing.
    """
    m = forest_sample.is_leaf.shape[-2]
    r = m * max_leaves
    tmask, ranks, _ = leaf_rank_targets(forest_sample)
    base = max_leaves * jnp.arange(m, dtype=jnp.int32)[:, None]
    target = jnp.where(tmask, base + ranks, r)  # non-leaf slots -> zero row
    return indicator_from_targets(leaves, target, r)


#: Leaf router per JAX platform. Both routers return identical leaf ids
#: (tests/test_forest.py), so the entry is a speed choice only. CPU: the
#: gather walk (the select router's O(B*m*L^2) transition matmuls lose
#: badly there). GPU: the faster of the two timed on an H100 at the
#: acquisition-scoring and sampler-init shapes (PERF.md, Findings).
_ROUTERS = {"cpu": route_forest, "gpu": route_forest}


def router_for(platform: str | None = None):
    """The leaf router for ``platform`` (default: JAX's default backend).

    Raises ``ValueError`` for a platform no router was chosen for, rather
    than guessing: a silent default is how the GPU once inherited the
    CPU's choice.
    """
    platform = platform or jax.default_backend()
    try:
        return _ROUTERS[platform]
    except KeyError:
        raise ValueError(
            f"no leaf router chosen for platform {platform!r}; "
            f"known: {sorted(_ROUTERS)}"
        ) from None


def route_forest_auto(
    forest: Forest,
    X: jax.Array,
    feat_types: jax.Array,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> jax.Array:
    """Leaf routing through the platform's router (:func:`router_for`)."""
    return router_for()(forest, X, feat_types, max_depth)


@functools.partial(jax.jit, static_argnames=("node_limit", "onehot_dtype"))
def gram_from_leaves(
    leaves1: jax.Array,
    leaves2: jax.Array,
    node_limit: int,
    mask1: jax.Array | None = None,
    mask2: jax.Array | None = None,
    onehot_dtype=jnp.float32,
) -> jax.Array:
    """Agreement Gram matrix from leaf assignments.

    ``leaves1`` is ``(N, m)``, ``leaves2`` is ``(M, m)``; returns ``(N, M)``
    with entries = fraction of trees in which the two rows share a leaf.
    Parity: src/bark/forest.py:78-89 (``forest_gram_matrix``), computed as a
    one-hot × one-hot matmul (inner dim ``m * node_limit``), one GEMM for
    XLA; counts are exact in float32 (0/1 values, sums <= m).

    ``onehot_dtype=bfloat16`` keeps the counts bit-identical (0/1 operands
    are exact in bf16 and the product accumulates in float32 via
    ``preferred_element_type``) while halving the matmul's input traffic and
    using the faster bf16 path — only material once the gram matmul is
    compute-bound (large N).

    ``mask1``/``mask2`` zero out rows/columns for padded data points — the
    fixed-shape BO path pads the training set to a bucket size so XLA
    recompiles only at bucket boundaries, and masked points must contribute
    nothing to the kernel.
    """
    n, m = leaves1.shape
    z1 = leaf_onehot(leaves1, node_limit, onehot_dtype).reshape(
        n, m * node_limit
    )
    z2 = leaf_onehot(leaves2, node_limit, onehot_dtype).reshape(
        leaves2.shape[0], m * node_limit
    )
    if mask1 is not None:
        z1 = z1 * mask1[:, None].astype(z1.dtype)
    if mask2 is not None:
        z2 = z2 * mask2[:, None].astype(z2.dtype)
    counts = jax.lax.dot_general(
        z1,
        z2,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return counts / m


@functools.partial(jax.jit, static_argnames=("max_depth",))
def forest_gram_matrix(
    forest: Forest,
    x1: jax.Array,
    x2: jax.Array,
    feat_types: jax.Array,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> jax.Array:
    """Agreement Gram matrix between two data sets under one forest.

    Parity: src/bark/forest.py:78-89.
    """
    l1 = route_forest_auto(forest, x1, feat_types, max_depth)
    l2 = route_forest_auto(forest, x2, feat_types, max_depth)
    return gram_from_leaves(l1, l2, forest.node_limit)


def batched_forest_gram_matrix(
    forest: Forest,
    x1: jax.Array,
    x2: jax.Array,
    feat_types: jax.Array,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> jax.Array:
    """Gram matrices for a batch of forests: fields ``(B, m, node_limit)``.

    Parity: src/bark/forest.py:92-98.
    """
    return jax.vmap(
        lambda f: forest_gram_matrix(f, x1, x2, feat_types, max_depth)
    )(forest)


def num_null_trees(forest: Forest) -> jax.Array:
    """Number of single-leaf ("null") trees per forest in the batch."""
    return jnp.sum(forest.is_leaf[..., 0].astype(jnp.int32), axis=-1)


def batched_forest_gram_matrix_no_null(
    forest: Forest,
    x1: jax.Array,
    x2: jax.Array,
    feat_types: jax.Array,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> jax.Array:
    """Gram matrix with single-leaf trees rescaled away.

    Parity: src/bark/forest.py:101-111 — subtract the constant contribution of
    null trees and rescale by ``m / max(m - num_null, 1)``.
    """
    sim = batched_forest_gram_matrix(forest, x1, x2, feat_types, max_depth)
    m = forest.num_trees
    n_null = num_null_trees(forest).astype(sim.dtype)[..., None, None]
    scale = m / jnp.maximum(m - n_null, 1.0)
    return (sim - n_null / m) * scale


def pack_forest(forest: Forest) -> jax.Array:
    """Pack the 8 SoA fields into one int32 array ``(..., m, node_limit, 8)``.

    The sampler's hot loop carries the packed form so that per-move forest
    edits are a single dynamic-update-slice instead of eight (the scan is
    latency-bound; op count is the budget). ``threshold`` keeps its exact
    bits via an int32 bitcast.
    """
    thr_bits = jax.lax.bitcast_convert_type(forest.threshold, jnp.int32)
    return jnp.stack(
        [
            forest.is_leaf.astype(jnp.int32),
            forest.feature,
            thr_bits,
            forest.left,
            forest.right,
            forest.parent,
            forest.depth,
            forest.active.astype(jnp.int32),
        ],
        axis=-1,
    )


def unpack_forest(packed: jax.Array) -> Forest:
    """Inverse of :func:`pack_forest` (fields are fused slices under jit)."""
    return Forest(
        is_leaf=packed[..., 0].astype(jnp.bool_),
        feature=packed[..., 1],
        threshold=jax.lax.bitcast_convert_type(packed[..., 2], jnp.float32),
        left=packed[..., 3],
        right=packed[..., 4],
        parent=packed[..., 5],
        depth=packed[..., 6],
        active=packed[..., 7].astype(jnp.bool_),
    )


def forest_from_numpy(arrays: dict) -> Forest:
    """Build a Forest from a dict of numpy arrays (checkpoint loading)."""
    return Forest(
        is_leaf=jnp.asarray(arrays["is_leaf"], jnp.bool_),
        feature=jnp.asarray(arrays["feature"], jnp.int32),
        threshold=jnp.asarray(arrays["threshold"], jnp.float32),
        left=jnp.asarray(arrays["left"], jnp.int32),
        right=jnp.asarray(arrays["right"], jnp.int32),
        parent=jnp.asarray(arrays["parent"], jnp.int32),
        depth=jnp.asarray(arrays["depth"], jnp.int32),
        active=jnp.asarray(arrays["active"], jnp.bool_),
    )
