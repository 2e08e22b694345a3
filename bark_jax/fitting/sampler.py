"""The BARK forest-MCMC transition kernel and multi-chain sampler.

Parity target: src/bark/fitting/bark_sampler.py:95-284. The reference's
Numba loop nest (chains -> steps -> m tree moves + one noise/scale move)
becomes one pure, fixed-shape function:

  ``step: (key, ChainState) -> ChainState``

scanned over steps and vmapped over chains. Each tree move proposes a
grow/prune/change edit, recomputes the marginal likelihood, and MH-accepts
on the MLL ratio exactly as the reference does (bark_sampler.py:233-264).

Design choices (this is where the speed comes from — per-op *latency*,
not FLOPs, dominates at BO problem sizes):

  - **Incremental leaf routing.** Proposals only ever touch terminal or
    singly-internal nodes, so the new leaf assignment of every training
    point is a single masked elementwise update of the carried ``(N, m)``
    leaf matrix — grow re-splits the points in one leaf, prune merges two
    leaves, change re-splits a singly-internal node's two leaves. No tree
    descent in the hot loop at all (the reference re-routes all points
    twice per move, forest.py:70-75).
  - **Pluggable kernel-update backend** (``params.kernel_backend``):
      * ``"rank1"`` (default): minimal-rank inverse maintenance — every
        move's kernel delta is exactly rank-2 (see ``_tree_moves_rank1``),
        so two Sherman-Morrison updates replace any per-move factorization;
        an exact once-per-step refresh bounds float32 drift (the per-move
        Cholesky's sequential critical path was the single largest cost
        in the step under "chol").
      * ``"chol"``: carry K itself; each move applies the exact
        rank-structured delta ``scale/m * (eq_new - eq_old)`` and
        refactorizes with one Cholesky — drift-free by construction; the
        conservative oracle backend.
      * ``"woodbury"``: the reference's incremental structure
        (quick_inverse.py:12-38) with both the inverse and determinant
        updates driven by a single Cholesky factorization of the SPD
        capacitance matrix ``I -/+ U^T K^-1 U``.
    All three produce identical trajectories under identical keys (tested).
  - **No RNG on the critical path**: all proposal randomness for the m
    moves is pre-drawn in one vectorized batch (proposals.ProposalNoise)
    and fed through scan xs.
  - All accept/reject logic is masked arithmetic — no host sync in the scan.
  - Chains vmap within a chip and shard over a mesh axis across chips (see
    bark_jax.parallel), where the reference ran chains serially
    (``parallel=False``, bark_sampler.py:120).
  - Padded training rows (fixed-shape BO path) are masked out of the
    kernel; the MLL correction keeps accept ratios exact
    (ops.linalg.masked_mll).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bark_jax.fitting.noise_scale import get_noise_scale_proposal
from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.proposals import (
    GROW,
    PRUNE,
    make_proposal_noise,
    propose_tree_packed,
)
from bark_jax.fitting.traversal import all_node_subspaces
from bark_jax.forest import (
    Forest,
    _split_decision,
    gram_from_leaves,
    indicator_from_targets,
    leaf_rank_targets,
    pack_forest,
    route_forest_auto,
    unpack_forest,
)
from bark_jax.ops.linalg import (
    JITTER,
    MM_PRECISION,
    MM_PRECISION_SCAN,
    blocked_cholesky,
    chol_inv_logdet,
    kernel_matrix,
    masked_mll,
)


def _chol_block(params: SamplerParams, n: int) -> int:
    """Panel size for the refresh Cholesky (trace-time); 0 means plain
    ``jnp.linalg.cholesky``.

    chol_block auto (-1) resolves to 0 at every N: the XLA-blocked form
    lost the full-bench A/B on the accelerator the sampler was first tuned
    on and has not yet been measured on the H100. It stays opt-in
    (chol_block > 0, which must divide the padded N).
    """
    if params.chol_block > 0 and n % params.chol_block == 0:
        return params.chol_block
    return 0


def _leaf_budget(params: SamplerParams, n: int) -> int:
    """Compact leaf-slot count R for refresh_style="leaf" (trace-time).

    Auto (leaf_budget=0): 128-aligned, scaled with the padded N because
    un-truncated posterior leaf totals GROW with the training set.
    Measured at the bench config (dense sampler, no truncation,
    results/ab_r4/leaf_totals.json, m=50): mean/max totals 130/143 at
    N=200, 155/171 at N=1024, 187/209 at N=2048, 225/262 at N=4096 —
    with per-snapshot spread sigma ~ 9-15. The auto tiers keep R >= ~5
    sigma above the measured mean so the capacity MH-guard essentially
    never fires (statistically invisible truncation):

      n <= 2048 -> 5 leaves/tree   (256 at m=50; 7.5 sigma over the 2048
                                    mean)
      n <= 8192 -> 7.5 leaves/tree (384 at m=50; 256 would sit only ~2
                                    sigma above the N=4096 mean and
                                    truncate the top percentile — the
                                    throughput of 256 at N=4096 is NOT a
                                    legitimate win)
      beyond    -> 10 leaves/tree  (512 at m=50; extrapolated headroom —
                                    re-measure totals before trusting
                                    budgets at N >> 8192)

    Do NOT force budgets below the realized totals: R=128 at m=50
    measured faster still, but it sits BELOW the posterior mean — the
    guard then truncates constantly and the chain no longer samples the
    intended posterior.

    The tiers are calibrated at the DEFAULT depth prior (alpha=0.95,
    beta=2.0). A deeper-tree prior gets double the headroom (capped at
    the per-tree structural maximum) rather than silently truncating —
    re-measure totals before trusting auto budgets under custom priors.
    """
    if params.leaf_budget > 0:
        return params.leaf_budget
    per_tree = 10.0 if n > 8192 else (7.5 if n > 2048 else 5.0)
    if params.alpha > 0.95 or params.beta < 2.0:
        per_tree *= 2.0
    slots = min(
        int(per_tree * params.num_trees),
        params.num_trees * ((params.node_limit + 1) // 2),
    )
    return max(128, -(-slots // 128) * 128)


def _resolve_styles(params: SamplerParams, n: int) -> SamplerParams:
    """Trace-time resolution of the measured-best lowering per padded N.

    Idempotent; called at every public entry (init_chain_state / step) so
    direct callers and the chain drivers agree. All thresholds were chosen
    by full-bench A/Bs at 64 chains on the accelerator the sampler was
    first tuned on; none has been measured on the H100 yet:

      - refresh "auto" -> "leaf" once padded N >= 256 (the leaf-space
        refresh won from N=384 up and tied at N=256; dense won below).
        The tie-at-256 resolves to leaf because it also removes the
        tier's explicit K^-1 — the inaccurate object at low noise
        (results/ab_r4/leaf_numerics.md finding 1). An
        EXPLICIT non-coeff scan_style opts out of the leaf resolution
        (refresh falls back to "onesolve") — auto must never override a
        user-pinned lowering, or A/B overrides like
        measure(scan_style="lowrank") would silently measure the leaf
        program instead (r4 code-review finding);
      - factor/leaf refreshes force the coeff scan (the only scan that
        consumes the kernel through symmetric products; explicit
        conflicting combinations are rejected by params validation);
      - scan "auto" (dense refreshes, reachable only via an explicit
        refresh pin or N < 256) -> coeff at N >= 1024, lowrank at
        256-1023, plain below.
    """
    if params.kernel_backend != "rank1":
        return params
    scan, refresh = params.scan_style, params.refresh_style
    if refresh == "auto":
        # dense tier resolves to "onesolve", not "pair": both branch MLLs
        # come from the Cholesky FACTOR (z = L^-1 y), which measured
        # f64-accurate where the explicit-inverse form (chol_inv_logdet +
        # masked_mll quad) was off by ~58 nats at (N=512, nu=0.011) —
        # triangular-solve/inverse expanders can lose cond^2 accuracy
        # (results/ab_r4/leaf_numerics.md).
        refresh = (
            "leaf" if n >= 256 and scan in ("auto", "coeff") else "onesolve"
        )
    if refresh in ("factor", "leaf"):
        scan = "coeff"
    elif scan == "auto":
        scan = "coeff" if n >= 1024 else ("lowrank" if n >= 256 else "plain")
    if (scan, refresh) == (params.scan_style, params.refresh_style):
        return params
    return params.with_(scan_style=scan, refresh_style=refresh)


def _leaf_Z(
    forest: Forest, leaves: jax.Array, budget: int, mask: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """(N, R) budget-packed leaf-indicator matrix + total leaf count.

    Tree j's active leaves are ranked in node order and packed at offset
    ``sum_{j'<j} num_leaves(j')`` (forest.leaf_rank_targets + one
    projection matmul, forest.indicator_from_targets — see there for the
    measured scatter/gather losers). Z then satisfies
    ``Z Z^T == m * gram`` exactly: the packing is injective on active
    leaves whenever total <= R (the move scan's capacity guard keeps it
    there; over-budget slots project to nothing and the callers NaN-poison
    the MLL on overflow). Padded rows are zeroed.
    """
    tmask, ranks, counts = leaf_rank_targets(forest)
    base = jnp.cumsum(counts) - counts  # exclusive prefix
    # non-leaf slots target index R -> all-zero projection row
    target = jnp.where(tmask, base[:, None] + ranks, budget)
    Z = indicator_from_targets(leaves, target, budget)
    return Z * mask[:, None], jnp.sum(counts)


class KernState(NamedTuple):
    """Kernel carry: exactly one of (K) or (K_inv, K_logdet) is live,
    depending on the static ``params.kernel_backend``; the other is a
    zero-size placeholder so the pytree structure stays static."""

    K: jax.Array
    K_inv: jax.Array
    K_logdet: jax.Array


class ChainState(NamedTuple):
    forest: Forest  # fields (m, node_limit)
    leaves: jax.Array  # (N, m) int32 — train-point leaf per tree
    noise: jax.Array  # f32 scalar
    scale: jax.Array  # f32 scalar
    kern: KernState
    mll: jax.Array  # f32 scalar
    # per-node subspace carry: (m, node_limit, D, 2) when
    # params.subspace_mode == "carry", zero-size placeholder under the
    # default "walk" mode (proposals re-derive the chosen node's subspace
    # by the fixed-depth parent-chain walk inside the parallel batch)
    subspaces: jax.Array


class BARKModel(NamedTuple):
    """Posterior (or state) triple; batch dims lead each field.

    Parity: ModelT = (forest, noise, scale), src/bark/fitting/bark_sampler.py:13
    and src/bark/tree_kernels/tree_gps.py:14-17.
    """

    forest: Forest
    noise: jax.Array
    scale: jax.Array


def _empty() -> jax.Array:
    return jnp.zeros((0,), jnp.float32)


def _chol_mll(K, y, noise, pad_count):
    """MLL via one Cholesky; returns (mll, L). NaN-safe under MH (a failed
    factorization yields NaN mll -> proposal rejected)."""
    L = jnp.linalg.cholesky(K)
    z = jax.scipy.linalg.solve_triangular(L, y, lower=True)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    correction = pad_count * jnp.log(JITTER + noise)
    return 0.5 * (-jnp.sum(z * z) - logdet + correction), L


def _leaf_agreement(leaves_j: jax.Array, mask: jax.Array) -> jax.Array:
    """(N, N) 0/1 matrix: points sharing a leaf in one tree (masked)."""
    eq = (leaves_j[:, None] == leaves_j[None, :]).astype(jnp.float32)
    return eq * (mask[:, None] * mask[None, :])


def _incremental_leaves(
    row_old: jax.Array,
    row_new: jax.Array,
    cur_leaves_j: jax.Array,
    move: jax.Array,
    node: jax.Array,
    X: jax.Array,
    feat_types: jax.Array,
) -> jax.Array:
    """Leaf assignment under the proposed tree, as O(1) masked updates.

    ``row_old``/``row_new`` are the packed (8,) node records of the proposal
    target before/after the edit. Grow at leaf n: points at n re-split to
    the two fresh children. Prune at singly-internal n: points at either
    child merge back to n. Change at singly-internal n: points at either
    child re-split by the new rule. Exactness relies on proposals only
    targeting terminal / singly-internal nodes (tree_proposals.py:202-210).
    """
    is_cat = feat_types == 0
    # new split rule at `node` (valid for grow/change paths)
    f = row_new[1]
    thr = jax.lax.bitcast_convert_type(row_new[2], jnp.float32)
    x_val = X[:, f]
    go_left = _split_decision(x_val, thr, is_cat[f])

    l_new, r_new = row_new[3], row_new[4]
    split_to = jnp.where(go_left, l_new, r_new)

    at_node = cur_leaves_j == node
    l_old, r_old = row_old[3], row_old[4]
    at_children = (cur_leaves_j == l_old) | (cur_leaves_j == r_old)

    grown = jnp.where(at_node, split_to, cur_leaves_j)
    pruned = jnp.where(at_children, node, cur_leaves_j)
    changed = jnp.where(at_children, split_to, cur_leaves_j)

    return jnp.where(
        move == GROW, grown, jnp.where(move == PRUNE, pruned, changed)
    ).astype(jnp.int32)


def init_chain_state(
    forest: Forest,
    noise: jax.Array,
    scale: jax.Array,
    X: jax.Array,
    y: jax.Array,
    feat_types: jax.Array,
    params: SamplerParams,
    mask: jax.Array | None = None,
    bounds: jax.Array | None = None,
) -> ChainState:
    """Route data, factorize the initial kernel, and precompute per-node
    subspaces (the one-time walk powering the hot loop's O(1) incremental
    subspace maintenance).

    Parity: src/bark/fitting/bark_sampler.py:153-162.
    """
    if bounds is None:
        raise ValueError("init_chain_state requires the domain bounds array")
    params = _resolve_styles(params, X.shape[0])
    if mask is None:
        mask = jnp.ones((X.shape[0],), jnp.float32)
    pad_count = X.shape[0] - jnp.sum(mask)
    noise = jnp.asarray(noise, jnp.float32)
    scale = jnp.asarray(scale, jnp.float32)
    leaves = route_forest_auto(forest, X, feat_types, params.max_depth)

    def dense_K():
        # only the dense-kernel branches build the (N, N) gram; the leaf
        # branch must stay N-free even for EAGER callers (jit DCE would
        # hide the cost under run_chain, but init_chain_state is public —
        # at N=32768 the dead gram would be gigabytes, r4 code review)
        gram = gram_from_leaves(
            leaves, leaves, params.node_limit, mask, mask,
            onehot_dtype=(
                jnp.bfloat16 if params.gram_dtype == "bf16" else jnp.float32
            ),
        )
        return kernel_matrix(gram, noise, scale)

    if params.subspace_mode == "carry":
        subspaces = jax.vmap(
            lambda t: all_node_subspaces(t, bounds, feat_types, params.max_depth)
        )(forest)
    else:  # "walk": no subspace carry — proposals re-walk the parent chain
        subspaces = jnp.zeros((0,), jnp.float32)
    if params.kernel_backend == "chol":
        K = dense_K()
        mll_val, _ = _chol_mll(K, y.reshape(-1), noise, pad_count)
        kern = KernState(K=K, K_inv=_empty(), K_logdet=_empty())
    elif (
        params.kernel_backend == "rank1" and params.refresh_style == "factor"
    ):
        # factor carry: L in the K slot, no inverse anywhere (see step())
        mll_val, L = _chol_mll(dense_K(), y.reshape(-1), noise, pad_count)
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
        kern = KernState(K=L, K_inv=_empty(), K_logdet=logdet)
    elif params.kernel_backend == "rank1" and params.refresh_style == "leaf":
        # leaf-factor carry: chol(A) in the K slot with
        # A = (nu/gamma) I_R + Z^T Z — the same quantities step()'s leaf
        # refresh produces, so the first move scan is indistinguishable
        # from any later one. No (N, N) object anywhere.
        budget = _leaf_budget(params, X.shape[0])
        y_flat = y.reshape(-1)
        nu = JITTER + noise
        gamma = scale / params.num_trees
        Z, total0 = _leaf_Z(forest, leaves, budget, mask)
        # Z'Z is exact at default precision (0/1 operands); the solves
        # and y-products below run at full mantissa
        # (results/ab_r5/precision_bug.md)
        A = Z.T @ Z + (nu / gamma) * jnp.eye(budget, dtype=jnp.float32)
        with jax.default_matmul_precision(MM_PRECISION):
            L_A = jnp.linalg.cholesky(A)
        logdet_A = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L_A)))
        K_logdet = (
            X.shape[0] * jnp.log(nu) + budget * jnp.log(gamma / nu) + logdet_A
        )
        # residual form, NOT (y'y - ||s||^2)/nu: that difference is
        # ~nu*N computed from O(N)-magnitude f32 sums — at small noise
        # the ~1% cancellation error corrupts the low-noise likelihood
        # and biases the posterior (measured z=28 on the noise mean,
        # results/ab_r4/leaf_selfparity.json). Here the cancellation
        # happens per element on O(1) operands: exact same math.
        with jax.default_matmul_precision(MM_PRECISION):
            w_y = jax.scipy.linalg.cho_solve(
                (L_A, True), Z.T @ y_flat
            )
            quad = y_flat @ (y_flat - Z @ w_y) / nu
        mll_val = 0.5 * (-quad - K_logdet + pad_count * jnp.log(nu))
        # an INITIAL forest over the leaf budget cannot be packed (the
        # capacity guard only blocks new grows) — poison the MLL with NaN
        # so every move rejects and the corruption is visible in outputs,
        # rather than silently sampling against a wrong kernel. The eager
        # fit path raises a real error first (models/surrogate.fit).
        mll_val = jnp.where(total0 <= budget, mll_val, jnp.nan)
        kern = KernState(K=L_A, K_inv=_empty(), K_logdet=K_logdet)
    else:
        K_inv, K_logdet = chol_inv_logdet(dense_K())
        mll_val = masked_mll(K_inv, K_logdet, y, noise, pad_count)
        kern = KernState(K=_empty(), K_inv=K_inv, K_logdet=K_logdet)
    return ChainState(
        forest=forest, leaves=leaves, noise=noise, scale=scale, kern=kern,
        mll=mll_val, subspaces=subspaces,
    )


class _ProposalBatch(NamedTuple):
    """All per-tree proposal quantities for one step, batched over the m
    trees (leading axis m). Everything here is *independent of move order*:
    within a step each tree is visited exactly once, so tree j's proposal,
    incremental leaf assignment, and update vectors depend only on tree j's
    own pre-step state — never on another tree's accepted move. Hoisting
    them out of the sequential scan (one vmap over trees) removes the
    proposal machinery from the latency-critical path entirely; the scan
    keeps only the kernel/MLL updates and accept logic, and the accepted
    per-tree state is merged with one bulk select after the scan."""

    new_packed: jax.Array  # (m, node_limit, 8)
    new_subs: jax.Array  # (m, node_limit, D, 2)
    cur_leavesT: jax.Array  # (m, N)
    new_leavesT: jax.Array  # (m, N)
    log_q_prior: jax.Array  # (m,)
    move: jax.Array  # (m,)
    node: jax.Array  # (m,)
    u_accept: jax.Array  # (m,)


def _propose_all_trees(key, state, X, feat_types, bounds, params):
    """vmap the full proposal pipeline over the m trees (see _ProposalBatch)."""
    m = params.num_trees
    noise_bundle = make_proposal_noise(key, m, params.node_limit)
    packed0 = pack_forest(state.forest)
    cur_leavesT = state.leaves.T
    carry_subs = params.subspace_mode == "carry"

    def one(tree_packed, sub_tree, cur_lj, nz):
        if carry_subs:
            new_packed, new_sub, log_q_prior, move, node = propose_tree_packed(
                key, tree_packed, bounds, feat_types, params,
                subspace_tree=sub_tree, noise=nz,
            )
        else:
            # "walk": re-derive the chosen node's subspace by the parent
            # chain — parallel work here in the hoisted batch, so the
            # sampler carries no (m, node_limit, D, 2) state at all
            new_packed, log_q_prior, move, node = propose_tree_packed(
                key, tree_packed, bounds, feat_types, params, noise=nz,
            )
            new_sub = jnp.zeros((0,), jnp.float32)
        new_lj = _incremental_leaves(
            tree_packed[node], new_packed[node], cur_lj, move, node, X,
            feat_types,
        )
        return new_packed, new_sub, log_q_prior, move, node, new_lj

    subs_in = state.subspaces if carry_subs else jnp.zeros(
        (m, 0), jnp.float32
    )
    new_packed, new_subs, log_q_prior, move, node, new_leavesT = jax.vmap(one)(
        packed0, subs_in, cur_leavesT, noise_bundle
    )
    batch = _ProposalBatch(
        new_packed=new_packed, new_subs=new_subs, cur_leavesT=cur_leavesT,
        new_leavesT=new_leavesT, log_q_prior=log_q_prior, move=move,
        node=node, u_accept=noise_bundle.u_accept,
    )
    return packed0, batch


def _merge_accepted(packed0, state, batch, accepts):
    """Bulk-select the accepted per-tree state after the move scan."""
    acc = accepts
    packed = jnp.where(acc[:, None, None], batch.new_packed, packed0)
    if state.subspaces.ndim == 4:  # "carry" mode
        subs = jnp.where(
            acc[:, None, None, None], batch.new_subs, state.subspaces
        )
    else:  # "walk" mode: nothing carried
        subs = state.subspaces
    leavesT = jnp.where(acc[:, None], batch.new_leavesT, batch.cur_leavesT)
    return unpack_forest(packed), subs, leavesT.T


def _tree_moves_chol(
    key, state, X, y, mask, pad_count, bounds, feat_types, params, beta=1.0
):
    """m sequential tree moves with exact-delta K maintenance + refactor.

    ``beta`` is an inverse temperature: the MH ratio uses beta * delta-MLL
    (likelihood tempering for parallel tempering / SMC; beta=1 recovers the
    reference sampler)."""
    s_over_m = state.scale / params.num_trees
    y_flat = y.reshape(-1)
    packed0, batch = _propose_all_trees(key, state, X, feat_types, bounds, params)

    def tree_move(carry, inputs):
        K, cur_mll = carry
        cur_lj, new_lj, log_q_prior, log_u = inputs

        delta = s_over_m * (
            _leaf_agreement(new_lj, mask) - _leaf_agreement(cur_lj, mask)
        )
        K_new = K + delta
        new_mll, _ = _chol_mll(K_new, y_flat, state.noise, pad_count)

        log_alpha = log_q_prior + beta * (new_mll - cur_mll)
        accept = log_u <= jnp.minimum(log_alpha, 0.0)

        K = jnp.where(accept, K_new, K)
        cur_mll = jnp.where(accept, new_mll, cur_mll)
        return (K, cur_mll), accept

    (K, cur_mll), accepts = jax.lax.scan(
        tree_move,
        (state.kern.K, state.mll),
        (batch.cur_leavesT, batch.new_leavesT, batch.log_q_prior,
         jnp.log(batch.u_accept)),
    )
    forest, subs, leaves = _merge_accepted(packed0, state, batch, accepts)
    return forest, subs, leaves, K, cur_mll



def _scan_precision(fn):
    """Trace the wrapped move-scan body under MM_PRECISION_SCAN (overrides
    the enclosing MM_PRECISION gate; see the ops/linalg.py constants)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        import bark_jax.ops.linalg as _lin

        with jax.default_matmul_precision(_lin.MM_PRECISION_SCAN):
            return fn(*args, **kwargs)
    return wrapped

def _tree_moves_rank1(
    key, state, X, y, mask, pad_count, bounds, feat_types, params, beta=1.0
):
    """Precision gate for :func:`_tree_moves_rank1_impl` (see there).

    A default-precision matmul may round f32 operands (TF32 on the H100,
    bf16 passes elsewhere). For the indicator/one-hot matmuls elsewhere
    (routing, gram counts) that is EXACT — 0/1 operands and small-integer
    counts are representable — but the move scan's hoisted quadratic
    forms are not: with bf16-rounded operands, per-move MH log-ratios
    through the leaf-tier hoist measured mean +0.65 / max 9.7 nats of
    error at (N=512, nu~0.1), enough to shift the stationary noise
    posterior by +11% against the chol oracle (the stationarity
    investigation, results/ab_r5/precision_bug.md). Under "highest" the
    same quantities match f64 to 0.002 nats. The proposal
    batch and scans contain no large matmuls, so gating the whole body
    costs only the (already hoisted, small) products.
    """
    with jax.default_matmul_precision(MM_PRECISION):
        return _tree_moves_rank1_impl(
            key, state, X, y, mask, pad_count, bounds, feat_types, params,
            beta,
        )


def _tree_moves_rank1_impl(
    key, state, X, y, mask, pad_count, bounds, feat_types, params, beta=1.0
):
    """m tree moves with *minimal-rank* inverse maintenance.

    Because proposals only touch terminal / singly-internal nodes, the exact
    kernel delta of every move is rank-2:

        E_new - E_old = 1/2 (w_add w_addᵀ - w_sub w_subᵀ)

    with ``w_add/w_sub`` built from leaf-membership indicators (grow at n:
    w_add = 1_L - 1_R, w_sub = 1_A; prune the reverse; change uses the
    old/new child indicators) — the identity 1_L1_Lᵀ + 1_R1_Rᵀ =
    (1_A1_Aᵀ + (1_L-1_R)(1_L-1_R)ᵀ)/2 for any leaf split L ∪ R = A.
    Each move is then two Sherman-Morrison updates (matvec + outer product;
    no sequential factorization), replacing the per-move Cholesky that
    dominated the step under the "chol" backend. The reference's
    rank-L Woodbury (quick_inverse.py:12-38) is the same idea at
    L = num-leaves; the incremental leaf tracking makes L = 1 exact.

    Float32 drift is bounded by the once-per-step exact refresh in
    :func:`step` (the rank1 branch rebuilds K from the Gram matrix and
    refactorizes both MH branches), and a ``denom <= eps`` guard turns
    round-off-broken updates into rejections.
    """
    # step() resolves styles before dispatching here; re-resolving is
    # idempotent and protects direct internal callers
    params = _resolve_styles(params, X.shape[0])
    half_s_over_m = jnp.sqrt(state.scale / (2.0 * params.num_trees))
    eps = jnp.float32(1e-6)
    packed0, batch = _propose_all_trees(key, state, X, feat_types, bounds, params)

    # rank-1 update vectors from leaf-membership indicators, built for all
    # trees at once (vectorized over the m axis)
    node = batch.node
    rows_new = jnp.take_along_axis(
        batch.new_packed, node[:, None, None], axis=1
    )[:, 0]  # (m, 8)
    rows_old = jnp.take_along_axis(packed0, node[:, None, None], axis=1)[:, 0]
    a_l, a_r = rows_new[:, 3:4], rows_new[:, 4:5]  # (m, 1)
    l_old, r_old = rows_old[:, 3:4], rows_old[:, 4:5]
    is_grow = (batch.move == GROW)[:, None]
    is_prune = (batch.move == PRUNE)[:, None]
    ind = lambda lv, i: (lv == i).astype(jnp.float32)
    w_add_all = jnp.where(
        is_prune,
        ind(batch.new_leavesT, node[:, None]),
        ind(batch.new_leavesT, a_l) - ind(batch.new_leavesT, a_r),
    )
    w_sub_all = jnp.where(
        is_grow,
        ind(batch.cur_leavesT, node[:, None]),
        ind(batch.cur_leavesT, l_old) - ind(batch.cur_leavesT, r_old),
    )
    w_add_all = mask[None, :] * w_add_all
    w_sub_all = mask[None, :] * w_sub_all
    # 0/±1 update patterns; the sqrt(scale/2m) scalar is applied at the
    # consumers — keeping patterns pure lets the leaf hoist's big
    # products run with EXACTLY-representable bf16 operands at default
    # matmul precision (results/ab_r5/precision_bug.md perf notes)
    W_pat = jnp.stack([w_add_all, w_sub_all], axis=-1)  # (m, N, 2)
    W_all = half_s_over_m * W_pat

    y_flat = y.reshape(-1)
    mll_corr = pad_count * jnp.log(JITTER + state.noise)

    def seed_mll(quad0, logdet0):
        """Scan-consistent starting MLL — NOT state.mll.

        Every move's new_mll is built from the hoisted (quad, logdet)
        arithmetic; the carried state.mll came from the refresh's
        *different* f32 program. Seeding the scan with state.mll injects
        the cross-program drift (~|mll| * 1e-6 per step, correlated
        across all m moves of the step) straight into every log-accept
        ratio — a pseudo-marginal-style bias that measurably flattened
        the posterior toward the prior under the leaf refresh (noise
        mean 0.035 vs 0.013, z=28 — results/ab_r4/leaf_selfparity.json
        pre-fix rows; the pair path only dodged it because its hoist
        happens to repeat the refresh's arithmetic). Computing the seed
        from the hoist's own quantities makes the MH ratios exact by
        construction for every (refresh, scan) pairing.
        """
        return 0.5 * (-quad0 - logdet0 + mll_corr)

    @_scan_precision
    def tree_move(carry, inputs):
        K_inv, K_logdet, v_y, quad, cur_mll = carry
        W, log_q_prior, log_u = inputs

        # Fused rank-2 Woodbury for K' = K + w_add w_addT - w_sub w_subT:
        # K'^-1 = K^-1 - V M^-1 V^T with V = K^-1 W,
        # M = S^-1 + W^T K^-1 W, S = diag(1, -1) — one (N,N)@(N,2) matmul
        # replaces two sequential Sherman-Morrison matvecs, and the
        # quadratic form y^T K^-1 y is maintained incrementally in O(N)
        # (v_y = K^-1 y), so no per-move MLL matvec remains. Equivalent to
        # the two-step update: denom1 = 1 + A, denom2 = -det(M)/denom1.
        V = K_inv @ W  # (N, 2)
        G = W.T @ V  # (2, 2)
        t = W.T @ v_y  # (2,)
        A, B, C = G[0, 0], G[1, 1], G[0, 1]
        denom1 = 1.0 + A
        detM = denom1 * (B - 1.0) - C * C
        denom2 = -detM / denom1
        Minv = jnp.array([[B - 1.0, -C], [-C, denom1]], dtype=K_inv.dtype) / detM
        P = V @ Minv  # (N, 2)
        K_inv2 = K_inv - P @ V.T
        K_logdet2 = K_logdet + jnp.log(-detM)
        u = Minv @ t
        v_y2 = v_y - V @ u
        quad2 = quad - t @ u

        new_mll = 0.5 * (-quad2 - K_logdet2 + mll_corr)
        new_mll = jnp.where(denom2 > eps, new_mll, -jnp.inf)
        log_alpha = log_q_prior + beta * (new_mll - cur_mll)
        accept = log_u <= jnp.minimum(log_alpha, 0.0)

        K_inv = jnp.where(accept, K_inv2, K_inv)
        K_logdet = jnp.where(accept, K_logdet2, K_logdet)
        v_y = jnp.where(accept, v_y2, v_y)
        quad = jnp.where(accept, quad2, quad)
        cur_mll = jnp.where(accept, new_mll, cur_mll)
        return (K_inv, K_logdet, v_y, quad, cur_mll), accept

    if params.refresh_style not in ("factor", "leaf"):
        v_y0 = state.kern.K_inv @ y_flat
        quad0 = y_flat @ v_y0

    @_scan_precision
    def tree_move_aug(carry, inputs):
        # augmented-carry variant: A = [K_inv | v_y] (N, N+1) — the v_y
        # update folds into the same rank-2 correction (K_inv' y =
        # v_y - V M^-1 t), so one (N,2)@(2,N+1) matmul updates both and
        # the carry needs one select instead of two. Identical arithmetic.
        A, K_logdet, quad, cur_mll = carry
        W, log_q_prior, log_u = inputs

        V = A[:, :-1] @ W  # (N, 2)
        G = W.T @ V  # (2, 2), = W^T K^-1 W by symmetry
        t = W.T @ A[:, -1]  # (2,)
        Acol, B, C = G[0, 0], G[1, 1], G[0, 1]
        denom1 = 1.0 + Acol
        detM = denom1 * (B - 1.0) - C * C
        denom2 = -detM / denom1
        Minv = jnp.array([[B - 1.0, -C], [-C, denom1]], dtype=A.dtype) / detM
        P = V @ Minv  # (N, 2)
        VT_aug = jnp.concatenate([V.T, t[:, None]], axis=1)  # (2, N+1)
        A2 = A - P @ VT_aug
        K_logdet2 = K_logdet + jnp.log(-detM)
        quad2 = quad - t @ (Minv @ t)

        new_mll = 0.5 * (-quad2 - K_logdet2 + mll_corr)
        new_mll = jnp.where(denom2 > eps, new_mll, -jnp.inf)
        log_alpha = log_q_prior + beta * (new_mll - cur_mll)
        accept = log_u <= jnp.minimum(log_alpha, 0.0)

        A = jnp.where(accept, A2, A)
        K_logdet = jnp.where(accept, K_logdet2, K_logdet)
        quad = jnp.where(accept, quad2, quad)
        cur_mll = jnp.where(accept, new_mll, cur_mll)
        return (A, K_logdet, quad, cur_mll), accept

    @_scan_precision
    def tree_move_lowrank(carry, inputs):
        # Deferred-update variant: K^-1 is NEVER written inside the scan.
        # The refresh at the end of step() rebuilds K^-1 from the Gram
        # matrix anyway (the scan's K_inv output is discarded), so the
        # only thing later moves need is K^-1_cur times their update pair.
        # Maintain the correction in low-rank factors (P, Q) with
        #   K^-1_cur = K0^-1 - P Q^T,   V_j = K0^-1 W_j - P (Q^T W_j),
        # appending the accepted move's two columns (P += V Minv, Q += V).
        # Per move this trades the (N,N) write + select for two (N,2m)
        # reads — a large HBM-traffic win once N^2 dominates (N >= ~200);
        # at bucket-sized N the extra ops cost more than they save (the
        # full-bench A/B decides). Because proposals are
        # hoisted, the base products V0_j = K0^-1 W_j for ALL m moves are
        # one batched (N,N)@(N,2m) matmul BEFORE the scan, so no move
        # ever touches an (N,N) operand: per-move traffic is the (N,2m)
        # P/Q factors only (~5x less than the plain carry at N=512).
        # Same math as tree_move up to association (not bit-identical;
        # accepts match in f64, tested).
        P, Q, K_logdet, v_y, quad, cur_mll = carry
        W, V0, log_q_prior, log_u, j = inputs

        V = V0 - P @ (Q.T @ W)  # (N, 2)
        G = W.T @ V
        t = W.T @ v_y
        A, B, C = G[0, 0], G[1, 1], G[0, 1]
        denom1 = 1.0 + A
        detM = denom1 * (B - 1.0) - C * C
        denom2 = -detM / denom1
        Minv = jnp.array([[B - 1.0, -C], [-C, denom1]], dtype=V.dtype) / detM
        K_logdet2 = K_logdet + jnp.log(-detM)
        u = Minv @ t
        v_y2 = v_y - V @ u
        quad2 = quad - t @ u

        new_mll = 0.5 * (-quad2 - K_logdet2 + mll_corr)
        new_mll = jnp.where(denom2 > eps, new_mll, -jnp.inf)
        log_alpha = log_q_prior + beta * (new_mll - cur_mll)
        accept = log_u <= jnp.minimum(log_alpha, 0.0)

        # append columns 2j:2j+2 on accept (zero columns are inert)
        two = jnp.where(accept, V @ Minv, jnp.zeros_like(V))
        col = (2 * j).astype(jnp.int32)
        P = jax.lax.dynamic_update_slice(P, two, (jnp.int32(0), col))
        Q = jax.lax.dynamic_update_slice(
            Q, jnp.where(accept, V, jnp.zeros_like(V)), (jnp.int32(0), col)
        )
        K_logdet = jnp.where(accept, K_logdet2, K_logdet)
        v_y = jnp.where(accept, v_y2, v_y)
        quad = jnp.where(accept, quad2, quad)
        cur_mll = jnp.where(accept, new_mll, cur_mll)
        return (P, Q, K_logdet, v_y, quad, cur_mll), accept

    @_scan_precision
    def tree_move_coeff(carry, inputs, cap=None):
        # Coefficient-space deferred update: every per-move quantity lives
        # in span(V0) with V0 = K0^-1 W_flat, so the scan NEVER touches an
        # N-sized operand at all. With the (2m, 2m) interaction matrix
        #   Hm = W_flat^T K0^-1 W_flat
        # hoisted into one matmul, represent
        #   K^-1_cur = K0^-1 - V0 S V0^T,   v_y_cur = v_y0 - V0 d
        # and per move j (Tv = Hm[:, 2j:2j+2], Ej = identity columns):
        #   V_j     = V0 c,  c = Ej - S Tv          (never formed)
        #   G_j     = W_j^T V_j = Tv^T c            (2, 2)
        #   t_j     = W_j^T v_y = t0_j - Tv^T d     (2,)
        # and on accept S += (c Minv) c^T, d += c u. The whole sequential
        # chain runs on (2m, 2m)-and-smaller tensors — N-independent — so
        # the latency-bound per-move cost stops growing with the training
        # set; N appears only in the three hoisted products. Same
        # Woodbury math as tree_move up to float association (accepts match
        # in f64, tested like lowrank).
        #
        # ``cap`` (static, refresh_style="leaf" only): compact leaf-slot
        # budget R. The carry gains the running total leaf count and grow
        # moves that would exceed R are MH-rejected — the principled
        # truncation that keeps the leaf-space refresh's packing exact
        # (see params.py leaf_budget notes).
        if cap is None:
            S, d, K_logdet, quad, cur_mll = carry
            Tv, Ej, t0, log_q_prior, log_u = inputs
        else:
            S, d, K_logdet, quad, cur_mll, total = carry
            Tv, Ej, t0, log_q_prior, log_u, delta = inputs

        c = Ej - S @ Tv  # (2m, 2)
        G = Tv.T @ c  # (2, 2); symmetric (S, Minv symmetric)
        t = t0 - Tv.T @ d  # (2,)
        A, B, C = G[0, 0], G[1, 1], G[0, 1]
        denom1 = 1.0 + A
        detM = denom1 * (B - 1.0) - C * C
        denom2 = -detM / denom1
        Minv = jnp.array([[B - 1.0, -C], [-C, denom1]], dtype=Tv.dtype) / detM
        K_logdet2 = K_logdet + jnp.log(-detM)
        u = Minv @ t
        quad2 = quad - t @ u

        new_mll = 0.5 * (-quad2 - K_logdet2 + mll_corr)
        new_mll = jnp.where(denom2 > eps, new_mll, -jnp.inf)
        if cap is not None:
            new_mll = jnp.where(total + delta > cap, -jnp.inf, new_mll)
        log_alpha = log_q_prior + beta * (new_mll - cur_mll)
        accept = log_u <= jnp.minimum(log_alpha, 0.0)

        S = jnp.where(accept, S + (c @ Minv) @ c.T, S)
        d = jnp.where(accept, d + c @ u, d)
        K_logdet = jnp.where(accept, K_logdet2, K_logdet)
        quad = jnp.where(accept, quad2, quad)
        cur_mll = jnp.where(accept, new_mll, cur_mll)
        if cap is not None:
            total = total + jnp.where(accept, delta, 0)
            return (S, d, K_logdet, quad, cur_mll, total), accept
        return (S, d, K_logdet, quad, cur_mll), accept

    scan_style = params.scan_style
    if scan_style == "lowrank":
        K0_inv = state.kern.K_inv
        n = K0_inv.shape[0]
        m2 = 2 * params.num_trees
        zeros = jnp.zeros((n, m2), dtype=K0_inv.dtype)
        # all m base products in one matmul, hoisted out of the scan
        V0_all = jnp.einsum("nk,mkt->mnt", K0_inv, W_all)
        (P, Q, K_logdet, _, _, cur_mll), accepts = jax.lax.scan(
            tree_move_lowrank,
            (zeros, zeros, state.kern.K_logdet, v_y0, quad0,
             seed_mll(quad0, state.kern.K_logdet)),
            (
                W_all,
                V0_all,
                batch.log_q_prior,
                jnp.log(batch.u_accept),
                jnp.arange(params.num_trees, dtype=jnp.int32),
            ),
            unroll=params.scan_unroll,
        )
        # K_inv output is discarded by the rank1 refresh; return the
        # uncorrected base (never materialize K0^-1 - P Q^T).
        K_inv = K0_inv
    elif scan_style == "coeff":
        m = params.num_trees
        m2 = 2 * m
        W_flat = W_all.transpose(1, 0, 2).reshape(-1, m2)  # (N, 2m)
        if params.refresh_style == "leaf":
            # leaf-factor carry: kern.K is chol(A), A = (nu/gamma) I_R +
            # Z^T Z of the *current* kernel. Structure (r5, after the
            # precision finding): the O(N)-sized products run at DEFAULT
            # matmul precision on EXACT operands — Z is 0/1 and Wp_flat
            # is the 0/±1 pattern (integer counts accumulate exactly in
            # f32) — while the inexact-operand work is either tiny
            # ((R, 2m+1) solve, (2m, 2m) symmetric products) or a matvec,
            # and runs under the enclosing "highest" gate. Hm comes from
            # the factor-SYMMETRIC form (W'K0^-1 W = (W'W - Sw'Sw)/nu
            # with Sw = L^-1 Z'W): with W'W and Z'W exact and the solve
            # at full precision, the B-1 ~ O(1e-2) cancellations resolve
            # to ~1e-6 absolute (per-move MH ratio error <= 0.003 nats
            # vs f64 — probe record in precision_bug.md). The y-side
            # quad/t0 keep the r4 RESIDUAL form (the Gram-difference
            # form's O(N) cancellation corrupts the likelihood at small
            # noise — z=28, results/ab_r4/leaf_selfparity.json).
            budget = _leaf_budget(params, X.shape[0])
            L_A = state.kern.K  # (R, R)
            nu = JITTER + state.noise
            Z, total0 = _leaf_Z(state.forest, state.leaves, budget, mask)
            Wp_flat = W_pat.transpose(1, 0, 2).reshape(-1, m2)  # (N, 2m)
            with jax.default_matmul_precision("default"):
                CW = Z.T @ Wp_flat  # (R, 2m) exact integer counts
                WtW = Wp_flat.T @ Wp_flat  # (2m, 2m) exact
            uz = Z.T @ y_flat
            Sw = jax.scipy.linalg.solve_triangular(
                L_A, half_s_over_m * CW, lower=True
            )  # (R, 2m)
            w_y = jax.scipy.linalg.cho_solve((L_A, True), uz)  # (R,)
            resid_y = y_flat - Z @ w_y
            hh = half_s_over_m * half_s_over_m
            Hm = (hh * WtW - Sw.T @ Sw) / nu
            Hm = 0.5 * (Hm + Hm.T)  # exact-symmetric (the scan assumes it)
            t0_all = (
                (half_s_over_m * (Wp_flat.T @ resid_y)) / nu
            ).reshape(m, 2)
            quad0 = (y_flat @ resid_y) / nu
        elif params.refresh_style == "factor":
            # kern carries L (chol of K0), never K0^-1: every quantity the
            # coeff scan needs is a symmetric product through
            # K0^-1 = L^-T L^-1, so ONE lower-triangular solve with 2m+1
            # RHS replaces both the refresh's N-RHS inverse build and the
            # V0 matmul — no N-RHS solve anywhere in the step.
            L0 = state.kern.K
            Z = jax.scipy.linalg.solve_triangular(
                L0,
                jnp.concatenate([W_flat, y_flat[:, None]], axis=1),
                lower=True,
            )  # (N, 2m+1)
            Zw, zy = Z[:, :-1], Z[:, -1]
            Hm = Zw.T @ Zw  # (2m, 2m)
            t0_all = (Zw.T @ zy).reshape(m, 2)
            quad0 = zy @ zy
        else:
            K0_inv = state.kern.K_inv
            # the only N-sized work: two products, hoisted out of the scan
            KW = K0_inv @ W_flat  # (N, 2m)
            Hm = W_flat.T @ KW  # (2m, 2m)
            t0_all = (W_flat.T @ v_y0).reshape(m, 2)
        Tv_all = Hm.reshape(m2, m, 2).transpose(1, 0, 2)  # (m, 2m, 2)
        r = jnp.arange(m2)
        j2 = 2 * jnp.arange(m)
        E_all = jnp.stack(
            [
                (r[None, :] == j2[:, None]).astype(Hm.dtype),
                (r[None, :] == (j2 + 1)[:, None]).astype(Hm.dtype),
            ],
            axis=-1,
        )  # (m, 2m, 2)
        zeros_S = jnp.zeros((m2, m2), dtype=Hm.dtype)
        zeros_d = jnp.zeros((m2,), dtype=Hm.dtype)
        if params.refresh_style == "leaf":
            delta = (
                (batch.move == GROW).astype(jnp.int32)
                - (batch.move == PRUNE).astype(jnp.int32)
            )
            (_, _, K_logdet, _, cur_mll, _), accepts = jax.lax.scan(
                functools.partial(tree_move_coeff, cap=budget),
                (zeros_S, zeros_d, state.kern.K_logdet, quad0,
                 seed_mll(quad0, state.kern.K_logdet), total0),
                (
                    Tv_all,
                    E_all,
                    t0_all,
                    batch.log_q_prior,
                    jnp.log(batch.u_accept),
                    delta,
                ),
                unroll=params.scan_unroll,
            )
        else:
            (_, _, K_logdet, _, cur_mll), accepts = jax.lax.scan(
                tree_move_coeff,
                (zeros_S, zeros_d, state.kern.K_logdet, quad0,
                 seed_mll(quad0, state.kern.K_logdet)),
                (
                    Tv_all,
                    E_all,
                    t0_all,
                    batch.log_q_prior,
                    jnp.log(batch.u_accept),
                ),
                unroll=params.scan_unroll,
            )
        # K_inv output is discarded by the rank1 refresh
        K_inv = (
            _empty()
            if params.refresh_style in ("factor", "leaf")
            else K0_inv
        )
    elif scan_style == "aug":
        A0 = jnp.concatenate([state.kern.K_inv, v_y0[:, None]], axis=1)
        (A, K_logdet, _, cur_mll), accepts = jax.lax.scan(
            tree_move_aug,
            (A0, state.kern.K_logdet, quad0,
             seed_mll(quad0, state.kern.K_logdet)),
            (W_all, batch.log_q_prior, jnp.log(batch.u_accept)),
            unroll=params.scan_unroll,
        )
        K_inv = A[:, :-1]
    else:
        (K_inv, K_logdet, _, _, cur_mll), accepts = jax.lax.scan(
            tree_move,
            (state.kern.K_inv, state.kern.K_logdet, v_y0, quad0,
             seed_mll(quad0, state.kern.K_logdet)),
            (W_all, batch.log_q_prior, jnp.log(batch.u_accept)),
            unroll=params.scan_unroll,
        )
    forest, subs, leaves = _merge_accepted(packed0, state, batch, accepts)
    return forest, subs, leaves, K_inv, K_logdet, cur_mll


def _tree_moves_woodbury(
    key, state, X, y, mask, pad_count, bounds, feat_types, params, beta=1.0
):
    """The reference's incremental inverse maintenance
    (bark_sampler.py:233-264), with a single SPD Cholesky powering both the
    Woodbury inverse update and the determinant-lemma update per direction."""
    with jax.default_matmul_precision(MM_PRECISION):
        return _tree_moves_woodbury_impl(
            key, state, X, y, mask, pad_count, bounds, feat_types, params,
            beta,
        )


def _tree_moves_woodbury_impl(
    key, state, X, y, mask, pad_count, bounds, feat_types, params, beta=1.0
):
    num_cols = params.node_limit // 2
    s_sqrtm = jnp.sqrt(state.scale / params.num_trees)
    packed0, batch = _propose_all_trees(key, state, X, feat_types, bounds, params)
    # active-leaf masks from the packed records (is_leaf & active bits)
    leaf_mask_cur_all = (packed0[:, :, 0] & packed0[:, :, 7]) == 1
    leaf_mask_new_all = (batch.new_packed[:, :, 0] & batch.new_packed[:, :, 7]) == 1

    def compact_onehot(leaves_j, leaf_mask):
        ranks = jnp.cumsum(leaf_mask.astype(jnp.int32)) - 1
        return jax.nn.one_hot(ranks[leaves_j], num_cols, dtype=jnp.float32)

    def low_rank_update(K_inv, K_logdet, U, subtract):
        """(K ± UUᵀ)⁻¹ and logdet via Cholesky of M = I ∓ UᵀK⁻¹U (SPD both
        ways when the update keeps K PD)."""
        KU = K_inv @ U
        UKU = U.T @ KU
        eye = jnp.eye(U.shape[-1], dtype=K_inv.dtype)
        M = eye - UKU if subtract else eye + UKU
        Lm = jnp.linalg.cholesky(M)
        # logdet(K') = logdet(K) + logdet(I ± UᵀK⁻¹U); for subtract,
        # logdet(I - UᵀK⁻¹U) = chol-logdet(M)
        logdet_M = 2.0 * jnp.sum(jnp.log(jnp.diagonal(Lm)))
        W = jax.scipy.linalg.solve_triangular(Lm, KU.T, lower=True)
        correction = W.T @ W
        K_inv_new = K_inv + correction if subtract else K_inv - correction
        return K_inv_new, K_logdet + logdet_M

    def tree_move(carry, inputs):
        K_inv, K_logdet, cur_mll = carry
        (cur_lj, new_lj, leaf_mask_cur, leaf_mask_new, log_q_prior,
         log_u) = inputs

        row_mask = mask[:, None]
        U_cur = s_sqrtm * row_mask * compact_onehot(cur_lj, leaf_mask_cur)
        U_new = s_sqrtm * row_mask * compact_onehot(new_lj, leaf_mask_new)

        K_inv1, K_logdet1 = low_rank_update(K_inv, K_logdet, U_cur, subtract=True)
        K_inv2, K_logdet2 = low_rank_update(K_inv1, K_logdet1, U_new, subtract=False)

        new_mll = masked_mll(K_inv2, K_logdet2, y, state.noise, pad_count)
        log_alpha = log_q_prior + beta * (new_mll - cur_mll)
        accept = log_u <= jnp.minimum(log_alpha, 0.0)

        K_inv = jnp.where(accept, K_inv2, K_inv)
        K_logdet = jnp.where(accept, K_logdet2, K_logdet)
        cur_mll = jnp.where(accept, new_mll, cur_mll)
        return (K_inv, K_logdet, cur_mll), accept

    (K_inv, K_logdet, cur_mll), accepts = jax.lax.scan(
        tree_move,
        (state.kern.K_inv, state.kern.K_logdet, state.mll),
        (batch.cur_leavesT, batch.new_leavesT, leaf_mask_cur_all,
         leaf_mask_new_all, batch.log_q_prior, jnp.log(batch.u_accept)),
    )
    forest, subs, leaves = _merge_accepted(packed0, state, batch, accepts)
    return forest, subs, leaves, K_inv, K_logdet, cur_mll


def step(
    key: jax.Array,
    state: ChainState,
    X: jax.Array,
    y: jax.Array,
    bounds: jax.Array,
    feat_types: jax.Array,
    params: SamplerParams,
    mask: jax.Array | None = None,
    beta: jax.Array | float = 1.0,
) -> ChainState:
    """One full MCMC step: m tree moves + one noise/scale move.

    Parity: src/bark/fitting/bark_sampler.py:216-284. ``beta`` tempers the
    likelihood (beta=1 is the reference posterior).
    """
    params = _resolve_styles(params, X.shape[0])
    if mask is None:
        mask = jnp.ones((X.shape[0],), jnp.float32)
    pad_count = X.shape[0] - jnp.sum(mask)
    k_trees, k_hyper, k_hyper_accept = jax.random.split(key, 3)

    # --- noise/scale proposal (computed up-front; accept decided below) ---
    (new_noise, new_scale), log_q_prior = get_noise_scale_proposal(
        k_hyper, state.noise, state.scale, params
    )

    if params.kernel_backend == "chol":
        forest, subs, leaves, K, cur_mll = _tree_moves_chol(
            k_trees, state, X, y, mask, pad_count, bounds, feat_types, params, beta
        )
        # hyperparameter move: exact elementwise kernel rescale, no gram
        # rebuild needed (K is maintained exactly)
        eye = jnp.eye(K.shape[-1], dtype=K.dtype)
        gram_part = K - (JITTER + state.noise) * eye
        K_hyp = (new_scale / state.scale) * gram_part + (JITTER + new_noise) * eye
        new_mll, _ = _chol_mll(K_hyp, y.reshape(-1), new_noise, pad_count)

        log_alpha = log_q_prior + beta * (new_mll - cur_mll)
        u = jax.random.uniform(k_hyper_accept, dtype=jnp.float32)
        accept = jnp.log(u) <= jnp.minimum(log_alpha, 0.0)
        kern = KernState(
            K=jnp.where(accept, K_hyp, K), K_inv=_empty(), K_logdet=_empty()
        )
        return ChainState(
            forest=forest,
            leaves=leaves,
            noise=jnp.where(accept, new_noise, state.noise),
            scale=jnp.where(accept, new_scale, state.scale),
            kern=kern,
            mll=jnp.where(accept, new_mll, cur_mll),
            subspaces=subs,
        )

    if params.kernel_backend == "rank1":
        forest, subs, leaves, K_inv, K_logdet, cur_mll = _tree_moves_rank1(
            k_trees, state, X, y, mask, pad_count, bounds, feat_types, params,
            beta,
        )
        if params.refresh_style == "leaf":
            # N-free exact refresh: rebuild the COMPACT (N, R) leaf
            # indicator Z from the post-move leaves and refactorize both
            # MH branches in leaf space — one batched (2, R, R) Cholesky
            # of A_b = (nu_b/gamma_b) I + Z^T Z. logdet and quadratic via
            # the matrix-determinant lemma / Woodbury (the repo's tested
            # oracles, ops/linalg.py:60-88):
            #   logdet K_b = N log nu_b + R log(gamma_b/nu_b) + logdet A_b
            #   y^T K_b^-1 y = (y^T y - ||L_Ab^-1 Z^T y||^2) / nu_b
            # Zero compact columns (slots past the realized total) add
            # log(nu/gamma) to logdet A and cancel exactly against the
            # R log(gamma/nu) term, so padding the budget is inert. The
            # (N, N) gram is never built; drift control is identical to
            # the dense refresh (exact quantities once per step).
            budget = _leaf_budget(params, X.shape[0])
            y_flat = y.reshape(-1)
            # the indicator build's one-hot matmuls are bf16-exact and
            # stay at default precision; everything downstream carries
            # non-representable f32 operands and runs at "highest" (the
            # default's bf16 truncation measurably biased the posterior —
            # see _tree_moves_rank1 and results/ab_r5/precision_bug.md)
            Z, total_r = _leaf_Z(forest, leaves, budget, mask)
            # Z'Z is 0/1 x 0/1 — exact integer counts at default
            # precision (the N-sized product; no precision passes needed)
            G = Z.T @ Z  # (R, R) — shared by both branches
            with jax.default_matmul_precision(MM_PRECISION):
                uz = Z.T @ y_flat
                nu2 = jnp.stack([JITTER + state.noise, JITTER + new_noise])
                gam2 = jnp.stack([state.scale, new_scale]) / params.num_trees
                eyeR = jnp.eye(budget, dtype=G.dtype)
                A2 = G[None] + (nu2 / gam2)[:, None, None] * eyeR
                L2 = jnp.linalg.cholesky(A2)
                logdet_A2 = 2.0 * jnp.sum(
                    jnp.log(jnp.diagonal(L2, axis1=-2, axis2=-1)), axis=-1
                )
                K_logdet2 = (
                    X.shape[0] * jnp.log(nu2)
                    + budget * jnp.log(gam2 / nu2)
                    + logdet_A2
                )
                # residual-form quadratic (see the coeff-hoist/init
                # branches: the Gram-difference form cancels
                # catastrophically at small noise and biases the noise
                # posterior)
                w2 = jax.scipy.linalg.cho_solve(
                    (L2, True), jnp.broadcast_to(uz, (2, uz.size))[..., None]
                )[..., 0]  # (2, R) = A_b^{-1} Z^T y
                resid2 = y_flat[None, :] - w2 @ Z.T  # (2, N)
                quad2 = (resid2 @ y_flat) / nu2
                mll2 = 0.5 * (-quad2 - K_logdet2 + pad_count * jnp.log(nu2))
            # over-budget packing is unreachable from a valid init (the
            # move scan rejects grows at capacity), but if an invalid
            # state got in, keep the NaN poison flowing (see
            # init_chain_state) instead of resuming on a wrong kernel
            mll2 = jnp.where(total_r <= budget, mll2, jnp.nan)
            cur_mll, new_mll = mll2[0], mll2[1]

            log_alpha = log_q_prior + beta * (new_mll - cur_mll)
            u = jax.random.uniform(k_hyper_accept, dtype=jnp.float32)
            accept = jnp.log(u) <= jnp.minimum(log_alpha, 0.0)
            kern = KernState(
                K=jnp.where(accept, L2[1], L2[0]),
                K_inv=_empty(),
                K_logdet=jnp.where(accept, K_logdet2[1], K_logdet2[0]),
            )
            return ChainState(
                forest=forest,
                leaves=leaves,
                noise=jnp.where(accept, new_noise, state.noise),
                scale=jnp.where(accept, new_scale, state.scale),
                kern=kern,
                mll=jnp.where(accept, new_mll, cur_mll),
                subspaces=subs,
            )
        # exact once-per-step refresh: rebuild the Gram matrix from the
        # maintained leaves and refactorize BOTH MH branches, so the
        # accept ratio uses exact quantities and Sherman-Morrison drift
        # cannot outlive one step (50 rank-1 updates).
        gram = gram_from_leaves(
            leaves, leaves, params.node_limit, mask, mask,
            onehot_dtype=(
                jnp.bfloat16 if params.gram_dtype == "bf16" else jnp.float32
            ),
        )
        blk = _chol_block(params, X.shape[0])
        if params.refresh_style == "factor":
            # factor refresh: both branch MLLs from one batched Cholesky +
            # single-RHS solves (like onesolve), but the selected branch's
            # FACTOR is the carry — the N-RHS inverse build never happens;
            # the next step's coeff scan consumes L through one 2m+1-RHS
            # lower solve.
            K2 = jnp.stack(
                [
                    kernel_matrix(gram, state.noise, state.scale),
                    kernel_matrix(gram, new_noise, new_scale),
                ]
            )
            L2 = blocked_cholesky(K2, block=blk)
            logdet2 = 2.0 * jnp.sum(
                jnp.log(jnp.diagonal(L2, axis1=-2, axis2=-1)), axis=-1
            )
            y2 = jnp.broadcast_to(y.reshape(-1), (2, y.size))[..., None]
            z2 = jax.scipy.linalg.solve_triangular(L2, y2, lower=True)[..., 0]
            quad2 = jnp.sum(z2 * z2, axis=-1)
            corr = jnp.stack(
                [
                    pad_count * jnp.log(JITTER + state.noise),
                    pad_count * jnp.log(JITTER + new_noise),
                ]
            )
            mll2 = 0.5 * (-quad2 - logdet2 + corr)
            cur_mll, new_mll = mll2[0], mll2[1]

            log_alpha = log_q_prior + beta * (new_mll - cur_mll)
            u = jax.random.uniform(k_hyper_accept, dtype=jnp.float32)
            accept = jnp.log(u) <= jnp.minimum(log_alpha, 0.0)
            kern = KernState(
                K=jnp.where(accept, L2[1], L2[0]),
                K_inv=_empty(),
                K_logdet=jnp.where(accept, logdet2[1], logdet2[0]),
            )
            return ChainState(
                forest=forest,
                leaves=leaves,
                noise=jnp.where(accept, new_noise, state.noise),
                scale=jnp.where(accept, new_scale, state.scale),
                kern=kern,
                mll=jnp.where(accept, new_mll, cur_mll),
                subspaces=subs,
            )
        if params.refresh_style == "onesolve":
            # both branches' exact MLLs come from one batched Cholesky +
            # one single-RHS triangular solve (z = L⁻¹y, mll from ‖z‖²);
            # the expensive N-RHS inverse solve runs ONCE, on the selected
            # branch's factor (the N-RHS triangular solve is a serial
            # substitution, the costliest op of a dense refresh).
            K2 = jnp.stack(
                [
                    kernel_matrix(gram, state.noise, state.scale),
                    kernel_matrix(gram, new_noise, new_scale),
                ]
            )
            L2 = blocked_cholesky(K2, block=blk)
            logdet2 = 2.0 * jnp.sum(
                jnp.log(jnp.diagonal(L2, axis1=-2, axis2=-1)), axis=-1
            )
            y2 = jnp.broadcast_to(y.reshape(-1), (2, y.size))[..., None]
            z2 = jax.scipy.linalg.solve_triangular(L2, y2, lower=True)[..., 0]
            quad2 = jnp.sum(z2 * z2, axis=-1)
            corr = jnp.stack(
                [
                    pad_count * jnp.log(JITTER + state.noise),
                    pad_count * jnp.log(JITTER + new_noise),
                ]
            )
            mll2 = 0.5 * (-quad2 - logdet2 + corr)
            cur_mll, new_mll = mll2[0], mll2[1]
            cur_logdet, new_logdet = logdet2[0], logdet2[1]

            log_alpha = log_q_prior + beta * (new_mll - cur_mll)
            u = jax.random.uniform(k_hyper_accept, dtype=jnp.float32)
            accept = jnp.log(u) <= jnp.minimum(log_alpha, 0.0)

            L_sel = jnp.where(accept, L2[1], L2[0])
            eye = jnp.eye(L_sel.shape[-1], dtype=L_sel.dtype)
            L_inv = jax.scipy.linalg.solve_triangular(L_sel, eye, lower=True)
            K_inv_sel = L_inv.T @ L_inv
            kern = KernState(
                K=_empty(),
                K_inv=K_inv_sel,
                K_logdet=jnp.where(accept, new_logdet, cur_logdet),
            )
            return ChainState(
                forest=forest,
                leaves=leaves,
                noise=jnp.where(accept, new_noise, state.noise),
                scale=jnp.where(accept, new_scale, state.scale),
                kern=kern,
                mll=jnp.where(accept, new_mll, cur_mll),
                subspaces=subs,
            )
        if params.refresh_style == "batched":
            # one batched (2, N, N) factorization for both MH branches —
            # halves the refresh's sequential Cholesky latency
            K2 = jnp.stack(
                [
                    kernel_matrix(gram, state.noise, state.scale),
                    kernel_matrix(gram, new_noise, new_scale),
                ]
            )
            inv2, logdet2 = chol_inv_logdet(K2, block=blk)
            cur_inv, new_inv = inv2[0], inv2[1]
            cur_logdet, new_logdet = logdet2[0], logdet2[1]
        else:  # "pair"
            K_cur = kernel_matrix(gram, state.noise, state.scale)
            cur_inv, cur_logdet = chol_inv_logdet(K_cur, block=blk)
            K_new = kernel_matrix(gram, new_noise, new_scale)
            new_inv, new_logdet = chol_inv_logdet(K_new, block=blk)
        cur_mll = masked_mll(cur_inv, cur_logdet, y, state.noise, pad_count)
        new_mll = masked_mll(new_inv, new_logdet, y, new_noise, pad_count)

        log_alpha = log_q_prior + beta * (new_mll - cur_mll)
        u = jax.random.uniform(k_hyper_accept, dtype=jnp.float32)
        accept = jnp.log(u) <= jnp.minimum(log_alpha, 0.0)
        kern = KernState(
            K=_empty(),
            K_inv=jnp.where(accept, new_inv, cur_inv),
            K_logdet=jnp.where(accept, new_logdet, cur_logdet),
        )
        return ChainState(
            forest=forest,
            leaves=leaves,
            noise=jnp.where(accept, new_noise, state.noise),
            scale=jnp.where(accept, new_scale, state.scale),
            kern=kern,
            mll=jnp.where(accept, new_mll, cur_mll),
            subspaces=subs,
        )

    # --- woodbury backend: full K rebuild at the hyper move
    # (bark_sampler.py:266-270) ---
    forest, subs, leaves, K_inv, K_logdet, cur_mll = _tree_moves_woodbury(
        k_trees, state, X, y, mask, pad_count, bounds, feat_types, params, beta
    )
    gram = gram_from_leaves(
        leaves, leaves, params.node_limit, mask, mask,
        onehot_dtype=jnp.bfloat16 if params.gram_dtype == "bf16" else jnp.float32,
    )
    K = kernel_matrix(gram, new_noise, new_scale)
    blk = _chol_block(params, X.shape[0])
    new_K_inv, new_K_logdet = chol_inv_logdet(K, block=blk)
    new_mll = masked_mll(new_K_inv, new_K_logdet, y, new_noise, pad_count)

    log_alpha = log_q_prior + beta * (new_mll - cur_mll)
    u = jax.random.uniform(k_hyper_accept, dtype=jnp.float32)
    accept = jnp.log(u) <= jnp.minimum(log_alpha, 0.0)

    kern = KernState(
        K=_empty(),
        K_inv=jnp.where(accept, new_K_inv, K_inv),
        K_logdet=jnp.where(accept, new_K_logdet, K_logdet),
    )
    return ChainState(
        forest=forest,
        leaves=leaves,
        noise=jnp.where(accept, new_noise, state.noise),
        scale=jnp.where(accept, new_scale, state.scale),
        kern=kern,
        mll=jnp.where(accept, new_mll, cur_mll),
        subspaces=subs,
    )


def _run_chain(
    key: jax.Array,
    forest: Forest,
    noise: jax.Array,
    scale: jax.Array,
    X: jax.Array,
    y: jax.Array,
    bounds: jax.Array,
    feat_types: jax.Array,
    params: SamplerParams,
    mask: jax.Array | None = None,
) -> tuple[BARKModel, ChainState, jax.Array]:
    """Run one chain: warmup then ``num_samples`` thinned samples.

    Returns (samples, final state, per-sample MLL trace). Un-jitted body so
    multi-chain drivers can vmap it inside ONE jit trace and XLA can
    dead-code-eliminate whichever outputs a driver discards (a nested-jit
    call boundary kept the full final ChainState — including the (N, N)
    kernel carry — alive in every caller and cost time at large N).
    """
    state = init_chain_state(
        forest, noise, scale, X, y, feat_types, params, mask, bounds=bounds
    )

    def one_step(state, k):
        return step(k, state, X, y, bounds, feat_types, params, mask), None

    if params.warmup_steps > 0:
        key, k_warm = jax.random.split(key)
        warm_keys = jax.random.split(k_warm, params.warmup_steps)
        state, _ = jax.lax.scan(one_step, state, warm_keys)

    def one_sample(state, k):
        keys = jax.random.split(k, params.steps_per_sample)
        state, _ = jax.lax.scan(one_step, state, keys)
        return state, (state.forest, state.noise, state.scale, state.mll)

    sample_keys = jax.random.split(key, params.num_samples)
    state, (forests, noises, scales, mlls) = jax.lax.scan(
        one_sample, state, sample_keys
    )
    return BARKModel(forest=forests, noise=noises, scale=scales), state, mlls


run_chain = functools.partial(jax.jit, static_argnames=("params",))(_run_chain)
run_chain.__doc__ = _run_chain.__doc__


@functools.partial(jax.jit, static_argnames=("params",))
def run_bark_sampler(
    key: jax.Array,
    model: BARKModel,
    X: jax.Array,
    y: jax.Array,
    bounds: jax.Array,
    feat_types: jax.Array,
    params: SamplerParams,
    mask: jax.Array | None = None,
) -> BARKModel:
    """Multi-chain driver: vmap chains on-chip.

    Parity: src/bark/fitting/bark_sampler.py:95-213 — model fields carry a
    leading ``(num_chains,)`` axis; returns samples with leading
    ``(num_chains, num_samples)`` axes. ``mask`` marks real training rows
    when X/y are padded to a bucket size (fixed-shape BO path). For
    multi-chip sharding see bark_jax.parallel.sharding.
    """
    num_chains = model.noise.shape[0]
    keys = jax.random.split(key, num_chains)
    # subset INSIDE the jit trace: the discarded final ChainState (with its
    # (N, N) kernel carry) is then dead code, not a forced output
    samples = jax.vmap(
        lambda k, f, n, s: _run_chain(
            k, f, n, s, X, y, bounds, feat_types, params, mask
        )[0]
    )(keys, model.forest, model.noise, model.scale)
    return samples


@functools.partial(jax.jit, static_argnames=("params",))
def run_bark_sampler_with_trace(
    key: jax.Array,
    model: BARKModel,
    X: jax.Array,
    y: jax.Array,
    bounds: jax.Array,
    feat_types: jax.Array,
    params: SamplerParams,
    mask: jax.Array | None = None,
) -> tuple[BARKModel, jax.Array]:
    """Like run_bark_sampler but also returns per-sample MLL traces
    ``(num_chains, num_samples)`` — the diagnostics path mirroring
    examples/mcmc/mcmc_record_mll.py in the reference."""
    num_chains = model.noise.shape[0]
    keys = jax.random.split(key, num_chains)
    def one(k, f, n, s):
        samples, _, mlls = _run_chain(
            k, f, n, s, X, y, bounds, feat_types, params, mask
        )
        return samples, mlls

    samples, mlls = jax.vmap(one)(keys, model.forest, model.noise, model.scale)
    return samples, mlls
