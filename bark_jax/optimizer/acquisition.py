"""Acquisition function over the sampled BARK posterior.

Parity target: the objective encoded in the reference's MIP
(src/bark/optimizer/opt_model.py:19-117): minimize over x the sample-average
LCB

    (1/S) * sum_s [ mu_s(x) - kappa * sigma_s(x) ]

where, per posterior sample s (with the *null-tree-free* agreement kernel,
opt_model.py:54-59 / gbm_model.py:46-50):

    mu_s(x)     = scale_s * k_s(x)ᵀ K_s⁻¹ y
    sigma_s²(x) = scale_s - scale_s² * k_s(x)ᵀ K_s⁻¹ k_s(x)

``k_s(x)`` is the per-sample agreement vector between x and the training
points, K_s = scale_s * gram + (jitter + noise_s) I. The reference encodes
this as Gurobi quadratic constraints over leaf-indicator variables; here it
is evaluated exactly, in batch, for thousands of candidates at once — one
one-hot matmul per posterior sample, fused by XLA.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bark_jax.fitting.sampler import BARKModel
from bark_jax.forest import (
    Forest,
    compact_leaf_indicator,
    gram_from_leaves,
    num_null_trees,
    route_forest_auto,
)
from bark_jax.ops.linalg import MM_PRECISION, JITTER, robust_chol_inv_logdet

DEFAULT_KAPPA = 1.96  # parity: strategies/tree_kernel.py:45

#: padded training-set size past which the strategy's ``acq_backend="auto"``
#: switches from the dense (S, N, N) builder to the factored low-rank one —
#: the same wall as models/surrogate.py's cg_threshold. Chosen on the
#: accelerator the system was first tuned on; not yet measured on the H100.
LR_THRESHOLD = 2048


class AcquisitionState(NamedTuple):
    """Precomputed per-sample quantities reused across candidate batches."""

    forest: Forest  # (S, m, node_limit)
    noise: jax.Array  # (S,)
    scale: jax.Array  # (S,)
    train_leaves: jax.Array  # (S, N, m)
    K_inv: jax.Array  # (S, N, N)
    K_inv_y: jax.Array  # (S, N)
    n_null: jax.Array  # (S,)
    train_mask: jax.Array  # (N,)


@functools.partial(jax.jit, static_argnames=("max_depth",))
def build_acquisition(
    model: BARKModel,
    train_x: jax.Array,
    train_y: jax.Array,
    feat_types: jax.Array,
    max_depth: int = 16,
    train_mask: jax.Array | None = None,
) -> AcquisitionState:
    """Flatten posterior samples and factorize their kernels once.

    Parity: the K⁻¹-per-sample precomputation in opt_model.py:54-59, using
    the no-null-rescaled gram exactly as the reference does.
    """
    m, node_limit = model.forest.num_trees, model.forest.node_limit
    forest = jax.tree.map(lambda a: a.reshape(-1, m, node_limit), model.forest)
    noise = model.noise.reshape(-1).astype(jnp.float32)
    scale = model.scale.reshape(-1).astype(jnp.float32)
    if train_mask is None:
        train_mask = jnp.ones((train_x.shape[0],), jnp.float32)
    y = train_y.reshape(-1)

    n_null = num_null_trees(forest).astype(jnp.float32)
    # train routing through the platform's router (forest.router_for)
    route = route_forest_auto

    def per_sample(tree_sample: Forest, noise_s, scale_s, n_null_s):
        leaves = route(tree_sample, train_x, feat_types, max_depth)
        gram = gram_from_leaves(
            leaves, leaves, node_limit, train_mask, train_mask
        )
        # no-null rescaling (forest.py:101-111); keep masked rows at zero
        denom = jnp.maximum(m - n_null_s, 1.0)
        outer = train_mask[:, None] * train_mask[None, :]
        gram = (gram - (n_null_s / m) * outer) * (m / denom)
        K = scale_s * gram + (JITTER + noise_s) * jnp.eye(
            train_x.shape[0], dtype=gram.dtype
        )
        K_inv, _ = robust_chol_inv_logdet(K)  # jitter escalation
        return leaves, K_inv, K_inv @ y

    train_leaves, K_inv, K_inv_y = jax.vmap(per_sample)(
        forest, noise, scale, n_null
    )
    return AcquisitionState(
        forest=forest,
        noise=noise,
        scale=scale,
        train_leaves=train_leaves,
        K_inv=K_inv,
        K_inv_y=K_inv_y,
        n_null=n_null,
        train_mask=train_mask,
    )


@functools.partial(jax.jit, static_argnames=("max_depth", "kappa"))
def _evaluate_acquisition_dense(
    acq: AcquisitionState,
    candidates: jax.Array,
    feat_types: jax.Array,
    max_depth: int = 16,
    kappa: float = DEFAULT_KAPPA,
) -> jax.Array:
    """Sample-average LCB for a ``(B, D)`` candidate batch; lower is better.

    Parity: the MIP objective and variance constraint,
    opt_model.py:75-111.
    """
    node_limit = acq.forest.node_limit
    m = acq.forest.num_trees

    # routing lowering by platform (bit-identical results, tested; chosen
    # by timing both routers at this scoring shape, forest.router_for)
    route = route_forest_auto

    def per_sample(tree_sample, noise_s, scale_s, n_null_s, leaves_s, K_inv_s, w_s):
        cand_leaves = route(tree_sample, candidates, feat_types, max_depth)
        k_vec = gram_from_leaves(
            cand_leaves, leaves_s, node_limit, None, acq.train_mask
        )  # (B, N)
        denom = jnp.maximum(m - n_null_s, 1.0)
        k_vec = (k_vec - (n_null_s / m) * acq.train_mask[None, :]) * (m / denom)
        mu = scale_s * (k_vec @ w_s)
        quad = jnp.sum((k_vec @ K_inv_s) * k_vec, axis=-1)
        var = jnp.maximum(scale_s - scale_s**2 * quad, 1e-12)
        return mu - kappa * jnp.sqrt(var)

    per_sample_lcb = jax.vmap(per_sample)(
        acq.forest,
        acq.noise,
        acq.scale,
        acq.n_null,
        acq.train_leaves,
        acq.K_inv,
        acq.K_inv_y,
    )  # (S, B)
    return jnp.mean(per_sample_lcb, axis=0)


# --- factored (matrix-free) acquisition — the large-N path ----------------
#
# The agreement kernel factorizes: with Z the (N, r) leaf-indicator matrix
# (one column per (tree, leaf) pair, entry sigma_z = 1/sqrt(m - n_null) for
# non-null trees, null-tree columns zero — exactly the no-null rescaling,
# because a null tree's "agreement" is the constant its own all-ones column
# would contribute), the no-null gram is Z Zᵀ and
#
#     K = nu I + s Z Zᵀ,   nu = jitter + noise,  s = scale.
#
# Woodbury with M = I_r + (s/nu) ZᵀZ collapses every acquisition term into
# r-space, where two identities make the result exceptionally clean:
#
#     Zᵀ K⁻¹ y = (1/nu) M⁻¹ Zᵀ y            (the posterior-mean weights)
#     Zᵀ K⁻¹ Z = (1/s) (I - M⁻¹)            (since (s/nu) ZᵀZ = M - I)
#
# and because every candidate's indicator z has ||z||² = 1 (one leaf per
# non-null tree), the LCB variance term telescopes:
#
#     var(x) = s - s² zᵀ(ZᵀK⁻¹Z)z = s (1 - ||z||² + zᵀM⁻¹z) = s ||Lm⁻¹ z||²
#
# — a pure sum of squares (no cancellation), with Lm = chol(M). Scoring a
# candidate batch is then one one-hot (B, r) x (r, r) matmul per posterior
# sample: **independent of N**. N appears only in the one-time build
# (G = ZᵀZ, an exact bf16 one-hot matmul, and one r x r
# Cholesky), so ask() scales to training sets far past the dense
# (S, N, N) memory wall — the wall the reference hits at
# src/bark/optimizer/opt_model.py:54-59. r = m * max_leaves with leaves compacted to dense ranks
# (max_leaves = (node_limit + 1) // 2), a 4x FLOP saving over node slots.


class AcquisitionStateLR(NamedTuple):
    """Factored acquisition state: everything scoring needs, nothing O(N)."""

    forest: Forest  # (S, m, node_limit) — for candidate routing + leaf boxes
    beta: jax.Array  # (S, r) — mu(x) = h(x) @ beta (scale, sigma_z folded in)
    V: jax.Array  # (S, r, r) — var(x) = scale * ||V @ h(x)||^2 + var0
    scale: jax.Array  # (S,)
    var0: jax.Array  # (S,) residual variance when every tree is null


def _compact_indicator_nonull(
    tree_sample: Forest, leaves: jax.Array, max_leaves: int
) -> jax.Array:
    """(B, r) compact 0/1 leaf indicators with null-tree blocks zeroed.

    forest.compact_leaf_indicator (one projection matmul, no gathers — the
    (B, m) rank gather measured slower at batch scale in the first tuning
    round) with the single-leaf trees' blocks masked
    out, matching the no-null gram rescaling semantics
    (src/bark/forest.py:101-111).
    """
    z = compact_leaf_indicator(tree_sample, leaves, max_leaves)
    nonnull = ~tree_sample.is_leaf[:, 0]  # (m,)
    mask = jnp.repeat(nonnull, max_leaves)
    return z * mask[None, :].astype(z.dtype)


@functools.partial(jax.jit, static_argnames=("max_depth", "row_block"))
def build_acquisition_lr(
    model: BARKModel,
    train_x: jax.Array,
    train_y: jax.Array,
    feat_types: jax.Array,
    max_depth: int = 16,
    train_mask: jax.Array | None = None,
    row_block: int | None = None,
) -> AcquisitionStateLR:
    """Build the factored acquisition state; never materializes anything NxN.

    Exactly equal (up to float32 factorization round-off) to the dense
    ``build_acquisition`` + ``evaluate_acquisition`` scores — tested at
    N=512 — but O(N r) memory and O(N r²) one-time build work, with
    N-independent scoring.

    ``row_block`` (None = auto: 4096 once N > 4096, off below) accumulates
    the Gram/projection sufficient statistics ``(G, u)`` over row blocks in
    a ``lax.scan``: peak build memory drops from O(N r) (the (N, r)
    indicator matrix, 105 MB/sample bf16 at N=32768) to O(r²) + one block,
    and the one-shot XLA program that previously grew linearly in N
    becomes a loop over identical block programs. Train routing goes
    through the platform's router (forest.router_for), as
    evaluate_acquisition's does.
    """
    m, node_limit = model.forest.num_trees, model.forest.node_limit
    max_leaves = (node_limit + 1) // 2
    r = m * max_leaves
    forest = jax.tree.map(lambda a: a.reshape(-1, m, node_limit), model.forest)
    noise = model.noise.reshape(-1).astype(jnp.float32)
    scale = model.scale.reshape(-1).astype(jnp.float32)
    if train_mask is None:
        train_mask = jnp.ones((train_x.shape[0],), jnp.float32)
    y = train_y.reshape(-1).astype(jnp.float32)
    n_null = num_null_trees(forest).astype(jnp.float32)

    n = train_x.shape[0]
    if row_block is None:
        row_block = 4096 if n > 4096 else 0
    if row_block and n > row_block:
        pad = (-n) % row_block
        train_x = jnp.pad(train_x, ((0, pad), (0, 0)))
        y = jnp.pad(y, (0, pad))
        train_mask = jnp.pad(train_mask, (0, pad))  # zero mask rows: inert
        nb = (n + pad) // row_block
        x_blocks = train_x.reshape(nb, row_block, -1)
        y_blocks = y.reshape(nb, row_block)
        m_blocks = train_mask.reshape(nb, row_block)
    else:
        row_block = 0

    route = route_forest_auto

    def per_sample(tree_sample: Forest, noise_s, scale_s, n_null_s):
        def block_stats(xb, yb, mb):
            """(G, u) contributions of one row block — 0/1 indicators from
            one bf16 projection matmul (exact counts, f32 accumulation;
            no rank gathers)."""
            leaves = route(tree_sample, xb, feat_types, max_depth)
            Z01 = _compact_indicator_nonull(tree_sample, leaves, max_leaves)
            Z01 = Z01 * mb[:, None].astype(Z01.dtype)
            Gb = jax.lax.dot_general(
                Z01,
                Z01,
                dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )  # (r, r) exact counts
            ub = jax.lax.dot_general(
                Z01.astype(jnp.float32),
                (yb * mb)[:, None],
                dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )[:, 0]  # Z01ᵀ y  (r,)
            return Gb, ub

        if row_block:
            def body(carry, xs):
                G_acc, u_acc = carry
                Gb, ub = block_stats(*xs)
                return (G_acc + Gb, u_acc + ub), ()

            (G, u), _ = jax.lax.scan(
                body,
                (
                    jnp.zeros((r, r), jnp.float32),
                    jnp.zeros((r,), jnp.float32),
                ),
                (x_blocks, y_blocks, m_blocks),
            )
        else:
            G, u = block_stats(train_x, y, train_mask)

        nn = jnp.maximum(m - n_null_s, 1.0)
        sigma2 = 1.0 / nn  # sigma_z^2
        nu = JITTER + noise_s
        M = jnp.eye(r, dtype=jnp.float32) + (scale_s / nu) * sigma2 * G
        # M >= I so Cholesky cannot hit a non-PD pivot; escalation guards
        # only float32 round-off at extreme scale/nu ratios.
        Lm = _robust_cholesky_psd_plus_eye(M)
        V = jax.scipy.linalg.solve_triangular(
            Lm, jnp.eye(r, dtype=jnp.float32), lower=True
        )  # Lm^{-1}
        sigma_z = jnp.sqrt(sigma2) * jnp.where(n_null_s >= m, 0.0, 1.0)
        t = jax.scipy.linalg.solve_triangular(Lm, sigma_z * u, lower=True)
        beta_raw = (
            jax.scipy.linalg.solve_triangular(Lm.T, t, lower=False) / nu
        )  # (1/nu) M^{-1} Zsᵀ y

        # fold scale and sigma_z so scoring is plain one-hot contractions
        beta = scale_s * sigma_z * beta_raw
        V = sigma_z * V
        var0 = scale_s * (1.0 - jnp.where(n_null_s >= m, 0.0, 1.0))
        return beta, V, var0

    beta, V, var0 = jax.vmap(per_sample)(forest, noise, scale, n_null)
    return AcquisitionStateLR(
        forest=forest,
        beta=beta,
        V=V,
        scale=scale,
        var0=var0,
    )


def _robust_cholesky_psd_plus_eye(M: jax.Array) -> jax.Array:
    """Cholesky of ``M = I + PSD`` with in-graph diagonal escalation.

    Mathematically always PD; float32 round-off at condition numbers near
    1/eps can still produce a non-finite factor, in which case a slightly
    damped M is factorized instead (equivalent to a hair more noise — the
    same trade ops/linalg.robust_chol_inv_logdet makes on the dense path).
    """
    L = jnp.linalg.cholesky(M)
    ok = jnp.all(jnp.isfinite(L))
    for f in (1e-4, 1e-2):
        L2 = jnp.linalg.cholesky(M + f * jnp.eye(M.shape[-1], dtype=M.dtype))
        L = jnp.where(ok, L, L2)
        ok = jnp.all(jnp.isfinite(L))
    return L


@functools.partial(jax.jit, static_argnames=("max_depth", "kappa"))
def _evaluate_acquisition_lr(
    acq: AcquisitionStateLR,
    candidates: jax.Array,
    feat_types: jax.Array,
    max_depth: int = 16,
    kappa: float = DEFAULT_KAPPA,
) -> jax.Array:
    """Sample-average LCB from the factored state; N never appears."""
    node_limit = acq.forest.node_limit
    max_leaves = (node_limit + 1) // 2

    route = route_forest_auto

    def per_sample(tree_sample, beta, V, scale_s, var0_s):
        leaves = route(tree_sample, candidates, feat_types, max_depth)
        h = _compact_indicator_nonull(tree_sample, leaves, max_leaves)  # (B, r)
        mu = h @ beta
        # HIGHEST keeps V at full float32 (a default-precision matmul may
        # round V, to TF32 on the H100; h is 0/1 and exact either way).
        acc = jax.lax.dot_general(
            h,
            V,
            dimension_numbers=(((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )  # (B, r) = h @ Vᵀ  = (Lm^{-1} z)ᵀ
        var = scale_s * jnp.sum(acc * acc, axis=-1) + var0_s
        var = jnp.maximum(var, 1e-12)
        return mu - kappa * jnp.sqrt(var)

    per_sample_lcb = jax.vmap(per_sample)(
        acq.forest, acq.beta, acq.V, acq.scale, acq.var0
    )  # (S, B)
    return jnp.mean(per_sample_lcb, axis=0)


# --- Thompson-sampling acquisition ------------------------------------------


class AcquisitionStateTS(NamedTuple):
    """Thompson-sampling acquisition: one exact posterior function draw.

    The agreement GP is identically Bayesian linear regression over compact
    leaf indicators (models/sampling.leaf_function_samples), so a Thompson
    draw is a single leaf-weight vector theta ~ p(theta | y) for one
    uniformly-chosen posterior (forest, noise, scale) sample, and
    score(x) = z_x^T theta — exact full-joint draw, O(r) per candidate,
    N never appears at scoring time. Optimizing it with the same search +
    leaf-box centering IS Thompson sampling over the piecewise-constant
    posterior (capability parity: the reference's stale
    thompson_sampling.py:9-27 only ever drew f* values at train sites).
    """

    forest: Forest  # (1, m, node_limit) — the chosen posterior forest
    theta: jax.Array  # (r,) leaf weights of the draw


@functools.partial(jax.jit, static_argnames=("max_depth",))
def build_acquisition_ts(
    key: jax.Array,
    model: BARKModel,
    train_x: jax.Array,
    train_y: jax.Array,
    feat_types: jax.Array,
    max_depth: int = 16,
    train_mask: jax.Array | None = None,
) -> AcquisitionStateTS:
    """One exact posterior function draw as an acquisition state.

    theta | y ~ N(A^{-1} Z^T y, nu A^{-1}) with A = (nu/gamma) I + Z^T Z
    (the same closed form forest_predict_leaf/leaf_function_samples use;
    A is SPD by construction, no clamping). A fresh key per ask() gives
    the TS exploration distribution.
    """
    m, node_limit = model.forest.num_trees, model.forest.node_limit
    max_leaves = (node_limit + 1) // 2
    flat = jax.tree.map(lambda a: a.reshape(-1, m, node_limit), model.forest)
    noise = model.noise.reshape(-1).astype(jnp.float32)
    scale = model.scale.reshape(-1).astype(jnp.float32)
    y = train_y.reshape(-1).astype(jnp.float32)
    if train_mask is not None:
        y = y * train_mask

    k_pick, k_draw = jax.random.split(key)
    s = jax.random.randint(k_pick, (), 0, noise.shape[0])
    tree_sample = jax.tree.map(lambda a: a[s], flat)
    noise_s, scale_s = noise[s], scale[s]

    train_leaves = route_forest_auto(
        tree_sample, train_x, feat_types, max_depth
    )
    Z = compact_leaf_indicator(tree_sample, train_leaves, max_leaves)
    if train_mask is not None:
        Z = Z * train_mask[:, None]
    nu = JITTER + noise_s
    gamma = scale_s / m
    r = Z.shape[1]
    A = Z.T @ Z + (nu / gamma) * jnp.eye(r, dtype=jnp.float32)
    L_A = jnp.linalg.cholesky(A)
    with jax.default_matmul_precision(MM_PRECISION):
        # full-mantissa y-side products (Z'Z above is exact at default;
        # results/ab_r5/precision_bug.md)
        theta_bar = jax.scipy.linalg.cho_solve((L_A, True), Z.T @ y)
    eps = jax.random.normal(k_draw, (r,), jnp.float32)
    theta = theta_bar + jnp.sqrt(nu) * jax.scipy.linalg.solve_triangular(
        L_A.T, eps, lower=False
    )
    return AcquisitionStateTS(
        forest=jax.tree.map(lambda a: a[None], tree_sample), theta=theta
    )


@functools.partial(jax.jit, static_argnames=("max_depth", "kappa"))
def _evaluate_acquisition_ts(
    acq: AcquisitionStateTS,
    candidates: jax.Array,
    feat_types: jax.Array,
    max_depth: int = 16,
    kappa: float = DEFAULT_KAPPA,
) -> jax.Array:
    """Score = the drawn function's value (kappa unused; lower is better)."""
    del kappa
    node_limit = acq.forest.node_limit
    max_leaves = (node_limit + 1) // 2
    route = route_forest_auto
    tree_sample = jax.tree.map(lambda a: a[0], acq.forest)
    leaves = route(tree_sample, candidates, feat_types, max_depth)
    h = compact_leaf_indicator(tree_sample, leaves, max_leaves)
    return h @ acq.theta


# --- multi-task (multi-fidelity) acquisition --------------------------------


class AcquisitionStateMOGP(NamedTuple):
    """Target-fidelity acquisition over a fitted multi-task tree GP.

    The reference's single-forest MIP builder accepts LeafGP *and* LeafMOGP
    (src/bark/optimizer/opt_model.py:167-284, task-0 row of the index
    kernel); this is the sampled-search analogue. The kernel between a
    candidate (at the target task 0) and training point j (at task t_j) is
    ``agreement(x, x_j) * B[0, t_j]`` — ``k_scale`` folds the index-kernel
    column so scoring stays one gram matmul.
    """

    forest: Forest  # (1, m, node_limit) — single booster forest
    train_leaves: jax.Array  # (N, m)
    k_scale: jax.Array  # (N,) = B[0, task_j]
    K_inv: jax.Array  # (N, N) inverse of the full multi-task K + noise
    K_inv_y: jax.Array  # (N,)
    prior_var: jax.Array  # scalar B[0, 0] (agreement diag is 1)


def build_acquisition_mogp(mogp) -> AcquisitionStateMOGP:
    """Build the target-fidelity acquisition from a LeafMOGPSurrogate.

    Uses the surrogate's fitted (forest, task covariance, per-task noise);
    y is in standardized units, matching the BARK acquisition convention.
    """
    from bark_jax.models.mogp import mogp_kernel, task_covariance, _softplus

    X, tasks, y, leaves, gram = mogp.train
    B = task_covariance(mogp.params)
    noise = _softplus(mogp.params.raw_noise)[tasks]
    K = mogp_kernel(gram, tasks, tasks, mogp.params) + jnp.diag(JITTER + noise)
    K_inv, _ = robust_chol_inv_logdet(K)
    return AcquisitionStateMOGP(
        forest=jax.tree.map(lambda a: a[None], mogp.forest),
        train_leaves=leaves,
        k_scale=B[0, tasks],
        K_inv=K_inv,
        K_inv_y=K_inv @ y,
        prior_var=B[0, 0],
    )


@functools.partial(jax.jit, static_argnames=("max_depth", "kappa"))
def _evaluate_acquisition_mogp(
    acq: AcquisitionStateMOGP,
    candidates: jax.Array,
    feat_types: jax.Array,
    max_depth: int = 16,
    kappa: float = DEFAULT_KAPPA,
) -> jax.Array:
    """LCB at the target fidelity; lower is better."""
    node_limit = acq.forest.node_limit
    route = route_forest_auto
    tree = jax.tree.map(lambda a: a[0], acq.forest)
    cand_leaves = route(tree, candidates, feat_types, max_depth)
    k_vec = gram_from_leaves(cand_leaves, acq.train_leaves, node_limit)
    k_vec = k_vec * acq.k_scale[None, :]
    mu = k_vec @ acq.K_inv_y
    quad = jnp.sum((k_vec @ acq.K_inv) * k_vec, axis=-1)
    var = jnp.maximum(acq.prior_var - quad, 1e-12)
    return mu - kappa * jnp.sqrt(var)


def evaluate_acquisition(
    acq,
    candidates: jax.Array,
    feat_types: jax.Array,
    max_depth: int = 16,
    kappa: float = DEFAULT_KAPPA,
) -> jax.Array:
    """Sample-average LCB for a ``(B, D)`` candidate batch; lower is better.

    Dispatches on the state type: dense ``AcquisitionState``, factored
    ``AcquisitionStateLR`` (see ``build_acquisition_lr``), or multi-task
    ``AcquisitionStateMOGP`` (target-fidelity LCB).
    """
    if isinstance(acq, AcquisitionStateLR):
        return _evaluate_acquisition_lr(acq, candidates, feat_types, max_depth, kappa)
    if isinstance(acq, AcquisitionStateMOGP):
        return _evaluate_acquisition_mogp(acq, candidates, feat_types, max_depth, kappa)
    if isinstance(acq, AcquisitionStateTS):
        return _evaluate_acquisition_ts(acq, candidates, feat_types, max_depth, kappa)
    return _evaluate_acquisition_dense(acq, candidates, feat_types, max_depth, kappa)


def evaluate_acquisition_sharded(
    acq: AcquisitionState,
    candidates: jax.Array,
    feat_types: jax.Array,
    mesh: jax.sharding.Mesh,
    max_depth: int = 16,
    kappa: float = DEFAULT_KAPPA,
    axis_name: str = "candidates",
) -> jax.Array:
    """``evaluate_acquisition`` with the candidate batch sharded over a mesh.

    At production scale (S = chains x samples posterior states, N past the
    32-bucket) scoring dominates the BO iteration; candidates are
    embarrassingly parallel, so each device scores its block against the
    replicated acquisition state — no collectives in the hot path, a single
    device-sharded result out. Scores are identical to the single-device
    evaluation (tested on the 8-device virtual mesh).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n_dev = mesh.shape[axis_name]
    assert candidates.shape[0] % n_dev == 0, "candidate batch must divide mesh"

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P()),
        out_specs=P(axis_name),
        check_vma=False,
    )
    def score_block(cands_block, ft):
        return evaluate_acquisition(acq, cands_block, ft, max_depth, kappa)

    return score_block(candidates, feat_types)
