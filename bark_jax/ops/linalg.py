"""GP linear algebra: Cholesky MLL path and rank-L Woodbury updates.

The reference maintains a dense kernel inverse and log-determinant across MCMC
tree moves via Woodbury / matrix-determinant-lemma updates
(``src/bark/fitting/quick_inverse.py:12-38``) and rebuilds K with a dense
``np.linalg.inv`` + ``slogdet`` at noise moves
(``src/bark/fitting/bark_sampler.py:153-162,266-282``). Here:

  - full rebuilds go through Cholesky (K is PSD by construction: the agreement
    kernel is a sum of one-hot outer products, plus a positive diagonal), with
    ``inv`` recovered by a triangular solve against I;
  - incremental updates keep the reference's Woodbury structure — pure
    matmuls plus a small (L x L) solve/slogdet, matmul-friendly and batched over
    vmapped chains;
  - everything is float32 and fixed-shape; the Woodbury identities are
    verified against dense recomputation in tests (the reference's own oracle,
    tests/bark_fitting/test_quick_inverse.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

JITTER = 1e-6  # parity: src/bark/fitting/bark_sampler.py:156

#: matmul precision for MLL-critical products. An accelerator's default
#: f32 matmul may round its operands (TF32 on the H100, bf16 passes on
#: the chip the sampler was first built on); rounded operands measurably
#: biased the posterior (results/ab_r5/precision_bug.md: per-move MH
#: ratio error max 9.7 nats at a bf16 default against 0.0024 at
#: "highest"). "highest" is full f32. Module-level so A/Bs can override
#: one knob (tools/ab_precision.py).
MM_PRECISION = "highest"

#: matmul precision for the move-scan BODIES (the per-move (2m,2m)-sized
#: Woodbury updates). Separate knob from MM_PRECISION: the scan is
#: latency-bound on per-move op count, and with the HOISTED quantities
#: computed exactly (structured-exact products + MM_PRECISION solves) the
#: default precision in-scan kept the carried MLL within 0.0007 nats of
#: f64 at (N=512, nu~0.1) and the stationary noise posterior on the chol
#: oracle's (results/ab_r5/precision_bug.md). chip_smoke.py holds the
#: carried MLL to float64 on the H100 (TF32 default) at every run.
MM_PRECISION_SCAN = "default"


def mll(K_inv: jax.Array, K_logdet: jax.Array, y: jax.Array) -> jax.Array:
    """Marginal log-likelihood up to the constant N/2 log(2pi) term.

    Parity: src/bark/fitting/quick_inverse.py:36-38.
    ``y`` is ``(N, 1)`` or ``(N,)``.
    """
    y = y.reshape(-1)
    with jax.default_matmul_precision(MM_PRECISION):
        # a default-precision matmul may round f32 operands; MLL
        # quadratics need the full mantissa (results/ab_r5/
        # precision_bug.md) and this matvec is cheap
        quad = y @ (K_inv @ y)
    return 0.5 * (-quad - K_logdet)


def masked_mll(
    K_inv: jax.Array,
    K_logdet: jax.Array,
    y: jax.Array,
    noise: jax.Array,
    pad_count: jax.Array,
) -> jax.Array:
    """MLL over the *real* data block of a padded kernel system.

    With padded rows masked out of the Gram matrix, K is block-diagonal:
    ``[K_real, (jitter + noise) I_pad]``. Padded y entries are 0, so the
    quadratic term is unaffected; the log-determinant over-counts by exactly
    ``pad_count * log(jitter + noise)``, which this subtracts so MH accept
    ratios (including noise moves) match the unpadded system exactly.
    """
    y = y.reshape(-1)
    with jax.default_matmul_precision(MM_PRECISION):
        # full-mantissa quad (see mll above)
        quad = y @ (K_inv @ y)
    correction = pad_count * jnp.log(JITTER + noise)
    return 0.5 * (-quad - K_logdet + correction)


def low_rank_inv_update(
    K_inv: jax.Array, U: jax.Array, subtract: bool = False
) -> jax.Array:
    """Woodbury update of a dense inverse: ``(K ± U Uᵀ)⁻¹`` from ``K⁻¹``.

    Parity: src/bark/fitting/quick_inverse.py:12-21. ``U`` is ``(N, L)`` and
    may contain all-zero columns (padded leaf one-hots) — they contribute
    nothing.
    """
    mul = -1.0 if subtract else 1.0
    KU = K_inv @ U
    den = mul * jnp.eye(U.shape[-1], dtype=K_inv.dtype) + U.T @ KU
    return K_inv - KU @ jnp.linalg.solve(den, KU.T)


def low_rank_det_update(
    K_inv: jax.Array, U: jax.Array, K_logdet: jax.Array, subtract: bool = False
) -> jax.Array:
    """Matrix determinant lemma: ``logdet(K ± U Uᵀ)`` from ``logdet(K)``.

    Parity: src/bark/fitting/quick_inverse.py:24-33.
    """
    mul = -1.0 if subtract else 1.0
    small = jnp.eye(U.shape[-1], dtype=K_inv.dtype) + mul * (U.T @ (K_inv @ U))
    _, logabsdet = jnp.linalg.slogdet(small)
    return K_logdet + logabsdet


def rank1_inv_logdet_update(
    K_inv: jax.Array,
    K_logdet: jax.Array,
    w: jax.Array,
    subtract: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Sherman-Morrison + determinant-lemma update for ``K ± w wᵀ``.

    Returns ``(K_inv', K_logdet', denom)`` where ``denom = 1 ± wᵀK⁻¹w`` —
    callers must treat ``denom <= 0`` (possible only through float32
    round-off on the subtract side; mathematically K stays PD because the
    updated kernel retains its positive diagonal) as a failed update and
    reject the move. No sequential factorization anywhere: the per-move
    critical path of the MCMC kernel collapses from a 64-step Cholesky to
    one matvec + one outer product.
    """
    Kw = K_inv @ w
    quad = w @ Kw
    denom = 1.0 - quad if subtract else 1.0 + quad
    sign = 1.0 if subtract else -1.0
    K_inv_new = K_inv + sign * jnp.outer(Kw, Kw) / denom
    K_logdet_new = K_logdet + jnp.log(denom)
    return K_inv_new, K_logdet_new, denom


def blocked_cholesky(K: jax.Array, block: int = 256) -> jax.Array:
    """Right-looking blocked Cholesky, batched over leading dims.

    Keeps the sequential column recursion confined to ``block``-sized
    diagonal blocks (small XLA chol), does each panel solve as one
    triangular solve, and the trailing SYRK update as one large matmul per
    panel. Same math as ``jnp.linalg.cholesky`` (identical up to float
    association); panel count N/block is unrolled at trace time. Opt-in
    only (``SamplerParams.chol_block``): it exists for compilers whose
    Cholesky is latency-bound on its column loop.

    Requires N % block == 0 (callers pad to 32-buckets; pick ``block``
    accordingly) — falls back to ``jnp.linalg.cholesky`` otherwise.
    """
    n = K.shape[-1]
    if block <= 0 or n <= block or n % block:
        return jnp.linalg.cholesky(K)
    nb = n // block
    batch = K.shape[:-2]
    # computed panel columns; cols[p] is the (n - p*block, block) strip
    cols = []
    T = K  # trailing matrix, shrinks by `block` per panel
    for p in range(nb):
        d = T[..., :block, :block]
        off = T[..., block:, :block]
        Ld = jnp.linalg.cholesky(d)
        # L_off Ld^T = off  =>  L_off = off Ld^{-T}
        Loff = jax.lax.linalg.triangular_solve(
            Ld, off, left_side=False, lower=True, transpose_a=True
        )
        cols.append((Ld, Loff))
        if p + 1 < nb:
            T = T[..., block:, block:] - Loff @ jnp.swapaxes(Loff, -1, -2)
    rows = []
    zeros = jnp.zeros(batch + (block, block), dtype=K.dtype)
    for i in range(nb):
        row = []
        for j in range(nb):
            if j > i:
                row.append(zeros)
            elif j == i:
                row.append(cols[j][0])
            else:
                off = cols[j][1]
                s = (i - j - 1) * block
                row.append(off[..., s : s + block, :])
        rows.append(jnp.concatenate(row, axis=-1))
    return jnp.concatenate(rows, axis=-2)


def chol_inv_logdet(
    K: jax.Array, block: int = 0
) -> tuple[jax.Array, jax.Array]:
    # ACCURACY NOTE (r4, results/ab_r4/leaf_numerics.md): the explicit
    # inverse squares the condition number; an eye-RHS triangular
    # solve/assembly can lose ~cond*eps — quadratic forms through the
    # returned K_inv measured ~58 nats of MLL error at (N=512, nu=0.011)
    # on an accelerator, where the factor form (z = L^-1 y) erred 0.09 and
    # CPU f32 0.02. Keep MLL-critical quadratics on the factor (the
    # onesolve/leaf refreshes do); use K_inv for carries and posterior
    # algebra at benign condition numbers.
    """Dense inverse and logdet of a PD matrix via Cholesky.

    Replaces the reference's ``np.linalg.inv`` + ``slogdet``
    (src/bark/fitting/bark_sampler.py:160-161) — K here is always PSD plus a
    positive diagonal, so Cholesky is both valid and cheaper/stabler.
    ``block > 0`` routes the factorization through ``blocked_cholesky``.
    """
    L = (
        blocked_cholesky(K, block=block)
        if block > 0
        else jnp.linalg.cholesky(K)
    )
    eye = jnp.broadcast_to(jnp.eye(K.shape[-1], dtype=K.dtype), K.shape)
    with jax.default_matmul_precision(MM_PRECISION):
        # the assembly product must keep L_inv's full f32 mantissa: at
        # default precision the operands may round and quadratic
        # forms through the result lose ~0.4% relative — on top of the
        # expander error documented above (results/ab_r5/precision_bug.md)
        L_inv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
        K_inv = jnp.swapaxes(L_inv, -1, -2) @ L_inv  # batch-safe transpose
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
    return K_inv, logdet


def robust_chol_inv_logdet(
    K: jax.Array, escalations: tuple[float, ...] = (1e2, 1e4)
) -> tuple[jax.Array, jax.Array]:
    """``chol_inv_logdet`` with in-graph jitter escalation.

    The agreement kernel is only PSD up to sampling (the reference warns at
    src/bark/optimizer/thompson_sampling.py:17-21 and leans on a fixed 1e-6
    jitter); a near-singular posterior sample can fail the factorization,
    surfacing as NaNs. Each escalation re-factorizes ``K + f*JITTER*I`` and
    is selected only where the previous attempt produced non-finite output.
    Used on the predict/acquisition paths (once per fit/ask, vmapped over
    posterior samples) — NOT in the sampler hot loop, where a NaN mll simply
    rejects the move (NaN-safe MH).
    """
    eye = jnp.broadcast_to(jnp.eye(K.shape[-1], dtype=K.dtype), K.shape)
    K_inv, logdet = chol_inv_logdet(K)
    ok = jnp.isfinite(logdet)
    for f in escalations:
        K_inv2, logdet2 = chol_inv_logdet(K + f * JITTER * eye)
        K_inv = jnp.where(ok[..., None, None], K_inv, K_inv2)
        logdet = jnp.where(ok, logdet, logdet2)
        ok = jnp.isfinite(logdet)
    return K_inv, logdet


def kernel_matrix(
    gram: jax.Array, noise: jax.Array, scale: jax.Array
) -> jax.Array:
    """``scale * gram + (jitter + noise) I`` for scalar noise/scale.

    Parity: src/bark/fitting/bark_sampler.py:153-156. Batch over samples or
    chains with ``vmap``.
    """
    eye = jnp.eye(gram.shape[-1], dtype=gram.dtype)
    return scale * gram + (JITTER + noise) * eye


def gp_posterior(
    K_inv: jax.Array,
    K_xX: jax.Array,
    y: jax.Array,
    prior_var: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Posterior mean and diagonal variance for one kernel sample.

    ``mu = K_xX K⁻¹ y``; ``var = prior_var − diag(K_xX K⁻¹ K_xXᵀ)``.
    Parity: src/bark/tree_kernels/tree_gps.py:107-108 (diag=True path).
    """
    y = y.reshape(-1)
    mu = K_xX @ (K_inv @ y)
    solve = K_inv @ K_xX.T  # (N, M)
    var = prior_var - jnp.sum(K_xX * solve.T, axis=-1)
    # float32 round-off can push tiny posterior variances below zero
    return mu, jnp.maximum(var, 1e-12)
