"""Woodbury / Cholesky linear-algebra oracles.

Parity with the reference's tests/bark_fitting/test_quick_inverse.py:21-101:
low-rank inverse and determinant updates are checked against dense numpy
recomputation, including the padded-zero-column case the sampler relies on.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from bark_jax.ops.linalg import (
    chol_inv_logdet,
    gp_posterior,
    kernel_matrix,
    low_rank_det_update,
    low_rank_inv_update,
    mll,
)


def random_spd(n, rng, jitter=1.0):
    A = rng.standard_normal((n, n))
    return A @ A.T + jitter * np.eye(n)


@pytest.mark.parametrize("n,rank", [(10, 3), (25, 8), (40, 1)])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("subtract", [False, True])
def test_low_rank_inv_update_vs_dense(n, rank, seed, subtract):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n, rank)) * 0.3
    if subtract:
        # ensure K - U U^T stays PD: build K containing U U^T
        K = random_spd(n, rng) + U @ U.T
    else:
        K = random_spd(n, rng)
    K_inv = np.linalg.inv(K)

    got = np.asarray(
        low_rank_inv_update(
            jnp.asarray(K_inv, jnp.float64), jnp.asarray(U, jnp.float64), subtract
        )
    )
    sign = -1.0 if subtract else 1.0
    expect = np.linalg.inv(K + sign * U @ U.T)
    np.testing.assert_allclose(got, expect, atol=1e-8)


@pytest.mark.parametrize("n,rank", [(10, 3), (25, 8)])
@pytest.mark.parametrize("subtract", [False, True])
def test_low_rank_det_update_vs_dense(n, rank, subtract):
    rng = np.random.default_rng(2)
    U = rng.standard_normal((n, rank)) * 0.3
    K = random_spd(n, rng) + (U @ U.T if subtract else 0)
    K_inv = np.linalg.inv(K)
    _, logdet = np.linalg.slogdet(K)

    got = float(
        low_rank_det_update(
            jnp.asarray(K_inv, jnp.float64),
            jnp.asarray(U, jnp.float64),
            jnp.asarray(logdet, jnp.float64),
            subtract,
        )
    )
    sign = -1.0 if subtract else 1.0
    _, expect = np.linalg.slogdet(K + sign * U @ U.T)
    np.testing.assert_allclose(got, expect, atol=1e-8)


@pytest.mark.parametrize("subtract", [False, True])
def test_updates_ignore_zero_columns(subtract):
    """Padded (all-zero) columns in U must not change the result — the
    sampler passes fixed-width leaf one-hots with empty slots."""
    rng = np.random.default_rng(3)
    n, rank, pad = 20, 4, 12
    U = rng.standard_normal((n, rank)) * 0.3
    U_pad = np.zeros((n, rank + pad))
    # interleave the real columns among zeros
    U_pad[:, ::4] = U
    K = random_spd(n, rng) + (U @ U.T if subtract else 0)
    K_inv = np.linalg.inv(K)
    _, logdet = np.linalg.slogdet(K)

    a = np.asarray(
        low_rank_inv_update(
            jnp.asarray(K_inv, jnp.float64), jnp.asarray(U, jnp.float64), subtract
        )
    )
    b = np.asarray(
        low_rank_inv_update(
            jnp.asarray(K_inv, jnp.float64), jnp.asarray(U_pad, jnp.float64), subtract
        )
    )
    np.testing.assert_allclose(a, b, atol=1e-9)

    da = float(
        low_rank_det_update(
            jnp.asarray(K_inv, jnp.float64),
            jnp.asarray(U, jnp.float64),
            jnp.asarray(logdet, jnp.float64),
            subtract,
        )
    )
    db = float(
        low_rank_det_update(
            jnp.asarray(K_inv, jnp.float64),
            jnp.asarray(U_pad, jnp.float64),
            jnp.asarray(logdet, jnp.float64),
            subtract,
        )
    )
    np.testing.assert_allclose(da, db, atol=1e-9)


def test_chol_inv_logdet():
    rng = np.random.default_rng(4)
    K = random_spd(15, rng)
    K_inv, logdet = chol_inv_logdet(jnp.asarray(K, jnp.float64))
    np.testing.assert_allclose(np.asarray(K_inv), np.linalg.inv(K), atol=1e-9)
    np.testing.assert_allclose(float(logdet), np.linalg.slogdet(K)[1], atol=1e-9)


def test_mll_formula():
    rng = np.random.default_rng(5)
    K = random_spd(12, rng)
    y = rng.standard_normal((12, 1))
    K_inv = np.linalg.inv(K)
    _, logdet = np.linalg.slogdet(K)
    got = float(mll(jnp.asarray(K_inv), jnp.asarray(logdet), jnp.asarray(y)))
    expect = 0.5 * (-(y.T @ K_inv @ y)[0, 0] - logdet)
    np.testing.assert_allclose(got, expect, rtol=1e-5)


def test_gp_posterior_matches_dense():
    rng = np.random.default_rng(6)
    n, m = 20, 7
    K = random_spd(n, rng)
    K_inv = np.linalg.inv(K)
    K_xX = rng.standard_normal((m, n)) * 0.2
    y = rng.standard_normal((n, 1))
    mu, var = gp_posterior(
        jnp.asarray(K_inv), jnp.asarray(K_xX), jnp.asarray(y), jnp.asarray(1.7)
    )
    expect_mu = (K_xX @ K_inv @ y).ravel()
    expect_var = 1.7 - np.diag(K_xX @ K_inv @ K_xX.T)
    np.testing.assert_allclose(np.asarray(mu), expect_mu, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(var), expect_var, rtol=1e-4, atol=1e-5)


def test_kernel_matrix():
    gram = np.eye(4) * 0.5 + 0.5
    K = np.asarray(kernel_matrix(jnp.asarray(gram), jnp.asarray(0.1), jnp.asarray(2.0)))
    np.testing.assert_allclose(K, 2.0 * gram + (1e-6 + 0.1) * np.eye(4), rtol=1e-6)


def test_robust_chol_escalates_jitter_on_singular_input():
    """A singular K fails the plain factorization (NaNs) but the escalated
    jitter recovers a finite, accurate inverse."""
    from bark_jax.ops.linalg import chol_inv_logdet, robust_chol_inv_logdet

    n = 8
    u = jnp.asarray(np.random.default_rng(0).normal(size=(n, 1)), jnp.float32)
    K = (u @ u.T).astype(jnp.float32)  # rank-1: exactly singular
    _, logdet_plain = chol_inv_logdet(K)
    assert not np.isfinite(float(logdet_plain))
    K_inv, logdet = robust_chol_inv_logdet(K)
    assert np.isfinite(float(logdet))
    assert np.isfinite(np.asarray(K_inv)).all()
    # the recovered inverse solves the escalated system accurately
    from bark_jax.ops.linalg import JITTER

    K_j = K + 1e2 * JITTER * jnp.eye(n, dtype=jnp.float32)
    np.testing.assert_allclose(
        np.asarray(K_inv @ K_j), np.eye(n), atol=5e-2
    )


def test_robust_chol_matches_plain_on_healthy_input():
    from bark_jax.ops.linalg import chol_inv_logdet, robust_chol_inv_logdet

    rng = np.random.default_rng(1)
    A = rng.normal(size=(6, 6))
    K = jnp.asarray(A @ A.T + 0.5 * np.eye(6), jnp.float32)
    K_inv_p, logdet_p = chol_inv_logdet(K)
    K_inv_r, logdet_r = robust_chol_inv_logdet(K)
    np.testing.assert_array_equal(np.asarray(K_inv_p), np.asarray(K_inv_r))
    assert float(logdet_p) == float(logdet_r)


def test_blocked_cholesky_matches_xla():
    """blocked_cholesky == jnp.linalg.cholesky up to float association,
    across batch shapes, non-divisible fallback, and both panel sizes."""
    from bark_jax.ops.linalg import blocked_cholesky

    rng = np.random.default_rng(2)
    for batch, n in [((3,), 512), ((2, 2), 256), ((), 384), ((4,), 96)]:
        a = jnp.asarray(rng.normal(size=batch + (n, 16)))
        K = a @ jnp.swapaxes(a, -1, -2) / 16.0 + 0.5 * jnp.eye(n)
        L_ref = np.asarray(jnp.linalg.cholesky(K))
        for block in (0, 128, 256):
            L = np.asarray(blocked_cholesky(K, block=block))
            np.testing.assert_allclose(L, L_ref, rtol=1e-10, atol=1e-10)
            assert np.allclose(
                np.tril(L) , L
            ), "blocked factor must be lower-triangular"


@pytest.mark.parametrize("block", [64, 128])
def test_blocked_cholesky_float32_matches_xla(block):
    """The sampler's own dtype: float32 panels at the small block sizes,
    over a batch, against XLA's Cholesky."""
    from bark_jax.ops.linalg import blocked_cholesky

    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.normal(size=(4, 512, 24)), jnp.float32)
    K = a @ jnp.swapaxes(a, -1, -2) / 24.0 + 0.5 * jnp.eye(
        512, dtype=jnp.float32
    )
    L = np.asarray(blocked_cholesky(K, block=block))
    assert L.dtype == np.float32
    np.testing.assert_allclose(L, np.asarray(jnp.linalg.cholesky(K)), atol=2e-4)
    np.testing.assert_array_equal(np.triu(L, 1), 0.0)


def test_chol_inv_logdet_blocked_matches_plain():
    from bark_jax.ops.linalg import chol_inv_logdet

    rng = np.random.default_rng(3)
    a = jnp.asarray(rng.normal(size=(2, 256, 16)))
    K = a @ jnp.swapaxes(a, -1, -2) / 16.0 + 0.5 * jnp.eye(256)
    inv_p, ld_p = chol_inv_logdet(K)
    inv_b, ld_b = chol_inv_logdet(K, block=128)
    np.testing.assert_allclose(np.asarray(inv_b), np.asarray(inv_p),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(ld_b), np.asarray(ld_p), rtol=1e-10)


def test_sampler_step_invariant_to_chol_block():
    """A full MCMC step at padded N=512 produces the same trajectory with
    the XLA and blocked refresh factorizations (x64 suite => exact-enough
    association to compare accept decisions and carried state tightly)."""
    import jax

    from bark_jax.fitting import sampler as S
    from bark_jax.fitting.params import SamplerParams
    from bark_jax.fitting.prior import sample_forest_prior

    N, D, m = 512, 3, 8
    key = jax.random.PRNGKey(0)
    X = jax.random.uniform(key, (N, D), jnp.float32)
    y = jax.random.normal(key, (N, 1), jnp.float32)
    bounds = jnp.stack([jnp.zeros(D), jnp.ones(D)], axis=-1)
    ft = jnp.zeros((D,), jnp.int32)
    f = jax.tree.map(
        lambda a: a[0], sample_forest_prior(jax.random.PRNGKey(1), m, bounds, ft)
    )
    for style, scan in [("pair", "auto"), ("factor", "coeff")]:
        outs = []
        for blk in (0, 256):
            p = SamplerParams(num_trees=m, chol_block=blk,
                              refresh_style=style, scan_style=scan)
            st = S.init_chain_state(f, 0.1, 1.0, X, y, ft, p, bounds=bounds)
            st2 = S.step(jax.random.PRNGKey(2), st, X, y, bounds, ft, p)
            outs.append(st2)
        a, b = outs
        np.testing.assert_allclose(float(a.mll), float(b.mll), rtol=1e-4)
        np.testing.assert_array_equal(
            np.asarray(a.forest.feature), np.asarray(b.forest.feature)
        )
        assert float(a.noise) == float(b.noise)
