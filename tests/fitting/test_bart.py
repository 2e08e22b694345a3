"""BART sampler tests: exact-math oracles + end-to-end recovery.

The integrated-leaf likelihood and conjugate leaf posterior are checked
against dense multivariate-normal computations (the same oracle style as
the Woodbury tests, SURVEY §4); the sampler is then checked to actually
regress a noisy step function and to be bit-inert to row padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bark_jax.fitting.bart import (
    BARTParams,
    bart_predict_samples,
    init_bart_state,
    leaf_suff_stats,
    run_bart_sampler,
    tree_marginal_loglik,
)


def _random_partition(rng, n, n_leaves, node_limit):
    """Random leaf assignment into n_leaves distinct slots."""
    slots = rng.choice(node_limit, size=n_leaves, replace=False)
    return jnp.asarray(slots[rng.integers(0, n_leaves, size=n)], jnp.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_marginal_loglik_matches_dense_mvn(seed):
    """sum-over-leaves closed form == log N(R | 0, s2 I + sm2 Z Z^T) + const.

    The const is ||R||^2/(2 s2) + (N/2) log(2 pi s2) (tree-independent)."""
    rng = np.random.default_rng(seed)
    n, node_limit = 12, 16
    sigma2, sigma_mu2 = 0.3, 0.07
    leaves = _random_partition(rng, n, 4, node_limit)
    resid = jnp.asarray(rng.normal(size=n), jnp.float32)

    n_l, s_l = leaf_suff_stats(leaves, resid, node_limit, None)
    got = tree_marginal_loglik(n_l, s_l, jnp.float32(sigma2), sigma_mu2)

    Z = np.eye(node_limit)[np.asarray(leaves)]  # (n, node_limit)
    cov = sigma2 * np.eye(n) + sigma_mu2 * Z @ Z.T
    sign, logdet = np.linalg.slogdet(cov)
    r = np.asarray(resid, np.float64)
    dense = -0.5 * (n * np.log(2 * np.pi) + logdet + r @ np.linalg.solve(cov, r))
    const = -0.5 * r @ r / sigma2 - 0.5 * n * np.log(2 * np.pi * sigma2)
    np.testing.assert_allclose(float(got), dense - const, rtol=1e-5, atol=1e-5)


def test_leaf_posterior_moments_are_conjugate():
    """Gibbs draw moments == analytic N(sm2 s/(s2+n sm2), s2 sm2/(s2+n sm2))."""
    from bark_jax.fitting.bart import sample_leaf_values

    sigma2, sigma_mu2 = jnp.float32(0.5), 0.04
    n_l = jnp.asarray([3.0, 0.0, 7.0, 1.0])
    s_l = jnp.asarray([1.2, 0.0, -2.5, 0.4])
    is_leaf = jnp.asarray([True, True, True, False])

    keys = jax.random.split(jax.random.key(0), 4000)
    draws = jax.vmap(
        lambda k: sample_leaf_values(k, n_l, s_l, sigma2, sigma_mu2, is_leaf)
    )(keys)
    draws = np.asarray(draws)

    denom = np.asarray(sigma2 + n_l * sigma_mu2)
    want_mean = np.asarray(sigma_mu2 * s_l / denom)
    want_var = np.asarray(sigma2 * sigma_mu2 / denom)
    np.testing.assert_allclose(draws[:, :3].mean(0), want_mean[:3], atol=0.02)
    np.testing.assert_allclose(draws[:, :3].var(0), want_var[:3], rtol=0.2)
    assert np.all(draws[:, 3] == 0.0)  # non-leaf slot forced to zero


def _step_data(n=96, noise=0.1, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, size=(n, 2)).astype(np.float32)
    f = np.where(X[:, 0] > 0.5, 1.0, -1.0) + 0.5 * np.where(X[:, 1] > 0.3, 1, -1)
    y = (f + noise * rng.normal(size=n)).astype(np.float32)
    return X, y, f


def test_bart_sampler_recovers_step_function():
    X, y, f = _step_data()
    bounds = jnp.asarray([[0.0, 1.0], [0.0, 1.0]], jnp.float32)
    ft = jnp.zeros((2,), jnp.int32) + 2  # FEAT_CONT
    params = BARTParams(
        warmup_steps=150, num_samples=30, num_trees=20, node_limit=32,
        num_chains=2,
    )
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    samples, state = run_bart_sampler(
        jax.random.key(0), Xj, yj, bounds, ft, params, jnp.float32(0.1)
    )
    c, S = samples.sigma2.shape
    packed = samples.packed.reshape((c * S,) + samples.packed.shape[2:])
    lv = samples.leaf_values.reshape((c * S,) + samples.leaf_values.shape[2:])
    pred = np.asarray(bart_predict_samples(packed, lv, Xj, ft)).mean(0)
    # in-sample fit should explain most of the (unit-scale) signal
    mse = float(np.mean((pred - y) ** 2))
    assert mse < 0.15 * float(np.var(y)), mse
    # sigma2 posterior should land near the true noise variance (0.01),
    # certainly far below the signal variance (~1.2)
    s2 = float(np.mean(samples.sigma2))
    assert s2 < 0.2 * float(np.var(y)), s2


def test_bart_padding_is_inert():
    """Extra masked rows change nothing: same trees, values, sigma2 draws.

    All RNG draws are N-independent (proposal noise and leaf draws are
    node_limit-shaped, sigma2 is one gamma draw), and masked rows
    contribute exact zeros to every sufficient statistic. Structural
    decisions (accepted trees) must match exactly; continuous draws match
    to reduction-order tolerance (the padded shape compiles to a different
    XLA reduction tree, same CLAUDE.md caveat as the BARK sampler)."""
    X, y, _ = _step_data(n=40)
    bounds = jnp.asarray([[0.0, 1.0], [0.0, 1.0]], jnp.float32)
    ft = jnp.zeros((2,), jnp.int32) + 2
    params = BARTParams(
        warmup_steps=10, num_samples=5, num_trees=8, node_limit=16
    )
    Xj, yj = jnp.asarray(X), jnp.asarray(y)

    s_plain, _ = run_bart_sampler(
        jax.random.key(7), Xj, yj, bounds, ft, params, jnp.float32(0.1),
        mask=jnp.ones((40,), jnp.float32),
    )

    n_pad = 64
    Xp = jnp.concatenate([Xj, jnp.broadcast_to(Xj[:1], (n_pad - 40, 2))])
    yp = jnp.concatenate([yj, jnp.zeros((n_pad - 40,), jnp.float32)])
    maskp = jnp.concatenate(
        [jnp.ones((40,), jnp.float32), jnp.zeros((n_pad - 40,), jnp.float32)]
    )
    s_pad, _ = run_bart_sampler(
        jax.random.key(7), Xp, yp, bounds, ft, params, jnp.float32(0.1),
        mask=maskp,
    )
    np.testing.assert_array_equal(
        np.asarray(s_plain.packed), np.asarray(s_pad.packed)
    )
    np.testing.assert_allclose(
        np.asarray(s_plain.leaf_values), np.asarray(s_pad.leaf_values),
        rtol=1e-4, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(s_plain.sigma2), np.asarray(s_pad.sigma2),
        rtol=1e-4, atol=1e-6,
    )


def test_bart_surrogate_end_to_end_and_grid_ucb():
    """BARTSurrogate fits, predicts in original units, and drives GridUCB."""
    from bark_jax.domain import Domain, ContinuousInput
    from bark_jax.models.bart import BARTSurrogate
    from bark_jax.strategies.baselines import GridUCBStrategy

    domain = Domain([ContinuousInput("x0", (0.0, 1.0)),
                     ContinuousInput("x1", (0.0, 1.0))])
    X, y, _ = _step_data(n=48, seed=3)
    y = y * 7.0 + 100.0  # exercise the min-max scaling round-trip
    sur = BARTSurrogate(
        domain,
        BARTParams(warmup_steps=60, num_samples=16, num_trees=15,
                   node_limit=16),
        seed=0,
    )
    sur.fit(X, y)
    mu, std = sur.predict(X)
    assert mu.shape == (48, 1) and std.shape == (48, 1)
    assert np.all(std > 0)
    # predictions live in original units
    assert abs(float(mu.mean()) - float(y.mean())) < 3.0
    mse = float(np.mean((mu[:, 0] - y) ** 2))
    assert mse < 0.3 * float(np.var(y)), mse

    draws = sur.function_samples(X[:5])
    assert draws.shape[1] == 5

    # warm-start refit with one more point (crosses no bucket boundary)
    sur.fit(np.vstack([X, X[:1]]), np.concatenate([y, y[:1]]))
    assert sur.is_fitted

    strat = GridUCBStrategy(domain, surrogate=BARTSurrogate(
        domain, BARTParams(warmup_steps=20, num_samples=8, num_trees=10,
                           node_limit=16)))
    strat.tell(X, y)
    cand = strat.ask(1)
    assert cand.shape == (1, 2)
    assert np.all(cand >= 0.0) and np.all(cand <= 1.0)
