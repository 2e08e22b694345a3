"""Surrogate-layer tests: regression quality, padding equivalence, warm start.

Protocol parity: examples/regression/regression.py:75-124 (NLPD/MSE on
held-out TreeFunction data).
"""

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.benchmarks.tree_function import TreeFunction
from bark_jax.fitting.params import SamplerParams
from bark_jax.models.gp import forest_predict, mixture_of_gaussians_as_normal
from bark_jax.models.surrogate import BARKPriorSurrogate, BARKSurrogate
from bark_jax.utils.metrics import mse, nlpd


def make_data(seed=0, n_train=50, n_test=80, dim=3, m=20):
    bench = TreeFunction(dim=dim, m=m, function_seed=1)
    rng = np.random.default_rng(seed)
    Xtr = bench.domain.sample(n_train, rng)
    Xte = bench.domain.sample(n_test, rng)
    return bench, Xtr, bench.f(Xtr), Xte, bench.f(Xte)


def test_bark_regression_beats_mean_predictor():
    bench, Xtr, ytr, Xte, yte = make_data()
    params = SamplerParams(
        warmup_steps=50, num_samples=5, steps_per_sample=10, num_chains=2, num_trees=20
    )
    sur = BARKSurrogate(bench.domain, params, seed=0).fit(Xtr, ytr)
    mu, std = sur.predict(Xte)

    assert mse(yte, mu) < 0.6 * mse(yte, np.full_like(yte, ytr.mean()))
    # NLPD must beat the naive Gaussian fit to the train distribution
    naive = nlpd(yte, np.full_like(yte, ytr.mean()), np.full_like(yte, ytr.var()))
    assert nlpd(yte, mu, std**2) < naive


def test_batched_predict_matches_mog_collapse():
    bench, Xtr, ytr, Xte, yte = make_data(n_test=10)
    params = SamplerParams(
        warmup_steps=10, num_samples=3, steps_per_sample=3, num_chains=2, num_trees=10
    )
    sur = BARKSurrogate(bench.domain, params, seed=0).fit(Xtr, ytr)
    mu_b, std_b = sur.predict(Xte, batched=True)
    mu, std = sur.predict(Xte)
    mu2, var2 = mixture_of_gaussians_as_normal(
        jnp.asarray(mu_b[..., 0]), jnp.asarray(std_b[..., 0] ** 2)
    )
    np.testing.assert_allclose(mu[..., 0], np.asarray(mu2), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        std[..., 0] ** 2, np.asarray(var2), rtol=1e-4, atol=1e-5
    )


def test_padding_equivalence_in_predict():
    """Padded training rows must not change predictions at all."""
    bench, Xtr, ytr, Xte, _ = make_data(n_train=20, n_test=7)
    params = SamplerParams(num_trees=8)
    sur = BARKSurrogate(bench.domain, params, seed=0)
    sur._store_train_data(Xtr, ytr)
    train_x, train_y = sur.train_data
    assert train_x.shape[0] == 32  # bucketed

    from bark_jax.fitting.prior import sample_forest_prior

    ft = jnp.asarray(bench.domain.feature_types())
    forest = sample_forest_prior(
        jax.random.key(0), 8, jnp.asarray(bench.domain.bounds("bitmask")), ft,
        num_samples=3,
    )
    noise = jnp.full((3,), 0.2)
    scale = jnp.ones((3,))

    mu_pad, var_pad = forest_predict(
        forest, noise, scale, train_x, train_y, jnp.asarray(Xte), ft,
        train_mask=sur.train_mask,
    )
    mu_ref, var_ref = forest_predict(
        forest, noise, scale, train_x[:20], train_y[:20], jnp.asarray(Xte), ft,
    )
    np.testing.assert_allclose(np.asarray(mu_pad), np.asarray(mu_ref), atol=1e-4)
    np.testing.assert_allclose(np.asarray(var_pad), np.asarray(var_ref), atol=1e-4)


def test_warm_start_skips_warmup():
    bench, Xtr, ytr, _, _ = make_data(n_train=12)
    params = SamplerParams(
        warmup_steps=5, num_samples=2, steps_per_sample=2, num_chains=1, num_trees=5
    )
    sur = BARKSurrogate(bench.domain, params, seed=0).fit(Xtr, ytr)
    first_model = sur.model
    sur.fit(Xtr, ytr)  # second fit warm-starts
    assert sur.model is not first_model
    assert sur.is_fitted


def test_prior_surrogate_fit_predict():
    bench, Xtr, ytr, Xte, yte = make_data(n_train=25, n_test=10)
    sur = BARKPriorSurrogate(bench.domain, num_samples=4, seed=0).fit(Xtr, ytr)
    mu, std = sur.predict(Xte)
    assert mu.shape == (10, 1) and std.shape == (10, 1)
    assert np.isfinite(mu).all() and (std > 0).all()
