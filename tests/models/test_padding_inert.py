"""The 32-bucket padding must be exactly inert end-to-end.

The padding invariant (masked rows drop out of the
kernel, MLL and posterior) was tested for the sampler but not for the
*predict* and *acquisition* paths together with the no-null rescaling.
These tests fit a padded surrogate and assert its predictions and
acquisition scores match the unpadded (sliced) computation bit-for-bit
up to float tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.benchmarks import map_benchmark
from bark_jax.fitting.params import SamplerParams
from bark_jax.models.gp import forest_predict
from bark_jax.models.surrogate import BARKSurrogate
from bark_jax.optimizer.acquisition import build_acquisition, evaluate_acquisition

PARAMS = SamplerParams(
    warmup_steps=20, num_samples=5, steps_per_sample=3, num_chains=2, num_trees=10
)


def _fitted(n=20):
    bench = map_benchmark(
        "TreeFunction", dim=2, cat_dim=1, num_cat=3, m=8, function_seed=3
    )
    rng = np.random.default_rng(0)
    X = bench.domain.sample(n, rng)
    y = bench.f(X)
    sur = BARKSurrogate(bench.domain, PARAMS, seed=0)
    sur.fit(X, y)  # n=20 pads to the 32 bucket
    cands = jnp.asarray(bench.domain.sample(16, rng))
    ft = jnp.asarray(bench.domain.feature_types())
    return bench, sur, cands, ft, n


def test_padded_predict_equals_sliced():
    bench, sur, cands, ft, n = _fitted()
    tx, ty = sur.train_data
    mu_pad, var_pad = forest_predict(
        sur.model.forest, sur.model.noise, sur.model.scale,
        tx, ty, cands, ft, PARAMS.max_depth, train_mask=sur.train_mask,
    )
    mu_cut, var_cut = forest_predict(
        sur.model.forest, sur.model.noise, sur.model.scale,
        tx[:n], ty[:n], cands, ft, PARAMS.max_depth,
    )
    np.testing.assert_allclose(
        np.asarray(mu_pad), np.asarray(mu_cut), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(var_pad), np.asarray(var_cut), rtol=1e-4, atol=1e-5
    )


def test_padded_acquisition_equals_sliced():
    """train_mask + no-null rescaling together on the acquisition path."""
    bench, sur, cands, ft, n = _fitted()
    tx, ty = sur.train_data
    acq_pad = build_acquisition(
        sur.model, tx, ty, ft, PARAMS.max_depth, train_mask=sur.train_mask
    )
    acq_cut = build_acquisition(sur.model, tx[:n], ty[:n], ft, PARAMS.max_depth)
    s_pad = evaluate_acquisition(acq_pad, cands, ft, PARAMS.max_depth)
    s_cut = evaluate_acquisition(acq_cut, cands, ft, PARAMS.max_depth)
    np.testing.assert_allclose(
        np.asarray(s_pad), np.asarray(s_cut), rtol=1e-4, atol=1e-5
    )


def test_surrogate_predict_shapes_and_quality():
    """sur.predict returns (N,1) mu/std in raw y units and beats the mean
    predictor on TreeFunction."""
    bench = map_benchmark("TreeFunction", dim=3, m=10, function_seed=2)
    rng = np.random.default_rng(1)
    Xtr = bench.domain.sample(50, rng)
    ytr = bench.f(Xtr)
    Xte = bench.domain.sample(30, rng)
    yte = bench.f(Xte)
    params = SamplerParams(
        warmup_steps=60, num_samples=8, steps_per_sample=4,
        num_chains=2, num_trees=20,
    )
    sur = BARKSurrogate(bench.domain, params, seed=0)
    sur.fit(Xtr, ytr)
    mu, std = sur.predict(Xte)
    assert mu.shape == (30, 1) and std.shape == (30, 1)
    mse = float(np.mean((mu[:, 0] - yte) ** 2))
    base = float(np.mean((ytr.mean() - yte) ** 2))
    assert mse < 0.5 * base, f"MSE {mse} vs mean-predictor {base}"
