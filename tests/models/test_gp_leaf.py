"""Exact leaf-space posterior prediction vs the dense oracle.

forest_predict_leaf must equal forest_predict (up to f32 association) for
any forest — the per-tree dense ranking is injective with no budget
assumption — including mixed categoricals and padded training rows.
"""

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.benchmarks.tree_function import TreeFunction
from bark_jax.fitting.prior import sample_forest_prior
from bark_jax.models.gp import forest_predict, forest_predict_leaf


def _setup(N=300, M=40, seed=0):
    bench = TreeFunction(dim=3, cat_dim=1, num_cat=4, m=15, function_seed=2)
    dom = bench.domain
    rng = np.random.default_rng(seed)
    X = jnp.asarray(dom.sample(N, rng))
    y = jnp.asarray(bench.f(np.asarray(X)))
    C = jnp.asarray(dom.sample(M, rng))
    ft = jnp.asarray(dom.feature_types())
    bounds = jnp.asarray(dom.bounds("bitmask"))
    forest = sample_forest_prior(
        jax.random.key(3), 15, bounds, ft, num_samples=4, node_limit=32,
        max_depth=8,
    )
    noise = jnp.linspace(0.05, 0.3, 4)
    scale = jnp.linspace(0.5, 2.0, 4)
    return X, y, C, ft, forest, noise, scale


def test_leaf_predict_matches_dense():
    X, y, C, ft, forest, noise, scale = _setup()
    mu_d, var_d = forest_predict(forest, noise, scale, X, y, C, ft, 8)
    mu_l, var_l = forest_predict_leaf(forest, noise, scale, X, y, C, ft, 8)
    np.testing.assert_allclose(np.asarray(mu_l), np.asarray(mu_d),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(var_l), np.asarray(var_d),
                               rtol=1e-4, atol=1e-4)


def test_leaf_predict_padding_inert():
    X, y, C, ft, forest, noise, scale = _setup()
    N = X.shape[0]
    pad = 20
    Xp = jnp.concatenate([X, jnp.tile(X[:1], (pad, 1))])
    yp = jnp.concatenate([y, jnp.zeros(pad)])
    mask = jnp.concatenate([jnp.ones(N), jnp.zeros(pad)]).astype(jnp.float32)
    mu_l, var_l = forest_predict_leaf(forest, noise, scale, X, y, C, ft, 8)
    mu_p, var_p = forest_predict_leaf(
        forest, noise, scale, Xp, yp, C, ft, 8, train_mask=mask
    )
    np.testing.assert_allclose(np.asarray(mu_p), np.asarray(mu_l),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(var_p), np.asarray(var_l),
                               rtol=1e-4, atol=1e-4)


def test_surrogate_leaf_backend_switch():
    from bark_jax.fitting.params import SamplerParams
    from bark_jax.models.surrogate import BARKSurrogate

    bench = TreeFunction(dim=2, m=8, function_seed=1)
    rng = np.random.default_rng(0)
    X = bench.domain.sample(40, rng)
    y = bench.f(X)
    params = SamplerParams(warmup_steps=5, num_samples=3, steps_per_sample=2,
                           num_chains=1, num_trees=8)
    C = bench.domain.sample(10, rng)
    out = {}
    for backend in ("dense", "leaf", "cg"):
        sur = BARKSurrogate(bench.domain, params, predict_backend=backend)
        sur.fit(X, y)
        out[backend] = sur.predict(C)
    np.testing.assert_allclose(out["leaf"][0], out["dense"][0],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(out["leaf"][1], out["dense"][1],
                               rtol=1e-4, atol=1e-3)
