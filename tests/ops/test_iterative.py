"""Matrix-free CG posterior vs the dense Cholesky oracle."""

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.forest import gram_from_leaves
from bark_jax.ops.iterative import (
    cg_posterior,
    cg_solve,
    leaf_features,
    shard_posterior_inputs,
)
from bark_jax.ops.linalg import JITTER

NODE_LIMIT = 16


def _random_leaves(rng, n, m=12):
    # random partitions: route to one of a few "leaf" slots per tree
    return jnp.asarray(rng.integers(0, 5, size=(n, m)), jnp.int32)


def _dense_K(leaves, noise, scale, mask=None):
    gram = gram_from_leaves(leaves, leaves, NODE_LIMIT, mask, mask)
    n = leaves.shape[0]
    return scale * gram + (JITTER + noise) * jnp.eye(n)


def test_factored_matvec_matches_dense():
    rng = np.random.default_rng(0)
    leaves = _random_leaves(rng, 40)
    v = jnp.asarray(rng.normal(size=40), jnp.float32)
    from bark_jax.ops.iterative import kernel_matvec

    Z = leaf_features(leaves, NODE_LIMIT)
    got = kernel_matvec(Z, 0.1, 1.3, v)
    want = _dense_K(leaves, 0.1, 1.3) @ v
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5)


def test_cg_solve_matches_cholesky():
    rng = np.random.default_rng(1)
    leaves = _random_leaves(rng, 48)
    y = jnp.asarray(rng.normal(size=48), jnp.float32)
    Z = leaf_features(leaves, NODE_LIMIT)
    x = cg_solve(Z, 0.05, 0.9, y)
    want = np.linalg.solve(np.asarray(_dense_K(leaves, 0.05, 0.9)), np.asarray(y))
    np.testing.assert_allclose(np.asarray(x), want, rtol=1e-3, atol=1e-4)


def test_cg_posterior_matches_dense_posterior():
    rng = np.random.default_rng(2)
    n, b = 56, 9
    leaves = _random_leaves(rng, n)
    cand = _random_leaves(rng, b)
    y = jnp.asarray(rng.normal(size=n), jnp.float32)
    noise, scale = 0.08, 1.4

    mu, var = cg_posterior(leaves, cand, y, noise, scale, NODE_LIMIT)

    K = np.asarray(_dense_K(leaves, noise, scale), np.float64)
    K_xX = scale * np.asarray(
        gram_from_leaves(cand, leaves, NODE_LIMIT), np.float64
    )
    sol = np.linalg.solve(K, np.asarray(y, np.float64))
    want_mu = K_xX @ sol
    want_var = scale - np.einsum(
        "bn,bn->b", K_xX, np.linalg.solve(K, K_xX.T).T
    )
    np.testing.assert_allclose(np.asarray(mu), want_mu, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(var), want_var, rtol=1e-3, atol=1e-4)


def test_cg_posterior_padding_inert():
    rng = np.random.default_rng(3)
    n, pad = 40, 64
    leaves = _random_leaves(rng, n)
    cand = _random_leaves(rng, 5)
    y = jnp.asarray(rng.normal(size=n), jnp.float32)

    mu0, var0 = cg_posterior(leaves, cand, y, 0.1, 1.0, NODE_LIMIT)

    leaves_p = jnp.concatenate(
        [leaves, jnp.broadcast_to(leaves[:1], (pad - n, leaves.shape[1]))]
    )
    y_p = jnp.concatenate([y, jnp.zeros((pad - n,), jnp.float32)])
    mask = jnp.concatenate(
        [jnp.ones((n,), jnp.float32), jnp.zeros((pad - n,), jnp.float32)]
    )
    mu1, var1 = cg_posterior(leaves_p, cand, y_p, 0.1, 1.0, NODE_LIMIT, mask)
    np.testing.assert_allclose(np.asarray(mu0), np.asarray(mu1), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(var0), np.asarray(var1), rtol=1e-4,
                               atol=1e-5)


def test_cg_posterior_sharded_matches_single():
    from jax.sharding import Mesh

    rng = np.random.default_rng(4)
    n, b = 64, 6
    leaves = _random_leaves(rng, n)
    cand = _random_leaves(rng, b)
    y = jnp.asarray(rng.normal(size=n), jnp.float32)

    mu0, var0 = cg_posterior(leaves, cand, y, 0.1, 1.2, NODE_LIMIT)

    devices = np.asarray(jax.devices()[:8])
    mesh = Mesh(devices, ("rows",))
    leaves_s, y_s = shard_posterior_inputs(mesh, leaves, y)
    mu1, var1 = cg_posterior(leaves_s, cand, y_s, 0.1, 1.2, NODE_LIMIT)
    np.testing.assert_allclose(np.asarray(mu0), np.asarray(mu1), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(var0), np.asarray(var1), rtol=1e-4,
                               atol=1e-5)


def test_surrogate_cg_backend_matches_dense():
    """forest_predict_cg == forest_predict through a real fitted surrogate."""
    from bark_jax.benchmarks import map_benchmark
    from bark_jax.fitting.params import SamplerParams
    from bark_jax.models.surrogate import BARKSurrogate

    bench = map_benchmark("TreeFunction", dim=2, m=6, function_seed=1)
    rng = np.random.default_rng(0)
    X = bench.domain.sample(20, rng)
    y = bench.f(X)
    params = SamplerParams(
        warmup_steps=5, num_samples=3, steps_per_sample=2, num_trees=6
    )
    dense = BARKSurrogate(bench.domain, params, seed=0,
                          predict_backend="dense").fit(X, y)
    Xte = bench.domain.sample(7, np.random.default_rng(9))
    mu_d, sd_d = dense.predict(Xte)

    dense.predict_backend = "cg"
    mu_c, sd_c = dense.predict(Xte)
    np.testing.assert_allclose(mu_d, mu_c, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(sd_d, sd_c, rtol=1e-3, atol=1e-4)
