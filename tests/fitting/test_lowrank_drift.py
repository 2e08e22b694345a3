"""Bound the in-scan Sherman-Morrison carry error at low noise (256-511 tier).

``results/ab_r4/leaf_numerics.md`` asserts the dense
tiers' explicit-inverse in-scan carry error is "negligible below N=512"
without a test, while the paper-budget parity run itself realized
nu ~ 0.016. Here the claim becomes a tested invariant: at N=384 (the
lowrank auto tier) with noise FORCED to 0.005 — well below anything the
parity runs realized — the move scan's final carried MLL must match an
exact float64 factor-form recompute of the post-move state to a fraction
of a nat. The scan's MH ratios consume exactly this carry, so bounding
it bounds the accept-ratio corruption of the whole tier.

The comparison target is the same quantity the refresh recomputes: the
MLL of the accepted forest at the carried (noise, scale). Parity anchor
for the transition kernel: src/bark/fitting/bark_sampler.py:233-264.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bark_jax.benchmarks.tree_function import TreeFunction
from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.sampler import (
    BARKModel,
    _tree_moves_rank1,
    init_chain_state,
    run_bark_sampler,
)
from bark_jax.forest import create_empty_forest, gram_from_leaves

N = 384
M = 50


def _exact_mll_f64(leaves, noise, scale, y, node_limit):
    """Factor-form MLL in float64 from scratch (the drift-free oracle).

    The gram is taken from the same (exact-in-f32) one-hot matmul the
    refresh uses, then promoted to f64 — this isolates the scan's carry
    drift from the shared /m representation rounding.
    """
    import scipy.linalg as sla

    leaves = jnp.asarray(leaves)
    n = leaves.shape[0]
    gram = np.asarray(
        gram_from_leaves(leaves, leaves, node_limit)
    ).astype(np.float64)
    K = float(scale) * gram + (1e-6 + float(noise)) * np.eye(n)
    L = np.linalg.cholesky(K)
    zvec = sla.solve_triangular(L, np.asarray(y, np.float64), lower=True)
    logdet = 2.0 * np.sum(np.log(np.diag(L)))
    return 0.5 * (-np.sum(zvec * zvec) - logdet)


_WARM_CACHE = {}


def _warm_problem(key):
    """Warm forest + data, computed once per process (the warmup run is
    identical across all parametrizations)."""
    if "warm" in _WARM_CACHE:
        return _WARM_CACHE["warm"]
    bench = TreeFunction(dim=5, cat_dim=0, num_cat=5, m=50, function_seed=1)
    rng = np.random.default_rng(0)
    X = bench.domain.sample(N, rng)
    y = bench.f(X)
    y = (y - y.mean()) / y.std()
    Xj, yj = jnp.asarray(X), jnp.asarray(y, jnp.float32)
    bounds = jnp.asarray(bench.domain.bounds("bitmask"))
    ft = jnp.asarray(bench.domain.feature_types())

    warm_params = SamplerParams(
        warmup_steps=0, num_samples=1, steps_per_sample=30, num_chains=1,
        num_trees=M,
    )
    forest = create_empty_forest(M, warm_params.node_limit, batch_shape=(1,))
    model = BARKModel(forest, jnp.full((1,), 0.1), jnp.ones((1,)))
    samples = run_bark_sampler(
        key, model, Xj, yj, bounds, ft, warm_params
    )
    warm_forest = jax.tree.map(lambda a: a[0, -1], samples.forest)
    _WARM_CACHE["warm"] = (warm_forest, Xj, yj, bounds, ft)
    return _WARM_CACHE["warm"]


def _warmed_state(scan_style, noise_force, key):
    warm_forest, Xj, yj, bounds, ft = _warm_problem(key)
    params = SamplerParams(
        num_trees=M, num_chains=1, scan_style=scan_style,
        refresh_style="onesolve",
    )
    state = init_chain_state(
        warm_forest, jnp.float32(noise_force), jnp.float32(1.0),
        Xj, yj, ft, params, bounds=bounds,
    )
    return state, params, Xj, yj, bounds, ft


@pytest.mark.parametrize("scan_style", ["lowrank", "coeff", "plain"])
@pytest.mark.parametrize("noise_force", [0.005, 0.016])
def test_in_scan_mll_drift_bounded_at_low_noise(scan_style, noise_force):
    state, params, X, y, bounds, ft = _warmed_state(
        scan_style, noise_force, jax.random.key(3)
    )
    mask = jnp.ones((N,), jnp.float32)
    forest, _, leaves, _, _, cur_mll = _tree_moves_rank1(
        jax.random.key(7), state, X, y, mask, jnp.float32(0.0), bounds, ft,
        params,
    )
    exact = _exact_mll_f64(
        leaves, state.noise, float(state.scale), y, params.node_limit
    )
    drift = abs(float(cur_mll) - exact)
    # |MLL| here is O(10^3-10^4); the carry must stay well under one nat
    # of error for the MH ratios (e^0.5 ~ 1.6x accept-prob distortion cap)
    assert np.isfinite(float(cur_mll))
    assert drift < 0.5, (
        f"in-scan MLL drift {drift:.4f} nats at nu={noise_force} "
        f"(scan={scan_style}; carried {float(cur_mll):.3f} vs exact "
        f"{exact:.3f})"
    )
