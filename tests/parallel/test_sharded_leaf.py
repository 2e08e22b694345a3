"""Multi-device coverage of the large-N leaf-tier lowering.

Every sharded test used N <= 16, so the shipped
N >= 512 default (refresh_style="leaf" + coeff scan) had never executed
under shard_map/psum anywhere. Here the chains-mesh sampler runs at
padded N = 512 on the 8-virtual-device CPU mesh with the auto-resolved
leaf lowering, and its psum diagnostics must agree with the unsharded
vmapped run on the same keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bark_jax.benchmarks import map_benchmark
from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.sampler import BARKModel, _resolve_styles, run_bark_sampler
from bark_jax.forest import create_empty_forest
from bark_jax.parallel.sharding import (
    chain_mesh,
    shard_model,
    sharded_run_sampler,
)

R = 8
N = 512

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < R, reason="needs the 8-device virtual CPU mesh"
)


def problem(m=6, seed=0):
    bench = map_benchmark("TreeFunction", dim=3, m=m, function_seed=1)
    rng = np.random.default_rng(seed)
    X = bench.domain.sample(N, rng)
    y = bench.f(X)
    y = (y - y.mean()) / max(y.std(), 1e-6)
    return (
        jnp.asarray(X),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(bench.domain.bounds("bitmask")),
        jnp.asarray(bench.domain.feature_types()),
    )


def test_leaf_tier_resolves_at_512():
    """Guard the guard: this file must actually cover the leaf lowering."""
    params = SamplerParams(num_trees=6)
    resolved = _resolve_styles(params, N)
    assert resolved.refresh_style == "leaf"
    assert resolved.scan_style == "coeff"


def test_sharded_leaf_sampler_matches_unsharded():
    X, y, bounds, ft = problem()
    params = SamplerParams(
        warmup_steps=2, num_samples=2, steps_per_sample=1, num_chains=R,
        num_trees=6,
    )
    forest = create_empty_forest(6, params.node_limit, batch_shape=(R,))
    model = BARKModel(
        forest,
        jnp.full((R,), 0.1, jnp.float32),
        jnp.ones((R,), jnp.float32),
    )

    ref = run_bark_sampler(
        jax.random.key(5), model, X, y, bounds, ft, params
    )

    mesh = chain_mesh(R)
    sharded = shard_model(model, mesh)
    samples, diag = sharded_run_sampler(
        jax.random.key(5), sharded, X, y, bounds, ft, params, mesh
    )

    assert samples.noise.shape == (R, params.num_samples)
    assert np.isfinite(np.asarray(samples.noise)).all()
    assert np.isfinite(float(diag.mean_mll))
    # one chain per device vs vmapped-on-one-device: same keys, same math —
    # trajectories must match to float tolerance (not bitwise: the vmapped
    # and per-device lowerings may fuse differently)
    np.testing.assert_allclose(
        np.asarray(samples.noise), np.asarray(ref.noise), rtol=2e-4, atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(samples.scale), np.asarray(ref.scale), rtol=2e-4, atol=2e-5
    )
    # forest structure is discrete: identical accepted moves expected
    np.testing.assert_array_equal(
        np.asarray(samples.forest.feature), np.asarray(ref.forest.feature)
    )
