"""Platform dispatch: one resolver picks the leaf router, and the two routers
it chooses between return identical leaf ids on every input shape the
library feeds them (small batches, one block, the chunked path and its
padded tail, categorical splits, padded training rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bark_jax.benchmarks.tree_function import TreeFunction
from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.prior import sample_forest_prior
from bark_jax.fitting.sampler import _chol_block
from bark_jax.forest import (
    route_forest,
    route_forest_auto,
    route_forest_select,
    router_for,
)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_router_for_known_platforms_is_the_gather_walk(platform):
    # H100 timing (PERF.md): the gather walk beat the transition matmuls
    # at the acquisition and sampler-init shapes; CPU likewise
    assert router_for(platform) is route_forest


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_router_for_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no leaf router"):
        router_for(platform)


def test_router_for_defaults_to_the_running_backend():
    assert router_for() is router_for(jax.default_backend())


def _mixed_forest(m=10, node_limit=32, seed=5):
    bench = TreeFunction(dim=3, cat_dim=2, num_cat=5, m=m, function_seed=3)
    ft = jnp.asarray(bench.domain.feature_types())
    bounds = jnp.asarray(bench.domain.bounds("bitmask"))
    forest = sample_forest_prior(
        jax.random.key(seed), m, bounds, ft, node_limit=node_limit
    )
    return bench, ft, jax.tree.map(lambda a: a[0], forest)


@pytest.mark.parametrize(
    "rows", [1, 300, 2048, 2049, 5000],
    ids=["single", "small", "one_block", "chunked", "chunked_tail"],
)
def test_select_router_matches_gather_walk(rows):
    bench, ft, tree = _mixed_forest()
    X = jnp.asarray(
        bench.domain.sample(rows, np.random.default_rng(rows)), jnp.float32
    )
    walk = np.asarray(route_forest(tree, X, ft))
    select = np.asarray(route_forest_select(tree, X, ft))
    assert walk.shape == (rows, 10)
    np.testing.assert_array_equal(walk, select)
    np.testing.assert_array_equal(
        np.asarray(route_forest_auto(tree, X, ft)), walk
    )


def test_select_router_matches_gather_walk_on_padded_rows():
    """The bucketed BO path pads X with zero rows; padded rows route like
    any point at the origin, identically under both routers."""
    bench, ft, tree = _mixed_forest(seed=11)
    X = bench.domain.sample(45, np.random.default_rng(0))
    Xp = jnp.asarray(np.vstack([X, np.zeros((19, X.shape[1]))]), jnp.float32)
    walk = np.asarray(route_forest(tree, Xp, ft))
    np.testing.assert_array_equal(walk, np.asarray(route_forest_select(tree, Xp, ft)))
    np.testing.assert_array_equal(walk[45:], np.repeat(walk[45:46], 19, axis=0))


@pytest.mark.parametrize(
    "chol_block,n,expected",
    [(-1, 512, 0), (0, 512, 0), (128, 512, 128), (128, 480, 0)],
    ids=["auto", "plain", "divides", "does_not_divide"],
)
def test_chol_block_resolution(chol_block, n, expected):
    assert _chol_block(SamplerParams(chol_block=chol_block), n) == expected
