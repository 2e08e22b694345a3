"""Checks that need an NVIDIA GPU; they skip on the CPU.

Run them on the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest -o addopts="" -m gpu tests/test_gpu.py

``chip_smoke.py`` runs the same comparisons at full width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from bark_jax.benchmarks.tree_function import TreeFunction
from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.prior import sample_forest_prior
from bark_jax.forest import create_empty_forest, route_forest, route_forest_select

pytestmark = pytest.mark.gpu


def test_routers_agree_on_the_card(gpu_device):
    """TF32 is the card's default matmul precision; the select router's
    0/1 operands are exact in it, so leaf ids must be equal."""
    bench = TreeFunction(dim=3, cat_dim=2, num_cat=5, m=20, function_seed=3)
    ft = jnp.asarray(bench.domain.feature_types())
    bounds = jnp.asarray(bench.domain.bounds("bitmask"))
    with jax.default_device(gpu_device):
        tree = jax.tree.map(
            lambda a: a[0],
            sample_forest_prior(jax.random.key(5), 20, bounds, ft),
        )
        X = jnp.asarray(bench.domain.sample(3000, np.random.default_rng(0)),
                        jnp.float32)
        walk = route_forest(tree, X, ft)
        select = route_forest_select(tree, X, ft)
    assert walk.devices() == {gpu_device}
    np.testing.assert_array_equal(np.asarray(walk), np.asarray(select))


@pytest.mark.parametrize("n", [200, 512])
def test_sampler_mll_matches_float64_on_the_card(gpu_device, n):
    """Refresh and carried scan MLLs (shipped precision gates) against the
    float64 host reference."""
    params = SamplerParams(num_trees=20)
    with jax.default_device(gpu_device):
        y, data = chip_smoke.tree_function_data(n, seed=n)
        state, after, leaves, scan_mll = chip_smoke._mll_probe(
            jax.random.key(n), create_empty_forest(20, params.node_limit),
            *data, params, 10,
        )
    for f32, (lv, noise, scale) in (
        (after.mll, (after.leaves, after.noise, after.scale)),
        (scan_mll, (leaves, state.noise, state.scale)),
    ):
        ref = chip_smoke.mll_float64(lv, y, noise, scale, params.node_limit)
        assert abs(float(f32) - ref) <= chip_smoke.mll_tolerance(ref)
