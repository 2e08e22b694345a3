"""Acquisition-search optimality — the end-to-end integration test.

Parity: tests/optimization/test_optimality.py:68-108 in the reference — the
full pipeline (sample data -> run sampler -> build acquisition -> propose)
must return a point whose acquisition value beats the best of 1000 random
candidates.
"""

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.benchmarks.tree_function import TreeFunction
from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.sampler import BARKModel, run_bark_sampler
from bark_jax.forest import create_empty_forest
from bark_jax.optimizer.acquisition import build_acquisition, evaluate_acquisition
from bark_jax.optimizer.search import propose


def test_proposal_beats_random_candidates():
    bench = TreeFunction(dim=3, m=10, function_seed=2)
    dom = bench.domain
    rng = np.random.default_rng(0)
    X = dom.sample(30, rng)
    y = bench.f(X)
    y_std = (y - y.mean()) / y.std()

    params = SamplerParams(
        warmup_steps=30, num_samples=5, steps_per_sample=5, num_chains=1, num_trees=10
    )
    ft = jnp.asarray(dom.feature_types())
    bounds = jnp.asarray(dom.bounds("bitmask"))
    forest = create_empty_forest(params.num_trees, params.node_limit, batch_shape=(1,))
    model = BARKModel(forest, jnp.full((1,), 0.1), jnp.ones((1,)))
    samples = run_bark_sampler(
        jax.random.key(0),
        model,
        jnp.asarray(X),
        jnp.asarray(y_std, jnp.float32),
        bounds,
        ft,
        params,
    )

    acq = build_acquisition(
        samples, jnp.asarray(X), jnp.asarray(y_std, jnp.float32), ft, params.max_depth
    )
    cand, val = propose(
        jax.random.key(1),
        acq,
        dom,
        ft,
        num_candidates=1024,
        num_rounds=3,
        rng=np.random.default_rng(1),
    )

    random_cands = jnp.asarray(dom.sample(1000, rng))
    random_vals = np.asarray(
        evaluate_acquisition(acq, random_cands, ft, params.max_depth)
    )

    # the returned leaf-box center must itself score at least as well
    center_val = float(
        evaluate_acquisition(acq, jnp.asarray(cand[None, :]), ft, params.max_depth)[0]
    )
    assert center_val <= random_vals.min() + 1e-3
    assert val <= random_vals.min() + 1e-6


def test_leaf_center_preserves_acquisition():
    """Acquisition is piecewise constant on leaf boxes: the box center must
    score identically to the raw optimum (proposals.py:131-147 semantics)."""
    bench = TreeFunction(dim=2, m=8, function_seed=3)
    dom = bench.domain
    rng = np.random.default_rng(2)
    X = dom.sample(20, rng)
    y = bench.f(X)
    y_std = (y - y.mean()) / max(y.std(), 1e-6)

    params = SamplerParams(
        warmup_steps=20, num_samples=4, steps_per_sample=5, num_chains=1, num_trees=8
    )
    ft = jnp.asarray(dom.feature_types())
    bounds = jnp.asarray(dom.bounds("bitmask"))
    forest = create_empty_forest(params.num_trees, params.node_limit, batch_shape=(1,))
    model = BARKModel(forest, jnp.full((1,), 0.1), jnp.ones((1,)))
    samples = run_bark_sampler(
        jax.random.key(3),
        model,
        jnp.asarray(X),
        jnp.asarray(y_std, jnp.float32),
        bounds,
        ft,
        params,
    )
    acq = build_acquisition(
        samples, jnp.asarray(X), jnp.asarray(y_std, jnp.float32), ft, params.max_depth
    )

    raw, raw_val = propose(
        jax.random.key(4), acq, dom, ft, num_candidates=512, num_rounds=2,
        return_center=False, rng=np.random.default_rng(3),
    )
    center, _ = propose(
        jax.random.key(4), acq, dom, ft, num_candidates=512, num_rounds=2,
        return_center=True, rng=np.random.default_rng(3),
    )
    vals = np.asarray(
        evaluate_acquisition(
            acq, jnp.asarray(np.stack([raw, center])), ft, params.max_depth
        )
    )
    np.testing.assert_allclose(vals[0], vals[1], atol=1e-4)
