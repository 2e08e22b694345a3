"""Parallel tempering and SMC tests."""

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.benchmarks import map_benchmark
from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.sampler import init_chain_state, step
from bark_jax.forest import create_empty_forest
from bark_jax.parallel.smc import run_smc, systematic_resample
from bark_jax.parallel.tempering import (
    geometric_ladder,
    run_parallel_tempering,
    swap_move,
)


def problem(n=20, seed=0, dim=2, m=6):
    bench = map_benchmark("TreeFunction", dim=dim, m=m, function_seed=1)
    rng = np.random.default_rng(seed)
    X = bench.domain.sample(n, rng)
    y = bench.f(X)
    y = (y - y.mean()) / max(y.std(), 1e-6)
    return (
        bench,
        jnp.asarray(X),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(bench.domain.bounds("bitmask")),
        jnp.asarray(bench.domain.feature_types()),
    )


def test_beta_one_matches_plain_step():
    """A tempered step at beta=1 must be bit-identical to the plain step."""
    bench, X, y, bounds, ft = problem()
    params = SamplerParams(num_trees=5)
    forest = create_empty_forest(5, params.node_limit)
    state = init_chain_state(forest, jnp.float32(0.1), jnp.float32(1.0), X, y, ft, params, bounds=bounds)
    k = jax.random.key(0)
    s_plain = step(k, state, X, y, bounds, ft, params)
    s_beta = step(k, state, X, y, bounds, ft, params, beta=jnp.float32(1.0))
    np.testing.assert_array_equal(
        np.asarray(s_plain.forest.threshold), np.asarray(s_beta.forest.threshold)
    )
    np.testing.assert_array_equal(
        np.asarray(s_plain.leaves), np.asarray(s_beta.leaves)
    )


def test_tempering_effect_hot_grows_more():
    """At high temperature (low beta) the likelihood barely gates proposals,
    so hot chains accept more structural moves and grow more nodes than
    cold chains over the same number of steps.

    This asserts the actual tempering *effect* (not just finiteness): mean
    active-node count after 30 steps must be strictly larger at beta=0.02
    than at beta=1 across 6 seeds, and the hot chains' final mll must not
    all exceed the cold chains' (hot states wander off the posterior mode).
    """
    bench, X, y, bounds, ft = problem(n=25)
    params = SamplerParams(num_trees=8)
    forest = create_empty_forest(8, params.node_limit)
    state = init_chain_state(forest, jnp.float32(0.1), jnp.float32(1.0), X, y, ft, params, bounds=bounds)

    @jax.jit
    def run_at(beta, seed):
        def body(s, k):
            return step(k, s, X, y, bounds, ft, params, beta=beta), None

        keys = jax.random.split(jax.random.key(seed), 30)
        s, _ = jax.lax.scan(body, state, keys)
        return jnp.sum(s.forest.active), s.mll

    hot_nodes, hot_mll = zip(*(run_at(jnp.float32(0.02), i) for i in range(6)))
    cold_nodes, cold_mll = zip(*(run_at(jnp.float32(1.0), i) for i in range(6)))
    hot_n = np.mean([int(v) for v in hot_nodes])
    cold_n = np.mean([int(v) for v in cold_nodes])
    assert hot_n > cold_n, f"tempering effect missing: hot={hot_n} cold={cold_n}"
    assert np.mean([float(v) for v in hot_mll]) <= np.mean(
        [float(v) for v in cold_mll]
    ), "hot chains should sit at lower likelihood than cold on average"


def test_swap_move_preserves_ladder():
    betas = geometric_ladder(8)
    mlls = jnp.asarray(np.random.default_rng(0).normal(size=8) * 5, jnp.float32)
    new = swap_move(jax.random.key(0), betas, mlls, jnp.int32(0))
    np.testing.assert_allclose(
        np.sort(np.asarray(new)), np.sort(np.asarray(betas)), rtol=1e-6
    )


def test_parallel_tempering_runs():
    bench, X, y, bounds, ft = problem()
    params = SamplerParams(num_trees=5)
    R = 4
    forest = create_empty_forest(5, params.node_limit, batch_shape=(R,))
    samples, beta_trace, swap_rate, cold_mlls = run_parallel_tempering(
        jax.random.key(0),
        forest,
        jnp.full((R,), 0.1),
        jnp.ones((R,)),
        X, y, bounds, ft, params,
        num_replicas=R,
        num_steps=20,
    )
    assert samples.noise.shape == (20,)
    assert np.isfinite(np.asarray(samples.noise)).all()
    # the ladder multiset is preserved at every step
    expect = np.sort(np.asarray(geometric_ladder(R)))
    for row in np.asarray(beta_trace):
        np.testing.assert_allclose(np.sort(row), expect, rtol=1e-6)
    assert 0.0 <= float(swap_rate) <= 1.0


def test_systematic_resample_unbiased():
    log_w = jnp.log(jnp.asarray([0.1, 0.2, 0.3, 0.4]))
    keys = jax.random.split(jax.random.key(0), 400)
    counts = np.zeros(4)
    idx = np.asarray(jax.vmap(lambda k: systematic_resample(k, log_w))(keys))
    for i in range(4):
        counts[i] = (idx == i).mean()
    np.testing.assert_allclose(counts, [0.1, 0.2, 0.3, 0.4], atol=0.02)


def test_smc_reaches_posterior():
    bench, X, y, bounds, ft = problem(n=20)
    params = SamplerParams(num_trees=5)
    res = run_smc(
        jax.random.key(0), X, y, bounds, ft, params,
        num_particles=16, num_rounds=12, mutation_steps=1,
    )
    betas = np.asarray(res.betas)
    assert (np.diff(betas) >= -1e-6).all(), "schedule must be nondecreasing"
    assert betas[-1] == 1.0, "must reach the posterior"
    assert np.isfinite(float(res.log_evidence))
    w = np.exp(np.asarray(res.log_weights))
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-4)
    assert res.model.noise.shape == (16,)
