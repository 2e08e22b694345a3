"""Cross-chip PT and SMC: 8-virtual-device tests of the collective layer.

The swap/resample/weight-statistic math must be bit-equal to the
single-device implementations; the full sharded runs are
integration-checked for shape, ladder and schedule invariants.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from bark_jax.benchmarks import map_benchmark
from bark_jax.fitting.params import SamplerParams
from bark_jax.forest import create_empty_forest
from bark_jax.parallel.smc import run_smc, run_smc_sharded
from bark_jax.parallel.tempering import (
    geometric_ladder,
    pt_swap_states,
    run_parallel_tempering_sharded,
    sharded_pt_swap,
)

R = 8

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < R, reason="needs the 8-device virtual CPU mesh"
)


def problem(n=16, seed=0, dim=2, m=5):
    bench = map_benchmark("TreeFunction", dim=dim, m=m, function_seed=1)
    rng = np.random.default_rng(seed)
    X = bench.domain.sample(n, rng)
    y = bench.f(X)
    y = (y - y.mean()) / max(y.std(), 1e-6)
    return (
        jnp.asarray(X),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(bench.domain.bounds("bitmask")),
        jnp.asarray(bench.domain.feature_types()),
    )


@pytest.mark.parametrize("parity", [0, 1])
def test_sharded_pt_swap_bit_equal(parity):
    """ppermute swap == single-device fixed-position swap, bitwise."""
    betas = geometric_ladder(R)
    mlls = jnp.asarray(
        np.random.default_rng(1).normal(size=R) * 3.0, jnp.float32
    )
    chains = {
        "a": jnp.asarray(
            np.random.default_rng(2).normal(size=(R, 4)), jnp.float32
        ),
        "b": jnp.arange(R, dtype=jnp.int32) * 7,
    }
    key = jax.random.key(42)

    ref_chains, ref_acc = pt_swap_states(key, chains, betas, mlls, parity)

    mesh = Mesh(np.array(jax.devices()[:R]), ("replicas",))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("replicas"), P("replicas"), P("replicas")),
        out_specs=(P("replicas"), P("replicas")),
        check_vma=False,
    )
    def go(c, b, m):
        c_local = jax.tree.map(lambda a: a[0], c)
        nc, acc = sharded_pt_swap(
            key, c_local, b[0], m[0], parity, "replicas", R
        )
        return jax.tree.map(lambda a: a[None], nc), acc[None]

    out_chains, out_acc = go(chains, betas, mlls)
    np.testing.assert_array_equal(np.asarray(out_acc), np.asarray(ref_acc))
    for k in chains:
        np.testing.assert_array_equal(
            np.asarray(out_chains[k]), np.asarray(ref_chains[k])
        )


def test_sharded_pt_swap_exchanges_on_accept():
    """Force an accept (huge mll gap favoring a swap) and check the states
    actually moved between the partner devices."""
    betas = geometric_ladder(R)
    # hot replicas hold much better mll -> cold-hot swaps strongly favored
    mlls = jnp.asarray(np.linspace(-50.0, 50.0, R), jnp.float32)
    chains = {"x": jnp.arange(R, dtype=jnp.float32)}
    key = jax.random.key(0)
    new_chains, acc = pt_swap_states(key, chains, betas, mlls, 0)
    acc = np.asarray(acc)
    x = np.asarray(new_chains["x"])
    assert acc.any(), "at least one pair must swap under a 100-nat gap"
    for i in range(0, R - 1, 2):
        if acc[i]:
            assert x[i] == i + 1 and x[i + 1] == i
        else:
            assert x[i] == i and x[i + 1] == i + 1


def test_sharded_pt_runs_and_cold_chain_is_position_zero():
    X, y, bounds, ft = problem()
    params = SamplerParams(num_trees=4)
    forest = create_empty_forest(4, params.node_limit, batch_shape=(R,))
    mesh = Mesh(np.array(jax.devices()[:R]), ("replicas",))
    samples, swap_rates = run_parallel_tempering_sharded(
        jax.random.key(0),
        forest,
        jnp.full((R,), 0.1, jnp.float32),
        jnp.ones((R,), jnp.float32),
        X,
        y,
        bounds,
        ft,
        params,
        mesh,
        num_steps=10,
    )
    assert samples.noise.shape == (10,)
    assert np.isfinite(np.asarray(samples.noise)).all()
    assert np.isfinite(np.asarray(samples.scale)).all()
    sr = np.asarray(swap_rates)
    assert ((sr >= 0.0) & (sr <= 1.0)).all()


def test_sharded_smc_matches_single_device_schedule():
    """The tempering schedule, ESS trace and evidence are computed from
    gathered population scalars -> must match the vmapped run closely."""
    X, y, bounds, ft = problem(n=12)
    params = SamplerParams(num_trees=4)
    mesh = Mesh(np.array(jax.devices()[:R]), ("particles",))
    kwargs = dict(num_particles=16, num_rounds=6, mutation_steps=1)
    ref = run_smc(jax.random.key(3), X, y, bounds, ft, params, **kwargs)
    shd = run_smc_sharded(
        jax.random.key(3), X, y, bounds, ft, params, mesh, **kwargs
    )
    np.testing.assert_allclose(
        np.asarray(shd.betas), np.asarray(ref.betas), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(shd.ess_trace), np.asarray(ref.ess_trace), rtol=1e-4
    )
    np.testing.assert_allclose(
        float(shd.log_evidence), float(ref.log_evidence), rtol=1e-4
    )
    w = np.exp(np.asarray(shd.log_weights))
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-4)
    assert shd.model.noise.shape == (16,)


def test_smc_state_gather_sits_inside_resample_conditional():
    """Scale-honesty: the full particle-state all-gathers
    must execute only on resample rounds. Asserted on the compiled HLO:
    every all-gather of a rank>=2 tensor (the forest/kernel state; the
    per-round weight statistics are rank-1 scalars) lives in a computation
    invoked by a ``conditional`` op, not in the unconditional scan body."""
    import re

    X, y, bounds, ft = problem(n=16)
    params = SamplerParams(num_trees=4, node_limit=16, max_depth=4)
    mesh = Mesh(np.array(jax.devices()[:R]), ("particles",))

    def fn(k):
        return run_smc_sharded(
            k, X, y, bounds, ft, params, mesh,
            num_particles=R, num_rounds=2, mutation_steps=1,
        )

    hlo = jax.jit(fn).lower(jax.random.key(0)).compile().as_text()
    lines = hlo.splitlines()
    comp = None
    state_gather_comps = set()
    n_state_gathers = 0
    for ln in lines:
        if ln.rstrip().endswith("{"):
            comp = ln.strip().split()[0].lstrip("%")
        if "all-gather" in ln and comp is not None:
            shape = re.search(r"(f32|s32|pred|u32|bf16)\[([\d,]*)\]", ln)
            if shape and "," in shape.group(2):  # rank >= 2 -> state tensor
                state_gather_comps.add(comp)
                n_state_gathers += 1
    assert n_state_gathers > 0, "expected state all-gathers in the program"
    cond_lines = [ln for ln in lines if "conditional(" in ln]
    for c in state_gather_comps:
        assert any(c in ln for ln in cond_lines), (
            f"state all-gather in computation {c!r} is not under a "
            f"conditional — it would run every round"
        )


def test_sharded_acquisition_scores_match():
    """Candidate-sharded acquisition evaluation == single-device scores."""
    from bark_jax.models.surrogate import BARKSurrogate
    from bark_jax.optimizer.acquisition import (
        build_acquisition,
        evaluate_acquisition,
        evaluate_acquisition_sharded,
    )

    bench = map_benchmark("TreeFunction", dim=3, m=5, function_seed=1)
    rng = np.random.default_rng(0)
    X = bench.domain.sample(16, rng)
    y = bench.f(X)
    params = SamplerParams(
        warmup_steps=10, num_samples=4, steps_per_sample=2,
        num_chains=2, num_trees=5,
    )
    sur = BARKSurrogate(bench.domain, params, seed=0)
    sur.fit(X, y)
    ft = jnp.asarray(bench.domain.feature_types())
    tx, ty = sur.train_data
    acq = build_acquisition(
        sur.model, tx, ty, ft, params.max_depth, train_mask=sur.train_mask
    )
    cands = jnp.asarray(bench.domain.sample(64, rng))
    mesh = Mesh(np.array(jax.devices()[:R]), ("candidates",))
    s_single = evaluate_acquisition(acq, cands, ft, params.max_depth)
    s_shard = evaluate_acquisition_sharded(acq, cands, ft, mesh, params.max_depth)
    np.testing.assert_allclose(
        np.asarray(s_shard), np.asarray(s_single), rtol=1e-5, atol=1e-6
    )
