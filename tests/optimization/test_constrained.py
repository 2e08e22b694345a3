"""Constraint-aware acquisition: BO loops on constrained benchmarks must
propose feasible candidates.

Parity: the reference lowers every domain constraint into the acquisition
MIP (src/bark/optimizer/opt_core.py:20-58) and re-centers proposals with a
min-center-dist MIP + epsilon-widening retries (proposals.py:56-66,150-214),
so its proposals are feasible by construction. Here feasibility comes from
the penalty-guided search + constrained centering in
bark_jax.optimizer.search; these tests assert the end-to-end feasible rate.
"""

import warnings

import numpy as np
import pytest

from bark_jax.benchmarks import map_benchmark
from bark_jax.constraints import (
    LinearInequalityConstraint,
    NChooseKConstraint,
    is_feasible,
    total_violation,
)
from bark_jax.domain import ContinuousInput, Domain
from bark_jax.fitting.params import SamplerParams
from bark_jax.optimizer.search import sample_feasible
from bark_jax.strategies.tree_kernel import RandomStrategy, TreeKernelStrategy

FAST = SamplerParams(warmup_steps=10, num_samples=3, steps_per_sample=2)


@pytest.mark.parametrize(
    "name", ["G1", "G3", "G4", "G6", "G7", "G10", "Alkylation", "PressureVessel"]
)
def test_sample_feasible(name):
    bench = map_benchmark(name)
    dom = bench.domain
    # feasibility sampling must be warning- and NaN-free across the whole
    # constrained registry (Alkylation's x6 expression once hit an
    # unguarded 0/0 and propagated NaN into feasibility logic)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        X = sample_feasible(dom, 8, np.random.default_rng(0))
        v = total_violation(dom.constraints, X, dom.input_keys)
    assert np.isfinite(X).all(), f"{name}: non-finite sample"
    assert np.isfinite(v).all(), f"{name}: non-finite violation"
    assert (v <= 1e-6).all(), f"{name}: max violation {v.max()}"


def test_alkylation_corner_nan_free():
    """The x_2 = x_3 = 0 lower-bound corner made x6 a 0/0;
    constraint evaluation there must now be finite and warning-free."""
    bench = map_benchmark("Alkylation")
    dom = bench.domain
    lb = np.array([inp.bounds[0] for inp in dom.inputs], np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        v = total_violation(dom.constraints, lb[None, :], dom.input_keys)
    assert np.isfinite(v).all()


@pytest.mark.parametrize("name", ["G1", "G6", "G10", "PressureVessel"])
def test_bo_proposals_feasible(name):
    """20-iteration BO runs must propose >= 95% feasible candidates."""
    bench = map_benchmark(name)
    dom = bench.domain
    rng = np.random.default_rng(0)
    X = sample_feasible(dom, 6, rng)
    y = bench.f(X)
    strat = TreeKernelStrategy(
        dom, params=FAST, seed=0, num_candidates=512, num_rounds=2
    )
    strat.tell(X, y)
    feasible = 0
    n_iter = 20
    for _ in range(n_iter):
        x = strat.ask(1)
        feasible += bool(is_feasible(dom.constraints, x, dom.input_keys)[0])
        strat.add(x, bench.f(x))
    assert feasible / n_iter >= 0.95, f"{name}: {feasible}/{n_iter} feasible"


def test_random_strategy_respects_constraints():
    bench = map_benchmark("G6")
    strat = RandomStrategy(bench.domain, seed=0)
    X = strat.ask(5)
    assert is_feasible(bench.domain.constraints, X, bench.domain.input_keys).all()


def test_nchoosek_feasible_sampling():
    """NChooseK has no smooth expression; rejection must still work."""
    dom = Domain(
        [ContinuousInput(f"x_{i}", (0.0, 1.0)) for i in range(4)],
        constraints=(
            NChooseKConstraint(
                features=["x_0", "x_1", "x_2", "x_3"], max_count=4, min_count=0
            ),
        ),
    )
    X = sample_feasible(dom, 4, np.random.default_rng(0))
    assert X.shape == (4, 4)


def test_warm_start_seeds_scored():
    """The incumbent is always injected into round 0 of the search."""
    dom = Domain([ContinuousInput("x_0", (0.0, 1.0))])
    strat = TreeKernelStrategy(dom, params=FAST, seed=0, num_candidates=128)
    X = np.array([[0.1], [0.5], [0.9]], np.float32)
    y = np.array([1.0, -2.0, 0.5])
    strat.tell(X, y)
    seeds = strat._warm_start_seeds()
    assert seeds is not None
    # first anchor row is the incumbent (argmin y)
    assert np.allclose(seeds[0], X[1])
    strat._last_proposal = np.array([0.3], np.float32)
    seeds = strat._warm_start_seeds()
    assert np.allclose(seeds[1], [0.3])


def test_penalized_search_prefers_feasible():
    """With a linear constraint, the proposal respects it even when the
    unconstrained optimum is infeasible."""
    bench = map_benchmark("G1")  # binary-ish 13-dim with 9 linear constraints
    dom = bench.domain
    rng = np.random.default_rng(1)
    X = sample_feasible(dom, 8, rng)
    y = bench.f(X)
    strat = TreeKernelStrategy(
        dom, params=FAST, seed=1, num_candidates=512, num_rounds=2
    )
    strat.tell(X, y)
    x = strat.ask(1)
    assert is_feasible(dom.constraints, x, dom.input_keys)[0]


def test_linear_constraint_violation_values():
    c = LinearInequalityConstraint(
        features=["a", "b"], coefficients=[1.0, 2.0], rhs=1.0
    )
    X = np.array([[0.2, 0.2], [1.0, 1.0]])
    v = c.violation(X, ["a", "b"])
    assert np.allclose(v, [0.0, 2.0])
