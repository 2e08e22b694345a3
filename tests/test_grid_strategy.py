"""Grid-UCB (BARTGrid analogue) strategy + Sobol sampling + function draws.

Parity targets: strategies/bart_grid.py:41-58 (grid reparam-UCB),
surrogates/bart.py:54-66 (function_samples), BoFire SOBOL fallback sampling.
"""

import jax.numpy as jnp
import numpy as np

from bark_jax.benchmarks.tree_function import TreeFunction
from bark_jax.domain import (
    CategoricalInput,
    ContinuousInput,
    Domain,
    IntegerInput,
)
from bark_jax.fitting.params import SamplerParams
from bark_jax.models.surrogate import BARKPriorSurrogate, BARKSurrogate
from bark_jax.strategies.tree_kernel import make_strategy


def mixed_domain():
    return Domain(
        [
            ContinuousInput(key="c0", bounds=(-1.0, 2.0)),
            IntegerInput(key="i0", bounds=(0, 4)),
            CategoricalInput(key="k0", categories=("a", "b", "c")),
        ]
    )


def test_sobol_points_are_in_domain_and_stratified():
    domain = mixed_domain()
    X = domain.sample_sobol(256, seed=3)
    assert X.shape == (256, 3)
    assert (X[:, 0] >= -1.0).all() and (X[:, 0] <= 2.0).all()
    assert set(np.unique(X[:, 1])) <= {0.0, 1.0, 2.0, 3.0, 4.0}
    assert set(np.unique(X[:, 2])) == {0.0, 1.0, 2.0}
    # stratified flooring: each category level gets ~equal measure
    counts = np.bincount(X[:, 2].astype(int), minlength=3)
    assert counts.min() > 256 / 3 * 0.7
    # round-trips through the domain projection unchanged
    np.testing.assert_allclose(domain.round(X), X)


def test_function_samples_shape_and_spread():
    bench = TreeFunction(dim=3, m=10, function_seed=1)
    rng = np.random.default_rng(0)
    X = bench.domain.sample(30, rng)
    y = bench.f(X)
    params = SamplerParams(
        warmup_steps=5, num_samples=4, steps_per_sample=2, num_chains=2,
        num_trees=10,
    )
    sur = BARKSurrogate(bench.domain, params, seed=0).fit(X, y)
    Xq = bench.domain.sample(9, rng)
    draws = sur.function_samples(Xq, num_draws=3)
    assert draws.shape == (2 * 4 * 3, 9)
    # draws vary across posterior samples and noise draws
    assert draws.std(axis=0).min() > 0.0
    # and are centred near the predictive mean
    mu, _ = sur.predict(Xq)
    assert np.abs(draws.mean(axis=0) - mu[:, 0]).max() < 5.0


def test_grid_ucb_strategy_end_to_end():
    bench = TreeFunction(dim=2, m=10, function_seed=2)
    rng = np.random.default_rng(1)
    X = bench.domain.sample(20, rng)
    y = bench.f(X)

    # BARKPrior surrogate keeps the test cheap (no MCMC)
    strategy = make_strategy(
        "BARTGrid",
        bench.domain,
        seed=0,
        surrogate=BARKPriorSurrogate(bench.domain, num_samples=8, seed=0),
        max_grid=256,
    )
    strategy.tell(X, y)
    assert strategy.has_sufficient_experiments()
    cand = strategy.ask(1)
    assert cand.shape == (1, 2)
    np.testing.assert_allclose(bench.domain.round(cand), cand)
    # the chosen grid point's acquisition beats a random candidate's mean
    strategy.add(cand, bench.f(cand))
    cand2 = strategy.ask(1)
    assert cand2.shape == (1, 2)


def test_grid_ucb_prefers_low_posterior_mean_region():
    """With a near-deterministic surrogate the reparam-LCB argmax must sit
    in the low-mean region (minimization)."""
    domain = Domain([ContinuousInput(key="x", bounds=(0.0, 1.0))])
    X = np.linspace(0, 1, 40).reshape(-1, 1).astype(np.float32)
    y = (X[:, 0] - 0.25) ** 2  # minimum at 0.25

    params = SamplerParams(
        warmup_steps=30, num_samples=5, steps_per_sample=4, num_chains=2,
        num_trees=15,
    )
    strategy = make_strategy(
        "GridUCB", domain, seed=0,
        surrogate=BARKSurrogate(domain, params, seed=0), max_grid=512,
    )
    strategy.tell(X, y)
    cand = strategy.ask(1)
    assert abs(float(cand[0, 0]) - 0.25) < 0.2


def test_smac_strategy_body_or_guarded():
    """SMACStrategy: full tell/ask wrapper when smac is installed, an
    informative error otherwise (parity: strategies/smac.py:19-24)."""
    import pytest

    from bark_jax.benchmarks import map_benchmark
    from bark_jax.strategies.baselines import smac_strategy

    bench = map_benchmark("TreeFunction", dim=2, m=5, function_seed=1)
    try:
        import smac  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="smac"):
            smac_strategy(bench.domain)
        return
    strat = smac_strategy(bench.domain, seed=0)
    rng = np.random.default_rng(0)
    X = bench.domain.sample(4, rng)
    strat.tell(X, bench.f(X))
    x = strat.ask(1)
    assert x.shape == (1, bench.domain.dim)


def test_relaxed_gp_fits_lengthscales():
    """With MLL fitting on, the relaxed GP recovers that only x_0 matters
    (fitted lengthscale for the dead dimension grows much larger)."""
    from bark_jax.domain import ContinuousInput, Domain
    from bark_jax.strategies.baselines import RelaxedGPStrategy

    dom = Domain([
        ContinuousInput("x_0", (0.0, 1.0)),
        ContinuousInput("x_1", (0.0, 1.0)),
    ])
    rng = np.random.default_rng(0)
    X = dom.sample(40, rng)
    y = np.sin(8.0 * X[:, 0])  # x_1 is a dead dimension
    strat = RelaxedGPStrategy(dom, seed=0, fit_steps=200)
    strat.tell(X, y)
    Z = jnp.asarray(strat._to_relaxed(strat.X))
    y_std = jnp.asarray((y - y.mean()) / y.std(), jnp.float32)
    span = strat.bounds_relax[:, 1] - strat.bounds_relax[:, 0]
    ls0 = jnp.asarray(np.maximum(span, 1e-3) * 0.3)
    ls, scale, noise = strat._fit_hypers(Z, y_std, ls0)
    assert float(ls[1]) > 2.0 * float(ls[0]), (
        f"dead dim lengthscale {float(ls[1])} should exceed active "
        f"{float(ls[0])}"
    )
    assert noise < 0.5
    # and the strategy still proposes in-domain points
    x = strat.ask(1)
    assert x.shape == (1, 2)
    assert (x >= 0).all() and (x <= 1).all()


def test_entmoot_strategy_body_or_guarded():
    """EntmootStrategy: tell/ask wrapper when entmoot is installed, an
    informative error otherwise (parity: the reference's registry hook,
    examples/bayes_opt/bark_study_strategy.py:84-89)."""
    import pytest

    from bark_jax.benchmarks import map_benchmark
    from bark_jax.strategies.tree_kernel import make_strategy

    bench = map_benchmark("TreeFunction", dim=2, m=5, function_seed=1)
    try:
        import entmoot  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="entmoot"):
            make_strategy("Entmoot", bench.domain)
        return
    strat = make_strategy("Entmoot", bench.domain, seed=0)
    rng = np.random.default_rng(0)
    X = bench.domain.sample(4, rng)
    strat.tell(X, bench.f(X))
    x = strat.ask(1)
    assert x.shape == (1, bench.domain.dim)
