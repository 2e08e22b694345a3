"""Tempered surrogate fits (fit_style="tempered") + fit diagnostics.

The PT ladder machinery itself is oracle-tested in tests/fitting and
tests/parallel; here the surrogate-level wiring is covered: cold-chain
samples flow into the standard BARKModel shape, warm starts work, the
BO strategy runs end-to-end on a tempered surrogate, and every fit
records split-R-hat/ESS diagnostics.
"""

import numpy as np
import pytest

from bark_jax.benchmarks.tree_function import TreeFunction
from bark_jax.fitting.params import SamplerParams
from bark_jax.models.surrogate import BARKSurrogate

FAST = SamplerParams(
    warmup_steps=6, num_samples=3, steps_per_sample=2, num_chains=2,
    num_trees=8,
)


def _problem(n=24, seed=0):
    bench = TreeFunction(dim=3, m=10, function_seed=1)
    rng = np.random.default_rng(seed)
    X = bench.domain.sample(n, rng)
    y = bench.f(X)
    return bench, X, y


def test_tempered_fit_shapes_and_diagnostics():
    bench, X, y = _problem()
    sur = BARKSurrogate(
        bench.domain, FAST, seed=0, fit_style="tempered", num_replicas=4
    )
    sur.fit(X, y)
    assert sur.model.noise.shape == (FAST.num_chains, FAST.num_samples)
    assert np.isfinite(np.asarray(sur.model.noise)).all()
    d = sur.fit_diagnostics
    assert set(d) >= {"r_hat_noise", "ess_noise", "swap_rate"}
    assert 0.0 <= d["swap_rate"] <= 1.0
    mu, std = sur.predict(X[:5])
    assert mu.shape == (5, 1) and np.isfinite(mu).all()
    assert (std > 0).all()


def test_tempered_warm_start_refit():
    bench, X, y = _problem()
    sur = BARKSurrogate(
        bench.domain, FAST, seed=0, fit_style="tempered", num_replicas=4
    )
    sur.fit(X, y)
    X2 = np.vstack([X, bench.domain.sample(8, np.random.default_rng(9))])
    y2 = bench.f(X2)
    sur.fit(X2, y2)  # warm start: warmup skipped, replicas re-tiled
    assert sur.model.noise.shape == (FAST.num_chains, FAST.num_samples)
    assert np.isfinite(np.asarray(sur.model.noise)).all()


def test_chains_fit_also_records_diagnostics():
    bench, X, y = _problem()
    sur = BARKSurrogate(bench.domain, FAST, seed=0)
    sur.fit(X, y)
    assert sur.fit_diagnostics is not None
    assert "r_hat_noise" in sur.fit_diagnostics
    assert "swap_rate" not in sur.fit_diagnostics


def test_unknown_fit_style_rejected():
    bench, _, _ = _problem()
    with pytest.raises(ValueError, match="fit_style"):
        BARKSurrogate(bench.domain, FAST, fit_style="annealed")


def test_tempered_strategy_end_to_end():
    from bark_jax.strategies.tree_kernel import TreeKernelStrategy

    bench, X, y = _problem(n=12)
    sur = BARKSurrogate(
        bench.domain, FAST, seed=0, fit_style="tempered", num_replicas=4
    )
    strat = TreeKernelStrategy(
        bench.domain, surrogate=sur, seed=0, num_candidates=128, num_rounds=2
    )
    strat.tell(X, y)
    for _ in range(2):
        c = strat.ask(1)
        assert c.shape[0] == 1
        strat.add(c, bench.f(c))
