"""Duplicate-proposal detection in TreeKernelStrategy.ask.

The leaf-box-centered LCB acquisition is piecewise
constant, so once one box dominates, every ask re-centers the identical
point and the BO loop stalls (the recorded N~4096 study proposed the same
objective value six iterations straight; the reference shares the failure
mode, src/bark/optimizer/proposals.py:131-147). ask() now detects a
candidate that replicates a train row or the previous proposal and falls
back to a Thompson draw from the exact leaf-space posterior, then to a
feasible random candidate.
"""

import numpy as np

from bark_jax.benchmarks.tree_function import TreeFunction
from bark_jax.fitting.params import SamplerParams
from bark_jax.strategies.tree_kernel import TreeKernelStrategy

FAST = SamplerParams(
    warmup_steps=10, num_samples=3, steps_per_sample=2, num_chains=2,
    num_trees=10,
)


def _fitted_strategy(seed=0, dedup=True):
    bench = TreeFunction(dim=3, m=10, function_seed=1)
    rng = np.random.default_rng(seed)
    X = bench.domain.sample(16, rng)
    y = bench.f(X)
    strat = TreeKernelStrategy(
        bench.domain, params=FAST, seed=seed, num_candidates=256,
        num_rounds=2, dedup=dedup,
    )
    strat.tell(X, y)
    return strat, bench


def test_is_duplicate_detects_train_rows_and_last_proposal():
    strat, _ = _fitted_strategy()
    assert strat._is_duplicate(strat.X[3].copy())
    # a point off every train row by a finite fraction of the span is new
    probe = strat.X[3].copy()
    probe[0] += 0.05
    assert not strat._is_duplicate(probe)
    strat._last_proposal = probe
    assert strat._is_duplicate(probe)


def test_ask_falls_back_to_thompson_on_duplicate(monkeypatch):
    strat, _ = _fitted_strategy()
    incumbent = strat.X[int(np.argmin(strat.y))].copy()
    fresh = incumbent.copy()
    fresh[0] = min(fresh[0] + 0.1, 1.0)
    calls = []

    def fake_propose(use_ts):
        calls.append(use_ts)
        return fresh.copy() if use_ts else incumbent.copy()

    monkeypatch.setattr(strat, "_propose_once", fake_propose)
    out = strat.ask(1)
    # primary (LCB) proposal duplicated the incumbent -> one TS retry
    assert calls == [False, True]
    np.testing.assert_allclose(out[0], fresh)


def test_ask_random_fallback_when_ts_also_duplicates(monkeypatch):
    strat, _ = _fitted_strategy()
    incumbent = strat.X[int(np.argmin(strat.y))].copy()

    monkeypatch.setattr(
        strat, "_propose_once", lambda use_ts: incumbent.copy()
    )
    out = strat.ask(1)
    assert out.shape == (1, strat.X.shape[1])
    # the emitted candidate must NOT be the stalled duplicate
    assert np.abs(out[0] - incumbent).max() > 1e-8


def test_dedup_off_preserves_raw_proposal(monkeypatch):
    strat, _ = _fitted_strategy(dedup=False)
    incumbent = strat.X[int(np.argmin(strat.y))].copy()
    monkeypatch.setattr(
        strat, "_propose_once", lambda use_ts: incumbent.copy()
    )
    out = strat.ask(1)
    np.testing.assert_allclose(out[0], incumbent)


def test_end_to_end_asks_are_distinct():
    """Consecutive asks on a tiny, quickly-stalling problem must not emit
    the same candidate twice in a row (the r4 degenerate-study signature)."""
    strat, bench = _fitted_strategy(seed=3)
    prev = None
    for _ in range(4):
        cand = strat.ask(1)
        if prev is not None:
            assert np.abs(cand - prev).max() > 1e-10
        strat.add(cand, bench.f(cand))
        prev = cand
