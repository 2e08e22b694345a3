"""Multi-fidelity BO driver test (C17 end-to-end coverage).

Runs the committed examples/mf_bo.py study loop for a few iterations and
checks the moving parts actually engage: the MOGP fits, the information-
based chooser returns valid fidelities, costs accumulate, and the target-
fidelity incumbent never worsens.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np

_MF_BO = Path(__file__).resolve().parents[2] / "examples" / "mf_bo.py"


def _load_mf_bo():
    spec = importlib.util.spec_from_file_location("mf_bo_example", _MF_BO)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["mf_bo_example"] = mod
    spec.loader.exec_module(mod)
    return mod


def test_mf_bo_study_loop():
    mf_bo = _load_mf_bo()
    records = mf_bo.run_study(
        seed=0, num_iter=4, num_init=6, num_candidates=64, num_fstar=8,
        surrogate_kwargs={"num_boost_round": 20},
    )
    assert len(records) == 4
    fids = [r["fidelity"] for r in records]
    assert all(f in (0, 1) for f in fids)
    costs = [r["cum_cost"] for r in records]
    assert all(b > a for a, b in zip(costs, costs[1:]))  # cost strictly grows
    bests = [r["best_target"] for r in records]
    assert all(np.isfinite(b) for b in bests)
    assert all(b2 <= b1 + 1e-12 for b1, b2 in zip(bests, bests[1:]))


def test_fstar_samples_are_plausible_minima():
    mf_bo = _load_mf_bo()
    from bark_jax.benchmarks import map_benchmark
    from bark_jax.models.mogp import LeafMOGPSurrogate

    bench = map_benchmark("CurrinExp2D")
    rng = np.random.default_rng(0)
    X = bench.domain.sample(12, rng)
    fid = np.arange(12) % 2
    y = bench.f_fidelity(X, fid)
    mogp = LeafMOGPSurrogate(bench.domain, num_tasks=2, num_boost_round=20)
    mogp.fit(X, fid, y)

    f_star = mf_bo.fstar_samples_mogp(mogp, X, num_fstar=32, rng=rng)
    assert f_star.shape == (32,)
    assert np.all(np.isfinite(f_star))
    # f* is a min over joint latent posterior draws at the train sites
    # (standardized space): draws must sit well below the average and
    # below the *posterior mean* floor, with genuine MC spread. (They
    # need not undercut the most extreme noisy observation — the latent
    # posterior shrinks it toward the mean.)
    mu0, _ = mogp._posterior_joint(X, np.zeros(len(X), np.int64))
    # E[min of a draw] <= min posterior mean (Jensen); allow 4 standard
    # errors of MC slack on the 32-draw average
    slack = 4.0 * float(f_star.std()) / np.sqrt(len(f_star))
    assert f_star.mean() <= float(np.asarray(mu0).min()) + slack
    assert f_star.std() > 0.0


def test_ask_cold_start_partial_fidelities():
    """ask() must round-robin fidelities while some task is unobserved.

    Round-3 regression: with >=2 observations at one
    fidelity, `len(self.y or [])` raised "truth value of an array ...
    is ambiguous" — exactly the state the round-robin branch serves.
    """
    from bark_jax.benchmarks import map_benchmark
    from bark_jax.strategies.multi_fidelity import MultiFidelityStrategy

    bench = map_benchmark("CurrinExp2D")
    rng = np.random.default_rng(0)
    X = bench.domain.sample(3, rng)
    fid = np.zeros(3, np.int64)  # all at fidelity 0: task 1 unobserved
    y = bench.f_fidelity(X, fid)

    strat = MultiFidelityStrategy(bench.domain, fidelity_costs=[1.0, 0.2], seed=0)
    strat.tell(X, fid, y)
    assert not strat.has_sufficient_experiments()
    x, f = strat.ask()
    assert x.shape == (1, len(bench.domain.inputs))
    assert f == 3 % 2  # round-robin on observation count
