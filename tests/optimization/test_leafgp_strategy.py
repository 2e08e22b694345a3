"""LeafGP / LeafMOGP driving the BO loop.

Parity: the reference admits LeafGP into TreeKernelStrategy
(src/bofire_mixed/data_models/strategies/tree_kernel.py:31) through the
single-forest acquisition builder (src/bark/optimizer/opt_model.py:167-284,
which also covers LeafMOGP at the target fidelity).
"""

import jax.numpy as jnp
import numpy as np

from bark_jax.benchmarks import map_benchmark
from bark_jax.strategies.tree_kernel import make_strategy


def test_leafgp_ask_tell_loop():
    bench = map_benchmark("TreeFunction", dim=2, m=10, function_seed=4)
    dom = bench.domain
    strat = make_strategy(
        "LeafGP", dom, seed=0, num_candidates=512, num_rounds=2,
        num_boost_round=20,
    )
    rng = np.random.default_rng(0)
    X = dom.sample(20, rng)
    strat.tell(X, bench.f(X))
    assert strat.surrogate.is_fitted

    cand = strat.ask()
    assert cand.shape == (1, len(dom.inputs))
    bounds = dom.bounds("ordinal")
    assert (cand[0] >= bounds[:, 0] - 1e-9).all()
    assert (cand[0] <= bounds[:, 1] + 1e-9).all()

    # the loop continues: add the new observation, refit, ask again
    strat.add(cand, bench.f(cand))
    cand2 = strat.ask()
    assert np.isfinite(cand2).all()


def test_leafgp_proposal_beats_random():
    """Reference optimality criterion (tests/optimization/test_optimality.py
    in the reference): the search result must beat random candidates."""
    from bark_jax.optimizer.acquisition import (
        build_acquisition,
        evaluate_acquisition,
    )

    bench = map_benchmark("TreeFunction", dim=3, m=10, function_seed=6)
    dom = bench.domain
    strat = make_strategy(
        "LeafGP", dom, seed=1, num_candidates=1024, num_rounds=3,
        num_boost_round=25,
    )
    rng = np.random.default_rng(1)
    X = dom.sample(25, rng)
    strat.tell(X, bench.f(X))
    cand = strat.ask()

    sur = strat.surrogate
    ft = jnp.asarray(dom.feature_types())
    tx, ty = sur.train_data
    acq = build_acquisition(sur.model, tx, ty, ft, sur.params.max_depth)
    rand = jnp.asarray(dom.sample(500, rng))
    rand_vals = np.asarray(evaluate_acquisition(acq, rand, ft, sur.params.max_depth))
    cand_val = float(
        evaluate_acquisition(acq, jnp.asarray(cand), ft, sur.params.max_depth)[0]
    )
    assert cand_val <= rand_vals.min() + 1e-3


def test_mogp_acquisition_matches_posterior():
    """The MOGP LCB must equal mu - kappa*sigma of the surrogate's own
    latent target-fidelity posterior (standardized space)."""
    from bark_jax.models.mogp import LeafMOGPSurrogate
    from bark_jax.optimizer.acquisition import (
        build_acquisition_mogp,
        evaluate_acquisition,
    )

    bench = map_benchmark("CurrinExp2D")
    dom = bench.domain
    rng = np.random.default_rng(2)
    X = dom.sample(16, rng)
    fid = np.arange(16) % 2
    y = bench.f_fidelity(X, fid)

    mogp = LeafMOGPSurrogate(dom, num_tasks=2, num_boost_round=15, seed=2)
    mogp.fit(X, fid, y)

    cands = dom.sample(32, rng)
    acq = build_acquisition_mogp(mogp)
    ft = jnp.asarray(dom.feature_types())
    scores = np.asarray(evaluate_acquisition(acq, jnp.asarray(cands), ft))

    mu, cov = mogp._posterior_joint(cands, np.zeros(32, np.int64))
    mu = np.asarray(mu, np.float64)
    var = np.maximum(np.asarray(jnp.diagonal(cov), np.float64), 1e-12)
    expect = mu - 1.96 * np.sqrt(var)
    np.testing.assert_allclose(scores, expect, rtol=1e-3, atol=1e-4)


def test_multi_fidelity_strategy_ask_tell():
    bench = map_benchmark("CurrinExp2D")
    dom = bench.domain
    strat = make_strategy(
        "LeafMOGP", dom, seed=3,
        fidelity_costs=list(bench.fidelity_costs),
        num_candidates=256, num_rounds=1, num_fstar=8,
    )
    rng = np.random.default_rng(3)
    X = dom.sample(10, rng)
    fid = np.arange(10) % 2
    strat.tell(X, fid, bench.f_fidelity(X, fid))

    x, f = strat.ask()
    assert x.shape == (1, len(dom.inputs))
    assert f in (0, 1)
    bounds = dom.bounds("ordinal")
    assert (x[0] >= bounds[:, 0] - 1e-9).all()
    assert (x[0] <= bounds[:, 1] + 1e-9).all()

    strat.add(x, [f], bench.f_fidelity(x, np.array([f])))
    x2, f2 = strat.ask()
    assert np.isfinite(x2).all() and f2 in (0, 1)
