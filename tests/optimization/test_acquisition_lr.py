"""Factored (matrix-free) acquisition vs the dense builder.

The low-rank path must score identically to the dense
(S, N, N) path — asserted here at N=512 (the criterion size) and at small N
with mixed categorical features, padding masks, and the all-null-forest
edge case. The dense path is the oracle; the reference has no large-N path
at all (src/bark/optimizer/opt_model.py:54-59 is dense).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bark_jax.benchmarks.tree_function import TreeFunction
from bark_jax.fitting.prior import sample_forest_prior
from bark_jax.fitting.sampler import BARKModel
from bark_jax.forest import create_empty_forest
from bark_jax.optimizer.acquisition import (
    build_acquisition,
    build_acquisition_lr,
    evaluate_acquisition,
)
from bark_jax.optimizer.search import propose

MAX_DEPTH = 8


def _prior_model(dom, num_samples=4, m=20, node_limit=32, seed=0) -> BARKModel:
    ft = jnp.asarray(dom.feature_types())
    bounds = jnp.asarray(dom.bounds("bitmask"))
    forest = sample_forest_prior(
        jax.random.key(seed),
        m,
        bounds,
        ft,
        num_samples=num_samples,
        node_limit=node_limit,
        max_depth=MAX_DEPTH,
    )
    noise = jnp.linspace(0.05, 0.4, num_samples, dtype=jnp.float32)
    scale = jnp.linspace(0.5, 2.0, num_samples, dtype=jnp.float32)
    return BARKModel(forest=forest, noise=noise, scale=scale)


@pytest.mark.parametrize("n", [50, 512])
def test_lr_matches_dense(n):
    bench = TreeFunction(dim=3, cat_dim=1, function_seed=2)
    dom = bench.domain
    ft = jnp.asarray(dom.feature_types())
    rng = np.random.default_rng(0)
    X = jnp.asarray(dom.sample(n, rng))
    y = jnp.asarray(rng.standard_normal(n), jnp.float32)
    model = _prior_model(dom)

    acq_d = build_acquisition(model, X, y, ft, MAX_DEPTH)
    acq_lr = build_acquisition_lr(model, X, y, ft, MAX_DEPTH)

    cands = jnp.asarray(dom.sample(256, rng))
    s_d = np.asarray(evaluate_acquisition(acq_d, cands, ft, MAX_DEPTH))
    s_lr = np.asarray(evaluate_acquisition(acq_lr, cands, ft, MAX_DEPTH))
    # the tolerance is set by the DENSE path's float32 error, not the LR
    # path's: against an f64 oracle at N=512 the dense scores are off by
    # up to 6.3e-4 while the LR scores are off by 3.3e-6 (the r x r
    # factorization is far better conditioned than the N x N one)
    np.testing.assert_allclose(s_lr, s_d, rtol=2e-3, atol=2e-3)


def test_lr_matches_dense_with_padding_mask():
    bench = TreeFunction(dim=2, function_seed=5)
    dom = bench.domain
    ft = jnp.asarray(dom.feature_types())
    rng = np.random.default_rng(1)
    n, n_pad = 40, 64
    X = dom.sample(n, rng)
    X_pad = np.vstack([X, np.tile(X[:1], (n_pad - n, 1))]).astype(np.float32)
    y_pad = np.zeros(n_pad, np.float32)
    y_pad[:n] = rng.standard_normal(n)
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0
    model = _prior_model(dom, seed=3)

    Xj, yj, mj = jnp.asarray(X_pad), jnp.asarray(y_pad), jnp.asarray(mask)
    acq_d = build_acquisition(model, Xj, yj, ft, MAX_DEPTH, train_mask=mj)
    acq_lr = build_acquisition_lr(model, Xj, yj, ft, MAX_DEPTH, train_mask=mj)
    # and the mask must reproduce the unpadded scores
    acq_cut = build_acquisition_lr(
        model, jnp.asarray(X), jnp.asarray(y_pad[:n]), ft, MAX_DEPTH
    )

    cands = jnp.asarray(dom.sample(128, rng))
    s_d = np.asarray(evaluate_acquisition(acq_d, cands, ft, MAX_DEPTH))
    s_lr = np.asarray(evaluate_acquisition(acq_lr, cands, ft, MAX_DEPTH))
    s_cut = np.asarray(evaluate_acquisition(acq_cut, cands, ft, MAX_DEPTH))
    np.testing.assert_allclose(s_lr, s_d, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s_lr, s_cut, rtol=1e-4, atol=1e-4)


def test_lr_all_null_forest():
    """Every tree a stump: mu = 0, var = scale, on both paths."""
    bench = TreeFunction(dim=2, function_seed=7)
    dom = bench.domain
    ft = jnp.asarray(dom.feature_types())
    rng = np.random.default_rng(2)
    X = jnp.asarray(dom.sample(16, rng))
    y = jnp.asarray(rng.standard_normal(16), jnp.float32)
    forest = create_empty_forest(10, 32, batch_shape=(2,))
    model = BARKModel(
        forest=forest,
        noise=jnp.asarray([0.1, 0.3], jnp.float32),
        scale=jnp.asarray([1.0, 2.0], jnp.float32),
    )
    acq_d = build_acquisition(model, X, y, ft, MAX_DEPTH)
    acq_lr = build_acquisition_lr(model, X, y, ft, MAX_DEPTH)
    cands = jnp.asarray(dom.sample(32, rng))
    s_d = np.asarray(evaluate_acquisition(acq_d, cands, ft, MAX_DEPTH))
    s_lr = np.asarray(evaluate_acquisition(acq_lr, cands, ft, MAX_DEPTH))
    np.testing.assert_allclose(s_lr, s_d, rtol=1e-5, atol=1e-5)
    # analytic value: mean over samples of -kappa * sqrt(scale)
    expect = float(np.mean(-1.96 * np.sqrt(np.array([1.0, 2.0]))))
    np.testing.assert_allclose(s_lr, expect, rtol=1e-5)


def test_propose_accepts_lr_state():
    """The full search (incl. leaf-box centering) runs on the LR state and
    lands on the same leaf box as the dense state for the same key."""
    bench = TreeFunction(dim=3, function_seed=11)
    dom = bench.domain
    ft = jnp.asarray(dom.feature_types())
    rng = np.random.default_rng(4)
    X = jnp.asarray(dom.sample(30, rng))
    y = jnp.asarray(rng.standard_normal(30), jnp.float32)
    model = _prior_model(dom, seed=9)

    acq_d = build_acquisition(model, X, y, ft, MAX_DEPTH)
    acq_lr = build_acquisition_lr(model, X, y, ft, MAX_DEPTH)
    cand_d, val_d = propose(
        jax.random.key(0), acq_d, dom, ft, num_candidates=512, num_rounds=2,
        max_depth=MAX_DEPTH, rng=np.random.default_rng(5),
    )
    cand_lr, val_lr = propose(
        jax.random.key(0), acq_lr, dom, ft, num_candidates=512, num_rounds=2,
        max_depth=MAX_DEPTH, rng=np.random.default_rng(5),
    )
    np.testing.assert_allclose(val_lr, val_d, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cand_lr, cand_d, rtol=1e-5, atol=1e-5)


def test_strategy_lowrank_ask():
    from bark_jax.fitting.params import SamplerParams
    from bark_jax.strategies.tree_kernel import TreeKernelStrategy

    bench = TreeFunction(dim=2, function_seed=13)
    dom = bench.domain
    params = SamplerParams(
        warmup_steps=10, num_samples=3, steps_per_sample=3,
        num_chains=1, num_trees=8, node_limit=32, max_depth=MAX_DEPTH,
    )
    strat = TreeKernelStrategy(
        dom, params=params, seed=0, num_candidates=256, num_rounds=1,
        acq_backend="lowrank",
    )
    rng = np.random.default_rng(6)
    X = dom.sample(12, rng)
    strat.tell(X, bench.f(X))
    cand = strat.ask()
    assert cand.shape == (1, len(dom.inputs))
    bounds = dom.bounds("ordinal")
    assert (cand[0] >= bounds[:, 0] - 1e-9).all()
    assert (cand[0] <= bounds[:, 1] + 1e-9).all()


def test_lr_blocked_build_matches_unblocked():
    """row_block accumulation of (G, u) must score identically to the
    one-shot build (counts are exact integer sums in f32; only the u
    reassociation differs), including a block size that forces padding."""
    bench = TreeFunction(dim=3, function_seed=5)
    dom = bench.domain
    rng = np.random.default_rng(2)
    N = 300  # not a multiple of the block -> exercises the zero-mask pad
    X = jnp.asarray(dom.sample(N, rng))
    y = jnp.asarray(bench.f(np.asarray(X)))
    ft = jnp.asarray(dom.feature_types())
    model = _prior_model(dom)

    base = build_acquisition_lr(model, X, y, ft, max_depth=MAX_DEPTH)
    for blk in (64, 128):
        blocked = build_acquisition_lr(
            model, X, y, ft, max_depth=MAX_DEPTH, row_block=blk
        )
        C = jnp.asarray(dom.sample(64, rng))
        s0 = evaluate_acquisition(base, C, ft, max_depth=MAX_DEPTH)
        s1 = evaluate_acquisition(blocked, C, ft, max_depth=MAX_DEPTH)
        np.testing.assert_allclose(
            np.asarray(s1), np.asarray(s0), rtol=1e-5, atol=1e-5
        )


def test_thompson_acquisition_and_strategy():
    """TS acquisition: exact leaf-space draw scores candidates by one
    function draw (deterministic per key, varying across keys), and the
    strategy's acq_backend="thompson" runs ask/tell end-to-end."""
    import jax.numpy as jnp

    from bark_jax.fitting.params import SamplerParams
    from bark_jax.optimizer.acquisition import (
        build_acquisition_ts,
        evaluate_acquisition,
    )
    from bark_jax.strategies.tree_kernel import TreeKernelStrategy

    bench = TreeFunction(dim=2, function_seed=13)
    dom = bench.domain
    rng = np.random.default_rng(3)
    X = jnp.asarray(dom.sample(30, rng))
    y = jnp.asarray(bench.f(np.asarray(X)))
    ft = jnp.asarray(dom.feature_types())
    model = _prior_model(dom, m=10)

    C = jnp.asarray(dom.sample(50, rng))
    acq1 = build_acquisition_ts(jax.random.key(0), model, X, y, ft, MAX_DEPTH)
    acq1b = build_acquisition_ts(jax.random.key(0), model, X, y, ft, MAX_DEPTH)
    acq2 = build_acquisition_ts(jax.random.key(9), model, X, y, ft, MAX_DEPTH)
    s1 = evaluate_acquisition(acq1, C, ft, max_depth=MAX_DEPTH)
    s1b = evaluate_acquisition(acq1b, C, ft, max_depth=MAX_DEPTH)
    s2 = evaluate_acquisition(acq2, C, ft, max_depth=MAX_DEPTH)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s1b))
    assert not np.allclose(np.asarray(s1), np.asarray(s2))  # a fresh draw
    assert np.isfinite(np.asarray(s1)).all()

    params = SamplerParams(
        warmup_steps=10, num_samples=3, steps_per_sample=3, num_chains=1,
        num_trees=8, node_limit=32, max_depth=MAX_DEPTH,
    )
    strat = TreeKernelStrategy(
        dom, params=params, seed=0, num_candidates=256, num_rounds=1,
        acq_backend="thompson",
    )
    Xs = dom.sample(12, np.random.default_rng(6))
    strat.tell(Xs, bench.f(Xs))
    c1, c2 = strat.ask(), strat.ask()
    bounds = dom.bounds("ordinal")
    for c in (c1, c2):
        assert c.shape == (1, len(dom.inputs))
        assert (c[0] >= bounds[:, 0] - 1e-9).all()
        assert (c[0] <= bounds[:, 1] + 1e-9).all()
