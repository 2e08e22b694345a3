"""Transition-kernel integration tests.

Central oracles:
  - the maintained kernel carry (exact-delta K for the "chol" backend,
    Woodbury inverse/logdet for "woodbury") must match a fresh dense rebuild
    from the final forest state (the reference's own validation style,
    tests/bark_fitting/test_quick_inverse.py:55-101);
  - the incrementally-updated leaf matrix must match full re-routing;
  - both kernel backends, fed the same keys, must produce identical
    trajectories (they compute the same accept ratios up to float error).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bark_jax.domain import CategoricalInput, ContinuousInput, Domain, IntegerInput
from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.sampler import (
    BARKModel,
    init_chain_state,
    run_bark_sampler,
    step,
)
from bark_jax.forest import create_empty_forest, gram_from_leaves, route_forest
from bark_jax.ops.linalg import chol_inv_logdet, kernel_matrix


def make_problem(n=25, seed=0):
    dom = Domain(
        [
            ContinuousInput("x_0", (0.0, 1.0)),
            ContinuousInput("x_1", (0.0, 1.0)),
            IntegerInput("i_0", (0, 5)),
            CategoricalInput("c_0", ("a", "b", "c", "d")),
        ]
    )
    rng = np.random.default_rng(seed)
    X = dom.sample(n, rng)
    y = rng.standard_normal((n,)).astype(np.float32)
    return dom, jnp.asarray(X), jnp.asarray(y)


@pytest.mark.parametrize("backend", ["chol", "woodbury", "rank1"])
def test_maintained_state_consistent_with_rebuild(backend):
    dom, X, y = make_problem()
    params = SamplerParams(num_trees=8, num_chains=1, kernel_backend=backend)
    bounds = jnp.asarray(dom.bounds("bitmask"))
    ft = jnp.asarray(dom.feature_types())

    forest = create_empty_forest(params.num_trees, params.node_limit)
    state = init_chain_state(
        forest, jnp.float32(0.1), jnp.float32(1.0), X, y, ft, params,
        bounds=bounds,
    )

    key = jax.random.key(0)
    for i in range(10):
        key, k = jax.random.split(key)
        state = step(k, state, X, y, bounds, ft, params)

    # incremental leaves must equal full re-routing
    leaves = route_forest(state.forest, X, ft, params.max_depth)
    np.testing.assert_array_equal(np.asarray(leaves), np.asarray(state.leaves))

    gram = gram_from_leaves(leaves, leaves, params.node_limit)
    K = kernel_matrix(gram, state.noise, state.scale)

    if backend == "chol":
        np.testing.assert_allclose(
            np.asarray(state.kern.K), np.asarray(K), rtol=1e-4, atol=1e-4
        )
    else:
        K_inv, K_logdet = chol_inv_logdet(K)
        np.testing.assert_allclose(
            np.asarray(state.kern.K_inv), np.asarray(K_inv), rtol=1e-3, atol=2e-3
        )
        np.testing.assert_allclose(
            float(state.kern.K_logdet), float(K_logdet), rtol=1e-4, atol=1e-3
        )


def test_backends_agree_on_trajectory():
    """Same keys -> same accepted moves -> identical sampled forests."""
    dom, X, y = make_problem(n=20, seed=4)
    bounds = jnp.asarray(dom.bounds("bitmask"))
    ft = jnp.asarray(dom.feature_types())

    out = {}
    for backend in ("chol", "woodbury", "rank1"):
        params = SamplerParams(
            warmup_steps=3,
            num_samples=3,
            steps_per_sample=2,
            num_chains=1,
            num_trees=6,
            kernel_backend=backend,
        )
        forest = create_empty_forest(6, params.node_limit, batch_shape=(1,))
        model = BARKModel(forest, jnp.full((1,), 0.1), jnp.ones((1,)))
        out[backend] = run_bark_sampler(
            jax.random.key(11), model, X, y, bounds, ft, params
        )

    np.testing.assert_array_equal(
        np.asarray(out["chol"].forest.threshold),
        np.asarray(out["woodbury"].forest.threshold),
    )
    np.testing.assert_allclose(
        np.asarray(out["chol"].noise), np.asarray(out["woodbury"].noise), rtol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(out["chol"].forest.threshold),
        np.asarray(out["rank1"].forest.threshold),
    )
    np.testing.assert_allclose(
        np.asarray(out["chol"].noise), np.asarray(out["rank1"].noise), rtol=1e-6
    )


def test_hot_styles_agree_on_trajectory():
    """hot_style / refresh_style / scan_style only change the lowering —
    same keys must yield identical trajectories (one-hot selects are exact;
    the onesolve MLL differs only in last-ulp association)."""
    dom, X, y = make_problem(n=20, seed=4)
    bounds = jnp.asarray(dom.bounds("bitmask"))
    ft = jnp.asarray(dom.feature_types())

    out = {}
    variants = {
        "scatter": dict(hot_style="scatter"),
        "walk_select": dict(hot_style="walk_select"),
        "select": dict(hot_style="select"),
        "select_fused": dict(hot_style="select", refresh_style="batched"),
        "doubling": dict(hot_style="doubling"),
        "doubling_fused": dict(hot_style="doubling", refresh_style="onesolve"),
        # aug scan differs only in matmul association ((V Minv) t vs
        # V (Minv t)) — statistically identical; exact equality holds at
        # these few-step x64 scales
        "aug_scan": dict(scan_style="aug"),
        # lowrank defers K^-1 updates into (P, Q) factors against the
        # frozen start-of-step inverse — same association caveat
        "lowrank_scan": dict(scan_style="lowrank"),
        # coeff runs the whole move scan in span(V0) coefficients — the
        # strongest reassociation, but still the same Woodbury math
        "coeff_scan": dict(scan_style="coeff"),
        # factor refresh carries L instead of K^-1 (inverse-free step);
        # requires the coeff scan. bf16 gram one-hots are bit-exact.
        "coeff_factor": dict(scan_style="coeff", refresh_style="factor"),
        "coeff_factor_bf16": dict(
            scan_style="coeff", refresh_style="factor", gram_dtype="bf16"
        ),
        # leaf refresh factorizes in compact leaf-indicator space (the
        # (N, N) gram is never built) — Woodbury/determinant-lemma math,
        # same trajectories at these scales
        "coeff_leaf": dict(scan_style="coeff", refresh_style="leaf"),
        # auto resolves to plain at this padded N (< 256) — must be
        # bit-identical to the reference lowering
        "auto_scan": dict(scan_style="auto"),
    }
    for name, kw in variants.items():
        params = SamplerParams(
            warmup_steps=3,
            num_samples=3,
            steps_per_sample=2,
            num_chains=2,
            num_trees=6,
            **kw,
        )
        forest = create_empty_forest(6, params.node_limit, batch_shape=(2,))
        model = BARKModel(forest, jnp.full((2,), 0.1), jnp.ones((2,)))
        out[name] = run_bark_sampler(
            jax.random.key(11), model, X, y, bounds, ft, params
        )

    ref = out["scatter"]
    for name in ("walk_select", "select", "select_fused", "doubling",
                 "doubling_fused", "aug_scan", "lowrank_scan", "coeff_scan",
                 "coeff_factor", "coeff_factor_bf16", "coeff_leaf",
                 "auto_scan"):
        np.testing.assert_array_equal(
            np.asarray(ref.forest.threshold),
            np.asarray(out[name].forest.threshold),
            err_msg=name,
        )
        np.testing.assert_array_equal(
            np.asarray(ref.forest.left), np.asarray(out[name].forest.left),
            err_msg=name,
        )
        np.testing.assert_allclose(
            np.asarray(ref.noise), np.asarray(out[name].noise), rtol=1e-6,
            err_msg=name,
        )


def test_sampler_moves_and_shapes():
    dom, X, y = make_problem(n=30, seed=1)
    params = SamplerParams(
        warmup_steps=10, num_samples=4, steps_per_sample=3, num_chains=3, num_trees=10
    )
    bounds = jnp.asarray(dom.bounds("bitmask"))
    ft = jnp.asarray(dom.feature_types())

    forest = create_empty_forest(params.num_trees, params.node_limit, batch_shape=(3,))
    model = BARKModel(forest, jnp.full((3,), 0.1), jnp.ones((3,)))
    samples = run_bark_sampler(jax.random.key(0), model, X, y, bounds, ft, params)

    assert samples.noise.shape == (3, 4)
    assert samples.scale.shape == (3, 4)
    assert samples.forest.is_leaf.shape == (3, 4, 10, params.node_limit)

    # the chains must actually move: trees grow and noise updates
    n_internal = np.asarray(
        (~samples.forest.is_leaf & samples.forest.active).sum(axis=(-1, -2))
    )
    assert (n_internal > 0).any()
    assert len(np.unique(np.asarray(samples.noise))) > 1

    # all sampled forests remain structurally valid
    active = np.asarray(samples.forest.active)
    is_leaf = np.asarray(samples.forest.is_leaf)
    n_active = active.sum(axis=-1)
    n_leaves = (active & is_leaf).sum(axis=-1)
    np.testing.assert_array_equal(n_active, 2 * n_leaves - 1)


def test_padded_run_matches_unpadded():
    """Same keys, padded data + mask vs raw data: identical samples."""
    dom, X, y = make_problem(n=18, seed=5)
    bounds = jnp.asarray(dom.bounds("bitmask"))
    ft = jnp.asarray(dom.feature_types())
    params = SamplerParams(
        warmup_steps=3, num_samples=2, steps_per_sample=2, num_chains=1, num_trees=5
    )
    forest = create_empty_forest(5, params.node_limit, batch_shape=(1,))
    model = BARKModel(forest, jnp.full((1,), 0.1), jnp.ones((1,)))

    plain = run_bark_sampler(jax.random.key(3), model, X, y, bounds, ft, params)

    pad = 14
    X_pad = jnp.concatenate([X, jnp.tile(X[:1], (pad, 1))])
    y_pad = jnp.concatenate([y, jnp.zeros((pad,), y.dtype)])
    mask = jnp.concatenate([jnp.ones(18), jnp.zeros(pad)]).astype(jnp.float32)
    padded = run_bark_sampler(
        jax.random.key(3), model, X_pad, y_pad, bounds, ft, params, mask=mask
    )

    np.testing.assert_array_equal(
        np.asarray(plain.forest.threshold), np.asarray(padded.forest.threshold)
    )
    np.testing.assert_allclose(
        np.asarray(plain.noise), np.asarray(padded.noise), rtol=1e-5
    )


def test_fixed_forest_chain_is_noise_only():
    dom, X, y = make_problem(n=15, seed=2)
    params = SamplerParams(
        warmup_steps=0, num_samples=20, steps_per_sample=1, num_chains=1, num_trees=4
    )
    bounds = jnp.asarray(dom.bounds("bitmask"))
    ft = jnp.asarray(dom.feature_types())
    forest = create_empty_forest(params.num_trees, params.node_limit, batch_shape=(1,))
    model = BARKModel(forest, jnp.full((1,), 0.1), jnp.ones((1,)))
    samples = run_bark_sampler(jax.random.key(1), model, X, y, bounds, ft, params)
    noise = np.asarray(samples.noise)
    assert np.isfinite(noise).all() and (noise > 0).all()


def test_deterministic_given_key():
    dom, X, y = make_problem(n=12, seed=3)
    params = SamplerParams(
        warmup_steps=2, num_samples=2, steps_per_sample=2, num_chains=1, num_trees=5
    )
    bounds = jnp.asarray(dom.bounds("bitmask"))
    ft = jnp.asarray(dom.feature_types())
    forest = create_empty_forest(params.num_trees, params.node_limit, batch_shape=(1,))
    model = BARKModel(forest, jnp.full((1,), 0.1), jnp.ones((1,)))
    s1 = run_bark_sampler(jax.random.key(7), model, X, y, bounds, ft, params)
    s2 = run_bark_sampler(jax.random.key(7), model, X, y, bounds, ft, params)
    np.testing.assert_array_equal(np.asarray(s1.noise), np.asarray(s2.noise))
    np.testing.assert_array_equal(
        np.asarray(s1.forest.threshold), np.asarray(s2.forest.threshold)
    )


def test_auto_scan_resolves_to_lowrank_at_large_n():
    """With a pinned dense refresh, scan_style="auto" must dispatch to the
    deferred low-rank carry once the padded N crosses the threshold (256):
    same keys => trajectories identical to an explicit scan_style="lowrank"
    run (exact in x64). (Unpinned, refresh auto resolves to "leaf" at this
    N since r5 — the dense lowrank tier is reachable only by opt-in.)"""
    dom, X, y = make_problem(n=256, seed=6)
    out = {}
    for style in ("auto", "lowrank"):
        params = SamplerParams(
            warmup_steps=2,
            num_samples=2,
            steps_per_sample=2,
            num_chains=1,
            num_trees=5,
            scan_style=style,
            refresh_style="onesolve",
        )
        forest = create_empty_forest(
            params.num_trees, params.node_limit, batch_shape=(1,)
        )
        model = BARKModel(forest, jnp.full((1,), 0.1), jnp.ones((1,)))
        out[style] = run_bark_sampler(
            jax.random.key(5),
            model,
            X,
            y,
            jnp.asarray(dom.bounds("bitmask")),
            jnp.asarray(dom.feature_types()),
            params,
        )
    np.testing.assert_array_equal(
        np.asarray(out["auto"].forest.threshold),
        np.asarray(out["lowrank"].forest.threshold),
    )
    np.testing.assert_array_equal(
        np.asarray(out["auto"].noise), np.asarray(out["lowrank"].noise)
    )


def test_leaf_refresh_padded_matches_unpadded():
    """refresh_style="leaf": padded rows must be inert (Z rows zeroed; the
    logdet/quad corrections keep accept ratios exact), like the dense path."""
    dom, X, y = make_problem(n=18, seed=5)
    bounds = jnp.asarray(dom.bounds("bitmask"))
    ft = jnp.asarray(dom.feature_types())
    params = SamplerParams(
        warmup_steps=3, num_samples=2, steps_per_sample=2, num_chains=1,
        num_trees=5, scan_style="coeff", refresh_style="leaf",
    )
    forest = create_empty_forest(5, params.node_limit, batch_shape=(1,))
    model = BARKModel(forest, jnp.full((1,), 0.1), jnp.ones((1,)))
    plain = run_bark_sampler(jax.random.key(3), model, X, y, bounds, ft, params)
    pad = 14
    X_pad = jnp.concatenate([X, jnp.tile(X[:1], (pad, 1))])
    y_pad = jnp.concatenate([y, jnp.zeros((pad,), y.dtype)])
    mask = jnp.concatenate([jnp.ones(18), jnp.zeros(pad)]).astype(jnp.float32)
    padded = run_bark_sampler(
        jax.random.key(3), model, X_pad, y_pad, bounds, ft, params, mask=mask
    )
    np.testing.assert_array_equal(
        np.asarray(plain.forest.threshold), np.asarray(padded.forest.threshold)
    )
    np.testing.assert_allclose(
        np.asarray(plain.noise), np.asarray(padded.noise), rtol=1e-5
    )


def test_leaf_refresh_capacity_guard():
    """With a leaf_budget barely above the initial leaf count, the move scan
    must MH-reject grows at capacity: total leaves never exceed the budget
    and the chain stays finite (the truncated-prior semantics, params.py)."""
    from bark_jax.fitting.traversal import terminal_mask

    dom, X, y = make_problem(n=20, seed=8)
    bounds = jnp.asarray(dom.bounds("bitmask"))
    ft = jnp.asarray(dom.feature_types())
    m = 5
    forest0 = jax.tree.map(
        lambda a: a[0], create_empty_forest(m, 32, batch_shape=(1,))
    )
    cap = m + 2  # room for exactly two grows across the whole forest
    params = SamplerParams(
        num_trees=m, node_limit=32, scan_style="coeff", refresh_style="leaf",
        leaf_budget=cap,
    )
    st = init_chain_state(
        forest0, 0.1, 1.0, X, y, ft, params, bounds=bounds
    )
    for i in range(25):
        st = step(jax.random.key(100 + i), st, X, y, bounds, ft, params)
        total = int(np.asarray(terminal_mask(st.forest).sum()))
        assert total <= cap, (i, total, cap)
        assert np.isfinite(float(st.mll))
    # the guard must not have frozen the chain entirely: some structure moved
    assert int(np.asarray(terminal_mask(st.forest).sum())) >= m


def test_auto_refresh_resolves_to_leaf_at_large_n():
    """refresh_style="auto" must dispatch to the leaf-space refresh (+coeff
    scan) once padded N >= 256 (the r5 mid-tier A/B moved the threshold
    down from 512) — same keys => trajectories identical to an explicit
    coeff+leaf run — and to the dense onesolve refresh below."""
    from bark_jax.fitting.sampler import _resolve_styles

    p = SamplerParams(num_trees=5)
    lo = _resolve_styles(p, 224)
    assert (lo.refresh_style, lo.scan_style) == ("onesolve", "plain")
    mid = _resolve_styles(p, 256)
    assert (mid.refresh_style, mid.scan_style) == ("leaf", "coeff")
    hi = _resolve_styles(p, 512)
    assert (hi.refresh_style, hi.scan_style) == ("leaf", "coeff")
    # explicit non-coeff scan pins opt OUT of the leaf resolution
    pinned = _resolve_styles(p.with_(scan_style="lowrank"), 512)
    assert (pinned.refresh_style, pinned.scan_style) == ("onesolve", "lowrank")

    dom, X, y = make_problem(n=512, seed=6)
    bounds = jnp.asarray(dom.bounds("bitmask"))
    ft = jnp.asarray(dom.feature_types())
    out = {}
    for kw in (dict(), dict(scan_style="coeff", refresh_style="leaf")):
        params = SamplerParams(
            warmup_steps=2, num_samples=2, steps_per_sample=2, num_chains=1,
            num_trees=5, **kw,
        )
        forest = create_empty_forest(5, params.node_limit, batch_shape=(1,))
        model = BARKModel(forest, jnp.full((1,), 0.1), jnp.ones((1,)))
        out[bool(kw)] = run_bark_sampler(
            jax.random.key(5), model, X, y, bounds, ft, params
        )
    np.testing.assert_array_equal(
        np.asarray(out[False].forest.threshold),
        np.asarray(out[True].forest.threshold),
    )
    np.testing.assert_array_equal(
        np.asarray(out[False].noise), np.asarray(out[True].noise)
    )


def test_leaf_refresh_tempered_matches_dense():
    """step(beta != 1) — the PT/SMC path — must produce the same tempered
    trajectory through the leaf refresh as through the dense pair refresh
    (beta scales the likelihood in both the move scan and the hyper
    accept; the leaf branch must apply it identically). Small N so f32
    association cannot flip marginal accepts — the cross-style caveat
    documented in params.py scan_style notes (at N=512 the styles match
    on noise/accept streams but mll association differs by ~1e-3
    relative, occasionally flipping a structural accept)."""
    dom, X, y = make_problem(n=20, seed=9)
    bounds = jnp.asarray(dom.bounds("bitmask"))
    ft = jnp.asarray(dom.feature_types())
    out = {}
    for kw in (dict(scan_style="plain", refresh_style="pair"),
               dict(scan_style="coeff", refresh_style="leaf")):
        params = SamplerParams(num_trees=5, **kw)
        forest = jax.tree.map(
            lambda a: a[0],
            create_empty_forest(5, params.node_limit, batch_shape=(1,)),
        )
        st = init_chain_state(forest, 0.1, 1.0, X, y, ft, params,
                              bounds=bounds)
        for i in range(8):
            st = step(jax.random.key(40 + i), st, X, y, bounds, ft, params,
                      beta=0.5)
        out[kw["refresh_style"]] = st
    np.testing.assert_array_equal(
        np.asarray(out["pair"].forest.threshold),
        np.asarray(out["leaf"].forest.threshold),
    )
    np.testing.assert_allclose(
        float(out["pair"].noise), float(out["leaf"].noise), rtol=1e-6
    )
    np.testing.assert_allclose(
        float(out["pair"].mll), float(out["leaf"].mll), rtol=1e-4
    )


def test_resolve_styles_honors_explicit_overrides():
    """Auto resolution must never override a user-pinned lowering: an
    explicit non-coeff scan_style opts out of the leaf refresh (A/B
    overrides like measure(scan_style='lowrank') must measure what they
    say — r4 code-review finding), and explicit refresh styles are
    preserved at every N."""
    from bark_jax.fitting.sampler import _resolve_styles

    # explicit scan pins at large N -> refresh auto falls back to the
    # dense factor-MLL refresh
    for scan in ("plain", "lowrank", "aug"):
        r = _resolve_styles(SamplerParams(num_trees=5, scan_style=scan), 1024)
        assert (r.scan_style, r.refresh_style) == (scan, "onesolve"), scan
    # explicit coeff still gets the leaf refresh at large N
    r = _resolve_styles(SamplerParams(num_trees=5, scan_style="coeff"), 1024)
    assert (r.scan_style, r.refresh_style) == ("coeff", "leaf")
    # explicit refresh styles survive; auto scan resolves around them
    r = _resolve_styles(
        SamplerParams(num_trees=5, refresh_style="pair"), 2048
    )
    assert (r.scan_style, r.refresh_style) == ("coeff", "pair")
    r = _resolve_styles(
        SamplerParams(num_trees=5, refresh_style="leaf"), 64
    )
    assert (r.scan_style, r.refresh_style) == ("coeff", "leaf")


def test_deep_prior_widens_auto_leaf_budget():
    """Auto leaf budgets were calibrated at the default depth prior; a
    deeper-tree prior (alpha>0.95 or beta<2) must get doubled headroom
    rather than silently truncating (r4 code-review finding)."""
    from bark_jax.fitting.sampler import _leaf_budget

    base = _leaf_budget(SamplerParams(num_trees=50), 1024)
    deep = _leaf_budget(SamplerParams(num_trees=50, alpha=0.99), 1024)
    assert base == 256 and deep == 512
    # explicit budgets always win
    assert _leaf_budget(
        SamplerParams(num_trees=50, alpha=0.99, leaf_budget=300), 1024
    ) == 300
