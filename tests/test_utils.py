"""Checkpoint, diagnostics, timer, and plotting utilities tests."""

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.benchmarks import map_benchmark
from bark_jax.fitting.params import SamplerParams
from bark_jax.models.surrogate import BARKSurrogate
from bark_jax.utils.checkpoint import (
    load_model,
    load_surrogate,
    save_model,
    save_surrogate,
)
from bark_jax.utils.diagnostics import (
    effective_sample_size,
    gelman_rubin,
    mll_trace_summary,
)
from bark_jax.utils.timer import BOLogger, Timer


def _fitted(tmp_seed=0):
    bench = map_benchmark("TreeFunction", dim=2, m=6, function_seed=1)
    rng = np.random.default_rng(tmp_seed)
    X = bench.domain.sample(15, rng)
    y = bench.f(X)
    params = SamplerParams(
        warmup_steps=5, num_samples=2, steps_per_sample=2, num_trees=6
    )
    return bench, BARKSurrogate(bench.domain, params, seed=0).fit(X, y), X, y


def test_model_checkpoint_roundtrip(tmp_path):
    _, sur, _, _ = _fitted()
    path = tmp_path / "model.npz"
    key = jax.random.key(42)
    save_model(path, sur.model, key=key, note=1.5)
    model, key2, extra = load_model(path)
    np.testing.assert_array_equal(
        np.asarray(model.forest.threshold), np.asarray(sur.model.forest.threshold)
    )
    np.testing.assert_array_equal(np.asarray(model.noise), np.asarray(sur.model.noise))
    assert float(extra["note"]) == 1.5
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(key2)), np.asarray(jax.random.key_data(key))
    )


def test_surrogate_checkpoint_resume(tmp_path):
    bench, sur, X, y = _fitted()
    Xte = bench.domain.sample(5, np.random.default_rng(9))
    mu_before, std_before = sur.predict(Xte)

    path = tmp_path / "surrogate.npz"
    save_surrogate(path, sur)

    fresh = BARKSurrogate(bench.domain, sur.params, seed=0)
    load_surrogate(path, fresh)
    mu_after, std_after = fresh.predict(Xte)
    np.testing.assert_allclose(mu_before, mu_after, rtol=1e-5)
    np.testing.assert_allclose(std_before, std_after, rtol=1e-5)

    # resumed surrogate can continue fitting (warm start)
    fresh.fit(X, y)
    assert fresh.is_fitted


def test_bart_surrogate_checkpoint_resume(tmp_path):
    from bark_jax.fitting.bart import BARTParams
    from bark_jax.models.bart import BARTSurrogate
    from bark_jax.utils.checkpoint import (
        load_bart_surrogate,
        save_bart_surrogate,
    )

    bench = map_benchmark("TreeFunction", dim=2, m=6, function_seed=1)
    rng = np.random.default_rng(0)
    X = bench.domain.sample(15, rng)
    y = bench.f(X)
    params = BARTParams(
        warmup_steps=10, num_samples=4, num_trees=6, node_limit=16
    )
    sur = BARTSurrogate(bench.domain, params, seed=0).fit(X, y)
    Xte = bench.domain.sample(5, np.random.default_rng(9))
    mu_before, std_before = sur.predict(Xte)

    path = tmp_path / "bart.npz"
    save_bart_surrogate(path, sur)
    fresh = BARTSurrogate(bench.domain, params, seed=0)
    load_bart_surrogate(path, fresh)
    mu_after, std_after = fresh.predict(Xte)
    np.testing.assert_allclose(mu_before, mu_after, rtol=1e-6)
    np.testing.assert_allclose(std_before, std_after, rtol=1e-6)

    # resumed surrogate warm-starts its next fit from the restored chains
    fresh.fit(X, y)
    assert fresh.is_fitted


def test_gelman_rubin_detects_disagreement():
    rng = np.random.default_rng(0)
    same = rng.normal(size=(4, 200))
    apart = same + np.arange(4)[:, None] * 5.0
    assert abs(gelman_rubin(same) - 1.0) < 0.1
    assert gelman_rubin(apart) > 2.0


def test_ess_detects_autocorrelation():
    rng = np.random.default_rng(1)
    iid = rng.normal(size=(2, 500))
    walk = np.cumsum(rng.normal(size=(2, 500)), axis=1) * 0.3 + iid * 0.05
    assert effective_sample_size(iid) > 0.5 * 1000
    assert effective_sample_size(walk) < 200
    s = mll_trace_summary(iid)
    assert set(s) == {"final_mean", "max", "r_hat", "ess"}


def test_timer_and_bologger():
    t = Timer()
    with t("fit"):
        sum(range(1000))
    with t("fit"):
        sum(range(1000))
    assert t["fit"] > 0

    log = BOLogger()
    log.log_iteration(np.array([0.1]), 2.0, t)
    log.log_iteration(np.array([0.2]), 1.0, t)
    log.log_iteration(np.array([0.3]), 3.0, t)
    assert log.best == [2.0, 1.0, 1.0]
    rows = list(log.as_rows())
    assert rows[2]["best"] == 1.0 and "fit" in rows[0]


def test_plots_render(tmp_path):
    import matplotlib.pyplot as plt

    from bark_jax.utils.plots import (
        plot_bo_trace,
        plot_covariance,
        plot_forest_depths,
        plot_gp_1d,
        plot_mll_trace,
        save_fig,
    )

    _, sur, _, _ = _fitted()
    fig, axes = plt.subplots(1, 5, figsize=(20, 3))
    x = np.linspace(0, 1, 30)
    plot_gp_1d(axes[0], x, np.sin(x), 0.1 + 0 * x)
    plot_covariance(axes[1], np.eye(5))
    plot_bo_trace(axes[2], [3, 2, 2.5, 1], label="bark")
    plot_mll_trace(axes[3], np.random.default_rng(0).normal(size=(2, 20)))
    plot_forest_depths(axes[4], sur.model.forest)
    out = tmp_path / "plots.png"
    save_fig(fig, out)
    assert out.exists() and out.stat().st_size > 1000


def test_profiling_hooks(tmp_path):
    """Device trace capture + annotations + throughput meter (SURVEY §5
    tracing/profiling replacement)."""
    from bark_jax.utils.profiling import ThroughputMeter, annotate, trace

    x = jnp.arange(1024.0)
    with trace(str(tmp_path / "trace")):
        with annotate("square"):
            y = jax.jit(lambda a: a * a)(x)
        jax.block_until_ready(y)
    produced = list((tmp_path / "trace").rglob("*"))
    assert any(p.is_file() for p in produced)

    meter = ThroughputMeter()
    meter.start()
    out = jax.jit(lambda a: a + 1)(x)
    rate = meter.stop(1024, out)
    assert rate > 0 and meter.rate > 0


def test_tree_rendering(tmp_path):
    """format_tree / plot_tree walk active nodes of a sampled forest
    (working replacement for the reference's stale plot_trees.py)."""
    import matplotlib.pyplot as plt

    from bark_jax.utils.plots import format_tree, plot_tree, save_fig

    _, sur, _, _ = _fitted()
    forest = jax.tree.map(lambda a: np.asarray(a)[0, -1], sur.model.forest)
    n_active = np.asarray(forest.active).sum(axis=-1)
    tree_idx = int(np.argmax(n_active))  # pick the bushiest tree
    text = format_tree(forest, tree_idx, feature_names=None)
    assert text.count("leaf[") == int(
        (np.asarray(forest.active) & np.asarray(forest.is_leaf))[tree_idx].sum()
    )
    fig, ax = plt.subplots()
    plot_tree(ax, forest, tree_idx)
    out = tmp_path / "tree.png"
    save_fig(fig, out)
    assert out.exists() and out.stat().st_size > 1000
