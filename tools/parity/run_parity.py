"""Statistical-parity harness: run the REFERENCE sampler and bark_jax on
identical data and compare posterior moments + predictive quality.

Reference side: /root/reference/src/bark/fitting/bark_sampler.py:120-213
(_run_bark_sampler_multichain, executed pure-Python via tools/parity/
numba_shim) + the forest_predict math of tree_kernels/tree_gps.py:80-113.
bark_jax side: bark_jax.fitting.sampler.run_bark_sampler +
bark_jax.models.gp.forest_predict.

Both samplers use their own (different) RNGs, so parity is statistical
(SURVEY.md §7.1.8): per-chain means are compared through their Monte-Carlo
standard errors (|Δ| / sqrt(se_a² + se_b²) ≤ Z).

Usage:  python tools/parity/run_parity.py [--fast] [--out PARITY_RESULTS.md]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")  # before any device use (CLAUDE.md)

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from tools.parity import numba_shim  # noqa: E402

REPO = Path(__file__).resolve().parents[2]


def make_workload(name: str, n_train: int, n_test: int, seed: int):
    """Shared (X, y) from bark_jax's benchmark layer; y standardized once."""
    from bark_jax.benchmarks import map_benchmark

    if name == "tree_function":
        bench = map_benchmark("TreeFunction", dim=5, m=20, function_seed=7)
    elif name == "mixed_cat":
        bench = map_benchmark(
            "TreeFunction", dim=2, cat_dim=2, num_cat=4, m=20, function_seed=7
        )
    else:
        raise KeyError(name)
    rng = np.random.default_rng(seed)
    X = bench.domain.sample(n_train + n_test, rng).astype(np.float64)
    y = bench.f(X).astype(np.float64)
    mu, sd = y[:n_train].mean(), max(y[:n_train].std(), 1e-6)
    y = (y - mu) / sd
    return (
        bench.domain,
        X[:n_train],
        y[:n_train],
        X[n_train:],
        y[n_train:],
    )


# --- reference side --------------------------------------------------------


def run_reference(domain, X, y, X_test, params_dict, seed):
    numba_shim.install()
    from bark.fitting.bark_sampler import (
        BARKTrainParamsNumba,
        _run_bark_sampler_multichain,
    )
    from bark.forest import NODE_RECORD_DTYPE, batched_forest_gram_matrix

    def create_empty_forest(m, node_limit=100):
        # forest.py:114-117 assigns parent=-1 into uint32, which Numba wraps
        # to 2**32-1 but plain numpy>=2 rejects; reproduce the wrapped value
        forest = np.zeros((m, node_limit), dtype=NODE_RECORD_DTYPE)
        forest[:, 0] = (1, 0, 0, 0, 0, np.iinfo(np.uint32).max, 0, 1)
        return forest

    np.random.seed(seed)
    m = params_dict["num_trees"]
    chains = params_dict["num_chains"]
    w = params_dict["grow_prune_weight"]
    pw = np.array([w, w, params_dict["change_weight"]], np.float64)
    pw /= pw.sum()
    ref_params = BARKTrainParamsNumba(
        warmup_steps=params_dict["warmup_steps"],
        num_samples=params_dict["num_samples"],
        steps_per_sample=params_dict["steps_per_sample"],
        num_chains=chains,
        alpha=params_dict["alpha"],
        beta=params_dict["beta"],
        proposal_weights=pw,
        verbose=False,
        use_softplus_transform=True,
        sample_scale=False,
        gamma_prior_shape=params_dict["gamma_prior_shape"],
        gamma_prior_rate=params_dict["gamma_prior_rate"],
    )
    forest = np.tile(create_empty_forest(m), (chains, 1, 1, 1))[:, 0]
    noise = np.full((chains,), 0.1)
    scale = np.ones((chains,))
    bounds = np.asarray(domain.bounds("bitmask"), np.float64)
    feat_types = np.asarray(domain.feature_types(), np.int64)

    t0 = time.perf_counter()
    nodes, noises, scales = _run_bark_sampler_multichain(
        forest, noise, scale, X, y.reshape(-1, 1), bounds, feat_types, ref_params
    )
    wall = time.perf_counter() - t0

    # predictive (tree_gps.py:97-113 math, plain gram, dense inverse)
    flat_nodes = nodes.reshape(-1, *nodes.shape[-2:])
    flat_noise = noises.reshape(-1)
    flat_scale = scales.reshape(-1)
    K = flat_scale[:, None, None] * batched_forest_gram_matrix(
        flat_nodes, X, X, feat_types
    )
    K += (1e-6 + flat_noise[:, None, None]) * np.eye(X.shape[0])
    K_inv = np.linalg.inv(K)
    K_xX = flat_scale[:, None, None] * batched_forest_gram_matrix(
        flat_nodes, X_test, X, feat_types
    )
    mu_s = (K_xX @ K_inv @ y.reshape(-1, 1))[..., 0]
    var_s = flat_scale[:, None] - np.einsum(
        "sij,sjk,sik->si", K_xX, K_inv, K_xX
    )
    var_s = np.maximum(var_s, 1e-12) + flat_noise[:, None]

    stats = {
        "noise_mean": noises.mean(axis=1),  # per chain
        "leaves_per_tree": _leaves_per_tree_ref(nodes),
        "leaf_depth_mean": _leaf_depth_moments(
            nodes["is_leaf"], nodes["active"], nodes["depth"]
        )[0],
        "leaf_depth_var": _leaf_depth_moments(
            nodes["is_leaf"], nodes["active"], nodes["depth"]
        )[1],
        "wall_s": wall,
    }
    return stats, mu_s, var_s, noises


def _leaves_per_tree_ref(nodes):
    # (chains, samples, m, node_limit) structured -> mean active leaves/tree
    is_leaf = nodes["is_leaf"].astype(np.float64)
    active = nodes["active"].astype(np.float64)
    per_tree = (is_leaf * active).sum(axis=-1)  # (chains, samples, m)
    return per_tree.mean(axis=(1, 2))  # per chain


def _leaf_depth_moments(is_leaf, active, depth):
    """Posterior depth-distribution moments per chain: mean and variance of
    active-leaf depth (weights every leaf equally across samples/trees)."""
    w = (np.asarray(is_leaf, np.float64) * np.asarray(active, np.float64))
    d = np.asarray(depth, np.float64)
    axes = tuple(range(1, w.ndim))  # all but the chain axis
    total = w.sum(axis=axes)
    mean = (w * d).sum(axis=axes) / total
    shape = (-1,) + (1,) * (w.ndim - 1)
    var = (w * (d - mean.reshape(shape)) ** 2).sum(axis=axes) / total
    return mean, var


# --- bark_jax side ---------------------------------------------------------


def run_bark_jax(domain, X, y, X_test, params_dict, seed):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bark_jax.fitting.params import SamplerParams
    from bark_jax.fitting.sampler import BARKModel, run_bark_sampler
    from bark_jax.forest import create_empty_forest
    from bark_jax.models.gp import forest_predict

    params = SamplerParams(
        warmup_steps=params_dict["warmup_steps"],
        num_samples=params_dict["num_samples"],
        steps_per_sample=params_dict["steps_per_sample"],
        num_chains=params_dict["num_chains"],
        alpha=params_dict["alpha"],
        beta=params_dict["beta"],
        num_trees=params_dict["num_trees"],
        gamma_prior_shape=params_dict["gamma_prior_shape"],
        gamma_prior_rate=params_dict["gamma_prior_rate"],
        grow_prune_weight=params_dict["grow_prune_weight"],
        change_weight=params_dict["change_weight"],
        # like-for-like kernel comparison: reproduce the reference's
        # (incorrect) softplus Hastings ratio here — the shipped default is
        # the corrected Jacobian-only form (params.q_ratio_style notes,
        # results/diagnostics/qratio_bug.md)
        q_ratio_style="reference",
    )
    chains = params.num_chains
    forest = create_empty_forest(
        params.num_trees, params.node_limit, batch_shape=(chains,)
    )
    model = BARKModel(
        forest,
        jnp.full((chains,), 0.1, jnp.float32),
        jnp.ones((chains,), jnp.float32),
    )
    Xj = jnp.asarray(X, jnp.float32)
    yj = jnp.asarray(y, jnp.float32)
    t0 = time.perf_counter()
    samples = run_bark_sampler(
        jax.random.key(seed),
        model,
        Xj,
        yj,
        jnp.asarray(domain.bounds("bitmask")),
        jnp.asarray(domain.feature_types()),
        params,
    )
    samples = jax.block_until_ready(samples)
    wall = time.perf_counter() - t0

    mu_s, var_s = forest_predict(
        samples.forest,
        samples.noise,
        samples.scale,
        Xj,
        yj,
        jnp.asarray(X_test, jnp.float32),
        jnp.asarray(domain.feature_types()),
        params.max_depth,
    )
    noise_flat = np.asarray(samples.noise).reshape(-1)
    mu_s = np.asarray(mu_s, np.float64)
    var_s = np.asarray(var_s, np.float64) + noise_flat[:, None]

    is_leaf = np.asarray(samples.forest.is_leaf, np.float64)
    active = np.asarray(samples.forest.active, np.float64)
    per_tree = (is_leaf * active).sum(axis=-1)
    depth_mean, depth_var = _leaf_depth_moments(
        is_leaf, active, np.asarray(samples.forest.depth)
    )
    stats = {
        "noise_mean": np.asarray(samples.noise).mean(axis=1),
        "leaves_per_tree": per_tree.mean(axis=(1, 2)),
        "leaf_depth_mean": depth_mean,
        "leaf_depth_var": depth_var,
        "wall_s": wall,
    }
    return stats, mu_s, var_s, np.asarray(samples.noise)


# --- comparison ------------------------------------------------------------


def mog_nlpd_mse(mu_s, var_s, y_test):
    """Moment-matched MoG predictive NLPD and MSE (metrics.py semantics)."""
    mu = mu_s.mean(axis=0)
    var = (var_s + mu_s**2).mean(axis=0) - mu**2
    nlpd = 0.5 * np.mean(
        np.log(2 * np.pi * var) + (y_test - mu) ** 2 / var
    )
    mse = np.mean((y_test - mu) ** 2)
    return float(nlpd), float(mse)


def chain_summary(values):
    values = np.asarray(values, np.float64)
    se = values.std(ddof=1) / np.sqrt(len(values)) if len(values) > 1 else 0.0
    return float(values.mean()), float(se)


def compare(name, ref, ours, z=4.0):
    """z-score of the difference of chain-mean estimates."""
    (m_a, se_a), (m_b, se_b) = ref, ours
    denom = np.sqrt(se_a**2 + se_b**2) + 1e-12
    zval = abs(m_a - m_b) / denom
    return {
        "metric": name,
        "reference": m_a,
        "reference_se": se_a,
        "bark_jax": m_b,
        "bark_jax_se": se_b,
        "z": float(zval),
        "pass": bool(zval <= z),
    }


def run_workload(name, n_train, n_test, params_dict, seed=0):
    domain, X, y, X_test, y_test = make_workload(name, n_train, n_test, seed)
    print(f"[{name}] running reference sampler (pure Python)...", flush=True)
    ref_stats, ref_mu, ref_var, _ = run_reference(
        domain, X, y, X_test, params_dict, seed
    )
    print(
        f"[{name}] reference done in {ref_stats['wall_s']:.1f}s; "
        "running bark_jax...",
        flush=True,
    )
    our_stats, our_mu, our_var, _ = run_bark_jax(
        domain, X, y, X_test, params_dict, seed
    )
    print(f"[{name}] bark_jax done in {our_stats['wall_s']:.1f}s", flush=True)

    rows = [
        compare(
            "posterior noise mean",
            chain_summary(ref_stats["noise_mean"]),
            chain_summary(our_stats["noise_mean"]),
        ),
        compare(
            "leaves per tree",
            chain_summary(ref_stats["leaves_per_tree"]),
            chain_summary(our_stats["leaves_per_tree"]),
        ),
        compare(
            "leaf depth mean",
            chain_summary(ref_stats["leaf_depth_mean"]),
            chain_summary(our_stats["leaf_depth_mean"]),
        ),
        compare(
            "leaf depth variance",
            chain_summary(ref_stats["leaf_depth_var"]),
            chain_summary(our_stats["leaf_depth_var"]),
        ),
    ]
    # predictive quality: compare point values (shared test set); NLPD/MSE
    # have no per-chain decomposition here, so use a relative tolerance
    ref_nlpd, ref_mse = mog_nlpd_mse(ref_mu, ref_var, y_test)
    our_nlpd, our_mse = mog_nlpd_mse(our_mu, our_var, y_test)
    rows.append(
        {
            "metric": "test NLPD",
            "reference": ref_nlpd,
            "bark_jax": our_nlpd,
            "pass": bool(abs(ref_nlpd - our_nlpd) <= 0.35),
        }
    )
    rows.append(
        {
            "metric": "test MSE",
            "reference": ref_mse,
            "bark_jax": our_mse,
            "pass": bool(
                abs(ref_mse - our_mse) <= 0.5 * max(ref_mse, our_mse, 0.05)
            ),
        }
    )
    rows.append(
        {
            "metric": "fit wall seconds",
            "reference": ref_stats["wall_s"],
            "bark_jax": our_stats["wall_s"],
            "pass": True,
        }
    )
    return rows


def run_workload_replay(name, n_train, n_test, params_dict, cached_rows, seed=0):
    """Re-run ONLY the bark_jax side and z-test against cached reference
    summaries: catches bark_jax statistical regressions at
    paper power without the ~260 s shimmed-reference run. ``cached_rows``
    must come from a ``run_workload`` invocation with the same workload,
    seed, and params (the committed cache: results/parity_r3/
    parity_paper.json); the reference chain means and their MC standard
    errors are read from it, the fresh bark_jax chains supply the other
    side of the two-sample z-test. Statistically valid because the two
    sides are independent runs either way."""
    domain, X, y, X_test, y_test = make_workload(name, n_train, n_test, seed)
    our_stats, our_mu, our_var, _ = run_bark_jax(
        domain, X, y, X_test, params_dict, seed
    )
    cached = {r["metric"]: r for r in cached_rows}

    def ref_summary(metric):
        r = cached[metric]
        return (r["reference"], r["reference_se"])

    rows = [
        compare(
            "posterior noise mean",
            ref_summary("posterior noise mean"),
            chain_summary(our_stats["noise_mean"]),
        ),
        compare(
            "leaves per tree",
            ref_summary("leaves per tree"),
            chain_summary(our_stats["leaves_per_tree"]),
        ),
        compare(
            "leaf depth mean",
            ref_summary("leaf depth mean"),
            chain_summary(our_stats["leaf_depth_mean"]),
        ),
        compare(
            "leaf depth variance",
            ref_summary("leaf depth variance"),
            chain_summary(our_stats["leaf_depth_var"]),
        ),
    ]
    ref_nlpd = cached["test NLPD"]["reference"]
    ref_mse = cached["test MSE"]["reference"]
    our_nlpd, our_mse = mog_nlpd_mse(our_mu, our_var, y_test)
    rows.append(
        {
            "metric": "test NLPD",
            "reference": ref_nlpd,
            "bark_jax": our_nlpd,
            "pass": bool(abs(ref_nlpd - our_nlpd) <= 0.35),
        }
    )
    rows.append(
        {
            "metric": "test MSE",
            "reference": ref_mse,
            "bark_jax": our_mse,
            "pass": bool(
                abs(ref_mse - our_mse) <= 0.5 * max(ref_mse, our_mse, 0.05)
            ),
        }
    )
    return rows


DEFAULT_PARAMS = dict(
    warmup_steps=100,
    num_samples=40,
    steps_per_sample=5,
    num_chains=8,
    alpha=0.95,
    beta=2.0,
    num_trees=20,
    gamma_prior_shape=1.5,
    gamma_prior_rate=5.0,
    grow_prune_weight=0.5,
    change_weight=1.0,
)

FAST_PARAMS = {**DEFAULT_PARAMS, "warmup_steps": 30, "num_samples": 10, "num_chains": 4}

# the reference's own example-study budget (examples/bayes_opt/
# example_model_config.yaml:2-8) at the reference surrogate's default
# m=50 trees (data_models/surrogates/bark.py:25) — the z-test's power
# scales with the budget, so this is the high-power evidence tier
#.
PAPER_PARAMS = {
    **DEFAULT_PARAMS,
    "warmup_steps": 1000,
    "num_samples": 4,
    "steps_per_sample": 50,
    "num_chains": 4,
    "num_trees": 50,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument(
        "--paper",
        action="store_true",
        help="reference example-config budget: 1000 warmup + 4x50, 4 chains, m=50",
    )
    ap.add_argument(
        "--replay",
        default=None,
        metavar="CACHE_JSON",
        help="re-run ONLY the bark_jax side and z-test against the cached "
        "reference summaries in CACHE_JSON (e.g. results/parity_r3/"
        "parity_paper.json); prints one JSON line, exit 1 on failure. "
        "Run from a fresh process — the x64 test-suite config changes "
        "f32 trajectories (CLAUDE.md).",
    )
    ap.add_argument("--out", default=str(REPO / "PARITY_RESULTS.md"))
    ap.add_argument("--json", default=str(REPO / "parity_results.json"))
    args = ap.parse_args()

    if args.replay:
        cache = json.loads(Path(args.replay).read_text())
        replay_results = {}
        ok = True
        for wl in cache["results"]:
            rows = run_workload_replay(
                wl, 50, 20, cache["params"], cache["results"][wl], seed=0
            )
            replay_results[wl] = rows
            ok = ok and all(r["pass"] for r in rows)
        print(json.dumps({"pass": ok, "results": replay_results}))
        raise SystemExit(0 if ok else 1)

    params = (
        PAPER_PARAMS if args.paper else FAST_PARAMS if args.fast else DEFAULT_PARAMS
    )

    results = {}
    for wl, n_train, n_test in (
        ("tree_function", 50, 20),
        ("mixed_cat", 50, 20),
    ):
        results[wl] = run_workload(wl, n_train, n_test, params)

    Path(args.json).write_text(json.dumps({"params": params, "results": results}, indent=1))

    lines = [
        "# PARITY_RESULTS — reference (pure-Python Numba source) vs bark_jax",
        "",
        "Generated by `python tools/parity/run_parity.py`"
        + (" --fast" if args.fast else "")
        + ". The REFERENCE sampler "
        "(`/root/reference/src/bark/fitting/bark_sampler.py:120-213`) was "
        "executed un-compiled via `tools/parity/numba_shim.py` (identical "
        "arithmetic — numba only compiles the same numpy code) on data "
        "generated from bark_jax's TreeFunction benchmarks; bark_jax ran the "
        "same protocol. RNG streams differ by construction (np.random vs "
        "jax.random, SURVEY §7.1.8), so the comparison is statistical: "
        "chain-mean estimates within z ≤ 4 combined MC standard errors; "
        "NLPD/MSE within fixed tolerances on a shared held-out set.",
        "",
        f"MCMC budget: {params['warmup_steps']} warmup + "
        f"{params['num_samples']}×{params['steps_per_sample']} steps, "
        f"{params['num_chains']} chains, m={params['num_trees']} trees.",
        "",
    ]
    all_pass = True
    for wl, rows in results.items():
        lines.append(f"## {wl}")
        lines.append("")
        lines.append("| metric | reference | bark_jax | z | pass |")
        lines.append("|---|---|---|---|---|")
        for r in rows:
            z = f"{r['z']:.2f}" if "z" in r else "—"
            ref = (
                f"{r['reference']:.4f} ± {r['reference_se']:.4f}"
                if "reference_se" in r
                else f"{r['reference']:.4f}"
            )
            ours = (
                f"{r['bark_jax']:.4f} ± {r['bark_jax_se']:.4f}"
                if "bark_jax_se" in r
                else f"{r['bark_jax']:.4f}"
            )
            lines.append(
                f"| {r['metric']} | {ref} | {ours} | {z} | "
                f"{'✓' if r['pass'] else '✗'} |"
            )
            all_pass &= r["pass"]
        lines.append("")
    lines.append(f"**Overall: {'PASS' if all_pass else 'FAIL'}**")
    Path(args.out).write_text("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0 if all_pass else 1


if __name__ == "__main__":
    sys.exit(main())
