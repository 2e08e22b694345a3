"""Stationarity-tier leaf-vs-dense statistical parity at N = 512.

The shipped N >= 512 leaf default's only
committed statistical artifact was a FAILING z-test taken in a config
that never converges (noiseless TreeFunction at N=512 is metastable:
results/ab_r4/leaf_numerics.md finding 3), so the default rested on
per-step identities alone. This tool builds the well-conditioned variant
that DOES converge — observation noise sized so the realized noise
posterior sits near 0.1, where the landscape is fast-mixing and
leaf_numerics finding 2 already shows one-step kernel identity —
and adjudicates the two lowerings at stationarity:

  - 32 chains per arm, OVERDISPERSED inits (half start at noise 1.0,
    half at 0.01 — all-identical inits make R-hat vacuous);
  - warmup run in chunks of <= 250 steps per sampler call (one 8000-step
    scan program crashed the device worker once; chunking keeps programs
    small and warm-startable);
  - convergence PROVEN per arm before any comparison: split-R-hat and
    Geyer ESS on the noise and MLL sample traces;
  - z-tests between arms on chain-mean posterior moments (noise,
    leaves/tree, leaf depth mean/var), chain means as the independent
    units.

Writes results/ab_r5/leaf_selfparity_stationary.json — the artifact that
supersedes the failing rows in results/ab_r4/leaf_selfparity.json as the
headline evidence for the leaf default. Run on a QUIET host (though this
is a statistical, not a timing, measurement).

Posterior law parity anchor: src/bark/fitting/bark_sampler.py:216-284.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

OUT = (
    pathlib.Path(__file__).resolve().parent.parent
    / "results" / "ab_r5" / "leaf_selfparity_stationary.json"
)

N = 512
M = 50
CHAINS = 32  # overridden by --chains
NOISE_FRAC = 0.10  # target noise share of standardized variance


def make_data(seed=0):
    from bark_jax.benchmarks.tree_function import TreeFunction

    bench = TreeFunction(dim=5, cat_dim=0, num_cat=5, m=50, function_seed=1)
    rng = np.random.default_rng(seed)
    X = bench.domain.sample(N, rng)
    f = bench.f(X)
    # observation noise sized for a NOISE_FRAC share of total variance:
    # after standardization the true noise variance is ~NOISE_FRAC, which
    # puts the posterior in the fast-mixing nu ~ 0.1 regime
    sigma = np.sqrt(bench.f(X).var() * NOISE_FRAC / (1 - NOISE_FRAC))
    y = f + rng.normal(0.0, sigma, f.shape)
    y = (y - y.mean()) / y.std()
    return (
        jnp.asarray(X),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(bench.domain.bounds("bitmask")),
        jnp.asarray(bench.domain.feature_types()),
    )


def run_arm(tag, sampler_kw, key, warmup, samples, thin, chunk=250):
    from bark_jax.fitting.params import SamplerParams
    from bark_jax.fitting.sampler import (
        BARKModel,
        run_bark_sampler,
        run_bark_sampler_with_trace,
    )
    from bark_jax.forest import create_empty_forest

    X, y, bounds, ft = make_data()
    base = SamplerParams(num_chains=CHAINS, num_trees=M, **sampler_kw)
    forest = create_empty_forest(M, base.node_limit, batch_shape=(CHAINS,))
    # overdispersed noise inits: half the chains hot, half cold
    noise0 = jnp.where(
        jnp.arange(CHAINS) % 2 == 0, 1.0, 0.01
    ).astype(jnp.float32)
    model = BARKModel(forest, noise0, jnp.ones((CHAINS,), jnp.float32))

    t0 = time.perf_counter()
    done = 0
    while done < warmup:
        step_n = min(chunk, warmup - done)
        key, k = jax.random.split(key)
        p = base.with_(
            warmup_steps=0, num_samples=1, steps_per_sample=step_n
        )
        out = run_bark_sampler(k, model, X, y, bounds, ft, p)
        model = BARKModel(
            forest=jax.tree.map(lambda a: a[:, -1], out.forest),
            noise=out.noise[:, -1],
            scale=out.scale[:, -1],
        )
        jax.block_until_ready(model.noise)
        done += step_n
        if done % 1000 < step_n:
            # transit visibility: the chain-mean noise trajectory says
            # whether the warmup budget actually reached stationarity
            print(
                f"[{tag}] warmup {done}/{warmup} "
                f"noise={float(jnp.mean(model.noise)):.4f}",
                flush=True,
            )

    # sampling phase, ALSO chunked (a single 600-step chol-arm program
    # crashed the worker just like the r4 8000-step probe)
    out_chunks, mll_chunks = [], []
    got = 0
    while got < samples:
        s_n = min(max(chunk // thin, 1), samples - got)
        key, k = jax.random.split(key)
        p = base.with_(warmup_steps=0, num_samples=s_n, steps_per_sample=thin)
        out, mlls = run_bark_sampler_with_trace(
            k, model, X, y, bounds, ft, p
        )
        model = BARKModel(
            forest=jax.tree.map(lambda a: a[:, -1], out.forest),
            noise=out.noise[:, -1],
            scale=out.scale[:, -1],
        )
        jax.block_until_ready(model.noise)
        out_chunks.append(out)
        mll_chunks.append(np.asarray(mlls))
        got += s_n
        print(f"[{tag}] samples {got}/{samples}", flush=True)
    wall = time.perf_counter() - t0
    forest_all = jax.tree.map(
        lambda *a: np.concatenate([np.asarray(x) for x in a], axis=1),
        *[c.forest for c in out_chunks],
    )
    noise = np.concatenate(
        [np.asarray(c.noise, np.float64) for c in out_chunks], axis=1
    )
    mlls = np.concatenate(mll_chunks, axis=1)

    tmask = np.asarray(forest_all.is_leaf & forest_all.active)
    depth = np.asarray(forest_all.depth)
    leaves_per_tree = tmask.sum(axis=-1).mean(axis=-1)  # (chains, samples)
    dsum = (depth * tmask).sum(axis=(-2, -1))
    dcount = tmask.sum(axis=(-2, -1))
    depth_mean = dsum / dcount

    from bark_jax.utils.diagnostics import (
        effective_sample_size,
        gelman_rubin,
    )

    stats = {
        "noise_mean": noise.mean(axis=1),
        "leaves_per_tree": leaves_per_tree.mean(axis=1),
        "leaf_depth_mean": depth_mean.mean(axis=1),
    }
    diag = {
        "r_hat_noise": gelman_rubin(noise),
        "ess_noise": effective_sample_size(noise),
        "r_hat_mll": gelman_rubin(np.asarray(mlls, np.float64)),
        "ess_mll": effective_sample_size(np.asarray(mlls, np.float64)),
        "wall_s": round(wall, 1),
        "noise_posterior_mean": float(noise.mean()),
    }
    return stats, diag


def main():
    global CHAINS
    ap = argparse.ArgumentParser()
    ap.add_argument("--warmup", type=int, default=6000)
    ap.add_argument("--samples", type=int, default=150)
    ap.add_argument("--thin", type=int, default=4)
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=250,
                    help="steps per sampler call (the r4 worker crash was "
                         "one oversized scan program; the chol arm needs "
                         "small chunks)")
    ap.add_argument("--arms", default="leaf,dense,chol",
                    help="comma list from {leaf,dense,chol}")
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    CHAINS = args.chains

    all_arms = {
        # the shipped default at this N resolves to leaf+coeff
        "leaf": dict(),
        # dense rank1 comparator, explicitly pinned (the opt-in tier).
        # NOTE its scan seeds ride the onesolve-built explicit K^-1,
        # which can carry ~cond^2*eps error (~0.6 nats at nu~0.1, N=512,
        # scaling from leaf_numerics finding 1) — a small correlated
        # per-step MH bias is EXPECTED in this arm on an accelerator.
        "dense": dict(scan_style="lowrank", refresh_style="onesolve"),
        # the drift-free oracle: exact-delta K + per-move Cholesky,
        # factor-form MLLs, NO explicit inverse anywhere. Slow, but the
        # decisive comparator for the leaf default's stationary law.
        "chol": dict(kernel_backend="chol"),
    }
    arms = {t: all_arms[t] for t in args.arms.split(",")}
    results, diags = {}, {}
    for i, (tag, kw) in enumerate(arms.items()):
        results[tag], diags[tag] = run_arm(
            tag, kw, jax.random.key(100 + i), args.warmup, args.samples,
            args.thin, chunk=args.chunk,
        )
        print(tag, json.dumps(diags[tag]), flush=True)

    rows = []
    baselines = [t for t in ("chol", "dense") if t in results]
    if "leaf" not in results:
        baselines = []
    for metric in results.get("leaf", {}):
        for base in baselines:
            a, b = results[base][metric], results["leaf"][metric]
            ma, sa = a.mean(), a.std(ddof=1) / np.sqrt(len(a))
            mb, sb = b.mean(), b.std(ddof=1) / np.sqrt(len(b))
            z = abs(ma - mb) / np.sqrt(sa**2 + sb**2 + 1e-300)
            rows.append({
                "metric": metric, "baseline": base,
                base: float(ma), f"{base}_se": float(sa),
                "leaf": float(mb), "leaf_se": float(sb),
                "z": float(z),
                # the oracle comparison is the gate; the dense rank1 arm
                # is informational (its own arithmetic is the suspect)
                "pass": bool(z < 3.0) if base == "chol" else None,
            })
            print(json.dumps(rows[-1]), flush=True)

    payload = {
        "config": {
            "benchmark": "TreeFunction(dim=5, m=50, seed=1) + observation "
                         f"noise at {NOISE_FRAC} variance share, N={N}",
            "chains": CHAINS,
            "warmup": args.warmup, "samples": args.samples,
            "thin": args.thin,
            "init": "overdispersed noise: alternating 1.0 / 0.01",
            "backend": jax.default_backend(),
        },
        "convergence": diags,
        "rows": rows,
        "supersedes": "results/ab_r4/leaf_selfparity.json (transit-regime "
                      "diagnostic; see leaf_numerics.md finding 3)",
    }
    out = pathlib.Path(args.out) if args.out else OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=1))
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
