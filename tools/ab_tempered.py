"""Tempered vs plain chains on the metastable N=512 landscape.

The r4 investigation proved the noiseless N=512
TreeFunction posterior is metastable (fresh chains still descending
after 2000 warmup steps; chains started low escape to noise ~ 1 —
results/ab_r4/leaf_numerics.md finding 3) and nothing in the repo
attacked it. This records the evidence for the fix that now ships as
``BARKSurrogate(fit_style="tempered")``:

  - equal-chip-work arms: 32 plain chains vs 4 PT ladders x 8 replicas
    (32 step computations per round either way);
  - per-arm traces: cold-chain MLL and noise every round;
  - metrics: wall time, best/mean MLL trajectory, rounds-to-MLL-target
    (the first round each chain's MLL beats a fixed threshold), split
    R-hat + ESS of the second-half noise trace, and the swap rate.

Writes results/ab_r5/tempered_n512.json. Run on a QUIET host — the
wall-clock comparison is part of the result.
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
    / "results" / "ab_r5" / "tempered_n512.json"
)

N = 512
M = 50
PLAIN_CHAINS = 32
LADDERS = 4
REPLICAS = 8


def make_data(seed=0):
    from bark_jax.benchmarks.tree_function import TreeFunction

    bench = TreeFunction(dim=5, cat_dim=0, num_cat=5, m=50, function_seed=1)
    rng = np.random.default_rng(seed)
    X = bench.domain.sample(N, rng)
    y = bench.f(X)
    y = (y - y.mean()) / y.std()  # noiseless: the metastable regime
    return (
        jnp.asarray(X),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(bench.domain.bounds("bitmask")),
        jnp.asarray(bench.domain.feature_types()),
    )


def run_plain(key, rounds, chunk=250):
    from bark_jax.fitting.params import SamplerParams
    from bark_jax.fitting.sampler import BARKModel, run_bark_sampler_with_trace
    from bark_jax.forest import create_empty_forest

    X, y, bounds, ft = make_data()
    params = SamplerParams(num_chains=PLAIN_CHAINS, num_trees=M)
    forest = create_empty_forest(
        M, params.node_limit, batch_shape=(PLAIN_CHAINS,)
    )
    model = BARKModel(
        forest,
        jnp.full((PLAIN_CHAINS,), 0.1, jnp.float32),
        jnp.ones((PLAIN_CHAINS,), jnp.float32),
    )
    mll_trace, noise_trace = [], []
    t0 = time.perf_counter()
    done = 0
    while done < rounds:
        step_n = min(chunk, rounds - done)
        key, k = jax.random.split(key)
        p = params.with_(warmup_steps=0, num_samples=step_n, steps_per_sample=1)
        out, mlls = run_bark_sampler_with_trace(
            k, model, X, y, bounds, ft, p
        )
        model = BARKModel(
            forest=jax.tree.map(lambda a: a[:, -1], out.forest),
            noise=out.noise[:, -1],
            scale=out.scale[:, -1],
        )
        jax.block_until_ready(model.noise)
        mll_trace.append(np.asarray(mlls))
        noise_trace.append(np.asarray(out.noise))
        done += step_n
        print(f"[plain] {done}/{rounds}", flush=True)
    wall = time.perf_counter() - t0
    return (
        np.concatenate(mll_trace, axis=1),  # (chains, rounds)
        np.concatenate(noise_trace, axis=1),
        wall,
        None,
    )


def run_tempered(key, rounds, chunk=250):
    from bark_jax.fitting.params import SamplerParams
    from bark_jax.fitting.sampler import BARKModel  # noqa: F401
    from bark_jax.forest import create_empty_forest
    from bark_jax.parallel.tempering import run_parallel_tempering

    X, y, bounds, ft = make_data()
    params = SamplerParams(num_chains=1, num_trees=M)

    # one fresh ladder per chunk would lose the state; run the full
    # horizon in one call per ladder batch (the PT scan carries state
    # internally; `rounds` here is bounded, and each round is one step +
    # two swap phases, so the program stays ~chunk-sized in memory).
    def one(k):
        forest = create_empty_forest(M, params.node_limit, batch_shape=(REPLICAS,))
        samples, _, swap_rate, cold_mlls = run_parallel_tempering(
            k,
            forest,
            jnp.full((REPLICAS,), 0.1, jnp.float32),
            jnp.ones((REPLICAS,), jnp.float32),
            X, y, bounds, ft, params,
            num_replicas=REPLICAS, num_steps=rounds,
        )
        return samples.noise, cold_mlls, swap_rate

    t0 = time.perf_counter()
    keys = jax.random.split(key, LADDERS)
    noise, mlls, swap_rate = jax.vmap(one)(keys)
    jax.block_until_ready(noise)
    wall = time.perf_counter() - t0
    return (
        np.asarray(mlls),  # (ladders, rounds)
        np.asarray(noise),
        wall,
        float(np.mean(np.asarray(swap_rate))),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2000)
    args = ap.parse_args()

    from bark_jax.utils.diagnostics import (
        effective_sample_size,
        gelman_rubin,
    )

    mll_p, noise_p, wall_p, _ = run_plain(jax.random.key(0), args.rounds)
    print(f"plain done in {wall_p:.0f}s", flush=True)
    mll_t, noise_t, wall_t, swap = run_tempered(jax.random.key(1), args.rounds)
    print(f"tempered done in {wall_t:.0f}s swap={swap:.2f}", flush=True)

    half = args.rounds // 2
    # rounds-to-target: first round each chain's MLL beats the pooled
    # median of final MLLs (a landscape-level "reached the good basin"
    # threshold shared by both arms)
    target = float(
        np.median(np.concatenate([mll_p[:, -1], mll_t[:, -1]]))
    ) - 50.0

    def rounds_to(mlls):
        hit = mlls >= target
        first = np.where(
            hit.any(axis=1), hit.argmax(axis=1), -1
        )
        return {
            "target_mll": target,
            "frac_chains_reached": float((first >= 0).mean()),
            "median_rounds_to_target": float(
                np.median(first[first >= 0]) if (first >= 0).any() else -1
            ),
        }

    def diag(noise):
        x = np.asarray(noise, np.float64)[:, half:]
        return {
            "r_hat_noise": float(gelman_rubin(x)),
            "ess_noise": float(effective_sample_size(x)),
            "noise_mean_2nd_half": float(x.mean()),
            "noise_sd_2nd_half": float(x.std()),
        }

    payload = {
        "config": {
            "problem": f"noiseless TreeFunction N={N} m={M} (metastable, "
                       "leaf_numerics.md finding 3)",
            "rounds": args.rounds,
            "plain_chains": PLAIN_CHAINS,
            "ladders": LADDERS, "replicas": REPLICAS,
            "equal_chip_work": "32 step computations per round both arms",
        },
        "plain": {
            "wall_s": round(wall_p, 1),
            **diag(noise_p),
            **rounds_to(mll_p),
            "mll_mean_final": float(mll_p[:, -1].mean()),
            "mll_best": float(mll_p.max()),
        },
        "tempered": {
            "wall_s": round(wall_t, 1),
            **diag(noise_t),
            **rounds_to(mll_t),
            "mll_mean_final": float(mll_t[:, -1].mean()),
            "mll_best": float(mll_t.max()),
            "swap_rate": swap,
        },
    }
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(payload, indent=1))
    print(json.dumps(payload), flush=True)


if __name__ == "__main__":
    main()
