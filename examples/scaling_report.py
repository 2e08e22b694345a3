"""Chain-scaling report over a device mesh.

Two measurements, both runnable on a virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8) or real GPUs:

1. **Weak scaling** — sampler throughput (full MCMC steps/s) at 1, 2, 4, ...
   devices with a fixed per-device chain count, efficiency vs the
   single-device rate. This is the BASELINE.md >=80% multi-host target —
   but it is only *meaningful on real chips*: on a virtual CPU mesh every
   "device" shares the host's physical cores, so weak-scaling efficiency
   collapses to core contention (a 2-core host cannot run 8 devices' worth
   of compute 8x faster). The numbers are still recorded for provenance.

2. **Sharding overhead** (fixed total chains) — the same total chain count
   run unsharded on 1 device vs shard_mapped over n devices. The sampler
   step has zero cross-chip communication (chains are embarrassingly
   parallel; only diagnostics psum), so on real hardware weak scaling is
   bounded by this overhead, which *is* honestly measurable on a virtual
   mesh: same FLOPs, same cores, only the SPMD partitioning differs.

Usage:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/scaling_report.py --platform cpu --out SCALING.json
"""

from __future__ import annotations

import sys
from pathlib import Path as _Path

sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))

import argparse
import json
import os
import time

import jax


def _setup(platform: str | None, n_train: int = 50):
    if platform:
        jax.config.update("jax_platforms", platform)

    import jax.numpy as jnp
    import numpy as np

    from bark_jax.benchmarks import map_benchmark

    bench = map_benchmark("TreeFunction", dim=5, m=50, function_seed=1)
    rng = np.random.default_rng(0)
    X = bench.domain.sample(n_train, rng)
    y = bench.f(X)
    y = (y - y.mean()) / y.std()
    Xj, yj = jnp.asarray(X), jnp.asarray(y, jnp.float32)
    bounds = jnp.asarray(bench.domain.bounds("bitmask"))
    ft = jnp.asarray(bench.domain.feature_types())
    return Xj, yj, bounds, ft


def _rate(num_chains: int, n_dev: int, num_steps: int, data) -> float:
    """steps/s of a (num_chains)-chain run over an n_dev-device mesh."""
    import jax.numpy as jnp

    from bark_jax.fitting.params import SamplerParams
    from bark_jax.fitting.sampler import BARKModel
    from bark_jax.forest import create_empty_forest
    from bark_jax.parallel.sharding import (
        chain_mesh,
        shard_model,
        sharded_run_sampler,
    )

    Xj, yj, bounds, ft = data
    params = SamplerParams(
        warmup_steps=0, num_samples=num_steps, steps_per_sample=1, num_trees=50
    )
    mesh = chain_mesh(n_dev)
    forest = create_empty_forest(
        params.num_trees, params.node_limit, batch_shape=(num_chains,)
    )
    model = shard_model(
        BARKModel(
            forest,
            jnp.full((num_chains,), 0.1, jnp.float32),
            jnp.ones((num_chains,), jnp.float32),
        ),
        mesh,
    )
    out = sharded_run_sampler(
        jax.random.key(0), model, Xj, yj, bounds, ft, params, mesh
    )
    jax.block_until_ready(out)  # compile + warm
    t0 = time.perf_counter()
    out = sharded_run_sampler(
        jax.random.key(1), model, Xj, yj, bounds, ft, params, mesh
    )
    jax.block_until_ready(out)
    return num_chains * num_steps / (time.perf_counter() - t0)


def weak_scaling(chains_per_device: int, num_steps: int, data) -> list[dict]:
    n_avail = len(jax.devices())
    results = []
    base_rate = None
    for n_dev in (d for d in (1, 2, 4, 8, 16, 32) if d <= n_avail):
        rate = _rate(chains_per_device * n_dev, n_dev, num_steps, data)
        if base_rate is None:
            base_rate = rate
        results.append(
            {
                "devices": n_dev,
                "chains": chains_per_device * n_dev,
                "steps_per_s": round(rate, 1),
                "efficiency": round(rate / (base_rate * n_dev), 3),
            }
        )
        print("weak:", json.dumps(results[-1]))
    return results


def sharding_overhead(total_chains: int, num_steps: int, data) -> list[dict]:
    n_avail = len(jax.devices())
    results = []
    base_rate = None
    for n_dev in (d for d in (1, 2, 4, 8) if d <= min(n_avail, total_chains)):
        rate = _rate(total_chains, n_dev, num_steps, data)
        if base_rate is None:
            base_rate = rate
        results.append(
            {
                "devices": n_dev,
                "chains": total_chains,
                "steps_per_s": round(rate, 1),
                "vs_unsharded": round(rate / base_rate, 3),
            }
        )
        print("fixed:", json.dumps(results[-1]))
    return results


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--platform", default=None)
    parser.add_argument("--chains-per-device", type=int, default=8)
    parser.add_argument("--total-chains", type=int, default=16)
    parser.add_argument("--num-steps", type=int, default=20)
    parser.add_argument(
        "--n-train", type=int, default=50,
        help="training-set size; >= 256 exercises the leaf-tier lowering "
             "under sharding",
    )
    parser.add_argument("--out", default=None, help="write results JSON here")
    parser.add_argument(
        "--note", default="", help="free-text provenance note stored in --out"
    )
    parser.add_argument(
        "--distributed",
        action="store_true",
        help="initialize jax.distributed from env (multi-host runs)",
    )
    args = parser.parse_args()
    if args.distributed:
        from bark_jax.parallel.distributed import initialize_distributed

        initialize_distributed()
    data = _setup(args.platform, args.n_train)
    weak = weak_scaling(args.chains_per_device, args.num_steps, data)
    fixed = sharding_overhead(args.total_chains, args.num_steps, data)
    if args.out:
        payload = {
            "note": args.note,
            "platform": args.platform or "default",
            "host_cores": os.cpu_count(),
            "devices": len(jax.devices()),
            "num_steps": args.num_steps,
            "n_train": args.n_train,
            "weak_scaling": {
                "chains_per_device": args.chains_per_device,
                "caveat": (
                    "virtual CPU devices share host cores; weak-scaling "
                    "efficiency on this host measures core contention, not "
                    "chip scaling — see sharding_overhead for the "
                    "hardware-independent component"
                ),
                "results": weak,
            },
            "sharding_overhead": {
                "total_chains": args.total_chains,
                "meaning": (
                    "same total work unsharded vs shard_mapped over n "
                    "devices; the sampler step has no cross-chip "
                    "communication, so real-chip weak-scaling efficiency "
                    "is bounded below by vs_unsharded"
                ),
                "results": fixed,
            },
        }
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
