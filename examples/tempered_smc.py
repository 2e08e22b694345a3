"""Parallel tempering + SMC driver over a BARK posterior.

Entry point for the two population samplers (SURVEY §2.4 new
capabilities; the reference has nothing comparable — its chains are a
serial Numba loop): a geometric-ladder parallel-tempering run reporting
swap rates and the cold chain's posterior, and an adaptive-tempering SMC
run reporting the tempering schedule and log-evidence. ``--sharded`` runs
both over a device mesh (one replica per device via ppermute swaps;
particles sharded with collective resampling) — identical schedules to
the on-chip versions, tested in tests/parallel/test_sharded_pt_smc.py.

Usage:
    python examples/tempered_smc.py -s 0 --platform cpu
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/tempered_smc.py --platform cpu --sharded
"""

from __future__ import annotations

import sys
from pathlib import Path as _Path

sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))

import argparse
import json
import logging

import numpy as np

logger = logging.getLogger("tempered_smc")


def main(seed: int, sharded: bool, num_replicas: int, num_steps: int,
         num_particles: int, out: str | None):
    import jax
    import jax.numpy as jnp

    from bark_jax.benchmarks import map_benchmark
    from bark_jax.fitting.params import SamplerParams
    from bark_jax.forest import create_empty_forest

    bench = map_benchmark("TreeFunction", dim=3, m=20, function_seed=1)
    rng = np.random.default_rng(seed)
    X = bench.domain.sample(40, rng)
    y = bench.f(X)
    y = (y - y.mean()) / y.std()
    Xj, yj = jnp.asarray(X), jnp.asarray(y, jnp.float32)
    bounds = jnp.asarray(bench.domain.bounds("bitmask"))
    ft = jnp.asarray(bench.domain.feature_types())
    params = SamplerParams(num_trees=20)

    result = {"seed": seed, "sharded": sharded}

    # --- parallel tempering ------------------------------------------------
    if sharded:
        from jax.sharding import Mesh

        from bark_jax.parallel.tempering import run_parallel_tempering_sharded

        n_dev = min(num_replicas, len(jax.devices()))
        mesh = Mesh(np.array(jax.devices()[:n_dev]), ("replicas",))
        forest = create_empty_forest(
            params.num_trees, params.node_limit, batch_shape=(n_dev,)
        )
        samples, swap_rate = run_parallel_tempering_sharded(
            jax.random.key(seed), forest,
            jnp.full((n_dev,), 0.1, jnp.float32),
            jnp.ones((n_dev,), jnp.float32),
            Xj, yj, bounds, ft, params, mesh, num_steps=num_steps,
        )
        result["pt"] = {
            "replicas": n_dev,
            "swap_rate": float(np.mean(np.asarray(swap_rate))),
            "cold_noise_mean": float(np.mean(np.asarray(samples.noise))),
        }
    else:
        from bark_jax.parallel.tempering import run_parallel_tempering

        forest = create_empty_forest(
            params.num_trees, params.node_limit, batch_shape=(num_replicas,)
        )
        samples, beta_trace, swap_rate, cold_mlls = run_parallel_tempering(
            jax.random.key(seed), forest,
            jnp.full((num_replicas,), 0.1, jnp.float32),
            jnp.ones((num_replicas,), jnp.float32),
            Xj, yj, bounds, ft, params,
            num_replicas=num_replicas, num_steps=num_steps,
        )
        result["pt"] = {
            "replicas": num_replicas,
            "swap_rate": float(np.mean(np.asarray(swap_rate))),
            "cold_noise_mean": float(np.mean(np.asarray(samples.noise))),
        }
    logger.info("PT: %s", result["pt"])

    # --- SMC ----------------------------------------------------------------
    if sharded:
        from jax.sharding import Mesh

        from bark_jax.parallel.smc import run_smc_sharded

        mesh = Mesh(np.array(jax.devices()), ("particles",))
        smc = run_smc_sharded(
            jax.random.key(seed + 1), Xj, yj, bounds, ft, params, mesh,
            num_particles=num_particles,
        )
    else:
        from bark_jax.parallel.smc import run_smc

        smc = run_smc(
            jax.random.key(seed + 1), Xj, yj, bounds, ft, params,
            num_particles=num_particles,
        )
    betas = np.asarray(smc.betas)
    result["smc"] = {
        "particles": num_particles,
        "log_evidence": float(np.asarray(smc.log_evidence)),
        "final_beta": float(betas[-1]),
        "tempering_rounds": int(np.sum(betas < 1.0)),
        "posterior_noise_mean": float(np.mean(np.asarray(smc.model.noise))),
        "final_ess": float(np.asarray(smc.ess_trace)[-1]),
    }
    logger.info("SMC: %s", result["smc"])

    print(json.dumps(result))
    if out:
        with open(out, "w") as fh:
            json.dump(result, fh, indent=1)
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("--sharded", action="store_true")
    parser.add_argument("--num-replicas", type=int, default=8)
    parser.add_argument("--num-steps", type=int, default=200)
    parser.add_argument("--num-particles", type=int, default=64)
    parser.add_argument("--platform", default=None)
    parser.add_argument("-o", "--out", default=None)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    main(args.seed, args.sharded, args.num_replicas, args.num_steps,
         args.num_particles, args.out)
