"""Posterior-budget ablation: held-out NLPD over a chains x samples grid.

Parity: examples/regression/regression_samples_ablation.py:70-86 — sweep the
number of MCMC chains and retained posterior samples and record mean NLPD on
held-out points (the reference saves ``nlpd_seed=...npy`` per cell; here one
``(len(chains), len(samples))`` grid per seed). On the accelerator every
cell's chains run vmapped in one program, so large-chain cells cost the same wall time as
small ones — the ablation that motivated the reference's default budget is
nearly free here.

Usage:
    python examples/regression_samples_ablation.py -s 0 \
        -c examples/configs/regression_treefunction.yaml -o results/ \
        --chains 1 2 4 8 --samples 2 5 10 20
"""

from __future__ import annotations

import sys
from pathlib import Path as _Path

sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))

import argparse
import logging
from pathlib import Path

import numpy as np

from bark_jax.benchmarks import map_benchmark
from bark_jax.fitting.params import SamplerParams
from bark_jax.models.surrogate import BARKSurrogate
from bark_jax.utils.config import load_config
from bark_jax.utils.metrics import nlpd

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
logger = logging.getLogger("samples_ablation")


def main(seed, benchmark_config, output, chain_grid, sample_grid, num_runs):
    benchmark = map_benchmark(
        benchmark_config["benchmark"],
        **benchmark_config.get("benchmark_params", {}),
    )
    domain = benchmark.domain
    num_train = benchmark_config.get("num_train", 50)
    num_test = benchmark_config.get("num_test", 200)

    grid = np.zeros((len(chain_grid), len(sample_grid)))
    rng = np.random.default_rng(seed)
    for run in range(num_runs):
        Xtr = domain.sample(num_train, rng)
        ytr = benchmark.f(Xtr)
        Xte = domain.sample(num_test, rng)
        yte = benchmark.f(Xte)
        for i, num_chains in enumerate(chain_grid):
            for j, num_samples in enumerate(sample_grid):
                params = SamplerParams(
                    num_chains=num_chains, num_samples=num_samples
                )
                surrogate = BARKSurrogate(domain, params, seed=seed + run)
                surrogate.fit(Xtr, ytr)
                mu, std = surrogate.predict(Xte)
                val = nlpd(yte, mu, std**2)
                grid[i, j] += val / num_runs
                logger.info(
                    "run %d chains=%d samples=%d nlpd=%.4f",
                    run, num_chains, num_samples, val,
                )

    output.mkdir(parents=True, exist_ok=True)
    tag = f"{benchmark_config['benchmark']}_seed={seed}"
    np.save(output / f"nlpd_ablation_{tag}.npy", grid)
    logger.info("grid (chains x samples):\n%s", np.array_str(grid, precision=3))
    return grid


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("-c", "--benchmark-config", type=Path, required=True)
    parser.add_argument("-o", "--output", type=Path, default=Path("results"))
    parser.add_argument("--chains", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--samples", type=int, nargs="+", default=[2, 5, 10])
    parser.add_argument("--num-runs", type=int, default=5)
    args = parser.parse_args()
    benchmark_config = load_config(args.benchmark_config)
    main(args.seed, benchmark_config, args.output, args.chains, args.samples,
         args.num_runs)
