"""MCMC diagnostics: record per-sample MLL traces + convergence stats.

Parity: examples/mcmc/mcmc_record_mll.py:57-74 (MLL trace recording) plus
the R-hat/ESS diagnostics SURVEY.md §4 prescribes for the new framework.
Saves ``mlls.npy`` of shape (chains, samples) and prints a summary.

Usage:
    python examples/mcmc_record_mll.py -s 0 \
        -c examples/configs/mcmc_benchmark.yaml -m examples/configs/mcmc_model.yaml -o results/
"""

from __future__ import annotations

import sys
from pathlib import Path as _Path

sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))

import argparse
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.benchmarks import map_benchmark
from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.sampler import BARKModel, run_bark_sampler_with_trace
from bark_jax.forest import create_empty_forest
from bark_jax.utils.config import load_config
from bark_jax.utils.diagnostics import mll_trace_summary

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
logger = logging.getLogger("mcmc")


def main(seed: int, benchmark_config: dict, model_config: dict, output: Path):
    benchmark = map_benchmark(
        benchmark_config["benchmark"],
        **benchmark_config.get("benchmark_params", {}),
    )
    domain = benchmark.domain
    num_train = benchmark_config.get("num_train", 50)

    rng = np.random.default_rng(seed)
    X = domain.sample(num_train, rng)
    y = benchmark.f(X)
    y_std = (y - y.mean()) / max(y.std(), 1e-6)

    keys = SamplerParams.__dataclass_fields__.keys()
    params = SamplerParams(
        **{
            k: v
            for k, v in model_config.get("model_params", {}).items()
            if k in keys
        }
    )
    forest = create_empty_forest(
        params.num_trees, params.node_limit, batch_shape=(params.num_chains,)
    )
    model = BARKModel(
        forest,
        jnp.full((params.num_chains,), 0.1, jnp.float32),
        jnp.ones((params.num_chains,), jnp.float32),
    )
    samples, mlls = run_bark_sampler_with_trace(
        jax.random.key(seed),
        model,
        jnp.asarray(X),
        jnp.asarray(y_std, jnp.float32),
        jnp.asarray(domain.bounds("bitmask")),
        jnp.asarray(domain.feature_types()),
        params,
    )
    mlls = np.asarray(mlls)
    summary = mll_trace_summary(mlls)
    logger.info("MLL trace summary: %s", summary)

    output.mkdir(parents=True, exist_ok=True)
    np.save(output / "mlls.npy", mlls)
    np.save(output / "noise_samples.npy", np.asarray(samples.noise))
    logger.info("Saved traces to %s", output)
    return summary


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("-c", "--benchmark-config", type=Path, required=True)
    parser.add_argument("-m", "--model-config", type=Path, required=True)
    parser.add_argument("-o", "--output", type=Path, default=Path("results"))
    args = parser.parse_args()
    benchmark_config = load_config(args.benchmark_config)
    model_config = load_config(args.model_config)
    main(args.seed, benchmark_config, model_config, args.output)
