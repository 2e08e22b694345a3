"""BO study driver: the framework's CLI entry point.

Parity: examples/bayes_opt/bark_study_strategy.py:119-193 — two YAML configs
(benchmark + model), a seed, and an output directory; runs num_init random
points then num_iter ask/evaluate/tell iterations, recording per-iteration
fit/optimize wall times and the experiment trace to CSV, and re-dumping the
merged config alongside results.

Usage:
    python examples/bark_study.py -s 0 \
        -c examples/configs/benchmark_treefunction.yaml \
        -m examples/configs/model_bark.yaml -o results/
"""

from __future__ import annotations

import sys
from pathlib import Path as _Path

sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))

import argparse
import csv
import json
import logging
import time
from pathlib import Path

import numpy as np

from bark_jax.benchmarks import map_benchmark
from bark_jax.constraints import total_violation
from bark_jax.fitting.params import SamplerParams
from bark_jax.strategies.tree_kernel import make_strategy
from bark_jax.utils.compile_cache import enable_compile_cache
from bark_jax.utils.config import load_config
from bark_jax.utils.timer import BOLogger, Timer

logging.basicConfig(
    level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s %(message)s"
)
logger = logging.getLogger("bark_study")


def build_strategy(model_config: dict, domain, seed: int):
    name = model_config["model"]
    model_params = dict(model_config.get("model_params", {}))
    if name in ("BARK", "TreeKernel"):
        sampler_keys = SamplerParams.__dataclass_fields__.keys()
        sampler_kwargs = {
            k: v for k, v in model_params.items() if k in sampler_keys
        }
        strategy_kwargs = {
            k: v for k, v in model_params.items() if k not in sampler_keys
        }
        return make_strategy(
            name,
            domain,
            seed=seed,
            params=SamplerParams(**sampler_kwargs),
            **strategy_kwargs,
        )
    return make_strategy(name, domain, seed=seed, **model_params)


def main(seed: int, benchmark_config: dict, model_config: dict, output: Path):
    benchmark = map_benchmark(
        benchmark_config["benchmark"],
        **benchmark_config.get("benchmark_params", {}),
    )
    domain = benchmark.domain

    num_init = benchmark_config.get("num_init", min(30, 2 * domain.dim))
    num_iter = benchmark_config.get("num_iter", 100)

    logger.info(
        "Benchmark: %s | Model: %s | seed=%d",
        benchmark_config["benchmark"], model_config["model"], seed,
    )
    rng = np.random.default_rng(seed)
    X = domain.sample(num_init, rng)
    y = benchmark.f(X)
    logger.info("Sampled %d initial points; best=%.4f", num_init, y.min())

    strategy = build_strategy(model_config, domain, seed)
    bo_log = BOLogger()

    timer = Timer()
    with timer("fit"):
        strategy.tell(X, y)

    viols = []
    for itr in range(num_iter):
        with timer("optimize"):
            candidate = strategy.ask(1)
        y_new = benchmark.f(candidate)
        with timer("fit"):
            strategy.add(candidate, y_new)
        bo_log.log_iteration(candidate[0], y_new[0], timer)
        viol = total_violation(
            domain.constraints, candidate.astype(np.float64), domain.input_keys
        )[0]
        viols.append(float(viol))
        logger.info(
            "iter %d: y=%.4f best=%.4f viol=%.3g fit=%.2fs opt=%.2fs",
            itr, y_new[0], bo_log.best[-1], viol,
            timer.get("fit", 0), timer.get("optimize", 0),
        )
        timer = Timer()

    output.mkdir(parents=True, exist_ok=True)
    tag = f"{benchmark_config['benchmark']}_{model_config['model']}_seed={seed}"
    with open(output / f"experiments_{tag}.csv", "w", newline="") as f:
        keys = domain.input_keys
        writer = csv.writer(f)
        writer.writerow([*keys, "y", "best", "viol", "fit_s", "optimize_s"])
        for row, cand, v in zip(bo_log.as_rows(), bo_log.candidates, viols):
            writer.writerow(
                [*cand, row["y"], row["best"], v, row.get("fit", 0.0),
                 row.get("optimize", 0.0)]
            )
    merged = {
        "seed": seed,
        "benchmark_config": benchmark_config,
        "model_config": model_config,
        "best": bo_log.best[-1] if bo_log.best else float(y.min()),
        "feasible_proposal_rate": (
            float(np.mean([v <= 1e-6 for v in viols])) if viols else 1.0
        ),
    }
    # JSON is valid YAML: the merged record stays readable as a config
    with open(output / f"config_{tag}.yaml", "w") as f:
        json.dump(merged, f, indent=1)
    logger.info("Done. Final best: %.4f", merged["best"])
    return merged


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("-c", "--benchmark-config", type=Path, required=True)
    parser.add_argument("-m", "--model-config", type=Path, required=True)
    parser.add_argument("-o", "--output", type=Path, default=Path("results"))
    parser.add_argument(
        "--platform",
        default=None,
        help="force a jax platform (e.g. cpu)",
    )
    args = parser.parse_args()

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()

    benchmark_config = load_config(args.benchmark_config)
    model_config = load_config(args.model_config)
    main(args.seed, benchmark_config, model_config, args.output)
