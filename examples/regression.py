"""Regression evaluation: NLPD / MSE / fit wall-time over resampled runs.

Parity: examples/regression/regression.py:75-124 — for each of ``num_runs``
resamples, fit the surrogate on num_train points and report NLPD, MSE, and
fit time on num_test held-out points; results to CSV.

Usage:
    python examples/regression.py -s 0 -c examples/configs/regression_treefunction.yaml \
        -m examples/configs/model_bark.yaml -o results/
"""

from __future__ import annotations

import sys
from pathlib import Path as _Path

sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))

import argparse
import csv
import logging
import time
from pathlib import Path

import numpy as np

from bark_jax.benchmarks import map_benchmark
from bark_jax.fitting.params import SamplerParams
from bark_jax.models.surrogate import BARKPriorSurrogate, BARKSurrogate
from bark_jax.utils.config import load_config
from bark_jax.utils.metrics import mse, nlpd

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
logger = logging.getLogger("regression")


def build_surrogate(model_config: dict, domain, seed: int):
    name = model_config["model"]
    model_params = dict(model_config.get("model_params", {}))
    if name == "BARK":
        keys = SamplerParams.__dataclass_fields__.keys()
        return BARKSurrogate(
            domain,
            SamplerParams(**{k: v for k, v in model_params.items() if k in keys}),
            seed=seed,
        )
    if name == "BARKPrior":
        return BARKPriorSurrogate(domain, seed=seed, **model_params)
    if name == "LeafGP":
        from bark_jax.models.leafgp import LeafGPSurrogate

        return LeafGPSurrogate(domain, seed=seed, **model_params)
    if name == "BART":
        from bark_jax.fitting.bart import BARTParams
        from bark_jax.models.bart import BARTSurrogate

        keys = BARTParams.__dataclass_fields__.keys()
        return BARTSurrogate(
            domain,
            BARTParams(**{k: v for k, v in model_params.items() if k in keys}),
            seed=seed,
        )
    raise KeyError(name)


def main(seed: int, benchmark_config: dict, model_config: dict, output: Path):
    benchmark = map_benchmark(
        benchmark_config["benchmark"],
        **benchmark_config.get("benchmark_params", {}),
    )
    domain = benchmark.domain
    num_train = benchmark_config.get("num_train", 50)
    num_test = benchmark_config.get("num_test", 200)
    num_runs = benchmark_config.get("num_runs", 20)

    rows = []
    rng = np.random.default_rng(seed)
    for run in range(num_runs):
        Xtr = domain.sample(num_train, rng)
        ytr = benchmark.f(Xtr)
        Xte = domain.sample(num_test, rng)
        yte = benchmark.f(Xte)

        surrogate = build_surrogate(model_config, domain, seed + run)
        t0 = time.perf_counter()
        surrogate.fit(Xtr, ytr)
        fit_s = time.perf_counter() - t0
        mu, std = surrogate.predict(Xte)
        row = {
            "run": run,
            "nlpd": nlpd(yte, mu, std**2),
            "mse": mse(yte, mu),
            "fit_s": fit_s,
        }
        rows.append(row)
        logger.info("run %d: nlpd=%.4f mse=%.4f fit=%.2fs", run, row["nlpd"], row["mse"], fit_s)

    output.mkdir(parents=True, exist_ok=True)
    tag = f"{benchmark_config['benchmark']}_{model_config['model']}_seed={seed}"
    with open(output / f"regression_{tag}.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    summary = {
        k: float(np.mean([r[k] for r in rows])) for k in ("nlpd", "mse", "fit_s")
    }
    logger.info("mean over %d runs: %s", num_runs, summary)
    return summary


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("-c", "--benchmark-config", type=Path, required=True)
    parser.add_argument("-m", "--model-config", type=Path, required=True)
    parser.add_argument("--platform", default=None,
                        help="force a jax platform (e.g. cpu)")
    parser.add_argument("-o", "--output", type=Path, default=Path("results"))
    args = parser.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    benchmark_config = load_config(args.benchmark_config)
    model_config = load_config(args.model_config)
    main(args.seed, benchmark_config, model_config, args.output)
