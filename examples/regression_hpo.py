"""Prior-hyperparameter grid search: NLPD over an alpha x beta grid.

Parity: examples/regression/regression_hpo.py:83-110 — fix one train/test
resample, fit a BARK surrogate for every (alpha, beta) combination of the
depth prior p(split at depth d) = alpha * (1 + d)^-beta, and record the
held-out NLPD grid to ``.npy``.

Usage:
    python examples/regression_hpo.py -s 0 \
        -c examples/configs/regression_treefunction.yaml -o results/ \
        --alpha 0.45 0.65 0.85 0.95 --beta 0.5 1.0 2.0
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
logger = logging.getLogger("regression_hpo")


def main(seed, benchmark_config, alphas, betas, output: Path, model_params=None):
    benchmark = map_benchmark(
        benchmark_config["benchmark"],
        **benchmark_config.get("benchmark_params", {}),
    )
    domain = benchmark.domain
    rng = np.random.default_rng(seed)
    Xtr = domain.sample(benchmark_config.get("num_train", 50), rng)
    ytr = benchmark.f(Xtr)
    Xte = domain.sample(benchmark_config.get("num_test", 200), rng)
    yte = benchmark.f(Xte)

    model_params = dict(model_params or {})
    keys = SamplerParams.__dataclass_fields__.keys()
    nlpd_arr = np.zeros((len(alphas), len(betas)))
    for i, alpha in enumerate(alphas):
        for j, beta in enumerate(betas):
            params = SamplerParams(
                **{k: v for k, v in model_params.items() if k in keys}
                | {"alpha": float(alpha), "beta": float(beta)}
            )
            surrogate = BARKSurrogate(domain, params, seed=seed)
            surrogate.fit(Xtr, ytr)
            mu, std = surrogate.predict(Xte)
            nlpd_arr[i, j] = nlpd(yte, mu, std**2)
            logger.info(
                "alpha=%.3g beta=%.3g nlpd=%.4f", alpha, beta, nlpd_arr[i, j]
            )

    output.mkdir(parents=True, exist_ok=True)
    tag = f"{benchmark_config['benchmark']}_seed={seed}"
    np.save(output / f"nlpd_hpo_{tag}.npy", nlpd_arr)
    logger.info("grid saved: %s", output / f"nlpd_hpo_{tag}.npy")
    return nlpd_arr


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("-c", "--benchmark-config", type=Path, required=True)
    parser.add_argument("-o", "--output", type=Path, default=Path("results"))
    parser.add_argument("--alpha", type=float, nargs="+",
                        default=[0.45, 0.65, 0.85, 0.95])
    parser.add_argument("--beta", type=float, nargs="+",
                        default=[0.5, 1.0, 2.0])
    args = parser.parse_args()
    benchmark_config = load_config(args.benchmark_config)
    main(args.seed, benchmark_config, args.alpha, args.beta, args.output)
