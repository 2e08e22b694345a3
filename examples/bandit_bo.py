"""Discrete-candidate bandit BO driver.

Parity: examples/bayes_opt/bandit_bo.py:87-148 — a UCB bandit loop over a
fixed discrete candidate set (the MAX-phase materials table): fit the BARK
surrogate on observed candidates, score every remaining candidate with the
batched posterior, pick the best LCB, observe, repeat.

Usage:
    python examples/bandit_bo.py -s 0 -n 20 -o results/
"""

from __future__ import annotations

import sys
from pathlib import Path as _Path

sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))

import argparse
import csv
import logging
from pathlib import Path

import numpy as np

from bark_jax.benchmarks import map_benchmark
from bark_jax.fitting.params import SamplerParams
from bark_jax.models.surrogate import BARKSurrogate

logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
logger = logging.getLogger("bandit")


def main(seed: int, num_iter: int, output: Path, num_init: int = 10, kappa: float = 1.96):
    bench = map_benchmark("MAXBandit")
    candidates = bench.candidates.astype(np.float32)
    targets = bench.targets
    n = len(candidates)

    rng = np.random.default_rng(seed)
    observed = list(rng.choice(n, size=num_init, replace=False))
    params = SamplerParams(
        warmup_steps=50, num_samples=5, steps_per_sample=10, num_chains=1,
        num_trees=50,
    )
    surrogate = BARKSurrogate(bench.domain, params, seed=seed)

    rows = []
    for itr in range(num_iter):
        X = candidates[observed]
        y = targets[observed]
        surrogate.fit(X, y)

        remaining = np.setdiff1d(np.arange(n), observed)
        mu, std = surrogate.predict(candidates[remaining])
        lcb = mu[:, 0] - kappa * std[:, 0]
        pick = remaining[int(np.argmin(lcb))]
        observed.append(int(pick))
        best = targets[observed].min()
        regret = best - targets.min()
        logger.info(
            "iter %d: picked #%d y=%.3f best=%.3f regret=%.3f",
            itr, pick, targets[pick], best, regret,
        )
        rows.append(
            {"iteration": itr, "picked": int(pick), "y": float(targets[pick]),
             "best": float(best), "regret": float(regret)}
        )

    output.mkdir(parents=True, exist_ok=True)
    with open(output / f"bandit_seed={seed}.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("-n", "--num-iter", type=int, default=20)
    parser.add_argument("-o", "--output", type=Path, default=Path("results"))
    args = parser.parse_args()
    main(args.seed, args.num_iter, args.output)
