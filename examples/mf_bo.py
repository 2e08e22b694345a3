"""End-to-end multi-fidelity BO driver (CurrinExp2D).

The driver the reference never shipped working (its MF pieces are stale —
src/bark/optimizer/information_based_fidelity.py imports a BARKMOGP that
does not exist; SURVEY §2.6). Protocol follows the reference's intent:

  1. fit a multi-task tree GP (booster forest + fitted index-kernel/noise
     hypers, bark_jax.models.mogp.LeafMOGPSurrogate ≙ LeafMOGP) on all
     (x, fidelity, y) observations so far;
  2. pick the next x by LCB at the TARGET fidelity over a Sobol candidate
     batch (kappa = 1.96, the study default);
  3. pick the fidelity by information gain per unit cost
     (bark_jax.optimizer.fidelity.propose_fidelity_information_based),
     with f* optimum samples drawn from the target-fidelity joint
     posterior at the training sites;
  4. evaluate the benchmark at that fidelity, pay its cost, repeat.

Regret is tracked as best observed TARGET-fidelity value vs cumulative
cost (the currency MF-BO optimizes).

Usage:
    python examples/mf_bo.py -s 0 --iters 20 -o results/mf_bo --platform cpu
"""

from __future__ import annotations

import sys
from pathlib import Path as _Path

sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))

import argparse
import csv
import json
import logging

import numpy as np

logger = logging.getLogger("mf_bo")


def fstar_samples_mogp(mogp, X_train, num_fstar: int, rng) -> np.ndarray:
    """Optimum-value samples from the target-fidelity joint posterior
    (now a library function; kept as a thin alias for recorded-run
    compatibility)."""
    from bark_jax.models.sampling import fstar_samples_mogp as _fs

    return _fs(mogp, X_train, num_fstar, rng)


def run_study(seed: int, num_iter: int, num_init: int = 6,
              num_candidates: int = 256, kappa: float = 1.96,
              num_fstar: int = 16, surrogate_kwargs: dict | None = None):
    from bark_jax.benchmarks import map_benchmark
    from bark_jax.models.mogp import LeafMOGPSurrogate
    from bark_jax.optimizer.fidelity import propose_fidelity_information_based

    bench = map_benchmark("CurrinExp2D")
    costs = bench.fidelity_costs
    rng = np.random.default_rng(seed)

    # init design: alternate fidelities so every task has data
    X = bench.domain.sample(num_init, rng)
    fid = np.arange(num_init) % bench.num_fidelities
    y = bench.f_fidelity(X, fid)

    records = []
    cum_cost = float(sum(costs[m] for m in fid))

    def best_target():
        at_target = y[fid == 0]
        return float(at_target.min()) if at_target.size else float("nan")

    for it in range(num_iter):
        mogp = LeafMOGPSurrogate(
            bench.domain, num_tasks=bench.num_fidelities, seed=seed,
            **(surrogate_kwargs or {}),
        )
        mogp.fit(X, fid, y)

        cands = bench.domain.sample_sobol(num_candidates, seed=seed * 1000 + it)
        mu, sd = mogp.predict(cands, np.zeros(len(cands), np.int64))
        x_next = cands[int(np.argmin(mu - kappa * sd))][None, :]

        f_star = fstar_samples_mogp(mogp, X, num_fstar, rng)
        m_next = propose_fidelity_information_based(
            mogp, x_next, costs, f_star
        )

        y_next = bench.f_fidelity(x_next, [m_next])
        X = np.vstack([X, x_next])
        fid = np.concatenate([fid, [m_next]])
        y = np.concatenate([y, y_next])
        cum_cost += costs[m_next]

        records.append({
            "iter": it, "fidelity": int(m_next), "y": float(y_next[0]),
            "cum_cost": cum_cost, "best_target": best_target(),
        })
        logger.info(
            "iter %d: fid=%d y=%.4f cost=%.2f best@target=%.4f",
            it, m_next, y_next[0], cum_cost, best_target(),
        )
    return records


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--num-init", type=int, default=6)
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--platform", default=None)
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    records = run_study(args.seed, args.iters, num_init=args.num_init)
    summary = {
        "benchmark": "CurrinExp2D",
        "seed": args.seed,
        "final_best_target": records[-1]["best_target"],
        "total_cost": records[-1]["cum_cost"],
        "low_fidelity_fraction": float(
            np.mean([r["fidelity"] != 0 for r in records])
        ),
    }
    print(json.dumps(summary))
    if args.output:
        out = _Path(args.output)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"mf_bo_currin_seed={args.seed}.csv"
        with open(path, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(records[0]))
            w.writeheader()
            w.writerows(records)
        with open(out / f"mf_bo_currin_seed={args.seed}.json", "w") as fh:
            json.dump(summary, fh, indent=1)
