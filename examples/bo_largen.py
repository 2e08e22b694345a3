"""Large-N BO study: the full tell -> fit -> ask loop past the dense wall.

Every large-N piece (leaf-space sampler refresh, leaf predict, factored
LR acquisition) runs *together* here, on TreeFunction at N ~ 4096 — the regime
where the reference's loop dies outright (its acquisition precomputes
dense (S, N, N) inverses, src/bark/optimizer/opt_model.py:54-59, and its
sampler rebuilds dense kernels per step, bark_sampler.py:153-162) — and
records per-phase wall times + the incumbent trace under
``results/bo_largen/``.

Usage::

    python examples/bo_largen.py            # N=4080 + 6 iterations (GPU)
    python examples/bo_largen.py --n-init 500 --num-iter 3   # smaller
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

OUT_DIR = pathlib.Path(__file__).resolve().parent.parent / "results" / "bo_largen"


def run_study(
    seed: int = 0,
    n_init: int = 4080,
    num_iter: int = 6,
    num_candidates: int = 4096,
    num_chains: int = 4,
    num_samples: int = 4,
    acq_backend: str = "auto",
    fit_style: str = "chains",
    return_strategy: bool = False,
):
    """Initial fit on ``n_init`` points, then ``num_iter`` ask/add rounds.

    Returns the JSON-ready record, and the strategy too when
    ``return_strategy`` is set.
    """
    from bark_jax.benchmarks.tree_function import TreeFunction
    from bark_jax.fitting.params import SamplerParams
    from bark_jax.models.surrogate import BARKSurrogate
    from bark_jax.strategies.tree_kernel import make_strategy

    bench = TreeFunction(dim=5, m=50, function_seed=1)
    rng = np.random.default_rng(seed)

    # random-search yardstick for the incumbent trace. NOTE: BARK routinely
    # goes BELOW this (negative best_minus_probe_min) — the leaf-box
    # centered acquisition exploits the piecewise-constant structure that
    # a 200k-point random sweep cannot (measured on CPU smoke: first BO
    # proposal 2.16 vs probe min 3.00 on this benchmark).
    probe = bench.domain.sample(200_000, np.random.default_rng(7))
    f_star_est = float(bench.f(probe).min())

    params = SamplerParams(
        warmup_steps=50,
        num_samples=num_samples,
        steps_per_sample=10,
        num_chains=num_chains,
        num_trees=50,
    )
    surrogate = BARKSurrogate(
        bench.domain, params, seed=seed, fit_style=fit_style
    )
    strat = make_strategy(
        "BARK",
        bench.domain,
        seed=seed,
        surrogate=surrogate,
        params=params,
        num_candidates=num_candidates,
        num_rounds=3,
        acq_backend=acq_backend,
    )

    X = bench.domain.sample(n_init, rng)
    y = bench.f(X)

    import jax

    def _sync():
        # sampler fits dispatch asynchronously; block so the phase timings
        # are honest device costs, not dispatch latency
        jax.block_until_ready(strat.surrogate.model)

    records = []
    t0 = time.perf_counter()
    strat.tell(X, y)  # initial fit (includes warmup + compiles)
    _sync()
    fit0_s = time.perf_counter() - t0

    for it in range(num_iter):
        t0 = time.perf_counter()
        cand = strat.ask(1)
        ask_s = time.perf_counter() - t0
        y_new = bench.f(cand)
        t0 = time.perf_counter()
        strat.add(cand, y_new)  # warm-started refit on the grown set
        _sync()
        fit_s = time.perf_counter() - t0
        rec = {
            "iter": it,
            "n_train": int(len(strat.y)),
            # the proposed POINT, not just its objective value: the
            # objective is piecewise constant, so distinct proposals can
            # share y — duplicate detection is about x
            "candidate": [round(float(v), 6) for v in np.asarray(cand)[0]],
            "ask_s": round(ask_s, 3),
            "fit_s": round(fit_s, 3),
            "y_new": float(np.asarray(y_new).reshape(-1)[0]),
            "best_y": float(strat.y.min()),
            "best_minus_probe_min": float(strat.y.min() - f_star_est),
            # distance-from-stationarity of the fit the ask consumed (the
            # large-N posterior can still be a transit ensemble)
            "fit_diagnostics": strat.surrogate.fit_diagnostics,
        }
        records.append(rec)
        print(json.dumps(rec), flush=True)

    result = {
        "config": {
            "benchmark": "TreeFunction(dim=5, m=50, seed=1)",
            "seed": seed,
            "n_init": n_init,
            "num_iter": num_iter,
            "num_candidates": num_candidates,
            "sampler": {
                "num_chains": num_chains,
                "num_samples": num_samples,
                "steps_per_sample": 10,
                "warmup_steps": 50,
                "num_trees": 50,
            },
            "acq_backend": acq_backend,
            "fit_style": fit_style,
        },
        "f_star_probe_200k": f_star_est,
        "initial_fit_s": round(fit0_s, 3),
        "iterations": records,
    }
    return (result, strat) if return_strategy else result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-init", type=int, default=4080)
    ap.add_argument("--num-iter", type=int, default=6)
    ap.add_argument("--num-candidates", type=int, default=4096)
    ap.add_argument("--fit-style", default="chains",
                    choices=("chains", "tempered"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from bark_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    result = run_study(
        seed=args.seed,
        n_init=args.n_init,
        num_iter=args.num_iter,
        num_candidates=args.num_candidates,
        fit_style=args.fit_style,
    )
    out = pathlib.Path(args.out) if args.out else OUT_DIR / (
        f"study_n{args.n_init}_seed{args.seed}.json"
    )
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
