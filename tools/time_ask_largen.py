"""Time ask() at large N on the GPU: dense vs factored acquisition.

Records whether ask() completes at padded N up to 32768 and its latency.
Writes results/ask_latency.json.

The surrogate is BARKPrior (prior draws, S=16 samples at m=50 trees — the
paper-scale posterior size of 4 chains x 4 samples) so the measurement
isolates the acquisition path; the MCMC fit cost is a separate axis
(bench.py). Each configuration runs ask() twice: cold (incl. jit compile)
and warm (the steady-state BO-iteration cost).
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.benchmarks.tree_function import TreeFunction
from bark_jax.models.surrogate import BARKPriorSurrogate
from bark_jax.optimizer.acquisition import (
    build_acquisition,
    build_acquisition_lr,
)
from bark_jax.optimizer.search import propose
from bark_jax.strategies.tree_kernel import TreeKernelStrategy

OUT = pathlib.Path(__file__).resolve().parent.parent / "results"


def time_ask(n: int, backend: str, num_samples: int = 16, seed: int = 0):
    bench = TreeFunction(dim=5, m=50, function_seed=1)
    dom = bench.domain
    rng = np.random.default_rng(seed)
    X = dom.sample(n, rng)
    y = bench.f(X)

    sur = BARKPriorSurrogate(dom, num_samples=num_samples, seed=seed)
    strat = TreeKernelStrategy(dom, surrogate=sur, seed=seed, acq_backend=backend)
    strat.tell(X, y)

    ft = jnp.asarray(dom.feature_types())
    train_x, train_y = sur.train_data
    builder = build_acquisition_lr if backend == "lowrank" else build_acquisition

    rec = {"n": n, "backend": backend, "num_samples": num_samples,
           "num_trees": 50, "node_limit": sur.params.node_limit}

    # build (cold, then warm)
    t0 = time.perf_counter()
    acq = builder(sur.model, train_x, train_y, ft, sur.params.max_depth,
                  train_mask=sur.train_mask)
    jax.block_until_ready(acq)
    rec["build_cold_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    acq = builder(sur.model, train_x, train_y, ft, sur.params.max_depth,
                  train_mask=sur.train_mask)
    jax.block_until_ready(acq)
    rec["build_warm_s"] = time.perf_counter() - t0

    # full propose (search + leaf-box centering)
    t0 = time.perf_counter()
    cand, val = propose(jax.random.key(1), acq, dom, ft,
                        max_depth=sur.params.max_depth,
                        rng=np.random.default_rng(1))
    rec["propose_cold_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cand, val = propose(jax.random.key(2), acq, dom, ft,
                        max_depth=sur.params.max_depth,
                        rng=np.random.default_rng(2))
    rec["propose_warm_s"] = time.perf_counter() - t0
    rec["ask_warm_s"] = rec["build_warm_s"] + rec["propose_warm_s"]
    rec["acq_value"] = float(val)

    # end-to-end strategy.ask() (wiring proof; warm jits by now)
    t0 = time.perf_counter()
    out = strat.ask()
    rec["strategy_ask_s"] = time.perf_counter() - t0
    rec["in_domain"] = bool(
        (out[0] >= dom.bounds("ordinal")[:, 0] - 1e-9).all()
        and (out[0] <= dom.bounds("ordinal")[:, 1] + 1e-9).all()
    )
    print(json.dumps(rec), flush=True)
    return rec


def main():
    from bench import card_line, device_fields, require_gpu
    from bark_jax.utils.compile_cache import enable_compile_cache

    require_gpu(jax.devices())
    enable_compile_cache()
    OUT.mkdir(parents=True, exist_ok=True)
    device = dict(device_fields(jax.devices()), card=card_line())
    print(json.dumps(device), flush=True)
    records = []
    # dense baseline at the auto threshold; factored at/past the wall
    for n, backend in [
        (2048, "dense"),
        (2048, "lowrank"),
        (8192, "lowrank"),
        (32768, "lowrank"),
    ]:
        records.append(time_ask(n, backend))
    (OUT / "ask_latency.json").write_text(json.dumps(
        {"device": device, "records": records}, indent=2))
    print("wrote", OUT / "ask_latency.json", flush=True)


if __name__ == "__main__":
    main()
