"""Sampler throughput: forest-MCMC steps/s on TreeFunction, on one GPU.

One full BARK MCMC step is m=50 tree moves + 1 noise/scale move; chains are
vmapped on the card. Default mode prints ONE JSON line for N=50 training
points and 64 chains. ``--curve`` sweeps N in {50, 200, 512, 1024} plus a
mixed-categorical variant (2 of 5 features categorical with 5 levels), and
``--curve-xl`` adds N in {2048, 4096, 8192}, the leaf-space refresh tier.
``--out FILE`` also writes the result JSON to disk.

Every result names the device it ran on (platform, ``device_kind``, device
count, and the card's name and power limit from ``nvidia-smi``). The script
refuses to run without a GPU: a CPU number is not a device metric.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def card_line() -> str:
    """``name, power.limit`` of the first card, as ``nvidia-smi`` prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def require_gpu(devices) -> None:
    """Raise SystemExit unless JAX's first device is a GPU."""
    platform = devices[0].platform if devices else None
    if platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU; JAX's first device is {platform!r}"
        )


def device_fields(devices) -> dict:
    """What a result reports about the devices it ran on."""
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
    }


def measure(n_train: int, cat_dim: int = 0, num_chains: int = 64,
            steps_per_call: int = 50, n_calls: int = 5,
            **sampler_overrides) -> dict:
    """Steady-state full-MCMC steps/s at one (N, domain) configuration.

    Two untimed calls first: one to compile + mix the trees from the empty
    forest, one on the warm state to compile the steady-state shapes; the
    timed region then measures ``n_calls`` async-dispatched sampler calls
    with a single trailing block_until_ready (a per-call sync would time
    dispatch latency, not the device).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bark_jax.benchmarks.tree_function import TreeFunction
    from bark_jax.fitting.params import SamplerParams
    from bark_jax.fitting.sampler import BARKModel, run_bark_sampler
    from bark_jax.forest import create_empty_forest

    cont_dim = 5 - cat_dim
    bench = TreeFunction(dim=cont_dim, cat_dim=cat_dim, num_cat=5, m=50,
                         function_seed=1)
    rng = np.random.default_rng(0)
    X = bench.domain.sample(n_train, rng)
    y = bench.f(X)
    y_std = (y - y.mean()) / y.std()

    sampler_overrides.setdefault("num_trees", 50)
    params = SamplerParams(
        warmup_steps=0,
        num_samples=10,
        steps_per_sample=steps_per_call // 10,
        num_chains=num_chains,
        **sampler_overrides,
    )
    bounds = jnp.asarray(bench.domain.bounds("bitmask"))
    ft = jnp.asarray(bench.domain.feature_types())
    forest = create_empty_forest(
        params.num_trees, params.node_limit, batch_shape=(num_chains,)
    )
    model = BARKModel(
        forest,
        jnp.full((num_chains,), 0.1, jnp.float32),
        jnp.ones((num_chains,), jnp.float32),
    )
    Xj = jnp.asarray(X)
    yj = jnp.asarray(y_std, jnp.float32)

    def run(m, key):
        return run_bark_sampler(key, m, Xj, yj, bounds, ft, params)

    # compile + warm the trees (so the timed region is steady-state mixing)
    t0 = time.perf_counter()
    samples = jax.block_until_ready(run(model, jax.random.key(0)))
    setup_s = time.perf_counter() - t0
    warm_model = BARKModel(
        forest=jax.tree.map(lambda a: a[:, -1], samples.forest),
        noise=samples.noise[:, -1],
        scale=samples.scale[:, -1],
    )
    jax.block_until_ready(run(warm_model, jax.random.key(1)))

    t0 = time.perf_counter()
    for i in range(n_calls):
        out = run(warm_model, jax.random.key(2 + i))
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0

    total_steps = n_calls * num_chains * steps_per_call
    return {
        "metric": "forest_mcmc_steps_per_s",
        "value": total_steps / dt,
        "unit": "steps/s",
        "n_train": n_train,
        "cat_dim": cat_dim,
        "num_chains": num_chains,
        "setup_s": setup_s,
        **device_fields(jax.devices()),
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--curve", action="store_true",
                        help="sweep N in {50,200,512,1024} + mixed-cat")
    parser.add_argument("--curve-xl", action="store_true",
                        help="also sweep N in {2048,4096,8192} (leaf refresh)")
    parser.add_argument("--out", default=None,
                        help="also write the result JSON to this file")
    args = parser.parse_args()

    import jax

    require_gpu(jax.devices())
    from bark_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = card_line()

    configs = [{"n_train": 50, "cat_dim": 0}]
    if args.curve or args.curve_xl:
        configs = [
            {"n_train": 50, "cat_dim": 0},
            {"n_train": 200, "cat_dim": 0},
            {"n_train": 512, "cat_dim": 0},
            {"n_train": 1024, "cat_dim": 0},
            {"n_train": 50, "cat_dim": 2},  # mixed-categorical variant
        ]
        if args.curve_xl:
            configs += [
                {"n_train": 2048, "cat_dim": 0},
                {"n_train": 4096, "cat_dim": 0},
                {"n_train": 8192, "cat_dim": 0},
            ]
    results = [dict(measure(**c), card=card) for c in configs]
    payload = json.dumps(results if len(results) > 1 else results[0])
    print(payload)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(payload + "\n")


if __name__ == "__main__":
    main()
