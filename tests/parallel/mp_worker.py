"""Worker for the two-process jax.distributed test (run via subprocess).

Each process calls bark_jax's ``initialize_distributed`` (args from env),
builds the global chain mesh spanning both processes, and runs the
sharded BARK sampler with chains distributed across all global devices.
The psum-reduced diagnostics are replicated, so both processes must print
identical values — the test asserts that.
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def main():
    from bark_jax.parallel.distributed import (
        global_chain_mesh,
        initialize_distributed,
    )

    ok = initialize_distributed()
    assert ok, "distributed runtime did not come up"
    assert jax.process_count() == 2, jax.process_count()

    import jax.numpy as jnp

    from bark_jax.benchmarks import map_benchmark
    from bark_jax.fitting.params import SamplerParams
    from bark_jax.fitting.sampler import BARKModel
    from bark_jax.forest import create_empty_forest
    from bark_jax.parallel.sharding import shard_model, sharded_run_sampler

    bench = map_benchmark("TreeFunction", dim=2, m=4, function_seed=1)
    rng = np.random.default_rng(0)
    X = jnp.asarray(bench.domain.sample(12, rng))
    y = jnp.asarray(
        np.random.default_rng(1).standard_normal(12).astype(np.float32)
    )
    bounds = jnp.asarray(bench.domain.bounds("bitmask"))
    ft = jnp.asarray(bench.domain.feature_types())
    params = SamplerParams(
        warmup_steps=2, num_samples=2, steps_per_sample=1, num_trees=4
    )

    mesh = global_chain_mesh()
    num_chains = 2 * jax.device_count()
    forest = create_empty_forest(
        params.num_trees, params.node_limit, batch_shape=(num_chains,)
    )
    model = shard_model(
        BARKModel(
            forest,
            jnp.full((num_chains,), 0.1, jnp.float32),
            jnp.ones((num_chains,), jnp.float32),
        ),
        mesh,
    )
    samples, diag = sharded_run_sampler(
        jax.random.key(0), model, X, y, bounds, ft, params, mesh
    )
    jax.block_until_ready(diag)
    print(
        "MPOK",
        jax.process_index(),
        jax.device_count(),
        f"{float(diag.mean_mll):.6f}",
        f"{float(diag.mean_noise):.6f}",
        flush=True,
    )


if __name__ == "__main__":
    main()
    sys.exit(0)
