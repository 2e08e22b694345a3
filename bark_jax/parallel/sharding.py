"""Multi-chip chain parallelism: mesh construction + sharded sampling.

The reference's only parallelism axis is a *disabled* Numba prange over
chains (src/bark/fitting/bark_sampler.py:120 — chains actually run
serially). Here chains are a first-class mesh axis: within a chip they vmap
(bark_jax.fitting.sampler.run_bark_sampler); across chips they shard over a
1-D ``chains`` mesh via ``shard_map``, with cross-chain statistics
(acceptance diagnostics, mixing summaries) reduced over ICI with ``psum`` —
the jax.sharding analogue of a distributed data-parallel sampler.

Scaling model: chains are embarrassingly parallel between collective points,
so scaling efficiency is bounded only by the (tiny) ``psum`` of per-chain
scalars — the ≥80% multi-host target in BASELINE.md comes from this design.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.sampler import BARKModel, _run_chain
from bark_jax.forest import Forest


def chain_mesh(n_devices: int | None = None) -> Mesh:
    """1-D device mesh with a single ``chains`` axis."""
    devices = jax.devices()
    n = n_devices or len(devices)
    mesh_devices = mesh_utils.create_device_mesh((n,), devices[:n])
    return Mesh(mesh_devices, ("chains",))


class ChainDiagnostics(NamedTuple):
    """Cross-chain summary statistics reduced with collectives."""

    mean_mll: jax.Array
    mean_noise: jax.Array
    mean_depth: jax.Array  # mean tree depth across chains (structure mixing)


@functools.partial(
    jax.jit, static_argnames=("params", "mesh"), donate_argnums=()
)
def sharded_run_sampler(
    key: jax.Array,
    model: BARKModel,
    X: jax.Array,
    y: jax.Array,
    bounds: jax.Array,
    feat_types: jax.Array,
    params: SamplerParams,
    mesh: Mesh,
    mask: jax.Array | None = None,
) -> tuple[BARKModel, ChainDiagnostics]:
    """Run all chains sharded over the ``chains`` mesh axis.

    ``model`` fields carry a leading ``(num_chains,)`` axis with
    ``num_chains % mesh.size == 0``; data/bounds are replicated. Returns
    posterior samples (chains resident on their devices) plus psum-reduced
    diagnostics.
    """
    num_chains = model.noise.shape[0]
    per_device = num_chains // mesh.shape["chains"]
    assert per_device * mesh.shape["chains"] == num_chains

    from jax import shard_map

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("chains"), P("chains"), P("chains"), P("chains"), P(), P(), P(), P()),
        out_specs=(P("chains"), P()),
        check_vma=False,
    )
    def run_local(keys, forest, noise, scale, X, y, bounds, feat_types):
        def one(k, f, n, s):
            samples, final, _ = _run_chain(
                k, f, n, s, X, y, bounds, feat_types, params, mask
            )
            return samples, final.mll

        samples, final_mll = jax.vmap(one)(keys, forest, noise, scale)

        # cross-chain diagnostics over ICI
        n_dev = jax.lax.psum(1, "chains")
        local = per_device
        mean_mll = jax.lax.psum(jnp.sum(final_mll), "chains") / (n_dev * local)
        mean_noise = jax.lax.psum(jnp.sum(samples.noise), "chains") / (
            n_dev * local * params.num_samples
        )
        depths = samples.forest.depth * samples.forest.active
        mean_depth = jax.lax.psum(
            jnp.sum(depths, dtype=jnp.float32), "chains"
        ) / jax.lax.psum(
            jnp.sum(samples.forest.active, dtype=jnp.float32), "chains"
        )
        diag = ChainDiagnostics(mean_mll, mean_noise, mean_depth)
        return samples, diag

    keys = jax.random.split(key, num_chains)
    samples, diag = run_local(
        keys, model.forest, model.noise, model.scale, X, y, bounds, feat_types
    )
    return samples, diag


def shard_model(model: BARKModel, mesh: Mesh) -> BARKModel:
    """Place a chain-batched model onto the mesh (chains axis sharded)."""
    sharding = NamedSharding(mesh, P("chains"))
    return jax.tree.map(lambda a: jax.device_put(a, sharding), model)
