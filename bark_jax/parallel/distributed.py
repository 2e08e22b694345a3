"""Multi-process initialization: the jax.distributed entry point.

The reference is single-process (SURVEY §2.4: no distributed backend of any
kind). The scale-out path here: each process calls
:func:`initialize_distributed` once at startup, after which ``jax.devices()``
spans every process's cards and every mesh built from it (``chain_mesh``,
the ``replicas``/``particles`` PT/SMC meshes) shards across them
transparently — XLA inserts the collectives (NCCL on GPUs) from the same
``shard_map`` programs that the virtual-CPU tests exercise.

The coordinator address, process count and process id come from explicit
arguments or the environment variables ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``. Nothing is auto-detected.
"""

from __future__ import annotations

import logging
import os

import jax

logger = logging.getLogger(__name__)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize the jax.distributed runtime (idempotent).

    Returns True when a multi-process runtime is active after the call.
    Without a configured coordinator this is a no-op returning False, so
    library code can call it unconditionally. Errors from
    ``jax.distributed.initialize`` propagate: a misconfigured cluster must
    not quietly run as one process.
    """
    # NB: do not call jax.process_count() here — it would initialize the
    # backend, after which jax.distributed.initialize refuses to run.
    if jax.distributed.is_initialized():
        return jax.process_count() > 1  # already initialized by the launcher

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    env_n = os.environ.get("JAX_NUM_PROCESSES")
    env_i = os.environ.get("JAX_PROCESS_ID")
    num_processes = num_processes if num_processes is not None else (
        int(env_n) if env_n else None
    )
    process_id = process_id if process_id is not None else (
        int(env_i) if env_i else None
    )

    if not coordinator_address:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    logger.info(
        "jax.distributed: process %d/%d, %d local + %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )
    return jax.process_count() > 1


def global_chain_mesh(axis_name: str = "chains"):
    """1-D mesh over every device in the (possibly multi-host) runtime.

    With ``initialize_distributed`` active this spans hosts; chains stay
    embarrassingly parallel between collective points, so weak-scaling
    efficiency is bounded only by the tiny scalar psums
    (bark_jax/parallel/sharding.py). Every card reaches every other at the
    same rate over NVLink, so the device order needs no topology.
    """
    from jax.experimental import mesh_utils
    from jax.sharding import Mesh

    devices = mesh_utils.create_device_mesh((jax.device_count(),))
    return Mesh(devices, (axis_name,))
