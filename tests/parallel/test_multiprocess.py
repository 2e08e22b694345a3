"""Two-process jax.distributed run of the sharded sampler.

The real multi-host path (SURVEY §5 distributed-comm backend): two OS
processes, each with 2 virtual CPU devices, joined by
``initialize_distributed`` into one 4-device runtime; the sharded sampler
runs chains across all of them and both processes must report identical
psum-reduced diagnostics. Uses the Gloo CPU collective backend — the same
jax.distributed code path a multi-host GPU run takes, with NCCL there.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

_WORKER = Path(__file__).resolve().parent / "mp_worker.py"
_REPO = Path(__file__).resolve().parents[2]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_sampler():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
            PYTHONPATH=str(_REPO),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, str(_WORKER)],
                env=env,
                cwd=_REPO,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=280)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        mpok = [l for l in out.splitlines() if l.startswith("MPOK")]
        assert mpok, out + err
        outs.append(mpok[0].split())

    # both processes saw 4 global devices and identical reduced diagnostics
    assert outs[0][2] == "4" and outs[1][2] == "4"
    assert outs[0][3] == outs[1][3]  # mean_mll matches across processes
    assert outs[0][4] == outs[1][4]  # mean_noise matches
