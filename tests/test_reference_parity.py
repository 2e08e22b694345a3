"""CI-runnable statistical-parity check against the actual reference sampler.

Runs a small-budget version of tools/parity/run_parity.py: the reference's
`_run_bark_sampler_multichain` (bark_sampler.py:120-213, executed pure-Python
via the numba shim) vs bark_jax, on identical TreeFunction data, asserting
chain-mean posterior moments agree within combined MC error and predictive
NLPD/MSE within tolerance. The full-budget evidence lives in
PARITY_RESULTS.md.
"""

from pathlib import Path

import pytest

REFERENCE = Path("/root/reference/src")

pytestmark = pytest.mark.skipif(
    not REFERENCE.exists(), reason="reference checkout not available"
)


def test_reference_parity_small_budget():
    from tools.parity.run_parity import DEFAULT_PARAMS, run_workload

    params = {
        **DEFAULT_PARAMS,
        "warmup_steps": 20,
        "num_samples": 10,
        "steps_per_sample": 3,
        "num_chains": 4,
        "num_trees": 10,
    }
    rows = run_workload("tree_function", 30, 15, params, seed=1)
    failures = [r for r in rows if not r["pass"]]
    assert not failures, f"parity failures: {failures}"


def test_reference_parity_paper_replay():
    """Paper-power parity WITHOUT re-running the shimmed reference
   : only the bark_jax side runs; the reference chain
    means/SEs are replayed from the committed cache
    results/parity_r3/parity_paper.json (same workloads, seed, params).
    ~40 s vs ~260 s for the full --paper harness. Runs in a SUBPROCESS:
    the suite's x64 config changes f32 trajectories (CLAUDE.md), and the
    cache was recorded from the CLI environment. Opt-in via
    PARITY_REPLAY=1 (CI on-demand tier, like the full harness)."""
    import json
    import os
    import subprocess
    import sys

    if os.environ.get("PARITY_REPLAY") != "1":
        pytest.skip("set PARITY_REPLAY=1 to run the paper-budget replay")

    repo = Path(__file__).resolve().parents[1]
    cache = repo / "results" / "parity_r3" / "parity_paper.json"
    proc = subprocess.run(
        [sys.executable, str(repo / "tools" / "parity" / "run_parity.py"),
         "--replay", str(cache)],
        capture_output=True, text=True, cwd=repo, timeout=300,
    )
    out = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    assert out, f"no JSON output; stderr tail: {proc.stderr[-2000:]}"
    payload = json.loads(out[-1])
    failures = {
        wl: [r for r in rows if not r["pass"]]
        for wl, rows in payload["results"].items()
    }
    failures = {wl: f for wl, f in failures.items() if f}
    assert proc.returncode == 0 and payload["pass"], (
        f"replay parity failures: {failures}"
    )
