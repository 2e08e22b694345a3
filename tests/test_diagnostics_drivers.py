"""Smoke tests for the notebook-tier diagnostics drivers: the
prior/proposal study and the cross-seed BO-runs plotter.

Both run in subprocesses: the suite's x64/virtual-device config must not
leak into the drivers' f32 CPU environment (CLAUDE.md).
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_priors_and_proposals_study(tmp_path):
    out = tmp_path / "study.json"
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "priors_and_proposals.py"),
         "--steps", "600", "--chains", "16", "--no-plots",
         "--out", str(out)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(out.read_text())
    # the proposal transition must be lognormal (z-ish stats ~ O(1))
    assert abs(summary["proposal_lognormal"]["proposal_log_std"] - 1.0) < 0.1
    # the corrected default must sit far closer to the analytic prior than
    # the reference-compat ratio (the study's motivating finding)
    z_correct = summary["default_correct_ratio"]["noise_prior_mean_z"]
    z_reference = summary["reference_ratio_for_contrast"]["noise_prior_mean_z"]
    assert z_reference > 5 * max(z_correct, 1.0)
    q90_an = summary["noise_prior_quantiles_analytic"][2]
    q90_ref = summary["reference_ratio_for_contrast"][
        "noise_prior_quantiles_empirical"
    ][2]
    assert q90_ref < 0.7 * q90_an  # the documented halved-tail signature


def test_plot_bo_runs(tmp_path):
    fig = tmp_path / "runs.png"
    summary_path = tmp_path / "runs.json"
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "plot_bo_runs.py"),
         str(REPO / "results" / "regret_r2"),
         "--out", str(fig), "--summary-out", str(summary_path)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert fig.exists()
    summary = json.loads(summary_path.read_text())
    # the recorded round-2 study must aggregate per strategy across 5 seeds
    assert summary["PestControl/BARK"]["seeds"] == 5
    # and the BO strategy must beat random in the aggregate
    assert (
        summary["TreeFunction/BARK"]["final_best_mean"]
        < summary["TreeFunction/Random"]["final_best_mean"]
    )
