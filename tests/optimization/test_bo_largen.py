"""Large-N BO driver smoke.

Runs the committed examples/bo_largen.py loop at reduced size with the
large-N backends forced (LR acquisition), checking the phases engage and
the incumbent never worsens. The recorded full-size runs live under
results/bo_largen/.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np

_DRIVER = Path(__file__).resolve().parents[2] / "examples" / "bo_largen.py"


def _load():
    spec = importlib.util.spec_from_file_location("bo_largen_example", _DRIVER)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["bo_largen_example"] = mod
    spec.loader.exec_module(mod)
    return mod


def test_bo_largen_loop_smoke():
    mod = _load()
    res = mod.run_study(
        seed=0, n_init=120, num_iter=2, num_candidates=256,
        num_chains=2, num_samples=3, acq_backend="lowrank",
    )
    its = res["iterations"]
    assert len(its) == 2
    assert its[0]["n_train"] == 121 and its[1]["n_train"] == 122
    bests = [r["best_y"] for r in its]
    assert all(np.isfinite(b) for b in bests)
    assert bests[1] <= bests[0] + 1e-12
    assert all(r["fit_s"] >= 0 and r["ask_s"] > 0 for r in its)
