"""End-to-end BO regret smoke test.

A miniature version of the committed study (REGRET_r02.md): BARK and
Random run the same TreeFunction budget at matched seeds; BARK must find
the optimum basin and beat Random's final best. This is the one test that
would catch a silent regression anywhere in the fit→predict→acquire→
propose chain (e.g. constraints or warm-start wiring breaking the search)
that the unit oracles can't see.

Runs in a subprocess: the suite's conftest forces x64 globally, which
changes the MCMC trajectory enough that this exact budget plateaus (the
production path is f32). The subprocess replays the .claude verify
recipe — f32, CPU, fixed seeds — whose measured behavior is a long
plateau at the init best (-0.715) and then the grid minimum (≈ -1.948).
Budget: 45 iterations. Under the round-5 corrected noise-proposal
Hastings ratio (results/diagnostics/qratio_bug.md) the honest noise
posterior carries a heavier upper tail, so the LCB explores slightly
longer on this noiseless toy: measured basin-hit iterations across seeds
0-4 are 36-42 (vs ~27 under the reference's biased ratio) — the 30-iter
budget was marginal either way.
"""

import subprocess
import sys
from pathlib import Path

_SCRIPT = """
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from bark_jax.benchmarks import map_benchmark
from bark_jax.fitting.params import SamplerParams
from bark_jax.strategies.tree_kernel import make_strategy

bench = map_benchmark("TreeFunction", dim=2, m=10, function_seed=1)
rng = np.random.default_rng(0)
X0 = bench.domain.sample(8, rng)
y0 = bench.f(X0)

params = SamplerParams(warmup_steps=50, num_samples=8, steps_per_sample=5,
                       num_chains=2, num_trees=20)
bark = make_strategy("BARK", bench.domain, seed=0, params=params,
                     num_candidates=1024, num_rounds=3)
bark.tell(X0, y0)
for _ in range(45):
    c = bark.ask(1)
    bark.add(c, bench.f(c))
bark_best = float(bark.y.min())

rand_rng = np.random.default_rng(1)
rand_best = float(y0.min())
for _ in range(45):
    c = bench.domain.sample(1, rand_rng)
    rand_best = min(rand_best, float(bench.f(c)[0]))

print("RESULT", bark_best, rand_best)
assert bark_best < rand_best, (bark_best, rand_best)
# BARK must actually reach the optimum basin, not just tie a weak Random
# draw (grid minimum ~ -1.948; init best ~ -0.715)
assert bark_best < -1.5, bark_best
"""


def test_bark_beats_random_on_treefunction():
    repo = Path(__file__).resolve().parents[2]
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        cwd=repo,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT")][0]
    _, bark_best, rand_best = line.split()
    assert float(bark_best) < float(rand_best)
