"""Full-bench cost of the matmul-precision gates (ops/linalg.py) on a GPU.

The move scan's hoisted quadratic forms and the refresh algebra run at
``MM_PRECISION`` ("highest"); the scan bodies at ``MM_PRECISION_SCAN``
("default", which is TF32 on the H100). This measures ``bench.measure`` at
each N with the shipped gates and with the scan gate raised to "highest",
in turns (shipped, raised, raised, shipped) in one process. The accuracy
side is held by chip_smoke.py (phase d) and tools/selfparity_stationary.py.
Writes results/ab_precision.jsonl.
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

import bark_jax.ops.linalg as linalg  # noqa: E402
from bark_jax.utils.compile_cache import enable_compile_cache  # noqa: E402
from bench import card_line, measure, require_gpu  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent.parent / "results" / "ab_precision.jsonl"
CONFIGS = [50, 256, 384, 512, 1024, 4096]

require_gpu(jax.devices())
enable_compile_cache()
card = card_line()
OUT.parent.mkdir(parents=True, exist_ok=True)
shipped = linalg.MM_PRECISION_SCAN
with open(OUT, "w") as fh:
    for n in CONFIGS:
        for scan_gate in (shipped, "highest", "highest", shipped):
            linalg.MM_PRECISION_SCAN = scan_gate
            jax.clear_caches()  # the gate is read at trace time
            r = dict(measure(n_train=n), scan_gate=scan_gate, card=card)
            print(json.dumps(r), flush=True)
            fh.write(json.dumps(r) + "\n")
            fh.flush()
linalg.MM_PRECISION_SCAN = shipped
