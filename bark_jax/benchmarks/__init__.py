"""Benchmark workload suite.

Parity: src/bofire_mixed/benchmarks/__init__.py:23-59 — the same registry
names resolve through ``map_benchmark``. SVRBench runs on the real CSV when
present and otherwise on a synthetic slice-localization-shaped substitute
(svr_bench.py); CCOBench runs on the real powermap blobs when present and
otherwise on synthetic 3GPP-style powermaps (cco.py) — both blobs are
absent from the reference checkout itself, see its .MISSING_LARGE_BLOBS.
DatasetBenchmark is live with a pluggable data source (DataFrame/CSV, or
the ucimlrepo fetcher when importable).
"""

from bark_jax.benchmarks.base import BENCHMARK_MAP, Benchmark, map_benchmark

# importing registers each benchmark
from bark_jax.benchmarks import cco as _cco  # noqa: F401
from bark_jax.benchmarks import constrained as _constrained  # noqa: F401
from bark_jax.benchmarks import dataset as _dataset  # noqa: F401
from bark_jax.benchmarks import hartmann as _hartmann  # noqa: F401
from bark_jax.benchmarks import hpo as _hpo  # noqa: F401
from bark_jax.benchmarks import max_bandit as _max_bandit  # noqa: F401
from bark_jax.benchmarks import mixed as _mixed  # noqa: F401
from bark_jax.benchmarks import multi_fidelity as _multi_fidelity  # noqa: F401
from bark_jax.benchmarks import pest as _pest  # noqa: F401
from bark_jax.benchmarks import reaction_emulator as _reaction  # noqa: F401
from bark_jax.benchmarks import svr_bench as _svr_bench  # noqa: F401
from bark_jax.benchmarks import tree_function as _tree_function  # noqa: F401
from bark_jax.benchmarks import unconstrained as _unconstrained  # noqa: F401


__all__ = ["BENCHMARK_MAP", "Benchmark", "map_benchmark"]
