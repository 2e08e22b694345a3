"""Multi-fidelity benchmarks.

Parity: src/bofire_mixed/benchmarks/multi_fidelity.py:8-55 (CurrinExp2D) —
the low fidelity is a local average of the high-fidelity function over four
0.05-shifted corners.
"""

from __future__ import annotations

import numpy as np

from bark_jax.benchmarks.base import Benchmark, register_benchmark
from bark_jax.domain import ContinuousInput, Domain


def _currin(x0, x1):
    prod1 = 1 - np.exp(-1 / (2 * (x1 + 1e-5)))
    prod2 = (2300 * x0**3 + 1900 * x0**2 + 2092 * x0 + 60) / (
        100 * x0**3 + 500 * x0**2 + 4 * x0 + 20
    )
    return -prod1 * prod2 / 10


@register_benchmark("CurrinExp2D")
class CurrinExp2D(Benchmark):
    """Two-fidelity Currin exponential; fidelity 0 = ground truth,
    fidelity 1 = local average (multi_fidelity.py:23-34)."""

    num_fidelities = 2
    fidelity_costs = (1.0, 0.25)

    def __init__(self, **kwargs):
        super().__init__(
            Domain(
                [
                    ContinuousInput("x_0", (0.0, 1.0)),
                    ContinuousInput("x_1", (0.0, 1.0)),
                ]
            )
        )

    def _f(self, X):
        return _currin(X[:, 0], X[:, 1])

    def f_fidelity(self, X, fidelity) -> np.ndarray:
        """Evaluate at per-row fidelities (0 = truth, 1 = local average)."""
        X = self.domain.transform(X).astype(np.float64)
        fidelity = np.asarray(fidelity, np.int64).reshape(-1)
        deltas = 0.05 * np.array([[1, 1], [1, -1], [-1, 1], [-1, -1]])
        x_tilde = np.clip(X[:, None, :] + deltas[None], 0, 1)
        low = _currin(x_tilde[..., 0], x_tilde[..., 1]).mean(axis=1)
        high = _currin(X[:, 0], X[:, 1])
        return np.where(fidelity == 0, high, low)
