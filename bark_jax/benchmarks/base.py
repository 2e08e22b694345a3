"""Benchmark base class and registry.

Parity: the reference exposes benchmarks through ``BENCHMARK_MAP`` /
``map_benchmark`` (src/bofire_mixed/benchmarks/__init__.py:23-59) with each
benchmark providing ``.domain`` and ``.f(X)``. Here ``f`` consumes
ordinal-encoded numpy arrays ``(N, D)`` (the same encoding the surrogates
train on) and returns ``(N,)`` outputs; helpers accept dict/DataFrame input
via ``Domain.transform``.
"""

from __future__ import annotations

import numpy as np

from bark_jax.domain import Domain

BENCHMARK_MAP: dict[str, type] = {}


def register_benchmark(name: str):
    def deco(cls):
        BENCHMARK_MAP[name] = cls
        cls.name = name
        return cls

    return deco


def map_benchmark(name: str, **kwargs) -> "Benchmark":
    """Instantiate a registered benchmark by name
    (parity: benchmarks/__init__.py:52-59)."""
    return BENCHMARK_MAP[name](**kwargs)


class Benchmark:
    """A black-box objective over a mixed domain (minimization)."""

    name: str = "benchmark"

    def __init__(self, domain: Domain):
        self._domain = domain

    @property
    def domain(self) -> Domain:
        return self._domain

    def _f(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def f(self, X) -> np.ndarray:
        """Evaluate at ordinal-encoded points (accepts dict/DataFrame too)."""
        X = self.domain.transform(X)
        return np.asarray(self._f(np.asarray(X, np.float64))).reshape(-1)

    def get_optima(self) -> tuple[np.ndarray, float] | None:
        """Return (argmin as ordinal-encoded (D,), min value) if known."""
        return None
