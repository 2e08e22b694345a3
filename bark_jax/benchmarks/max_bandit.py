"""MAX-phase materials bandit: discrete candidate lookup benchmark.

Parity: src/bofire_mixed/benchmarks/MAX_bandit.py:16-106 — a 27-feature
domain (3 categorical element choices + 10 property dims + 16 nuisance dims)
whose objective is a lookup into a fixed table of candidate materials
(data/MAX_data.json in the reference checkout); maximization of K_exp turned
into minimization by negation.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from bark_jax.benchmarks.base import Benchmark, register_benchmark
from bark_jax.domain import CategoricalInput, ContinuousInput, Domain

A_ELE = ("Tl", "Pb", "Ge", "Al", "Ga", "In", "Sn", "Cd", "S", "Si", "As", "P")
M_ELE = ("Ti", "V", "Hf", "Ta", "Nb", "Cr", "Zr", "Sc", "Mo")
X_ELE = ("N", "C")

DATA_PATH = Path(__file__).parent / "data" / "MAX_data.json"


@register_benchmark("MAXBandit")
class MAXBandit(Benchmark):
    def __init__(self, data_path=None, target="K_exp", negate=True, **kwargs):
        self.target = target
        cont = [
            ("e_a", (2.5, 6.0)),
            ("APF", (0.35, 1.0)),
            ("C", (-8.0, 0.0)),
            ("m", (0.0, 1.0)),
            ("Cv", (0.0, 1.0)),
            ("a_exp", (2.0, 4.0)),
            ("c_exp", (10.0, 25.0)),
            ("Z", (10.0, 100.0)),
            ("I_dist", (0.0, 1.0)),
        ]
        super().__init__(
            Domain(
                [
                    CategoricalInput("A_ele", A_ELE),
                    CategoricalInput("M_ele", M_ELE),
                    CategoricalInput("X_ele", X_ELE),
                    *(ContinuousInput(k, b) for k, b in cont),
                    *(
                        ContinuousInput(f"nuisance{i}", (-1.0, 1.0))
                        for i in range(16)
                    ),
                ]
            )
        )
        path = Path(data_path) if data_path else DATA_PATH
        if not path.exists():
            raise FileNotFoundError(f"MAX bandit data not found at {path}")
        with open(path) as f:
            rows = json.load(f)
        keys = self.domain.input_keys
        self.candidates = np.array(
            [
                [self._encode(i, row[k]) for i, k in enumerate(keys)]
                for row in rows
            ],
            np.float64,
        )
        self.targets = np.array([float(row[target]) for row in rows], np.float64)
        if negate:
            self.targets = -self.targets

    def _encode(self, idx, v):
        cats = {0: A_ELE, 1: M_ELE, 2: X_ELE}
        if idx in cats and isinstance(v, str):
            return float(cats[idx].index(v))
        return float(v)

    def _f(self, X):
        # nearest-candidate lookup (exact-match semantics in the reference)
        out = np.empty(X.shape[0])
        for i, row in enumerate(X):
            d = np.abs(self.candidates - row[None, :]).sum(axis=1)
            out[i] = self.targets[int(np.argmin(d))]
        return out

    def sample_candidates(self, n, rng=None):
        """Discrete candidate set access for bandit-style drivers."""
        rng = rng or np.random.default_rng()
        idx = rng.choice(len(self.candidates), size=n, replace=False)
        return self.candidates[idx].astype(np.float32), idx

    def f_by_idx(self, idx):
        return self.targets[idx]

    def get_optima(self):
        i = int(np.argmin(self.targets))
        return self.candidates[i].astype(np.float32), float(self.targets[i])
