"""Toy chemistry reaction-yield emulator (mixed cat/cont).

Parity: src/bofire_mixed/benchmarks/reaction_emulator.py:16-110 (itself from
the public BoFire tutorial). The reference has a latent bug (missing
MaximizeObjective import, reaction_emulator.py:104); here yields are negated
into the framework's uniform minimization convention, matching the
reference's ``-y`` output column.
"""

from __future__ import annotations

import numpy as np

from bark_jax.benchmarks.base import Benchmark, register_benchmark
from bark_jax.domain import CategoricalInput, ContinuousInput, Domain

T0, T1 = 25, 100
_E0 = np.exp((T1 + 0) / T0)
_E60 = np.exp((T1 + 60) / T0)
_DE = _E60 - _E0

SOLVENTS = ("MeOH", "THF", "Dioxane")
DENSITY = np.array([0.792, 0.886, 1.03])


def _calc_volume_fact(V):
    x = (V - 20) / 70
    return 0.5 + (x - 0.75) * 0.1 + (x - 0.4) ** 2


def _calc_Tfact(T):
    x = np.exp((T1 + T) / T0)
    return (x - _E0) / _DE


@register_benchmark("ToyReaction")
class ToyReaction(Benchmark):
    def __init__(self, A=25, B=90, **kwargs):
        self.A, self.B = A, B
        super().__init__(
            Domain(
                [
                    ContinuousInput("Temperature", (0.0, 60.0)),
                    CategoricalInput("Solvent Type", SOLVENTS),
                    ContinuousInput("Solvent Volume", (20.0, 90.0)),
                ]
            )
        )

    def _f(self, X):
        T = X[:, 0]
        solvent = X[:, 1].astype(int)
        V = X[:, 2]
        Tfact = _calc_Tfact(T)
        rho = DENSITY[solvent]
        rhofact = (1.5 - rho) * (Tfact + 0.5) / 2
        Vfact = _calc_volume_fact(V)
        y = self.A * Tfact + self.B * rhofact
        y = 0.5 * y + 0.5 * y * Vfact
        return -y
