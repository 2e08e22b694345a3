"""Constrained continuous benchmarks with known optima.

Parity: src/bofire_mixed/benchmarks/constrained.py:19-570 (G1, G3, G4, G6,
G7, G10, Alkylation) — standard constrained test problems; constraints are
expressed through bark_jax.constraints and consumed by the acquisition
search's penalty/feasibility machinery.
"""

from __future__ import annotations

import numpy as np

from bark_jax.benchmarks.base import Benchmark, register_benchmark
from bark_jax.constraints import (
    FunctionalEqualityConstraint,
    FunctionalInequalityConstraint,
    LinearInequalityConstraint,
)
from bark_jax.domain import ContinuousInput, Domain


@register_benchmark("G1")
class G1(Benchmark):
    """Parity: constrained.py:19-88; optimum -15 at the known point."""

    def __init__(self, **kwargs):
        lin = [
            (["x_0", "x_1", "x_9", "x_10"], [2, 2, 1, 1], 10),
            (["x_0", "x_2", "x_9", "x_11"], [2, 2, 1, 1], 10),
            (["x_1", "x_2", "x_10", "x_11"], [2, 2, 1, 1], 10),
            (["x_0", "x_9"], [-8, 1], 0),
            (["x_1", "x_10"], [-8, 1], 0),
            (["x_2", "x_11"], [-3, 1], 0),
            (["x_3", "x_4", "x_9"], [-2, -1, 1], 0),
            (["x_5", "x_6", "x_10"], [-2, -1, 1], 0),
            (["x_7", "x_8", "x_11"], [-2, -1, 1], 0),
        ]
        super().__init__(
            Domain(
                [
                    ContinuousInput(
                        f"x_{i}", (0.0, 100.0 if i in {9, 10, 11} else 1.0)
                    )
                    for i in range(13)
                ],
                constraints=tuple(
                    LinearInequalityConstraint(
                        features=f, coefficients=c, rhs=r
                    )
                    for f, c, r in lin
                ),
            )
        )

    def _f(self, X):
        return (
            5 * np.sum(X[:, :4], axis=1)
            - 5 * np.sum(X[:, :4] ** 2, axis=1)
            - np.sum(X[:, 4:], axis=1)
        )

    def get_optima(self):
        x = np.array(
            [3 if i in {9, 10, 11} else 1 for i in range(13)], np.float32
        )
        return x, -15.0


@register_benchmark("G3")
class G3(Benchmark):
    """Parity: constrained.py:91-130; equality-constrained product max."""

    def __init__(self, dim=5, **kwargs):
        self.dim = dim
        super().__init__(
            Domain(
                [ContinuousInput(f"x_{i}", (0.0, 1.0)) for i in range(dim)],
                constraints=(
                    FunctionalEqualityConstraint(
                        func=lambda x: float(np.sum(x[: self.dim] ** 2)), rhs=1.0
                    ),
                ),
            )
        )

    def _f(self, X):
        z = np.sqrt(self.dim) ** self.dim
        return z * np.prod(X, axis=1)

    def get_optima(self):
        x = np.full(self.dim, 1 / np.sqrt(self.dim), np.float32)
        return x, 1.0


def _g4_u(x):
    return (
        85.334407
        + 0.0056858 * x[1] * x[4]
        + 0.0006262 * x[0] * x[3]
        - 0.0022053 * x[2] * x[4]
    )


def _g4_v(x):
    return (
        80.51249
        + 0.0071317 * x[1] * x[4]
        + 0.0029955 * x[0] * x[1]
        + 0.0021813 * x[2] ** 2
    )


def _g4_w(x):
    return (
        9.300961
        + 0.0047026 * x[2] * x[4]
        + 0.0012547 * x[0] * x[2]
        + 0.0019085 * x[2] * x[3]
    )


@register_benchmark("G4")
class G4(Benchmark):
    """Parity: constrained.py:133-214; optimum -30665.539."""

    def __init__(self, **kwargs):
        super().__init__(
            Domain(
                [
                    ContinuousInput("x_0", (78.0, 102.0)),
                    ContinuousInput("x_1", (33.0, 45.0)),
                    ContinuousInput("x_2", (27.0, 45.0)),
                    ContinuousInput("x_3", (27.0, 45.0)),
                    ContinuousInput("x_4", (27.0, 45.0)),
                ],
                constraints=(
                    FunctionalInequalityConstraint(lambda x: -_g4_u(x), 0.0),
                    FunctionalInequalityConstraint(lambda x: _g4_u(x), 92.0),
                    FunctionalInequalityConstraint(lambda x: -_g4_v(x), -90.0),
                    FunctionalInequalityConstraint(lambda x: _g4_v(x), 110.0),
                    FunctionalInequalityConstraint(lambda x: -_g4_w(x), -20.0),
                    FunctionalInequalityConstraint(lambda x: _g4_w(x), 25.0),
                ),
            )
        )

    def _f(self, X):
        return (
            5.3578547 * X[:, 2] ** 2
            + 0.8356891 * X[:, 0] * X[:, 4]
            + 37.293239 * X[:, 0]
            - 40792.141
        )

    def get_optima(self):
        return np.array([78, 33, 29.995, 45, 36.7758], np.float32), -30665.539


@register_benchmark("G6")
class G6(Benchmark):
    """Parity: constrained.py:217-249."""

    def __init__(self, **kwargs):
        super().__init__(
            Domain(
                [
                    ContinuousInput("x_0", (13.0, 100.0)),
                    ContinuousInput("x_1", (0.0, 100.0)),
                ],
                constraints=(
                    FunctionalInequalityConstraint(
                        lambda x: -((x[0] - 5) ** 2) - (x[1] - 5) ** 2, -100.0
                    ),
                    FunctionalInequalityConstraint(
                        lambda x: (x[0] - 6) ** 2 + (x[1] - 5) ** 2, 82.81
                    ),
                ),
            )
        )

    def _f(self, X):
        return (X[:, 0] - 10) ** 3 + (X[:, 1] - 20) ** 3


@register_benchmark("G7")
class G7(Benchmark):
    """Parity: constrained.py:252-341; optimum 24.3062091."""

    def __init__(self, **kwargs):
        lin = [
            (["x_0", "x_1", "x_6", "x_7"], [4, 5, -3, 9], 105.0),
            (["x_0", "x_1", "x_6", "x_7"], [10, -8, -17, 2], 0.0),
            (["x_0", "x_1", "x_8", "x_9"], [-8, 2, 5, -2], 12.0),
        ]
        funcs = [
            (
                lambda x: 3 * (x[0] - 2) ** 2
                + 4 * (x[1] - 3) ** 2
                + 2 * x[2] ** 2
                - 7 * x[3],
                120.0,
            ),
            (lambda x: 5 * x[0] ** 2 + 8 * x[1] + (x[2] - 6) ** 2 - 2 * x[3], 40.0),
            (
                lambda x: 0.5 * (x[0] - 8) ** 2
                + 2 * (x[1] - 4) ** 2
                + 3 * x[4] ** 2
                - x[5],
                30.0,
            ),
            (
                lambda x: x[0] ** 2
                + 2 * (x[1] - 2) ** 2
                - 2 * x[0] * x[1]
                + 14 * x[4]
                - 6 * x[5],
                0.0,
            ),
            (lambda x: -3 * x[0] + 6 * x[1] + 12 * (x[8] - 8) ** 2 - 7 * x[9], 0.0),
        ]
        super().__init__(
            Domain(
                [ContinuousInput(f"x_{i}", (-10.0, 10.0)) for i in range(10)],
                constraints=(
                    *(
                        LinearInequalityConstraint(
                            features=f, coefficients=c, rhs=r
                        )
                        for f, c, r in lin
                    ),
                    *(
                        FunctionalInequalityConstraint(func, rhs)
                        for func, rhs in funcs
                    ),
                ),
            )
        )

    def _f(self, X):
        return (
            X[:, 0] ** 2
            + X[:, 1] ** 2
            + X[:, 0] * X[:, 1]
            - 14 * X[:, 0]
            - 16 * X[:, 1]
            + (X[:, 2] - 10) ** 2
            + 4 * (X[:, 3] - 5) ** 2
            + (X[:, 4] - 3) ** 2
            + 2 * (X[:, 5] - 1) ** 2
            + 5 * X[:, 6] ** 2
            + 7 * (X[:, 7] - 11) ** 2
            + 2 * (X[:, 8] - 10) ** 2
            + (X[:, 9] - 7) ** 2
            + 45
        )


@register_benchmark("G10")
class G10(Benchmark):
    """Parity: constrained.py:344-431; optimum 7049.3307."""

    def __init__(self, **kwargs):
        lb = [100.0, 1000.0, 1000.0, 10.0, 10.0, 10.0, 10.0, 10.0]
        ub = [10000.0, 10000.0, 10000.0, 1000.0, 1000.0, 1000.0, 1000.0, 1000.0]
        super().__init__(
            Domain(
                [
                    ContinuousInput(f"x_{i}", (lb[i], ub[i]))
                    for i in range(8)
                ],
                constraints=(
                    LinearInequalityConstraint(
                        features=["x_3", "x_5"], coefficients=[1.0, 1.0], rhs=400.0
                    ),
                    LinearInequalityConstraint(
                        features=["x_3", "x_4", "x_6"],
                        coefficients=[-1.0, 1.0, 1.0],
                        rhs=400.0,
                    ),
                    LinearInequalityConstraint(
                        features=["x_4", "x_7"], coefficients=[-1.0, 1.0], rhs=100.0
                    ),
                    FunctionalInequalityConstraint(
                        lambda x: 100 * x[0] - x[0] * x[5] + 833.33252 * x[3],
                        83333.333,
                    ),
                    FunctionalInequalityConstraint(
                        lambda x: x[1] * x[3]
                        - x[1] * x[6]
                        - 1250 * x[3]
                        + 1250 * x[4],
                        0.0,
                    ),
                    FunctionalInequalityConstraint(
                        lambda x: x[2] * x[4] - x[2] * x[7] - 2500 * x[4],
                        -1250000,
                    ),
                ),
            )
        )

    def _f(self, X):
        return X[:, 0] + X[:, 1] + X[:, 2]

    def get_optima(self):
        x = np.array(
            [579.3167, 1359.943, 5110.071, 182.0174, 295.5985, 217.9799,
             286.4162, 395.5979],
            np.float32,
        )
        return x, 7049.3307


def _alk_x5(x):
    return 1.22 * x[3] - x[0]


def _alk_x6(x):
    # x[2] = x[3] = 0 (both lower bounds) makes this 0/0; everywhere else
    # denom >= 1000*x[2] > 0 bounds the ratio by 98. Evaluate the division
    # only where the denominator is nonzero (the corner's limit along any
    # x[2] -> 0 path is 0) so feasibility sampling never emits NaN or a
    # RuntimeWarning.
    num = 98000.0 * x[2]
    denom = x[3] * x[5] + 1000.0 * x[2]
    safe = denom > 0
    return np.where(safe, num / np.where(safe, denom, 1.0), 0.0)


def _alk_x8(x):
    return (x[1] + _alk_x5(x)) / x[0]


@register_benchmark("Alkylation")
class Alkylation(Benchmark):
    """Alkylation process profit (constrained.py:434-570); max profit
    1768.75 (minimized as its negation)."""

    def __init__(self, **kwargs):
        lb = [0.1, 0.0, 0.0, 0.0, 90.0, 0.01, 145.0]
        ub = [2000.0, 16000.0, 120.0, 5000.0, 95.0, 4.0, 162.0]

        def g1(x):
            x8 = _alk_x8(x)
            return 0.99 * x[3] - (x[0] * (1.12 + 0.13167 * x8 - 0.00667 * x8**2))

        def g2(x):
            x8 = _alk_x8(x)
            return (x[0] * (1.12 + 0.13167 * x8 - 0.00667 * x8**2)) - (
                100.0 / 99.0
            ) * x[3]

        def g3(x):
            x6, x8 = _alk_x6(x), _alk_x8(x)
            return 0.99 * x[4] - (
                86.35 + 1.098 * x8 - 0.038 * x8**2 + 0.325 * (x6 - 89.0)
            )

        def g4(x):
            x6, x8 = _alk_x6(x), _alk_x8(x)
            return (
                86.35 + 1.098 * x8 - 0.038 * x8**2 + 0.325 * (x6 - 89.0)
            ) - (100.0 / 99.0) * x[4]

        def g5(x):
            return 0.9 * x[5] - (35.82 - 0.222 * x[6])

        def g6(x):
            return (35.82 - 0.222 * x[6]) - (10.0 / 9.0) * x[5]

        def g7(x):
            return 0.99 * x[6] - (-133 + 3 * x[4])

        def g8(x):
            return (-133 + 3.0 * x[4]) - (100.0 / 99.0) * x[6]

        aux = [
            (lambda x: _alk_x5(x) - 2000, 0.0),
            (lambda x: -_alk_x5(x), 0.0),
            (lambda x: _alk_x6(x) - 93.0, 0.0),
            (lambda x: 85.0 - _alk_x6(x), 0.0),
            (lambda x: _alk_x8(x) - 12.0, 0.0),
            (lambda x: 3.0 - _alk_x8(x), 0.0),
        ]
        super().__init__(
            Domain(
                [
                    ContinuousInput(f"x_{i}", (lb[i], ub[i]))
                    for i in range(7)
                ],
                constraints=(
                    *(
                        FunctionalInequalityConstraint(g, 0.0)
                        for g in (g1, g2, g3, g4, g5, g6, g7, g8)
                    ),
                    *(
                        FunctionalInequalityConstraint(g, r)
                        for g, r in aux
                    ),
                ),
            )
        )

    def _f(self, X):
        x5 = 1.22 * X[:, 3] - X[:, 0]
        return -(
            0.063 * X[:, 3] * X[:, 4]
            - 5.04 * X[:, 0]
            - 0.035 * X[:, 1]
            - 10.0 * X[:, 2]
            - 3.36 * x5
        )

    def get_optima(self):
        x = np.array(
            [1698.1, 15819, 54.107, 3031.2, 95.000, 1.5618, 153.54], np.float32
        )
        return x, -1768.75
