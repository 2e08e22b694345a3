"""Construction-time strategy capability validation.

Parity: src/bofire_mixed/data_models/strategies/tree_kernel.py:66-86 —
strategies declare supported constraint/feature types and constructing
one on an unsupported domain fails immediately with a clear message
(misuse previously surfaced as a deep failure or the silent
random-fallback warning).
"""

import numpy as np
import pytest

from bark_jax.constraints import (
    FunctionalInequalityConstraint,
    LinearEqualityConstraint,
    LinearInequalityConstraint,
    NChooseKConstraint,
)
from bark_jax.domain import CategoricalInput, ContinuousInput, Domain
from bark_jax.strategies.baselines import GridUCBStrategy, RelaxedGPStrategy
from bark_jax.strategies.capabilities import (
    supports_constraint,
    supports_feature,
    validate_domain,
)
from bark_jax.strategies.tree_kernel import RandomStrategy, TreeKernelStrategy


def _constrained_domain():
    return Domain(
        [
            ContinuousInput("x_0", (0.0, 1.0)),
            ContinuousInput("x_1", (0.0, 1.0)),
        ],
        constraints=(
            LinearInequalityConstraint(
                features=["x_0", "x_1"], coefficients=[1.0, 1.0], rhs=1.5
            ),
        ),
    )


def test_tree_kernel_accepts_constrained_domain():
    strat = TreeKernelStrategy(_constrained_domain(), seed=0)
    assert strat.domain is not None


def test_unconstrained_baselines_reject_constrained_domain():
    dom = _constrained_domain()
    for cls in (RelaxedGPStrategy, GridUCBStrategy):
        with pytest.raises(ValueError, match="does not support"):
            cls(dom)


def test_random_strategy_unrestricted():
    # rejection sampling handles every constraint family
    strat = RandomStrategy(_constrained_domain(), seed=0)
    X = strat.ask(4)
    assert X.shape == (4, 2)


def test_capability_queries():
    assert supports_constraint(TreeKernelStrategy, LinearInequalityConstraint)
    # subclass semantics: equality rides the inequality machinery
    assert supports_constraint(TreeKernelStrategy, LinearEqualityConstraint)
    assert supports_constraint(TreeKernelStrategy, NChooseKConstraint)
    assert supports_constraint(
        TreeKernelStrategy, FunctionalInequalityConstraint
    )
    assert not supports_constraint(RelaxedGPStrategy, LinearInequalityConstraint)
    assert supports_feature(TreeKernelStrategy, CategoricalInput)
    assert supports_feature(RelaxedGPStrategy, ContinuousInput)
    assert supports_constraint(RandomStrategy, NChooseKConstraint)


def test_validate_domain_message_names_offender():
    with pytest.raises(ValueError) as exc:
        validate_domain(RelaxedGPStrategy, _constrained_domain())
    msg = str(exc.value)
    assert "RelaxedGPStrategy" in msg
    assert "LinearInequalityConstraint" in msg


def test_external_strategy_without_declarations_is_unrestricted():
    class External:
        pass

    validate_domain(External, _constrained_domain())  # must not raise
