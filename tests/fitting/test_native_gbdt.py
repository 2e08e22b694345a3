"""Tests for the native (C++) GBDT booster and its Forest import.

The native booster is the framework's own equivalent of the reference's
LightGBM dependency (src/bark/fitting/lgbm_fitting.py:15-47). Oracles:
training-set fit quality on a known function, exact agreement between the
C++ router and the JAX forest router on imported trees, and recovery of a
non-contiguous categorical subset (the capability sklearn's ordinal splits
lack).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from bark_jax import native
from bark_jax.domain import CategoricalInput, ContinuousInput, Domain
from bark_jax.fitting.booster import fit_booster_forest
from bark_jax.forest import route_forest

pytestmark = pytest.mark.skipif(
    not native.gbdt_available(), reason="no C++ toolchain on this host"
)


def _data(n=200, seed=0):
    rng = np.random.default_rng(seed)
    X = np.column_stack(
        [rng.uniform(0, 1, n), rng.uniform(0, 1, n), rng.integers(0, 5, n)]
    ).astype(np.float32)
    y = (
        np.sin(4 * X[:, 0])
        + 0.5 * X[:, 1]
        + np.where(np.isin(X[:, 2].astype(int), [1, 3]), 1.5, -0.5)
    ).astype(np.float32)
    ft = np.array([2, 2, 0], np.int32)
    cs = np.array([0, 0, 5], np.int32)
    return X, y, ft, cs


def test_fit_quality_and_leaf_values():
    X, y, ft, cs = _data()
    arrs = native.fit_gbdt(X, y, ft, cs, num_rounds=50, max_depth=3)
    _, pred = native.predict_gbdt(X, arrs, ft)
    assert np.mean((pred - y) ** 2) < 0.05 * np.var(y)


def test_categorical_subset_recovery():
    """The only informative categorical structure is the subset {1, 3};
    the booster's first tree must separate exactly that subset (as the mask
    or its complement) — sklearn's ordinal prefix splits cannot express it."""
    rng = np.random.default_rng(3)
    n = 400
    X = np.column_stack(
        [rng.uniform(0, 1, n), rng.integers(0, 5, n)]
    ).astype(np.float32)
    y = np.where(np.isin(X[:, 1].astype(int), [1, 3]), 1.0, -1.0).astype(
        np.float32
    )
    ft = np.array([2, 0], np.int32)
    cs = np.array([0, 5], np.int32)
    arrs = native.fit_gbdt(X, y, ft, cs, num_rounds=1, max_depth=1)
    root_feat = arrs["feature"][0, 0]
    mask = int(arrs["threshold"][0, 0])
    assert root_feat == 1
    subset = 0b01010  # {1, 3}
    assert mask in (subset, 0b11111 ^ subset)


def test_router_agreement_with_jax_forest():
    """C++ routing and the JAX fixed-trip router agree on imported trees."""
    X, y, ft, cs = _data(seed=1)
    arrs = native.fit_gbdt(X, y, ft, cs, num_rounds=20, max_depth=3)
    leaves_native, _ = native.predict_gbdt(X, arrs, ft)
    from bark_jax.forest import forest_from_numpy

    forest = forest_from_numpy({k: v for k, v in arrs.items() if k != "leaf_value"})
    leaves_jax = np.asarray(
        route_forest(forest, jnp.asarray(X), jnp.asarray(ft))
    )
    np.testing.assert_array_equal(leaves_native, leaves_jax)


def test_booster_forest_import_backends_agree_on_kernel_shape():
    domain = Domain(
        [
            ContinuousInput("x0", (0.0, 1.0)),
            CategoricalInput("c", ("a", "b", "c", "d")),
        ]
    )
    rng = np.random.default_rng(1)
    X = domain.sample(60, rng)
    y = np.sin(5 * X[:, 0]) + (X[:, 1] == 2).astype(float)
    for backend in ("native", "sklearn"):
        f = fit_booster_forest(X, y, domain, backend=backend)
        assert f.is_leaf.shape == (50, 64)
        # every active non-leaf has two active children
        act = np.asarray(f.active)
        nl = act & ~np.asarray(f.is_leaf)
        for t in range(f.is_leaf.shape[0]):
            for nid in np.where(nl[t])[0]:
                assert act[t, np.asarray(f.left)[t, nid]]
                assert act[t, np.asarray(f.right)[t, nid]]
