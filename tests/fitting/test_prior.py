"""Prior-sampler distribution tests.

The ancestral sampler must reproduce the BARK depth prior: a node at depth d
splits with probability alpha(1+d)^-beta (bark_prior_sampler.py:15-65).
"""

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.domain import CategoricalInput, ContinuousInput, Domain
from bark_jax.fitting.prior import sample_forest_prior, sample_noise_prior


def test_root_split_frequency_matches_prior():
    dom = Domain([ContinuousInput("x", (0.0, 1.0))])
    bounds = jnp.asarray(dom.bounds("bitmask"))
    ft = jnp.asarray(dom.feature_types())

    alpha, beta = 0.95, 2.0
    forest = sample_forest_prior(
        jax.random.key(0), m=200, bounds=bounds, feat_types=ft,
        alpha=alpha, beta=beta, num_samples=5,
    )
    # fraction of trees whose root split: expect alpha (depth 0)
    root_split = 1.0 - np.asarray(forest.is_leaf[..., 0]).mean()
    assert abs(root_split - alpha) < 0.05

    # depth-1 nodes (children of split roots) split w.p. alpha * 2^-beta
    is_leaf = np.asarray(forest.is_leaf)
    active = np.asarray(forest.active)
    depth = np.asarray(forest.depth)
    d1 = active & (depth == 1)
    d1_split_frac = (~is_leaf & d1).sum() / max(d1.sum(), 1)
    expect = alpha * 2 ** (-beta)
    assert abs(d1_split_frac - expect) < 0.05


def test_prior_trees_are_valid():
    dom = Domain(
        [
            ContinuousInput("x", (0.0, 1.0)),
            CategoricalInput("c", ("a", "b", "c")),
        ]
    )
    bounds = jnp.asarray(dom.bounds("bitmask"))
    ft = jnp.asarray(dom.feature_types())
    forest = sample_forest_prior(
        jax.random.key(1), m=50, bounds=bounds, feat_types=ft, num_samples=3
    )
    active = np.asarray(forest.active)
    is_leaf = np.asarray(forest.is_leaf)
    n_active = active.sum(axis=-1)
    n_leaves = (active & is_leaf).sum(axis=-1)
    np.testing.assert_array_equal(n_active, 2 * n_leaves - 1)

    # categorical thresholds on split nodes must be valid non-empty subsets
    feature = np.asarray(forest.feature)
    thr = np.asarray(forest.threshold).astype(np.int64)
    cat_splits = active & ~is_leaf & (feature == 1)
    assert (thr[cat_splits] > 0).all()
    assert (thr[cat_splits] < 0b111).all() or (thr[cat_splits] <= 0b111).all()


def test_noise_prior_moments():
    shape, rate = 2.5, 9.0
    draws = np.asarray(
        sample_noise_prior(jax.random.key(2), shape, rate, 20000)
    )
    np.testing.assert_allclose(draws.mean(), shape / rate, rtol=0.05)
    np.testing.assert_allclose(draws.var(), shape / rate**2, rtol=0.1)
