"""Forest encoding, routing, and Gram matrix tests.

Oracles are small clean-room numpy implementations of the reference
semantics (src/bark/forest.py:28-111): per-point tree descent with bitmask
categorical tests, and an elementwise leaf-agreement count.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from bark_jax.forest import (
    FEAT_CAT,
    FEAT_CONT,
    FEAT_INT,
    batched_forest_gram_matrix,
    batched_forest_gram_matrix_no_null,
    create_empty_forest,
    forest_gram_matrix,
    gram_from_leaves,
    route_forest,
)
from bark_jax.utils.build import LEAF, build_forest


def np_route_one(tree_arrays, x, feat_types):
    """Numpy oracle for single-point routing (spec: forest.py:28-47)."""
    idx = 0
    while True:
        if tree_arrays["is_leaf"][idx]:
            return idx
        f = tree_arrays["feature"][idx]
        thr = tree_arrays["threshold"][idx]
        if feat_types[f] == FEAT_CAT:
            go_left = bool((1 << int(x[f])) & int(thr))
        else:
            go_left = x[f] <= thr
        idx = tree_arrays["left"][idx] if go_left else tree_arrays["right"][idx]


def demo_forest():
    """Mixed-feature forest: cont split, cat bitmask split, int split."""
    specs = [
        ("split", 0, 0.5, LEAF, ("split", 0, 0.75, LEAF, LEAF)),
        # cat feature 1 with 4 cats; mask 0b0101 sends cats {0, 2} left
        ("split", 1, float(0b0101), LEAF, LEAF),
        # int feature 2 over [0, 10]: x <= 4 goes left
        ("split", 2, 4.0, ("split", 0, 0.2, LEAF, LEAF), LEAF),
        LEAF,
    ]
    feat_types = np.array([FEAT_CONT, FEAT_CAT, FEAT_INT], np.int32)
    return specs, feat_types


def sample_X(n, rng):
    return np.stack(
        [
            rng.uniform(0, 1, n),
            rng.integers(0, 4, n),
            rng.integers(0, 11, n),
        ],
        axis=1,
    ).astype(np.float32)


def test_route_forest_matches_numpy_oracle():
    specs, feat_types = demo_forest()
    forest = build_forest(specs)
    rng = np.random.default_rng(0)
    X = sample_X(64, rng)

    got = np.asarray(route_forest(forest, jnp.asarray(X), jnp.asarray(feat_types)))

    from bark_jax.utils.build import build_tree_arrays

    for j, spec in enumerate(specs):
        arrs = build_tree_arrays(spec)
        expect = np.array([np_route_one(arrs, x, feat_types) for x in X])
        np.testing.assert_array_equal(got[:, j], expect)


def test_gram_matrix_matches_bruteforce():
    specs, feat_types = demo_forest()
    forest = build_forest(specs)
    rng = np.random.default_rng(1)
    X1, X2 = sample_X(40, rng), sample_X(17, rng)

    K = np.asarray(
        forest_gram_matrix(
            forest, jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(feat_types)
        )
    )

    leaves1 = np.asarray(route_forest(forest, jnp.asarray(X1), jnp.asarray(feat_types)))
    leaves2 = np.asarray(route_forest(forest, jnp.asarray(X2), jnp.asarray(feat_types)))
    expect = (leaves1[:, None, :] == leaves2[None, :, :]).mean(axis=-1)
    np.testing.assert_allclose(K, expect, atol=1e-6)


def test_gram_diag_is_one():
    specs, feat_types = demo_forest()
    forest = build_forest(specs)
    rng = np.random.default_rng(2)
    X = sample_X(20, rng)
    K = np.asarray(
        forest_gram_matrix(forest, jnp.asarray(X), jnp.asarray(X), jnp.asarray(feat_types))
    )
    np.testing.assert_allclose(np.diag(K), 1.0, atol=1e-6)
    # PSD check: agreement kernel is an average of one-hot outer products
    eigs = np.linalg.eigvalsh(K)
    assert eigs.min() > -1e-5


def test_empty_forest_routes_to_root():
    forest = create_empty_forest(3)
    X = jnp.asarray(np.random.default_rng(0).uniform(size=(5, 2)).astype(np.float32))
    ft = jnp.asarray(np.array([FEAT_CONT, FEAT_CONT], np.int32))
    leaves = np.asarray(route_forest(forest, X, ft))
    np.testing.assert_array_equal(leaves, 0)
    K = np.asarray(forest_gram_matrix(forest, X, X, ft))
    np.testing.assert_allclose(K, 1.0)


def test_no_null_rescaling():
    """Parity with forest.py:101-111: null trees contribute a constant 1/m
    which is subtracted and the rest rescaled."""
    specs, feat_types = demo_forest()
    forest = build_forest(specs)  # tree 3 is a null (single-leaf) tree
    rng = np.random.default_rng(3)
    X = sample_X(25, rng)

    batched = jnp.asarray
    f_b = type(forest)(*[a[None] for a in forest])  # batch of 1
    K = np.asarray(
        batched_forest_gram_matrix(f_b, batched(X), batched(X), jnp.asarray(feat_types))
    )[0]
    K_nn = np.asarray(
        batched_forest_gram_matrix_no_null(
            f_b, batched(X), batched(X), jnp.asarray(feat_types)
        )
    )[0]

    m, n_null = 4, 1
    expect = (K - n_null / m) * (m / (m - n_null))
    np.testing.assert_allclose(K_nn, expect, atol=1e-6)
    np.testing.assert_allclose(np.diag(K_nn), 1.0, atol=1e-6)


@pytest.mark.parametrize("n,m_pts", [(8, 8), (33, 7)])
def test_gram_from_leaves_cross(n, m_pts):
    rng = np.random.default_rng(4)
    leaves1 = rng.integers(0, 64, size=(n, 5))
    leaves2 = rng.integers(0, 64, size=(m_pts, 5))
    K = np.asarray(gram_from_leaves(jnp.asarray(leaves1), jnp.asarray(leaves2), 64))
    expect = (leaves1[:, None, :] == leaves2[None, :, :]).mean(axis=-1)
    np.testing.assert_allclose(K, expect, atol=1e-6)


def test_route_forest_select_matches_gather_walk():
    """One-hot transition-matmul routing == the gather-loop walk, on a
    mixed continuous/categorical prior forest (either may be a platform's
    router, forest.router_for)."""
    import jax

    from bark_jax.benchmarks.tree_function import TreeFunction
    from bark_jax.fitting.prior import sample_forest_prior
    from bark_jax.forest import route_forest, route_forest_select

    bench = TreeFunction(dim=3, cat_dim=2, num_cat=5, m=12, function_seed=3)
    ft = jnp.asarray(bench.domain.feature_types())
    bounds = jnp.asarray(bench.domain.bounds("bitmask"))
    forest = sample_forest_prior(
        jax.random.key(5), 12, bounds, ft, num_samples=3, node_limit=32
    )
    X = jnp.asarray(
        bench.domain.sample(257, np.random.default_rng(0)), jnp.float32
    )
    for s in range(3):
        tree = jax.tree.map(lambda a: a[s], forest)
        a = route_forest(tree, X, ft)
        b = route_forest_select(tree, X, ft)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_route_forest_select_chunked_matches_gather_walk():
    """Past 2048 rows the select router chunks the walk through a lax.map
    (the unchunked transients ran out of device memory at (128 chains,
    4096)); results
    must stay identical to the gather walk, including the padded tail of a
    non-multiple block count."""
    import jax

    from bark_jax.benchmarks.tree_function import TreeFunction
    from bark_jax.fitting.prior import sample_forest_prior
    from bark_jax.forest import route_forest, route_forest_select

    bench = TreeFunction(dim=3, cat_dim=1, num_cat=4, m=8, function_seed=3)
    ft = jnp.asarray(bench.domain.feature_types())
    bounds = jnp.asarray(bench.domain.bounds("bitmask"))
    tree = jax.tree.map(
        lambda a: a[0],
        sample_forest_prior(jax.random.key(5), 8, bounds, ft, node_limit=32),
    )
    X = jnp.asarray(
        bench.domain.sample(2500, np.random.default_rng(0)), jnp.float32
    )
    a = route_forest(tree, X, ft)
    b = route_forest_select(tree, X, ft)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
