"""Node-mask and subspace tests against hand-built trees.

Oracle semantics: src/bark/fitting/tree_traversal.py:28-86.
"""

import jax.numpy as jnp
import numpy as np

from bark_jax.fitting.traversal import (
    node_subspace,
    singly_internal_mask,
    terminal_mask,
)
from bark_jax.forest import FEAT_CAT, FEAT_CONT, FEAT_INT
from bark_jax.utils.build import LEAF, build_forest


def get_tree(forest, j):
    import jax

    return jax.tree.map(lambda a: a[j], forest)


def test_masks():
    forest = build_forest(
        [
            # node0: split -> node1 leaf, node2: split -> leaves 3,4
            ("split", 0, 0.5, LEAF, ("split", 0, 0.75, LEAF, LEAF)),
            LEAF,
        ]
    )
    t0 = get_tree(forest, 0)
    term = np.asarray(terminal_mask(t0))
    si = np.asarray(singly_internal_mask(t0))
    assert list(np.nonzero(term)[0]) == [1, 3, 4]
    assert list(np.nonzero(si)[0]) == [2]

    t1 = get_tree(forest, 1)
    assert list(np.nonzero(np.asarray(terminal_mask(t1)))[0]) == [0]
    assert not np.asarray(singly_internal_mask(t1)).any()


def test_subspace_continuous_chain():
    # x0 <= 0.5 -> left; within right branch x0 <= 0.75 -> left
    forest = build_forest(
        [("split", 0, 0.5, LEAF, ("split", 0, 0.75, LEAF, LEAF))]
    )
    tree = get_tree(forest, 0)
    bounds = jnp.asarray(np.array([[0.0, 1.0]], np.float32))
    ft = jnp.asarray(np.array([FEAT_CONT], np.int32))

    # node 3 = left child of the inner split: 0.5 < x0 <= 0.75
    sub = np.asarray(node_subspace(tree, jnp.int32(3), bounds, ft, 16))
    np.testing.assert_allclose(sub[0], [0.5, 0.75], atol=1e-6)
    # node 1 = root's left leaf: x0 <= 0.5
    sub = np.asarray(node_subspace(tree, jnp.int32(1), bounds, ft, 16))
    np.testing.assert_allclose(sub[0], [0.0, 0.5], atol=1e-6)
    # root: full bounds
    sub = np.asarray(node_subspace(tree, jnp.int32(0), bounds, ft, 16))
    np.testing.assert_allclose(sub[0], [0.0, 1.0], atol=1e-6)


def test_subspace_categorical_bitmask():
    # 5 cats, mask 0b00101 goes left; right keeps complement within bounds
    forest = build_forest([("split", 0, float(0b00101), LEAF, LEAF)])
    tree = get_tree(forest, 0)
    bounds = jnp.asarray(np.array([[0.0, float(0b11111)]], np.float32))
    ft = jnp.asarray(np.array([FEAT_CAT], np.int32))

    left = np.asarray(node_subspace(tree, jnp.int32(1), bounds, ft, 16))
    right = np.asarray(node_subspace(tree, jnp.int32(2), bounds, ft, 16))
    assert int(left[0, 1]) == 0b00101
    assert int(right[0, 1]) == 0b11010


def test_subspace_categorical_nested_complement():
    # nested: first split mask 0b0111 (left); inside, split 0b0010:
    # right child of inner = complement of 0b0010 within current ub 0b0111
    forest = build_forest(
        [("split", 0, float(0b0111), ("split", 0, float(0b0010), LEAF, LEAF), LEAF)]
    )
    tree = get_tree(forest, 0)
    bounds = jnp.asarray(np.array([[0.0, float(0b1111)]], np.float32))
    ft = jnp.asarray(np.array([FEAT_CAT], np.int32))

    # node indices: 0 root, 1 inner split, 2 right leaf of root,
    # 3/4 = children of inner
    right_inner = np.asarray(node_subspace(tree, jnp.int32(4), bounds, ft, 16))
    # reference walk: at inner split, ub becomes (npo2(0b0111)-1 - 0b0010) & 0b0111?
    # walk order is child->root: first intersect with full bounds at inner,
    # then with root's mask. Walking from node 4: parent=1 (mask 0b0010,
    # node4 is right): ub = (npo2(0b1111)-1 - 0b0010) & 0b1111 = 0b1101;
    # then parent=0 (mask 0b0111, node1 is left): ub = 0b0111 & 0b1101 = 0b0101
    assert int(right_inner[0, 1]) == 0b0101


def test_subspace_integer_delta():
    # int feature: right child of "x <= 4" has lower bound 5
    forest = build_forest([("split", 0, 4.0, LEAF, LEAF)])
    tree = get_tree(forest, 0)
    bounds = jnp.asarray(np.array([[0.0, 10.0]], np.float32))
    ft = jnp.asarray(np.array([FEAT_INT], np.int32))

    left = np.asarray(node_subspace(tree, jnp.int32(1), bounds, ft, 16))
    right = np.asarray(node_subspace(tree, jnp.int32(2), bounds, ft, 16))
    np.testing.assert_allclose(left[0], [0.0, 4.0])
    np.testing.assert_allclose(right[0], [5.0, 10.0])


def test_incremental_subspaces_match_walk():
    """The sampler's O(1) incremental subspace maintenance
    (child_subspaces applied on grow/change) must stay bit-exact with the
    parent-chain walk across long sequences of structural edits, over
    mixed cont/int/cat features."""
    import jax

    from bark_jax.domain import (
        CategoricalInput,
        ContinuousInput,
        Domain,
        IntegerInput,
    )
    from bark_jax.fitting.params import SamplerParams
    from bark_jax.fitting.proposals import propose_tree_packed
    from bark_jax.fitting.traversal import all_node_subspaces
    from bark_jax.forest import create_empty_forest, pack_forest, unpack_forest

    dom = Domain(
        [
            ContinuousInput("x", (0.0, 1.0)),
            IntegerInput("i", (0, 7)),
            CategoricalInput("c", tuple("abcdef")),
        ]
    )
    bounds = jnp.asarray(dom.bounds("bitmask"))
    ft = jnp.asarray(dom.feature_types())
    params = SamplerParams(num_trees=1)
    tree = jax.tree.map(lambda a: a[0], create_empty_forest(1, params.node_limit))
    packed = pack_forest(tree)
    subs = all_node_subspaces(tree, bounds, ft, params.max_depth)

    key = jax.random.key(0)
    for i in range(120):
        key, k = jax.random.split(key)
        new_packed, new_subs, lqp, _, _ = propose_tree_packed(
            k, packed, bounds, ft, params, subspace_tree=subs
        )
        if np.isfinite(float(lqp)):  # accept every valid proposal
            packed, subs = new_packed, new_subs
        if i % 20 == 19:
            t = unpack_forest(packed)
            ref = all_node_subspaces(t, bounds, ft, params.max_depth)
            act = np.asarray(t.active)
            np.testing.assert_array_equal(
                np.asarray(ref)[act], np.asarray(subs)[act]
            )
