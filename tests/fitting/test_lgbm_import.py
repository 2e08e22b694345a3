"""LightGBM dump importer: arbitrary-subset categorical splits.

The reference's LightGBM path carries category-
subset splits into the forest encoding; the repo's sklearn fallback
could only express contiguous-prefix masks. `lgbm_dump_to_forest`
consumes the documented ``dump_model()`` JSON (exercised here on
synthetic dumps — lightgbm itself is an optional dependency, guarded
like SMAC/Entmoot) and emits exact bitmask splits, subsets included.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from bark_jax.fitting.booster import fit_booster_forest, lgbm_dump_to_forest
from bark_jax.forest import route_forest


def _dump():
    """Two-tree dump: root subset split {0,2,3} on cat feature 1, then a
    numeric split on feature 0; second tree one-vs-rest category 4."""
    t0 = {
        "split_feature": 1,
        "decision_type": "==",
        "threshold": "0||2||3",
        "left_child": {
            "split_feature": 0,
            "decision_type": "<=",
            "threshold": 0.25,
            "left_child": {"leaf_index": 0, "leaf_value": 1.0},
            "right_child": {"leaf_index": 1, "leaf_value": 2.0},
        },
        "right_child": {"leaf_index": 2, "leaf_value": 3.0},
    }
    t1 = {
        "split_feature": 1,
        "decision_type": "==",
        "threshold": "4",
        "left_child": {"leaf_index": 0, "leaf_value": 0.0},
        "right_child": {"leaf_index": 1, "leaf_value": 1.0},
    }
    return {"tree_info": [
        {"tree_structure": t0}, {"tree_structure": t1},
    ]}


def test_subset_split_bitmask_and_routing():
    forest = lgbm_dump_to_forest(_dump(), node_limit=16)
    thr = np.asarray(forest.threshold)
    assert int(thr[0, 0]) == (1 << 0) + (1 << 2) + (1 << 3)  # {0,2,3}
    assert int(thr[1, 0]) == 1 << 4

    # feature types: x_0 numeric (1), x_1 categorical (0)
    ft = jnp.asarray([1, 0])
    X = jnp.asarray([
        [0.1, 2.0],  # cat 2 in subset, x0 <= 0.25 -> tree0 leaf "1.0" path
        [0.9, 3.0],  # in subset, x0 > 0.25
        [0.5, 1.0],  # cat 1 not in subset -> right leaf
        [0.5, 4.0],  # tree1: category 4 -> left leaf
    ], jnp.float32)
    leaves = np.asarray(route_forest(forest, X, ft, max_depth=4))
    # tree 0: nodes (root=0, left split, its children, right leaf)
    assert leaves[0, 0] != leaves[1, 0]  # numeric split separates them
    assert leaves[2, 0] not in (leaves[0, 0], leaves[1, 0])
    # tree 1: category 4 goes left, others right
    assert leaves[3, 1] != leaves[2, 1]
    assert leaves[0, 1] == leaves[1, 1] == leaves[2, 1]

    # bookkeeping the reference skips: parent/depth filled in
    par = np.asarray(forest.parent)
    dep = np.asarray(forest.depth)
    assert dep[0, 0] == 0
    left0 = int(np.asarray(forest.left)[0, 0])
    assert par[0, left0] == 0 and dep[0, left0] == 1


def test_category_index_beyond_bitmask_range_rejected():
    bad = {"tree_info": [{"tree_structure": {
        "split_feature": 0,
        "decision_type": "==",
        "threshold": "25",
        "left_child": {"leaf_index": 0, "leaf_value": 0.0},
        "right_child": {"leaf_index": 1, "leaf_value": 1.0},
    }}]}
    with pytest.raises(ValueError, match="24-bit"):
        lgbm_dump_to_forest(bad, node_limit=8)


def test_lightgbm_backend_guarded():
    from bark_jax.domain import ContinuousInput, Domain

    dom = Domain([ContinuousInput("x_0", (0.0, 1.0))])
    X = np.random.default_rng(0).uniform(size=(10, 1)).astype(np.float32)
    y = X[:, 0]
    try:
        import lightgbm  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="lightgbm"):
            fit_booster_forest(X, y, dom, backend="lightgbm")
    else:
        forest = fit_booster_forest(X, y, dom, backend="lightgbm")
        assert np.asarray(forest.active)[:, 0].all()
