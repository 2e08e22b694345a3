"""Host-side tree construction helpers (tests, boosters import, goldens).

Builds :class:`~bark_jax.forest.Forest` arrays from nested Python tree specs:

    ("leaf",)
    ("split", feature_idx, threshold, left_spec, right_spec)

using the same free-list layout the sampler produces (children allocated at
the first two inactive slots, parity with
src/bark/fitting/tree_proposals.py:45-58), so hand-built trees are
indistinguishable from sampled ones.
"""

from __future__ import annotations

import numpy as np

from bark_jax.forest import DEFAULT_NODE_LIMIT, Forest, forest_from_numpy

LEAF = ("leaf",)


def build_tree_arrays(spec, node_limit: int = DEFAULT_NODE_LIMIT) -> dict:
    """Build one tree's field arrays from a nested spec (numpy dict)."""
    arrs = {
        "is_leaf": np.zeros(node_limit, bool),
        "feature": np.zeros(node_limit, np.int32),
        "threshold": np.zeros(node_limit, np.float32),
        "left": np.zeros(node_limit, np.int32),
        "right": np.zeros(node_limit, np.int32),
        "parent": np.zeros(node_limit, np.int32),
        "depth": np.zeros(node_limit, np.int32),
        "active": np.zeros(node_limit, bool),
    }
    next_slot = [1]

    def assign(idx, spec, parent, depth):
        arrs["active"][idx] = True
        arrs["parent"][idx] = parent
        arrs["depth"][idx] = depth
        if spec[0] == "leaf":
            arrs["is_leaf"][idx] = True
            return
        _, feat, thr, left_spec, right_spec = spec
        li, ri = next_slot[0], next_slot[0] + 1
        next_slot[0] += 2
        if ri >= node_limit:
            raise OverflowError("tree spec exceeds node_limit")
        arrs["feature"][idx] = feat
        arrs["threshold"][idx] = thr
        arrs["left"][idx] = li
        arrs["right"][idx] = ri
        assign(li, left_spec, idx, depth + 1)
        assign(ri, right_spec, idx, depth + 1)

    assign(0, spec, 0, 0)
    return arrs


def build_forest(specs, node_limit: int = DEFAULT_NODE_LIMIT) -> Forest:
    """Build a Forest (fields ``(m, node_limit)``) from a list of tree specs."""
    trees = [build_tree_arrays(s, node_limit) for s in specs]
    stacked = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    return forest_from_numpy(stacked)
