"""TreeFunction: a ground-truth function sampled from the BARK prior.

Parity target: src/bofire_mixed/benchmarks/tree_function.py:19-98. The primary
correctness benchmark — BARK should recover functions drawn from its own
prior. Mirrors the reference's generator exactly:

  - tree *structure* grown with probability alpha(1+d)^-beta (alpha=0.95,
    beta=2.0), feature uniform over all dims, threshold ~ U(0, 1) regardless
    of feature type (tree_function.py:36-57 — yes, categorical splits in the
    ground-truth forest are degenerate int(thr)=0 masks that always route
    right; we reproduce that faithfully);
  - leaf values ~ N(0, 1) per node slot; f(x) = sum over trees of the leaf
    value x lands in (tree_function.py:19-33).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.benchmarks.base import Benchmark, register_benchmark
from bark_jax.domain import CategoricalInput, ContinuousInput, Domain
from bark_jax.forest import Forest, route_forest_auto
from bark_jax.utils.build import build_tree_arrays


def sample_tree_structure_from_prior(
    m: int, dim: int, rng: np.random.Generator, node_limit: int = 64,
    alpha: float = 0.95, beta: float = 2.0, max_depth: int = 16,
) -> Forest:
    """Host-side structure sampling matching tree_function.py:36-57."""
    from bark_jax.forest import forest_from_numpy

    trees = []
    for _ in range(m):
        def sample_spec(depth):
            if depth >= max_depth or rng.uniform() > alpha * (1 + depth) ** (-beta):
                return ("leaf",)
            feat = int(rng.integers(dim))
            thr = float(rng.uniform(0, 1))
            left = sample_spec(depth + 1)
            right = sample_spec(depth + 1)
            return ("split", feat, thr, left, right)

        # depth-first with capacity fallback, like the reference's stack loop
        while True:
            spec = sample_spec(0)
            try:
                trees.append(build_tree_arrays(spec, node_limit))
                break
            except OverflowError:
                continue
    stacked = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    return forest_from_numpy(stacked)


@register_benchmark("TreeFunction")
class TreeFunction(Benchmark):
    """f(x) = sum_j leaf_value_j(x) for a prior-sampled forest."""

    def __init__(self, dim=5, cat_dim=0, num_cat=5, m=50, function_seed=1, **kwargs):
        categories = tuple(chr(i + ord("a")) for i in range(num_cat))
        domain = Domain(
            [
                *(ContinuousInput(f"x_{i}", (0.0, 1.0)) for i in range(dim)),
                *(CategoricalInput(f"c_{i}", categories) for i in range(cat_dim)),
            ]
        )
        super().__init__(domain)
        rng = np.random.default_rng(function_seed)
        total_dim = dim + cat_dim
        self.forest = sample_tree_structure_from_prior(m, total_dim, rng)
        # leaf values per node slot (reference: leaf_values over forest.shape)
        self.leaf_values = rng.standard_normal(
            (m, self.forest.node_limit)
        ).astype(np.float64)
        self._feat_types = jnp.asarray(self.domain.feature_types())

    def _f(self, X: np.ndarray) -> np.ndarray:
        leaves = np.asarray(
            route_forest_auto(self.forest, jnp.asarray(X, jnp.float32), self._feat_types)
        )  # (N, m)
        vals = self.leaf_values[np.arange(self.leaf_values.shape[0])[None, :], leaves]
        return vals.sum(axis=1)
