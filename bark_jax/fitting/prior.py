"""Ancestral sampling from the BARK forest prior, fixed-shape.

Parity target: src/bark/fitting/bark_prior_sampler.py:15-93. The reference
grows each tree with an explicit Python stack: pop a node, grow it with
probability alpha * (1 + depth)^-beta, sample a split inside the node's
subspace, skip invalid categorical/integer splits, push the children.

Here the stack becomes a ``pending`` mask over node slots scanned for a fixed
``node_limit`` trips: each trip resolves the first pending leaf (lowest slot
index), which exactly reproduces the reference's sampling distribution (the
grow decisions are exchangeable across frontier order). Everything vmaps
over trees and prior samples.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from bark_jax.fitting.proposals import _first_two_inactive, _grow, sample_splitting_rule
from bark_jax.fitting.traversal import node_subspace
from bark_jax.forest import FEAT_CAT, FEAT_INT, Forest, create_empty_forest


@functools.partial(jax.jit, static_argnames=("m", "node_limit", "max_depth"))
def _sample_single_forest(
    key: jax.Array,
    bounds: jax.Array,
    feat_types: jax.Array,
    alpha: float,
    beta: float,
    m: int,
    node_limit: int,
    max_depth: int,
) -> Forest:
    forest = create_empty_forest(m, node_limit)

    def sample_tree(key, tree: Forest) -> Forest:
        pending = jnp.zeros((node_limit,), jnp.bool_).at[0].set(True)

        def body(carry, k):
            tree, pending = carry
            k_grow, k_split = jax.random.split(k)
            any_pending = pending.any()
            n = jnp.argmax(pending).astype(jnp.int32)
            pending = pending.at[n].set(False)

            d = tree.depth[n].astype(jnp.float32)
            grow_prob = alpha * (1.0 + d) ** (-beta)
            want_grow = jax.random.uniform(k_grow) <= grow_prob

            subspace = node_subspace(tree, n, bounds, feat_types, max_depth)
            feat, thr = sample_splitting_rule(k_split, subspace, feat_types)
            ftype = feat_types[feat]
            invalid = ((ftype == FEAT_CAT) & (thr == 0)) | (
                (ftype == FEAT_INT) & (thr == subspace[feat, 1])
            )

            i1, i2, has_two = _first_two_inactive(tree.active)
            depth_ok = tree.depth[n] + 1 <= max_depth
            do_grow = (
                any_pending & want_grow & ~invalid & has_two & depth_ok
            )

            grown = _grow(tree, n, i1, i2, feat, thr)
            tree = jax.tree.map(
                lambda g, t: jnp.where(do_grow, g, t), grown, tree
            )
            pending = jnp.where(
                do_grow, pending.at[i1].set(True).at[i2].set(True), pending
            )
            return (tree, pending), None

        keys = jax.random.split(key, node_limit)
        (tree, _), _ = jax.lax.scan(body, (tree, pending), keys)
        return tree

    keys = jax.random.split(key, m)
    return jax.vmap(sample_tree)(keys, forest)


def sample_forest_prior(
    key: jax.Array,
    m: int,
    bounds: jax.Array,
    feat_types: jax.Array,
    alpha: float = 0.95,
    beta: float = 2.0,
    num_samples: int = 1,
    node_limit: int = 64,
    max_depth: int = 16,
) -> Forest:
    """Sample ``num_samples`` forests; fields ``(num_samples, m, node_limit)``.

    Parity: src/bark/fitting/bark_prior_sampler.py:68-84.
    """
    keys = jax.random.split(key, num_samples)
    return jax.vmap(
        lambda k: _sample_single_forest(
            k, bounds, feat_types, alpha, beta, m, node_limit, max_depth
        )
    )(keys)


def sample_noise_prior(
    key: jax.Array, gamma_shape: float, gamma_rate: float, num_samples: int
) -> jax.Array:
    """Gamma(shape, rate) noise draws (bark_prior_sampler.py:87-93)."""
    return jax.random.gamma(key, gamma_shape, (num_samples,)) / gamma_rate
