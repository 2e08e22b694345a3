"""Posterior GP prediction over batched forest samples.

Parity target: src/bark/tree_kernels/tree_gps.py:80-131 (``forest_predict``
and ``mixture_of_gaussians_as_normal``). The reference loops a Numba Gram
matrix over samples and inverts each kernel densely; here the whole batch is
one jitted program: leaves are routed once per sample, Gram matrices come
from one-hot matmuls, and solves go through Cholesky.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from bark_jax.forest import Forest, gram_from_leaves, route_forest_auto
from bark_jax.ops.linalg import (
    JITTER,
    MM_PRECISION,
    gp_posterior,
    robust_chol_inv_logdet,
)


@functools.partial(jax.jit, static_argnames=("max_depth",))
def forest_predict(
    forest: Forest,
    noise: jax.Array,
    scale: jax.Array,
    train_x: jax.Array,
    train_y: jax.Array,
    candidates: jax.Array,
    feat_types: jax.Array,
    max_depth: int = 16,
    train_mask: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Batched posterior mean/variance over all posterior samples.

    Forest fields may carry any leading batch shape (e.g. chains x samples);
    noise/scale match it. Returns ``mu, var`` of shape ``(S, M)`` with
    ``S = prod(batch)``, matching the reference's flattened output
    (tree_gps.py:88-112). ``train_mask`` marks real rows when the training
    set is padded to a bucket size: masked rows have zero cross-kernel
    columns and an isolated diagonal block, so they drop out of the
    posterior exactly.
    """
    m, node_limit = forest.num_trees, forest.node_limit
    flat = jax.tree.map(lambda a: a.reshape(-1, m, node_limit), forest)
    noise = noise.reshape(-1).astype(jnp.float32)
    scale = scale.reshape(-1).astype(jnp.float32)

    def one_sample(tree_sample: Forest, noise_s, scale_s):
        train_leaves = route_forest_auto(tree_sample, train_x, feat_types, max_depth)
        cand_leaves = route_forest_auto(tree_sample, candidates, feat_types, max_depth)
        K_XX = scale_s * gram_from_leaves(
            train_leaves, train_leaves, node_limit, train_mask, train_mask
        )
        K_XX = K_XX + (JITTER + noise_s) * jnp.eye(
            train_x.shape[0], dtype=K_XX.dtype
        )
        K_inv, _ = robust_chol_inv_logdet(K_XX)  # jitter escalation
        K_xX = scale_s * gram_from_leaves(
            cand_leaves, train_leaves, node_limit, None, train_mask
        )
        return gp_posterior(K_inv, K_xX, train_y, scale_s)

    return jax.vmap(one_sample)(flat, noise, scale)


@functools.partial(jax.jit, static_argnames=("max_depth", "maxiter"))
def forest_predict_cg(
    forest: Forest,
    noise: jax.Array,
    scale: jax.Array,
    train_x: jax.Array,
    train_y: jax.Array,
    candidates: jax.Array,
    feat_types: jax.Array,
    max_depth: int = 16,
    train_mask: jax.Array | None = None,
    maxiter: int = 256,
) -> tuple[jax.Array, jax.Array]:
    """Matrix-free sibling of :func:`forest_predict` for large N.

    Same (mu, var) semantics per posterior sample, but every kernel
    product is factored through the leaf one-hot matrix and solved by
    preconditioned CG (ops/iterative.py) — no N x N array is ever
    materialized, and row-sharded inputs data-parallelize the solve.
    Use when the training set outgrows the dense path's O(S * N^2)
    memory; at bucket-sized N the dense Cholesky is faster.
    """
    from bark_jax.ops.iterative import cg_posterior

    m, node_limit = forest.num_trees, forest.node_limit
    flat = jax.tree.map(lambda a: a.reshape(-1, m, node_limit), forest)
    noise = noise.reshape(-1).astype(jnp.float32)
    scale = scale.reshape(-1).astype(jnp.float32)

    def one_sample(tree_sample: Forest, noise_s, scale_s):
        train_leaves = route_forest_auto(tree_sample, train_x, feat_types, max_depth)
        cand_leaves = route_forest_auto(tree_sample, candidates, feat_types, max_depth)
        return cg_posterior(
            train_leaves, cand_leaves, train_y, noise_s, scale_s,
            node_limit, mask=train_mask, maxiter=maxiter,
        )

    return jax.vmap(one_sample)(flat, noise, scale)


@functools.partial(jax.jit, static_argnames=("max_depth",))
def forest_predict_leaf(
    forest: Forest,
    noise: jax.Array,
    scale: jax.Array,
    train_x: jax.Array,
    train_y: jax.Array,
    candidates: jax.Array,
    feat_types: jax.Array,
    max_depth: int = 16,
    train_mask: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """EXACT large-N sibling of :func:`forest_predict` in leaf space.

    With the compact leaf-indicator matrices Z (N, r), Z_x (M, r) and
    A = (nu/gamma) I_r + Z^T Z  (nu = jitter + noise, gamma = scale / m,
    r = m * max_leaves), the Woodbury identity collapses the posterior to

        mu(x)  = z_x^T A^{-1} (Z^T y)
        var(x) = nu * || L_A^{-1} z_x ||^2

    (both derived from K = nu I + gamma Z Z^T; diag(Z_x Z_x^T) = m makes
    the prior-variance term cancel exactly). One (r, r) Cholesky per
    posterior sample replaces the (N, N) factorization — O((N + M) r)
    work and memory in N — and unlike :func:`forest_predict_cg` the
    result is exact (same math as dense up to float association; the
    per-tree dense ranking is injective for any forest, no budget
    assumption). The refresh identity the sampler uses at N >= 512
    (fitting/sampler.py), applied to prediction.
    """
    from bark_jax.forest import compact_leaf_indicator

    m, node_limit = forest.num_trees, forest.node_limit
    max_leaves = (node_limit + 1) // 2
    flat = jax.tree.map(lambda a: a.reshape(-1, m, node_limit), forest)
    noise = noise.reshape(-1).astype(jnp.float32)
    scale = scale.reshape(-1).astype(jnp.float32)
    y = train_y.reshape(-1).astype(jnp.float32)
    if train_mask is not None:
        y = y * train_mask

    def one_sample(tree_sample: Forest, noise_s, scale_s):
        train_leaves = route_forest_auto(tree_sample, train_x, feat_types, max_depth)
        cand_leaves = route_forest_auto(tree_sample, candidates, feat_types, max_depth)
        Z = compact_leaf_indicator(tree_sample, train_leaves, max_leaves)
        if train_mask is not None:
            Z = Z * train_mask[:, None]
        Zx = compact_leaf_indicator(tree_sample, cand_leaves, max_leaves)
        nu = JITTER + noise_s
        gamma = scale_s / m
        r = Z.shape[1]
        # Z'Z is exact at default precision (0/1 operands); the y-side
        # matvecs carry non-representable f32 values and run at full
        # mantissa (a default-precision matmul may round its operands —
        # results/ab_r5/precision_bug.md)
        A = Z.T @ Z + (nu / gamma) * jnp.eye(r, dtype=jnp.float32)
        L_A = jnp.linalg.cholesky(A)
        with jax.default_matmul_precision(MM_PRECISION):
            u = Z.T @ y
            w = jax.scipy.linalg.cho_solve((L_A, True), u)
            mu = Zx @ w
        T = jax.scipy.linalg.solve_triangular(L_A, Zx.T, lower=True)
        var = nu * jnp.sum(T * T, axis=0)
        return mu, var

    return jax.vmap(one_sample)(flat, noise, scale)


def mixture_of_gaussians_as_normal(
    mu: jax.Array, var: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Moment-match a uniform mixture of Gaussians to a single Gaussian.

    Parity: src/bark/tree_kernels/tree_gps.py:116-131.
    """
    mu_y = jnp.mean(mu, axis=0)
    var_y = jnp.mean(var + mu**2, axis=0) - mu_y**2
    return mu_y, var_y
