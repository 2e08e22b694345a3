"""Posterior function sampling: Thompson/f* draws and Nyström features.

Parity targets (capability-level — the reference modules are stale/
unimportable, src/bark/tree_kernels/__init__.py is empty):
  - src/bark/optimizer/thompson_sampling.py:9-27 (``generate_fstar_samples``:
    draws of the optimum value from the posterior over the training sites);
  - src/bark/optimizer/nystrom.py:6-42 (low-rank Nyström feature map from
    the kernel against inducing points, eigenvalue-clamped, used for
    approximate posterior function samples).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from bark_jax.fitting.sampler import BARKModel
from bark_jax.forest import Forest, gram_from_leaves, route_forest_auto
from bark_jax.ops.linalg import JITTER, MM_PRECISION


@functools.partial(jax.jit, static_argnames=("num_fstar", "max_depth"))
def generate_fstar_samples(
    key: jax.Array,
    model: BARKModel,
    train_x: jax.Array,
    train_y: jax.Array,
    feat_types: jax.Array,
    num_fstar: int = 16,
    max_depth: int = 16,
) -> jax.Array:
    """Sample optimum values f* from the latent posterior at the train sites.

    For each posterior (forest, noise, scale) sample: the joint latent
    posterior over f(X_train) is N(mu, Sigma) with
    ``mu = K (K + nu I)^-1 y`` and ``Sigma = K - K (K + nu I)^-1 K``;
    draw ``num_fstar`` joint samples and take the minimum over sites.
    Returns ``(S, num_fstar)``. Parity: thompson_sampling.py:9-27 (which
    warns about non-PSD covariance — handled here by eigenvalue clamping).
    """
    m, node_limit = model.forest.num_trees, model.forest.node_limit
    flat = jax.tree.map(lambda a: a.reshape(-1, m, node_limit), model.forest)
    noise = model.noise.reshape(-1).astype(jnp.float32)
    scale = model.scale.reshape(-1).astype(jnp.float32)
    y = train_y.reshape(-1)
    n = train_x.shape[0]

    def per_sample(tree_sample: Forest, noise_s, scale_s, k):
        leaves = route_forest_auto(tree_sample, train_x, feat_types, max_depth)
        K = scale_s * gram_from_leaves(leaves, leaves, node_limit)
        K_s = K + (JITTER + noise_s) * jnp.eye(n)
        sol = jnp.linalg.solve(K_s, jnp.concatenate([y[:, None], K], axis=1))
        mu = K @ sol[:, 0]
        Sigma = K - K @ sol[:, 1:]
        # eigenvalue-clamped sampling (the agreement kernel is PSD only up
        # to float error; thompson_sampling.py:17-21 warns on this)
        evals, evecs = jnp.linalg.eigh(0.5 * (Sigma + Sigma.T))
        root = evecs * jnp.sqrt(jnp.maximum(evals, 0.0))[None, :]
        z = jax.random.normal(k, (n, num_fstar))
        draws = mu[:, None] + root @ z
        return jnp.min(draws, axis=0)

    keys = jax.random.split(key, noise.shape[0])
    return jax.vmap(per_sample)(flat, noise, scale, keys)


@functools.partial(jax.jit, static_argnames=("max_depth",))
def construct_nystrom_features(
    model: BARKModel,
    inducing_x: jax.Array,
    candidates: jax.Array,
    feat_types: jax.Array,
    max_depth: int = 16,
    eig_floor: float = 1e-6,
):
    """Nyström feature map per posterior sample.

    ``phi(x) = K_xZ V diag(clamped eigenvalues)^(-1/2)`` from the
    eigendecomposition of K_ZZ over the inducing set Z; features satisfy
    ``phi(x) phi(x')^T ~= k(x, x')``. Returns ``(S, M, Z)``.
    Parity: nystrom.py:6-38 (pinv + eigh with clamped eigenvalues).
    """
    m, node_limit = model.forest.num_trees, model.forest.node_limit
    flat = jax.tree.map(lambda a: a.reshape(-1, m, node_limit), model.forest)
    scale = model.scale.reshape(-1).astype(jnp.float32)

    def per_sample(tree_sample: Forest, scale_s):
        z_leaves = route_forest_auto(tree_sample, inducing_x, feat_types, max_depth)
        c_leaves = route_forest_auto(tree_sample, candidates, feat_types, max_depth)
        K_zz = scale_s * gram_from_leaves(z_leaves, z_leaves, node_limit)
        K_xz = scale_s * gram_from_leaves(c_leaves, z_leaves, node_limit)
        evals, evecs = jnp.linalg.eigh(K_zz)
        inv_root = jnp.where(
            evals > eig_floor, 1.0 / jnp.sqrt(jnp.maximum(evals, eig_floor)), 0.0
        )
        return K_xz @ (evecs * inv_root[None, :])

    return jax.vmap(per_sample)(flat, scale)


def nystrom_samples(
    key: jax.Array, features: jax.Array, num_samples: int
) -> jax.Array:
    """Approximate prior function draws from Nyström features:
    ``f(x) = phi(x) @ w`` with w ~ N(0, I). Returns ``(S, num_samples, M)``.
    Parity: nystrom.py:40-42."""
    s, m, z = features.shape
    w = jax.random.normal(key, (s, z, num_samples))
    return jnp.einsum("smz,szn->snm", features, w)


@functools.partial(jax.jit, static_argnames=("num_draws", "max_depth"))
def leaf_function_samples(
    key: jax.Array,
    model: BARKModel,
    train_x: jax.Array,
    train_y: jax.Array,
    X_eval: jax.Array,
    feat_types: jax.Array,
    num_draws: int = 16,
    max_depth: int = 16,
    train_mask: jax.Array | None = None,
) -> jax.Array:
    """EXACT joint posterior function draws at arbitrary eval points.

    The forest-agreement GP is identically a Bayesian linear model over
    compact leaf indicators: f(x) = z_x^T theta with prior
    theta ~ N(0, gamma I_r) reproduces cov(f(x), f(x')) =
    scale * agreement exactly, so the posterior is available in closed
    form — theta | y ~ N(A^{-1} Z^T y, nu A^{-1}) with
    A = (nu/gamma) I + Z^T Z (verified against the dense posterior:
    models/gp.forest_predict_leaf derives the same mu/var). Draws are
    theta = theta_bar + sqrt(nu) L_A^{-T} eps — one (r, r) Cholesky per
    posterior sample, O(r) per eval point, exact FULL joint covariance,
    and A is SPD by construction so no eigenvalue clamping is ever needed
    (both the dense f* sampler above and the reference's Nystrom features
    clamp away indefiniteness; this path has none). Supersedes Nystrom
    features for BARK models (kept for parity). Returns
    ``(S, num_draws, M)``.
    """
    from bark_jax.forest import compact_leaf_indicator

    m, node_limit = model.forest.num_trees, model.forest.node_limit
    max_leaves = (node_limit + 1) // 2
    flat = jax.tree.map(lambda a: a.reshape(-1, m, node_limit), model.forest)
    noise = model.noise.reshape(-1).astype(jnp.float32)
    scale = model.scale.reshape(-1).astype(jnp.float32)
    y = train_y.reshape(-1).astype(jnp.float32)
    if train_mask is not None:
        y = y * train_mask

    def per_sample(tree_sample: Forest, noise_s, scale_s, k):
        train_leaves = route_forest_auto(
            tree_sample, train_x, feat_types, max_depth
        )
        eval_leaves = route_forest_auto(
            tree_sample, X_eval, feat_types, max_depth
        )
        Z = compact_leaf_indicator(tree_sample, train_leaves, max_leaves)
        if train_mask is not None:
            Z = Z * train_mask[:, None]
        Ze = compact_leaf_indicator(tree_sample, eval_leaves, max_leaves)
        nu = JITTER + noise_s
        gamma = scale_s / m
        r = Z.shape[1]
        A = Z.T @ Z + (nu / gamma) * jnp.eye(r, dtype=jnp.float32)
        L_A = jnp.linalg.cholesky(A)
        with jax.default_matmul_precision(MM_PRECISION):
            # full-mantissa y-side products (Z'Z above is exact at
            # default; results/ab_r5/precision_bug.md)
            theta_bar = jax.scipy.linalg.cho_solve((L_A, True), Z.T @ y)
        eps = jax.random.normal(k, (r, num_draws), jnp.float32)
        pert = jnp.sqrt(nu) * jax.scipy.linalg.solve_triangular(
            L_A.T, eps, lower=False
        )  # L_A^{-T} eps: draws from N(0, nu A^{-1})
        theta = theta_bar[:, None] + pert  # (r, num_draws)
        return (Ze @ theta).T  # (num_draws, M)

    keys = jax.random.split(key, noise.shape[0])
    return jax.vmap(per_sample)(flat, noise, scale, keys)


@functools.partial(jax.jit, static_argnames=("num_fstar", "max_depth"))
def generate_fstar_samples_leaf(
    key: jax.Array,
    model: BARKModel,
    train_x: jax.Array,
    train_y: jax.Array,
    feat_types: jax.Array,
    num_fstar: int = 16,
    max_depth: int = 16,
    train_mask: jax.Array | None = None,
) -> jax.Array:
    """:func:`generate_fstar_samples` through the exact leaf-space draws —
    O(N r + r^2) per posterior sample instead of the dense path's O(N^3)
    solve + eigendecomposition, with no PSD clamping. Returns
    ``(S, num_fstar)``."""
    draws = leaf_function_samples(
        key, model, train_x, train_y, train_x, feat_types, num_fstar,
        max_depth, train_mask,
    )  # (S, num_fstar, N)
    if train_mask is not None:
        draws = jnp.where(train_mask[None, None, :] > 0, draws, jnp.inf)
    return jnp.min(draws, axis=-1)


def fstar_samples_mogp(mogp, X_train, num_fstar: int, rng) -> jnp.ndarray:
    """Optimum-value samples from a LeafMOGP's target-fidelity posterior.

    The multi-task analogue of :func:`generate_fstar_samples` (the
    reference's MF-MES consumer, information_based_fidelity.py:16-36, is
    stale — it imports a BARKMOGP that does not exist). Standardized-y
    space; eigenvalue-clamped joint draws over the training sites at task 0,
    minimized per draw. Returns ``(num_fstar,)`` numpy.
    """
    import numpy as np

    mu, cov = mogp._posterior_joint(
        X_train, np.zeros(len(X_train), np.int64)
    )
    mu, cov = np.asarray(mu, np.float64), np.asarray(cov, np.float64)
    w, V = np.linalg.eigh(0.5 * (cov + cov.T))
    half = V * np.sqrt(np.clip(w, 1e-12, None))
    eps = rng.standard_normal((num_fstar, len(mu)))
    draws = mu[None, :] + eps @ half.T
    return draws.min(axis=1)
