"""Multi-task (multi-fidelity) tree-kernel GP.

Parity targets:
  - LeafMOGP (src/bark/tree_kernels/tree_gps.py:47-77): kernel
    ``k((x,i),(x',j)) = agreement(x,x') * B[i,j]`` with a rank-1-plus-diag
    index kernel ``B = w w^T + diag(v)`` over tasks/fidelities;
  - MultitaskGaussianLikelihood (src/bark/tree_kernels/
    multitask_likelihood.py:9-81): task-wise heteroskedastic, input-wise
    homoskedastic noise;
  - the GPyTorch MLL fit (surrogates train scale/task/noise hypers with the
    forest fixed) — here a jitted Adam loop on the exact MLL.

The forest comes from the booster import (bark_jax.fitting.booster), as in
the reference's LeafGP pathway.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from bark_jax.domain import Domain, Standardize
from bark_jax.fitting.booster import fit_booster_forest
from bark_jax.forest import Forest, gram_from_leaves, route_forest_auto
from bark_jax.ops.linalg import JITTER


class MOGPParams(NamedTuple):
    task_w: jax.Array  # (T,) rank-1 index-kernel factor
    raw_task_v: jax.Array  # (T,) softplus-param diag
    raw_noise: jax.Array  # (T,) softplus-param per-task noise


def _softplus(x):
    return jnp.logaddexp(x, 0.0)


def task_covariance(params: MOGPParams) -> jax.Array:
    """B = w w^T + diag(v) (IndexKernel rank 1, tree_gps.py:63)."""
    w = params.task_w
    return jnp.outer(w, w) + jnp.diag(_softplus(params.raw_task_v))


def mogp_kernel(
    gram: jax.Array, tasks1: jax.Array, tasks2: jax.Array, params: MOGPParams
) -> jax.Array:
    """Product kernel: agreement gram x task covariance lookup."""
    B = task_covariance(params)
    return gram * B[tasks1[:, None], tasks2[None, :]]


def _mogp_mll(params: MOGPParams, gram, tasks, y):
    K = mogp_kernel(gram, tasks, tasks, params)
    noise = _softplus(params.raw_noise)[tasks]
    K = K + jnp.diag(JITTER + noise)
    L = jnp.linalg.cholesky(K)
    z = jax.scipy.linalg.solve_triangular(L, y, lower=True)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    return -0.5 * (jnp.sum(z * z) + logdet)


@functools.partial(jax.jit, static_argnames=("num_tasks", "steps"))
def fit_mogp_hypers(gram, tasks, y, num_tasks: int, steps: int = 300):
    params = MOGPParams(
        task_w=jnp.ones((num_tasks,), jnp.float32),
        raw_task_v=jnp.zeros((num_tasks,), jnp.float32),
        raw_noise=jnp.full((num_tasks,), -1.5, jnp.float32),
    )
    opt = optax.adam(0.05)
    state = opt.init(params)

    def body(carry, _):
        params, state = carry
        loss, grads = jax.value_and_grad(
            lambda p: -_mogp_mll(p, gram, tasks, y)
        )(params)
        updates, state = opt.update(grads, state)
        params = optax.apply_updates(params, updates)
        return (params, state), loss

    (params, _), losses = jax.lax.scan(body, (params, state), None, length=steps)
    return params, losses


class LeafMOGPSurrogate:
    """Multi-fidelity tree GP: booster forest + fitted task/noise hypers.

    Training data is (X, task_idx, y); task 0 is the target fidelity.
    """

    def __init__(
        self,
        domain: Domain,
        num_tasks: int = 2,
        num_boost_round: int = 50,
        max_depth: int = 3,
        node_limit: int = 64,
        seed: int = 0,
    ):
        self.domain = domain
        self.num_tasks = num_tasks
        self.num_boost_round = num_boost_round
        self.max_depth = max_depth
        self.node_limit = node_limit
        self.seed = seed
        self.scaler = Standardize()
        self._feat_types = jnp.asarray(domain.feature_types())
        self.forest: Forest | None = None
        self.params: MOGPParams | None = None
        self.train = None

    def fit(self, X, tasks, y):
        X = self.domain.transform(X)
        tasks = np.asarray(tasks, np.int32).reshape(-1)
        y = np.asarray(y, np.float64).reshape(-1)
        y_std = self.scaler(y, train=True)

        self.forest = fit_booster_forest(
            X, y_std, self.domain,
            num_boost_round=self.num_boost_round,
            max_depth=self.max_depth,
            node_limit=self.node_limit,
            random_state=self.seed,
        )
        Xj = jnp.asarray(X, jnp.float32)
        yj = jnp.asarray(y_std, jnp.float32)
        tj = jnp.asarray(tasks)
        leaves = route_forest_auto(self.forest, Xj, self._feat_types)
        gram = gram_from_leaves(leaves, leaves, self.node_limit)
        self.params, _ = fit_mogp_hypers(gram, tj, yj, self.num_tasks)
        self.train = (Xj, tj, yj, leaves, gram)
        return self

    def _posterior_joint(self, X_new, tasks_new):
        """Joint latent posterior (mu, cov) at (X_new, tasks_new)."""
        Xj = jnp.asarray(self.domain.transform(X_new), jnp.float32)
        tnew = jnp.asarray(np.asarray(tasks_new, np.int32).reshape(-1))
        X, t, y, leaves, gram = self.train

        new_leaves = route_forest_auto(self.forest, Xj, self._feat_types)
        K_xX = mogp_kernel(
            gram_from_leaves(new_leaves, leaves, self.node_limit),
            tnew, t, self.params,
        )
        K_xx = mogp_kernel(
            gram_from_leaves(new_leaves, new_leaves, self.node_limit),
            tnew, tnew, self.params,
        )
        noise = _softplus(self.params.raw_noise)[t]
        K_XX = mogp_kernel(gram, t, t, self.params) + jnp.diag(JITTER + noise)
        sol = jnp.linalg.solve(
            K_XX, jnp.concatenate([y[:, None], K_xX.T], axis=1)
        )
        mu = K_xX @ sol[:, 0]
        cov = K_xx - K_xX @ sol[:, 1:]
        return mu, cov

    def predict(self, X_new, tasks_new, predict_observed: bool = True):
        """Mean and std per point; y-scale restored."""
        mu, cov = self._posterior_joint(X_new, tasks_new)
        var = jnp.maximum(jnp.diagonal(cov), 1e-12)
        if predict_observed:
            tnew = jnp.asarray(np.asarray(tasks_new, np.int32).reshape(-1))
            var = var + _softplus(self.params.raw_noise)[tnew]
        mu, var = self.scaler.untransform_mu_var(np.asarray(mu), np.asarray(var))
        return mu, np.sqrt(var)
