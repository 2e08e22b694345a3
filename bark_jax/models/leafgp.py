"""LeafGP: non-Bayesian tree-kernel GP over a fitted booster forest.

Parity: src/bofire_mixed/surrogates/leafgp.py:23-107 + the LeafGP model
(src/bark/tree_kernels/tree_gps.py:20-44): a GBDT forest defines a *fixed*
agreement kernel; only the scale (outputscale) and observation noise are
learned, by maximizing the exact GP marginal likelihood. The reference
delegates to GPyTorch's ``fit_gpytorch_mll``; here the MLL is maximized
with Adam on softplus-parameterized (noise, scale) — a jitted fixed-length
optimization loop (the kernel matrix is constant, so each step is one
Cholesky).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax

from bark_jax.domain import Domain, Standardize
from bark_jax.fitting.booster import fit_booster_forest
from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.sampler import BARKModel
from bark_jax.forest import gram_from_leaves, route_forest_auto
from bark_jax.models.gp import forest_predict, mixture_of_gaussians_as_normal
from bark_jax.ops.linalg import JITTER


def _softplus(x):
    return jnp.logaddexp(x, 0.0)


def _inv_softplus(y):
    return float(np.log(np.expm1(y)))


@jax.jit
def _fit_hypers(gram: jax.Array, y: jax.Array, steps: int = 200):
    """Maximize MLL over (noise, scale) with the gram matrix fixed."""
    n = gram.shape[0]
    eye = jnp.eye(n, dtype=gram.dtype)

    def neg_mll(params):
        noise = _softplus(params[0])
        scale = _softplus(params[1])
        K = scale * gram + (JITTER + noise) * eye
        L = jnp.linalg.cholesky(K)
        z = jax.scipy.linalg.solve_triangular(L, y, lower=True)
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
        return 0.5 * (jnp.sum(z * z) + logdet)

    opt = optax.adam(0.05)
    params = jnp.asarray(
        [_inv_softplus(0.1), _inv_softplus(1.0)], jnp.float32
    )
    state = opt.init(params)

    def body(carry, _):
        params, state = carry
        loss, grads = jax.value_and_grad(neg_mll)(params)
        updates, state = opt.update(grads, state)
        params = optax.apply_updates(params, updates)
        return (params, state), loss

    (params, _), losses = jax.lax.scan(body, (params, state), None, length=steps)
    return _softplus(params[0]), _softplus(params[1]), losses


class LeafGPSurrogate:
    """Booster forest + ScaleKernel(TreeAgreementKernel) GP.

    Parity: surrogates/leafgp.py:48-94 (fit forest -> optimize scale/noise
    -> posterior predictions with observation noise).
    """

    def __init__(
        self,
        domain: Domain,
        num_boost_round: int = 50,
        max_depth: int = 3,
        node_limit: int = 64,
        seed: int = 0,
    ):
        self.domain = domain
        self.num_boost_round = num_boost_round
        self.max_depth = max_depth
        self.node_limit = node_limit
        self.seed = seed
        self.params = SamplerParams(node_limit=node_limit)
        self.scaler = Standardize()
        self.model: BARKModel | None = None
        self.train_data = None
        self.train_mask = None
        self._feat_types = jnp.asarray(domain.feature_types())

    @property
    def is_fitted(self) -> bool:
        return self.model is not None

    def model_as_tuple(self):
        return self.model

    def fit(self, X, y):
        X = self.domain.transform(X)
        y_arr = np.asarray(y, np.float64).reshape(-1)
        y_std = self.scaler(y_arr, train=True)

        forest = fit_booster_forest(
            X,
            y_std,
            self.domain,
            num_boost_round=self.num_boost_round,
            max_depth=self.max_depth,
            node_limit=self.node_limit,
            random_state=self.seed,
        )
        Xj = jnp.asarray(X, jnp.float32)
        yj = jnp.asarray(y_std, jnp.float32)
        leaves = route_forest_auto(forest, Xj, self._feat_types)
        gram = gram_from_leaves(leaves, leaves, self.node_limit)
        noise, scale, _ = _fit_hypers(gram, yj)

        # batch dims (1, 1) so the downstream sample-batched paths apply
        self.model = BARKModel(
            forest=jax.tree.map(lambda a: a[None], forest),
            noise=jnp.asarray([noise], jnp.float32),
            scale=jnp.asarray([scale], jnp.float32),
        )
        self.train_data = (Xj, yj)
        self.train_mask = None
        return self

    def predict(self, X, batched=False, predict_observed=True):
        candidates = jnp.asarray(self.domain.transform(X))
        train_x, train_y = self.train_data
        mu, var = forest_predict(
            self.model.forest,
            self.model.noise,
            self.model.scale,
            train_x,
            train_y,
            candidates,
            self._feat_types,
        )
        mu, var = self.scaler.untransform_mu_var(np.asarray(mu), np.asarray(var))
        if predict_observed:
            var = var + np.asarray(self.model.noise).reshape(-1, 1) * self.scaler.std**2
        if not batched:
            mu, var = mixture_of_gaussians_as_normal(jnp.asarray(mu), jnp.asarray(var))
            mu, var = np.asarray(mu), np.asarray(var)
        return mu[..., None], np.sqrt(var[..., None])
