"""BART surrogate over a Domain: native sum-of-trees posterior.

Parity target: src/bofire_mixed/surrogates/bart.py:15-89 (BARTSurrogate —
pymc-bart 50-tree BART with inverse-gamma noise, posterior-predictive
``function_samples`` and moment-matched ``predict``). This one is backed by
the in-repo :mod:`bark_jax.fitting.bart` Gibbs sampler instead of an
external library, so it runs on the accelerator inside one jitted scan and
needs no NUTS. The classic scaling convention is used: y is min-max scaled to
[-0.5, 0.5] (Chipman et al. 2010), the leaf prior is
sigma_mu = 0.5/(k sqrt(m)), and the inverse-gamma noise prior rate is
calibrated at fit time so P(sigma2 < var(y_scaled)) = 0.9.

Interface-compatible with the BARK surrogates (fit / predict /
function_samples / is_fitted), so it drops into GridUCBStrategy — giving
the reference's BARTGridStrategy (strategies/bart_grid.py:18-92) a real
BART posterior rather than a substitute.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.domain import Domain
from bark_jax.fitting.bart import (
    BARTParams,
    BARTState,
    bart_predict_samples,
    run_bart_sampler,
)
from bark_jax.forest import unpack_forest
from bark_jax.models.surrogate import bucket_size


class _MinMaxHalf:
    """y <-> [-0.5, 0.5] min-max scaling (classic BART convention)."""

    def __init__(self):
        self.y_min = 0.0
        self.range = 1.0

    def __call__(self, y: np.ndarray, train: bool = False) -> np.ndarray:
        if train:
            self.y_min = float(y.min()) if y.size else 0.0
            self.range = float(y.max() - y.min()) if y.size else 1.0
            if self.range <= 0.0:
                self.range = 1.0
        return (y - self.y_min) / self.range - 0.5

    def untransform_mu_var(self, mu, var):
        return (mu + 0.5) * self.range + self.y_min, var * self.range**2


def _invgamma_rate_for_quantile(shape: float, x: float, q: float = 0.9) -> float:
    """Rate b of InvGamma(shape, b) such that P(sigma2 < x) = q.

    InvGamma(a, b) CDF at x equals the upper regularized gamma Q(a, b/x);
    solved through scipy's invgamma (a pure-scipy call at fit time, not in
    the jitted path).
    """
    from scipy.stats import invgamma

    return x / float(invgamma.ppf(q, shape))


class BARTSurrogate:
    """Fully-Bayesian sum-of-trees surrogate (native BART Gibbs sampler)."""

    def __init__(
        self,
        domain: Domain,
        params: BARTParams | None = None,
        seed: int = 0,
    ):
        self.domain = domain
        self.params = params or BARTParams()
        self.scaler = _MinMaxHalf()
        self.samples = None  # BARTSamples
        self._state: BARTState | None = None
        self._key = jax.random.key(seed)
        self._bounds = jnp.asarray(domain.bounds("bitmask"))
        self._feat_types = jnp.asarray(domain.feature_types())

    @property
    def is_fitted(self) -> bool:
        return self.samples is not None

    def _store_train_data(self, X, y):
        X = self.domain.transform(X)
        y = np.asarray(y, np.float64).reshape(-1)
        y_std = self.scaler(y, train=True)
        n = X.shape[0]
        n_pad = bucket_size(n)
        X_pad = np.zeros((n_pad, X.shape[1]), np.float32)
        X_pad[:n] = X
        X_pad[n:] = X[0] if n else 0.0
        y_pad = np.zeros((n_pad,), np.float32)
        y_pad[:n] = y_std
        mask = np.zeros((n_pad,), np.float32)
        mask[:n] = 1.0
        self.train_data = (jnp.asarray(X_pad), jnp.asarray(y_pad))
        self.train_mask = jnp.asarray(mask)
        sighat2 = float(np.var(y_std)) if n > 1 else 1.0
        self._noise_rate = jnp.float32(
            _invgamma_rate_for_quantile(
                self.params.noise_prior_shape, max(sighat2, 1e-8)
            )
        )

    def _warm_state(self, X: jax.Array) -> BARTState | None:
        """Re-route the final chains' trees onto the new padded X.

        BO grows the training set between fits; trees and sigma2 carry
        over (the warm start the reference gets from pymc is a cold NUTS
        restart — this is strictly stronger), only the cached leaf
        assignments and f_total must be rebuilt for the new shapes.
        """
        if self._state is None:
            return None
        from bark_jax.forest import route_tree

        def rebuild(packed, leaf_values, sigma2):
            def one_tree(packed_j, values_j):
                leaves = route_tree(
                    unpack_forest(packed_j), X, self._feat_types,
                    self.params.max_depth,
                )
                return leaves, values_j[leaves]

            leaves, g = jax.vmap(one_tree)(packed, leaf_values)
            return BARTState(
                packed, leaf_values, leaves, jnp.sum(g, axis=0), sigma2
            )

        return jax.vmap(rebuild)(
            self._state.packed, self._state.leaf_values, self._state.sigma2
        )

    def fit(self, X, y):
        self._store_train_data(X, y)
        train_x, train_y = self.train_data
        init_state = self._warm_state(train_x)
        params = (
            self.params.with_(warmup_steps=0)
            if init_state is not None
            else self.params
        )
        self._key, k = jax.random.split(self._key)
        self.samples, self._state = run_bart_sampler(
            k, train_x, train_y, self._bounds, self._feat_types, params,
            self._noise_rate, mask=self.train_mask, init_state=init_state,
        )
        return self

    def _flat_samples(self):
        s = self.samples
        c, S = s.sigma2.shape
        return (
            s.packed.reshape((c * S,) + s.packed.shape[2:]),
            s.leaf_values.reshape((c * S,) + s.leaf_values.shape[2:]),
            s.sigma2.reshape(-1),
        )

    def predict(
        self, X, batched: bool = False, predict_observed: bool = True
    ) -> tuple[np.ndarray, np.ndarray]:
        """Posterior mean and std, shape ``([S,] N, 1)``.

        Parity: surrogates/bart.py:68-81 — per-sample means are
        moment-matched across draws; observation noise adds the posterior
        sigma2 per sample.
        """
        candidates = jnp.asarray(self.domain.transform(X), jnp.float32)
        packed, leaf_values, sigma2 = self._flat_samples()
        f = bart_predict_samples(
            packed, leaf_values, candidates, self._feat_types,
            self.params.max_depth,
        )  # (S, N) in scaled units
        f = np.asarray(f, np.float64)
        var_obs = np.asarray(sigma2, np.float64)[:, None] * np.ones_like(f)
        mu_s, var_s = self.scaler.untransform_mu_var(
            f, var_obs if predict_observed else np.zeros_like(f)
        )
        if batched:
            return mu_s[..., None], np.sqrt(var_s)[..., None]
        mu = mu_s.mean(axis=0)
        var = var_s.mean(axis=0) + mu_s.var(axis=0)
        return mu[:, None], np.sqrt(var)[:, None]

    def function_samples(
        self, X, key: jax.Array | None = None, num_draws: int = 1
    ) -> np.ndarray:
        """Posterior-predictive draws ``(S*num_draws, N)`` in original units.

        Parity: surrogates/bart.py:54-66 (posterior-predictive samples fed
        to the grid-UCB reparameterization).
        """
        mu, std = self.predict(X, batched=True, predict_observed=True)
        mu, std = mu[..., 0], std[..., 0]
        if key is None:
            key = jax.random.key(0)
        eps = jax.random.normal(key, (num_draws,) + mu.shape)
        draws = mu[None] + std[None] * np.asarray(eps)
        return draws.reshape(-1, mu.shape[-1])
