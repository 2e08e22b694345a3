"""Surrogate layer: trainable BARK / BARK-prior models over a Domain.

Parity target: src/bofire_mixed/surrogates/bark.py:39-189 (BARKSurrogate /
BARKPriorSurrogate) — without the BoFire/pydantic machinery: a surrogate is
constructed from a :class:`~bark_jax.domain.Domain` plus
:class:`~bark_jax.fitting.params.SamplerParams`, consumes ordinal-encoded
numpy/JAX arrays, and returns numpy predictions.

Behavioral parity highlights:
  - y is standardized at fit time and un-standardized at predict
    (surrogates/bark.py:124-129, 83-89);
  - the sampler warm-starts from the most recent posterior sample and skips
    warmup after the first fit (surrogates/bark.py:131-141);
  - predictions collapse the per-sample Gaussians by moment matching and add
    observation noise per sample (surrogates/bark.py:71-94).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.domain import Domain, Standardize
from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.prior import sample_forest_prior, sample_noise_prior
from bark_jax.fitting.sampler import BARKModel, run_bark_sampler
from bark_jax.forest import Forest, create_empty_forest
from bark_jax.models.gp import (
    forest_predict,
    forest_predict_cg,
    forest_predict_leaf,
    mixture_of_gaussians_as_normal,
)


def bucket_size(n: int, bucket: int = 32) -> int:
    """Round n up to a padding bucket so jit shapes change rarely during BO."""
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


class _BARKSurrogateBase:
    #: training-set size past which ``predict`` switches from the dense
    #: Cholesky posterior to the exact leaf-space path
    #: (forest_predict_leaf) — the dense path holds S x N x N kernels;
    #: leaf/CG never build anything N x N. (Name kept from the r2 CG
    #: switch; "cg" remains available as an explicit backend.) Chosen on
    #: the accelerator the system was first tuned on; not yet measured on
    #: the H100.
    cg_threshold: int = 2048

    def __init__(self, domain: Domain, params: SamplerParams,
                 predict_backend: str = "auto"):
        if predict_backend not in ("auto", "dense", "cg", "leaf"):
            raise ValueError(f"unknown predict_backend: {predict_backend!r}")
        self.domain = domain
        self.params = params
        self.predict_backend = predict_backend
        self.scaler = Standardize()
        self.model: BARKModel | None = None
        self.train_data: tuple[jax.Array, jax.Array] | None = None
        self.train_mask: jax.Array | None = None
        self._bounds = jnp.asarray(domain.bounds("bitmask"))
        self._feat_types = jnp.asarray(domain.feature_types())

    @property
    def is_fitted(self) -> bool:
        return self.model is not None

    def model_as_tuple(self) -> BARKModel | None:
        return self.model

    def predict(
        self, X, batched: bool = False, predict_observed: bool = True
    ) -> tuple[np.ndarray, np.ndarray]:
        """Posterior mean and standard deviation, shape ``([S,] N, 1)``.

        Parity: surrogates/bark.py:71-94 (returns mu and **std**).
        """
        candidates = jnp.asarray(self.domain.transform(X))
        train_x, train_y = self.train_data
        # auto: dense Cholesky at bucket-sized N; past the dense wall the
        # EXACT leaf-space path (one (r, r) Cholesky per sample, the
        # sampler-refresh identity applied to prediction) replaces the
        # round-3 CG approximation — same scaling, no iteration error.
        backend = self.predict_backend
        if backend == "auto":
            backend = "leaf" if train_x.shape[0] > self.cg_threshold else "dense"
        predict_fn = {
            "dense": forest_predict,
            "cg": forest_predict_cg,
            "leaf": forest_predict_leaf,
        }[backend]
        mu, var = predict_fn(
            self.model.forest,
            self.model.noise,
            self.model.scale,
            train_x,
            train_y,
            candidates,
            self._feat_types,
            self.params.max_depth,
            train_mask=self.train_mask,
        )
        mu, var = self.scaler.untransform_mu_var(np.asarray(mu), np.asarray(var))
        if predict_observed:
            noise_flat = np.asarray(self.model.noise).reshape(-1, 1)
            var = var + noise_flat * self.scaler.std**2
        if not batched:
            mu, var = mixture_of_gaussians_as_normal(
                jnp.asarray(mu), jnp.asarray(var)
            )
            mu, var = np.asarray(mu), np.asarray(var)
        return mu[..., None], np.sqrt(var[..., None])

    def function_samples(
        self, X, key: jax.Array | None = None, num_draws: int = 1
    ) -> np.ndarray:
        """Posterior-predictive function draws at ``X``: ``(S*num_draws, N)``.

        One independent marginal Gaussian draw per posterior sample per
        point, in original (un-standardized) y units, observation noise
        included — the BARK analogue of the reference BART surrogate's
        ``function_samples`` (surrogates/bart.py:54-66) consumed by the
        grid-UCB strategy (strategies/bart_grid.py:46-56).
        """
        mu, std = self.predict(X, batched=True, predict_observed=True)
        mu, std = mu[..., 0], std[..., 0]  # (S, N)
        if key is None:
            key = jax.random.key(0)
        eps = jax.random.normal(key, (num_draws,) + mu.shape)
        draws = mu[None] + std[None] * np.asarray(eps)
        return draws.reshape(-1, mu.shape[-1])

    def _store_train_data(self, X, y):
        """Standardize y and pad (X, y) to a bucket size with a row mask.

        Padding keeps jit shapes stable as the BO training set grows one
        point per iteration (recompiles happen only at bucket boundaries);
        masked rows are provably inert in the kernel, MLL, and posterior.
        """
        X = self.domain.transform(X)
        y = np.asarray(y, np.float64).reshape(-1)
        y_std = self.scaler(y, train=True)
        n = X.shape[0]
        n_pad = bucket_size(n)
        X_pad = np.zeros((n_pad, X.shape[1]), np.float32)
        X_pad[:n] = X
        X_pad[n:] = X[0] if n else 0.0  # valid in-domain filler rows
        y_pad = np.zeros((n_pad,), np.float32)
        y_pad[:n] = y_std
        mask = np.zeros((n_pad,), np.float32)
        mask[:n] = 1.0
        self.train_data = (jnp.asarray(X_pad), jnp.asarray(y_pad))
        self.train_mask = jnp.asarray(mask)


class BARKSurrogate(_BARKSurrogateBase):
    """Fully-Bayesian BARK surrogate (MCMC over forest + hyperparameters).

    ``fit_style``:
      - ``"chains"`` (default) — independent vmapped MH chains
        (run_bark_sampler), the reference's sampling scheme.
      - ``"tempered"`` — parallel tempering: ``num_chains`` independent
        replica ladders of ``num_replicas`` inverse temperatures with
        even-odd swap moves; posterior samples come from each ladder's
        cold chain. The textbook fix for the metastable large-N
        landscape (results/ab_r4/leaf_numerics.md finding 3: at N >= 512
        plain chains are still in transit after thousands of steps); no
        reference equivalent — bark_sampler.py:120 runs plain chains
        serially. Costs ``num_replicas`` x the step work of "chains".

    After every fit, ``fit_diagnostics`` holds split-R-hat / Geyer ESS
    over the sampled noise trace (chains x samples), so callers can see
    how far from stationarity a fit budget left the posterior instead of
    silently consuming a transit ensemble.
    """

    def __init__(self, domain: Domain, params: SamplerParams | None = None,
                 seed: int = 0, predict_backend: str = "auto",
                 fit_style: str = "chains", num_replicas: int = 8,
                 beta_min: float = 0.05):
        if fit_style not in ("chains", "tempered"):
            raise ValueError(f"unknown fit_style: {fit_style!r}")
        super().__init__(domain, params or SamplerParams(),
                         predict_backend=predict_backend)
        self.fit_style = fit_style
        self.num_replicas = num_replicas
        self.beta_min = beta_min
        self.fit_diagnostics: dict | None = None
        self._key = jax.random.key(seed)
        self._warmed_up = False

    def _check_leaf_budget(self, start: BARKModel, params, n: int) -> None:
        """Refuse a warm-start forest the leaf-space refresh cannot pack.

        The sampler's capacity guard only blocks NEW grows; an initial
        forest whose total leaf count already exceeds the (resolved) leaf
        budget would NaN-poison the chain inside jit (sampler.py
        init_chain_state). This is the eager boundary where a real error
        with a fix is possible — it fires only on cross-run warm starts
        with a smaller budget or custom deep priors (r4 code review).
        """
        from bark_jax.fitting.sampler import _leaf_budget, _resolve_styles

        resolved = _resolve_styles(params, n)
        if resolved.refresh_style != "leaf":
            return
        budget = _leaf_budget(resolved, n)
        totals = np.asarray(
            (start.forest.is_leaf & start.forest.active).sum(axis=(-2, -1))
        )
        worst = int(totals.max())
        if worst > budget:
            raise ValueError(
                f"warm-start forest has up to {worst} total leaves but the "
                f"leaf-space refresh budget is {budget} at padded N={n}; "
                "raise SamplerParams.leaf_budget (or set "
                'refresh_style="pair") to fit this state'
            )

    def _init_state(self) -> BARKModel:
        """Empty forests, noise 0.1, scale 1.0 (surrogates/bark.py:116-121)."""
        c = self.params.num_chains
        forest = create_empty_forest(
            self.params.num_trees, self.params.node_limit, batch_shape=(c,)
        )
        return BARKModel(
            forest=forest,
            noise=jnp.full((c,), 0.1, jnp.float32),
            scale=jnp.ones((c,), jnp.float32),
        )

    def fit(self, X, y):
        self._store_train_data(X, y)
        if not self.is_fitted:
            start = self._init_state()
            params = self.params
        else:
            # warm start from the most recent sample; skip warmup
            # (surrogates/bark.py:131-141)
            start = BARKModel(
                forest=jax.tree.map(lambda a: a[:, -1], self.model.forest),
                noise=self.model.noise[:, -1],
                scale=self.model.scale[:, -1],
            )
            params = self.params.with_(warmup_steps=0)

        self._key, k = jax.random.split(self._key)
        train_x, train_y = self.train_data
        self._check_leaf_budget(start, params, train_x.shape[0])
        if self.fit_style == "tempered":
            self.model = self._fit_tempered(k, start, params)
        else:
            self.model = run_bark_sampler(
                k,
                start,
                train_x,
                train_y,
                self._bounds,
                self._feat_types,
                params,
                mask=self.train_mask,
            )
        self._record_fit_diagnostics()
        return self

    def _fit_tempered(self, key, start: BARKModel, params: SamplerParams):
        """num_chains independent PT ladders; cold-chain samples only.

        Every replica of ladder c starts from chain c's (warm-started)
        state; the geometric beta ladder + even-odd swaps re-diversify
        immediately. The cold trace is thinned exactly like the plain
        sampler: the fit consumes ``num_samples`` samples spaced
        ``steps_per_sample`` apart after ``warmup_steps`` rounds.
        """
        from bark_jax.parallel.tempering import run_parallel_tempering

        train_x, train_y = self.train_data
        C, R = params.num_chains, self.num_replicas
        num_steps = (
            params.warmup_steps + params.num_samples * params.steps_per_sample
        )

        tile = lambda a: jnp.repeat(a[:, None], R, axis=1)
        forest_cr = jax.tree.map(tile, start.forest)
        noise_cr, scale_cr = tile(start.noise), tile(start.scale)

        def one_ladder(k, f, n, s):
            samples, _, swap_rate, _ = run_parallel_tempering(
                k, f, n, s, train_x, train_y, self._bounds,
                self._feat_types, params, num_replicas=R,
                num_steps=num_steps, beta_min=self.beta_min,
                mask=self.train_mask,
            )
            return samples, swap_rate

        keys = jax.random.split(key, C)
        samples, swap_rates = jax.vmap(one_ladder)(
            keys, forest_cr, noise_cr, scale_cr
        )
        self._last_swap_rate = float(jnp.mean(swap_rates))
        sl = slice(
            params.warmup_steps + params.steps_per_sample - 1,
            None,
            params.steps_per_sample,
        )
        return BARKModel(
            forest=jax.tree.map(lambda a: a[:, sl], samples.forest),
            noise=samples.noise[:, sl],
            scale=samples.scale[:, sl],
        )

    def _record_fit_diagnostics(self):
        """Split-R-hat / ESS over the sampled noise trace (cheap: the
        trace is already on host-bound output); surfaced so BO drivers
        can report distance-from-stationarity instead of silently using
        a transit ensemble."""
        from bark_jax.utils.diagnostics import (
            effective_sample_size,
            gelman_rubin,
        )

        noise = np.asarray(self.model.noise, np.float64)
        self.fit_diagnostics = {
            "r_hat_noise": float(gelman_rubin(noise)),
            "ess_noise": float(effective_sample_size(noise)),
            "noise_mean": float(noise.mean()),
        }
        if self.fit_style == "tempered":
            self.fit_diagnostics["swap_rate"] = getattr(
                self, "_last_swap_rate", float("nan")
            )


class BARKPriorSurrogate(_BARKSurrogateBase):
    """Prior-only ablation: forests/noise drawn from the BARK prior.

    Parity: surrogates/bark.py:152-189 (gamma(2.5, 9) noise prior default,
    scale fixed at 1).
    """

    def __init__(
        self,
        domain: Domain,
        params: SamplerParams | None = None,
        num_samples: int = 5,
        seed: int = 0,
        predict_backend: str = "auto",
    ):
        params = params or SamplerParams(
            gamma_prior_shape=2.5, gamma_prior_rate=9.0
        )
        super().__init__(domain, params, predict_backend=predict_backend)
        self.num_samples = num_samples
        self._key = jax.random.key(seed)

    def fit(self, X, y):
        self._store_train_data(X, y)
        self._key, k_forest, k_noise = jax.random.split(self._key, 3)
        forest = sample_forest_prior(
            k_forest,
            self.params.num_trees,
            self._bounds,
            self._feat_types,
            alpha=self.params.alpha,
            beta=self.params.beta,
            num_samples=self.num_samples,
            node_limit=self.params.node_limit,
            max_depth=self.params.max_depth,
        )
        noise = sample_noise_prior(
            k_noise,
            self.params.gamma_prior_shape,
            self.params.gamma_prior_rate,
            self.num_samples,
        )
        self.model = BARKModel(
            forest=forest,
            noise=noise.astype(jnp.float32),
            scale=jnp.ones((self.num_samples,), jnp.float32),
        )
        return self
