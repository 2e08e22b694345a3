"""Baseline strategies.

Parity targets:
  - RelaxedSoboStrategy (src/bofire_mixed/strategies/relaxed_sobo.py:19-74):
    a continuous-relaxation GP baseline — integers widened ±0.5, categoricals
    one-hot-relaxed to boxes — here with a native JAX RBF GP (the reference
    wraps BoFire/BoTorch SoboStrategy) and an LCB acquisition optimized by
    random search + local refinement, rounding back through the domain.
  - SMACStrategy (strategies/smac.py:27-96): ConfigSpace conversion +
    tell/ask replay through the SMAC3 HPO facade; import-guarded exactly as
    in the reference (smac is not even in its pyproject deps).
  - BARTGridStrategy (strategies/bart_grid.py:18-92): requires pymc-bart;
    gated identically.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.domain import (
    CategoricalInput,
    ContinuousInput,
    Domain,
    IntegerInput,
)
from bark_jax.strategies.capabilities import validate_domain

#: the baseline strategies' acquisition paths (relaxed-box LCB, ConfigSpace,
#: Sobol grid, Entmoot MIP) are all unconstrained — they neither lower nor
#: reject domain constraints, so constructing them on a constrained domain
#: must fail fast (capabilities.validate_domain) rather than silently
#: propose infeasible points.
_BASELINE_FEATURES = (ContinuousInput, IntegerInput, CategoricalInput)


def _relax_bounds(domain: Domain) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """Relaxed continuous box: ints ±0.5; cats -> one-hot blocks.

    Parity: relaxed_sobo.py:19-33. Returns bounds (D_relax, 2) and the
    (start, size) block per original feature.
    """
    rows, blocks = [], []
    for f in domain.inputs:
        start = len(rows)
        if isinstance(f, CategoricalInput):
            rows.extend([(0.0, 1.0)] * len(f.categories))
            blocks.append((start, len(f.categories)))
        elif isinstance(f, IntegerInput):
            rows.append((f.bounds[0] - 0.5, f.bounds[1] + 0.5))
            blocks.append((start, 1))
        else:
            rows.append((float(f.bounds[0]), float(f.bounds[1])))
            blocks.append((start, 1))
    return np.array(rows, np.float32), blocks


class RelaxedGPStrategy:
    """Continuous-relaxation RBF-GP LCB baseline (RelaxedSobo analogue).

    Hyperparameters (per-dimension lengthscales, outputscale, noise) are
    fitted by Adam on the exact MLL each ``ask`` — the honest counterpart of
    the reference's ``fit_gpytorch_mll``-fitted BoTorch GP (relaxed_sobo.py
    wraps SoboStrategy, whose SingleTaskGP is MLL-fitted). Set
    ``fit_hypers=False`` for the round-1 fixed-lengthscale behavior.
    """

    SUPPORTED_FEATURES = _BASELINE_FEATURES
    SUPPORTED_CONSTRAINTS = ()

    def __init__(self, domain: Domain, seed: int = 0, kappa: float = 1.96,
                 num_candidates: int = 2048, fit_hypers: bool = True,
                 fit_steps: int = 150):
        validate_domain(type(self), domain)
        self.domain = domain
        self.kappa = kappa
        self.num_candidates = num_candidates
        self.fit_hypers = fit_hypers
        self.fit_steps = fit_steps
        self._rng = np.random.default_rng(seed)
        self._key = jax.random.key(seed)
        self.bounds_relax, self.blocks = _relax_bounds(domain)
        self.X = None
        self.y = None

    def _to_relaxed(self, X: np.ndarray) -> np.ndarray:
        out = np.zeros((X.shape[0], self.bounds_relax.shape[0]), np.float32)
        for i, (f, (start, size)) in enumerate(zip(self.domain.inputs, self.blocks)):
            if isinstance(f, CategoricalInput):
                out[np.arange(X.shape[0]), start + X[:, i].astype(int)] = 1.0
            else:
                out[:, start] = X[:, i]
        return out

    def _from_relaxed(self, Z: np.ndarray) -> np.ndarray:
        out = np.zeros((Z.shape[0], len(self.domain.inputs)), np.float32)
        for i, (f, (start, size)) in enumerate(zip(self.domain.inputs, self.blocks)):
            if isinstance(f, CategoricalInput):
                out[:, i] = np.argmax(Z[:, start : start + size], axis=1)
            else:
                out[:, i] = Z[:, start]
        return self.domain.round(out)

    def tell(self, X, y):
        self.X = self.domain.transform(X)
        self.y = np.asarray(y, np.float64).reshape(-1)

    def add(self, X_new, y_new):
        X_new = self.domain.transform(X_new)
        y_new = np.asarray(y_new, np.float64).reshape(-1)
        if self.X is None:
            self.X, self.y = X_new, y_new
        else:
            self.X = np.vstack([self.X, X_new])
            self.y = np.concatenate([self.y, y_new])

    def _fit_hypers(self, Z, y_std, ls0):
        """Adam on the exact MLL over (log lengthscales, log scale, log noise)."""
        import optax

        n = Z.shape[0]

        def neg_mll(p):
            ls = jnp.exp(p["log_ls"])
            scale = jnp.exp(p["log_scale"])
            noise = jnp.exp(p["log_noise"])
            d = (Z[:, None, :] - Z[None, :, :]) / ls
            K = scale * jnp.exp(-0.5 * jnp.sum(d * d, axis=-1))
            K = K + (noise + 1e-6) * jnp.eye(n)
            L = jnp.linalg.cholesky(K)
            a = jax.scipy.linalg.solve_triangular(L, y_std, lower=True)
            return jnp.sum(a * a) + 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))

        params = {
            "log_ls": jnp.log(ls0),
            "log_scale": jnp.asarray(0.0),
            "log_noise": jnp.asarray(jnp.log(0.1)),
        }
        opt = optax.adam(0.05)
        state = opt.init(params)

        @jax.jit
        def step(params, state):
            loss, grads = jax.value_and_grad(neg_mll)(params)
            updates, state = opt.update(grads, state)
            return optax.apply_updates(params, updates), state, loss

        for _ in range(self.fit_steps):
            params, state, _ = step(params, state)
        return (
            jnp.exp(params["log_ls"]),
            float(jnp.exp(params["log_scale"])),
            float(jnp.exp(params["log_noise"])),
        )

    def ask(self, candidate_count: int = 1) -> np.ndarray:
        if self.y is None or len(self.y) < 2:
            return self.domain.sample(candidate_count, self._rng)
        Z = jnp.asarray(self._to_relaxed(self.X))
        y = self.y
        y_std = jnp.asarray((y - y.mean()) / max(y.std(), 1e-9), jnp.float32)

        span = self.bounds_relax[:, 1] - self.bounds_relax[:, 0]
        ls = jnp.asarray(np.maximum(span, 1e-3) * 0.3)
        scale, noise = 1.0, 1e-4
        if self.fit_hypers:
            ls, scale, noise = self._fit_hypers(Z, y_std, ls)

        def rbf(a, b):
            d = (a[:, None, :] - b[None, :, :]) / ls
            return scale * jnp.exp(-0.5 * jnp.sum(d * d, axis=-1))

        K = rbf(Z, Z) + (noise + 1e-6) * jnp.eye(Z.shape[0])
        L = jnp.linalg.cholesky(K)
        alpha = jax.scipy.linalg.cho_solve((L, True), y_std)

        # candidate batch in relaxed space
        self._key, k = jax.random.split(self._key)
        u = jax.random.uniform(
            k, (self.num_candidates, self.bounds_relax.shape[0])
        )
        cands = (
            jnp.asarray(self.bounds_relax[:, 0]) + u * jnp.asarray(span)
        )
        Kc = rbf(cands, Z)
        mu = Kc @ alpha
        v = jax.scipy.linalg.solve_triangular(L, Kc.T, lower=True)
        var = jnp.maximum(scale - jnp.sum(v * v, axis=0), 1e-9)
        lcb = mu - self.kappa * jnp.sqrt(var)
        best = np.asarray(cands[jnp.argmin(lcb)])[None, :]
        return self._from_relaxed(best)


class _Unavailable:
    def __init__(self, name, reason):
        raise RuntimeError(f"Strategy {name} unavailable: {reason}")


class SMACStrategy:
    """SMAC3 HPO-facade baseline wrapper.

    Parity: strategies/smac.py:27-96 — domain features become a ConfigSpace
    (Float/Integer/Categorical), observed experiments are replayed into the
    optimizer via ``smac.tell`` with one seed per config, and ``ask`` pulls
    one suggested configuration. ``predict`` returns zeros like the
    reference's dummy ``_predict``. smac stays an optional dependency
    (guarded import, as in the reference — it is absent from the reference's
    own pyproject too).
    """

    SUPPORTED_FEATURES = _BASELINE_FEATURES
    SUPPORTED_CONSTRAINTS = ()

    def __init__(self, domain: Domain, seed: int = 0, n_trials: int = 100):
        validate_domain(type(self), domain)
        try:
            import ConfigSpace as cs
            from smac import HyperparameterOptimizationFacade, Scenario
        except ImportError as e:
            raise RuntimeError(
                "SMACStrategy requires the 'smac' package (not installed; "
                "the reference also treats it as optional)"
            ) from e
        self._cs = cs
        self.domain = domain
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self.X = None
        self.y = None
        self._told = set()

        space = cs.ConfigurationSpace(seed=seed)
        for f in domain.inputs:
            if isinstance(f, CategoricalInput):
                space.add(cs.Categorical(name=f.key, items=list(f.categories)))
            elif isinstance(f, IntegerInput):
                space.add(
                    cs.Integer(name=f.key, bounds=(int(f.bounds[0]), int(f.bounds[1])))
                )
            else:
                space.add(
                    cs.Float(
                        name=f.key, bounds=(float(f.bounds[0]), float(f.bounds[1]))
                    )
                )
        self.configspace = space
        scenario = Scenario(space, deterministic=True, n_trials=n_trials)
        self.smac = HyperparameterOptimizationFacade(
            scenario,
            lambda x, seed=0: 0.0,  # dummy objective: driven via tell/ask
            initial_design=HyperparameterOptimizationFacade.get_initial_design(
                scenario, n_configs=1
            ),
            intensifier=HyperparameterOptimizationFacade.get_intensifier(
                scenario, max_config_calls=1
            ),
            overwrite=True,
        )

    def _config_from_row(self, row: np.ndarray):
        values = {}
        for i, f in enumerate(self.domain.inputs):
            if isinstance(f, CategoricalInput):
                values[f.key] = f.categories[int(round(row[i]))]
            elif isinstance(f, IntegerInput):
                values[f.key] = int(round(row[i]))
            else:
                values[f.key] = float(row[i])
        return self._cs.Configuration(self.configspace, values=values)

    def _replay(self):
        from smac.runhistory.dataclasses import TrialInfo, TrialValue

        for row, y_val in zip(self.X, self.y):
            key = row.tobytes()
            if key in self._told:
                continue
            trial = TrialInfo(self._config_from_row(row), seed=self.seed)
            if trial not in self.smac.runhistory:
                self.smac.tell(trial, TrialValue(float(y_val)), save=False)
            self._told.add(key)

    def tell(self, X, y) -> None:
        self.X = self.domain.transform(X)
        self.y = np.asarray(y, np.float64).reshape(-1)
        self._replay()

    def add(self, X_new, y_new) -> None:
        X_new = self.domain.transform(X_new)
        y_new = np.asarray(y_new, np.float64).reshape(-1)
        if self.X is None:
            self.X, self.y = X_new, y_new
        else:
            self.X = np.vstack([self.X, X_new])
            self.y = np.concatenate([self.y, y_new])
        self._replay()

    def has_sufficient_experiments(self) -> bool:
        return self.y is not None and len(self.y) >= 1

    def ask(self, candidate_count: int = 1) -> np.ndarray:
        assert candidate_count == 1, "SMAC only supports single candidates"
        info = self.smac.ask()
        cfg = dict(info.config)
        row = np.zeros((len(self.domain.inputs),), np.float32)
        for i, f in enumerate(self.domain.inputs):
            v = cfg[f.key]
            if isinstance(f, CategoricalInput):
                row[i] = f.categories.index(v)
            else:
                row[i] = float(v)
        return row[None, :]

    def predict(self, X) -> tuple[np.ndarray, np.ndarray]:
        """Dummy predictions (parity: strategies/smac.py:87-89)."""
        n = len(next(iter(X.values()))) if isinstance(X, dict) else len(X)
        return np.zeros((n, 1)), np.zeros((n, 1))


def smac_strategy(domain: Domain, **kwargs):
    """Parity: strategies/smac.py:19-24 guards on the smac import too."""
    return SMACStrategy(domain, **kwargs)


class GridUCBStrategy:
    """Sobol-grid reparameterized-UCB strategy (BARTGrid analogue).

    Parity: strategies/bart_grid.py:41-58 — grid of ``min(2^(5D), 2^14)``
    Sobol points, posterior-predictive function draws, Wilson et al. 2018
    (Eq 7) reparameterized LCB for minimization
    ``mean_s(-mu + kappa*sqrt(pi/2)*|y_s - mu|)``, argmax over the grid.
    The reference runs this over a PyMC-BART surrogate; any surrogate
    exposing ``function_samples`` works — the BARTGrid registry entry
    pairs it with the native :class:`bark_jax.models.bart.BARTSurrogate`
    (true parity), and the default here is the fully-Bayesian BARK
    surrogate, whose sum-of-trees posterior is the GP-kernelized
    counterpart of BART's.
    """

    SUPPORTED_FEATURES = _BASELINE_FEATURES
    SUPPORTED_CONSTRAINTS = ()

    def __init__(self, domain: Domain, surrogate=None, seed: int = 0,
                 kappa: float = 1.96, max_grid: int = 2**14, params=None):
        from bark_jax.models.surrogate import BARKSurrogate

        validate_domain(type(self), domain)
        self.domain = domain
        self.surrogate = surrogate or BARKSurrogate(domain, params, seed=seed)
        self.kappa = kappa
        self.max_grid = max_grid
        self.seed = seed
        self._ask_count = 0
        self._rng = np.random.default_rng(seed)
        self.X = None
        self.y = None

    def _refit(self):
        self.surrogate.fit(self.X, self.y)

    def tell(self, X, y) -> None:
        self.X = self.domain.transform(X)
        self.y = np.asarray(y, np.float64).reshape(-1)
        self._refit()

    def add(self, X_new, y_new) -> None:
        X_new = self.domain.transform(X_new)
        y_new = np.asarray(y_new, np.float64).reshape(-1)
        if self.X is None:
            self.X, self.y = X_new, y_new
        else:
            self.X = np.vstack([self.X, X_new])
            self.y = np.concatenate([self.y, y_new])
        self._refit()

    def has_sufficient_experiments(self) -> bool:
        return self.y is not None and len(self.y) > 1

    def ask(self, candidate_count: int = 1) -> np.ndarray:
        assert candidate_count == 1, "grid UCB proposes single candidates"
        if not self.has_sufficient_experiments() or not self.surrogate.is_fitted:
            return self.domain.sample(1, self._rng)
        n = min(2 ** (5 * self.domain.dim), self.max_grid)
        grid = self.domain.sample_sobol(n, seed=self.seed + self._ask_count)
        self._ask_count += 1
        draws = self.surrogate.function_samples(
            grid, key=jax.random.key(self.seed + self._ask_count)
        )  # (S, n)
        mu = draws.mean(axis=0, keepdims=True)
        reparam = -mu + self.kappa * np.sqrt(np.pi / 2) * np.abs(draws - mu)
        lcb = reparam.mean(axis=0)
        return grid[int(np.argmax(lcb))][None, :]

    def predict(self, X):
        return self.surrogate.predict(X)


def bart_grid_strategy(domain: Domain, seed: int = 0, **kwargs):
    """BARTGrid entry point: grid-UCB over the native BART posterior
    (bark_jax.fitting.bart Gibbs sampler), matching the reference's
    BARTGridStrategy-over-pymc-bart (strategies/bart_grid.py:18-92)."""
    from bark_jax.models.bart import BARTSurrogate

    sur = BARTSurrogate(domain, kwargs.pop("bart_params", None), seed=seed)
    return GridUCBStrategy(domain, surrogate=sur, seed=seed, **kwargs)


class EntmootStrategy:
    """Entmoot (tree-ensemble + MIP acquisition) baseline wrapper.

    Parity: the reference's study registry wires BoFire's EntingStrategy
    with solver_options TimeLimit=60, MIPGap=0.05
    (examples/bayes_opt/bark_study_strategy.py:84-89). Entmoot embeds a
    LightGBM ensemble in a Gurobi MIP — an external proprietary-solver
    dependency, so (like SMAC in the reference's own pyproject) it stays
    optional: a guarded import that raises an informative error when the
    package is absent, and a thin ask/tell adapter over our Domain encoding
    when it is present.
    """

    SUPPORTED_FEATURES = _BASELINE_FEATURES
    SUPPORTED_CONSTRAINTS = ()

    def __init__(self, domain: Domain, seed: int = 0,
                 time_limit: int = 60, mip_gap: float = 0.05):
        validate_domain(type(self), domain)
        try:
            from entmoot import Enting, GurobiOptimizer, ProblemConfig
        except ImportError as e:
            raise RuntimeError(
                "EntmootStrategy requires the 'entmoot' package (and a "
                "Gurobi license), neither installed here; the reference "
                "treats it as an optional study baseline too "
                "(bark_study_strategy.py:84-89)"
            ) from e
        self.domain = domain
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self.X = None
        self.y = None

        pc = ProblemConfig(rnd_seed=seed)
        for f in domain.inputs:
            if isinstance(f, CategoricalInput):
                pc.add_feature("categorical", tuple(f.categories), name=f.key)
            elif isinstance(f, IntegerInput):
                pc.add_feature(
                    "integer", (int(f.bounds[0]), int(f.bounds[1])), name=f.key
                )
            else:
                pc.add_feature(
                    "real", (float(f.bounds[0]), float(f.bounds[1])), name=f.key
                )
        pc.add_min_objective(name="y")
        self._pc = pc
        self._enting = Enting(pc, params={"unc_params": {"dist_metric": "l1"}})
        self._solver_params = {"TimeLimit": time_limit, "MIPGap": mip_gap,
                               "LogToConsole": 0}
        self._opt_cls = GurobiOptimizer

    def tell(self, X, y) -> None:
        self.X = np.asarray(X, np.float64)
        self.y = np.asarray(y, np.float64).reshape(-1)

    def add(self, X_new, y_new) -> None:
        X_new = np.atleast_2d(np.asarray(X_new, np.float64))
        y_new = np.asarray(y_new, np.float64).reshape(-1)
        if self.X is None:
            self.tell(X_new, y_new)
        else:
            self.tell(np.vstack([self.X, X_new]),
                      np.concatenate([self.y, y_new]))

    def ask(self, n: int = 1) -> np.ndarray:
        if self.X is None or len(self.y) < 2:
            return self.domain.sample(n, self._rng)
        self._enting.fit(self.X, self.y.reshape(-1, 1))
        opt = self._opt_cls(self._pc, params=self._solver_params)
        res = opt.solve(self._enting)
        x = np.asarray(res.opt_point, np.float64).reshape(1, -1)
        return np.vstack([x] + [self.domain.sample(1, self._rng)
                                for _ in range(n - 1)])
