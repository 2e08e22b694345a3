"""Ask/tell BO strategy around a tree surrogate + parallel acquisition search.

Parity target: src/bofire_mixed/strategies/tree_kernel.py:22-89
(TreeKernelStrategy): tell() fits the surrogate on all experiments; ask()
builds the acquisition over the posterior samples (kappa = 1.96) and proposes
the leaf-box center of the optimum, falling back to a random candidate if
the optimizer fails. The strategy is framework-native: numpy/ordinal arrays
in and out, no pandas/pydantic dependency (dict/DataFrame input accepted via
``Domain.transform``).
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.constraints import (
    FunctionalInequalityConstraint,
    LinearInequalityConstraint,
    NChooseKConstraint,
    QuadraticInequalityConstraint,
)
from bark_jax.domain import (
    CategoricalInput,
    ContinuousInput,
    Domain,
    IntegerInput,
)
from bark_jax.fitting.params import SamplerParams
from bark_jax.models.surrogate import (
    BARKPriorSurrogate,
    BARKSurrogate,
    _BARKSurrogateBase,
)
from bark_jax.optimizer.acquisition import (
    DEFAULT_KAPPA,
    LR_THRESHOLD,
    build_acquisition,
    build_acquisition_lr,
    build_acquisition_ts,
)
from bark_jax.optimizer.search import propose, sample_feasible
from bark_jax.strategies.capabilities import validate_domain

logger = logging.getLogger(__name__)


class TreeKernelStrategy:
    """BO loop driver: alternate surrogate MCMC fits with acquisition search."""

    # Declared capabilities, validated at construction (parity:
    # data_models/strategies/tree_kernel.py:66-86). The penalty-guided
    # search + constrained leaf-box centering handle every constraint
    # family in bark_jax.constraints (subclasses included: equality forms
    # ride their inequality bases) — a superset of the reference's
    # Linear/NChooseK MIP support.
    SUPPORTED_FEATURES = (ContinuousInput, IntegerInput, CategoricalInput)
    SUPPORTED_CONSTRAINTS = (
        LinearInequalityConstraint,
        QuadraticInequalityConstraint,
        FunctionalInequalityConstraint,
        NChooseKConstraint,
    )

    def __init__(
        self,
        domain: Domain,
        surrogate: _BARKSurrogateBase | None = None,
        params: SamplerParams | None = None,
        kappa: float = DEFAULT_KAPPA,
        seed: int = 0,
        num_candidates: int = 4096,
        num_rounds: int = 4,
        acq_backend: str = "auto",
        dedup: bool = True,
    ):
        if acq_backend not in ("auto", "dense", "lowrank", "thompson"):
            raise ValueError(f"unknown acq_backend: {acq_backend!r}")
        validate_domain(type(self), domain)
        self.domain = domain
        self.surrogate = surrogate or BARKSurrogate(domain, params, seed=seed)
        self.kappa = kappa
        self.num_candidates = num_candidates
        self.num_rounds = num_rounds
        self.acq_backend = acq_backend
        self.dedup = dedup
        self._rng = np.random.default_rng(seed)
        self._key = jax.random.key(seed + 1)
        self.X: np.ndarray | None = None
        self.y: np.ndarray | None = None
        self._last_proposal: np.ndarray | None = None

    # --- tell ------------------------------------------------------------

    def tell(self, X, y) -> None:
        """Record experiments (full history) and refit the surrogate.

        Parity: strategies/tree_kernel.py:31-32.
        """
        X = self.domain.transform(X)
        y = np.asarray(y, np.float64).reshape(-1)
        self.X, self.y = X, y
        if self.has_sufficient_experiments():
            self.surrogate.fit(X, y)

    def add(self, X_new, y_new) -> None:
        """Append new experiments to the history and refit."""
        X_new = self.domain.transform(X_new)
        y_new = np.asarray(y_new, np.float64).reshape(-1)
        if self.X is None:
            self.tell(X_new, y_new)
        else:
            self.tell(
                np.vstack([self.X, X_new]), np.concatenate([self.y, y_new])
            )

    def has_sufficient_experiments(self) -> bool:
        """Parity: strategies/tree_kernel.py:75-89 (needs > 1)."""
        return self.y is not None and len(self.y) > 1

    # --- ask -------------------------------------------------------------

    def ask(self, candidate_count: int = 1) -> np.ndarray:
        """Propose the next candidate(s), ordinal-encoded ``(k, D)``.

        Parity: strategies/tree_kernel.py:37-57, incl. the random-candidate
        fallback on optimizer failure.
        """
        assert candidate_count == 1, "BARK proposes single candidates"
        if not self.has_sufficient_experiments() or not self.surrogate.is_fitted:
            return sample_feasible(self.domain, 1, self._rng)

        try:
            candidate = self._propose_once(
                use_ts=self.acq_backend == "thompson"
            )
            if self.dedup and self._is_duplicate(candidate):
                # The leaf-box-centered LCB optimum is piecewise constant:
                # once the incumbent's box dominates, every ask re-centers
                # the SAME point and the BO loop stalls (measured six
                # identical proposals in a row at N~4096; the reference
                # shares the failure mode,
                # src/bark/optimizer/proposals.py:131-147). A Thompson
                # draw from the exact leaf-space posterior breaks the tie
                # by optimizing a different (sampled) objective.
                candidate = self._propose_once(use_ts=True)
                if self._is_duplicate(candidate):
                    logger.info(
                        "Duplicate proposal persisted through the Thompson "
                        "fallback; proposing a feasible random candidate."
                    )
                    candidate = sample_feasible(self.domain, 1, self._rng)[0]
            self._last_proposal = candidate
            return candidate[None, :]
        except Exception:
            logger.warning(
                "Failed to optimize acqf, proposing random candidate.",
                exc_info=True,
            )
            return sample_feasible(self.domain, 1, self._rng)

    def _propose_once(self, use_ts: bool) -> np.ndarray:
        """One acquisition build + search; returns the (D,) candidate."""
        train_x, train_y = self.surrogate.train_data
        if use_ts:
            # one exact posterior function draw per ask (leaf-space
            # BLR closed form); fresh key = the TS exploration draw
            self._key, k_ts = jax.random.split(self._key)
            acq = build_acquisition_ts(
                k_ts,
                self.surrogate.model,
                train_x,
                train_y,
                jnp.asarray(self.domain.feature_types()),
                self.surrogate.params.max_depth,
                train_mask=self.surrogate.train_mask,
            )
        else:
            # the factored builder never materializes (S, N, N): past
            # the dense memory wall it is the only way ask() completes
            # at all (the reference is equally dense,
            # src/bark/optimizer/opt_model.py:54-59)
            use_lr = self.acq_backend == "lowrank" or (
                self.acq_backend == "auto"
                and train_x.shape[0] > LR_THRESHOLD
            )
            builder = build_acquisition_lr if use_lr else build_acquisition
            acq = builder(
                self.surrogate.model,
                train_x,
                train_y,
                jnp.asarray(self.domain.feature_types()),
                self.surrogate.params.max_depth,
                train_mask=self.surrogate.train_mask,
            )
        self._key, k = jax.random.split(self._key)
        candidate, _ = propose(
            k,
            acq,
            self.domain,
            jnp.asarray(self.domain.feature_types()),
            kappa=self.kappa,
            num_candidates=self.num_candidates,
            num_rounds=self.num_rounds,
            max_depth=self.surrogate.params.max_depth,
            rng=self._rng,
            seeds=self._warm_start_seeds(),
        )
        return np.asarray(candidate)

    def _is_duplicate(self, candidate: np.ndarray, rel_tol: float = 1e-6) -> bool:
        """Does ``candidate`` (ordinal ``(D,)``) replicate a train row or the
        previous proposal within per-dimension relative tolerance?"""
        refs = []
        if self.X is not None and len(self.X):
            refs.append(np.asarray(self.X, np.float64))
        if self._last_proposal is not None:
            refs.append(np.asarray(self._last_proposal, np.float64)[None, :])
        if not refs:
            return False
        refs = np.vstack(refs)
        bounds = np.asarray(self.domain.bounds("ordinal"), np.float64)
        span = np.maximum(bounds[:, 1] - bounds[:, 0], 1e-12)
        rel = np.abs(refs - np.asarray(candidate, np.float64)[None, :]) / span
        return bool((rel.max(axis=1) <= rel_tol).any())

    def _warm_start_seeds(self, n_jitter: int = 3) -> np.ndarray | None:
        """Round-0 elites: incumbent best X, the previous proposal, and
        jittered copies of each.

        The analogue of the reference's MIP warm start from the previous
        candidate (src/bark/optimizer/opt_model.py:120-164) — BO's strongest
        prior information is where it last looked and where the incumbent
        sits.
        """
        anchors = []
        if self.y is not None and len(self.y):
            anchors.append(self.X[int(np.argmin(self.y))])
        if self._last_proposal is not None:
            anchors.append(self._last_proposal)
        if not anchors:
            return None
        anchors = np.stack(anchors).astype(np.float32)
        bounds = self.domain.bounds("ordinal")
        span = bounds[:, 1] - bounds[:, 0]
        jit = np.repeat(anchors, n_jitter, axis=0)
        jit = jit + self._rng.normal(0.0, 0.05, jit.shape) * span[None, :]
        return self.domain.round(np.vstack([anchors, jit]))

    def predict(self, X) -> tuple[np.ndarray, np.ndarray]:
        return self.surrogate.predict(X)


def make_strategy(name: str, domain: Domain, seed: int = 0, **kwargs):
    """Strategy registry (parity: data_models/strategies/mapper.py:18-22)."""
    if name in ("BARK", "TreeKernel"):
        return TreeKernelStrategy(domain, seed=seed, **kwargs)
    if name == "BARKPrior":
        sur = BARKPriorSurrogate(domain, seed=seed)
        return TreeKernelStrategy(domain, surrogate=sur, seed=seed, **kwargs)
    if name == "LeafGP":
        # parity: the reference's AnyTreeSurrogate union admits LeafGP into
        # the TreeKernelStrategy (data_models/strategies/tree_kernel.py:31)
        # via the single-forest acquisition builder (opt_model.py:167-284);
        # build_acquisition handles the S=1 model shape directly.
        from bark_jax.models.leafgp import LeafGPSurrogate

        sur = kwargs.pop("surrogate", None) or LeafGPSurrogate(
            domain, seed=seed,
            **{k: kwargs.pop(k) for k in
               ("num_boost_round", "max_depth", "node_limit")
               if k in kwargs},
        )
        return TreeKernelStrategy(domain, surrogate=sur, seed=seed, **kwargs)
    if name == "LeafMOGP":
        from bark_jax.strategies.multi_fidelity import MultiFidelityStrategy

        return MultiFidelityStrategy(domain, seed=seed, **kwargs)
    if name == "Random":
        return RandomStrategy(domain, seed=seed)
    if name in ("BART", "BARTGrid"):
        from bark_jax.models.bart import BARTSurrogate
        from bark_jax.strategies.baselines import GridUCBStrategy

        # default to the native BART posterior; honor an explicit surrogate
        sur = kwargs.pop("surrogate", None) or BARTSurrogate(
            domain, kwargs.pop("bart_params", None), seed=seed
        )
        return GridUCBStrategy(domain, surrogate=sur, seed=seed, **kwargs)
    if name == "GridUCB":
        from bark_jax.strategies.baselines import GridUCBStrategy

        return GridUCBStrategy(domain, seed=seed, **kwargs)
    if name in ("RelaxedSobo", "Sobo", "RelaxedGP"):
        from bark_jax.strategies.baselines import RelaxedGPStrategy

        return RelaxedGPStrategy(domain, seed=seed, **kwargs)
    if name == "SMAC":
        from bark_jax.strategies.baselines import smac_strategy

        return smac_strategy(domain, **kwargs)
    if name == "Entmoot":
        from bark_jax.strategies.baselines import EntmootStrategy

        return EntmootStrategy(domain, **kwargs)
    raise KeyError(f"Unknown strategy: {name}")


class RandomStrategy:
    """Uniform-random baseline (the reference falls back to BoFire's)."""

    # rejection sampling is type-agnostic: everything supported
    SUPPORTED_FEATURES = None
    SUPPORTED_CONSTRAINTS = None

    def __init__(self, domain: Domain, seed: int = 0):
        self.domain = domain
        self._rng = np.random.default_rng(seed)
        self.X = None
        self.y = None

    def tell(self, X, y) -> None:
        self.X = self.domain.transform(X)
        self.y = np.asarray(y, np.float64).reshape(-1)

    def add(self, X_new, y_new) -> None:
        X_new = self.domain.transform(X_new)
        y_new = np.asarray(y_new, np.float64).reshape(-1)
        if self.X is None:
            self.X, self.y = X_new, y_new
        else:
            self.X = np.vstack([self.X, X_new])
            self.y = np.concatenate([self.y, y_new])

    def ask(self, candidate_count: int = 1) -> np.ndarray:
        return sample_feasible(self.domain, candidate_count, self._rng)
