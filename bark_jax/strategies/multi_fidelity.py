"""Multi-fidelity BO strategy: LeafMOGP surrogate + acquisition search +
information-gain fidelity choice.

Capability parity: the reference *intends* this loop (LeafMOGP at
src/bark/tree_kernels/tree_gps.py:47-77, the single-forest MIP builder's
MOGP branch at src/bark/optimizer/opt_model.py:167-284, and the MES-style
fidelity chooser at src/bark/optimizer/information_based_fidelity.py:16-36)
but never shipped it working — the fidelity module imports a ``BARKMOGP``
that does not exist (SURVEY §2.6). Here the loop is first-class:

  1. ``tell(X, fidelities, y)`` refits the multi-task tree GP on all
     observations (booster forest + index-kernel/noise hypers by exact MLL);
  2. ``ask()`` optimizes the target-fidelity LCB with the same massively
     parallel search + leaf-box centering the BARK strategy uses
     (``build_acquisition_mogp`` + ``propose``), then picks the fidelity by
     information gain per unit cost at the chosen x.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.domain import Domain
from bark_jax.models.mogp import LeafMOGPSurrogate
from bark_jax.models.sampling import fstar_samples_mogp
from bark_jax.optimizer.acquisition import DEFAULT_KAPPA, build_acquisition_mogp
from bark_jax.optimizer.fidelity import propose_fidelity_information_based
from bark_jax.optimizer.search import propose, sample_feasible
from bark_jax.strategies.capabilities import validate_domain
from bark_jax.strategies.tree_kernel import TreeKernelStrategy


class MultiFidelityStrategy:
    """Ask/tell MF-BO driver; ``ask`` returns ``(x (1, D), fidelity int)``."""

    # same search/centering machinery as TreeKernelStrategy -> same
    # declared capabilities (strategies/capabilities.py)
    SUPPORTED_FEATURES = TreeKernelStrategy.SUPPORTED_FEATURES
    SUPPORTED_CONSTRAINTS = TreeKernelStrategy.SUPPORTED_CONSTRAINTS

    def __init__(
        self,
        domain: Domain,
        fidelity_costs: list[float],
        surrogate: LeafMOGPSurrogate | None = None,
        kappa: float = DEFAULT_KAPPA,
        seed: int = 0,
        num_candidates: int = 2048,
        num_rounds: int = 3,
        num_fstar: int = 16,
    ):
        validate_domain(type(self), domain)
        self.domain = domain
        self.fidelity_costs = list(fidelity_costs)
        self.num_tasks = len(self.fidelity_costs)
        self.surrogate = surrogate or LeafMOGPSurrogate(
            domain, num_tasks=self.num_tasks, seed=seed
        )
        self.kappa = kappa
        self.num_candidates = num_candidates
        self.num_rounds = num_rounds
        self.num_fstar = num_fstar
        self._rng = np.random.default_rng(seed)
        self._key = jax.random.key(seed + 1)
        self.X: np.ndarray | None = None
        self.fid: np.ndarray | None = None
        self.y: np.ndarray | None = None

    def tell(self, X, fidelities, y) -> None:
        self.X = self.domain.transform(X)
        self.fid = np.asarray(fidelities, np.int64).reshape(-1)
        self.y = np.asarray(y, np.float64).reshape(-1)
        if self.has_sufficient_experiments():
            self.surrogate.fit(self.X, self.fid, self.y)

    def add(self, X_new, fid_new, y_new) -> None:
        X_new = self.domain.transform(X_new)
        fid_new = np.asarray(fid_new, np.int64).reshape(-1)
        y_new = np.asarray(y_new, np.float64).reshape(-1)
        if self.X is None:
            self.tell(X_new, fid_new, y_new)
        else:
            self.tell(
                np.vstack([self.X, X_new]),
                np.concatenate([self.fid, fid_new]),
                np.concatenate([self.y, y_new]),
            )

    def has_sufficient_experiments(self) -> bool:
        """Every task observed at least once, and >1 point overall."""
        if self.y is None or len(self.y) <= 1:
            return False
        return len(np.unique(self.fid)) == self.num_tasks

    def ask(self) -> tuple[np.ndarray, int]:
        """Next (candidate, fidelity); random (x, round-robin task) before
        the surrogate has enough data."""
        if not self.has_sufficient_experiments() or self.surrogate.train is None:
            x = sample_feasible(self.domain, 1, self._rng)
            # self.y is an ndarray once anything was told — `self.y or []`
            # would raise on >1 elements (round-4 cold-start fix; exactly
            # the state this round-robin branch serves: several points
            # observed but some fidelity still unobserved).
            n_obs = 0 if self.y is None else len(self.y)
            fid = int(n_obs % self.num_tasks)
            return x, fid

        ft = jnp.asarray(self.domain.feature_types())
        acq = build_acquisition_mogp(self.surrogate)
        self._key, k = jax.random.split(self._key)
        x, _ = propose(
            k,
            acq,
            self.domain,
            ft,
            kappa=self.kappa,
            num_candidates=self.num_candidates,
            num_rounds=self.num_rounds,
            rng=self._rng,
        )
        f_star = fstar_samples_mogp(
            self.surrogate, self.X, self.num_fstar, self._rng
        )
        fid = propose_fidelity_information_based(
            self.surrogate, x, self.fidelity_costs, f_star
        )
        return x[None, :], int(fid)

    def predict(self, X, fidelities):
        return self.surrogate.predict(X, fidelities)
