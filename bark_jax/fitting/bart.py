"""Fixed-shape BART: Bayesian Additive Regression Trees by Gibbs backfitting.

The reference wraps pymc-bart for its BART baseline surrogate
(/root/reference/src/bofire_mixed/surrogates/bart.py:29-52 — 50-tree BART,
inverse-gamma noise, NUTS over leaf values). This module is a from-scratch
sum-of-trees sampler in the classic Chipman-George-McCulloch form, built on
bark_jax's fixed-shape forest machinery so the whole chain is one jitted
``lax.scan`` (no external library, no NUTS: leaf values are conjugate and
integrated out of the structure move, which both mixes faster and maps to
fixed shapes).

Model:  y = sum_j g(x; T_j, mu_j) + eps,   eps ~ N(0, sigma2)
        mu_jl ~ N(0, sigma_mu^2) iid,      sigma2 ~ InvGamma(a, b)
        T_j ~ the same alpha(1+d)^-beta branching prior as BARK
        (src/bark/fitting/tree_proposals.py:120-143).

One Gibbs sweep = for each tree j: MH structure move (grow/prune/change via
:func:`bark_jax.fitting.proposals.propose_tree_packed`) scored by the
*marginal* likelihood of the partial residual with leaf values integrated
out (closed form below), then a conjugate-normal draw of all leaf values;
finally an exact inverse-gamma draw of sigma2. Everything is O(N * node_limit)
per tree via one-hot matmuls — no N x N algebra anywhere, so BART scales
to much larger N than the GP paths.

Integrated leaf likelihood (per tree, residual R, leaf counts n_l and
residual sums s_l): summing over leaves of
    0.5*log(sigma2/(sigma2 + n_l*sigma_mu^2))
    + sigma_mu^2 * s_l^2 / (2*sigma2*(sigma2 + n_l*sigma_mu^2))
equals log N(R | 0, sigma2*I + sigma_mu^2*Z Z^T) up to a term constant in
the tree (tested against the dense slogdet form). Empty node slots have
n_l = s_l = 0 and contribute exactly 0, so padding is inert by construction.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bark_jax.forest import (
    DEFAULT_MAX_DEPTH,
    DEFAULT_NODE_LIMIT,
    create_empty_forest,
    pack_forest,
    route_tree,
    unpack_forest,
)
from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.proposals import propose_tree_packed


@dataclass(frozen=True)
class BARTParams:
    """Static BART configuration (hashable; passed as a static jit arg).

    Defaults follow the classic BART recommendation and the reference's
    wrapper (50 trees, inverse-gamma noise —
    src/bofire_mixed/surrogates/bart.py:29-43): y is scaled to [-0.5, 0.5]
    by the surrogate, ``sigma_mu = 0.5 / (k * sqrt(m))`` with k=2, and the
    noise prior is InvGamma(nu/2, nu*lam/2) with nu=3 and lam fit so that
    P(sigma2 < var(y)) = 0.9 (the rate is a *traced* argument to the
    sampler, so per-dataset calibration does not recompile).
    """

    warmup_steps: int = 100
    num_samples: int = 50
    steps_per_sample: int = 1
    num_chains: int = 1

    alpha: float = 0.95
    beta: float = 2.0
    num_trees: int = 50
    k: float = 2.0  # leaf-value prior: sigma_mu = 0.5 / (k * sqrt(m))

    noise_prior_shape: float = 1.5  # nu/2 with nu=3

    grow_prune_weight: float = 0.5
    change_weight: float = 1.0

    node_limit: int = DEFAULT_NODE_LIMIT
    max_depth: int = DEFAULT_MAX_DEPTH

    @property
    def sigma_mu(self) -> float:
        return 0.5 / (self.k * self.num_trees**0.5)

    def proposal_params(self) -> SamplerParams:
        """The SamplerParams view consumed by ``propose_tree_packed``."""
        return SamplerParams(
            alpha=self.alpha,
            beta=self.beta,
            num_trees=self.num_trees,
            grow_prune_weight=self.grow_prune_weight,
            change_weight=self.change_weight,
            node_limit=self.node_limit,
            max_depth=self.max_depth,
        )

    def with_(self, **kwargs) -> "BARTParams":
        return replace(self, **kwargs)


class BARTState(NamedTuple):
    """Per-chain BART chain state (all fixed-shape).

    packed: (m, node_limit, 8) int32 packed trees
    leaf_values: (m, node_limit) f32; zero on non-leaf slots
    leaves: (m, N) int32 cached leaf assignment of every training row
    f_total: (N,) f32 current sum-of-trees fit
    sigma2: () f32
    """

    packed: jax.Array
    leaf_values: jax.Array
    leaves: jax.Array
    f_total: jax.Array
    sigma2: jax.Array


class BARTSamples(NamedTuple):
    """Posterior draws with leading (num_chains, num_samples) axes."""

    packed: jax.Array  # (C, S, m, node_limit, 8)
    leaf_values: jax.Array  # (C, S, m, node_limit)
    sigma2: jax.Array  # (C, S)


def leaf_suff_stats(
    leaves: jax.Array,
    resid: jax.Array,
    node_limit: int,
    mask: jax.Array | None,
) -> tuple[jax.Array, jax.Array]:
    """Per-node-slot counts and residual sums: n_l, s_l of shape (node_limit,).

    One one-hot (N, node_limit) matmul against [1, R] — matmul-friendly and
    exactly zero on slots no point routes to. ``mask`` zeroes padded rows.
    """
    z = jax.nn.one_hot(leaves, node_limit, dtype=jnp.float32)
    if mask is not None:
        z = z * mask[:, None].astype(jnp.float32)
    n_l = jnp.sum(z, axis=0)
    s_l = resid @ z
    return n_l, s_l


def tree_marginal_loglik(
    n_l: jax.Array, s_l: jax.Array, sigma2: jax.Array, sigma_mu2: float
) -> jax.Array:
    """Leaf-integrated log-likelihood of a tree, up to tree-independent terms.

    Equals log N(R | 0, sigma2 I + sigma_mu2 Z Z^T)
    + ||R||^2/(2 sigma2) + (N/2) log(2 pi sigma2)   (both constant in T).
    """
    denom = sigma2 + n_l * sigma_mu2
    return jnp.sum(
        0.5 * jnp.log(sigma2 / denom) + sigma_mu2 * s_l**2 / (2.0 * sigma2 * denom)
    )


def sample_leaf_values(
    key: jax.Array,
    n_l: jax.Array,
    s_l: jax.Array,
    sigma2: jax.Array,
    sigma_mu2: float,
    is_leaf_slot: jax.Array,
) -> jax.Array:
    """Conjugate posterior draw of every leaf value (node_limit,).

    mu_l | R ~ N(sigma_mu2 s_l / (sigma2 + n_l sigma_mu2),
                 sigma2 sigma_mu2 / (sigma2 + n_l sigma_mu2));
    empty/internal slots are forced to 0 so stale values can never leak
    into predictions through a later structural change.
    """
    denom = sigma2 + n_l * sigma_mu2
    post_mean = sigma_mu2 * s_l / denom
    post_sd = jnp.sqrt(sigma2 * sigma_mu2 / denom)
    draw = post_mean + post_sd * jax.random.normal(key, n_l.shape, jnp.float32)
    return jnp.where(is_leaf_slot, draw, 0.0)


def _leaf_slot_mask(packed: jax.Array) -> jax.Array:
    """(node_limit,) bool: slot is an active leaf (packed cols 0=is_leaf, 7=active)."""
    return (packed[:, 0] == 1) & (packed[:, 7] == 1)


def bart_step(
    key: jax.Array,
    state: BARTState,
    X: jax.Array,
    y: jax.Array,
    bounds: jax.Array,
    feat_types: jax.Array,
    params: BARTParams,
    noise_prior_rate: jax.Array,
    mask: jax.Array | None = None,
) -> BARTState:
    """One full Gibbs sweep: m tree moves + leaf draws, then sigma2."""
    m = params.num_trees
    node_limit = params.node_limit
    sigma_mu2 = params.sigma_mu**2
    pparams = params.proposal_params()
    sigma2 = state.sigma2

    k_trees, k_sigma = jax.random.split(key)
    tree_keys = jax.random.split(k_trees, m)

    def visit_tree(f_total, per_tree):
        packed_j, values_j, leaves_j, kj = per_tree
        k_prop, k_acc, k_leaf = jax.random.split(kj, 3)

        g_j = values_j[leaves_j]  # (N,)
        resid = y - (f_total - g_j)
        if mask is not None:
            resid = jnp.where(mask, resid, 0.0)

        new_packed, log_q_prior, _, _ = propose_tree_packed(
            k_prop, packed_j, bounds, feat_types, pparams
        )
        new_leaves = route_tree(
            unpack_forest(new_packed), X, feat_types, params.max_depth
        )

        n_cur, s_cur = leaf_suff_stats(leaves_j, resid, node_limit, mask)
        n_new, s_new = leaf_suff_stats(new_leaves, resid, node_limit, mask)
        log_alpha = (
            tree_marginal_loglik(n_new, s_new, sigma2, sigma_mu2)
            - tree_marginal_loglik(n_cur, s_cur, sigma2, sigma_mu2)
            + log_q_prior
        )
        u = jax.random.uniform(k_acc, dtype=jnp.float32)
        accept = jnp.log(u) <= jnp.minimum(log_alpha, 0.0)

        packed_j = jnp.where(accept, new_packed, packed_j)
        leaves_j = jnp.where(accept, new_leaves, leaves_j)
        n_l = jnp.where(accept, n_new, n_cur)
        s_l = jnp.where(accept, s_new, s_cur)

        values_j = sample_leaf_values(
            k_leaf, n_l, s_l, sigma2, sigma_mu2, _leaf_slot_mask(packed_j)
        )
        g_new = values_j[leaves_j]
        f_total = f_total - g_j + g_new
        return f_total, (packed_j, values_j, leaves_j)

    f_total, (packed, leaf_values, leaves) = jax.lax.scan(
        visit_tree,
        state.f_total,
        (state.packed, state.leaf_values, state.leaves, tree_keys),
    )

    # sigma2 | f ~ InvGamma(shape + n/2, rate + SSR/2), exact Gibbs draw.
    err2 = (y - f_total) ** 2
    if mask is not None:
        err2 = jnp.where(mask, err2, 0.0)
        n_real = jnp.sum(mask.astype(jnp.float32))
    else:
        n_real = jnp.float32(y.shape[0])
    post_shape = params.noise_prior_shape + 0.5 * n_real
    post_rate = noise_prior_rate + 0.5 * jnp.sum(err2)
    g = jax.random.gamma(k_sigma, post_shape, dtype=jnp.float32)
    sigma2 = post_rate / g

    return BARTState(packed, leaf_values, leaves, f_total, sigma2)


def init_bart_state(
    X: jax.Array, params: BARTParams, sigma2_init: float = 1.0
) -> BARTState:
    """All-stump forest, zero leaf values, everything routed to the root."""
    n = X.shape[0]
    forest = create_empty_forest(params.num_trees, params.node_limit)
    packed = jax.vmap(pack_forest)(forest)
    return BARTState(
        packed=packed,
        leaf_values=jnp.zeros((params.num_trees, params.node_limit), jnp.float32),
        leaves=jnp.zeros((params.num_trees, n), jnp.int32),
        f_total=jnp.zeros((n,), jnp.float32),
        sigma2=jnp.float32(sigma2_init),
    )


@functools.partial(jax.jit, static_argnames=("params",))
def run_bart_chain(
    key: jax.Array,
    state: BARTState,
    X: jax.Array,
    y: jax.Array,
    bounds: jax.Array,
    feat_types: jax.Array,
    params: BARTParams,
    noise_prior_rate: jax.Array,
    mask: jax.Array | None = None,
) -> tuple[BARTSamples, BARTState]:
    """Warmup then ``num_samples`` thinned draws from one chain."""

    def one_step(state, k):
        return (
            bart_step(
                k, state, X, y, bounds, feat_types, params, noise_prior_rate, mask
            ),
            None,
        )

    if params.warmup_steps > 0:
        key, k_warm = jax.random.split(key)
        warm_keys = jax.random.split(k_warm, params.warmup_steps)
        state, _ = jax.lax.scan(one_step, state, warm_keys)

    def one_sample(state, k):
        keys = jax.random.split(k, params.steps_per_sample)
        state, _ = jax.lax.scan(one_step, state, keys)
        return state, (state.packed, state.leaf_values, state.sigma2)

    sample_keys = jax.random.split(key, params.num_samples)
    state, (packed, leaf_values, sigma2) = jax.lax.scan(
        one_sample, state, sample_keys
    )
    return BARTSamples(packed, leaf_values, sigma2), state


@functools.partial(jax.jit, static_argnames=("params",))
def run_bart_sampler(
    key: jax.Array,
    X: jax.Array,
    y: jax.Array,
    bounds: jax.Array,
    feat_types: jax.Array,
    params: BARTParams,
    noise_prior_rate: jax.Array,
    mask: jax.Array | None = None,
    init_state: BARTState | None = None,
) -> tuple[BARTSamples, BARTState]:
    """Multi-chain driver: chains vmapped on-chip (like ``run_bark_sampler``).

    Returns samples with leading (num_chains, num_samples) axes plus the
    final per-chain states (for BO warm-starting across ``fit`` calls).
    """
    c = params.num_chains
    keys = jax.random.split(key, c)
    if init_state is None:
        one = init_bart_state(X, params)
        init_state = jax.tree.map(lambda a: jnp.broadcast_to(a, (c,) + a.shape), one)

    def chain(k, st):
        return run_bart_chain(
            k, st, X, y, bounds, feat_types, params, noise_prior_rate, mask
        )

    return jax.vmap(chain)(keys, init_state)


@functools.partial(jax.jit, static_argnames=("max_depth",))
def bart_predict_samples(
    packed: jax.Array,
    leaf_values: jax.Array,
    X: jax.Array,
    feat_types: jax.Array,
    max_depth: int = DEFAULT_MAX_DEPTH,
) -> jax.Array:
    """Per-sample sum-of-trees evaluation f_s(x).

    packed: (S, m, node_limit, 8), leaf_values: (S, m, node_limit),
    X: (M, D) -> (S, M). The flagship posterior-function evaluator for
    grid-UCB asks (reference: strategies/bart_grid.py:41-58 draws
    posterior-predictive samples the same way, through pymc).
    """

    def one_tree(packed_j, values_j):
        leaves = route_tree(unpack_forest(packed_j), X, feat_types, max_depth)
        return values_j[leaves]  # (M,)

    def one_sample(packed_s, values_s):
        return jnp.sum(jax.vmap(one_tree)(packed_s, values_s), axis=0)

    return jax.vmap(one_sample)(packed, leaf_values)
