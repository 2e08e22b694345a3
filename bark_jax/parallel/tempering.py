"""Parallel tempering over forest posteriors.

A replica ladder runs the BARK transition kernel at inverse temperatures
1 = beta_0 > beta_1 > ... > beta_{R-1} (likelihood tempering), with
even-odd adjacent swap moves between rounds. Temperatures are exchanged
rather than states (the standard trick: states stay resident, the beta
*labels* move), so a swap is O(1) regardless of forest size. Samples are
emitted from whichever replica currently holds beta = 1.

This is a new capability over the reference (BASELINE.json north star) —
the reference has only plain MH chains. Two implementations:

  - ``run_parallel_tempering`` — replicas vmapped on one chip, label-moving
    swaps (``swap_move``: betas migrate, states stay put).
  - ``run_parallel_tempering_sharded`` — one replica per device on a
    ``replicas`` mesh axis, *fixed-position* ladder (device r always holds
    beta_r), deterministic even-odd (DEO) rounds. A swap exchanges the
    partner replicas' (mll) scalar and then the full chain state over ICI
    with ``jax.lax.ppermute`` (``sharded_pt_swap``); the accept draw is
    derived from ``fold_in(key, left_position)`` so both partners decide
    identically without extra communication. ``pt_swap_states`` is the
    bit-identical single-device reference used by the tests.

The two schemes are statistically equivalent (same stationary distribution,
same pairwise accept rule); they are not trajectory-identical because the
label-moving variant draws its uniforms differently.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.sampler import (
    BARKModel,
    ChainState,
    init_chain_state,
    step,
)
from bark_jax.forest import Forest


class PTState(NamedTuple):
    chains: ChainState  # fields with leading (R,) replica axis
    betas: jax.Array  # (R,) inverse temperatures (a permutation of ladder)


def geometric_ladder(num_replicas: int, beta_min: float = 0.05) -> jax.Array:
    """Geometric inverse-temperature ladder from 1 down to beta_min."""
    if num_replicas == 1:
        return jnp.ones((1,), jnp.float32)
    return jnp.asarray(
        beta_min ** (jnp.arange(num_replicas) / (num_replicas - 1)), jnp.float32
    )


def swap_move(key: jax.Array, betas: jax.Array, mlls: jax.Array, parity: jax.Array):
    """Even-odd adjacent swap of temperatures (by ladder rank).

    Replicas are ranked by beta (descending); pairs (0,1),(2,3),... on even
    parity, (1,2),(3,4),... on odd. Accept a swap with probability
    min(1, exp((beta_i - beta_j) * (mll_j - mll_i))).
    """
    r = betas.shape[0]
    order = jnp.argsort(-betas)  # replica ids ranked hot->cold by beta rank
    ranked_betas = betas[order]
    ranked_mlls = mlls[order]

    idx = jnp.arange(r)
    is_left = (idx % 2) == (parity % 2)
    partner = jnp.where(is_left, idx + 1, idx - 1)
    valid = (partner >= 0) & (partner < r)
    partner = jnp.clip(partner, 0, r - 1)

    delta = (ranked_betas - ranked_betas[partner]) * (
        ranked_mlls[partner] - ranked_mlls
    )
    u = jax.random.uniform(key, (r,))
    # one draw per pair: the left member's uniform decides for both
    pair_u = jnp.where(is_left, u, u[partner])
    pair_delta = jnp.where(is_left, delta, delta[partner])
    accept = valid & (jnp.log(pair_u) <= jnp.minimum(pair_delta, 0.0))

    new_ranked_betas = jnp.where(accept, ranked_betas[partner], ranked_betas)
    # scatter back to replica ids
    return betas.at[order].set(new_ranked_betas)


# --- fixed-position (DEO) swaps: single-device reference + sharded --------


def _deo_partners(idx: jax.Array, parity: int, r: int):
    """Even-odd pairing by ladder position: positions (parity, parity+1),
    (parity+2, parity+3), ... Returns (partner, valid, left_position)."""
    is_left = ((idx - parity) % 2) == 0
    partner = jnp.where(is_left, idx + 1, idx - 1)
    valid = (partner >= 0) & (partner < r)
    left = jnp.minimum(idx, jnp.clip(partner, 0, r - 1))
    return jnp.clip(partner, 0, r - 1), valid, left


def _swap_accept(key, beta, nbr_beta, mll, nbr_mll, left, valid):
    """Pairwise PT accept bit, identical on both partners: the *left*
    position's fold_in stream supplies the uniform."""
    delta = (beta - nbr_beta) * (nbr_mll - mll)
    u = jax.random.uniform(jax.random.fold_in(key, left))
    return valid & (jnp.log(u) <= jnp.minimum(delta, 0.0))


def pt_swap_states(
    key: jax.Array, chains, betas: jax.Array, mlls: jax.Array, parity: int
):
    """Single-device fixed-position swap: betas stay attached to positions,
    accepted pairs exchange full chain *states*. Bit-identical math to
    ``sharded_pt_swap`` (the tests assert it). Returns (chains, accepts)."""
    r = betas.shape[0]
    idx = jnp.arange(r)
    partner, valid, left = _deo_partners(idx, parity, r)
    accept = jax.vmap(
        lambda b, nb, m, nm, lf, v: _swap_accept(key, b, nb, m, nm, lf, v)
    )(betas, betas[partner], mlls, mlls[partner], left, valid)
    take = jnp.where(accept, partner, idx)
    return jax.tree.map(lambda a: a[take], chains), accept


def _deo_perm(r: int, parity: int) -> list[tuple[int, int]]:
    """Static bidirectional ppermute pairing for one DEO phase."""
    perm = []
    for a in range(parity, r - 1, 2):
        perm += [(a, a + 1), (a + 1, a)]
    return perm


def sharded_pt_swap(
    key: jax.Array,
    chains,
    beta: jax.Array,
    mll: jax.Array,
    parity: int,
    axis_name: str,
    num_replicas: int,
):
    """One DEO swap phase with one replica per device on ``axis_name``.

    Exchanges the partner's (beta, mll) scalars and the full chain state via
    ``ppermute`` over ICI; each pair decides from the shared
    ``fold_in(key, left_position)`` uniform so no accept bit needs to travel.
    Unpaired edge devices receive ppermute zeros and keep their state
    (``valid`` is False there). Returns (chains, accept) for this device.
    """
    perm = _deo_perm(num_replicas, parity)
    i = jax.lax.axis_index(axis_name)
    partner, valid, left = _deo_partners(i, parity, num_replicas)
    del partner  # implicit in the static perm
    nbr_beta = jax.lax.ppermute(beta, axis_name, perm)
    nbr_mll = jax.lax.ppermute(mll, axis_name, perm)
    accept = _swap_accept(key, beta, nbr_beta, mll, nbr_mll, left, valid)
    nbr_chains = jax.tree.map(
        lambda a: jax.lax.ppermute(a, axis_name, perm), chains
    )
    new_chains = jax.tree.map(
        lambda a, b: jnp.where(accept, b, a), chains, nbr_chains
    )
    return new_chains, accept


def run_parallel_tempering_sharded(
    key: jax.Array,
    forest: Forest,
    noise: jax.Array,
    scale: jax.Array,
    X: jax.Array,
    y: jax.Array,
    bounds: jax.Array,
    feat_types: jax.Array,
    params: SamplerParams,
    mesh: jax.sharding.Mesh,
    num_steps: int = 100,
    beta_min: float = 0.05,
    mask: jax.Array | None = None,
    axis_name: str = "replicas",
) -> tuple[BARKModel, jax.Array]:
    """PT with one replica per device over a ``replicas`` mesh axis.

    ``forest``/``noise``/``scale`` carry a leading (R,) axis with R equal to
    the mesh size. Each round runs one tempered MCMC step per replica, then
    an even and an odd ``sharded_pt_swap`` phase (DEO). Device 0 always
    holds beta=1 (DEO swaps states between fixed temperatures, never the
    temperatures themselves), so the cold chain is device 0's trace: each
    device keeps its own (num_steps,) state trace as a *sharded* scan
    output and the cold samples are sliced out after the shard_map — no
    cross-replica communication for sample extraction at all (an earlier
    version psum'd the full forest state across all replicas every round,
    an all-reduce costing (R-1)x the useful traffic). Returns (num_steps,)
    cold samples plus a (num_steps,) mean swap-rate trace.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    num_replicas = mesh.shape[axis_name]
    ladder = geometric_ladder(num_replicas, beta_min)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis_name), P(axis_name), P(axis_name), P(), P(), P(), P()),
        out_specs=(P(None, axis_name), P()),
        check_vma=False,
    )
    def run(key, forest, noise, scale, X, y, bounds, feat_types):
        # local block has leading axis 1 (one replica per device)
        forest_l = jax.tree.map(lambda a: a[0], forest)
        i = jax.lax.axis_index(axis_name)
        beta = jnp.asarray(ladder)[i]
        state = init_chain_state(
            forest_l, noise[0], scale[0], X, y, feat_types, params, mask,
            bounds=bounds,
        )

        def one_round(carry, k):
            state = carry
            k_step, k_even, k_odd = jax.random.split(k, 3)
            state = step(
                k_step, state, X, y, bounds, feat_types, params, mask, beta=beta
            )
            state, acc_e = sharded_pt_swap(
                k_even, state, beta, state.mll, 0, axis_name, num_replicas
            )
            state, acc_o = sharded_pt_swap(
                k_odd, state, beta, state.mll, 1, axis_name, num_replicas
            )
            # each accepted pair sets the accept bit on BOTH partners, so
            # the psum counts every swap twice; R-1 = adjacent pairs across
            # the two DEO phases. Cast before adding: bool + bool is a
            # logical OR and would count a replica that swapped in both
            # phases once.
            swap_rate = jax.lax.psum(
                acc_e.astype(jnp.float32) + acc_o.astype(jnp.float32),
                axis_name,
            ) / (2.0 * max(num_replicas - 1, 1))
            # every device records ITS OWN state (leading axis 1 = this
            # replica's slot in the sharded (T, R, ...) trace output);
            # the cold slice happens outside the shard_map, communication-free
            mine = jax.tree.map(
                lambda a: a[None], (state.forest, state.noise, state.scale)
            )
            return state, (mine, swap_rate)

        _, (trace, swap_rates) = jax.lax.scan(
            one_round, state, jax.random.split(key, num_steps)
        )
        return trace, swap_rates

    (forest_t, noise_t, scale_t), swap_rates = run(
        key, forest, noise, scale, X, y, bounds, feat_types
    )
    # device 0 owns beta=1; pulling [:, 0] reads one shard, no collective
    cold_forest, cold_noise, cold_scale = jax.tree.map(
        lambda a: a[:, 0], (forest_t, noise_t, scale_t)
    )
    samples = BARKModel(forest=cold_forest, noise=cold_noise, scale=cold_scale)
    return samples, swap_rates


@functools.partial(jax.jit, static_argnames=("params", "num_replicas", "num_steps"))
def run_parallel_tempering(
    key: jax.Array,
    forest: Forest,
    noise: jax.Array,
    scale: jax.Array,
    X: jax.Array,
    y: jax.Array,
    bounds: jax.Array,
    feat_types: jax.Array,
    params: SamplerParams,
    num_replicas: int = 8,
    num_steps: int = 100,
    beta_min: float = 0.05,
    mask: jax.Array | None = None,
) -> tuple[BARKModel, jax.Array, jax.Array, jax.Array]:
    """Run one PT ladder; returns cold-chain samples + swap diagnostics.

    ``forest``/``noise``/``scale`` carry a leading (num_replicas,) axis.
    Returns (cold samples over steps, beta trace (T, R), mean swap rate,
    cold-chain MLL trace (T,) — the time-to-target diagnostic consumed by
    tools/ab_tempered.py and convergence reporting).
    """
    chains = jax.vmap(
        lambda f, n, s: init_chain_state(
            f, n, s, X, y, feat_types, params, mask, bounds=bounds
        )
    )(forest, noise, scale)
    betas = geometric_ladder(num_replicas, beta_min)
    state = PTState(chains=chains, betas=betas)

    def one_round(carry, inputs):
        state, parity = carry
        k = inputs
        k_steps, k_swap = jax.random.split(k)
        keys = jax.random.split(k_steps, num_replicas)
        chains = jax.vmap(
            lambda kk, c, b: step(
                kk, c, X, y, bounds, feat_types, params, mask, beta=b
            )
        )(keys, state.chains, state.betas)

        old_betas = state.betas
        betas = swap_move(k_swap, state.betas, chains.mll, parity)
        swapped_frac = jnp.mean((betas != old_betas).astype(jnp.float32))

        # cold-chain sample: the replica currently holding beta == 1
        cold = jnp.argmax(betas)
        cold_sample = (
            jax.tree.map(lambda a: a[cold], chains.forest),
            chains.noise[cold],
            chains.scale[cold],
            chains.mll[cold],
        )
        return (PTState(chains, betas), parity + 1), (
            cold_sample,
            betas,
            swapped_frac,
        )

    keys = jax.random.split(key, num_steps)
    (state, _), (cold_samples, beta_trace, swap_frac) = jax.lax.scan(
        one_round, (state, jnp.int32(0)), keys
    )
    cold_forest, cold_noise, cold_scale, cold_mll = cold_samples
    samples = BARKModel(forest=cold_forest, noise=cold_noise, scale=cold_scale)
    return samples, beta_trace, jnp.mean(swap_frac), cold_mll
