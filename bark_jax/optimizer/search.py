"""Massively parallel acquisition search — the Gurobi-MIP replacement.

The reference solves a mixed-integer program for the global LCB optimum over
the piecewise-constant acquisition, then returns the *center of the active
leaf box* (src/bark/optimizer/proposals.py:43-147). Key structural fact: the
acquisition depends on x only through the leaves x lands in, so it is
constant within the intersection box of those leaves. This search exploits
the same structure with batched scoring:

  1. score a large uniform candidate batch (one fused batched kernel eval),
  2. evolutionary refinement rounds: mutate the top-k candidates with
     per-feature-type moves (Gaussian for continuous, jitter for integer,
     resample for categorical) at a decaying scale,
  3. compute the active leaf box of the winner across every sampled tree
     (exact subspace intersection, vmapped) and return the box center —
     matching the reference's ``_get_leaf_center`` semantics
     (proposals.py:131-147: categorical -> random allowed category, integer
     -> stochastic rounding, continuous -> midpoint).

Because the acquisition is constant on the box, step 3 never degrades the
score; it re-centers the proposal away from arbitrary box edges exactly as
the reference does.

Constraints (the reference lowers them into Gurobi rows,
src/bark/optimizer/opt_core.py:20-58 + src/bofire_mixed/constraints.py:122-152)
are honored in two places, mirroring the reference's two MIPs:

  - the global search adds a feasibility penalty to every scored batch, so
    elites descend toward the feasible region even when a uniform batch
    contains no feasible point (G6's feasible region is ~1e-4 of the box);
  - the leaf-centering step becomes the reference's *constrained* semantics
    (proposals.py:150-214): the feasible point nearest the box center under
    the MIP's distance metric (squared for numerics, +1 per differing
    category), found by sampled projection + segment bisection + an optional
    L-BFGS penalty polish, with the same ε-box-widening retry loop
    (proposals.py:56-66,205-214; ε escalates ×10 so the loop terminates).

Constraint expressions are arbitrary Python callables (the reference's
FunctionalConstraint takes *Gurobi vars*), so this half runs host-side in
numpy — once per BO iteration, off the hot path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.constraints import is_feasible, total_violation
from bark_jax.domain import CategoricalInput, Domain, IntegerInput
from bark_jax.fitting.traversal import node_subspace
from bark_jax.forest import FEAT_CAT, FEAT_INT, Forest, route_forest
from bark_jax.optimizer.acquisition import (
    DEFAULT_KAPPA,
    AcquisitionState,
    evaluate_acquisition,
    evaluate_acquisition_sharded,
)


@functools.partial(jax.jit, static_argnames=("n",))
def _uniform_candidates(
    key: jax.Array, bounds_ord: jax.Array, feat_types: jax.Array, n: int
) -> jax.Array:
    """Uniform batch in ordinal data space (cats/ints uniform over values)."""
    d = bounds_ord.shape[0]
    k_cont, k_disc = jax.random.split(key)
    lb, ub = bounds_ord[:, 0], bounds_ord[:, 1]
    cont = jax.random.uniform(k_cont, (n, d)) * (ub - lb) + lb
    disc = jnp.floor(
        jax.random.uniform(k_disc, (n, d)) * (ub - lb + 1.0) + lb
    )
    disc = jnp.clip(disc, lb, ub)
    is_disc = (feat_types == FEAT_CAT) | (feat_types == FEAT_INT)
    return jnp.where(is_disc[None, :], disc, cont).astype(jnp.float32)


def _mutate(
    key: jax.Array,
    parents: jax.Array,
    bounds_ord: jax.Array,
    feat_types: jax.Array,
    n_children: int,
    sigma: float,
) -> jax.Array:
    """Per-feature-type mutations of top candidates."""
    k_pick, k_mask, k_cont, k_int, k_cat = jax.random.split(key, 5)
    d = parents.shape[1]
    lb, ub = bounds_ord[:, 0], bounds_ord[:, 1]
    span = ub - lb

    idx = jax.random.randint(k_pick, (n_children,), 0, parents.shape[0])
    base = parents[idx]

    mutate_mask = jax.random.uniform(k_mask, (n_children, d)) < 0.3
    cont_step = base + sigma * span * jax.random.normal(k_cont, (n_children, d))
    int_step = base + jnp.round(
        sigma * jnp.maximum(span, 1.0) * jax.random.normal(k_int, (n_children, d))
    )
    cat_step = jnp.floor(
        jax.random.uniform(k_cat, (n_children, d)) * (span + 1.0) + lb
    )

    ft = feat_types[None, :]
    stepped = jnp.where(
        ft == FEAT_CAT, cat_step, jnp.where(ft == FEAT_INT, int_step, cont_step)
    )
    stepped = jnp.clip(stepped, lb, ub)
    return jnp.where(mutate_mask, stepped, base).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("max_depth",))
def _leaf_box(
    acq: AcquisitionState,
    x: jax.Array,
    bounds_bitmask: jax.Array,
    feat_types: jax.Array,
    max_depth: int,
) -> jax.Array:
    """Intersection of the subspaces of every leaf x lands in: ``(D, 2)``.

    Jitted as one program: eagerly this is dozens of small dispatches,
    each paying the host-to-device dispatch latency.

    Parity: the active-area computation in proposals.py:95-117 +
    gbm_model.update_var_bounds — here exact, via the same ``node_subspace``
    walk the sampler uses, vmapped over (samples x trees).
    """

    def per_sample(tree_sample: Forest):
        leaves = route_forest(tree_sample, x[None, :], feat_types, max_depth)[0]

        def per_tree(tree: Forest, leaf_idx):
            return node_subspace(tree, leaf_idx, bounds_bitmask, feat_types, max_depth)

        return jax.vmap(per_tree)(tree_sample, leaves)  # (m, D, 2)

    boxes = jax.vmap(per_sample)(acq.forest)  # (S, m, D, 2)
    boxes = boxes.reshape(-1, *boxes.shape[-2:])

    lo = jnp.max(boxes[:, :, 0], axis=0)
    hi = jnp.min(boxes[:, :, 1], axis=0)
    # categorical: intersect masks with bitwise AND instead
    masks = boxes[:, :, 1].astype(jnp.int32)

    def and_reduce(col):
        return jax.lax.reduce(
            col, jnp.int32(-1), jax.lax.bitwise_and, dimensions=(0,)
        )

    cat_mask = jax.vmap(and_reduce, in_axes=1)(masks).astype(jnp.float32)
    is_cat = feat_types == FEAT_CAT
    lo = jnp.where(is_cat, 0.0, lo)
    hi = jnp.where(is_cat, cat_mask, hi)
    return jnp.stack([lo, hi], axis=1)


def _box_center(
    box: np.ndarray, domain: Domain, rng: np.random.Generator
) -> np.ndarray:
    """Center point of an active-leaf box in ordinal data space.

    Parity: proposals.py:131-147 — categorical: uniform choice among allowed
    categories; integer: midpoint with stochastic rounding; continuous:
    midpoint.
    """
    out = np.zeros((len(domain.inputs),), np.float32)
    for i, feat in enumerate(domain.inputs):
        lb, ub = float(box[i, 0]), float(box[i, 1])
        if isinstance(feat, CategoricalInput):
            mask = int(ub)
            allowed = [c for c in range(len(feat.categories)) if mask & (1 << c)]
            if not allowed:
                allowed = list(range(len(feat.categories)))
            out[i] = rng.choice(allowed)
        elif isinstance(feat, IntegerInput):
            mid = lb + (ub - lb) / 2
            floor = np.floor(mid)
            out[i] = floor + rng.binomial(1, mid - floor)
        else:
            out[i] = lb + (ub - lb) / 2
    return out


# --- constraint handling (host-side numpy; see module docstring) ----------


def _penalize(
    scores: jax.Array, cands: jax.Array, constraints, keys: list[str]
) -> jax.Array:
    """Add a feasibility penalty so selection is feasible-first.

    Infeasible candidates pay the current batch's score span once (a fixed
    step: never preferred over a feasible point of any score in-batch) plus
    a slope proportional to the violation (descent direction toward the
    feasible region). Parity intent: the hard constraint rows of the MIP
    (opt_core.py:20-58).
    """
    if not constraints:
        return scores
    viol = total_violation(constraints, np.asarray(cands, np.float64), keys)
    s = np.asarray(scores, np.float64)
    span = float(np.max(s) - np.min(s)) + 1.0
    return jnp.asarray(s + span * (viol + (viol > 1e-6)), jnp.float32)


def _sample_in_box(
    box: np.ndarray, domain: Domain, rng: np.random.Generator, n: int
) -> np.ndarray:
    """Uniform samples inside an active-leaf box (cats within the mask)."""
    out = np.zeros((n, len(domain.inputs)), np.float32)
    for i, feat in enumerate(domain.inputs):
        lb, ub = float(box[i, 0]), float(box[i, 1])
        if isinstance(feat, CategoricalInput):
            mask = int(ub)
            allowed = [c for c in range(len(feat.categories)) if mask & (1 << c)]
            if not allowed:
                allowed = list(range(len(feat.categories)))
            out[:, i] = rng.choice(allowed, size=n)
        elif isinstance(feat, IntegerInput):
            out[:, i] = rng.integers(int(np.ceil(lb)), int(np.floor(ub)) + 1, size=n)
        else:
            out[:, i] = rng.uniform(lb, ub, size=n)
    return out


def _center_dist(X: np.ndarray, center: np.ndarray, is_cat: np.ndarray):
    """The min-center-dist MIP's metric (proposals.py:180-194): squared
    distance over numerics, +1 per differing category."""
    num = np.where(is_cat[None, :], 0.0, X - center[None, :])
    cat = is_cat[None, :] & (X != center[None, :])
    return (num**2).sum(axis=1) + cat.sum(axis=1)


def _bisect_toward(
    x: np.ndarray,
    center: np.ndarray,
    domain: Domain,
    constraints,
    is_cat: np.ndarray,
    iters: int = 24,
) -> np.ndarray:
    """Largest feasible step from a feasible x toward the center along the
    numeric segment (categories stay put)."""
    keys = domain.input_keys
    lo, hi = 0.0, 1.0

    def at(t):
        trial = x.copy()
        trial[~is_cat] = x[~is_cat] + t * (center[~is_cat] - x[~is_cat])
        return domain.round(trial[None])[0]

    if is_feasible(constraints, at(1.0)[None], keys)[0]:
        return at(1.0)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if is_feasible(constraints, at(mid)[None], keys)[0]:
            lo = mid
        else:
            hi = mid
    return at(lo)


def _penalty_polish(
    x0: np.ndarray,
    center: np.ndarray,
    box: np.ndarray,
    domain: Domain,
    constraints,
    is_cat: np.ndarray,
) -> np.ndarray | None:
    """L-BFGS-B penalty descent on the numeric dims (helps equality
    constraints, which segment bisection cannot hold). Returns a feasible
    point or None."""
    try:
        from scipy.optimize import minimize
    except ImportError:  # pragma: no cover
        return None
    keys = domain.input_keys
    free = np.flatnonzero(~is_cat)
    if free.size == 0:
        return None
    bnds = [(float(box[i, 0]), float(box[i, 1])) for i in free]

    x64 = x0.astype(np.float64)  # float32 would swallow the FD steps
    c64 = center.astype(np.float64)
    for w in (1e3, 1e6, 1e9):

        def objective(z):
            x = x64.copy()
            x[free] = z
            v = total_violation(constraints, x[None], keys)[0]
            d = float(((z - c64[free]) ** 2).sum())
            return d + w * v**2

        res = minimize(objective, x64[free], method="L-BFGS-B", bounds=bnds)
        x = x64.copy()
        x[free] = res.x
        x = domain.round(x[None])[0]
        if is_feasible(constraints, x[None], keys)[0]:
            return x
        x64 = x.astype(np.float64)
    return None


def _widen_box(
    box: np.ndarray, domain: Domain, eps: float, is_cat: np.ndarray
) -> np.ndarray:
    """ε-relax numeric box bounds, clipped to the domain
    (proposals.py:205-214)."""
    bounds = domain.bounds("ordinal")
    out = box.copy()
    out[~is_cat, 0] = np.maximum(box[~is_cat, 0] - eps, bounds[~is_cat, 0])
    out[~is_cat, 1] = np.minimum(box[~is_cat, 1] + eps, bounds[~is_cat, 1])
    return out


def _constrained_center(
    box: np.ndarray,
    domain: Domain,
    constraints,
    rng: np.random.Generator,
    n_local: int = 512,
    max_widen: int = 12,
) -> np.ndarray:
    """Feasible point nearest the active-box center, with ε-widening retries.

    Parity: proposals.py:56-66 (retry loop) + 150-202 (min-center-dist MIP),
    solved here by sampled projection: draw candidates in the box, bisect
    each feasible one toward the center, keep the closest; polish with a
    penalty descent. ε starts at the reference's 1e-5 and escalates ×10 per
    retry so the loop terminates; if the box grows to the whole domain with
    nothing feasible, the minimum-violation point is returned (the reference
    would raise inside Gurobi instead — a random fallback happens one level
    up in the strategy either way).
    """
    keys = domain.input_keys
    is_cat = np.array(
        [isinstance(f, CategoricalInput) for f in domain.inputs], bool
    )
    eps = 1e-5
    best_fallback, best_fallback_viol = None, np.inf

    for _ in range(max_widen):
        center = _box_center(box, domain, rng)
        if is_feasible(constraints, center[None], keys)[0]:
            return center

        cand = np.vstack([center[None], _sample_in_box(box, domain, rng, n_local)])
        viol = total_violation(constraints, cand, keys)
        feas = viol <= 1e-6

        i_min = int(np.argmin(viol))
        if viol[i_min] < best_fallback_viol:
            best_fallback, best_fallback_viol = cand[i_min], viol[i_min]

        if feas.any():
            feas_pts = cand[feas]
            dists = _center_dist(feas_pts, center, is_cat)
            # bisect the few closest feasible points toward the center
            order = np.argsort(dists)[:8]
            refined = np.stack(
                [
                    _bisect_toward(feas_pts[j], center, domain, constraints, is_cat)
                    for j in order
                ]
            )
            refined_d = _center_dist(refined, center, is_cat)
            best = refined[int(np.argmin(refined_d))]
            polished = _penalty_polish(
                best, center, box, domain, constraints, is_cat
            )
            if polished is not None and _center_dist(
                polished[None], center, is_cat
            )[0] < _center_dist(best[None], center, is_cat)[0]:
                best = polished
            return best

        # nothing feasible in the box: try a penalty descent from the least
        # violating point before widening
        polished = _penalty_polish(
            cand[i_min], center, box, domain, constraints, is_cat
        )
        if polished is not None:
            return polished

        box = _widen_box(box, domain, eps, is_cat)
        eps *= 10.0

    # all retries exhausted: project the least-violating point found onto
    # the feasible region before conceding (the reference would raise in
    # Gurobi here; we prefer a feasible point further from the center over
    # an infeasible one near it)
    if best_fallback is not None:
        x = _violation_descent(best_fallback, domain, constraints, is_cat)
        if is_feasible(constraints, x[None], keys)[0]:
            return x
        return best_fallback
    return _box_center(box, domain, rng)


def _margin_violation(
    constraints, X: np.ndarray, keys: list[str], margin_rel: float
) -> np.ndarray:
    """total_violation with inequality rows tightened per-constraint — descent
    targets (slightly) the strict interior so float32 rounding of the result
    cannot push it back over the boundary. The margin scales with each
    constraint's magnitude (``margin_rel * (|rhs| + 1)``): float32 rounding
    of x perturbs a constraint of magnitude ~1e6 (PressureVessel's volume)
    by ~0.1, so any absolute margin is either too loose or too tight
    somewhere."""
    out = np.zeros(X.shape[0], np.float64)
    for c in constraints:
        try:
            g = np.asarray(c.expr(X, keys), np.float64) - c.rhs
            m = margin_rel * (abs(float(c.rhs)) + 1.0)
            out += np.abs(g) if c.is_equality else np.maximum(g + m, 0.0)
        except NotImplementedError:  # NChooseK has no smooth expr
            out += c.violation(X, keys)
    return out


def _violation_descent(
    x0: np.ndarray, domain: Domain, constraints, is_cat: np.ndarray
) -> np.ndarray:
    """L-BFGS-B descent on the squared total violation over numeric dims.

    Turns a near-feasible draw into a feasible one when rejection sampling
    is hopeless (G6's feasible region is ~1e-5 of its box)."""
    try:
        from scipy.optimize import minimize
    except ImportError:  # pragma: no cover
        return x0
    keys = domain.input_keys
    free = np.flatnonzero(~is_cat)
    if free.size == 0:
        return x0
    bounds = domain.bounds("ordinal")
    bnds = [(float(bounds[i, 0]), float(bounds[i, 1])) for i in free]

    x64 = x0.astype(np.float64)  # float32 would swallow the FD steps

    def objective(z):
        x = x64.copy()
        x[free] = z
        return float(_margin_violation(constraints, x[None], keys, 1e-6)[0] ** 2)

    res = minimize(objective, x64[free], method="L-BFGS-B", bounds=bnds)
    x = x64.copy()
    x[free] = res.x
    return domain.round(x[None])[0]


def sample_feasible(
    domain: Domain,
    n: int,
    rng: np.random.Generator,
    constraints=None,
    max_tries: int = 16,
) -> np.ndarray:
    """Rejection-sample feasible domain points, polishing near-misses with a
    violation descent when the feasible region is too small to hit.

    The reference's random fallback goes through BoFire's RandomStrategy,
    which also rejection-samples declared constraints."""
    constraints = domain.constraints if constraints is None else constraints
    if not constraints:
        return domain.sample(n, rng)
    keys = domain.input_keys
    is_cat = np.array(
        [isinstance(f, CategoricalInput) for f in domain.inputs], bool
    )
    out: list[np.ndarray] = []
    near_misses: list[tuple[float, np.ndarray]] = []
    for _ in range(max_tries):
        X = domain.sample(max(n * 8, 64), rng)
        viol = total_violation(constraints, X, keys)
        feas = np.flatnonzero(viol <= 1e-6)
        out.extend(X[feas][: n - len(out)])
        for i in np.argsort(viol)[:4]:
            near_misses.append((float(viol[i]), X[i]))
        if len(out) >= n:
            return np.stack(out[:n])
    # polish the least-violating draws into feasibility
    near_misses.sort(key=lambda t: t[0])
    for _, x0 in near_misses:
        x = _violation_descent(x0, domain, constraints, is_cat)
        if is_feasible(constraints, x[None], keys)[0]:
            out.append(x)
        if len(out) >= n:
            return np.stack(out[:n])
    # give up gracefully: pad with the minimum-violation points found
    pad = [x for _, x in near_misses[: n - len(out)]]
    return np.stack(list(out) + pad)


def propose(
    key: jax.Array,
    acq: AcquisitionState,
    domain: Domain,
    feat_types: jax.Array,
    kappa: float = DEFAULT_KAPPA,
    num_candidates: int = 4096,
    num_rounds: int = 4,
    top_k: int = 64,
    max_depth: int = 16,
    return_center: bool = True,
    rng: np.random.Generator | None = None,
    constraints=None,
    seeds: np.ndarray | None = None,
    mesh=None,
) -> tuple[np.ndarray, float]:
    """Optimize the acquisition; returns (proposal ordinal point, acq value).

    Parity: src/bark/optimizer/proposals.py:43-70 (propose -> global solution
    -> leaf center), with the MIP replaced by batched sampled search. Domain
    constraints are enforced by penalty during the search and exactly at the
    centering step. ``seeds`` (K, D) warm-starts round 0 — the analogue of
    the reference's MIP warm start (opt_model.py:120-164). Pass ``mesh`` (a
    1-D ``candidates`` mesh) to shard candidate scoring across chips.
    """
    rng = rng or np.random.default_rng()
    constraints = domain.constraints if constraints is None else constraints
    keys = domain.input_keys
    bounds_ord = jnp.asarray(domain.bounds("ordinal"))
    bounds_bitmask = jnp.asarray(domain.bounds("bitmask"))

    key, k0 = jax.random.split(key)
    cands = _uniform_candidates(k0, bounds_ord, feat_types, num_candidates)
    if seeds is not None and len(seeds):
        k = min(len(seeds), num_candidates)
        cands = cands.at[:k].set(jnp.asarray(seeds[:k], jnp.float32))

    def score(batch):
        if mesh is not None:
            return evaluate_acquisition_sharded(
                acq, batch, feat_types, mesh, max_depth, kappa
            )
        return evaluate_acquisition(acq, batch, feat_types, max_depth, kappa)

    scores = _penalize(score(cands), cands, constraints, keys)

    _, best_idx = jax.lax.top_k(-scores, top_k)
    elites, elite_scores = cands[best_idx], scores[best_idx]

    sigma = 0.2
    for _ in range(num_rounds):
        key, k_mut = jax.random.split(key)
        children = _mutate(
            k_mut, elites, bounds_ord, feat_types, num_candidates, sigma
        )
        child_scores = _penalize(score(children), children, constraints, keys)
        pool = jnp.concatenate([elites, children])
        pool_scores = jnp.concatenate([elite_scores, child_scores])
        _, best_idx = jax.lax.top_k(-pool_scores, top_k)
        elites, elite_scores = pool[best_idx], pool_scores[best_idx]
        sigma *= 0.5

    x_best = elites[0]
    best_val = float(elite_scores[0])

    if return_center:
        box = np.asarray(
            _leaf_box(acq, x_best, bounds_bitmask, feat_types, max_depth)
        )
        if constraints:
            center = _constrained_center(box, domain, constraints, rng)
            # Final feasibility gate, judged on the FLOAT32 round-trip of
            # the point: the centering works in f64 and loves the
            # constraint boundary (the constrained optimum usually sits
            # there), but a boundary-exact point flips infeasible under
            # downstream f32 casts (measured: PressureVessel's 1.3e6-scale
            # volume constraint moves ~0.1 per f32 ulp of x). Repair with
            # the margin-targeting violation descent, then feasible
            # sampling — a constrained ask never proposes an
            # f32-infeasible candidate while any feasible point is
            # findable (>=95% feasible-rate target).
            def f32_ok(x):
                x32 = np.asarray(x, np.float32).astype(np.float64)
                return bool(is_feasible(constraints, x32[None], keys)[0])

            if not f32_ok(center):
                is_cat = np.array(
                    [isinstance(f, CategoricalInput) for f in domain.inputs],
                    bool,
                )
                x = _violation_descent(
                    np.asarray(center, np.float64), domain, constraints, is_cat
                )
                if f32_ok(x):
                    center = x
                else:
                    center = sample_feasible(domain, 1, rng, constraints)[0]
            return np.asarray(center, np.float64), best_val
        center = _box_center(box, domain, rng)
        return center, best_val
    return np.asarray(x_best), best_val
