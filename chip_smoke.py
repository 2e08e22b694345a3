"""Smoke run of BARK's main path on one NVIDIA GPU, in one process.

    python chip_smoke.py               # phases a-d on one card
    python chip_smoke.py --four-cards  # phase e only, on four cards

Phases (one card):

  a. the BO loop at the reference's defaults through the strategy API
     (``make_strategy`` -> ``tell`` -> ``ask``/``add``);
  b. the large-N tier along ``examples/bo_largen.py`` at N ~ 4096: leaf-space
     refresh, row-blocked LR acquisition, leaf predict;
  c. sampler throughput (``bench.measure``) at N=50 and N=1024, and what
     XLA makes of the plain refresh Cholesky and one-hot Gram;
  d. comparisons with the plain references at real widths: the two leaf
     routers (ids must be equal) and the sampler's float32 MLL, after the
     refresh and carried out of the move scan, against float64 on the host.

``--four-cards`` runs only phase e: the chain-sharded sampler and sharded
parallel tempering over four cards, each against the same computation on
one card.

Every timing and comparison line names the card and its power limit. Any
failed phase ends the run with a non-zero exit and no result line; without
a GPU it exits before any phase. The last line of a passing run is the JSON
object ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib.util
import io
import json
import logging
import pathlib
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from bench import card_line, require_gpu

ROOT = pathlib.Path(__file__).resolve().parent
ASK_LOGGER = "bark_jax.strategies.tree_kernel"


class PhaseError(RuntimeError):
    """A phase produced a wrong or missing result."""


def parse_card_line(line: str) -> tuple[str, str]:
    """Split ``nvidia-smi``'s ``name, power.limit`` line into its fields."""
    name, sep, power = line.strip().rpartition(",")
    if not sep or not name.strip() or not power.strip():
        raise ValueError(f"not a 'name, power.limit' line: {line!r}")
    return name.strip(), power.strip()


def result_line(devices) -> str:
    """The run's last line: the device as JAX reports it."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    })


def mll_tolerance(mll: float) -> float:
    """Allowed |f32 - f64| in nats: MH accepts compare O(1)-nat log-ratios,
    so 1e-2 moves an acceptance probability by about 1%."""
    return 1e-4 * abs(mll) + 1e-2


def mll_float64(leaves, y, noise, scale, node_limit: int) -> float:
    """The exact BARK MLL in float64 (no padding), up to the N/2 log 2pi term.

    K = (scale / m) * counts + (jitter + noise) * I, where counts[i, j] is
    the number of trees in which rows i and j share a leaf (ops/linalg.py).
    """
    from scipy.linalg import solve_triangular

    from bark_jax.ops.linalg import JITTER

    leaves = np.asarray(leaves, np.int64)
    n, m = leaves.shape
    Z = np.zeros((n, m * node_limit))
    Z[np.arange(n)[:, None], np.arange(m) * node_limit + leaves] = 1.0
    K = (float(scale) / m) * (Z @ Z.T)
    K[np.diag_indices(n)] += JITTER + float(noise)
    L = np.linalg.cholesky(K)
    z = solve_triangular(L, np.asarray(y, np.float64).reshape(-1), lower=True)
    return 0.5 * (-(z @ z) - 2.0 * np.log(np.diag(L)).sum())


class _Counter(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.WARNING)
        self.records: list[logging.LogRecord] = []

    def emit(self, record):
        self.records.append(record)


@contextlib.contextmanager
def watch_ask_fallback():
    """Count the strategy's random-candidate fallbacks inside the block.

    ``TreeKernelStrategy.ask`` answers any exception with a random point
    and a WARNING on its module logger; a lowering failure on the card
    would otherwise look like a working BO loop.
    """
    logger = logging.getLogger(ASK_LOGGER)
    counter = _Counter()
    old_level = logger.level
    logger.addHandler(counter)
    if logger.getEffectiveLevel() > logging.WARNING:
        logger.setLevel(logging.WARNING)
    try:
        yield counter
    finally:
        logger.removeHandler(counter)
        logger.setLevel(old_level)


def check_no_fallback(counter: _Counter, phase: str) -> None:
    if counter.records:
        raise PhaseError(
            f"{phase}: ask fell back to a random candidate "
            f"{len(counter.records)} time(s): {counter.records[0].getMessage()}"
        )


def check_candidate(cand, domain, phase: str) -> None:
    cand = np.asarray(cand, np.float64)
    bounds = np.asarray(domain.bounds("ordinal"), np.float64)
    if cand.shape != (1, bounds.shape[0]) or not np.isfinite(cand).all():
        raise PhaseError(f"{phase}: bad candidate {cand!r}")
    if ((cand < bounds[:, 0]) | (cand > bounds[:, 1])).any():
        raise PhaseError(f"{phase}: candidate {cand!r} outside {bounds!r}")


def median_seconds(fn, *args, repeats: int = 5) -> float:
    """Median wall time of ``fn(*args)`` to completion, after one warm call."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


class Report:
    """Prints one labelled line per timing or comparison."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, phase: str, **fields):
        print(f"[{self.card}] {phase}: {json.dumps(fields)}", flush=True)


def phase_bo_loop(report, n_init=10, n_iter=5, num_candidates=4096,
                  num_rounds=4, dim=5, num_trees=50):
    """a. BO at the reference's defaults (examples/configs/model_bark.yaml)."""
    from bark_jax.benchmarks.tree_function import TreeFunction
    from bark_jax.fitting.params import SamplerParams
    from bark_jax.strategies.tree_kernel import make_strategy

    bench = TreeFunction(dim=dim, m=50, function_seed=1)
    params = SamplerParams(warmup_steps=50, num_samples=5, steps_per_sample=10,
                           num_chains=1, num_trees=num_trees)
    strat = make_strategy("BARK", bench.domain, seed=0, params=params,
                          num_candidates=num_candidates, num_rounds=num_rounds)
    X = bench.domain.sample(n_init, np.random.default_rng(0))
    with watch_ask_fallback() as fallbacks:
        t0 = time.perf_counter()
        strat.tell(X, bench.f(X))
        jax.block_until_ready(strat.surrogate.model)
        first_fit_s = time.perf_counter() - t0
        its = []
        for _ in range(n_iter):
            t0 = time.perf_counter()
            cand = strat.ask(1)
            ask_s = time.perf_counter() - t0
            check_candidate(cand, bench.domain, "a")
            t0 = time.perf_counter()
            strat.add(cand, bench.f(cand))
            jax.block_until_ready(strat.surrogate.model)
            its.append({"ask_s": ask_s, "fit_s": time.perf_counter() - t0})
    check_no_fallback(fallbacks, "a")
    if not np.isfinite(strat.y).all():
        raise PhaseError("a: non-finite objective values")
    report("a.bo_loop.setup", first_fit_s=first_fit_s, **its[0],
           note="includes compilation")
    for i, it in enumerate(its[1:], start=1):
        report("a.bo_loop.iteration", iter=i, n_train=n_init + i, **it)
    report("a.bo_loop.result", asks=len(its), best_y=float(strat.y.min()),
           fallbacks=len(fallbacks.records))
    return strat


def phase_large_n(report, n_init=4080, num_iter=2, num_candidates=4096,
                  num_chains=4, num_samples=4):
    """b. The large-N tier along examples/bo_largen.py."""
    from bark_jax.fitting.sampler import _resolve_styles
    from bark_jax.optimizer.acquisition import LR_THRESHOLD

    spec = importlib.util.spec_from_file_location(
        "bo_largen", ROOT / "examples" / "bo_largen.py"
    )
    bo_largen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bo_largen)
    # the driver prints an unlabelled record per iteration; report it below
    with watch_ask_fallback() as fallbacks, \
            contextlib.redirect_stdout(io.StringIO()):
        res, strat = bo_largen.run_study(
            seed=0, n_init=n_init, num_iter=num_iter,
            num_candidates=num_candidates, num_chains=num_chains,
            num_samples=num_samples, return_strategy=True,
        )
    check_no_fallback(fallbacks, "b")
    for rec in res["iterations"]:
        check_candidate([rec["candidate"]], strat.domain, "b")
    train_x = strat.surrogate.train_data[0]
    n_pad = int(train_x.shape[0])
    styles = _resolve_styles(strat.surrogate.params, n_pad)
    X_test = strat.domain.sample(256, np.random.default_rng(3))
    t0 = time.perf_counter()
    mu, std = strat.surrogate.predict(X_test)
    predict_s = time.perf_counter() - t0
    if mu.shape != (256, 1) or not (np.isfinite(mu).all()
                                    and np.isfinite(std).all()):
        raise PhaseError(f"b: predict gave {mu.shape} / non-finite values")
    report("b.large_n.setup", n_pad=n_pad, first_fit_s=res["initial_fit_s"],
           refresh=styles.refresh_style, scan=styles.scan_style,
           lr_acquisition=n_pad > LR_THRESHOLD,
           leaf_predict=n_pad > strat.surrogate.cg_threshold,
           note="first fit includes compilation")
    for rec in res["iterations"]:
        report("b.large_n.iteration", iter=rec["iter"], n_train=rec["n_train"],
               ask_s=rec["ask_s"], fit_s=rec["fit_s"])
    report("b.large_n.predict", rows=256, seconds=predict_s,
           note="first call includes compilation")
    if styles.refresh_style != "leaf" or n_pad <= LR_THRESHOLD:
        raise PhaseError("b: the large-N tier was not reached")


def phase_throughput(report, sizes=(50, 1024), num_chains=64):
    """c. Sampler steps/s (bench.measure); informational only."""
    from bench import measure

    for n in sizes:
        res = measure(n_train=n, num_chains=num_chains)
        report("c.sampler_throughput", n_train=n, num_chains=num_chains,
               steps_per_s=res["value"], setup_s=res["setup_s"])


def phase_plain_xla(report, chol_sizes=(256, 384), chol_batch=128,
                    gram_sizes=(200, 2048), num_trees=50, node_limit=64):
    """c. What XLA makes of the plain refresh Cholesky and one-hot Gram: the
    bar a hand-written kernel for either would have to beat."""
    from bark_jax.forest import gram_from_leaves

    rng = np.random.default_rng(0)
    chol = jax.jit(jnp.linalg.cholesky)
    for r in chol_sizes:
        Z = rng.integers(0, 2, size=(chol_batch, 2 * r, r)).astype(np.float32)
        A = jnp.asarray((np.einsum("bnr,bns->brs", Z, Z) + r * np.eye(r))
                        .astype(np.float32))
        report("c.plain_xla.cholesky", shape=[chol_batch, r, r],
               ms=1e3 * median_seconds(chol, A))
    gram = jax.jit(functools.partial(gram_from_leaves, node_limit=node_limit))
    for n in gram_sizes:
        leaves = jnp.asarray(rng.integers(0, node_limit, size=(n, num_trees)),
                             jnp.int32)
        report("c.plain_xla.gram_from_leaves", n=n, m=num_trees,
               node_limit=node_limit,
               ms=1e3 * median_seconds(gram, leaves, leaves))


def phase_routing(report, forests, domain, sizes=(2048, 4096, 5000),
                  time_shapes=((4096, 5), (1024, 64))):
    """d. Gather walk against one-hot transition matmuls: equal leaf ids.

    ``forests`` is a ``(S, m, node_limit)`` batch of fitted trees. The 0/1
    operands of the select router are exact at any matmul precision, so any
    mismatch is a bug. Then both routers are timed at the acquisition
    scoring shape (B candidates x S samples) and the sampler-init shape
    (N rows x chains).
    """
    from bark_jax.forest import route_forest, route_forest_select

    ft = jnp.asarray(domain.feature_types())
    s = forests.feature.shape[0]
    rng = np.random.default_rng(1)
    for b in sizes:
        X = jnp.asarray(domain.sample(b, rng), jnp.float32)
        for i in range(s):
            f = jax.tree.map(lambda a: a[i], forests)
            walk = np.asarray(route_forest(f, X, ft))
            select = np.asarray(route_forest_select(f, X, ft))
            if not np.array_equal(walk, select):
                bad = int((walk != select).sum())
                raise PhaseError(f"d: routers disagree on {bad} ids at B={b}")
        report("d.routing.compare", rows=b, samples=s,
               trees=int(forests.feature.shape[1]), equal=True,
               chunked=b > 2048,
               precision=str(jax.config.jax_default_matmul_precision
                             or "default"))
    for b, batch in time_shapes:
        X = jnp.asarray(domain.sample(b, rng), jnp.float32)
        tiled = jax.tree.map(
            lambda a: jnp.asarray(np.resize(np.asarray(a),
                                            (batch,) + a.shape[1:])),
            forests,
        )
        ms = {}
        for name, router in (("gather_walk", route_forest),
                             ("transition_matmul", route_forest_select)):
            fn = jax.jit(jax.vmap(router, in_axes=(0, None, None)))
            ms[name] = 1e3 * median_seconds(fn, tiled, X, ft)
        report("d.routing.time", rows=b, batch=batch,
               trees=int(forests.feature.shape[1]), ms=ms)


@functools.partial(jax.jit, static_argnames=("params", "warm"))
def _mll_probe(key, forest, X, y, bounds, ft, params, warm):
    """Warm a chain, then one full step and one bare move scan from it."""
    from bark_jax.fitting.sampler import (
        _tree_moves_rank1,
        init_chain_state,
        step,
    )

    state = init_chain_state(forest, jnp.float32(0.1), jnp.float32(1.0), X, y,
                             ft, params, bounds=bounds)
    k_warm, k_step, k_scan = jax.random.split(key, 3)
    state, _ = jax.lax.scan(
        lambda s, k: (step(k, s, X, y, bounds, ft, params), None),
        state, jax.random.split(k_warm, warm),
    )
    after = step(k_step, state, X, y, bounds, ft, params)
    mask = jnp.ones((X.shape[0],), jnp.float32)
    _, _, scan_leaves, _, _, scan_mll = _tree_moves_rank1(
        k_scan, state, X, y, mask, jnp.float32(0.0), bounds, ft, params
    )
    return state, after, scan_leaves, scan_mll


def phase_mll(report, sizes=(200, 512, 4096), num_trees=50, warm=20):
    """d. The sampler's float32 MLL against float64 on the host.

    Checked twice per N: the MLL after a full step (the exact refresh of
    the accepted branch, at MM_PRECISION) and the MLL carried out of the
    move scan (scan bodies at MM_PRECISION_SCAN) against the exact MLL of
    the same post-scan forest.
    """
    from bark_jax.fitting.params import SamplerParams
    from bark_jax.fitting.sampler import _resolve_styles
    from bark_jax.forest import create_empty_forest
    from bark_jax.ops import linalg

    params = SamplerParams(num_trees=num_trees)
    failures = []
    for n in sizes:
        y, data = tree_function_data(n, seed=n)
        forest = create_empty_forest(num_trees, params.node_limit)
        state, after, scan_leaves, scan_mll = _mll_probe(
            jax.random.key(n), forest, *data, params, warm
        )
        styles = _resolve_styles(params, n)
        checks = {
            "refresh": (float(after.mll), mll_float64(
                after.leaves, y, after.noise, after.scale, params.node_limit),
                linalg.MM_PRECISION),
            "scan_carry": (float(scan_mll), mll_float64(
                scan_leaves, y, state.noise, state.scale, params.node_limit),
                linalg.MM_PRECISION_SCAN),
        }
        for what, (f32, f64, precision) in checks.items():
            tol = mll_tolerance(f64)
            ok = bool(np.isfinite(f32) and abs(f32 - f64) <= tol)
            report("d.mll.compare", n=n, trees=num_trees, which=what,
                   refresh_style=styles.refresh_style,
                   scan_style=styles.scan_style, precision=precision,
                   noise=float(after.noise if what == "refresh"
                               else state.noise),
                   mll_f32=f32, mll_f64=f64, abs_diff=abs(f32 - f64),
                   tolerance=tol, ok=ok)
            if not ok:
                failures.append(f"{what} at N={n}")
    if failures:
        raise PhaseError(f"d: MLL outside tolerance: {', '.join(failures)}")


def tree_function_data(n, seed=0):
    """N standardized TreeFunction(dim=5, m=50) points from ``seed``.

    Returns the float64 targets (for the host reference) and the device
    arrays ``(X, y, bounds, feat_types)`` the sampler takes.
    """
    from bark_jax.benchmarks.tree_function import TreeFunction

    bench = TreeFunction(dim=5, m=50, function_seed=1)
    X = bench.domain.sample(n, np.random.default_rng(seed))
    y = bench.f(X)
    y = (y - y.mean()) / y.std()
    return y, (jnp.asarray(X, jnp.float32), jnp.asarray(y, jnp.float32),
               jnp.asarray(bench.domain.bounds("bitmask")),
               jnp.asarray(bench.domain.feature_types()))


def pt_one_card(key, forest, noise, scale, X, y, bounds, ft, params,
                num_steps, beta_min=0.05):
    """``run_parallel_tempering_sharded``'s computation with every replica
    on one device: the same fixed-position ladder, step keys and even-odd
    swaps (``pt_swap_states`` is the single-device twin of the ppermute
    swap). Returns (cold noise, cold scale, cold features, swap rates)."""
    from bark_jax.fitting.sampler import init_chain_state, step
    from bark_jax.parallel.tempering import geometric_ladder, pt_swap_states

    r = noise.shape[0]
    ladder = geometric_ladder(r, beta_min)

    @jax.jit
    def run(key, forest, noise, scale):
        chains = jax.vmap(
            lambda f, nz, sc: init_chain_state(f, nz, sc, X, y, ft, params,
                                               bounds=bounds)
        )(forest, noise, scale)

        def one_round(chains, k):
            k_step, k_even, k_odd = jax.random.split(k, 3)
            chains = jax.vmap(
                lambda c, b: step(k_step, c, X, y, bounds, ft, params, beta=b)
            )(chains, ladder)
            chains, acc_e = pt_swap_states(k_even, chains, ladder,
                                           chains.mll, 0)
            chains, acc_o = pt_swap_states(k_odd, chains, ladder,
                                           chains.mll, 1)
            rate = (acc_e.sum() + acc_o.sum()) / (2.0 * max(r - 1, 1))
            cold = (chains.noise[0], chains.scale[0], chains.forest.feature[0])
            return chains, (cold, rate)

        _, (cold, rates) = jax.lax.scan(one_round, chains,
                                        jax.random.split(key, num_steps))
        return cold + (rates,)

    return run(key, forest, noise, scale)


def phase_four_cards(report, devices, n=512, num_chains=64, num_trees=50,
                     pt_steps=10):
    """e. Chain sharding and parallel tempering over the cards in
    ``devices`` against the same computation on one card, held to the
    equality the virtual-mesh tests hold (tests/parallel)."""
    from jax.sharding import Mesh

    from bark_jax.fitting.params import SamplerParams
    from bark_jax.fitting.sampler import BARKModel, run_bark_sampler
    from bark_jax.forest import create_empty_forest
    from bark_jax.parallel.sharding import (
        chain_mesh,
        shard_model,
        sharded_run_sampler,
    )
    from bark_jax.parallel.tempering import run_parallel_tempering_sharded

    k = len(devices)
    _, (X, y, bounds, ft) = tree_function_data(n)
    params = SamplerParams(warmup_steps=2, num_samples=2, steps_per_sample=1,
                           num_chains=num_chains, num_trees=num_trees)
    model = BARKModel(
        create_empty_forest(num_trees, params.node_limit,
                            batch_shape=(num_chains,)),
        jnp.full((num_chains,), 0.1, jnp.float32),
        jnp.ones((num_chains,), jnp.float32),
    )
    t0 = time.perf_counter()
    ref = jax.block_until_ready(run_bark_sampler(
        jax.random.key(5), model, X, y, bounds, ft, params))
    one_s = time.perf_counter() - t0
    mesh = chain_mesh(k)
    t0 = time.perf_counter()
    samples, diag = jax.block_until_ready(sharded_run_sampler(
        jax.random.key(5), shard_model(model, mesh), X, y, bounds, ft,
        params, mesh))
    sharded_s = time.perf_counter() - t0
    _assert_close("e.sharded_sampler", samples.noise, ref.noise)
    _assert_close("e.sharded_sampler", samples.scale, ref.scale)
    _assert_equal("e.sharded_sampler", samples.forest.feature,
                  ref.forest.feature)
    if not np.isfinite(float(diag.mean_mll)):
        raise PhaseError("e.sharded_sampler: non-finite psum diagnostics")
    report("e.sharded_sampler", cards=k, chains=num_chains, n=n,
           trees=num_trees, equal_structure=True, noise_rtol=2e-4,
           one_card_s=one_s, sharded_s=sharded_s,
           note="times include compilation")

    pt_forest = create_empty_forest(num_trees, params.node_limit,
                                    batch_shape=(k,))
    pt_noise = jnp.full((k,), 0.1, jnp.float32)
    pt_scale = jnp.ones((k,), jnp.float32)
    pt_params = SamplerParams(num_trees=num_trees)
    pt_mesh = Mesh(np.asarray(devices), ("replicas",))
    t0 = time.perf_counter()
    cold, rates = jax.block_until_ready(run_parallel_tempering_sharded(
        jax.random.key(7), pt_forest, pt_noise, pt_scale, X, y, bounds, ft,
        pt_params, pt_mesh, num_steps=pt_steps))
    sharded_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r_noise, r_scale, r_feature, r_rates = jax.block_until_ready(pt_one_card(
        jax.random.key(7), pt_forest, pt_noise, pt_scale, X, y, bounds, ft,
        pt_params, pt_steps))
    one_s = time.perf_counter() - t0
    _assert_close("e.sharded_tempering", cold.noise, r_noise)
    _assert_close("e.sharded_tempering", cold.scale, r_scale)
    _assert_equal("e.sharded_tempering", cold.forest.feature, r_feature)
    _assert_close("e.sharded_tempering", rates, r_rates)
    report("e.sharded_tempering", cards=k, replicas=k, n=n, trees=num_trees,
           steps=pt_steps, equal_structure=True,
           mean_swap_rate=float(np.mean(np.asarray(rates))),
           one_card_s=one_s, sharded_s=sharded_s,
           note="times include compilation")


def _assert_close(phase, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.allclose(got, want, rtol=2e-4,
                                                  atol=2e-5):
        raise PhaseError(f"{phase}: {got!r} != {want!r}")


def _assert_equal(phase, got, want):
    if not np.array_equal(np.asarray(got), np.asarray(want)):
        raise PhaseError(f"{phase}: discrete forest structure differs")


def run_one_card(report):
    strat = phase_bo_loop(report)
    phase_large_n(report)
    phase_throughput(report)
    phase_plain_xla(report)
    forests = jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]),
                           strat.surrogate.model.forest)
    phase_routing(report, forests, strat.domain)
    phase_mll(report)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (e)")
    args = ap.parse_args(argv)

    devices = jax.devices()
    require_gpu(devices)
    card = card_line()
    parse_card_line(card)
    from bark_jax.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    print(card, flush=True)
    print(f"device_kind: {devices[0].device_kind}; devices: {len(devices)}; "
          f"jax {jax.__version__}; compile cache: {cache}", flush=True)
    report = Report(card)
    if args.four_cards:
        if len(devices) < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, found {len(devices)}")
        used = devices[:4]
        phase_four_cards(report, used)
    else:
        used = devices[:1]
        run_one_card(report)
    print(result_line(used), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
