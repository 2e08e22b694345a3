"""The on-card smoke script's contract, checked on the CPU.

The script itself refuses to run here; its helpers, its float64 MLL
reference and its phases at tiny sizes are exercised directly, and the
four-card phase runs on four of the suite's virtual CPU devices.
"""

import json
import logging
import os
import pathlib
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from bark_jax.utils import compile_cache

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run_script(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _has_result_line(stdout: str) -> bool:
    return any('"ok"' in line for line in stdout.splitlines())


def test_refuses_the_cpu_before_any_phase():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.main([])


def test_script_exits_nonzero_without_a_gpu():
    proc = _run_script(ROOT)
    assert proc.returncode != 0
    assert not _has_result_line(proc.stdout)
    assert "needs an NVIDIA GPU" in proc.stderr


def test_script_fails_alone_in_an_empty_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_script(tmp_path)
    assert proc.returncode != 0
    assert not _has_result_line(proc.stdout)


def test_cache_dir_comes_from_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == tmp_path
    # JAX reads the variable itself; the helper sets no other cache
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    assert compile_cache.cache_dir() == ROOT / ".jax_cache"


@pytest.mark.parametrize(
    "line,expected",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W", ("NVIDIA H100 80GB HBM3", "700.00 W")),
        ("NVIDIA H100 80GB HBM3, 400.00 W\n", ("NVIDIA H100 80GB HBM3", "400.00 W")),
    ],
)
def test_parse_card_line(line, expected):
    assert chip_smoke.parse_card_line(line) == expected


@pytest.mark.parametrize("line", ["", "NVIDIA H100", ", 700.00 W", "NVIDIA H100,"])
def test_parse_card_line_rejects_malformed(line):
    with pytest.raises(ValueError):
        chip_smoke.parse_card_line(line)


def test_result_line_is_exactly_the_contract():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
    assert "\n" not in line
    assert json.loads(chip_smoke.result_line([dev] * 4))["device"]["count"] == 4


def test_fallback_detector_fails_the_phase():
    """A failing acquisition makes ask() return a random point with a
    WARNING; the detector must turn that into a failed phase."""
    from bark_jax.benchmarks.tree_function import TreeFunction
    from bark_jax.fitting.params import SamplerParams
    from bark_jax.strategies.tree_kernel import make_strategy

    bench = TreeFunction(dim=2, m=5, function_seed=1)
    strat = make_strategy(
        "BARK", bench.domain, seed=0, num_candidates=16, num_rounds=1,
        params=SamplerParams(warmup_steps=2, num_samples=2, steps_per_sample=1,
                             num_trees=4),
    )
    X = bench.domain.sample(6, np.random.default_rng(0))
    strat.tell(X, bench.f(X))

    def broken(use_ts):
        raise RuntimeError("lowering failed")

    strat._propose_once = broken
    with chip_smoke.watch_ask_fallback() as fallbacks:
        cand = strat.ask(1)
    assert cand.shape == (1, 2)
    with pytest.raises(chip_smoke.PhaseError, match="random candidate"):
        chip_smoke.check_no_fallback(fallbacks, "a")
    # the handler is detached again
    assert not any(
        isinstance(h, type(fallbacks))
        for h in logging.getLogger(chip_smoke.ASK_LOGGER).handlers
    )


def test_fallback_detector_passes_a_clean_block():
    with chip_smoke.watch_ask_fallback() as fallbacks:
        logging.getLogger(chip_smoke.ASK_LOGGER).info("not a fallback")
    chip_smoke.check_no_fallback(fallbacks, "a")


@pytest.mark.parametrize("n", [40, 300], ids=["dense_tier", "leaf_tier"])
def test_float64_mll_reference_matches_the_sampler(n):
    """The host reference and the sampler's init MLL describe one model."""
    from bark_jax.fitting.params import SamplerParams
    from bark_jax.fitting.prior import sample_forest_prior
    from bark_jax.fitting.sampler import init_chain_state

    rng = np.random.default_rng(n)
    X = jnp.asarray(rng.uniform(size=(n, 3)), jnp.float32)
    y = rng.normal(size=n)
    bounds = jnp.stack([jnp.zeros(3), jnp.ones(3)], axis=-1)
    ft = jnp.full((3,), 2, jnp.int32)
    params = SamplerParams(num_trees=6)
    forest = jax.tree.map(
        lambda a: a[0],
        sample_forest_prior(jax.random.key(1), 6, bounds, ft),
    )
    state = init_chain_state(forest, 0.2, 1.3, X, jnp.asarray(y, jnp.float32),
                             ft, params, bounds=bounds)
    ref = chip_smoke.mll_float64(state.leaves, y, 0.2, 1.3, params.node_limit)
    assert abs(float(state.mll) - ref) <= chip_smoke.mll_tolerance(ref)


def test_mll_phase_at_small_size():
    lines = []
    chip_smoke.phase_mll(lambda phase, **f: lines.append((phase, f)),
                         sizes=(48, 260), num_trees=6, warm=3)
    assert [f["which"] for _, f in lines] == ["refresh", "scan_carry"] * 2
    assert all(f["ok"] for _, f in lines)
    assert {f["refresh_style"] for _, f in lines} == {"onesolve", "leaf"}


def test_four_card_phase_on_virtual_devices():
    """Sharded sampler and sharded PT against their one-device twins."""
    lines = []
    chip_smoke.phase_four_cards(
        lambda phase, **f: lines.append((phase, f)), jax.devices()[:4],
        n=260, num_chains=8, num_trees=5, pt_steps=3,
    )
    phases = [p for p, _ in lines]
    assert phases == ["e.sharded_sampler", "e.sharded_tempering"]
    rate = lines[1][1]["mean_swap_rate"]
    assert 0.0 <= rate <= 1.0
