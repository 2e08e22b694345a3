"""Benchmark self-consistency.

Parity: the reference's tests/test_benchmark.py:11-23 — every registered
benchmark's declared optimum must satisfy its own constraints and reproduce
its declared f value (skipped where no optimum is implemented).
"""

import numpy as np
import pytest

from bark_jax.benchmarks import BENCHMARK_MAP, map_benchmark
from bark_jax.constraints import total_violation

UNAVAILABLE = set()
NEEDS_DATA = {"DatasetBenchmark"}
# train a real model per evaluation (or, CCOBench, synthesize raster maps
# at construction); SVRBench/CCOBench have their own sized-down tests
SLOW = {"XGBoostMNIST", "SVRBench", "CCOBench"}


@pytest.mark.parametrize(
    "name", sorted(set(BENCHMARK_MAP) - UNAVAILABLE - NEEDS_DATA - SLOW)
)
def test_benchmark_constructs_and_evaluates(name):
    bench = map_benchmark(name)
    rng = np.random.default_rng(0)
    X = bench.domain.sample(4, rng)
    y = bench.f(X)
    assert y.shape == (4,)
    assert np.isfinite(y).all()


@pytest.mark.parametrize(
    "name", sorted(set(BENCHMARK_MAP) - UNAVAILABLE - NEEDS_DATA - SLOW)
)
def test_benchmark_optima_consistent(name):
    bench = map_benchmark(name)
    try:
        optima = bench.get_optima()
    except NotImplementedError:
        pytest.skip("no optimum declared")
    if optima is None:
        pytest.skip("no optimum declared")
    x_opt, f_opt = optima

    # declared optimum satisfies the benchmark's own constraints
    viol = total_violation(
        bench.domain.constraints, x_opt[None, :].astype(np.float64),
        bench.domain.input_keys,
    )
    assert viol[0] < 1e-2

    # and reproduces the declared objective value
    y = bench.f(x_opt[None, :])
    np.testing.assert_allclose(y[0], f_opt, rtol=2e-3, atol=1e-3)


def test_cco_bench_synthetic_fallback():
    """CCOBench (cco.py) runs end-to-end on synthetic 3GPP-style powermaps
    when the reference's blobs are absent, with the reference's domain and
    objective semantics (cellular_network.py:42-66,109-137)."""
    bench = map_benchmark("CCOBench")
    assert "synthetic" in bench.data_source
    assert len(bench.domain.inputs) == 30  # 15 downtilts + 15 powers
    assert bench.simulator.num_total_sectors == 15
    rng = np.random.default_rng(0)
    X = bench.domain.sample(4, rng)
    y = bench.f(X)
    assert y.shape == (4,) and np.all((y >= 0) & (y <= 1))
    np.testing.assert_array_equal(y, bench.f(X))  # deterministic

    # physics sanity: max TX power everywhere eliminates weak coverage but
    # inflates over-coverage (the tension the benchmark optimizes)
    lo = np.concatenate([np.full((1, 15), 2.0), np.full((1, 15), 30.0)], 1)
    hi = np.concatenate([np.full((1, 15), 2.0), np.full((1, 15), 50.0)], 1)
    r_lo, i_lo, _ = bench.simulator.powermaps(lo[:, :15] * 2, lo[:, 15:])
    r_hi, i_hi, _ = bench.simulator.powermaps(hi[:, :15] * 2, hi[:, 15:])
    w_lo, o_lo = bench.formulation.area_percentages(r_lo, i_lo)
    w_hi, o_hi = bench.formulation.area_percentages(r_hi, i_hi)
    assert w_hi[0] <= w_lo[0] and o_hi[0] >= o_lo[0]

    # n_int_values=11 uses raw downtilts (no x2 rescale)
    b11 = map_benchmark("CCOBench", n_int_values=11)
    assert b11.f(b11.domain.sample(2, rng)).shape == (2,)
    with pytest.raises(ValueError):
        map_benchmark("CCOBench", n_int_values=7)


def test_cco_simulator_against_hand_oracle():
    """RSRPSimulator on a hand-built 2-sector map: serving-cell max,
    watt-domain interference, and fractional-downtilt lerp all match a
    direct computation (parity: simulated_rsrp.py:345-399,428-458)."""
    from bark_jax.benchmarks.cco import RSRPSimulator, dbm_to_watt, watt_to_dbm

    rng = np.random.default_rng(3)
    maps = {}
    for dt in range(3):
        pwr = rng.uniform(-100.0, -60.0, size=(4, 4, 2)).astype(np.float32)
        maps[dt] = {
            "x": np.arange(4.0),
            "y": np.arange(4.0),
            "z": np.float64(1.5),
            "ptx": np.float64(1.0),  # 30 dBm
            "Tx1pwr": pwr + 30.0,
            "Tx1loc": np.zeros(3),
        }
    sim = RSRPSimulator(maps)
    assert sim.num_total_sectors == 2

    tx = np.array([[33.0, 41.0]])
    # integer downtilts: exact map lookup
    rsrp, intf, serving = sim.powermaps(np.array([[1.0, 2.0]]), tx)
    rx0 = maps[1]["Tx1pwr"][:, :, 0] - 30.0 + 33.0
    rx1 = maps[2]["Tx1pwr"][:, :, 1] - 30.0 + 41.0
    np.testing.assert_allclose(rsrp[0], np.maximum(rx0, rx1), rtol=1e-6)
    np.testing.assert_array_equal(serving[0], (rx1 > rx0).astype(int))
    expect_intf = watt_to_dbm(
        np.maximum(
            1e-24,
            dbm_to_watt(rx0) + dbm_to_watt(rx1)
            - dbm_to_watt(np.maximum(rx0, rx1)),
        )
    )
    np.testing.assert_allclose(intf[0], expect_intf, rtol=1e-5)

    # fractional downtilt: linear interpolation of the per-sector map
    rsrp_h, _, _ = sim.powermaps(np.array([[0.25, 2.0]]), tx)
    rx0_h = (
        0.75 * maps[0]["Tx1pwr"][:, :, 0] + 0.25 * maps[1]["Tx1pwr"][:, :, 0]
        - 30.0 + 33.0
    )
    np.testing.assert_allclose(rsrp_h[0], np.maximum(rx0_h, rx1), rtol=1e-5)

    # out-of-range guards (simulated_rsrp.py:364-369)
    with pytest.raises(ValueError):
        sim.powermaps(np.array([[0.0, 5.0]]), tx)
    with pytest.raises(ValueError):
        sim.powermaps(np.array([[0.0, 1.0]]), np.array([[20.0, 40.0]]))


def test_dataset_benchmark_roundtrip():
    # reference parity: sequential sampling + row-lookup f
    # (src/bofire_mixed/benchmarks/dataset.py:131-157)
    pd = pytest.importorskip("pandas")
    from bark_jax.benchmarks.dataset import dataset_domain

    rng = np.random.default_rng(0)
    dom = dataset_domain("Abalone")
    n = 32
    raw = {}
    for f in dom.inputs:
        if hasattr(f, "categories"):
            raw[f.key] = rng.choice(f.categories, size=n)
        else:
            lo, hi = f.bounds
            raw[f.key] = rng.uniform(lo, hi, size=n)
    raw[dom.output_keys[0]] = rng.normal(size=n)
    bench = map_benchmark("DatasetBenchmark", dataset_name="Abalone",
                          data=pd.DataFrame(raw))

    X1 = bench.sample(8, seed=3)
    X2 = bench.sample(8, seed=3)
    assert X1.shape == (8, dom.dim)
    # sequential without replacement: disjoint rows from the same permutation
    assert not any(np.all(np.isclose(X1, r), axis=1).any() for r in X2)
    y = bench.f(X1)
    assert y.shape == (8,) and np.isfinite(y).all()
    # standardized target with sample std (ddof=1), matching the
    # reference's pandas .std() (dataset.py:140-144)
    assert abs(bench.y_data.mean()) < 1e-9
    assert abs(bench.y_data.std(ddof=1) - 1) < 1e-9
    with pytest.raises(KeyError):
        bench.f(np.full((1, dom.dim), -123.0, np.float32))


def test_max_bandit_candidates():
    bench = map_benchmark("MAXBandit")
    X, idx = bench.sample_candidates(10, np.random.default_rng(0))
    assert X.shape == (10, 28)
    y = bench.f_by_idx(idx)
    assert np.isfinite(y).all()


def test_svr_bench_synthetic_fallback():
    """SVRBench (svr_bench.py:28-155) runs end-to-end on the synthetic
    substitute: full pipeline (constant filter, importance ranking, 5
    splits) + SVR scoring, feature mask genuinely changes the objective."""
    bench = map_benchmark(
        "SVRBench",
        num_features_to_optimize=10,
        num_features_to_keep=10,
        num_samples=400,
    )
    assert bench.data_source == "synthetic"
    dom = bench.domain
    assert dom.dim == 13  # 3 continuous hypers + 10 binary mask dims

    rng = np.random.default_rng(0)
    X = dom.sample(3, rng)
    y = bench.f(X)
    assert y.shape == (3,) and np.isfinite(y).all() and (y > 0).all()

    # all-zeros mask -> constant predictor; all-ones mask should beat it
    base = np.array([[-1.0, 0.0, 0.0] + [0.0] * 10])
    full = np.array([[-1.0, 0.0, 0.0] + [1.0] * 10])
    y0, y1 = bench.f(base)[0], bench.f(full)[0]
    assert y1 < y0
