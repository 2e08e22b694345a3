"""Leaf-vs-dense transit diagnostic at N=512 — NOT a stationarity test.

Originally written as a z-test between the leaf refresh (the N >= 512
auto default) and the dense refresh at a paper-style budget. The round-4
investigation (results/ab_r4/leaf_numerics.md) showed that at this N the
chain mixes pathologically slowly (fresh chains are still descending in
noise after 2000 warmup steps; chains started at the low-noise states
escape toward noise ~ 1), so chain-mean moments at any short budget
measure different TRANSIT speeds through a metastable landscape, not
different stationary laws — large z values here are expected and do not
adjudicate correctness. The decisive evidence is per-evaluation: the
leaf identity matches f64 to ~0.02 nats everywhere tested, while the
dense explicit-inverse MLL was off by ~58 nats on an accelerator at
(N=512, nu=0.011); and per-step: one-step kernels are identical wherever the
dense arithmetic is sound.

Kept for tracking how the transit behavior evolves across rounds.
Writes results/ab_r4/leaf_selfparity.json. Run on a QUIET host.
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.benchmarks.tree_function import TreeFunction
from bark_jax.fitting.params import SamplerParams
from bark_jax.fitting.sampler import BARKModel, run_bark_sampler
from bark_jax.forest import create_empty_forest

OUT = pathlib.Path(__file__).resolve().parent.parent / "results" / "ab_r4"
CHAINS = 16


def run(refresh, scan, key):
    bench = TreeFunction(dim=5, cat_dim=0, num_cat=5, m=50, function_seed=1)
    rng = np.random.default_rng(0)
    X = bench.domain.sample(512, rng)
    y = bench.f(X)
    y = (y - y.mean()) / y.std()
    p = SamplerParams(
        warmup_steps=200, num_samples=50, steps_per_sample=4,
        num_chains=CHAINS, num_trees=50, refresh_style=refresh,
        scan_style=scan,
    )
    bounds = jnp.asarray(bench.domain.bounds("bitmask"))
    ft = jnp.asarray(bench.domain.feature_types())
    forest = create_empty_forest(50, p.node_limit, batch_shape=(CHAINS,))
    model = BARKModel(forest, jnp.full((CHAINS,), 0.1), jnp.ones((CHAINS,)))
    out = run_bark_sampler(
        key, model, jnp.asarray(X), jnp.asarray(y)[:, None], bounds, ft, p
    )
    tmask = np.asarray(out.forest.is_leaf & out.forest.active)
    depth = np.asarray(out.forest.depth)
    # per-chain means over samples (chains are the independent units)
    stats = {
        "noise_mean": np.asarray(out.noise).mean(axis=1),
        "leaves_per_tree": tmask.sum(axis=-1).mean(axis=(1, 2)),
        "leaf_depth_mean": np.array([
            depth[c][tmask[c]].mean() for c in range(CHAINS)
        ]),
        "leaf_depth_var": np.array([
            depth[c][tmask[c]].var() for c in range(CHAINS)
        ]),
    }
    return stats


def summarize(v):
    v = np.asarray(v, np.float64)
    return float(v.mean()), float(v.std(ddof=1) / np.sqrt(len(v)))


def main():
    a = run("pair", "lowrank", jax.random.key(11))
    b = run("leaf", "coeff", jax.random.key(23))
    rows = []
    for metric in a:
        (ma, sa), (mb, sb) = summarize(a[metric]), summarize(b[metric])
        z = abs(ma - mb) / (np.sqrt(sa**2 + sb**2) + 1e-12)
        rows.append({
            "metric": metric, "pair": ma, "pair_se": sa,
            "leaf": mb, "leaf_se": sb, "z": float(z),
            "z_note": "transit diagnostic, not a gate",
        })
        print(json.dumps(rows[-1]), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "leaf_selfparity.json").write_text(json.dumps({
        "config": "TreeFunction dim=5 m=50 N=512, 16 chains, "
                  "200 warmup + 50x4 steps, independent keys",
        "rows": rows,
    }, indent=1))
    # informational: large z here reflects transit-speed differences in a
    # slow-mixing regime (see module docstring), not a correctness gate


if __name__ == "__main__":
    main()
