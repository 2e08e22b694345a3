"""Multi-task GP, posterior sampling, fidelity selection, LeafGP tests."""

import jax
import jax.numpy as jnp
import numpy as np

from bark_jax.benchmarks import map_benchmark
from bark_jax.fitting.params import SamplerParams
from bark_jax.models.leafgp import LeafGPSurrogate
from bark_jax.models.mogp import LeafMOGPSurrogate, task_covariance
from bark_jax.models.sampling import (
    construct_nystrom_features,
    generate_fstar_samples,
    nystrom_samples,
)
from bark_jax.models.surrogate import BARKSurrogate
from bark_jax.optimizer.fidelity import propose_fidelity_information_based
from bark_jax.utils.metrics import mse


def test_leafgp_beats_mean_predictor():
    bench = map_benchmark("TreeFunction", dim=3, m=20, function_seed=1)
    rng = np.random.default_rng(0)
    Xtr = bench.domain.sample(60, rng)
    ytr = bench.f(Xtr)
    Xte = bench.domain.sample(80, rng)
    yte = bench.f(Xte)
    sur = LeafGPSurrogate(bench.domain).fit(Xtr, ytr)
    mu, std = sur.predict(Xte)
    assert mse(yte, mu) < 0.5 * mse(yte, np.full_like(yte, ytr.mean()))
    assert (std > 0).all() and np.isfinite(std).all()


def test_mogp_learns_correlated_fidelities():
    bench = map_benchmark("CurrinExp2D")
    rng = np.random.default_rng(0)
    X0 = bench.domain.sample(15, rng)
    X1 = bench.domain.sample(30, rng)
    X = np.vstack([X0, X1])
    tasks = np.array([0] * 15 + [1] * 30)
    y = bench.f_fidelity(X, tasks)
    mogp = LeafMOGPSurrogate(bench.domain, num_tasks=2).fit(X, tasks, y)

    B = np.asarray(task_covariance(mogp.params))
    corr = B[0, 1] / np.sqrt(B[0, 0] * B[1, 1])
    assert corr > 0.8, "fidelities are strongly correlated by construction"

    Xte = bench.domain.sample(40, rng)
    yte = bench.f_fidelity(Xte, np.zeros(40))
    mu, std = mogp.predict(Xte, np.zeros(40, int))
    assert np.sqrt(np.mean((mu - yte) ** 2)) < yte.std()


def _fitted_bark(seed=0):
    bench = map_benchmark("TreeFunction", dim=2, m=8, function_seed=1)
    rng = np.random.default_rng(seed)
    Xtr = bench.domain.sample(20, rng)
    ytr = bench.f(Xtr)
    params = SamplerParams(
        warmup_steps=10, num_samples=3, steps_per_sample=2, num_trees=8
    )
    sur = BARKSurrogate(bench.domain, params, seed=seed).fit(Xtr, ytr)
    return bench, sur


def test_fstar_samples_below_posterior_mean_min():
    bench, sur = _fitted_bark()
    tx, ty = sur.train_data
    ft = jnp.asarray(bench.domain.feature_types())
    fstar = np.asarray(
        generate_fstar_samples(
            jax.random.key(0), sur.model, tx, ty, ft, num_fstar=32
        )
    )
    assert fstar.shape == (3, 32)
    assert np.isfinite(fstar).all()
    # f* = min over sites of latent draws: on average below the y mean (0)
    assert fstar.mean() < 0


def test_nystrom_features_approximate_kernel():
    bench, sur = _fitted_bark()
    tx, _ = sur.train_data
    ft = jnp.asarray(bench.domain.feature_types())
    Z = tx[:15]
    feats = construct_nystrom_features(sur.model, Z, Z, ft)
    # phi(Z) phi(Z)^T must reproduce K_ZZ (exact on the inducing set)
    from bark_jax.forest import gram_from_leaves, route_forest

    forest0 = jax.tree.map(lambda a: a.reshape(-1, 8, 64)[0], sur.model.forest)
    leaves = route_forest(forest0, Z, ft)
    K = float(sur.model.scale.reshape(-1)[0]) * np.asarray(
        gram_from_leaves(leaves, leaves, 64)
    )
    approx = np.asarray(feats[0] @ feats[0].T)
    np.testing.assert_allclose(approx, K, atol=5e-3)

    draws = nystrom_samples(jax.random.key(1), feats, 6)
    assert draws.shape == (3, 6, 15)


def test_fidelity_chooser_returns_valid_index():
    bench = map_benchmark("CurrinExp2D")
    rng = np.random.default_rng(1)
    X = np.vstack([bench.domain.sample(10, rng), bench.domain.sample(20, rng)])
    tasks = np.array([0] * 10 + [1] * 20)
    y = bench.f_fidelity(X, tasks)
    mogp = LeafMOGPSurrogate(bench.domain, num_tasks=2).fit(X, tasks, y)
    f_star = np.asarray([-1.0, -1.1, -0.9])
    fid = propose_fidelity_information_based(
        mogp, bench.domain.sample(1, rng), bench.fidelity_costs, f_star
    )
    assert fid in (0, 1)


def test_leaf_function_samples_match_posterior_moments():
    """Exact leaf-space draws: mean equals the closed-form posterior mean
    and per-point variance matches forest_predict's latent variance within
    MC error — no eigenvalue clamping anywhere (A is SPD by construction)."""
    import jax.numpy as jnp

    from bark_jax.benchmarks.tree_function import TreeFunction
    from bark_jax.fitting.prior import sample_forest_prior
    from bark_jax.fitting.sampler import BARKModel
    from bark_jax.models.gp import forest_predict_leaf
    from bark_jax.models.sampling import (
        generate_fstar_samples,
        generate_fstar_samples_leaf,
        leaf_function_samples,
    )

    bench = TreeFunction(dim=3, m=10, function_seed=4)
    dom = bench.domain
    rng = np.random.default_rng(0)
    X = jnp.asarray(dom.sample(60, rng))
    y = jnp.asarray(bench.f(np.asarray(X)))
    C = jnp.asarray(dom.sample(15, rng))
    ft = jnp.asarray(dom.feature_types())
    bounds = jnp.asarray(dom.bounds("bitmask"))
    forest = sample_forest_prior(
        jax.random.key(5), 10, bounds, ft, num_samples=2, node_limit=32,
        max_depth=8,
    )
    model = BARKModel(forest, jnp.array([0.1, 0.2]), jnp.array([1.0, 0.7]))

    D = 4096
    draws = leaf_function_samples(
        jax.random.key(0), model, X, y, C, ft, num_draws=D, max_depth=8
    )  # (2, D, 15)
    mu, var = forest_predict_leaf(
        model.forest, model.noise, model.scale, X, y, C, ft, 8
    )
    emp_mu = np.asarray(draws.mean(axis=1))
    emp_var = np.asarray(draws.var(axis=1))
    # MC error ~ sqrt(2/D) for the variance, sqrt(var/D) for the mean
    np.testing.assert_allclose(emp_mu, np.asarray(mu), atol=4.5 * float(
        np.sqrt(np.asarray(var).max() / D)
    ))
    np.testing.assert_allclose(emp_var, np.asarray(var), rtol=0.15, atol=1e-4)

    # f* draws through the leaf path agree with the dense sampler in
    # distribution (same posterior; different RNG streams)
    fs_leaf = np.asarray(generate_fstar_samples_leaf(
        jax.random.key(1), model, X, y, ft, num_fstar=512, max_depth=8
    ))
    fs_dense = np.asarray(generate_fstar_samples(
        jax.random.key(2), model, X, y, ft, num_fstar=512, max_depth=8
    ))
    assert abs(fs_leaf.mean() - fs_dense.mean()) < 0.2
    assert abs(fs_leaf.std() - fs_dense.std()) < 0.2
