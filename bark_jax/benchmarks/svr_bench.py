"""SVR feature-selection + hyperparameter benchmark (SVRBench).

Parity: src/bofire_mixed/benchmarks/svr_bench.py:28-155 — jointly tune an
SVR's (log_epsilon, log_C, log_gamma) and a 50-dim binary feature-selection
mask; the objective is the mean held-out MSE over 5 fixed train/test splits
of the CT slice-localization dataset, with the candidate feature pool
pre-ranked to the top ``num_features_to_keep`` by gradient-boosted feature
importances.

Data: the reference's CSV blob (``slice_localization_data.csv``) is absent
from its own checkout (``.MISSING_LARGE_BLOBS``). When a real CSV is not
found, this implementation substitutes a *synthetic slice-localization-shaped
dataset* (same pipeline shape: ~10k rows, a few hundred bounded histogram-like
features, some constant, sparse nonlinear ground truth) so every code path —
constant-feature filtering, importance ranking, split generation, SVR
cross-evaluation — stays runnable and testable. The docstring of
``_load_data`` states which source was used; pass ``csv_path`` to run on the
real data.

Intentional divergence from the reference: its feature mask is applied as
``x[:, features_filter]`` with an *int* 0/1 array (svr_bench.py:137-141),
which numpy treats as fancy indexing — it gathers columns 0 and 1 repeatedly
instead of masking. Here the mask selects columns as a boolean filter (the
intended semantics, matching the paper's description).
"""

from __future__ import annotations

import pathlib

import numpy as np

from bark_jax.benchmarks.base import Benchmark, register_benchmark
from bark_jax.domain import ContinuousInput, Domain, build_integer_input

try:  # pragma: no cover - environment-dependent
    import xgboost  # noqa: F401

    HAS_XGBOOST = True
except ImportError:
    HAS_XGBOOST = False


def _synthetic_slice_data(
    n_rows: int, n_features: int = 300, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Slice-localization-shaped synthetic data.

    The real set is ~53.5k rows x 384 bounded histogram features (many
    near-constant) with a smooth target. Mimic that: features are clipped
    scaled half-normals in [0, 1] (a random subset exactly constant so the
    constant-feature filter has work to do), and y is a sparse nonlinear
    function of ~10% of the informative features plus noise — so the
    importance ranking is meaningful and feature selection genuinely moves
    the SVR's held-out MSE.
    """
    rng = np.random.default_rng(seed)
    scales = rng.uniform(0.05, 0.5, size=n_features)
    x = np.clip(np.abs(rng.normal(0.0, scales, size=(n_rows, n_features))), 0, 1)
    const = rng.choice(n_features, size=n_features // 10, replace=False)
    x[:, const] = rng.uniform(0, 1, size=len(const))[None, :].repeat(n_rows, 0)

    informative = rng.choice(
        np.setdiff1d(np.arange(n_features), const),
        size=max(n_features // 10, 8),
        replace=False,
    )
    w = rng.normal(0, 1, size=len(informative))
    xi = x[:, informative]
    y = (
        xi @ w
        + np.sin(3.0 * xi[:, 0]) * xi[:, 1]
        + (xi[:, 2] * xi[:, 3] if len(informative) > 3 else 0.0)
        + rng.normal(0, 0.1, size=n_rows)
    )
    return x, y


@register_benchmark("SVRBench")
class SVRBench(Benchmark):
    """Minimize 5-split mean test MSE of an SVR over (hypers, feature mask)."""

    def __init__(
        self,
        num_features_to_optimize: int = 50,
        num_features_to_keep: int = 50,
        num_samples: int = 10000,
        csv_path: str | None = None,
        seed: int = 0,
        **kwargs,
    ):
        if num_features_to_optimize > num_features_to_keep:
            raise ValueError(
                "num_features_to_optimize must be <= num_features_to_keep"
            )
        self.num_features_to_optimize = num_features_to_optimize
        self.num_features_to_keep = num_features_to_keep
        self.num_samples = num_samples
        self.csv_path = csv_path
        self.seed = seed
        self.data_source = None  # set by _prepare: "csv" or "synthetic"
        self._splits = None
        super().__init__(
            Domain(
                [
                    ContinuousInput("log_epsilon", (-2.0, 0.0)),
                    ContinuousInput("log_C", (-2.0, 2.0)),
                    ContinuousInput("log_gamma", (-1.0, 1.0)),
                    *[
                        build_integer_input(key=f"feature_{i + 1}", bounds=(0, 1))
                        for i in range(num_features_to_optimize)
                    ],
                ]
            )
        )
        self._prepare()

    # --- data pipeline (svr_bench.py:60-103) -------------------------------

    def _load_data(self) -> tuple[np.ndarray, np.ndarray]:
        """Real CSV when present (here or in the reference tree), else the
        synthetic substitute; records which in ``self.data_source``."""
        candidates = [self.csv_path] if self.csv_path else []
        candidates += [
            str(
                pathlib.Path(__file__).parent
                / "data"
                / "slice_localization_data.csv"
            ),
        ]
        for path in candidates:
            if path and pathlib.Path(path).exists():
                import pandas as pd

                data = pd.read_csv(path, sep=",").to_numpy()
                self.data_source = "csv"
                return data[:, :-1], data[:, -1]
        self.data_source = "synthetic"
        return _synthetic_slice_data(
            max(self.num_samples, 2 * self.num_features_to_keep), seed=self.seed
        )

    def _rank_features(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Top-``num_features_to_keep`` columns by boosted-tree importance
        (XGBRegressor(max_depth=8) when available, svr_bench.py:85-89; else
        sklearn RandomForest importances — same ranking semantics)."""
        if HAS_XGBOOST:
            import xgboost

            regr = xgboost.XGBRegressor(max_depth=8).fit(x, y)
            imp = regr.feature_importances_
        else:
            from sklearn.ensemble import RandomForestRegressor

            regr = RandomForestRegressor(
                n_estimators=50, max_depth=8, random_state=0, n_jobs=-1
            ).fit(x, y)
            imp = regr.feature_importances_
        return np.argsort(imp)[::-1][: self.num_features_to_keep]

    def _prepare(self) -> None:
        from sklearn.model_selection import train_test_split

        x, y = self._load_data()
        keep = (x.max(0) - x.min(0)) > 1e-6  # drop constant features
        x = x[:, keep]
        mixed = np.random.RandomState(0).permutation(len(x))[: self.num_samples]
        x, y = x[mixed], y[mixed]
        x = x[:, self._rank_features(x, y)]

        self._splits = [
            train_test_split(x, y, test_size=0.3, random_state=s)
            for s in range(5)
        ]

    # --- objective (svr_bench.py:105-155) -----------------------------------

    def _score_one(self, row: np.ndarray) -> float:
        from sklearn.metrics import mean_squared_error
        from sklearn.pipeline import make_pipeline
        from sklearn.preprocessing import MinMaxScaler
        from sklearn.svm import SVR

        eps, c, gamma = np.exp(row[0]), np.exp(row[1]), np.exp(row[2])
        mask = np.concatenate(
            [
                row[3 : 3 + self.num_features_to_optimize] > 0.5,
                np.ones(
                    self.num_features_to_keep - self.num_features_to_optimize,
                    bool,
                ),
            ]
        )
        scores = []
        for x_train, x_test, y_train, y_test in self._splits:
            mu, sd = y_train.mean(), y_train.std()
            if not mask.any():  # nothing selected -> constant predictor
                scores.append(mean_squared_error(y_test, np.full(len(y_test), mu)))
                continue
            xt, xs = x_train[:, mask], x_test[:, mask]
            regr = make_pipeline(
                MinMaxScaler(),
                SVR(epsilon=eps, C=c, gamma=gamma / xt.shape[-1]),
            )
            regr.fit(xt, (y_train - mu) / sd)
            scores.append(mean_squared_error(y_test, regr.predict(xs) * sd + mu))
        return float(np.mean(scores))

    def _f(self, X: np.ndarray) -> np.ndarray:
        return np.array([self._score_one(row) for row in np.atleast_2d(X)])
