"""Hyperparameter-optimization benchmarks (real model-training objectives).

Parity: src/bofire_mixed/benchmarks/xgboost_mnist.py:18-76 — tune a gradient
-boosted classifier on the sklearn digits set, minimizing 1 - accuracy, over
a mixed categorical/integer/continuous space. The reference requires the
xgboost binary; when it is unavailable this falls back to sklearn's
HistGradientBoostingClassifier with the analogous hyperparameters (the
booster/objective categoricals then act as inert dims), keeping the
capability runnable everywhere.
"""

from __future__ import annotations

import numpy as np

from bark_jax.benchmarks.base import Benchmark, register_benchmark
from bark_jax.domain import (
    CategoricalInput,
    ContinuousInput,
    Domain,
    build_integer_input,
)

try:  # pragma: no cover - environment-dependent
    import xgboost  # noqa: F401

    HAS_XGBOOST = True
except ImportError:
    HAS_XGBOOST = False


@register_benchmark("XGBoostMNIST")
class XGBoostMNIST(Benchmark):
    def __init__(self, seed: int = 0, split=0.3, **kwargs):
        from sklearn import datasets, model_selection

        data = datasets.load_digits()
        (
            self.train_x,
            self.test_x,
            self.train_y,
            self.test_y,
        ) = model_selection.train_test_split(
            data["data"],
            data["target"],
            test_size=split,
            stratify=data["target"],
            random_state=seed,
        )
        super().__init__(
            Domain(
                [
                    CategoricalInput("booster", ("gbtree", "dart")),
                    CategoricalInput("grow_policy", ("depthwise", "lossguide")),
                    CategoricalInput(
                        "objective", ("multi:softmax", "multi:softprob")
                    ),
                    ContinuousInput("log_learning_rate", (-5.0, 0.0)),
                    build_integer_input(key="max_depth", bounds=(1, 10)),
                    ContinuousInput("min_split_loss", (0.0, 10.0)),
                    ContinuousInput("subsample", (0.001, 1.0)),
                    ContinuousInput("reg_lambda", (0.0, 5.0)),
                ]
            )
        )

    def _train_one(self, row):
        from sklearn import metrics

        lr = 10.0 ** row[3]
        max_depth = int(row[4])
        if HAS_XGBOOST:
            import xgboost

            model = xgboost.XGBClassifier(
                booster=("gbtree", "dart")[int(row[0])],
                grow_policy=("depthwise", "lossguide")[int(row[1])],
                objective=("multi:softmax", "multi:softprob")[int(row[2])],
                learning_rate=lr,
                max_depth=max_depth,
                min_split_loss=row[5],
                subsample=row[6],
                reg_lambda=row[7],
            )
        else:
            from sklearn.ensemble import HistGradientBoostingClassifier

            model = HistGradientBoostingClassifier(
                learning_rate=lr,
                max_depth=max_depth,
                min_samples_leaf=max(1, int(row[5]) + 1),
                l2_regularization=row[7],
                max_iter=50,
                random_state=0,
            )
        model.fit(self.train_x, self.train_y)
        return 1.0 - metrics.accuracy_score(self.test_y, model.predict(self.test_x))

    def _f(self, X):
        return np.array([self._train_one(row) for row in X])
