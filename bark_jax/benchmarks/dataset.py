"""UCI regression-dataset benchmarks.

Parity: src/bofire_mixed/benchmarks/dataset.py:19-157 — hand-declared
domains for four UCI datasets (Auto MPG, Student Performance, Abalone,
Concrete Compressive Strength), targets standardized at load, a sequential
without-replacement ``sample(n, seed)`` API, and ``f`` as a row lookup into
the dataset rather than a closed-form function.

The reference fetches via ``ucimlrepo`` (dataset.py:14,23). That fetcher
needs network access, so here the data source is pluggable: pass a pandas
DataFrame / CSV path with the declared input+output columns, or rely on
``ucimlrepo`` when it is importable. Only construction is gated — the
domains themselves are always available (``dataset_domain(name)``).
"""

from __future__ import annotations

import os

import numpy as np

from bark_jax.benchmarks.base import Benchmark, register_benchmark
from bark_jax.domain import (
    CategoricalInput,
    ContinuousInput,
    ContinuousOutput,
    Domain,
    build_integer_input,
)

_YES_NO = ("yes", "no")

# Domain declarations mirror dataset.py:32-128 exactly (keys, bounds,
# category sets, target names).
_AUTO_MPG = Domain(
    inputs=[
        ContinuousInput(key="displacement", bounds=(0.0, 500.0)),
        build_integer_input(key="cylinders", bounds=(3, 8)),
        ContinuousInput(key="horsepower", bounds=(0.0, 500.0)),
        ContinuousInput(key="weight", bounds=(0.0, 7000.0)),
        ContinuousInput(key="acceleration", bounds=(0.0, 30.0)),
        build_integer_input(key="model_year", bounds=(70, 82)),
        build_integer_input(key="origin", bounds=(1, 3)),
    ],
    outputs=[ContinuousOutput(key="mpg")],
)

_STUDENT_PERFORMANCE = Domain(
    inputs=[
        CategoricalInput(key="school", categories=("GP", "MS")),
        CategoricalInput(key="sex", categories=("M", "F")),
        build_integer_input(key="age", bounds=(15, 22)),
        CategoricalInput(key="address", categories=("U", "R")),
        CategoricalInput(key="famsize", categories=("LE3", "GT3")),
        CategoricalInput(key="Pstatus", categories=("A", "T")),
        build_integer_input(key="Medu", bounds=(0, 4)),
        build_integer_input(key="Fedu", bounds=(0, 4)),
        CategoricalInput(
            key="Mjob",
            categories=("teacher", "health", "services", "at_home", "other"),
        ),
        CategoricalInput(
            key="Fjob",
            categories=("teacher", "health", "services", "at_home", "other"),
        ),
        CategoricalInput(
            key="reason", categories=("home", "reputation", "course", "other")
        ),
        CategoricalInput(key="guardian", categories=("mother", "father", "other")),
        build_integer_input(key="traveltime", bounds=(1, 4)),
        build_integer_input(key="studytime", bounds=(1, 4)),
        build_integer_input(key="failures", bounds=(0, 4)),
        CategoricalInput(key="schoolsup", categories=_YES_NO),
        CategoricalInput(key="famsup", categories=_YES_NO),
        CategoricalInput(key="paid", categories=_YES_NO),
        CategoricalInput(key="activities", categories=_YES_NO),
        CategoricalInput(key="nursery", categories=_YES_NO),
        CategoricalInput(key="higher", categories=_YES_NO),
        CategoricalInput(key="internet", categories=_YES_NO),
        CategoricalInput(key="romantic", categories=_YES_NO),
        build_integer_input(key="famrel", bounds=(1, 5)),
        build_integer_input(key="freetime", bounds=(1, 5)),
        build_integer_input(key="goout", bounds=(1, 5)),
        build_integer_input(key="Dalc", bounds=(1, 5)),
        build_integer_input(key="Walc", bounds=(1, 5)),
        build_integer_input(key="health", bounds=(1, 5)),
        build_integer_input(key="absences", bounds=(0, 93)),
    ],
    outputs=[ContinuousOutput(key="G3")],
)

_ABALONE = Domain(
    inputs=[
        CategoricalInput(key="Sex", categories=("M", "F", "I")),
        ContinuousInput(key="Length", bounds=(0.0, 1.0)),
        ContinuousInput(key="Diameter", bounds=(0.0, 1.0)),
        ContinuousInput(key="Height", bounds=(0.0, 2.0)),
        ContinuousInput(key="Whole_weight", bounds=(0.0, 3.0)),
        ContinuousInput(key="Shucked_weight", bounds=(0.0, 1.5)),
        ContinuousInput(key="Viscera_weight", bounds=(0.0, 1.0)),
        ContinuousInput(key="Shell_weight", bounds=(0.0, 2.0)),
    ],
    outputs=[ContinuousOutput(key="Rings")],
)

_CONCRETE = Domain(
    inputs=[
        ContinuousInput(key="Cement", bounds=(0.0, 600.0)),
        ContinuousInput(key="Blast Furnace Slag", bounds=(0.0, 400.0)),
        ContinuousInput(key="Fly Ash", bounds=(0.0, 210.0)),
        ContinuousInput(key="Water", bounds=(0.0, 250.0)),
        ContinuousInput(key="Superplasticizer", bounds=(0.0, 50.0)),
        ContinuousInput(key="Coarse Aggregate", bounds=(0.0, 1200.0)),
        ContinuousInput(key="Fine Aggregate", bounds=(0.0, 1000.0)),
        ContinuousInput(key="Age", bounds=(0.0, 400.0)),
    ],
    outputs=[ContinuousOutput(key="Concrete compressive strength")],
)

DATASET_DOMAINS: dict[str, Domain] = {
    "Auto MPG": _AUTO_MPG,
    "Student Performance": _STUDENT_PERFORMANCE,
    "Abalone": _ABALONE,
    "Concrete Compressive Strength": _CONCRETE,
}


def dataset_domain(dataset_name: str) -> Domain:
    """Declared domain for a supported UCI dataset (dataset.py:123-128)."""
    return DATASET_DOMAINS[dataset_name]


def _load_dataframe(dataset_name: str, data):
    """Resolve the data source to a pandas DataFrame.

    Accepts a DataFrame, a CSV path, or None (→ try the ucimlrepo fetcher,
    matching dataset.py:23)."""
    import pandas as pd

    if data is None:
        try:
            from ucimlrepo import fetch_ucirepo
        except ImportError as e:
            raise RuntimeError(
                f"DatasetBenchmark({dataset_name!r}): no `data=` provided and "
                "the ucimlrepo fetcher is not installed. Pass a DataFrame or "
                "CSV path containing the declared input/output columns."
            ) from e
        ds = fetch_ucirepo(name=dataset_name)
        return pd.concat((ds.data.features, ds.data.targets), axis=1)
    if isinstance(data, (str, os.PathLike)):
        return pd.read_csv(data)
    return data


@register_benchmark("DatasetBenchmark")
class DatasetBenchmark(Benchmark):
    """Regression over a fixed real dataset (dataset.py:131-157).

    ``f`` looks target values up by row identity (points must come from
    ``sample``); ``sample`` draws sequentially without replacement from a
    seed-determined permutation, exactly as the reference.
    """

    def __init__(self, dataset_name: str, standardise: bool = True, data=None):
        super().__init__(dataset_domain(dataset_name))
        df = _load_dataframe(dataset_name, data)
        target = self.domain.output_keys[0]
        cols = self.domain.input_keys + [target]
        # drop NaNs on *input* columns only + sample std (ddof=1), matching
        # the reference's df.dropna / pandas .std() (dataset.py:140-144)
        df = df[cols].dropna(subset=self.domain.input_keys)
        y = np.asarray(df[target], dtype=np.float64)
        if standardise:
            y = (y - np.nanmean(y)) / np.nanstd(y, ddof=1)
        # ordinal-encode inputs once; lookups key on encoded rows
        self.X_data = self.domain.transform({k: df[k] for k in self.domain.input_keys})
        self.y_data = y
        self._num_sampled = 0
        # sample() records the indices it drew so f() can resolve targets by
        # row index (reference: dataset.py:146-148); UCI data contains
        # duplicate feature rows, so value-matching alone can pick the wrong
        # row's target.
        self._sampled_index: dict[bytes, int] = {}

    def _f(self, X: np.ndarray) -> np.ndarray:
        out = np.empty(len(X), dtype=np.float64)
        for i, row in enumerate(np.asarray(X, np.float32)):
            idx = self._sampled_index.get(row.tobytes())
            if idx is None:
                # externally-constructed point: fall back to value match
                match = np.flatnonzero(
                    np.all(np.isclose(self.X_data, row), axis=1)
                )
                if match.size == 0:
                    raise KeyError(
                        "DatasetBenchmark.f: point not in the dataset; draw "
                        "points with .sample()"
                    )
                idx = int(match[0])
            out[i] = self.y_data[idx]
        return out

    def sample(self, n_samples: int, seed: int = 0) -> np.ndarray:
        """Next ``n_samples`` rows of the seed's permutation, encoded (N, D)."""
        if self._num_sampled + n_samples > len(self.y_data):
            raise ValueError("dataset exhausted")
        order = np.random.default_rng(seed).permutation(len(self.y_data))
        idx = order[self._num_sampled : self._num_sampled + n_samples]
        self._num_sampled += n_samples
        rows = self.X_data[idx]
        for row, j in zip(rows, idx):
            # last draw wins on duplicate rows — later draws are the ones a
            # caller is about to evaluate
            self._sampled_index[row.tobytes()] = int(j)
        return rows
