"""Native (C++) runtime components, loaded via ctypes.

The reference's native layer is external C++ (LightGBM for booster fitting,
Gurobi for the MIP; pyproject.toml:14-15). This package holds the
framework's own native equivalents, compiled on demand with the system
toolchain and cached next to the source:

  - ``gbdt.cpp`` — exact greedy least-squares GBDT with LightGBM-style
    categorical bitmask splits, emitting trees in the flat forest encoding
    (the LeafGP import path, parity src/bark/fitting/lgbm_fitting.py).

All callers degrade gracefully when no compiler is available
(``gbdt_available()`` -> False; bark_jax.fitting.booster falls back to the
sklearn backend).
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

_HERE = pathlib.Path(__file__).parent
_LIB_PATH = _HERE / "libbarkgbdt.so"
_SRC_PATH = _HERE / "gbdt.cpp"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def _build() -> bool:
    """Compile gbdt.cpp -> libbarkgbdt.so if missing/stale. Returns success."""
    if _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= _SRC_PATH.stat().st_mtime:
        return True
    try:
        # atomic replace so concurrent builders can't load a half-written .so
        with tempfile.NamedTemporaryFile(
            suffix=".so", dir=_HERE, delete=False
        ) as tmp:
            tmp_path = pathlib.Path(tmp.name)
        cmd = [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
            str(_SRC_PATH), "-o", str(tmp_path),
        ]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        tmp_path.replace(_LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            tmp_path.unlink(missing_ok=True)
        except (OSError, NameError):
            pass
        return False


def _load() -> ctypes.CDLL | None:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not _build():
            _load_failed = True
            return None
        lib = ctypes.CDLL(str(_LIB_PATH))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.bark_gbdt_fit.restype = ctypes.c_int
        lib.bark_gbdt_fit.argtypes = [
            f32p, f32p, ctypes.c_int, ctypes.c_int, i32p, i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int,
            u8p, i32p, f32p, i32p, i32p, i32p, i32p, u8p, f32p,
        ]
        lib.bark_gbdt_predict.restype = None
        lib.bark_gbdt_predict.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int,
            ctypes.c_int, u8p, i32p, f32p, i32p, i32p, f32p, i32p, f32p,
        ]
        _lib = lib
        return _lib


def gbdt_available() -> bool:
    """Whether the native booster can be built/loaded on this host."""
    return _load() is not None


def fit_gbdt(
    X: np.ndarray,
    y: np.ndarray,
    feat_types: np.ndarray,
    cat_sizes: np.ndarray,
    num_rounds: int = 50,
    max_depth: int = 3,
    learning_rate: float = 0.1,
    node_limit: int = 64,
    min_samples_leaf: int = 1,
) -> dict:
    """Fit the native GBDT; returns flat forest arrays + ``leaf_value``.

    Arrays have shape ``(num_rounds, node_limit)`` in the encoding of
    :class:`bark_jax.forest.Forest`. Raises RuntimeError if the native
    library is unavailable, OverflowError if a tree exceeds ``node_limit``.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native GBDT library unavailable (no C++ toolchain?)")
    X = np.ascontiguousarray(X, np.float32)
    y = np.ascontiguousarray(y, np.float32).reshape(-1)
    n, d = X.shape
    feat_types = np.ascontiguousarray(feat_types, np.int32)
    cat_sizes = np.ascontiguousarray(cat_sizes, np.int32)
    shape = (num_rounds, node_limit)
    out = {
        "is_leaf": np.zeros(shape, np.uint8),
        "feature": np.zeros(shape, np.int32),
        "threshold": np.zeros(shape, np.float32),
        "left": np.zeros(shape, np.int32),
        "right": np.zeros(shape, np.int32),
        "parent": np.zeros(shape, np.int32),
        "depth": np.zeros(shape, np.int32),
        "active": np.zeros(shape, np.uint8),
        "leaf_value": np.zeros(shape, np.float32),
    }
    rc = lib.bark_gbdt_fit(
        X, y, n, d, feat_types, cat_sizes,
        num_rounds, max_depth, learning_rate, node_limit, min_samples_leaf,
        out["is_leaf"], out["feature"], out["threshold"], out["left"],
        out["right"], out["parent"], out["depth"], out["active"],
        out["leaf_value"],
    )
    if rc != 0:
        raise OverflowError(
            f"native GBDT tree exceeded node_limit={node_limit}"
        )
    out["is_leaf"] = out["is_leaf"].astype(bool)
    out["active"] = out["active"].astype(bool)
    return out


def predict_gbdt(
    X: np.ndarray, arrays: dict, feat_types: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Route rows through a fitted native forest.

    Returns ``(leaves (n, m) int32, pred (n,) float32)`` where pred is the
    sum of leaf values (the booster's regression output).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native GBDT library unavailable")
    X = np.ascontiguousarray(X, np.float32)
    n, d = X.shape
    m, node_limit = arrays["is_leaf"].shape
    feat_types = np.ascontiguousarray(feat_types, np.int32)
    leaves = np.zeros((n, m), np.int32)
    pred = np.zeros((n,), np.float32)
    lib.bark_gbdt_predict(
        X, n, d, feat_types, m, node_limit,
        np.ascontiguousarray(arrays["is_leaf"], np.uint8),
        np.ascontiguousarray(arrays["feature"], np.int32),
        np.ascontiguousarray(arrays["threshold"], np.float32),
        np.ascontiguousarray(arrays["left"], np.int32),
        np.ascontiguousarray(arrays["right"], np.int32),
        np.ascontiguousarray(arrays["leaf_value"], np.float32),
        leaves, pred,
    )
    return leaves, pred
