"""Checkpoint / resume for sampler state and surrogates.

The reference stubs serialization entirely (``_dumps``/``loads`` are no-ops,
src/bofire_mixed/surrogates/bark.py:96-100) and relies on in-process
warm-starting. Here a checkpoint is exactly what SURVEY.md §5 prescribes:
an array snapshot of the model triple (forest SoA + noise + scale) plus the
RNG key state and scaler statistics — a single .npz written atomically.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import jax
import numpy as np

from bark_jax.fitting.sampler import BARKModel
from bark_jax.forest import Forest, forest_from_numpy

FOREST_FIELDS = (
    "is_leaf", "feature", "threshold", "left", "right", "parent", "depth",
    "active",
)


def _atomic_savez(path: Path, **arrays):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    # the suffix must be ".npz": numpy appends it otherwise, which would
    # leave the temp handle empty and the rename would move a 0-byte file
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_model(path, model: BARKModel, key: jax.Array | None = None, **extra):
    """Snapshot a model triple (+ optional RNG key and scalar metadata)."""
    arrays = {
        f"forest_{f}": np.asarray(getattr(model.forest, f))
        for f in FOREST_FIELDS
    }
    arrays["noise"] = np.asarray(model.noise)
    arrays["scale"] = np.asarray(model.scale)
    if key is not None:
        arrays["rng_key"] = np.asarray(jax.random.key_data(key))
    for k, v in extra.items():
        arrays[f"extra_{k}"] = np.asarray(v)
    _atomic_savez(path, **arrays)


def load_model(path) -> tuple[BARKModel, jax.Array | None, dict]:
    """Restore (model, rng key or None, extra metadata dict)."""
    with np.load(path) as data:
        forest = forest_from_numpy(
            {f: data[f"forest_{f}"] for f in FOREST_FIELDS}
        )
        model = BARKModel(
            forest=forest,
            noise=np.asarray(data["noise"]),
            scale=np.asarray(data["scale"]),
        )
        key = None
        if "rng_key" in data:
            key = jax.random.wrap_key_data(data["rng_key"])
        extra = {
            k[len("extra_"):]: data[k]
            for k in data.files
            if k.startswith("extra_")
        }
    import jax.numpy as jnp

    model = BARKModel(
        forest=forest,
        noise=jnp.asarray(model.noise),
        scale=jnp.asarray(model.scale),
    )
    return model, key, extra


def save_surrogate(path, surrogate) -> None:
    """Checkpoint a fitted BARK surrogate (model + scaler + train data)."""
    train_x, train_y = surrogate.train_data
    save_model(
        path,
        surrogate.model,
        key=getattr(surrogate, "_key", None),
        scaler_mean=surrogate.scaler.mean,
        scaler_std=surrogate.scaler.std,
        train_x=np.asarray(train_x),
        train_y=np.asarray(train_y),
        train_mask=np.asarray(surrogate.train_mask)
        if surrogate.train_mask is not None
        else np.ones(np.asarray(train_x).shape[0], np.float32),
    )


def load_surrogate(path, surrogate):
    """Restore a checkpoint into a freshly-constructed surrogate."""
    import jax.numpy as jnp

    model, key, extra = load_model(path)
    surrogate.model = model
    if key is not None:
        surrogate._key = key
    surrogate.scaler.mean = float(extra["scaler_mean"])
    surrogate.scaler.std = float(extra["scaler_std"])
    surrogate.train_data = (
        jnp.asarray(extra["train_x"]),
        jnp.asarray(extra["train_y"]),
    )
    surrogate.train_mask = jnp.asarray(extra["train_mask"])
    return surrogate


def save_bart_surrogate(path, surrogate) -> None:
    """Checkpoint a fitted BART surrogate (samples + chain state + scaler).

    Everything BART needs to resume is arrays: posterior draws, per-chain
    final states (for warm-started refits), the min-max y scaler, the
    calibrated noise-prior rate, the padded train data and its mask, and
    the RNG key.
    """
    s, st = surrogate.samples, surrogate._state
    train_x, train_y = surrogate.train_data
    arrays = {
        "samples_packed": np.asarray(s.packed),
        "samples_leaf_values": np.asarray(s.leaf_values),
        "samples_sigma2": np.asarray(s.sigma2),
        "state_packed": np.asarray(st.packed),
        "state_leaf_values": np.asarray(st.leaf_values),
        "state_leaves": np.asarray(st.leaves),
        "state_f_total": np.asarray(st.f_total),
        "state_sigma2": np.asarray(st.sigma2),
        "scaler_y_min": np.asarray(surrogate.scaler.y_min),
        "scaler_range": np.asarray(surrogate.scaler.range),
        "noise_rate": np.asarray(surrogate._noise_rate),
        "train_x": np.asarray(train_x),
        "train_y": np.asarray(train_y),
        "train_mask": np.asarray(surrogate.train_mask),
        "rng_key": np.asarray(jax.random.key_data(surrogate._key)),
    }
    _atomic_savez(path, **arrays)


def load_bart_surrogate(path, surrogate):
    """Restore a BART checkpoint into a freshly-constructed surrogate."""
    import jax.numpy as jnp

    from bark_jax.fitting.bart import BARTSamples, BARTState

    with np.load(path) as data:
        surrogate.samples = BARTSamples(
            packed=jnp.asarray(data["samples_packed"]),
            leaf_values=jnp.asarray(data["samples_leaf_values"]),
            sigma2=jnp.asarray(data["samples_sigma2"]),
        )
        surrogate._state = BARTState(
            packed=jnp.asarray(data["state_packed"]),
            leaf_values=jnp.asarray(data["state_leaf_values"]),
            leaves=jnp.asarray(data["state_leaves"]),
            f_total=jnp.asarray(data["state_f_total"]),
            sigma2=jnp.asarray(data["state_sigma2"]),
        )
        surrogate.scaler.y_min = float(data["scaler_y_min"])
        surrogate.scaler.range = float(data["scaler_range"])
        surrogate._noise_rate = jnp.asarray(data["noise_rate"])
        surrogate.train_data = (
            jnp.asarray(data["train_x"]),
            jnp.asarray(data["train_y"]),
        )
        surrogate.train_mask = jnp.asarray(data["train_mask"])
        surrogate._key = jax.random.wrap_key_data(np.asarray(data["rng_key"]))
    return surrogate
