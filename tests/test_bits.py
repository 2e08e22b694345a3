"""Bit-operation property tests.

Parity with the reference's tests/test_bit_operations.py:4-17: sampled
categorical masks are non-empty proper subsets of the available mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bark_jax.fitting.bits import next_power_of_2, popcount, sample_binary_mask


@pytest.mark.parametrize("x,expect", [(0, 1), (1, 2), (2, 4), (3, 4), (4, 8), (5, 8), (15, 16), (16, 32)])
def test_next_power_of_2(x, expect):
    assert int(next_power_of_2(jnp.int32(x))) == expect


def test_popcount():
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 1 << 24, size=100)
    got = np.asarray(jax.vmap(popcount)(jnp.asarray(xs, jnp.int32)))
    expect = np.array([bin(int(x)).count("1") for x in xs])
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("mask", [0b1111, 0b1010101, 0b11, (1 << 10) - 1])
def test_sample_binary_mask_proper_nonempty_subset(mask):
    keys = jax.random.split(jax.random.key(0), 100)
    samples = np.asarray(
        jax.vmap(lambda k: sample_binary_mask(k, jnp.int32(mask)))(keys)
    )
    for s in samples:
        s = int(s)
        assert s != 0, "subset must be non-empty"
        assert s != mask, "subset must be proper"
        assert (s & ~mask) == 0, "subset must be within the mask"


def test_sample_binary_mask_degenerate():
    # fewer than two available categories -> 0 (rejection indicator)
    for mask in (0, 1, 0b1000):
        got = int(sample_binary_mask(jax.random.key(0), jnp.int32(mask)))
        assert got == 0


def test_sample_binary_mask_uniform():
    """All 2^c - 2 proper non-empty subsets occur with equal frequency."""
    mask = 0b10110  # c = 3 -> 6 valid subsets
    keys = jax.random.split(jax.random.key(1), 3000)
    samples = np.asarray(
        jax.vmap(lambda k: sample_binary_mask(k, jnp.int32(mask)))(keys)
    )
    values, counts = np.unique(samples, return_counts=True)
    assert len(values) == 6
    assert counts.min() > 3000 / 6 * 0.7
