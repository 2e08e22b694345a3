"""Branch-free int32 bit operations for categorical bitmask splits.

Parity targets: src/bark/utils/bit_operations.py:5-58 (next_power_of_2,
bit_count, sample_binary_mask). All functions operate on traced int32 scalars
inside jit/vmap — the reference's Python while-loops become fixed-trip-count
loops over the 25 bit positions relevant for <=24-category masks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from bark_jax.forest import MAX_CATEGORIES

_NUM_BITS = MAX_CATEGORIES + 1  # enough to cover next_power_of_2 of any mask


def popcount(x: jax.Array) -> jax.Array:
    """Number of set bits (src/bark/utils/bit_operations.py:23-31)."""
    x = x.astype(jnp.uint32)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24).astype(jnp.int32)


def next_power_of_2(x: jax.Array) -> jax.Array:
    """Smallest power of two strictly greater than x (for x >= 0).

    Parity: src/bark/utils/bit_operations.py:5-10 (``while x >= p: p <<= 1``).
    """
    x = jnp.asarray(x, jnp.int32)
    powers = jnp.left_shift(jnp.int32(1), jnp.arange(_NUM_BITS, dtype=jnp.int32))
    exponent = jnp.sum((powers <= x[..., None]).astype(jnp.int32), axis=-1)
    return jnp.left_shift(jnp.int32(1), exponent)


def sample_binary_mask(key: jax.Array, mask: jax.Array) -> jax.Array:
    """Uniformly sample a proper, non-empty subset of the set bits of mask.

    Parity: src/bark/utils/bit_operations.py:34-58 — draw a uniform integer in
    ``[1, 2^c - 2]`` (c = popcount(mask)) and scatter its bits into the set
    bit positions of ``mask``. Returns 0 when mask has < 2 set bits (the
    degenerate-split indicator the sampler rejects on).
    """
    mask = mask.astype(jnp.int32)
    c = popcount(mask)
    max_sample = jnp.left_shift(jnp.int32(1), c) - 1  # all-ones over choices
    # uniform in [1, max_sample - 1] == reference np.random.randint(1, max_sample)
    r = jax.random.randint(
        key, (), jnp.int32(1), jnp.maximum(max_sample, jnp.int32(2))
    ).astype(jnp.int32)
    return scatter_bits(r, mask, c)


def scatter_bits(r: jax.Array, mask: jax.Array, c: jax.Array) -> jax.Array:
    """Scatter the low ``popcount(mask)`` bits of ``r`` into the set bit
    positions of ``mask`` (ascending), branch-free and fully parallel.

    Bit ``i`` of the result takes bit ``rank(i)`` of ``r``, where ``rank(i)``
    is the number of set mask bits below position ``i`` — the same mapping
    the reference's sequential consume-one-bit loop produces
    (src/bark/utils/bit_operations.py:44-56) without the 25-iteration
    sequential chain in the sampler's hot path. Returns 0 when ``c < 2``
    (degenerate-split indicator).
    """
    idx = jnp.arange(_NUM_BITS, dtype=jnp.int32)
    below = jnp.left_shift(jnp.int32(1), idx) - 1
    ranks = popcount(mask & below)  # (25,)
    mask_bits = (mask >> idx) & 1
    sel = (r >> ranks) & 1
    threshold = jnp.sum(
        jnp.where(mask_bits & sel, jnp.left_shift(jnp.int32(1), idx), 0)
    )
    return jnp.where(c < 2, jnp.int32(0), threshold)
