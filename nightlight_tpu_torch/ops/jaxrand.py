"""JAX's threefry2x32 key derivation and ``randint`` in numpy, bit for bit.

The sampled robust estimators (ops/stats.py, models/fastpath.py) draw their
sample indices and roll shifts from fixed ``jax.random.PRNGKey(0)`` keys in
the JAX package. Location and scale are order statistics of that sample, so
the port must draw the SAME indices or every detection threshold, star count
and histogram match downstream drifts by sampling noise. This module
reproduces, for the default ``jax_threefry_partitionable=True`` scheme:

* ``prng_key(seed)``       == ``jax.random.PRNGKey(seed)`` (raw uint32[2])
* ``split(key, num)``      == ``jax.random.split(key, num)``
* ``fold_in(key, data)``   == ``jax.random.fold_in(key, data)``
* ``randint(key, shape, minval, maxval)`` == ``jax.random.randint`` (int32)

Everything is host-side numpy on uint32 arrays; the draws are tiny (at most
a few hundred thousand indices per image size) and are cached by callers.
"""

from __future__ import annotations

import numpy as np

_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 hash with 20 rounds (jax/_src/prng.py
    _threefry2x32_lowering). k1, k2: uint32 scalars; x1, x2: uint32 arrays
    of one shape. Returns the two uint32 output words."""
    k1 = np.uint32(k1)
    k2 = np.uint32(k2)
    ks = (k1, k2, np.uint32(k1 ^ k2 ^ np.uint32(0x1BD11BDA)))
    x0 = np.asarray(x1, np.uint32) + ks[0]
    y0 = np.asarray(x2, np.uint32) + ks[1]
    x = [x0, y0]
    schedule = (
        (_ROT0, ks[1], ks[2], 1), (_ROT1, ks[2], ks[0], 2),
        (_ROT0, ks[0], ks[1], 3), (_ROT1, ks[1], ks[2], 4),
        (_ROT0, ks[2], ks[0], 5),
    )
    with np.errstate(over="ignore"):
        for rots, ka, kb, inc in schedule:
            for r in rots:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r)
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ka
            x[1] = x[1] + kb + np.uint32(inc)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: [0, seed]."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _iota_2x32(shape) -> tuple[np.ndarray, np.ndarray]:
    """(high, low) 32-bit words of a row-major uint64 iota of `shape`."""
    n = int(np.prod(shape)) if len(shape) else 1
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (num, 2) uint32 keys (fold-like scheme)."""
    hi, lo = _iota_2x32((int(num),))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=-1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: threefry_2x32(key, [0, data])."""
    b1, b2 = threefry2x32(key[0], key[1], np.array([0], np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([b1[0], b2[0]], np.uint32)


def _random_bits32(key: np.ndarray, shape) -> np.ndarray:
    hi, lo = _iota_2x32(tuple(shape))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` with the default
    int32 dtype (jax/_src/random.py _randint): two 32-bit draws combined
    modulo the span."""
    shape = tuple(int(s) for s in shape)
    lo_v = max(int(minval), -(1 << 31))
    hi_v = min(int(maxval), (1 << 31) - 1)
    k = split(key, 2)
    higher = _random_bits32(k[0], shape)
    lower = _random_bits32(k[1], shape)
    span = np.uint32(1 if hi_v <= lo_v else (hi_v - lo_v) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        # uint32 arithmetic wraps, as lax.mul does
        mult = np.uint32((1 << 16) % int(span))
        mult = np.uint32(((int(mult) * int(mult)) & 0xFFFFFFFF) % int(span))
        off = (higher % span) * mult + (lower % span)
        off = off % span
    return (np.int64(lo_v) + off.astype(np.int64)).astype(np.int32)
