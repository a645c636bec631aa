"""JAX's threefry key stream, bit for bit, on the host.

The fused measurement route (``ops/measurement.py``) thresholds each
shot's outcome against ``jax.random.uniform(jax.random.fold_in(key,
shot), dtype=dtype)``, as the JAX package's fused route does.  This
module computes the same numbers with NumPy ``uint32`` arithmetic (all
mod 2^32), so the same seeds give the same outcomes in both packages.
The draw depends on nothing but (key, shot), so a call's thresholds are
computed here and uploaded to the card once.

The stream is JAX's default ``threefry2x32`` implementation with
``jax_threefry_partitionable`` on: a scalar 32-bit draw takes
``x0 ^ x1`` of the block ``threefry2x32(key, (0, 0))``, a 64-bit draw
``(x0 << 32) | x1``.  ``tests/test_torch_rng.py`` pins both against
``jax.random``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """The 20-round Threefry-2x32 block function (Salmon et al. 2011) on
    uint32 arrays that broadcast together."""
    k0 = np.asarray(k0, dtype=np.uint32)
    k1 = np.asarray(k1, dtype=np.uint32)
    x0 = np.array(x0, dtype=np.uint32, ndmin=1)
    x1 = np.array(x1, dtype=np.uint32, ndmin=1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a seed below 2^32."""
    return 0, int(seed) & 0xFFFFFFFF


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in(key, data)``."""
    x0, x1 = threefry2x32(key[0], key[1], 0, int(data) & 0xFFFFFFFF)
    return int(x0[0]), int(x1[0])


def key_from_seeds(seeds: Sequence[int]) -> Tuple[int, int]:
    """The JAX package's measurement key for ``seedQuEST(env, seeds)``:
    ``PRNGKey(seeds[0])`` folded with each further seed (0 for none)."""
    seeds = [int(s) & 0xFFFFFFFF for s in seeds]
    key = prng_key(seeds[0] if seeds else 0)
    for s in seeds[1:]:
        key = fold_in(key, s)
    return key


def uniforms(key: Tuple[int, int], shot: int, count: int,
             dtype: str) -> np.ndarray:
    """``jax.random.uniform(jax.random.fold_in(key, s), dtype=dtype)``
    for s = shot .. shot + count - 1, as a NumPy array of ``dtype``
    ("float32" or "float64"); every value is exact."""
    shots = (np.arange(count, dtype=np.uint64) + np.uint64(shot)) \
        .astype(np.uint32)
    s0, s1 = threefry2x32(key[0], key[1], np.zeros_like(shots), shots)
    zero = np.zeros_like(s0)
    x0, x1 = threefry2x32(s0, s1, zero, zero)
    if dtype == "float32":
        bits = (x0 ^ x1) >> np.uint32(9)
        return (bits.astype(np.float64) * 2.0 ** -23).astype(np.float32)
    if dtype == "float64":
        bits = ((x0.astype(np.uint64) << np.uint64(32))
                | x1.astype(np.uint64)) >> np.uint64(12)
        return bits.astype(np.float64) * 2.0 ** -52
    raise ValueError(f"uniforms: dtype {dtype!r} is not float32 or float64")
