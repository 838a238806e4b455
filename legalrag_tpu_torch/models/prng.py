"""numpy reproduction of ``jax.random.normal(jax.random.PRNGKey(seed), shape)``.

The hash encoder's default projection is that Gaussian matrix
(``legalrag_tpu/models/hash_encoder.py:113-115``) and is not saved with an
index, so the port must draw the same numbers. JAX's recipe, as of jax 0.9
with ``jax_threefry_partitionable=True`` (its default):

1. the key of ``PRNGKey(seed)`` is the uint32 pair ``(seed >> 32, seed & 0xffffffff)``;
2. element ``i`` of the flat output gets the counter pair ``(i >> 32, i & 0xffffffff)``,
   hashed with threefry2x32 (20 rounds); its 32 random bits are ``x0 ^ x1``;
3. uniform: the top 23 bits become the mantissa of a float in [1, 2), minus 1,
   scaled onto ``[nextafter(-1, 0), 1)`` and clamped below at that bound;
4. normal: ``sqrt(2) * erfinv(u)``.

Steps 1-3 are bit-exact. JAX's ``erf_inv`` is a float32 polynomial; scipy's
float64 ``erfinv`` rounded to float32 differs from it by at most 2.2e-5
absolute and 5.8e-6 relative over the 16384 x 768 projection of seed 7
(``tests/test_torch_hash_encoder.py``).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
from scipy.special import erfinv

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (Salmon et al. 2011), 20 rounds, as ``jax._src.prng``."""
    ks = [np.uint32(k0), np.uint32(k1),
          np.uint32(k0 ^ k1 ^ 0x1BD11BDA)]
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def jax_normal(seed: int, shape: Sequence[int]) -> np.ndarray:
    """float32 samples equal to ``jax.random.normal(PRNGKey(seed), shape)``
    up to the erfinv residue stated in the module docstring."""
    size = math.prod(shape)
    idx = np.arange(size, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    del idx
    seed = int(seed) & (2 ** 64 - 1)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(seed >> 32, seed & 0xFFFFFFFF, hi, lo)
    bits = b0 ^ b1
    del b0, b1, hi, lo
    fbits = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = fbits.view(np.float32) - np.float32(1.0)
    lo_f = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    hi_f = np.float32(1.0)
    u = np.maximum(lo_f, floats * (hi_f - lo_f) + lo_f)
    z = np.sqrt(2.0) * erfinv(u.astype(np.float64))
    return z.astype(np.float32).reshape(tuple(shape))
