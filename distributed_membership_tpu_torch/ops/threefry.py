"""Threefry-2x32 in PyTorch: the ``jax.random`` streams, bit for bit.

Every random stream of the ring step comes from ``jax.random`` in the
JAX package, so per-tick parity with it is only possible if the port
reproduces those bits exactly.  This module ports the pieces the slice
needs from jax 0.9 (``_src/prng.py`` threefry2x32 and its
``jax_threefry_partitionable=True`` split/bits; ``_src/random.py``
``_uniform`` and ``_randint``), under JAX's default 32-bit mode.

Representation: a key is a pair of Python ints ``(k0, k1)``, each a u32.
Key derivation (``prng_key``, ``fold_in``, ``split``) is scalar work and
stays on the host in Python ints, so a tick never copies a key to the
device.  Bulk draws (``random_bits``, ``uniform``, ``randint``) run on
``int64`` tensors on the requested device, with every u32 intermediate
masked by ``& 0xFFFFFFFF`` (CPU PyTorch has no u32 arithmetic).

The round function is written once with plain operators, so the same
code hashes Python ints and int64 tensors, keys included: one pass over
a ``[K, numel]`` counter grid with a ``[K, 1]`` key column draws K keys'
streams at once (``uniform_keys``, the JAX package's vmapped draws).
Element ``i`` of a draw depends on ``i`` and the key only, so a draw can
also be taken at chosen elements (``uniform_at``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

M32 = 0xFFFFFFFF
Key = Tuple[int, int]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 with 20 rounds on u32 words (``prng.py``
    ``_threefry2x32_lowering``).  ``x0``/``x1`` are Python ints or int64
    tensors holding u32 values; the result has the same kind.

    The round updates tensors in place (the inputs are copied first) and
    masks only where the next step needs a clean u32: ``x1`` before its
    rotate, ``x0`` after its add.  The words above bit 31 are otherwise
    left to collect carries and shifted-out bits, which never reach the
    low 32 bits and stay below 2^62, so int64 never overflows."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x0 &= M32
            x1 &= M32
            low = x1 >> (32 - r)
            x1 <<= r
            x1 |= low
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + i + 1
    return x0 & M32, x1 & M32


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` under 32-bit mode: the seed is taken
    mod 2^32 and the high word is 0."""
    return (0, int(seed) & M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: hash the count pair ``(0, data)``."""
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def split(key: Key, num: int = 2) -> list:
    """``jax.random.split`` on the partitionable stream (the fold-like
    split): key ``i`` is the hash of the count pair ``(0, i)``."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def random_bits(key: Key, numel: int, device) -> torch.Tensor:
    """32 random bits per element, flat ``[numel]`` int64 holding u32.

    Partitionable stream: element ``i`` hashes the 64-bit count ``i``
    split into ``(hi, lo)`` words and XORs the two output words.  A
    shape's draw is its flat draw reshaped, so callers pass the element
    count only."""
    if numel >= 1 << 32:
        raise ValueError(f"draw of {numel} elements exceeds the u32 count")
    lo = torch.arange(numel, dtype=torch.int64, device=device)
    return _bits_at(key[0], key[1], lo)


def _bits_at(k0, k1, lo: torch.Tensor) -> torch.Tensor:
    """The bits of elements ``lo`` (< 2^32, so the count's high word is
    0) under the key words ``k0``/``k1`` (ints, or tensors broadcasting
    against ``lo``)."""
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return b0.bitwise_xor_(b1)


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """u32 bits -> float32 on [0, 1): the top 23 bits become the mantissa
    of a float in [1, 2), minus 1 (``jax.random.uniform``)."""
    bits = bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000)
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: Key, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1)."""
    return _unit(random_bits(key, math.prod(shape), device)).reshape(shape)


def uniform_at(key: Key, idx: torch.Tensor) -> torch.Tensor:
    """Elements ``idx`` (int64, any shape, each < 2^32) of the flat draw
    ``uniform(key, ...)``, on ``idx``'s device."""
    return _unit(_bits_at(key[0], key[1], idx))


def uniform_keys(keys, numel: int, device) -> torch.Tensor:
    """``torch.cat([uniform(k, (numel,)) for k in keys])`` in one pass
    over a ``[len(keys), numel]`` grid.  The key words reach the device
    as fills, so nothing is copied from the host."""
    if len(keys) == 1:
        return uniform(keys[0], (numel,), device)
    if numel >= 1 << 32:
        raise ValueError(f"draw of {numel} elements exceeds the u32 count")

    def column(word):
        return torch.stack([torch.full((), k[word], dtype=torch.int64,
                                       device=device) for k in keys])[:, None]

    lo = torch.arange(numel, dtype=torch.int64, device=device)[None, :]
    return _unit(_bits_at(column(0), column(1), lo)).reshape(-1)


def randint(key: Key, shape, minval: int, maxval: int, device) -> torch.Tensor:
    """``jax.random.randint`` into int32 for ``0 <= minval < maxval <
    2^31``: two 32-bit draws combined modulo the span, with the
    multiplier ``(2^16 % span)^2 % span`` taken in u32 arithmetic (it
    wraps for spans above 2^16, as JAX's does)."""
    if not 0 <= minval < maxval < 1 << 31:
        raise ValueError(f"randint range [{minval}, {maxval}) unsupported")
    k_hi, k_lo = split(key, 2)
    numel = math.prod(shape)
    hi = random_bits(k_hi, numel, device)
    lo = random_bits(k_lo, numel, device)
    span = maxval - minval
    mult = (1 << 16) % span
    mult = ((mult * mult) & M32) % span
    off = (((hi % span) * mult) & M32) + lo % span
    off = (off & M32) % span
    return (off + minval).to(torch.int32).reshape(shape)
