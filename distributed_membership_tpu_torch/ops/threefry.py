"""Threefry-2x32 in PyTorch: the ``jax.random`` streams, bit for bit.

Every random stream of the ring step comes from ``jax.random`` in the
JAX package, so per-tick parity with it is only possible if the port
reproduces those bits exactly.  This module ports the pieces the port
needs from jax 0.9 (``_src/prng.py`` threefry2x32 with both of its
streams; ``_src/random.py`` ``_uniform`` and ``_randint``), under JAX's
default 32-bit mode.

Two streams, as jax has (its ``jax_threefry_partitionable`` flag):

* partitionable (jax 0.9's default): element ``i`` of a draw hashes the
  count pair ``(0, i)`` and XORs the two output words; ``split(key, num)``
  hashes ``(0, i)`` for key ``i``.  Element ``i`` depends on ``i`` alone.
* legacy: a draw of ``n`` elements hashes the pairs ``(i, i + h)``, ``h =
  ceil(n / 2)`` (an odd ``n`` pads its last pair with a zero count and
  drops that pad's output), and concatenates the pairs' first words, then
  their second words; ``split(key, num)`` is the draw of ``2 * num`` counts
  read as ``num`` key pairs.  Element ``i`` depends on ``n`` too, so a
  draw taken at chosen elements (:func:`uniform_at`) needs its count.

``fold_in`` is the same in both.  The module's stream starts from the
environment variable jax itself reads, ``JAX_THREEFRY_PARTITIONABLE``
(parsed as jax parses a boolean flag; unset means True, as in jax 0.9),
so one setting drives both packages; :func:`partitionable` switches it
for a block, as ``jax.threefry_partitionable`` does.

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

``PRNG_IMPL: rbg|unsafe_rbg`` keys (``ops/rbg.RbgKey``) take the same
functions: each public function here dispatches on the key's type, so
no call site needs to know the implementation.  A vmapped draw is not a
loop's draw under them (ops/rbg.py): ``uniform_keys``, ``bits_keys``,
``split_keys``, ``randint_keys`` and ``fold_in_vmapped`` stand for the
JAX package's vmapped sites, ``uniform_each`` for per-key draws that no
vmap batches (each shard's own, inside the JAX package's ``shard_map``).
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Tuple

import numpy as np
import torch

from distributed_membership_tpu_torch.ops import rbg

M32 = 0xFFFFFFFF
Key = Tuple[int, int]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _bool_env(name: str, default: bool) -> bool:
    """A boolean environment variable as jax's ``bool_env`` reads it."""
    val = os.getenv(name, str(default)).lower()
    if val in ("y", "yes", "t", "true", "on", "1"):
        return True
    if val in ("n", "no", "f", "false", "off", "0"):
        return False
    raise ValueError(f"invalid truth value {val!r} for environment {name!r}")


# The stream in force: jax's own flag, read from the same variable.
_PARTITIONABLE = _bool_env("JAX_THREEFRY_PARTITIONABLE", True)


def is_partitionable() -> bool:
    """Whether draws follow the partitionable stream (else the legacy)."""
    return _PARTITIONABLE


@contextlib.contextmanager
def partitionable(flag: bool):
    """Draw from the partitionable stream (True) or the legacy one (False)
    inside the block, as ``with jax.threefry_partitionable(flag)``."""
    global _PARTITIONABLE
    prev, _PARTITIONABLE = _PARTITIONABLE, bool(flag)
    try:
        yield
    finally:
        _PARTITIONABLE = prev


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


def is_rbg(key) -> bool:
    """Whether ``key`` is an rbg or unsafe_rbg key (else threefry's)."""
    return isinstance(key, rbg.RbgKey)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: hash the count pair ``(0, data)``."""
    if is_rbg(key):
        return rbg.fold_in(key, data)
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def fold_in_vmapped(key: Key, data: int, first: int, row: int) -> Key:
    """Row ``row`` of ``jax.vmap(lambda d: jax.random.fold_in(key,
    d))(datas)`` with ``datas[0] == first`` and ``datas[row] == data``:
    ``fold_in(key, data)``, except under unsafe_rbg (ops/rbg.py)."""
    if is_rbg(key):
        return rbg.fold_in_vmapped(key, data, first, row)
    return fold_in(key, data)


def split(key: Key, num: int = 2) -> list:
    """``jax.random.split``: on the partitionable stream key ``i`` is the
    hash of the count pair ``(0, i)``; on the legacy one the ``2 * num``
    counts hash as the pairs ``(i, i + num)``, whose first words then
    second words, read two at a time, are the keys."""
    if is_rbg(key):
        return rbg.split(key, num)
    if _PARTITIONABLE:
        return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]
    pairs = [threefry2x32(key[0], key[1], i, i + num) for i in range(num)]
    words = [w0 for w0, _ in pairs] + [w1 for _, w1 in pairs]
    return [(words[2 * i], words[2 * i + 1]) for i in range(num)]


def split_keys(keys, num: int) -> list:
    """``jax.vmap(lambda k: jax.random.split(k, num))(keys)``: one list of
    ``num`` keys per key."""
    if is_rbg(keys[0]):
        return rbg.split_vmapped(keys, num)
    return [split(k, num) for k in keys]


def _check_size(numel: int) -> None:
    """Counts are u32.  The legacy stream also splits its key into blocks
    from 2^32 - 1 elements on (jax's ``nblocks`` path), which no draw
    below this guard reaches."""
    if numel >= (1 << 32 if _PARTITIONABLE else M32):
        raise ValueError(f"draw of {numel} elements exceeds the u32 count")


def random_bits(key: Key, numel: int, device) -> torch.Tensor:
    """32 random bits per element, flat ``[numel]`` int64 holding u32.
    A shape's draw is its flat draw reshaped, so callers pass the element
    count only."""
    if is_rbg(key):
        return rbg.bits(key, numel, device)
    _check_size(numel)
    if _PARTITIONABLE:
        lo = torch.arange(numel, dtype=torch.int64, device=device)
        return _bits_at(key[0], key[1], lo, numel)
    return _legacy_rows(key[0], key[1], 1, numel, device).reshape(-1)


def _legacy_rows(k0, k1, rows: int, numel: int, device) -> torch.Tensor:
    """The legacy stream's ``[rows, numel]`` draws under key words that
    broadcast against a ``[rows, 1]`` column: each row hashes its ``h``
    pairs ``(i, i + h)`` once and lays out their first words, then their
    second words (an odd draw's last pair ends in the zero pad)."""
    h = (numel + 1) // 2
    x0 = torch.arange(h, dtype=torch.int64, device=device)
    x1 = x0 + h
    if numel % 2:
        x1[-1] = 0
    x0, x1 = x0[None, :].expand(rows, h), x1[None, :].expand(rows, h)
    w0, w1 = threefry2x32(k0, k1, x0, x1)
    return torch.cat([w0, w1], dim=1)[:, :numel]


def _bits_at(k0, k1, lo: torch.Tensor, numel: int) -> torch.Tensor:
    """The bits of elements ``lo`` (each < ``numel`` < 2^32) of a
    ``numel``-element draw under the key words ``k0``/``k1`` (ints, or
    tensors broadcasting against ``lo``)."""
    if _PARTITIONABLE:
        b0, b1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
        return b0.bitwise_xor_(b1)
    # Element i is word 0 of the pair (i, i + h) below h, else word 1 of
    # the pair (i - h, i); the odd draw's pad count is 0.
    h = (numel + 1) // 2
    first = lo < h
    x0 = torch.where(first, lo, lo - h)
    x1 = torch.where(first, lo + h, lo)
    x1 = torch.where(x1 >= numel, 0, x1)
    b0, b1 = threefry2x32(k0, k1, x0, x1)
    return torch.where(first, b0, b1)


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """u32 bits -> float32 on [0, 1): the top 23 bits become the mantissa
    of a float in [1, 2), minus 1 (``jax.random.uniform``)."""
    bits = bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000)
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: Key, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1)."""
    if is_rbg(key):
        return rbg.uniform(key, math.prod(shape), device).reshape(shape)
    return _unit(random_bits(key, math.prod(shape), device)).reshape(shape)


def bernoulli(key: Key, p: float, shape, device) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform(key, shape) <
    p``, with ``p`` rounded to float32 as jax rounds a Python float."""
    return uniform(key, shape, device) < float(np.float32(p))


def bernoulli_at(key: Key, p: float, idx: torch.Tensor,
                 numel: int) -> torch.Tensor:
    """Elements ``idx`` of the flat draw ``bernoulli(key, p, (numel,))``
    (so of any shape's draw of ``numel`` elements, at flat indices)."""
    return uniform_at(key, idx, numel) < float(np.float32(p))


def uniform_at(key: Key, idx: torch.Tensor, numel: int) -> torch.Tensor:
    """Elements ``idx`` (int64, any shape, each < ``numel``) of the flat
    draw ``uniform(key, (numel,))``, on ``idx``'s device."""
    if is_rbg(key):
        return rbg.uniform_at(key, idx)
    _check_size(numel)
    return _unit(_bits_at(key[0], key[1], idx, numel))


def uniform_keys(keys, numel: int, device) -> torch.Tensor:
    """The JAX package's ``jax.vmap(lambda k: uniform(k, (numel,)))(keys)``
    flattened.  Under threefry that is ``torch.cat([uniform(k, (numel,))
    for k in keys])``, drawn in one pass over a ``[len(keys), numel]``
    grid (``[len(keys), ceil(numel / 2)]`` pairs on the legacy stream;
    the key words reach the device as fills, so nothing is copied from
    the host).  Under rbg and unsafe_rbg it is the first key's draw of
    ``len(keys) * numel`` elements (ops/rbg.py)."""
    if is_rbg(keys[0]):
        return rbg.uniform(keys[0], len(keys) * numel, device)
    if len(keys) == 1:
        return uniform(keys[0], (numel,), device)
    _check_size(numel)

    def column(word):
        return torch.stack([torch.full((), k[word], dtype=torch.int64,
                                       device=device) for k in keys])[:, None]

    if not _PARTITIONABLE:
        return _unit(_legacy_rows(column(0), column(1), len(keys), numel,
                                  device)).reshape(-1)
    lo = torch.arange(numel, dtype=torch.int64, device=device)[None, :]
    return _unit(_bits_at(column(0), column(1), lo, numel)).reshape(-1)


def uniform_each(keys, numel: int, device) -> torch.Tensor:
    """``torch.cat([uniform(k, (numel,)) for k in keys])``: each key's own
    draw, as each shard draws inside the JAX package's ``shard_map``
    (under threefry one pass, :func:`uniform_keys`)."""
    if is_rbg(keys[0]):
        return torch.cat([rbg.uniform(k, numel, device) for k in keys])
    return uniform_keys(keys, numel, device)


def bits_keys(keys, numel: int, device) -> torch.Tensor:
    """The JAX package's ``jax.vmap(lambda k: bits(k, (numel,)))(keys)``
    flattened: each key's bits under threefry, the first key's draw of
    ``len(keys) * numel`` under rbg and unsafe_rbg."""
    if is_rbg(keys[0]):
        return rbg.bits(keys[0], len(keys) * numel, device)
    return torch.cat([random_bits(k, numel, device) for k in keys])


def randint(key: Key, shape, minval: int, maxval: int, device) -> torch.Tensor:
    """``jax.random.randint`` into int32 for ``0 <= minval < maxval <
    2^31``: two 32-bit draws combined modulo the span, with the
    multiplier ``(2^16 % span)^2 % span`` taken in u32 arithmetic (it
    wraps for spans above 2^16, as JAX's does)."""
    _check_range(minval, maxval)
    k_hi, k_lo = split(key, 2)
    numel = math.prod(shape)
    hi = random_bits(k_hi, numel, device)
    lo = random_bits(k_lo, numel, device)
    return _span_draw(hi, lo, minval, maxval).reshape(shape)


def randint_keys(keys, shape, minval: int, maxval: int, device) -> list:
    """The JAX package's ``jax.vmap(lambda k: randint(k, shape, minval,
    maxval))(keys)``, one int32 tensor per key: the vmapped split, then
    two vmapped bit draws (:func:`split_keys`, :func:`bits_keys`)."""
    _check_range(minval, maxval)
    halves = split_keys(keys, 2)
    numel = math.prod(shape)
    hi = bits_keys([h[0] for h in halves], numel, device)
    lo = bits_keys([h[1] for h in halves], numel, device)
    return list(_span_draw(hi, lo, minval, maxval).view(
        (len(keys),) + tuple(shape)).unbind(0))


def _check_range(minval: int, maxval: int) -> None:
    if not 0 <= minval < maxval < 1 << 31:
        raise ValueError(f"randint range [{minval}, {maxval}) unsupported")


def _span_draw(hi, lo, minval: int, maxval: int) -> torch.Tensor:
    """randint's combination of its two bit draws, flat int32."""
    span = maxval - minval
    mult = (1 << 16) % span
    mult = ((mult * mult) & M32) % span
    off = (((hi % span) * mult) & M32) + lo % span
    off = (off & M32) % span
    return (off + minval).to(torch.int32)
