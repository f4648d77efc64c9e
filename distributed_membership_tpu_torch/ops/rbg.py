"""The ``rbg`` and ``unsafe_rbg`` keys of ``jax.random``, bit for bit.

``PRNG_IMPL: rbg|unsafe_rbg`` makes the JAX package draw through XLA's
``rng_bit_generator`` (algorithm DEFAULT) in place of threefry.  On the
CPU, the JAX package's reference platform, XLA compiles that op to
Philox4x32-10, so the stream is portable there.  This module ports the
two implementations of jax 0.9 (``jax/_src/prng.py``) that the port's
ring steps need; ``ops/threefry.py`` dispatches to it on the key's type,
so no call site has to know the implementation.

The stream.  A key is four u32 words ``w``.  ``rng_bit_generator(w,
shape)`` hashes, for block ``j``, the 128-bit counter whose low 64 bits
are ``(w2 | w3 << 32) + j`` (mod 2^64) and whose high 64 bits are ``(w0
| w1 << 32)`` plus the carry out of the low half, under the Philox key
``(w0, w1)``.  Block ``j``'s four output words are elements ``4j ..
4j+3`` of the flat draw, so a draw of any shape is the first ``numel``
words, row-major, and element ``i`` is word ``i % 4`` of block ``i //
4`` whatever the count: a draw may start at any element (``start``).

The keys.  Both implementations seed ``[0, s, 0, s]``.

* ``rbg``: ``split`` and ``fold_in`` run threefry on each two-word half
  (the stream in force, ``JAX_THREEFRY_PARTITIONABLE``, as
  ``ops/threefry.py``'s own ``split``).
* ``unsafe_rbg``: ``split(k, num)`` is rows 0, 10, 20, ... of
  ``rng_bit_generator(k, (10 * num, 4))``, so key ``i`` is block ``10 *
  i`` of ``k``'s stream; ``fold_in(k, d)`` is ``k`` XOR the last row of
  ``rng_bit_generator([0, d, 0, d], (10, 4))``, block 9 of the seed
  ``d``'s stream.

Draws under ``jax.vmap`` are not a loop's draws: XLA's batching rule
for ``rng_bit_generator`` draws the whole ``(batch, *shape)`` from the
batch's FIRST key and ignores the others.  So wherever the JAX package
vmaps a draw (its batched and hoisted RNG plans, ``plan_tensors``' tick
keys under ``unsafe_rbg``), the port draws from the first key:
``*_vmapped`` below and ``threefry.uniform_keys``.  Nested vmaps
flatten outer-major.  ``shard_map`` is not a vmap: each shard draws
from its own key.

Key derivation stays on the host in Python ints, as in
``ops/threefry.py``.  Bulk draws run on the requested device: on a CUDA
device through the kernel ``csrc/philox.cu`` (one launch a draw,
counted in ``kernels.LAUNCHES``: ``philox`` for float32 uniforms,
``philox_bits`` for u32 bits in int64, ``philox_at`` for uniforms at chosen
elements), on the CPU through the plain version in int64 tensor ops
(:func:`bits_plain`, :func:`uniform_plain`, :func:`uniform_at_plain`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from distributed_membership_tpu_torch import kernels
from distributed_membership_tpu_torch.ops import threefry

M32 = 0xFFFFFFFF
IMPLS = ("rbg", "unsafe_rbg")
_MUL = (0xD2511F53, 0xCD9E8D57)      # Philox4x32 round multipliers
_WEYL = (0x9E3779B9, 0xBB67AE85)     # key increments between rounds
_ROUNDS = 10


class RbgKey(NamedTuple):
    """A key of one of ``IMPLS``: its four u32 words (``jax.random.
    key_data``) and the implementation, which its ``split``/``fold_in``
    follow."""
    words: Tuple[int, int, int, int]
    impl: str


def seed(s: int, impl: str) -> RbgKey:
    """``jax.random.key(s, impl=impl)``: the words ``[0, s, 0, s]``
    (``s`` mod 2^32)."""
    if impl not in IMPLS:
        raise ValueError(f"PRNG implementation {impl!r} is not one of "
                         f"{IMPLS}")
    s = int(s) & M32
    return RbgKey((0, s, 0, s), impl)


def philox(words, block):
    """The four output words of Philox4x32-10 for ``block`` of the
    stream of ``words``: Python ints, or int64 tensors of blocks (each
    below 2^63).  On tensors the u32 x u32 products overflow int64 and
    wrap; ``(p >> 32) & M32`` and ``p & M32`` still give their true high
    and low words, since a wrap subtracts 2^64, a multiple of 2^32."""
    w0, w1, w2, w3 = words
    # The 128-bit counter (w1:w0:w3:w2) + block, in 32-bit limbs.
    c0 = w2 + (block & M32)
    c1 = w3 + (block >> 32) + (c0 >> 32)
    c2 = w0 + (c1 >> 32)
    c3 = (w1 + (c2 >> 32)) & M32
    c0, c1, c2 = c0 & M32, c1 & M32, c2 & M32
    k0, k1 = w0, w1
    for _ in range(_ROUNDS):
        p0 = c0 * _MUL[0]
        p1 = c2 * _MUL[1]
        c0, c1, c2, c3 = (((p1 >> 32) & M32) ^ c1 ^ k0, p1 & M32,
                          ((p0 >> 32) & M32) ^ c3 ^ k1, p0 & M32)
        k0, k1 = (k0 + _WEYL[0]) & M32, (k1 + _WEYL[1]) & M32
    return c0, c1, c2, c3


def split(key: RbgKey, num: int = 2) -> list:
    """``jax.random.split(key, num)`` under the key's implementation."""
    if key.impl == "rbg":
        lo = threefry.split(key.words[:2], num)
        hi = threefry.split(key.words[2:], num)
        return [RbgKey(a + b, key.impl) for a, b in zip(lo, hi)]
    return [RbgKey(philox(key.words, 10 * i), key.impl) for i in range(num)]


def split_vmapped(keys, num: int) -> list:
    """``jax.vmap(lambda k: jax.random.split(k, num))(keys)``, one list
    of ``num`` keys per key: under ``unsafe_rbg`` the first key's draw
    of ``(len(keys), 10 * num, 4)``, row ``b`` its ``b``-th slice."""
    if keys[0].impl == "rbg":
        return [split(k, num) for k in keys]
    first = keys[0].words
    return [[RbgKey(philox(first, 10 * (b * num + i)), keys[0].impl)
             for i in range(num)] for b in range(len(keys))]


def fold_in(key: RbgKey, data: int) -> RbgKey:
    """``jax.random.fold_in(key, data)`` under the key's implementation
    (``data`` mod 2^32)."""
    return fold_in_vmapped(key, data, data, 0)


def fold_in_vmapped(key: RbgKey, data: int, first: int, row: int
                    ) -> RbgKey:
    """Row ``row`` of ``jax.vmap(lambda d: jax.random.fold_in(key,
    d))(datas)``, where ``datas[0] == first`` and ``datas[row] ==
    data``: ``fold_in(key, data)`` under ``rbg`` (threefry per half),
    but under ``unsafe_rbg`` the vmapped seeds draw from ``first``'s
    seed alone, so row ``row`` XORs block ``10 * row + 9`` of it."""
    if key.impl == "rbg":
        lo = threefry.fold_in(key.words[:2], data)
        hi = threefry.fold_in(key.words[2:], data)
        return RbgKey(lo + hi, key.impl)
    d = int(first) & M32
    bits = philox((0, d, 0, d), 10 * row + 9)
    return RbgKey(tuple(a ^ b for a, b in zip(key.words, bits)), key.impl)


# ---- bulk draws: the plain versions -----------------------------------

def _blocks(words, first: int, count: int, device) -> torch.Tensor:
    """``[count, 4]`` int64 words of the blocks ``first ..``."""
    blk = first + torch.arange(count, dtype=torch.int64, device=device)
    return torch.stack(philox(words, blk), dim=1)


def bits_plain(key: RbgKey, numel: int, device, start: int = 0
               ) -> torch.Tensor:
    """Elements ``start .. start + numel`` of ``key``'s flat draw, as
    int64 holding u32 (``jax.random.bits`` flattened)."""
    skip = start % 4
    count = (skip + numel + 3) // 4
    flat = _blocks(key.words, start // 4, count, device).reshape(-1)
    return flat[skip:skip + numel]


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """u32 bits -> float32 on [0, 1), as ``jax.random.uniform``."""
    bits = bits.bitwise_right_shift(9).bitwise_or_(0x3F800000)
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform_plain(key: RbgKey, numel: int, device, start: int = 0
                  ) -> torch.Tensor:
    """Elements ``start .. start + numel`` of ``jax.random.uniform(key,
    (start + numel,))`` (float32)."""
    return _unit(bits_plain(key, numel, device, start))


def uniform_at_plain(key: RbgKey, idx: torch.Tensor) -> torch.Tensor:
    """Elements ``idx`` (int64, any shape, each >= 0) of ``key``'s flat
    uniform draw, on ``idx``'s device."""
    words = torch.stack(philox(key.words, idx >> 2), dim=-1)
    return _unit(words.gather(-1, (idx & 3).unsqueeze(-1)).squeeze(-1))


# ---- bulk draws: the wrappers ------------------------------------------

_FORMS = {"philox": 0, "philox_bits": 1, "philox_at": 2}


def _launch(form: str, key: RbgKey, out: torch.Tensor, numel: int,
            block0: int = 0, idx=None) -> None:
    """One launch of ``csrc/philox.cu`` writing ``numel`` elements of
    ``out`` (block ``block0`` on; or at ``idx``)."""
    lib = kernels.library("philox")
    rc = lib.dm_philox(_FORMS[form], *key.words, block0, numel,
                       kernels.ptr(idx), out.data_ptr(),
                       kernels.stream_of(out))
    kernels.check(rc, "philox")
    kernels.LAUNCHES[form] += 1


def _on_card(device) -> bool:
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"Philox draws run on cuda or cpu, not {kind}")
    return kind == "cuda"


def _flat(form: str, key: RbgKey, numel: int, device, start: int,
          dtype) -> torch.Tensor:
    """The kernel's flat draw of elements ``start .. start + numel``: it
    writes from word 0 of block ``start // 4`` into a fresh buffer (so
    its 16-byte stores stay aligned), of which this is a view."""
    skip = start % 4
    buf = torch.empty((skip + numel,), dtype=dtype, device=device)
    if numel:
        _launch(form, key, buf, skip + numel, start // 4)
    return buf[skip:]


def bits(key: RbgKey, numel: int, device, start: int = 0) -> torch.Tensor:
    """:func:`bits_plain` (int64 holding u32): the kernel's bits form on a
    CUDA device, which writes that layout itself."""
    if not _on_card(device):
        return bits_plain(key, numel, device, start)
    return _flat("philox_bits", key, numel, device, start, torch.int64)


def uniform(key: RbgKey, numel: int, device, start: int = 0
            ) -> torch.Tensor:
    """:func:`uniform_plain`: the kernel's float32 form on a CUDA
    device."""
    if not _on_card(device):
        return uniform_plain(key, numel, device, start)
    return _flat("philox", key, numel, device, start, torch.float32)


def uniform_at(key: RbgKey, idx: torch.Tensor) -> torch.Tensor:
    """:func:`uniform_at_plain`: the kernel's indexed form for a CUDA
    ``idx``."""
    kernels.require(idx.dtype == torch.int64,
                    "philox_at: indices must be int64")
    if not idx.is_cuda:
        return uniform_at_plain(key, idx)
    flat = idx.contiguous().reshape(-1)
    out = torch.empty(flat.shape, dtype=torch.float32, device=idx.device)
    if flat.numel():
        _launch("philox_at", key, out, flat.numel(), idx=flat)
    return out.view(idx.shape)
