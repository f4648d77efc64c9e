"""Packed view entries: the slot-map constants and u32 helpers.

A view or mailbox entry is the u32 ``hb * N + id + 1`` (0 = empty), as in
the JAX package.  CPU PyTorch has almost no u32 arithmetic, so the port
keeps every packed plane as an ``int32`` tensor holding the u32 bit
pattern (the CUDA kernels read the same bytes as ``uint32``) and widens
to ``int64`` wherever order or ``%`` matters.
"""

from __future__ import annotations

import torch

EMPTY = -1          # member id of a free slot
STRIDE = 7919       # odd prime per-node slot-map offset (JAX view_merge.py)
M32 = 0xFFFFFFFF
SIGN = -(1 << 31)   # int32 sign bit: x ^ SIGN orders u32 bits as int32


def as_u32(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 holding the unsigned value."""
    return bits.to(torch.int64) & M32


def to_bits(u: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 value (taken mod 2^32) -> int32 bit pattern."""
    return (((u & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def umax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned max of two int32 bit-pattern tensors (the signed max with
    the sign bit flipped around it)."""
    return torch.maximum(a ^ SIGN, b ^ SIGN) ^ SIGN


def member_of(bits: torch.Tensor, n: int) -> torch.Tensor:
    """``(packed - 1) % n`` in u32 arithmetic (0 - 1 wraps to 2^32 - 1),
    as int64."""
    return ((as_u32(bits) - 1) & M32) % n


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The JAX ``mix32`` (lowbias32-style finalizer) on int64 tensors
    holding u32 values; every product is taken mod 2^32."""
    x = x & M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & M32
    return x ^ (x >> 16)


def hash_slot(msg_id: torch.Tensor, salt: int, qsz: int,
              n_pad: int) -> torch.Tensor:
    """Per-receiver mailbox slot for a message about ``msg_id`` (int64,
    non-negative), as the JAX ``hash_slot``: ``(id + salt) % qsz`` when
    ``qsz >= n_pad`` (injective), else the :func:`mix32` of ``id + 0x9E3779B9
    * salt`` in u32 arithmetic, mod ``qsz``."""
    if qsz >= n_pad:
        return (msg_id + salt) % qsz
    salted = (msg_id + ((0x9E3779B9 * (salt & M32)) & M32)) & M32
    return mix32(salted) % qsz
