"""T-tick blocks and the shrunk block carry (counterpart of the JAX
package's ``ops/megakernel.py``).

``MEGA_TICKS: T`` (config.py) runs a segment's ticks in blocks of T:
:func:`mega_ticks` packs the carry at each block boundary and unpacks it
at the next block's start, and runs the ``L % T`` tail of a segment whose
length T does not divide as plain ticks after the blocks, exactly as the
JAX ``mega_scan`` restructures its ``lax.scan``.  ``T <= 1``, or a
segment no longer than T, is the plain tick loop.  On the card a block is
a Python loop of the same per-tick step, so every kernel still launches
once per tick; the block is the unit a CUDA graph would capture.

The codec (:func:`make_codec`) is the JAX one on the port's tensors: a
bool leaf is bit-packed 32 per u32 word (bit ``k`` of word ``w`` is
element ``32*w + k`` of the flat leaf, zero-padded), and under ``pack16``
the ``view_ts``/``self_hb`` leaves (tick and heartbeat values, -1 for
"never") travel as 16-bit lanes, ``value + 1``, two per u32 word (the
even element in the low half, an odd last dimension zero-padded).  Words
are int32 tensors holding the u32 bits (ops/view_merge.py), computed in
int64 so that no shift sign-extends.  Every other leaf passes as it is.
The round trip is exact whenever the values fit the 16-bit lanes, which
the static bound :func:`pack_fits` proves for the run's tick count.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from distributed_membership_tpu_torch.ops.view_merge import (
    M32, as_u32, to_bits)

I32 = torch.int32
I64 = torch.int64

# Heartbeats advance +2 per tick from 1 and view_ts holds tick values, so
# every packable value is <= 2 * total + 1; with the +1 offset a lane
# needs 2 * total + 2 < 2**16.  The margin keeps the bound conservative.
PACK_SAFE_TICKS = (1 << 15) - 16

# The int32 leaves that may travel as 16-bit lanes, by field name (the
# natural, folded and sharded states share these names).
_TS16_FIELDS = frozenset({"view_ts", "self_hb"})


def pack_fits(total_ticks: int) -> bool:
    """Does the 16-bit packed carry provably cover a run of this many
    ticks?"""
    return 0 <= int(total_ticks) <= PACK_SAFE_TICKS


def fits16(x) -> bool:
    """Do these values survive the u16 + 1 round trip?"""
    a = np.asarray(x).astype(np.int64)
    return bool(((a + 1 >= 0) & (a + 1 < (1 << 16))).all())


def named_leaves(state, prefix: str = "") -> list:
    """``(leaf name, tensor)`` of a ring-step carry in the JAX flatten
    order: a state's fields in order, a nested tuple's (the aggregate's,
    or the batched exchange's ``(state, xbuf)`` lane) inline as
    ``field.sub`` (a plain tuple's members named by position)."""
    items = (state._asdict().items() if hasattr(state, "_asdict")
             else ((str(i), x) for i, x in enumerate(state)))
    out = []
    for name, leaf in items:
        if isinstance(leaf, tuple):
            out.extend(named_leaves(leaf, f"{prefix}{name}."))
        else:
            out.append((prefix + name, leaf))
    return out


def rebuild_carry(template, leaves: list):
    """A carry of ``template``'s types from leaves in flatten order."""
    it = iter(leaves)

    def build(tpl):
        vals = [build(x) if isinstance(x, tuple) else next(it) for x in tpl]
        return type(tpl)(*vals) if hasattr(tpl, "_fields") else tuple(vals)
    return build(template)


def _pack_bits(a: torch.Tensor) -> torch.Tensor:
    flat = a.reshape(-1).to(I64)
    pad = (-flat.numel()) % 32
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    shifts = torch.arange(32, dtype=I64, device=a.device)
    return to_bits((flat.view(-1, 32) << shifts).sum(1))


def _unpack_bits(words: torch.Tensor, shape) -> torch.Tensor:
    size = int(np.prod(shape, dtype=np.int64))
    shifts = torch.arange(32, dtype=I64, device=words.device)
    bits = (as_u32(words)[:, None] >> shifts) & 1
    return bits.reshape(-1)[:size].to(torch.bool).reshape(shape)


def _pack_u16(a: torch.Tensor) -> torch.Tensor:
    u = (a.to(I64) + 1) & M32
    if u.shape[-1] % 2:
        u = torch.cat([u, u.new_zeros(u.shape[:-1] + (1,))], dim=-1)
    pair = u.reshape(u.shape[:-1] + (-1, 2))
    return to_bits(pair[..., 0] | ((pair[..., 1] << 16) & M32))


def _unpack_u16(words: torch.Tensor, shape) -> torch.Tensor:
    w = as_u32(words)
    u = torch.stack([w & 0xFFFF, w >> 16], dim=-1)
    u = u.reshape(words.shape[:-1] + (-1,))
    return (u[..., :shape[-1]] - 1).to(I32)


def _plan(state, pack16: bool) -> list:
    """``(kind, shape)`` per leaf: 'bits', 'u16' or 'raw'."""
    plan = []
    for name, leaf in named_leaves(state):
        shape = tuple(leaf.shape)
        if leaf.dtype == torch.bool:
            plan.append(("bits", shape))
        elif (pack16 and name.rsplit(".", 1)[-1] in _TS16_FIELDS
              and leaf.dtype == I32):
            plan.append(("u16", shape))
        else:
            plan.append(("raw", shape))
    return plan


def make_codec(state, pack16: bool):
    """``(pack, unpack)`` for states shaped like ``state``: ``pack(st)``
    is a tuple of tensors in flatten order, ``unpack`` rebuilds the
    state."""
    plan = _plan(state, pack16)

    def pack(st) -> tuple:
        out = []
        for (kind, _), (_, leaf) in zip(plan, named_leaves(st)):
            out.append(_pack_bits(leaf) if kind == "bits"
                       else _pack_u16(leaf) if kind == "u16" else leaf)
        return tuple(out)

    def unpack(packed):
        out = [_unpack_bits(leaf, shape) if kind == "bits"
               else _unpack_u16(leaf, shape) if kind == "u16" else leaf
               for (kind, shape), leaf in zip(plan, packed)]
        return rebuild_carry(state, out)

    return pack, unpack


def carry_bytes(state, pack16: bool = True) -> dict:
    """Bytes of the carry at a T-block boundary: ``full`` the wide carry,
    ``packed`` what the codec keeps."""
    full = packed = 0
    for (kind, shape), (_, leaf) in zip(_plan(state, pack16),
                                        named_leaves(state)):
        size = int(np.prod(shape, dtype=np.int64))
        nbytes = size * leaf.element_size()
        full += nbytes
        if kind == "bits":
            packed += 4 * (-(-size // 32))
        elif kind == "u16":
            last = shape[-1] if shape else 1
            packed += nbytes // last * (-(-last // 2))
        else:
            packed += nbytes
    return {"full": int(full), "packed": int(packed)}


def mega_ticks(tick: Callable, state, a: int, b: int, t_block: int,
               pack16: bool = False):
    """Run ``state = tick(state, t)`` for ``t`` in ``[a, b)`` in T-tick
    blocks (the JAX ``mega_scan``): the carry is packed at every block
    boundary and unpacked at the next block's start, and the ``(b - a) %
    T`` tail runs after the last block.  ``T <= 1`` or ``b - a <= T`` is
    the plain loop."""
    length, t = b - a, int(t_block)
    if t <= 1 or length <= t:
        for tt in range(a, b):
            state = tick(state, tt)
        return state
    nblk = length // t
    pack, unpack = make_codec(state, pack16)
    packed = pack(state)
    for blk in range(nblk):
        st = unpack(packed)
        for tt in range(a + blk * t, a + (blk + 1) * t):
            st = tick(st, tt)
        packed = pack(st)
    state = unpack(packed)
    for tt in range(a + nblk * t, b):
        state = tick(state, tt)
    return state
