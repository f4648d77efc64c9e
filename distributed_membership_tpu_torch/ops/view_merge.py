"""Bounded member views: the sorted merge, the hashed mailboxes, and the
packed-entry helpers (the JAX package's ``ops/view_merge.py``).

A view or mailbox entry is the u32 ``hb * N + id + 1`` (0 = empty), as in
the JAX package.  CPU PyTorch has almost no u32 arithmetic, so the port
keeps every packed plane as an ``int32`` tensor holding the u32 bit
pattern (the CUDA kernels read the same bytes as ``uint32``) and widens
to ``int64`` wherever order or ``%`` matters.

:func:`merge_views` is the ``tpu_sparse`` receive: per member id the max
heartbeat wins, the timestamp refreshes only on a strict increase
(MP1Node.cpp:278-288), and when more ids survive than the view has slots
the node keeps its own entry, then the members it already had (freshest
heartbeat first), then new ones (highest heartbeat first).  The JAX
function orders each row with two ``lax.sort`` calls; the port takes
the same orders with stable sorts (see its docstring).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EMPTY = -1          # member id of a free slot
_ID_INF = 2**30     # sorts empty/invalid entries last
# Sink slots of a scatter: most messages of a mailbox scatter can be
# invalid (the ack plane has Qa entries a row, a few of them due), and
# sending them all to one sink address serialises the card's atomics.
SINKS = 1024
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


def unpack_mailbox(mail: torch.Tensor, n_pad: int):
    """``(id, hb, valid)`` of an ``[N, Q]`` packed mailbox (int32 bits),
    as the JAX ``unpack_mailbox``: id ``EMPTY`` and hb -1 where empty."""
    valid = mail != 0
    v = (as_u32(mail) - 1) & M32
    msg_id = torch.where(valid, v % n_pad, EMPTY).to(torch.int32)
    msg_hb = torch.where(valid, v // n_pad, -1).to(torch.int32)
    return msg_id, msg_hb, valid


def scatter_mailbox(mail: torch.Tensor, tgt: torch.Tensor,
                    msg_id: torch.Tensor, msg_hb: torch.Tensor,
                    msg_valid: torch.Tensor, n_pad: int,
                    salt: int = 0) -> torch.Tensor:
    """Max-combine messages into per-receiver hash-slotted mailboxes (the
    JAX ``scatter_mailbox``): message ``k`` packs to ``hb * n_pad + id +
    1`` in u32 arithmetic and lands at row ``tgt[k]``, slot
    ``hash_slot(id, salt)``; two ids in one slot keep the larger pack.
    ``mail`` is ``[N, Q]`` int32 bits; the jax ``.at[].max(mode="drop")``
    is :func:`scatter_umax`, the invalid messages going to its sinks.
    Requires ``max_hb * n_pad + n_pad < 2**32``
    (``Params.validate_sparse_packing``).  Returns a new plane."""
    n, qsz = mail.shape
    msg_id = msg_id.to(torch.int64)
    packed = ((msg_hb.to(torch.int64) & M32) * n_pad + (msg_id & M32)
              + 1) & M32
    addr = tgt.to(torch.int64) * qsz + hash_slot(msg_id, salt, qsz, n_pad)
    addr = torch.where(msg_valid.reshape(-1), addr.reshape(-1),
                       sink_spread(n * qsz, addr.numel(), mail.device))
    return scatter_umax(mail, addr, packed)


def sink_spread(base: int, count: int, device) -> torch.Tensor:
    """``count`` sink addresses ``base + (i mod SINKS)``: where a scatter
    sends its invalid entries, into ``SINKS`` slots past the real ones."""
    return base + (torch.arange(count, dtype=torch.int64, device=device)
                   & (SINKS - 1))


def scatter_umax(plane: torch.Tensor, addr: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """``plane`` (int32 u32 bits) max-combined with the u32 values ``val``
    (int64) at the flat addresses ``addr``; the addresses from
    ``plane.numel()`` on (``SINKS`` of them) are sinks, dropped.  The
    unsigned max is the signed one with the sign bit flipped around it
    (:func:`umax`).  Returns a new plane."""
    flat = torch.cat([(plane ^ SIGN).reshape(-1),
                      plane.new_full((SINKS,), SIGN)])
    flat.scatter_reduce_(0, addr.reshape(-1), to_bits(val).reshape(-1) ^ SIGN,
                         "amax")
    return flat[:plane.numel()].reshape(plane.shape) ^ SIGN


def count_at(tgt: torch.Tensor, valid: torch.Tensor, weight,
             n: int) -> torch.Tensor:
    """``[n]`` int32 per-target counts: ``weight`` (a scalar or a tensor
    of ``tgt``'s shape) added at each valid ``tgt`` (the jax
    ``.at[where(valid, tgt, n)].add(..., mode="drop")``; the invalid
    entries go to :func:`sink_spread`'s slots past ``n``)."""
    w = torch.as_tensor(weight, dtype=torch.int32, device=tgt.device).expand(
        tgt.shape)
    out = torch.zeros((n + SINKS,), dtype=torch.int32, device=tgt.device)
    out.index_add_(0, torch.where(
        valid.reshape(-1), tgt.to(torch.int64).reshape(-1),
        sink_spread(n, tgt.numel(), tgt.device)), w.reshape(-1))
    return out[:n]


class MergeResult(NamedTuple):
    slot_id: torch.Tensor    # [N, M] int32, EMPTY where free
    slot_hb: torch.Tensor    # [N, M] int32
    slot_ts: torch.Tensor    # [N, M] int32
    join_mask: torch.Tensor  # [N, M] bool: the id was not in the view


def _has_id(sorted_ids: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Row-batched membership test: is ``query[n, q]`` in the ascending
    row ``sorted_ids[n, :]``?  (``vmap(jnp.searchsorted)``, left side.)"""
    pos = torch.searchsorted(sorted_ids, query.contiguous())
    pos = pos.clamp(0, sorted_ids.shape[1] - 1)
    return sorted_ids.gather(1, pos) == query


def _sort_rows(key: torch.Tensor, *payload):
    """Stable ascending sort of each row by ``key``; the payload rows
    follow."""
    order = torch.sort(key, dim=1, stable=True).indices
    return (key.gather(1, order),) + tuple(x.gather(1, order)
                                           for x in payload)


def merge_views(slot_id, slot_hb, slot_ts, in_id, in_hb, in_valid,
                self_id, self_hb, self_on, t: int, apply_row) -> MergeResult:
    """Merge incoming entries and the self refresh into bounded views (the
    JAX ``merge_views``; see its docstring for the arguments, with ``t``
    a host int).

    Each row is the concatenation (local slots, incoming, self) with an
    origin rank (1, 2, 0).  The JAX function sorts it by ``(id, -hb,
    rank)`` with ``lax.sort(num_keys=3)``, keeps each id's head, and
    sorts again by ``(keep class, -hb)`` with ``num_keys=2`` to fill the
    ``M`` slots.  ``lax.sort`` is not stable unless asked, so the order of
    entries equal in every key is the one the port must reproduce:

    * in the first sort such entries are copies of one entry (an id
      arrives once per mailbox slot, views hold each id once, and warm
      views' duplicates carry hb 0 and ts 0 alike), so any order gives
      the same rows; the port sorts by ``(-hb, rank)`` and then, stably,
      by id;
    * in the second, entries of one class and heartbeat but different ids
      tie, and which of them fill the last slots decides the view.  The
      JAX sort on the CPU keeps their input order -- the id order the
      first sort left -- and the port's stable sort on the composite key
      ``class * 2^33 + (-hb + 2^31)`` does the same
      (tests/test_torch_sparse.py holds this on overflowing views).
    """
    n, m = slot_id.shape
    q = in_id.shape[1]
    dev = slot_id.device
    i32 = dict(dtype=torch.int32, device=dev)

    local_valid = slot_id != EMPTY
    sorted_local = torch.sort(torch.where(local_valid, slot_id, _ID_INF),
                              dim=1).values
    self_col = self_id.to(torch.int32)[:, None]
    ids = torch.cat([slot_id, in_id.to(torch.int32), self_col], dim=1)
    hbs = torch.cat([slot_hb, in_hb.to(torch.int32),
                     self_hb.to(torch.int32)[:, None]], dim=1)
    tss = torch.cat([slot_ts, torch.full((n, q + 1), t, **i32)], dim=1)
    valid = torch.cat([local_valid, in_valid, self_on[:, None]], dim=1)
    rank = torch.cat([torch.ones((n, m), **i32), torch.full((n, q), 2, **i32),
                      torch.zeros((n, 1), **i32)], dim=1)
    known = torch.cat([torch.ones((n, m), dtype=torch.bool, device=dev),
                       _has_id(sorted_local,
                               torch.cat([in_id.to(torch.int32), self_col],
                                         dim=1))], dim=1)

    id_key = torch.where(valid, ids, _ID_INF).to(torch.int64)
    neg_hb = torch.where(valid, -hbs.to(torch.int64), _ID_INF)
    _, id_key, ids, hbs, tss, known = _sort_rows(
        (neg_hb + 2**31) * 4 + rank, id_key, ids, hbs, tss, known)
    id_key, ids, hbs, tss, known = _sort_rows(id_key, ids, hbs, tss, known)

    winner = (id_key != _ID_INF) & torch.cat(
        [torch.ones((n, 1), dtype=torch.bool, device=dev),
         id_key[:, 1:] != id_key[:, :-1]], dim=1)
    # Retention class: 0 self, 1 existing member, 2 new member, 3 dropped.
    is_self = ids == self_col
    keep = torch.where(~winner, 3, torch.where(
        is_self, 0, torch.where(known, 1, 2))).to(torch.int64)
    join = winner & ~known
    neg_w = torch.where(winner, -hbs.to(torch.int64), _ID_INF)
    key2, ids, hbs, tss, join = _sort_rows(
        keep * 2**33 + neg_w + 2**31, ids, hbs, tss, join)
    kept = (key2[:, :m] >> 33) < 3

    ar = apply_row[:, None]
    new_id = torch.where(ar, torch.where(kept, ids[:, :m], EMPTY), slot_id)
    new_hb = torch.where(ar & kept, hbs[:, :m],
                         torch.where(ar, 0, slot_hb))
    new_ts = torch.where(ar & kept, tss[:, :m],
                         torch.where(ar, 0, slot_ts))
    return MergeResult(new_id.to(torch.int32), new_hb.to(torch.int32),
                       new_ts.to(torch.int32), ar & kept & join[:, :m])
