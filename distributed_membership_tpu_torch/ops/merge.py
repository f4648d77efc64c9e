"""Gossip delivery as heartbeat-max propagation (the JAX package's
``ops/merge.py``), for the dense ``tpu`` and ``tpu_sharded`` steps.

The reference's LIST burst -- one message per live member-list entry,
per target, per tick (MP1Node.cpp:360-395) -- merges at the receiver by
keeping the max heartbeat per entry (MP1Node.cpp:259-301), a combine that
ignores the order of the messages.  So a tick's delivery is

    contrib[r, e] = max over senders s targeting r of hb[s, e]

max-combined into the receiver's in-flight buffer.  Each (sender,
receiver, entry) triple is still one message: the sent/received counts
and the per-message Bernoulli drops (EmulNet.cpp:92) are the
reference's.  Every max and count is an integer reduction, so the
results are exact on any device and in any order.

The random streams are the JAX functions': ``fanout_deliver`` splits its
key into one key per sender chunk of ``_chunk_size`` senders, so the
chunking is part of the stream and is kept as it is.
"""

from __future__ import annotations

import torch

from distributed_membership_tpu_torch.ops.threefry import (
    Key, bernoulli, split)

I32 = torch.int32
I64 = torch.int64


def _chunk_size(n: int, budget_elems: int = 1 << 22) -> int:
    """Largest divisor of n such that chunk*n*n stays within budget."""
    per_sender = max(n * n, 1)
    target = max(budget_elems // per_sender, 1)
    best = 1
    for c in range(1, n + 1):
        if n % c == 0 and c <= target:
            best = c
    return best


def fanout_deliver(key: Key, target_mask: torch.Tensor,
                   send_hb: torch.Tensor, drop_active: bool,
                   drop_prob: float):
    """One tick of gossip from the dense ``[S, R]`` target mask (the
    executable spec of :func:`fanout_deliver_indexed`).

    ``send_hb`` is ``[S, E]`` int32, -1 where the entry is absent or
    withheld; ``drop_active`` (a host bool) says whether the drop window
    is open, ``drop_prob`` is the effective ``int(p*100)/100``.  Returns
    ``(contrib [R, E], sent [S], recv_add [R])``: the max heartbeat
    arriving per (receiver, entry) (-1 none), the messages accepted from
    each sender after the drops, and the messages in flight to each
    receiver."""
    s, r = target_mask.shape
    e = send_hb.shape[1]
    c = _chunk_size(s)
    n_chunks = s // c
    keys = split(key, n_chunks)
    dev = send_hb.device
    contrib = torch.full((r, e), -1, dtype=I32, device=dev)
    recv_add = torch.zeros((r,), dtype=I32, device=dev)
    sent = []
    for i in range(n_chunks):
        tm_c = target_mask[i * c:(i + 1) * c]
        sh_c = send_hb[i * c:(i + 1) * c]
        mask = tm_c[:, :, None] & (sh_c >= 0)[:, None, :]        # [c, R, E]
        if drop_prob > 0.0 and drop_active:
            mask = mask & ~bernoulli(keys[i], drop_prob, (c, r, e), dev)
        vals = torch.where(mask, sh_c[:, None, :], -1)
        contrib = torch.maximum(contrib, vals.amax(0))
        recv_add = recv_add + mask.sum((0, 2), dtype=I32)
        sent.append(mask.sum((1, 2), dtype=I32))
    return contrib, torch.cat(sent), recv_add


def fanout_deliver_indexed(key: Key, targets: torch.Tensor,
                           valid: torch.Tensor, send_hb: torch.Tensor,
                           n_receivers: int, drop_active: bool,
                           drop_prob: float, drop=None):
    """Scatter-max gossip delivery with targets in index form (the
    production path): the same messages as :func:`fanout_deliver` for the
    same target sets, in O(S * K * E).

    ``targets``/``valid`` are ``[S, K]``; the drop coin is one per
    (sender, slot, entry), ``bernoulli(key, p, (S, K, E))``, unless
    ``drop`` (the ``[S, K, E]`` dropped mask, the sharded step's per-shard
    draws) is given.  Invalid slots go to a scrap receiver row R, which
    is dropped: the jax ``.at[tgt].max(..., mode="drop")`` is a
    ``scatter_reduce_("amax")`` into R + 1 rows (its row index broadcast
    along E, not copied), and ``.at[tgt].add`` an ``index_add_``.  Returns ``(contrib [R, E], sent [S], recv_add
    [R])``."""
    s, k = targets.shape
    e = send_hb.shape[1]
    dev = send_hb.device
    msg = valid[:, :, None] & (send_hb >= 0)[:, None, :]          # [S, K, E]
    if drop is not None:
        msg = msg & ~drop
    elif drop_prob > 0.0 and drop_active:
        msg = msg & ~bernoulli(key, drop_prob, (s, k, e), dev)
    tgt = torch.where(valid, targets.to(I64), n_receivers).reshape(s * k)
    contrib = torch.full((n_receivers + 1, e), -1, dtype=I32, device=dev)
    contrib.scatter_reduce_(
        0, tgt[:, None].expand(s * k, e),
        torch.where(msg, send_hb[:, None, :], -1).reshape(s * k, e), "amax")
    counts = msg.sum(2, dtype=I32)
    recv_add = torch.zeros((n_receivers + 1,), dtype=I32, device=dev)
    recv_add.index_add_(0, tgt, counts.reshape(s * k))
    return contrib[:n_receivers], counts.sum(1, dtype=I32), \
        recv_add[:n_receivers]


def broadcast_deliver(key: Key, recipients: torch.Tensor,
                      send_hb: torch.Tensor, drop_active: bool,
                      drop_prob: float):
    """One sender's live list to a set of recipients (the introducer's
    burst to this tick's joiners, MP1Node.cpp:240-242,454, which FANOUT
    does not bound).  ``recipients`` is ``[R]`` bool, ``send_hb`` ``[E]``.
    Returns ``(contrib [R, E], sent [] int32, recv_add [R])``."""
    r = recipients.shape[0]
    e = send_hb.shape[0]
    msg = recipients[:, None] & (send_hb >= 0)[None, :]           # [R, E]
    if drop_prob > 0.0 and drop_active:
        msg = msg & ~bernoulli(key, drop_prob, (r, e), send_hb.device)
    contrib = torch.where(msg, send_hb[None, :], -1)
    return contrib, msg.sum(dtype=I32), msg.sum(1, dtype=I32)
