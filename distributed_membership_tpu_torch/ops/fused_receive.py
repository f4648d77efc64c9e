"""K1: the ring step's receive pass (counterpart of the JAX package's
``ops/fused_receive.py``).

* :func:`receive_core` -- the plain PyTorch version, op for op the JAX
  ``_receive_body`` (its elementwise part, :func:`receive_planes`, is
  also K5's plain version): sticky admission of mail, the occupant-matched
  strict-increase ack refresh, the double-heartbeat self refresh
  (MP1Node.cpp:412-415) and the TFAIL/TREMOVE sweep (MP1Node.cpp:429-446).
* :func:`receive_fused` -- the wrapper: the CUDA kernel
  ``csrc/receive.cu`` for CUDA tensors (any ``S``: tiles of the flattened
  planes, read by 16-byte loads), the plain version for CPU ones.

Both take the JAX kernel's optional ``admit_mask`` (``[rows, S]``, 0 =
suppress): a slot whose entry is 0 treats its delivered mail as not
delivered this tick, so it neither admits nor refreshes, while the
mailbox still clears where the row receives.  No ring step passes it, in
either package; the CUDA kernel runs it as a second instantiation
(counted as ``receive_admit``).

Packed planes are int32 tensors holding u32 bits (ops/view_merge.py).
The kernel updates ``view``, ``view_ts`` and ``mail`` in place and
returns them; the plain version returns new tensors.  Callers treat the
three inputs as consumed either way.
"""

from __future__ import annotations

import torch

from distributed_membership_tpu_torch import kernels
from distributed_membership_tpu_torch.ops.view_merge import (
    EMPTY, M32, as_u32, to_bits)


def receive_planes(n: int, s: int, tfail: int, tremove: int, stride: int,
                   t: int, view, view_ts, mail, cand, recv_mask, act,
                   self_on, self_pack, row0: int = 0, admit_mask=None):
    """The elementwise pass on an ``[rows, S]`` plane (``row0`` is the
    first row's global node id; ``admit_mask``, nonzero = admit, gates
    the delivered mail).  Returns ``(view, view_ts, mail_cleared,
    join_mask, rm_ids, stale)`` with ``stale`` the pre-remove TFAIL mask;
    the natural and the folded receive (ops/fused_folded.py) reduce it
    their own way."""
    rows = view.shape[0]
    dev = view.device
    node = row0 + torch.arange(rows, dtype=torch.int64, device=dev)
    col = torch.arange(s, dtype=torch.int64, device=dev)[None, :]
    self_slot = ((node % s) * ((1 + stride) % s)) % s
    self_mask = col == self_slot[:, None]
    rcol = recv_mask[:, None]

    v = as_u32(view)
    m = as_u32(mail)
    if admit_mask is not None:
        m = torch.where(admit_mask != 0, m, 0)
    c = as_u32(cand)
    prev_present = v > 0
    # --- admit gossip mail (sticky admission) ---
    in_id = ((m - 1) & M32) % n
    matches = in_id == ((v - 1) & M32) % n
    ok = ((self_mask & (in_id == node[:, None]))
          | (~self_mask & (~prev_present | matches)))
    take = (m > 0) & ok
    new_v = torch.where(rcol & take, torch.maximum(v, m), v)
    changed = new_v > v
    new_ts = torch.where(changed, t, view_ts)
    join_mask = changed & ~prev_present
    mail_cleared = torch.where(rcol, 0, mail)

    # --- ack application: occupant-matched strict-increase refresh ---
    match = ((c > 0) & (new_v > 0)
             & (((c - 1) & M32) % n == ((new_v - 1) & M32) % n) & rcol)
    upd = match & (c > new_v)
    new_v = torch.where(upd, c, new_v)
    new_ts = torch.where(upd, t, new_ts)

    # --- self refresh (the caller packs the entry) ---
    s_on = self_mask & self_on[:, None]
    new_v = torch.where(s_on, as_u32(self_pack)[:, None], new_v)
    new_ts = torch.where(s_on, t, new_ts)

    # --- TFAIL / TREMOVE sweep ---
    present = new_v > 0
    difft = t - new_ts
    stale = present & (difft >= tfail) & act[:, None]
    removes = stale & (difft >= tremove)
    rm_ids = torch.where(removes, ((new_v - 1) & M32) % n,
                         EMPTY).to(torch.int32)
    new_v = torch.where(removes, 0, new_v)
    return (to_bits(new_v), new_ts.to(torch.int32), mail_cleared,
            join_mask, rm_ids, stale)


def receive_core(n: int, s: int, tfail: int, tremove: int, stride: int,
                 t: int, view, view_ts, mail, cand, recv_mask, act,
                 self_on, self_pack, row0: int = 0, admit_mask=None):
    """Plain version.  ``view``/``mail``/``cand``/``self_pack`` are int32
    u32-bit planes, ``view_ts`` int32, the masks bool ``[rows]``; ``row0``
    is the first row's global node id; ``admit_mask`` an optional
    ``[rows, S]`` plane (nonzero = admit).  Returns ``(view, view_ts,
    mail_cleared, join_mask, rm_ids, numfailed, size)``."""
    view, view_ts, mail_cleared, join_mask, rm_ids, stale = receive_planes(
        n, s, tfail, tremove, stride, t, view, view_ts, mail, cand,
        recv_mask, act, self_on, self_pack, row0, admit_mask)
    return (view, view_ts, mail_cleared, join_mask, rm_ids,
            stale.sum(1, dtype=torch.int32),
            (view != 0).sum(1, dtype=torch.int32))


def receive_fused(n: int, s: int, tfail: int, tremove: int, stride: int,
                  t: int, view, view_ts, mail, cand, recv_mask, act,
                  self_on, self_pack, row0: int = 0, admit_mask=None):
    """K1 wrapper: the CUDA kernel for CUDA tensors (in place on
    ``view``/``view_ts``/``mail``), :func:`receive_core` for CPU ones.
    ``admit_mask``, where given, is an int32 ``[rows, S]`` plane."""
    rows = view.shape[0]
    planes = (view, view_ts, mail, cand) + (
        () if admit_mask is None else (admit_mask,))
    vecs = (recv_mask, act, self_on, self_pack)
    req = kernels.require
    req(all(p.shape == (rows, s) and p.dtype == torch.int32
            and p.is_contiguous() and p.device == view.device
            for p in planes), "receive: planes must be contiguous int32 "
                              f"[{rows}, {s}] on one device")
    req(all(v.shape == (rows,) and v.is_contiguous()
            and v.device == view.device for v in vecs)
        and recv_mask.dtype == act.dtype == self_on.dtype == torch.bool
        and self_pack.dtype == torch.int32,
        "receive: row vectors must be contiguous [rows] (bool masks, "
        "int32 self_pack) on the planes' device")
    if not view.is_cuda:
        return receive_core(n, s, tfail, tremove, stride, t, view, view_ts,
                            mail, cand, recv_mask, act, self_on, self_pack,
                            row0, admit_mask)
    req(all(p.data_ptr() % 4 == 0 for p in planes + (self_pack,)),
        "receive kernel: int32 planes must be 4-byte aligned")
    dev = view.device
    join = torch.empty((rows, s), dtype=torch.bool, device=dev)
    rm_ids = torch.empty((rows, s), dtype=torch.int32, device=dev)
    numfailed = torch.empty((rows,), dtype=torch.int32, device=dev)
    size = torch.empty((rows,), dtype=torch.int32, device=dev)
    p = kernels.ptr
    rc = kernels.library("receive").dm_receive(
        t, n, s, tfail, tremove, stride, row0, rows, p(view), p(view_ts),
        p(mail), p(cand), p(recv_mask), p(act), p(self_on), p(self_pack),
        p(join), p(rm_ids), p(numfailed), p(size), p(admit_mask),
        kernels.stream_of(view))
    kernels.check(rc, "receive")
    kernels.LAUNCHES["receive" if admit_mask is None
                     else "receive_admit"] += 1
    return view, view_ts, mail, join, rm_ids, numfailed, size
