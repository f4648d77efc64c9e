"""K5 and K6: the receive pass and gossip delivery on the folded layout
(counterpart of the JAX package's ``ops/fused_folded.py``).

For ``S < 128`` dividing 128 the ring state is stored folded: ``F = 128 //
S`` nodes share each ``[rows, 128]`` plane row, entry ``e`` belonging to
node ``row0 + e // S`` at slot ``e % S``.  That is the byte layout of the
natural ``[N, S]`` plane, so the plain versions here work on
``plane.view(-1, S)`` and reshape back.

* :func:`roll_nodes` / :func:`roll_slots` -- the folds of a node-axis and
  a slot-axis roll, written from those definitions (the JAX
  ``tpu_hash_folded`` functions of the same names).
* :func:`folded_receive_core` -- K5's plain version, op for op the JAX
  ``_folded_receive_body`` (the natural pass's elementwise body on the
  unfolded view); :func:`receive_folded_fused` -- its wrapper, the CUDA
  kernel ``csrc/receive_folded.cu`` for CUDA tensors.  Unlike the TPU
  kernel it takes ``recv``, ``act`` and ``self_val`` as per-node
  vectors, not as pre-broadcast planes.
* :func:`gossip_folded_plain` -- K6's plain version, the JAX folded
  step's per-shift ``roll_slots(roll_nodes(payload_j, thr_j), c_j)``
  loop on each shard of a mesh (K4's plain version on the natural view);
  :func:`gossip_folded_stacked` -- its wrapper, the CUDA kernel
  ``csrc/gossip_folded.cu`` (K4's tiled body, ``csrc/gossip_tile.cuh``,
  on D shards of ``n_local`` nodes, one launch for all of them) for CUDA
  tensors (mail updated in place).  One shard is the single-chip step's
  call; the JAX sharded folded step calls its kernel once per shard.
"""

from __future__ import annotations

import torch

from distributed_membership_tpu_torch import kernels
from distributed_membership_tpu_torch.ops.fused_gossip import (
    gossip_stacked_plain)
from distributed_membership_tpu_torch.ops.fused_receive import (
    receive_planes)

LANES = 128


def roll_nodes(x, r, f: int, s: int):
    """Fold of ``roll(unfolded, r, axis=0)``: node ``i`` takes node ``(i
    - r) mod N``'s slots.  ``r`` is an int or a device scalar (no host
    sync)."""
    n = x.shape[0] * f
    src = (torch.arange(n, dtype=torch.int64, device=x.device) - r) % n
    return x.view(n, s).index_select(0, src).view(x.shape)


def roll_slots(x, c, s: int):
    """Fold of ``roll(unfolded, c, axis=1)``: slot ``q`` of every node
    takes slot ``(q - c) mod S``."""
    cols = (torch.arange(s, dtype=torch.int64, device=x.device) - c) % s
    return x.reshape(-1, s).index_select(1, cols).view(x.shape)


def folded_receive_core(n: int, s: int, tfail: int, tremove: int,
                        stride: int, t: int, view, view_ts, mail, cand,
                        recv, act, self_val, row0: int = 0):
    """K5's plain version.  Planes are ``[rows, 128]`` (int32 u32 bits,
    ``view_ts`` int32); ``recv``/``act`` bool and ``self_val`` int32
    u32-bit vectors over the plane's ``rows * 128 // S`` nodes.  Returns
    ``(view, view_ts, mail_cleared, join_mask, rm_ids, stale)`` as
    planes."""
    shape = view.shape
    out = receive_planes(n, s, tfail, tremove, stride, t,
                         *(p.view(-1, s) for p in (view, view_ts, mail,
                                                   cand)),
                         recv, act, act, self_val, row0)
    return tuple(p.view(shape) for p in out)


def _check_planes(what, planes, rows, dev):
    kernels.require(all(p.shape == (rows, LANES) and p.dtype == torch.int32
                        and p.is_contiguous() and p.device == dev
                        for p in planes),
                    f"{what}: planes must be contiguous int32 "
                    f"[{rows}, {LANES}] on one device")


def receive_folded_fused(n: int, s: int, tfail: int, tremove: int,
                         stride: int, t: int, view, view_ts, mail, cand,
                         recv, act, self_val, row0: int = 0):
    """K5 wrapper: the CUDA kernel for CUDA tensors (in place on
    ``view``/``view_ts``/``mail``), :func:`folded_receive_core` for CPU
    ones."""
    req = kernels.require
    req(0 < s < LANES and LANES % s == 0,
        f"receive_folded: S must divide {LANES} (got {s})")
    rows = view.shape[0]
    nodes = rows * (LANES // s)
    dev = view.device
    planes = (view, view_ts, mail, cand)
    _check_planes("receive_folded", planes, rows, dev)
    req(all(v.shape == (nodes,) and v.is_contiguous() and v.device == dev
            for v in (recv, act, self_val))
        and recv.dtype == act.dtype == torch.bool
        and self_val.dtype == torch.int32,
        f"receive_folded: recv/act (bool) and self_val (int32) must be "
        f"contiguous [{nodes}] on the planes' device")
    if not view.is_cuda:
        return folded_receive_core(n, s, tfail, tremove, stride, t, view,
                                   view_ts, mail, cand, recv, act, self_val,
                                   row0)
    req(all(p.data_ptr() % 16 == 0 for p in planes),
        "receive_folded kernel reads 16-byte vectors: planes must be "
        "16-byte aligned")
    join = torch.empty((rows, LANES), dtype=torch.bool, device=dev)
    rm_ids = torch.empty((rows, LANES), dtype=torch.int32, device=dev)
    stale = torch.empty((rows, LANES), dtype=torch.bool, device=dev)
    p = kernels.ptr
    rc = kernels.library("receive_folded").dm_receive_folded(
        t, n, s, tfail, tremove, stride, row0, rows, p(view), p(view_ts),
        p(mail), p(cand), p(recv), p(act), p(self_val), p(join), p(rm_ids),
        p(stale), kernels.stream_of(view))
    kernels.check(rc, "receive_folded")
    kernels.LAUNCHES["receive_folded"] += 1
    return view, view_ts, mail, join, rm_ids, stale


def gossip_folded_plain(rows: int, s: int, k_max: int, single_col: bool,
                        mail, payloads, thr, c1, c2, masks=None,
                        n_local=None):
    """K6's plain version: the JAX folded step's per-shift
    ``roll_slots(roll_nodes(payload_j, thr_j), c_j)`` loop, on each of the
    ``D = rows * 128 / S / n_local`` shards of ``n_local`` nodes (all of
    them one shard when ``n_local`` is None).  Per shift ``j`` the payload
    (``payloads[j]``, or the shared ``payloads[0]`` gated by ``masks[j]``)
    is rolled by ``thr_j`` nodes within each shard and by ``c_j`` slots,
    ``c_j = c1[d, j]`` on shard ``d``'s nodes ``>= thr_j`` (or all of
    them, when ``single_col``) and ``c2[d, j]`` below, and maxed into
    mail.  The folded planes are the natural ``[N, S]`` bytes, so this is
    K4's plain version (ops/fused_gossip.py) on that view."""
    n = rows * (LANES // s)
    n_local = n if n_local is None else n_local
    flat = lambda x: x.view(x.shape[0], n, s)  # noqa: E731
    out = gossip_stacked_plain(
        n_local, s, k_max, single_col, mail.view(n, s), flat(payloads), thr,
        c1.view(-1, k_max), c2.view(-1, k_max),
        None if masks is None else flat(masks))
    return out.view(rows, LANES)


def gossip_folded_stacked(rows: int, s: int, k_max: int, single_col: bool,
                          mail, payloads, thr, c1, c2, masks=None,
                          n_local=None):
    """K6 wrapper.  ``mail`` int32 u32-bit ``[rows, 128]`` holding ``D``
    shards of ``n_local`` nodes (whole plane rows each; one shard of all
    ``rows * 128 / S`` nodes when ``n_local`` is None); ``payloads``
    ``[k_max, rows, 128]`` pre-masked (on a mesh, already block-routed),
    or ``[1, rows, 128]`` shared by every shift; ``masks`` bool ``[k_max,
    rows, 128]`` sender-indexed keep masks or None; ``thr`` int32
    ``[k_max]`` node shifts within a shard; ``c1``/``c2`` int32 ``[D,
    k_max]`` per-shard slot shifts (``[k_max]`` for one shard; ``c2``
    unread when ``single_col``).  All on one device; the CUDA kernel
    ``csrc/gossip_folded.cu`` for CUDA tensors (mail updated in place, all
    shards in one launch), :func:`gossip_folded_plain` for CPU ones."""
    req = kernels.require
    dev = mail.device
    req(0 < s < LANES and LANES % s == 0,
        f"gossip_folded: S must divide {LANES} (got {s})")
    _check_planes("gossip_folded", (mail,), rows, dev)
    nodes = rows * (LANES // s)
    n_local = nodes if n_local is None else n_local
    req(n_local > 0 and nodes % n_local == 0
        and (n_local * s) % LANES == 0,
        f"gossip_folded: n_local ({n_local}) must divide the {nodes} nodes "
        f"in whole plane rows (n_local * S % {LANES} == 0)")
    shards = nodes // n_local
    req(payloads.shape in ((k_max, rows, LANES), (1, rows, LANES))
        and payloads.dtype == torch.int32 and payloads.device == dev
        and payloads.is_contiguous(),
        f"gossip_folded: payloads must be contiguous int32 "
        f"[{k_max} or 1, {rows}, {LANES}]")
    req(thr.shape == (k_max,) and thr.dtype == torch.int32
        and thr.device == dev and thr.is_contiguous(),
        f"gossip_folded: thr must be contiguous int32 [{k_max}]")
    req(all(v.shape in ((shards, k_max),) + (((k_max,),) if shards == 1
                                              else ())
            and v.dtype == torch.int32 and v.device == dev
            and v.is_contiguous() for v in (c1, c2)),
        f"gossip_folded: c1/c2 must be contiguous int32 [{shards}, "
        f"{k_max}]")
    if masks is not None:
        req(masks.shape == (k_max, rows, LANES) and masks.dtype == torch.bool
            and masks.device == dev and masks.is_contiguous(),
            f"gossip_folded: masks must be contiguous bool "
            f"[{k_max}, {rows}, {LANES}]")
    if not mail.is_cuda:
        return gossip_folded_plain(rows, s, k_max, single_col, mail,
                                   payloads, thr, c1, c2, masks, n_local)
    req(nodes < 2**31
        and all(t.data_ptr() % 16 == 0 for t in (mail, payloads, masks)
                if t is not None),
        "gossip_folded: the CUDA kernel takes fewer than 2^31 nodes and "
        "16-byte aligned mail, payloads and masks")
    if k_max == 0:
        return mail
    p = kernels.ptr
    rc = kernels.library("gossip_folded").dm_gossip_folded(
        rows, s, n_local, k_max, int(single_col), int(payloads.shape[0] == 1),
        p(mail), p(payloads), p(masks), p(thr), p(c1), p(c2),
        kernels.stream_of(mail))
    kernels.check(rc, "gossip_folded")
    kernels.LAUNCHES["gossip_folded" if masks is None
                     else "gossip_folded_masks"] += 1
    return mail
