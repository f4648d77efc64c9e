"""K2 and K4: circulant gossip delivery (counterpart of the JAX package's
``ops/fused_gossip.py``).

Per shift ``r_j`` sender row ``i`` gossips to row ``(i + r_j) mod N``;
the slot map is affine, so the sender's row lands on the receiver's
coordinates rotated by ``r_j * STRIDE mod S`` columns (by ``(r_j - N) *
STRIDE mod S`` for wrapped receiver rows ``i < r_j`` when ``(N * STRIDE)
% S != 0``).  Delivery max-combines every shift into the mailbox.

* :func:`gossip_plain` -- the plain version: the JAX step's
  ``deliver_shift`` loop (tpu_hash.py:155, :1097-1148), with the rolls by
  a device shift written as index arithmetic (no host sync).
* :func:`gossip_fused` -- the wrapper: the CUDA kernel
  ``csrc/gossip.cu`` for CUDA tensors (mail updated in place), the plain
  version for CPU ones.

Two operand forms, as in the JAX package: ``k_eff [N]`` (shift ``j``
delivers sender rows with ``j < k_eff``; payload pre-masked), or
``masks [k_max, N, S]`` bool per-shift keep masks, sender-indexed, which
subsume the fanout gate (used under drops; the payload is the unmasked
view).

K4 is the sharded ring step's local delivery (JAX
``gossip_fused_stacked``): :func:`gossip_stacked_plain` and the wrapper
:func:`gossip_fused_stacked` (CUDA kernel ``csrc/gossip_stacked.cu``)
take K payloads that already crossed shards, and per shift roll them by
``c_j`` rows within each shard and align their columns by that shard's
``s1``/``s2``.  One call covers every shard of a LocalMesh
(parallel/mesh.py); for one shard it is exactly the JAX call.
"""

from __future__ import annotations

import torch

from distributed_membership_tpu_torch import kernels
from distributed_membership_tpu_torch.ops.view_merge import STRIDE, umax

# The widest row the tiled body takes: one row per 16 KiB tile
# (csrc/gossip_tile.cuh).  Wider rows take the wide-row body.
MAX_TILE_S = 4096


def wide_form(s: int) -> bool:
    """Whether K2/K4 run their wide-row body (rows wider than a tile)."""
    return s > MAX_TILE_S


def _require_tiles(name: str, *planes) -> None:
    """What K2 and K4 take on CUDA (csrc/gossip_tile.cuh): rows of any
    width (the tiled body up to MAX_TILE_S slots, the wide-row body past
    it), fewer than 2^31 rows, and planes the bulk copies can address
    (16-byte aligned bases; spans inside them are widened to bounds)."""
    kernels.require(planes[0].shape[0] < 2**31,
                    f"{name}: the CUDA kernel takes fewer than 2^31 rows")
    kernels.require(all(p.data_ptr() % 16 == 0 for p in planes
                        if p is not None),
                    f"{name}: mail, payload and masks must be 16-byte "
                    "aligned")


def gossip_plain(n: int, s: int, k_max: int, mail, payload, k_eff, shifts,
                 masks=None):
    dev = mail.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    cols = torch.arange(s, dtype=torch.int64, device=dev)
    cstride = STRIDE % s
    out = mail
    for j in range(k_max):
        r = shifts[j].to(torch.int64)
        src = (rows - r) % n
        send = payload.index_select(0, src)
        keep = (masks[j].index_select(0, src) if masks is not None
                else (j < k_eff.index_select(0, src))[:, None])
        send = torch.where(keep, send, 0)
        s1 = ((r % s) * cstride) % s
        delivered = send.index_select(1, (cols - s1) % s)
        if (n * STRIDE) % s != 0:
            s2 = ((r - n) % s) * cstride % s
            wrapped = send.index_select(1, (cols - s2) % s)
            delivered = torch.where((rows >= r)[:, None], delivered, wrapped)
        out = umax(out, delivered)
    return out


def gossip_fused(n: int, s: int, k_max: int, mail, payload, k_eff, shifts,
                 masks=None):
    """K2 wrapper.  ``mail``/``payload`` int32 u32-bit ``[N, S]``,
    ``k_eff`` int32 ``[N]`` (ignored when ``masks`` is given), ``shifts``
    int32 ``[k_max]`` on the device (the ring draws ``[1, N)``; any int32
    shift gives the plain version's result), ``masks`` bool ``[k_max, N,
    S]``.  The CUDA kernel ``csrc/gossip.cu`` takes any ``S`` and 16-byte
    aligned planes (its wide-row body past ``MAX_TILE_S``)."""
    req = kernels.require
    dev = mail.device
    req(all(p.shape == (n, s) and p.dtype == torch.int32
            and p.is_contiguous() and p.device == dev
            for p in (mail, payload)),
        f"gossip: mail/payload must be contiguous int32 [{n}, {s}]")
    req(shifts.shape == (k_max,) and shifts.dtype == torch.int32
        and shifts.device == dev and shifts.is_contiguous(),
        f"gossip: shifts must be contiguous int32 [{k_max}]")
    if masks is None:
        req(k_eff.shape == (n,) and k_eff.dtype == torch.int32
            and k_eff.device == dev and k_eff.is_contiguous(),
            f"gossip: k_eff must be contiguous int32 [{n}]")
    else:
        req(masks.shape == (k_max, n, s) and masks.dtype == torch.bool
            and masks.device == dev and masks.is_contiguous(),
            f"gossip: masks must be contiguous bool [{k_max}, {n}, {s}]")
    if not mail.is_cuda:
        return gossip_plain(n, s, k_max, mail, payload, k_eff, shifts, masks)
    _require_tiles("gossip", mail, payload, masks)
    if k_max == 0:
        return mail
    p = kernels.ptr
    rc = kernels.library("gossip").dm_gossip(
        n, s, k_max, STRIDE % s, int((n * STRIDE) % s == 0), p(mail),
        p(payload), None if masks is not None else p(k_eff), p(masks),
        p(shifts), kernels.stream_of(mail))
    kernels.check(rc, "gossip")
    kernels.LAUNCHES[("gossip_wide" if wide_form(s) else "gossip")
                     + ("_masks" if masks is not None else "")] += 1
    return mail


def gossip_stacked_plain(n_local: int, s: int, k_max: int, single_col: bool,
                         mail, payloads, c, s1, s2, masks=None):
    """K4's plain version: the JAX sharded step's per-shift loop
    (tpu_hash_sharded.py:711-718) on every shard of the flat layout.  For
    shift ``j``, the payload (``payloads[j]``, or the shared
    ``payloads[0]`` gated by ``masks[j]``) is rolled by ``c[j]`` rows
    within each shard and by ``s1[d, j]`` columns on shard ``d`` (by
    ``s2[d, j]`` on the shard's rows ``l < c[j]`` unless ``single_col``),
    and maxed into mail."""
    rows = mail.shape[0]
    d = rows // n_local
    dev = mail.device
    local = torch.arange(n_local, dtype=torch.int64, device=dev)
    cols = torch.arange(s, dtype=torch.int64, device=dev)
    out = mail
    for j in range(k_max):
        send = payloads[0 if payloads.shape[0] == 1 else j]
        if masks is not None:
            send = torch.where(masks[j], send, 0)
        cj = c[j].to(torch.int64)
        rolled = send.view(d, n_local, s).index_select(1, (local - cj)
                                                       % n_local)

        def align(shift):
            src = (cols[None, :] - shift[:, j].to(torch.int64)[:, None]) % s
            return rolled.gather(2, src[:, None, :].expand(d, n_local, s))

        delivered = align(s1)
        if not single_col:
            delivered = torch.where((local >= cj)[None, :, None], delivered,
                                    align(s2))
        out = umax(out, delivered.reshape(rows, s))
    return out


def gossip_fused_stacked(n_local: int, s: int, k_max: int, single_col: bool,
                         mail, payloads, c, s1, s2, masks=None):
    """K4 wrapper.  ``mail`` int32 u32-bit ``[N, S]`` holding ``D = N //
    n_local`` shards; ``payloads`` ``[k_max, N, S]`` pre-masked and already
    block-routed, or ``[1, N, S]`` shared by every shift; ``masks`` bool
    ``[k_max, N, S]`` sender-indexed keep masks or None; ``c`` int32
    ``[k_max]`` row shifts (the step passes ``[0, n_local)``; any int32
    gives the plain version's result); ``s1``/``s2`` int32 ``[D, k_max]``
    per-shard column shifts (``s2`` unused when ``single_col``).  The
    CUDA kernel ``csrc/gossip_stacked.cu`` for CUDA tensors (mail updated
    in place; any ``S`` and shard size, 16-byte aligned planes; the
    wide-row body past ``MAX_TILE_S``),
    :func:`gossip_stacked_plain` for CPU ones."""
    req = kernels.require
    dev = mail.device
    rows = mail.shape[0]
    req(n_local > 0 and rows % n_local == 0,
        f"gossip_stacked: mail rows ({rows}) must be a multiple of "
        f"n_local ({n_local})")
    d = rows // n_local
    req(mail.shape == (rows, s) and mail.dtype == torch.int32
        and mail.is_contiguous(),
        f"gossip_stacked: mail must be contiguous int32 [{rows}, {s}]")
    req(payloads.shape in ((k_max, rows, s), (1, rows, s))
        and payloads.dtype == torch.int32 and payloads.device == dev
        and payloads.is_contiguous(),
        f"gossip_stacked: payloads must be contiguous int32 "
        f"[{k_max} or 1, {rows}, {s}]")
    req(c.shape == (k_max,) and c.dtype == torch.int32 and c.device == dev
        and c.is_contiguous(),
        f"gossip_stacked: c must be contiguous int32 [{k_max}]")
    req(all(v.shape == (d, k_max) and v.dtype == torch.int32
            and v.device == dev and v.is_contiguous() for v in (s1, s2)),
        f"gossip_stacked: s1/s2 must be contiguous int32 [{d}, {k_max}]")
    if masks is not None:
        req(masks.shape == (k_max, rows, s) and masks.dtype == torch.bool
            and masks.device == dev and masks.is_contiguous(),
            f"gossip_stacked: masks must be contiguous bool "
            f"[{k_max}, {rows}, {s}]")
    if not mail.is_cuda:
        return gossip_stacked_plain(n_local, s, k_max, single_col, mail,
                                    payloads, c, s1, s2, masks)
    _require_tiles("gossip_stacked", mail, payloads, masks)
    if k_max == 0:
        return mail
    p = kernels.ptr
    rc = kernels.library("gossip_stacked").dm_gossip_stacked(
        rows, s, n_local, k_max, int(single_col), int(payloads.shape[0] == 1),
        p(mail), p(payloads), p(masks), p(c), p(s1), p(s2),
        kernels.stream_of(mail))
    kernels.check(rc, "gossip_stacked")
    kernels.LAUNCHES[("gossip_stacked_wide" if wide_form(s)
                      else "gossip_stacked")
                     + ("_masks" if masks is not None else "")] += 1
    return mail
