"""K2: circulant gossip delivery (counterpart of the JAX package's
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
"""

from __future__ import annotations

import torch

from distributed_membership_tpu_torch import kernels
from distributed_membership_tpu_torch.ops.view_merge import STRIDE, umax


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
    int32 ``[k_max]`` on the device, ``masks`` bool ``[k_max, N, S]``."""
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
    if k_max == 0:
        return mail
    p = kernels.ptr
    rc = kernels.library("gossip").dm_gossip(
        n, s, k_max, STRIDE % s, int((n * STRIDE) % s == 0), p(mail),
        p(payload), None if masks is not None else p(k_eff), p(masks),
        p(shifts), kernels.stream_of(mail))
    kernels.check(rc, "gossip")
    kernels.LAUNCHES["gossip" if masks is None else "gossip_masks"] += 1
    return mail
