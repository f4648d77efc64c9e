"""K3 and K7: the probe-window read plus aggregate partials, on the
natural and the folded layout (counterpart of the JAX package's
``ops/fused_probe.py``).

The window is the cyclic P-slot band of each row starting at ``ptr = (t
* P) mod S``; a slot yields a probe id if it is occupied, not the node
itself, and the observer is active.  Optional partials ride the same
pass: per-row staleness and suspicion bucket counts (``want_hist``) and
the FastAgg removal count and per-fail-id detection counts
(``want_agg``).  Drop coins stay outside, in ``[N, P]`` space.

* :func:`probe_plain` -- the plain version (the JAX ``_probe_body`` over
  a rolled window).
* :func:`probe_window_fused` -- the wrapper: the CUDA kernel
  ``csrc/probe.cu`` for CUDA tensors, the plain version for CPU ones.

Outputs (a dict): ``ids`` int32 ``[rows, P]`` (0 = no probe, else id +
1); with ``want_hist`` ``stale_rows``/``susp_rows`` int32 ``[rows, 8]``;
with ``want_agg`` ``rm_cnt`` int32 ``[rows]`` and ``det`` int32
``[F, rows]``.

* :func:`probe_folded_plain` / :func:`probe_folded_window_fused` -- K7,
  the same on ``[rows, 128]`` folded planes (ops/fused_folded.py), which
  hold ``nodes = rows * 128 // S`` nodes of S slots each, node-major.
  ``ids`` is int32 ``[nodes, P]``: position p of node i is slot ``(ptr +
  p) mod S`` of the node, validated as above; ``act`` is per node.  The
  partials are per plane row, except ``det_any``: bool ``[nodes]``, true
  where the node removed any failed id (present when there are failed
  ids).  The output dict has the JAX keys: ``ids``, ``rm_cnt`` and
  ``det_cols`` (int32 ``[rows, 1]`` each), ``det_any`` and, with
  ``want_hist``, ``stale_rows`` and ``susp_rows``.  The JAX kernel
  returns the whole rolled ``[rows, 128]`` id plane and ``det_any`` per
  slot, of which the folded step keeps the window and the per-node any;
  this contract is those.  The CUDA kernel is ``csrc/probe_folded.cu``.
"""

from __future__ import annotations

import torch

from distributed_membership_tpu_torch import kernels
from distributed_membership_tpu_torch.ops.fused_folded import LANES
from distributed_membership_tpu_torch.ops.view_merge import M32, as_u32

# h_staleness / h_suspicion geometry (JAX observability/timeline.py).
HIST_BUCKETS = 8
STALENESS_BUCKET_TICKS = 8
_BUCKET_SHIFT = STALENESS_BUCKET_TICKS.bit_length() - 1
MAX_FAIL_IDS = 8


def _bucket_rows(vals, mask):
    b = (vals >> _BUCKET_SHIFT).clamp(0, HIST_BUCKETS - 1)
    return torch.stack([((b == k) & mask).sum(1, dtype=torch.int32)
                        for k in range(HIST_BUCKETS)], dim=1)


def probe_plain(n: int, s: int, p_cnt: int, tfail: int, fail_ids: tuple,
                want_hist: bool, want_agg: bool, t: int, ptr: int,
                row0: int, view, view_ts, act, rm_ids) -> dict:
    rows = view.shape[0]
    dev = view.device
    cols = (ptr + torch.arange(p_cnt, dtype=torch.int64, device=dev)) % s
    w = as_u32(view.index_select(1, cols))
    node = row0 + torch.arange(rows, dtype=torch.int64, device=dev)
    w_id = ((w - 1) & M32) % n
    valid = (w > 0) & (w_id != node[:, None]) & act[:, None]
    out = {"ids": torch.where(valid, w_id + 1, 0).to(torch.int32)}
    if want_hist:
        difft = t - view_ts
        pres = view != 0
        out["stale_rows"] = _bucket_rows(difft, pres)
        out["susp_rows"] = _bucket_rows(difft - tfail, pres & (difft >= tfail))
    if want_agg:
        out["rm_cnt"] = (rm_ids >= 0).sum(1, dtype=torch.int32)
        out["det"] = (torch.stack([(rm_ids == f).sum(1, dtype=torch.int32)
                                   for f in fail_ids])
                      if fail_ids else
                      torch.zeros((0, rows), dtype=torch.int32, device=dev))
    return out


def probe_window_fused(n: int, s: int, p_cnt: int, tfail: int,
                       fail_ids: tuple, want_hist: bool, want_agg: bool,
                       t: int, ptr: int, row0: int, view, view_ts, act,
                       rm_ids) -> dict:
    """K3 wrapper.  ``view`` int32 u32-bit ``[rows, S]``, ``view_ts``
    int32 ``[rows, S]`` (``None`` unless ``want_hist``), ``act`` bool
    ``[rows]``, ``rm_ids`` int32 ``[rows, S]`` (``None`` unless
    ``want_agg``); ``t``, ``ptr`` and ``row0`` are host ints."""
    rows = view.shape[0]
    dev = view.device
    req = kernels.require
    req(0 < p_cnt < s and 0 <= ptr < s,
        f"probe: need 0 < P < S and 0 <= ptr < S (P={p_cnt}, ptr={ptr})")
    req(len(fail_ids) <= MAX_FAIL_IDS,
        f"probe: at most {MAX_FAIL_IDS} fail ids (got {len(fail_ids)})")
    req(s < 1 << 16, f"probe: S must be below 2^16 (got {s})")
    req(view.shape == (rows, s) and view.dtype == torch.int32
        and view.is_contiguous(), f"probe: view must be int32 [{rows}, {s}]")
    req(act.shape == (rows,) and act.dtype == torch.bool
        and act.device == dev and act.is_contiguous(),
        f"probe: act must be bool [{rows}]")
    for name, plane, want in (("view_ts", view_ts, want_hist),
                              ("rm_ids", rm_ids, want_agg)):
        req((plane is not None) == want, f"probe: {name} given iff wanted")
        if want:
            req(plane.shape == (rows, s) and plane.dtype == torch.int32
                and plane.device == dev and plane.is_contiguous(),
                f"probe: {name} must be contiguous int32 [{rows}, {s}]")
    if not view.is_cuda:
        return probe_plain(n, s, p_cnt, tfail, fail_ids, want_hist,
                           want_agg, t, ptr, row0, view, view_ts, act,
                           rm_ids)
    i32 = dict(dtype=torch.int32, device=dev)
    out = {"ids": torch.empty((rows, p_cnt), **i32)}
    if want_hist:
        out["stale_rows"] = torch.empty((rows, HIST_BUCKETS), **i32)
        out["susp_rows"] = torch.empty((rows, HIST_BUCKETS), **i32)
    if want_agg:
        out["rm_cnt"] = torch.empty((rows,), **i32)
        out["det"] = torch.empty((len(fail_ids), rows), **i32)
    fail = kernels.FailIds()
    for k, f in enumerate(fail_ids if want_agg else ()):
        fail.ids[k] = int(f)
    p = kernels.ptr
    rc = kernels.library("probe").dm_probe(
        t, ptr, n, s, p_cnt, tfail, row0, rows, p(view), p(view_ts),
        p(act), p(rm_ids), len(fail_ids) if want_agg else 0, fail,
        p(out["ids"]), p(out.get("stale_rows")), p(out.get("susp_rows")),
        p(out.get("rm_cnt")), p(out.get("det")), kernels.stream_of(view))
    kernels.check(rc, "probe")
    kernels.LAUNCHES["probe_hist" if want_hist else "probe"] += 1
    return out


def probe_folded_plain(n: int, s: int, p_cnt: int, tfail: int,
                       fail_ids: tuple, want_hist: bool, want_agg: bool,
                       t: int, ptr: int, row0: int, view, view_ts, act,
                       rm_ids) -> dict:
    # A node's S slots are one row of the [nodes, S] view of the plane.
    out = {"ids": probe_plain(n, s, p_cnt, tfail, (), False, False, t, ptr,
                              row0, view.view(-1, s), None, act,
                              None)["ids"]}
    if want_hist:
        difft = t - view_ts
        pres = view != 0
        out["stale_rows"] = _bucket_rows(difft, pres)
        out["susp_rows"] = _bucket_rows(difft - tfail, pres & (difft >= tfail))
    if want_agg:
        out.update(folded_agg_partials(rm_ids, fail_ids, s))
    return out


def folded_agg_partials(rm_ids, fail_ids: tuple, s: int) -> dict:
    """K7's FastAgg partials of a folded removal plane ``[rows, 128]`` of
    S-slot nodes: ``rm_cnt`` and one ``det_cols`` entry per failed id
    (``[rows, 1]`` each) and, with failed ids, ``det_any`` (``[nodes]``,
    the nodes that removed any).  The folded step sums these itself where
    it runs no K7 (``PROBES: 0``)."""
    out = {"rm_cnt": (rm_ids >= 0).sum(1, keepdim=True, dtype=torch.int32)}
    hits = [rm_ids == f for f in fail_ids]
    out["det_cols"] = tuple(h.sum(1, keepdim=True, dtype=torch.int32)
                            for h in hits)
    if hits:
        out["det_any"] = torch.stack(hits).any(0).view(-1, s).any(1)
    return out


def probe_folded_window_fused(n: int, s: int, p_cnt: int, tfail: int,
                              fail_ids: tuple, want_hist: bool,
                              want_agg: bool, t: int, ptr: int, row0: int,
                              view, view_ts, act, rm_ids) -> dict:
    """K7 wrapper.  ``view`` int32 u32-bit ``[rows, 128]``, ``view_ts``
    int32 ``[rows, 128]`` (``None`` unless ``want_hist``), ``act`` bool
    over the plane's ``rows * 128 // S`` nodes, ``rm_ids`` int32 ``[rows,
    128]`` (``None`` unless ``want_agg``); ``t``, ``ptr`` and ``row0`` (the
    plane's first global node id) are host ints."""
    rows = view.shape[0]
    dev = view.device
    req = kernels.require
    req(0 < s < LANES and LANES % s == 0,
        f"probe_folded: S must divide {LANES} (got {s})")
    req(0 < p_cnt < s and 0 <= ptr < s,
        f"probe_folded: need 0 < P < S and 0 <= ptr < S (P={p_cnt}, "
        f"ptr={ptr})")
    req(len(fail_ids) <= MAX_FAIL_IDS,
        f"probe_folded: at most {MAX_FAIL_IDS} fail ids "
        f"(got {len(fail_ids)})")
    req(view.shape == (rows, LANES) and view.dtype == torch.int32
        and view.is_contiguous(),
        f"probe_folded: view must be contiguous int32 [{rows}, {LANES}]")
    nodes = rows * (LANES // s)
    req(act.shape == (nodes,) and act.dtype == torch.bool
        and act.device == dev and act.is_contiguous(),
        f"probe_folded: act must be bool [{nodes}]")
    for name, plane, want in (("view_ts", view_ts, want_hist),
                              ("rm_ids", rm_ids, want_agg)):
        req((plane is not None) == want,
            f"probe_folded: {name} given iff wanted")
        if want:
            req(plane.shape == (rows, LANES) and plane.dtype == torch.int32
                and plane.device == dev and plane.is_contiguous(),
                f"probe_folded: {name} must be contiguous int32 "
                f"[{rows}, {LANES}]")
    if not view.is_cuda:
        return probe_folded_plain(n, s, p_cnt, tfail, fail_ids, want_hist,
                                  want_agg, t, ptr, row0, view, view_ts,
                                  act, rm_ids)
    req(all(x.data_ptr() % 16 == 0 for x in (view, view_ts, rm_ids)
            if x is not None),
        "probe_folded kernel reads 16-byte vectors: planes must be 16-byte "
        "aligned")
    i32 = dict(dtype=torch.int32, device=dev)
    fails = fail_ids if want_agg else ()
    out = {"ids": torch.empty((nodes, p_cnt), **i32)}
    det = det_any = None
    if want_hist:
        out["stale_rows"] = torch.empty((rows, HIST_BUCKETS), **i32)
        out["susp_rows"] = torch.empty((rows, HIST_BUCKETS), **i32)
    if want_agg:
        out["rm_cnt"] = torch.empty((rows, 1), **i32)
        det = torch.empty((len(fails), rows), **i32)
        out["det_cols"] = det.unsqueeze(-1).unbind(0)
        if fails:
            det_any = torch.empty((nodes,), dtype=torch.bool, device=dev)
            out["det_any"] = det_any
    fail = kernels.FailIds()
    for k, f in enumerate(fails):
        fail.ids[k] = int(f)
    p = kernels.ptr
    rc = kernels.library("probe_folded").dm_probe_folded(
        t, ptr, n, s, p_cnt, tfail, row0, rows, p(view), p(view_ts), p(act),
        p(rm_ids), len(fails), fail, p(out["ids"]), p(out.get("stale_rows")),
        p(out.get("susp_rows")), p(out.get("rm_cnt")), p(det), p(det_any),
        kernels.stream_of(view))
    kernels.check(rc, "probe_folded")
    kernels.LAUNCHES["probe_folded_hist" if want_hist
                     else "probe_folded"] += 1
    return out
