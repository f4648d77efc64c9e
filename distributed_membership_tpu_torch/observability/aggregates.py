"""On-device event aggregates for scale runs (the JAX package's
``observability/aggregates.py``).

At 1M nodes the per-tick event planes cannot be kept, so a run folds
them into O(N) accumulators: detection counts, the tracker census at the
failure tick, distinct-observer flags, the detection-latency histogram
and message totals.  Everything the detection summary reports is
computed from these on the host at the end.

Two forms, as in the JAX package: ``FastAgg`` for a static failed set of
at most ``FAST_AGG_MAX_FAILED`` ids (per-id elementwise work, fed by the
probe kernels' partials), and ``AggStats`` for any failed set (per-id
``[N]`` counts, each tick's events added by id with one int32
``index_add_`` per event plane; integer adds are order-free, so the
counts are exact on any device).  Full event mode carries an
``AggStats`` it never updates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LAT_BINS = 512          # ticks-after-failure resolution; last bin overflows
FAST_AGG_MAX_FAILED = 8
_NO_TICK = np.iinfo(np.int32).max


class AggStats(NamedTuple):
    rm_count: torch.Tensor
    det_count: torch.Tensor
    rm_first: torch.Tensor
    rm_last: torch.Tensor
    join_count: torch.Tensor
    trackers: torch.Tensor
    tracker_obs: torch.Tensor
    det_obs: torch.Tensor
    lat_hist: torch.Tensor
    sent_total: torch.Tensor
    recv_total: torch.Tensor


def init_agg(n: int, device, rows: int | None = None) -> AggStats:
    """``rows`` (default N) sizes the observer-row fields, as in the JAX
    package (a sharded state carries one shard's rows)."""
    rows = n if rows is None else rows
    i32 = dict(dtype=torch.int32, device=device)
    return AggStats(
        rm_count=torch.zeros((n,), **i32),
        det_count=torch.zeros((n,), **i32),
        rm_first=torch.full((n,), _NO_TICK, **i32),
        rm_last=torch.full((n,), -1, **i32),
        join_count=torch.zeros((n,), **i32),
        trackers=torch.zeros((n,), **i32),
        tracker_obs=torch.zeros((rows,), dtype=torch.bool, device=device),
        det_obs=torch.zeros((rows,), dtype=torch.bool, device=device),
        lat_hist=torch.zeros((LAT_BINS,), **i32),
        sent_total=torch.zeros((rows,), **i32),
        recv_total=torch.zeros((rows,), **i32),
    )


# Sink slots of a count: most entries of an event plane are empty, and
# adding them all at one sink address serialises the card's atomics.
_SINKS = 1024


def _count_by_id(ids: torch.Tensor, mask: torch.Tensor, n: int):
    """``[n]`` int32 counts of the ids where ``mask`` holds (the JAX
    ``count_by_id``: a scatter-add whose masked-out entries go to sink
    slots that are dropped, spread over ``_SINKS`` of them)."""
    flat = mask.reshape(-1)
    spread = torch.arange(flat.numel(), device=ids.device) & (_SINKS - 1)
    sel = torch.where(flat, ids.reshape(-1).to(torch.int64), n + spread)
    out = torch.zeros((n + _SINKS,), dtype=torch.int32, device=ids.device)
    out.index_add_(0, sel, torch.ones(sel.shape, dtype=torch.int32,
                                      device=ids.device))
    return out[:n]


def update_agg(agg: AggStats, *, t: int, join_ids, rm_ids, view_ids,
               view_present, fail_mask, fail_time: int, sent_tick,
               recv_tick, holder_failed=None) -> AggStats:
    """One tick (JAX ``update_agg``): ``join_ids``/``rm_ids`` ``[rows, M]``
    member ids (``EMPTY`` = none), ``view_ids``/``view_present`` the
    post-merge view, read at ``t == fail_time`` for the tracker census;
    ``fail_mask`` ``[N]`` by member id, ``holder_failed`` (default
    ``fail_mask``) by observer row.  ``t`` and ``fail_time`` are host
    ints, so the census is a host branch."""
    n = agg.rm_count.shape[0]
    if holder_failed is None:
        holder_failed = fail_mask
    rm_mask = rm_ids >= 0
    rm_add = _count_by_id(rm_ids, rm_mask, n)
    removed_any = rm_add > 0
    rm_first = torch.where(removed_any, agg.rm_first.clamp(max=t),
                           agg.rm_first)
    rm_last = torch.where(removed_any, agg.rm_last.clamp(min=t),
                          agg.rm_last)
    join_count = agg.join_count + _count_by_id(join_ids, join_ids >= 0, n)
    trackers, tracker_obs = agg.trackers, agg.tracker_obs
    if t == fail_time:
        # Dead holders (and their self entries) are no completeness
        # denominator.
        live_holder = ~holder_failed[:, None]
        holds_failed = view_present & fail_mask[
            view_ids.to(torch.int64).clamp_min(0)]
        trackers = _count_by_id(view_ids, view_present & live_holder, n)
        tracker_obs = holds_failed.any(1) & ~holder_failed
    # True detections: removals naming a crashed id strictly after the
    # crash; earlier removals of it are false positives.
    true_rm = rm_mask & fail_mask[rm_ids.to(torch.int64).clamp_min(0)]
    if not t > fail_time:
        true_rm = torch.zeros_like(true_rm)
    lat = min(max(t - fail_time, 0), LAT_BINS - 1)
    lat_hist = agg.lat_hist.clone()
    lat_hist[lat] += true_rm.sum(dtype=torch.int32)
    return AggStats(
        rm_count=agg.rm_count + rm_add,
        det_count=agg.det_count + _count_by_id(rm_ids, true_rm, n),
        rm_first=rm_first, rm_last=rm_last, join_count=join_count,
        trackers=trackers, tracker_obs=tracker_obs,
        det_obs=agg.det_obs | true_rm.any(1), lat_hist=lat_hist,
        sent_total=agg.sent_total + sent_tick,
        recv_total=agg.recv_total + recv_tick)


def merge_agg(a: AggStats, b: AggStats) -> AggStats:
    """Merge two AggStats of disjoint tick ranges of one run (JAX
    ``merge_agg``, on tensors): sums, ors, and the first/last removal
    ticks as min/max (their init values are the identities); the census
    is taken in one range only, zero elsewhere, so ``+`` is exact."""
    return AggStats(
        rm_count=a.rm_count + b.rm_count,
        det_count=a.det_count + b.det_count,
        rm_first=torch.minimum(a.rm_first, b.rm_first),
        rm_last=torch.maximum(a.rm_last, b.rm_last),
        join_count=a.join_count + b.join_count,
        trackers=a.trackers + b.trackers,
        tracker_obs=a.tracker_obs | b.tracker_obs,
        det_obs=a.det_obs | b.det_obs,
        lat_hist=a.lat_hist + b.lat_hist,
        sent_total=a.sent_total + b.sent_total,
        recv_total=a.recv_total + b.recv_total)


class FastAgg(NamedTuple):
    det_count: torch.Tensor    # [F] i32 true detections per failed id
    trackers: torch.Tensor     # [F] i32 live views holding id f at fail_time
    tracker_obs: torch.Tensor  # [N] bool held >= 1 crashed id at the crash
    det_obs: torch.Tensor      # [N] bool issued >= 1 true detection
    lat_hist: torch.Tensor     # [LAT_BINS] i32
    join_total: torch.Tensor   # [] i32
    rm_total: torch.Tensor     # [] i32 (false removals = rm - det)
    sent_total: torch.Tensor   # [N] i32
    recv_total: torch.Tensor   # [N] i32


def init_fast_agg(n_failed: int, rows: int, device,
                  shards: int = 0) -> FastAgg:
    """With ``shards`` the per-id, histogram and scalar fields carry one
    partial per shard (a leading ``[D]`` axis), for the sharded step to
    reduce at the end of the run; the per-row fields are flat."""
    i32 = dict(dtype=torch.int32, device=device)
    lead = (shards,) if shards else ()
    return FastAgg(
        det_count=torch.zeros(lead + (max(n_failed, 1),), **i32),
        trackers=torch.zeros(lead + (max(n_failed, 1),), **i32),
        tracker_obs=torch.zeros((rows,), dtype=torch.bool, device=device),
        det_obs=torch.zeros((rows,), dtype=torch.bool, device=device),
        lat_hist=torch.zeros(lead + (LAT_BINS,), **i32),
        join_total=torch.zeros(lead, **i32),
        rm_total=torch.zeros(lead, **i32),
        sent_total=torch.zeros((rows,), **i32),
        recv_total=torch.zeros((rows,), **i32),
    )


def update_fast_agg(agg: FastAgg, *, t: int, fail_ids: tuple,
                    join_events, rm_total_tick, det_tick, any_true_rm,
                    view_ids, view_present, fail_time: int, holder_failed,
                    sent_tick, recv_tick, part=None) -> FastAgg:
    """One tick (JAX ``update_fast_agg`` with the probe kernel's
    partials as ``pre``): ``det_tick`` [F] removals naming each failed id,
    ``any_true_rm`` [N] rows that removed one, ``rm_total_tick`` all
    removals.  ``t`` and ``fail_time`` are host ints, so the crash-tick
    census is a host branch.  ``part`` reduces a per-row plane to the
    accumulators' partials: its total by default, or one sum per shard
    (``LocalMesh.shard_sums``) for an agg of ``init_fast_agg(...,
    shards=D)``, with ``det_tick`` ``[D, F]`` and ``rm_total_tick``
    ``[D]`` reduced the same way."""
    if part is None:
        def part(x):
            return x.sum(dtype=torch.int32)
    post = t > fail_time
    trackers, tracker_obs = agg.trackers, agg.tracker_obs
    if fail_ids:
        det_tick = det_tick if post else torch.zeros_like(det_tick)
        if t == fail_time:
            live = ~holder_failed[:, None]
            holds = [view_present & (view_ids == f) for f in fail_ids]
            trackers = torch.stack([part(h & live) for h in holds], dim=-1)
            tracker_obs = torch.stack([h.any(1) for h in holds]).any(0) \
                & ~holder_failed
    else:
        det_tick = torch.zeros_like(agg.det_count)
        any_true_rm = torch.zeros_like(agg.det_obs)
    lat = min(max(t - fail_time, 0), LAT_BINS - 1)
    lat_hist = agg.lat_hist.clone()
    lat_hist[..., lat] += det_tick.sum(-1, dtype=torch.int32)
    return FastAgg(
        det_count=agg.det_count + det_tick,
        trackers=trackers,
        tracker_obs=tracker_obs,
        det_obs=agg.det_obs | (any_true_rm & post),
        lat_hist=lat_hist,
        join_total=agg.join_total + part(join_events),
        rm_total=agg.rm_total + rm_total_tick,
        sent_total=agg.sent_total + sent_tick,
        recv_total=agg.recv_total + recv_tick,
    )


def latency_stats(hist: np.ndarray) -> dict:
    hist = np.asarray(hist)
    total_det = int(hist.sum())
    if not total_det:
        return {}
    ticks = np.arange(hist.shape[0])
    cdf = np.cumsum(hist)
    return {
        "latency_min": int(ticks[hist > 0][0]),
        "latency_max": int(ticks[hist > 0][-1]),
        "latency_p50": int(np.searchsorted(cdf, 0.50 * total_det)),
        "latency_p99": int(np.searchsorted(cdf, 0.99 * total_det)),
        "latency_overflow_count": int(hist[hist.shape[0] - 1]),
        "latency_hist_nonzero": {
            int(k): int(v) for k, v in zip(ticks[hist > 0], hist[hist > 0])},
    }


def _completeness_stats(trackers, detections, tracker_obs, det_obs,
                        n_failed: int, total_det: int) -> dict:
    tracker_nodes = int(tracker_obs.sum())
    detecting = int((det_obs & tracker_obs).sum())
    return {
        "failed_nodes": n_failed,
        "trackers_per_failed_min": int(trackers.min()),
        "trackers_per_failed_mean": float(trackers.mean()),
        "detections_total": total_det,
        "tracker_nodes": tracker_nodes,
        "observer_completeness": (
            detecting / tracker_nodes if tracker_nodes else 1.0),
        "detection_completeness": float((detections >= trackers).mean()),
        "detected_by_someone": float((detections > 0).mean()),
    }


def fast_summary(agg: FastAgg, fail_ids, fail_time) -> dict:
    """The detection summary: accuracy (false removals), completeness
    per failed id and per observer, and the latency distribution."""
    agg = FastAgg(*(x.cpu().numpy() for x in agg))
    det_total = int(agg.det_count.sum())
    out = {
        "n": agg.tracker_obs.shape[0],
        "joins_total": int(agg.join_total),
        "false_removals": int(agg.rm_total) - det_total,
        "msgs_sent": int(agg.sent_total.sum()),
        "msgs_recv": int(agg.recv_total.sum()),
    }
    if fail_time is not None and len(fail_ids):
        f = len(fail_ids)
        out.update(_completeness_stats(
            agg.trackers[:f], agg.det_count[:f], agg.tracker_obs,
            agg.det_obs, f, int(agg.lat_hist.sum())))
        out.update(latency_stats(agg.lat_hist))
    return out


def detection_summary(agg, fail_mask: np.ndarray, fail_time) -> dict:
    """The detection summary of either aggregate form (JAX
    ``detection_summary``, same keys and criteria)."""
    if isinstance(agg, FastAgg):
        fail_ids = tuple(np.nonzero(np.asarray(fail_mask, bool))[0])
        return fast_summary(agg, fail_ids, fail_time)
    agg = AggStats(*(x.cpu().numpy() for x in agg))
    fail_mask = np.asarray(fail_mask, bool)
    out = {
        "n": agg.rm_count.shape[0],
        "joins_total": int(agg.join_count.sum()),
        # Every removal that is not a true detection is false.
        "false_removals": int(agg.rm_count.sum() - agg.det_count.sum()),
        "msgs_sent": int(agg.sent_total.sum()),
        "msgs_recv": int(agg.recv_total.sum()),
    }
    if fail_time is not None and fail_mask.any():
        failed = np.nonzero(fail_mask)[0]
        out.update(_completeness_stats(
            agg.trackers[failed], agg.det_count[failed], agg.tracker_obs,
            agg.det_obs, int(fail_mask.sum()), int(agg.lat_hist.sum())))
        out.update(latency_stats(agg.lat_hist))
    return out
