"""The parts of the JAX package's ``backends/tpu_sparse.py`` the hash
backend shares: the per-tick event record, the seed-burst cap, dbg.log
reconstruction from events, and the run tail (with the scenario oracle's
report)."""

from __future__ import annotations

import json
import os
import time as _time
from typing import NamedTuple

import numpy as np
import torch

from distributed_membership_tpu_torch.addressing import INTRODUCER_INDEX
from distributed_membership_tpu_torch.backends import RunResult
from distributed_membership_tpu_torch.observability.aggregates import (
    detection_summary)
from distributed_membership_tpu_torch.observability.timeline import (
    TimelineRecorder)
from distributed_membership_tpu_torch.runtime.failures import log_failures

SEED_CAP = 8  # max JOINREQs the introducer answers with a burst per tick


class SparseTickEvents(NamedTuple):
    join_ids: torch.Tensor   # [N, S] int32 id joined into this slot, -1 none
    rm_ids: torch.Tensor     # [N, S] int32 id removed from this slot, -1 none
    sent: torch.Tensor       # [N] int32
    recv: torch.Tensor       # [N] int32


class CompactEvents(NamedTuple):
    """Host form of a full-event run: ``(tick, logger, member)`` rows for
    joins and removals, in tick, logger, slot order, plus ``[T, N]``
    message counts."""
    joins: np.ndarray
    removes: np.ndarray
    sent: np.ndarray
    recv: np.ndarray
    total: int


def compact_tick(t: int, ids: torch.Tensor) -> np.ndarray:
    """``(t, row, id)`` rows of one tick's event plane (-1 = none)."""
    ids = ids.cpu().numpy()
    rows, slots = np.nonzero(ids >= 0)
    return np.stack([np.full(rows.shape, t, np.int64), rows.astype(np.int64),
                     ids[rows, slots].astype(np.int64)], axis=1)


def events_to_log(params, plan, events: CompactEvents, log) -> None:
    """Reconstruct dbg.log from the compacted events (the JAX
    ``events_to_log``).  Cold joins add each node's start line in
    descending index order and the introducer's ``@@time`` line every 500
    ticks; under warm join every node starts in the group, so neither is
    logged."""
    n = params.EN_GPSZ
    starts = [params.start_tick(i) for i in range(n)]
    for i in range(n):
        log.log(i + 1, 0, "APP")
    join_by_tick: dict = {}
    for t, i, j in events.joins:
        join_by_tick.setdefault(int(t), []).append((int(i), int(j)))
    remove_by_tick: dict = {}
    for t, i, j in events.removes:
        remove_by_tick.setdefault(int(t), []).append((int(i), int(j)))
    intro_failed = (plan.fail_time is not None
                    and INTRODUCER_INDEX in plan.failed_indices)
    warm = params.JOIN_MODE == "warm"
    for t in range(events.total):
        if not warm:
            for i in range(n - 1, -1, -1):
                if starts[i] == t:
                    log.log(i + 1, t, "Starting up group..."
                            if i == INTRODUCER_INDEX else "Trying to join...")
        for i, j in join_by_tick.get(t, ()):
            log.node_add(i + 1, j + 1, t)
        for i, j in remove_by_tick.get(t, ()):
            log.node_remove(i + 1, j + 1, t)
        if (not warm and t % 500 == 0 and t > starts[INTRODUCER_INDEX]
                and not (intro_failed and t > plan.fail_time)):
            log.log(INTRODUCER_INDEX + 1, t, f"@@time={t}")
        if plan.fail_time == t:
            log_failures(plan, log, t)


def finish_run(params, plan, log, run_scan_fn, t0: float, seed: int,
               device) -> RunResult:
    """Run the tick loop in the resolved event mode, then either rebuild
    dbg.log (full) or summarize the on-device aggregates (agg).  Under
    ``TELEMETRY: scalars|hist`` the per-tick series land in
    ``extra["timeline"]`` and, with ``TELEMETRY_DIR``, in its
    ``timeline.jsonl`` (and in agg mode the detection summary in its
    ``summary.json``).  A general scenario's oracle report lands in
    ``extra["scenario_report"]`` and ``TELEMETRY_DIR/scenario.json``."""
    aggregate = params.resolved_event_mode() == "agg"
    recorder = (TimelineRecorder(params.TELEMETRY_DIR or None)
                if params.TELEMETRY in ("scalars", "hist") else None)
    final_state, events = run_scan_fn(params, plan, seed, device,
                                      collect_events=not aggregate,
                                      telemetry=recorder)
    failed = plan.failed_indices if plan.fail_time is not None else []
    if aggregate:
        if plan.fail_time is not None:
            log_failures(plan, log, plan.fail_time)
        fail_mask = np.zeros((params.EN_GPSZ,), bool)
        fail_mask[failed] = True
        summary = detection_summary(final_state.agg, fail_mask,
                                    plan.fail_time)
        from distributed_membership_tpu_torch.backends.tpu_hash import (
            probe_attribution_exact)
        summary["approx_probe_attribution"] = (
            not probe_attribution_exact(params))
        sent = final_state.agg.sent_total.cpu().numpy()[:, None]
        recv = final_state.agg.recv_total.cpu().numpy()[:, None]
        extra = {"final_state": final_state, "aggregate": True,
                 "detection_summary": summary}
    else:
        events_to_log(params, plan, events, log)
        sent = events.sent.T
        recv = events.recv.T
        extra = {"final_state": final_state}
    if plan.scenario is not None:
        # The scenario oracle (scenario/oracle.py): the run graded against
        # its schedule from what it recorded -- the telemetry series, else
        # the dbg.log events -- and its final state; beside the timeline
        # as scenario.json.
        from distributed_membership_tpu_torch.scenario.oracle import (
            scenario_report)
        report = scenario_report(
            plan.scenario, params, final_state=final_state,
            summary=extra.get("detection_summary"),
            timeline=recorder.series() if recorder is not None else None,
            dbg_text=log.dbg_text() if not aggregate else None)
        extra["scenario_report"] = report
        if params.TELEMETRY_DIR:
            with open(os.path.join(params.TELEMETRY_DIR, "scenario.json"),
                      "w") as fh:
                json.dump(report, fh, indent=1)
    if recorder is not None:
        extra["timeline"] = recorder.series()
        extra["timeline_path"] = recorder.path
        if params.TELEMETRY_DIR and aggregate:
            # The detection verdicts beside the series they reconcile
            # with, for scripts/run_report.py.
            with open(os.path.join(params.TELEMETRY_DIR, "summary.json"),
                      "w") as fh:
                json.dump(extra["detection_summary"], fh, indent=1)
    return RunResult(
        params=params, log=log, sent=sent, recv=recv,
        failed_indices=failed, fail_time=plan.fail_time,
        wall_seconds=_time.time() - t0, extra=extra)
