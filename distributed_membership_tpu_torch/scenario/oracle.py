"""Scenario oracle: grade a run against its declared chaos schedule (the
JAX package's ``scenario/oracle.py``, on the port's run artifacts).

The report is computed from what the run produced: the per-tick
telemetry series (``TELEMETRY: scalars|hist``) when recorded, else the
per-tick join/removal counts parsed from dbg.log in full-event runs, and
the final state (live/failed flags and a staleness census over the
packed views, whose node-major flat order is the same for the natural
``[N, S]`` and the folded ``[N*S/128, 128]`` planes).  Every metric is a
deterministic function of bit-exact artifacts, so the report equals the
JAX package's for the same run.

Per partition window ``(start, stop]``: ``removals_during`` (removals
in ``(start, stop + TREMOVE]``), ``refill_joins`` (admissions from the
start to the end of the run), ``joins_after_heal``, ``unhealed_removals``
(``max(0, removals_during - refill_joins)``) and ``reconverged_tick``
(first post-heal tick with no suspected entry on the telemetry basis,
else the last post-heal churn tick).  The invariant verdicts
(``report["invariants"]``): ``no_false_removals`` (excused by schedules
that mask liveness: partitions, restart churn, delays of at least TFAIL,
loss of at least 0.5 over at least TFAIL ticks), ``removals_healed``,
``restarts_rejoined`` and ``detection_slo`` (the hist tier's latency
SLO, observability/latency_dist.py).  ``report["violations"]`` lists the
failing ones and ``report["ok"]`` rolls them up.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from distributed_membership_tpu_torch.scenario.compile import (
    DOWN_KINDS, ScenarioProgram)

_REMOVED_RE = re.compile(r"removed at time (\d+)\s*$")
_JOINED_RE = re.compile(r"joined at time (\d+)\s*$")


def _series_from_dbg(dbg_text: str, total: int):
    """Per-tick join/removal counts from dbg.log lines (the grader's
    line grammar; variant-prefix lines without the suffix are skipped,
    as observability.metrics does)."""
    joins = np.zeros((total,), np.int64)
    removals = np.zeros((total,), np.int64)
    for line in dbg_text.splitlines():
        m = _REMOVED_RE.search(line)
        if m:
            t = int(m.group(1))
            if 0 <= t < total:
                removals[t] += 1
            continue
        m = _JOINED_RE.search(line)
        if m:
            t = int(m.group(1))
            if 0 <= t < total:
                joins[t] += 1
    return joins, removals


def _host(x) -> np.ndarray:
    """A final-state leaf on the host (a tensor of any device, or numpy)."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _final_state_census(final_state, params, total: int) -> dict:
    """Live/failed counts + a staleness census over the final views."""
    failed = _host(final_state.failed)
    started = _host(final_state.started)
    in_group = _host(final_state.in_group)
    live = started & in_group & ~failed
    out = {"live": int(live.sum()), "failed": int(failed.sum())}
    n = params.EN_GPSZ
    s = params.VIEW_SIZE if params.VIEW_SIZE > 0 else n
    view = _host(final_state.view).reshape(-1)
    view_ts = _host(final_state.view_ts).reshape(-1)
    if view.size == n * s:
        # Node-major flat order holds for natural AND folded planes; the
        # packed u32 entries are int32 bits here, so occupied is != 0.
        holder_live = np.repeat(live, s)
        present = (view != 0) & holder_live
        stale = present & ((total - 1) - view_ts >= params.TFAIL)
        out["suspected_entries"] = int(stale.sum())
        out["present_entries"] = int(present.sum())
    return out


def _masking_excuses(program: ScenarioProgram, params) -> list:
    """Schedule features that legitimately cause the scalar accuracy
    metric to count removals of live nodes (module docstring) — a
    deterministic function of the SCHEDULE, independent of the run."""
    excuses = []
    if program.partitions:
        excuses.append("partition")
    if any(e["kind"] == "restart" for e in program.point_events):
        excuses.append("restart_churn")
    if any(w["stop"] - w["start"] >= params.TFAIL
           for w in program.delays):
        excuses.append("long_delay")
    heavy = [w for w in program.flakes + program.drop_windows
             if (w["drop_prob"] >= 0.5
                 and w["stop"] - w["start"] >= params.TFAIL)]
    if heavy:
        excuses.append("heavy_loss")
    return excuses


def _invariant_verdicts(program: ScenarioProgram, params, report: dict,
                        summary: Optional[dict],
                        timeline: Optional[dict]) -> dict:
    """The hard verdicts (module docstring).  Each entry carries its
    evidence plus ``ok``; unassessable invariants (missing artifact
    stream) pass with ``assessed: False`` — absence of evidence is not
    a violation, and the campaign runner requires the streams it needs."""
    inv: dict = {}

    fr = None if summary is None else summary.get("false_removals")
    excuses = _masking_excuses(program, params)
    inv["no_false_removals"] = {
        "count": fr, "excused_by": excuses,
        "assessed": fr is not None,
        "ok": fr is None or fr == 0 or bool(excuses)}

    unhealed = sum(p.get("unhealed_removals", 0)
                   for p in report.get("partitions", ()))
    susp = report.get("final", {}).get("suspected_entries")
    inv["removals_healed"] = {
        "unhealed_removals": unhealed, "suspected_entries": susp,
        "assessed": bool(report.get("partitions")) or susp is not None,
        "ok": unhealed == 0 and not susp}

    restarts = report.get("restarts", ())
    not_back = [r for r in restarts if r.get("rejoined") is False]
    inv["restarts_rejoined"] = {
        "restart_events": len(restarts), "not_rejoined": len(not_back),
        "assessed": bool(restarts),
        "ok": not not_back}

    slo = None
    if timeline is not None and "h_latency" in timeline:
        from distributed_membership_tpu_torch.observability.latency_dist import (
            slo_verdict)
        slo = slo_verdict(timeline)
    inv["detection_slo"] = {
        "assessed": bool(slo) and slo.get("passed") is not None,
        "max_cdf_deviation": (None if slo is None
                              else slo.get("max_cdf_deviation")),
        "ok": slo is None or slo.get("passed") is not False}
    return inv


def _window_sum(series, lo: int, hi: int, t0: int = 0) -> int:
    """Sum of series[t] for lo < t <= hi (series starts at tick t0)."""
    a = max(lo + 1 - t0, 0)
    b = max(min(hi + 1 - t0, len(series)), a)
    return int(np.asarray(series[a:b]).sum())


def scenario_report(program: ScenarioProgram, params, *,
                    final_state=None, summary: Optional[dict] = None,
                    timeline: Optional[dict] = None,
                    dbg_text: Optional[str] = None,
                    final_live: Optional[int] = None,
                    final_failed: Optional[int] = None,
                    final_failed_indices=None) -> dict:
    """The oracle report dict (see module docstring for the metrics)."""
    total = params.TOTAL_TIME
    t0 = 0
    joins = removals = suspected = None
    basis = "none"
    if timeline is not None and timeline.get("ticks", 0) > 0:
        joins = timeline["joins"]
        removals = timeline["removals"]
        suspected = timeline["suspected"]
        t0 = int(timeline.get("t0", 0))
        basis = "telemetry"
    elif dbg_text is not None:
        joins, removals = _series_from_dbg(dbg_text, total)
        basis = "dbg"

    report: dict = {
        "scenario": program.scenario.name,
        "basis": basis,
        "events": [],
        "partitions": [],
        "crashes": [],
        "restarts": [],
    }
    end = t0 + (len(joins) if joins is not None else total) - 1

    for ev in program.point_events:
        count = sum(hi - lo for lo, hi in ev["ranges"])
        entry = {"kind": ev["kind"], "time": ev["time"], "nodes": count}
        report["events"].append(dict(entry))
        if ev["kind"] in DOWN_KINDS:
            if removals is not None:
                entry["removals_within_2tremove"] = _window_sum(
                    removals, ev["time"], ev["time"] + 2 * params.TREMOVE,
                    t0)
            report["crashes"].append(entry)
        else:
            idxs = [i for lo, hi in ev["ranges"] for i in range(lo, hi)]
            if final_state is not None:
                failed = _host(final_state.failed)
                entry["rejoined"] = bool((~failed[idxs]).all())
            elif final_failed_indices is not None:
                down = set(final_failed_indices)
                entry["rejoined"] = not down.intersection(idxs)
            if joins is not None:
                entry["joins_after"] = _window_sum(joins, ev["time"],
                                                   end, t0)
            report["restarts"].append(entry)

    for w in program.partitions:
        start, stop = w["start"], w["stop"]
        p: dict = {"start": start, "stop": stop,
                   "groups": len(w["cuts"]) + 1}
        report["events"].append({"kind": "partition", "start": start,
                                 "stop": stop})
        if removals is not None:
            p["removals_during"] = _window_sum(
                removals, start, stop + params.TREMOVE, t0)
            p["refill_joins"] = _window_sum(joins, start, end, t0)
            p["joins_after_heal"] = _window_sum(joins, stop, end, t0)
            p["unhealed_removals"] = max(
                0, p["removals_during"] - p["refill_joins"])
        if suspected is not None:
            post = np.asarray(suspected[max(stop + 1 - t0, 0):])
            zeros = np.nonzero(post == 0)[0]
            p["reconverged_tick"] = (int(stop + 1 + zeros[0])
                                     if zeros.size else None)
            p["reconverge_basis"] = "suspected"
        elif removals is not None:
            churn = np.asarray(joins[max(stop + 1 - t0, 0):]) \
                + np.asarray(removals[max(stop + 1 - t0, 0):])
            nz = np.nonzero(churn)[0]
            p["reconverged_tick"] = (int(stop + 1 + nz[-1])
                                     if nz.size else None)
            p["reconverge_basis"] = "churn"
        report["partitions"].append(p)

    for w in program.flakes:
        report["events"].append({"kind": "link_flake", **{
            k: w[k] for k in ("start", "stop", "drop_prob")}})
    for w in program.drop_windows:
        report["events"].append({"kind": "drop_window", **{
            k: w[k] for k in ("start", "stop", "drop_prob")}})
    for w in program.delays:
        report["events"].append({"kind": "delay_window",
                                 "start": w["start"], "stop": w["stop"],
                                 "dst": list(w["dst"])})

    if joins is not None:
        report["totals"] = {"joins_total": int(np.asarray(joins).sum()),
                            "removals_total":
                                int(np.asarray(removals).sum())}
    if final_state is not None:
        report["final"] = _final_state_census(final_state, params, total)
    elif final_live is not None:
        report["final"] = {"live": int(final_live),
                           "failed": int(final_failed or 0)}
    if summary is not None:
        report["detection_summary"] = {
            k: summary[k] for k in ("detections_total", "false_removals")
            if k in summary}
    report["invariants"] = _invariant_verdicts(program, params, report,
                                               summary, timeline)
    report["violations"] = sorted(
        name for name, v in report["invariants"].items() if not v["ok"])
    report["ok"] = not report["violations"]
    return report
