"""Flight-recorder report: one markdown/JSON view of a recorded run (the
JAX package's ``scripts/run_report.py``, reading the streams through the
port's modules; the same markdown and JSON).

Renders the three recorder streams into a single report:

  * ``timeline.jsonl`` (TELEMETRY: scalars — observability/timeline.py):
    per-tick protocol health, summarized and reconciled against
  * ``summary.json`` (the detection verdicts finish_run drops next to
    the timeline), plus
  * ``runlog.jsonl`` (observability/runlog.py): per-segment
    wall / device-sync / checkpoint-write-overlap timings,
    compile-vs-execute events, and watchdog alerts
    (observability/watchdog.py — rendered both as inline timeline
    markers and as a per-rule count table), plus
  * ``spans.jsonl`` (observability/spans.py): per-injected-event
    stage traces (accepted → … → visible_at_replica), cross-checked
    against the scenario oracle when a ``scenario.json`` report is
    present, and optionally
  * a ladder event log (``artifacts/ladder_events.jsonl``): per-rung
    start/land/fail/retry/resume provenance.

With the hist telemetry tier (``TELEMETRY: hist``) two more views open:
``--slo`` reconstructs the detection-latency distribution from the
banked ``h_latency`` histograms and renders the BASELINE.md fidelity
verdict (observability/latency_dist.py), dropping ``slo.json`` next to
the timeline; ``--compare A B`` diffs two recorder directories series by
series and reports the first diverging tick — the bisect primitive for
"same run, different twin/resume/knob" investigations.

``--watch`` turns the one-shot report into a live dashboard for a run
in flight (``--serve`` or plain chunked): re-read the recorder streams
every ``--interval`` seconds and re-render (screen-clear on a tty, a
separator banner otherwise) until Ctrl-C.  The readers are all
torn-line tolerant, so watching a directory the run is actively
appending to is safe.

``--dir`` pointed at a FLEET root (a directory holding
``fleet_runs.jsonl``) switches to the fleet view: one status line per
run — state, tick progress, live census, SLO verdict — rebuilt from a
read-only journal replay plus each run dir's beacon/timeline/slo.json.
Combined with ``--watch`` that is the sweep dashboard.

Usage:
  R="python -m distributed_membership_tpu_torch.run_report"
  $R --dir <TELEMETRY_DIR>            # markdown
  $R --dir <dir> --json               # dict
  $R --dir <dir> --out report.md
  $R --dir <dir> --slo                # + verdict
  $R --dir <dir> --watch --interval 2
  $R --dir <FLEET_DIR> --watch        # fleet view
  $R --compare <dirA> <dirB>
  $R --ladder artifacts/ladder_events.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from distributed_membership_tpu_torch.observability import merge, spans
from distributed_membership_tpu_torch.observability.beacon import read_beacon
from distributed_membership_tpu_torch.observability.latency_dist import (
    slo_verdict)
from distributed_membership_tpu_torch.observability.runlog import read_events
from distributed_membership_tpu_torch.observability.timeline import (
    TIMELINE_NAME, read_timeline, timeline_summary)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _segment_stats(events: list) -> dict:
    segs = [e for e in events if e.get("kind") == "segment"]
    if not segs:
        return {}
    dev = [e.get("device_sync_s", 0.0) for e in segs]
    wait = [e.get("ckpt_wait_s", 0.0) for e in segs]
    flush = [e.get("flush_s", 0.0) for e in segs]
    out = {
        "segments": len(segs),
        "ticks_covered": sum(e["t1"] - e["t0"] for e in segs
                             if "t0" in e and "t1" in e),
        "device_sync_s_total": round(sum(dev), 3),
        "device_sync_s_mean": round(sum(dev) / len(dev), 4),
        "device_sync_s_max": round(max(dev), 4),
        "ckpt_wait_s_total": round(sum(wait), 3),
        "flush_s_total": round(sum(flush), 3),
    }
    compiles = [e for e in events if e.get("kind") == "compile"
                and e.get("phase") == "done"]
    if compiles:
        out["compile_plus_first_run_s"] = [
            e.get("compile_plus_first_run_s") for e in compiles]
    resumed = [e for e in events if e.get("kind") == "segments_start"
               and e.get("resumed")]
    if resumed:
        out["resumed_from_ticks"] = [e.get("tick_start") for e in resumed]
    return out


def _ladder_stats(events: list) -> dict:
    rungs: dict = {}
    for e in events:
        name = e.get("rung")
        if not name:
            continue
        r = rungs.setdefault(name, {"starts": 0, "timeouts": 0,
                                    "retries": 0, "resumes": 0,
                                    "errors": 0, "status": "pending"})
        kind = e.get("kind")
        if kind == "rung_start":
            r["starts"] += 1
        elif kind == "rung_timeout":
            r["timeouts"] += 1
        elif kind == "rung_retry":
            r["retries"] += 1
        elif kind == "rung_resume":
            r["resumes"] += 1
            r["resumed_from_tick"] = e.get("resumed_from_tick")
        elif kind in ("rung_attempt_failed", "rung_error"):
            r["errors"] += 1
        elif kind == "rung_land":
            r["status"] = "landed"
            for k in ("node_ticks_per_sec", "ms_per_tick", "attempts"):
                if e.get(k) is not None:
                    r[k] = e[k]
        elif kind == "rung_fail":
            r["status"] = "failed"
        elif kind == "rung_abandoned":
            r["status"] = "abandoned"
        elif kind == "correctness_failure":
            r["status"] = "correctness_failure"
    passes = [e for e in events if e.get("kind") == "pass_done"]
    out = {"rungs": rungs}
    if passes:
        out["passes"] = len(passes)
        out["landed_total"] = passes[-1].get("landed_total")
    return out


def _replica_beacons(directory: str) -> list:
    """The query tier's ``replica_<i>.json`` beacons (one per read
    replica, rewritten every second — service/replica.py), sorted by
    replica index, parsed by the shared torn-tolerant reader
    (observability/beacon.py).  Beacons whose ``time`` stamp is older
    than 10s are marked stale (a dead replica's last beacon stays on
    disk)."""
    import glob
    rows = []
    now = time.time()
    for path in sorted(glob.glob(os.path.join(directory,
                                              "replica_*.json"))):
        doc = read_beacon(path)
        if doc is None or doc.get("role") != "replica":
            continue
        doc["stale"] = bool(now - doc.get("time", 0) > 10)
        rows.append(doc)
    rows.sort(key=lambda d: d.get("index", 0))
    return rows


def _span_rows(span_map: dict) -> list:
    """One row per traced event: the tick each stage landed at, plus
    the span's own detection latency when stamped."""
    rows = []
    for eid in sorted(span_map):
        stages = span_map[eid]
        row: dict = {"event_id": eid}
        for s in spans.STAGES:
            rec = stages.get(s)
            if rec is not None:
                row[s] = rec.get("tick")
        det = stages.get("first_detection") or {}
        if det.get("latency_ticks") is not None:
            row["latency_ticks"] = det["latency_ticks"]
        vis = stages.get("visible_at_replica") or {}
        if vis.get("replica") is not None:
            row["replica"] = vis["replica"]
        rows.append(row)
    return rows


def build_report(directory: str | None,
                 ladder_path: str | None = None,
                 slo: bool = False) -> dict:
    """Collect every recorder stream present into one dict.

    ``slo=True`` adds the detection-latency SLO verdict reconstructed
    from the hist tier's ``h_latency`` series (and the caller writes it
    to ``<directory>/slo.json``)."""
    report: dict = {}
    series: dict = {}
    if directory:
        tl_path = os.path.join(directory, TIMELINE_NAME)
        if os.path.exists(tl_path):
            series = read_timeline(tl_path)
        else:
            # A multiproc out-root: merge the p{i} shards in memory
            # (verify + union — observability/merge.py); a shard
            # disagreement is reported, not raised, so the rest of the
            # artifacts still render.
            shards = merge.shard_dirs(directory)
            if shards:
                try:
                    series = merge.merged_series(
                        merge.merge_paths(shards))
                    report["merged_from"] = [lb for lb, _ in shards]
                except merge.MergeError as e:
                    report["merge_error"] = str(e)
        if series.get("ticks", 0):
            report["timeline"] = timeline_summary(series)
            report["timeline"]["detections_so_far_final"] = (
                int(series["detections_cum"][-1])
                if len(series["detections_cum"]) else 0)
            if report.get("merged_from"):
                report["timeline"]["merged_shards"] = len(
                    report["merged_from"])
        sm_path = os.path.join(directory, "summary.json")
        if os.path.exists(sm_path):
            with open(sm_path) as fh:
                report["detection_summary"] = json.load(fh)
        rl_path = os.path.join(directory, "runlog.jsonl")
        if os.path.exists(rl_path):
            events = read_events(rl_path)
            report["segments"] = _segment_stats(events)
            alert_rows = [e for e in events
                          if e.get("kind") == "alert"]
            if alert_rows:
                by_rule: dict = {}
                for a in alert_rows:
                    r = a.get("rule", "?")
                    by_rule[r] = by_rule.get(r, 0) + 1
                report["alerts"] = {"total": len(alert_rows),
                                    "by_rule": by_rule,
                                    "rows": alert_rows}
        sc_path = os.path.join(directory, "scenario.json")
        if os.path.exists(sc_path):
            with open(sc_path) as fh:
                report["scenario"] = json.load(fh)
        sp_path = os.path.join(directory, spans.SPANS_NAME)
        if os.path.exists(sp_path):
            span_map = spans.read_spans(sp_path)
            if span_map:
                report["spans"] = _span_rows(span_map)
                sc = report.get("scenario")
                if sc is not None:
                    report["span_crosscheck"] = spans.crosscheck(
                        span_map, sc,
                        series=series if series.get("ticks") else None)
        replicas = _replica_beacons(directory)
        if replicas:
            report["query_tier"] = {
                "replicas": replicas,
                "qps_total": round(sum(r.get("qps") or 0
                                       for r in replicas
                                       if not r["stale"]), 1),
                "tick_lag_max": max(
                    (r["tick_lag"] for r in replicas
                     if not r["stale"]
                     and r.get("tick_lag") is not None),
                    default=None),
            }
        # Elastic-mesh provenance (elastic/reshard.py): a resharded
        # run's checkpoint manifest carries the full migration chain —
        # surface it so a report says WHERE this trajectory has lived.
        chain = _reshard_chain(directory)
        if chain:
            report["reshard"] = chain
    if ladder_path and os.path.exists(ladder_path):
        report["ladder"] = _ladder_stats(read_events(ladder_path))
    # Reconciliation: the per-tick series must sum to the run verdicts
    # (the acceptance contract tests/test_timeline.py pins).
    tl, ds = report.get("timeline"), report.get("detection_summary")
    if tl and ds:
        report["reconciliation"] = {
            "joins_match": tl["joins_total"] == ds.get("joins_total"),
            "removals_match": tl["removals_total"] == (
                ds.get("false_removals", 0)
                + ds.get("detections_total", 0)),
        }
    # Scenario ↔ timeline cross-check: the oracle's event-count totals
    # were computed from the same per-tick series the timeline section
    # summarizes — any divergence means a torn artifact set.
    sc = report.get("scenario")
    if sc and tl and sc.get("totals"):
        report.setdefault("reconciliation", {})
        report["reconciliation"].update({
            "scenario_joins_match":
                sc["totals"]["joins_total"] == tl["joins_total"],
            "scenario_removals_match":
                sc["totals"]["removals_total"] == tl["removals_total"],
        })
    # Hist ↔ scalars cross-check: the latency histogram's total mass is
    # the per-tick detections series re-counted through a different
    # in-graph reduction — they must agree tick-for-tick in aggregate.
    if tl and tl.get("hist"):
        report.setdefault("reconciliation", {})
        report["reconciliation"]["hist_latency_matches_detections"] = (
            tl["latency_hist_detections"] == tl["detections_total"])
    if slo and "h_latency" in series:
        report["slo"] = slo_verdict(series)
    return report


def _reshard_chain(directory: str) -> list:
    """The reshard-provenance chain from the run's checkpoint manifest
    (first of the conventional checkpoint dir names under
    ``directory``, plus a multiproc ``p0/``)."""
    for sub in ("ck", "ckpt", "checkpoints",
                os.path.join("p0", "ck"), os.path.join("p0", "ckpt")):
        path = os.path.join(directory, sub, "MANIFEST.json")
        try:
            with open(path) as fh:
                chain = json.load(fh).get("reshard")
        except (OSError, ValueError):
            continue
        if chain:
            return list(chain)
    return []


def compare_dirs(dir_a: str, dir_b: str) -> dict:
    """Series-by-series diff of two recorder directories: per common
    series, the first tick where the values diverge (hist series compare
    whole bucket rows), plus length mismatches and one-sided fields.
    ``identical`` is the roll-up verdict."""
    def _arrays(d):
        return {f: v for f, v in d.items() if getattr(v, "ndim", None)}

    out: dict = {"a": dir_a, "b": dir_b, "series": {}, "identical": True}
    sa = _arrays(read_timeline(os.path.join(dir_a, TIMELINE_NAME)))
    sb = _arrays(read_timeline(os.path.join(dir_b, TIMELINE_NAME)))
    out["only_in_a"] = sorted(set(sa) - set(sb))
    out["only_in_b"] = sorted(set(sb) - set(sa))
    if out["only_in_a"] or out["only_in_b"]:
        out["identical"] = False
    for f in sorted(set(sa) & set(sb)):
        va, vb = sa[f], sb[f]
        k = min(len(va), len(vb))
        neq = va[:k] != vb[:k]
        if neq.ndim > 1:
            neq = neq.any(axis=tuple(range(1, neq.ndim)))
        idx = neq.nonzero()[0]
        first = int(idx[0]) if len(idx) else None
        entry = {"ticks_a": int(len(va)), "ticks_b": int(len(vb)),
                 "first_divergence": first,
                 "diverging_ticks": int(len(idx))}
        if first is not None or len(va) != len(vb):
            out["identical"] = False
        out["series"][f] = entry
    return out


def _scenario_markers(sc: dict) -> list:
    """One marker line per scenario event, for inline rendering in the
    timeline section."""
    out = []
    for ev in sc.get("events", ()):
        kind = ev.get("kind")
        if kind in ("crash", "leave", "restart"):
            out.append(f"t={ev['time']}: **{kind}** "
                       f"({ev.get('nodes', '?')} nodes)")
        elif kind == "partition":
            out.append(f"t={ev['start']}→{ev['stop']}: **partition** "
                       "(heal at stop)")
        elif kind == "delay_window":
            dst = ev.get("dst")
            where = (f"dst [{dst[0]},{dst[1]})" if dst else "all")
            out.append(f"t={ev['start']}→{ev['stop']}: "
                       f"**delay_window** {where} (inbound held)")
        else:
            out.append(f"t={ev['start']}→{ev['stop']}: **{kind}** "
                       f"p={ev.get('drop_prob')}")
    return out


def _md_kv(d: dict) -> list:
    return [f"| {k} | {v} |" for k, v in d.items()]


def render_markdown(report: dict) -> str:
    lines = ["# Flight-recorder run report", ""]
    if report.get("merge_error"):
        lines += [f"**MERGE ERROR**: {report['merge_error']}", ""]
    if report.get("merged_from"):
        lines += ["merged from shards: "
                  + ", ".join(report["merged_from"]), ""]
    sc = report.get("scenario")
    tl = report.get("timeline")
    al = report.get("alerts")
    if tl:
        lines += ["## Timeline (per-tick telemetry)", ""]
        if sc:
            # Scenario event markers inline, so the per-tick metrics
            # read against the chaos schedule that produced them.
            lines += [f"- {m}" for m in _scenario_markers(sc)]
        if al:
            # Watchdog alerts as inline markers too: a degradation
            # reads in-place against the schedule that caused it.
            for a in al["rows"]:
                lines.append(
                    f"- t={a.get('boundary_tick', '?')}: **ALERT** "
                    f"{a.get('rule', '?')} "
                    f"({a.get('severity', 'warn')})")
        if sc or al:
            lines.append("")
        lines += ["| metric | value |", "|---|---|"]
        lines += _md_kv(tl)
        lines.append("")
    if al:
        lines += ["## Watchdog alerts", "",
                  f"{al['total']} rising edge(s)", "",
                  "| rule | count |", "|---|---|"]
        lines += _md_kv(al["by_rule"])
        lines.append("")
    sp = report.get("spans")
    if sp:
        lines += ["## Event spans (injection tracing)", "",
                  "| event | accepted | journaled | compiled | "
                  "first detection | removal | visible@replica | "
                  "latency |",
                  "|---|---|---|---|---|---|---|---|"]
        for r in sp:
            def _c(key, row=r):
                v = row.get(key)
                return "-" if v is None else str(v)
            vis = _c("visible_at_replica")
            if r.get("replica") is not None and vis != "-":
                vis += f" (r{r['replica']})"
            lines.append(
                f"| {r['event_id']} | {_c('accepted')} | "
                f"{_c('journaled')} | {_c('compiled')} | "
                f"{_c('first_detection')} | {_c('removal')} | "
                f"{vis} | {_c('latency_ticks')} |")
        xc = report.get("span_crosscheck")
        if xc:
            lines += ["", "span ↔ oracle cross-check:", "",
                      "| event | latency supported | removal in "
                      "window | ordered | consistent |",
                      "|---|---|---|---|---|"]
            for r in xc:
                def _b(key, row=r):
                    v = row.get(key)
                    return "-" if v is None else ("ok" if v
                                                  else "FAIL")
                lines.append(
                    f"| {r['event_id']} | {_b('latency_supported')} |"
                    f" {_b('removal_in_window')} | {_b('ordered')} | "
                    f"{'ok' if r['consistent'] else 'FAIL'} |")
        lines.append("")
    if sc:
        lines += [f"## Scenario oracle — {sc.get('scenario', '?')}", "",
                  "| metric | value |", "|---|---|"]
        for i, p in enumerate(sc.get("partitions", ())):
            lines += _md_kv({f"partition[{i}].{k}": v
                             for k, v in p.items()})
        for i, c in enumerate(sc.get("crashes", ())):
            lines += _md_kv({f"crash[{i}].{k}": v for k, v in c.items()})
        for i, rr in enumerate(sc.get("restarts", ())):
            lines += _md_kv({f"restart[{i}].{k}": v
                             for k, v in rr.items()})
        if sc.get("final"):
            lines += _md_kv({f"final.{k}": v
                             for k, v in sc["final"].items()})
        inv = sc.get("invariants")
        if inv:
            # Hard verdicts (scenario/oracle.py): the chaos campaign's
            # grading contract, rendered per invariant.
            for name, v in inv.items():
                mark = ("FAIL" if not v.get("ok") else
                        "pass" if v.get("assessed")
                        else "pass (not assessed)")
                lines += _md_kv({f"invariant.{name}": mark})
            lines += _md_kv(
                {"verdict": "ok" if sc.get("ok") else "VIOLATED: "
                 + ", ".join(sc.get("violations", ()))})
        lines.append("")
    ds = report.get("detection_summary")
    if ds:
        lines += ["## Detection summary", "",
                  "| metric | value |", "|---|---|"]
        lines += _md_kv({k: v for k, v in ds.items()
                         if not isinstance(v, dict)})
        lines.append("")
    slo = report.get("slo")
    if slo:
        verdict = ("PASS" if slo["passed"] else
                   "no data" if slo["passed"] is None else "FAIL")
        lines += ["## Detection-latency SLO", "",
                  f"**{verdict}** — max CDF deviation "
                  f"{slo['max_cdf_deviation']:.4f} vs threshold "
                  f"{slo['threshold']:.2f} "
                  f"({slo['detections_total']} detections)", "",
                  "| latency (ticks) | observed | reference |",
                  "|---|---|---|"]
        for k in sorted(set(slo["observed"]) | set(slo["reference"])):
            lines.append(f"| {k} | {slo['observed'].get(k, 0)} | "
                         f"{slo['reference'].get(k, 0)} |")
        lines.append("")
    rc = report.get("reconciliation")
    if rc:
        lines += ["## Timeline ↔ summary reconciliation", "",
                  "| check | ok |", "|---|---|"]
        lines += _md_kv(rc)
        lines.append("")
    qt = report.get("query_tier")
    if qt:
        lines += ["## Query tier (read replicas)", "",
                  f"aggregate **{qt['qps_total']} q/s**, snapshot "
                  f"lag max **{qt['tick_lag_max']}** tick(s)", "",
                  "| replica | port | q/s | p50 ms | p99 ms | "
                  "snapshot tick | gen | lag | status |",
                  "|---|---|---|---|---|---|---|---|---|"]
        for r in qt["replicas"]:
            lines.append(
                f"| {r.get('index')} | {r.get('port')} | "
                f"{r.get('qps', '-')} | {r.get('p50_ms', '-')} | "
                f"{r.get('p99_ms', '-')} | "
                f"{r.get('snapshot_tick', '-')} | "
                f"{r.get('snapshot_gen', '-')} | "
                f"{r.get('tick_lag', '-')} | "
                f"{'stale' if r['stale'] else r.get('engine_status')} |")
        lines.append("")
    rsh = report.get("reshard")
    if rsh:
        lines += ["## Elastic reshard provenance", "",
                  "| tick | from shape/procs | to shape/procs | "
                  "carry digest |", "|---|---|---|---|"]
        for r in rsh:
            lines.append(
                f"| {r.get('tick')} | {r.get('from_shape') or '(auto)'}"
                f"/{r.get('from_procs')}p | "
                f"{r.get('to_shape') or '(auto)'}/{r.get('to_procs')}p "
                f"| {str(r.get('carry_digest', ''))[:16]} |")
        lines.append("")
    seg = report.get("segments")
    if seg:
        lines += ["## Segment timings (chunked driver)", "",
                  "| metric | value |", "|---|---|"]
        lines += _md_kv(seg)
        lines.append("")
    lad = report.get("ladder")
    if lad:
        lines += ["## Ladder rungs", "",
                  "| rung | status | starts | timeouts | retries | "
                  "resumes | node-ticks/s |",
                  "|---|---|---|---|---|---|---|"]
        for name, r in sorted(lad["rungs"].items()):
            lines.append(
                f"| {name} | {r['status']} | {r['starts']} | "
                f"{r['timeouts']} | {r['retries']} | {r['resumes']} | "
                f"{r.get('node_ticks_per_sec', '')} |")
        tail = {k: v for k, v in lad.items() if k != "rungs"}
        if tail:
            lines += [""] + ["| metric | value |", "|---|---|"]
            lines += _md_kv(tail)
        lines.append("")
    if len(lines) <= 2:
        lines.append("(no recorder artifacts found)")
    return "\n".join(lines)


def render_compare_markdown(cmp: dict) -> str:
    lines = ["# Recorder compare", "",
             f"- A: `{cmp['a']}`", f"- B: `{cmp['b']}`",
             f"- identical: **{cmp['identical']}**", ""]
    if cmp["only_in_a"]:
        lines.append(f"- only in A: {', '.join(cmp['only_in_a'])}")
    if cmp["only_in_b"]:
        lines.append(f"- only in B: {', '.join(cmp['only_in_b'])}")
    lines += ["", "| series | ticks A | ticks B | first divergence | "
              "diverging ticks |", "|---|---|---|---|---|"]
    for f, e in cmp["series"].items():
        first = "—" if e["first_divergence"] is None else e["first_divergence"]
        lines.append(f"| {f} | {e['ticks_a']} | {e['ticks_b']} | "
                     f"{first} | {e['diverging_ticks']} |")
    return "\n".join(lines)


def is_fleet_root(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, "fleet_runs.jsonl"))


def _tail_field(path: str, field: str):
    """``field`` from the last parseable row of a JSONL file (reads
    only the tail; torn-tolerant like every reader here)."""
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            fh.seek(max(fh.tell() - 8192, 0))
            lines = fh.read().decode(errors="replace").splitlines()
    except OSError:
        return None
    for line in reversed(lines):
        try:
            return json.loads(line).get(field)
        except json.JSONDecodeError:
            continue
    return None


def fleet_report(root: str) -> dict:
    """Per-run status rows for a fleet root.

    STRICTLY read-only: the controller's own recovery journals
    transitions, a reporter must not — so this is a local journal
    replay (last submit/state row wins) refreshed from each run dir's
    ``run_state.json`` beacon (fresher tick for in-flight workers),
    ``timeline.jsonl`` tail (live census) and ``slo.json`` (verdict
    from a prior ``--slo`` pass), never the fleet's HTTP surface — it
    works on a dead fleet too."""
    from distributed_membership_tpu_torch.config import Params
    runs: dict = {}
    try:
        with open(os.path.join(root, "fleet_runs.jsonl")) as fh:
            lines = fh.read().splitlines()
    except OSError:
        lines = []
    for line in lines:
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue
        rid = row.get("run_id")
        if row.get("kind") == "submit" and rid:
            total = 0
            try:
                total = Params().parse(row.get("conf", ""),
                                       validate=False).TOTAL_TIME
            except (TypeError, ValueError):
                pass
            runs[rid] = {"run_id": rid, "state": "queued", "tick": 0,
                         "total": total, "seq": row.get("seq", 0)}
        elif row.get("kind") == "state" and rid in runs:
            runs[rid]["state"] = row.get("state", runs[rid]["state"])
            runs[rid]["tick"] = int(row.get("tick",
                                            runs[rid]["tick"]))
            # Migration provenance (elastic/migrate.py journals both
            # transitions with trigger + from/resume ticks).
            if row.get("state") == "migrating":
                runs[rid]["migrations"] = (
                    runs[rid].get("migrations", 0) + 1)
                runs[rid]["last_trigger"] = row.get("trigger", "")
            elif row.get("state") == "requeued":
                ft, rt = row.get("from_tick"), row.get("resume_tick")
                if ft is not None and rt is not None:
                    runs[rid]["downtime_ticks"] = (
                        runs[rid].get("downtime_ticks", 0)
                        + max(int(ft) - int(rt), 0))
    rows = []
    for rid in sorted(runs, key=lambda r: runs[r]["seq"]):
        row = runs[rid]
        run_dir = os.path.join(root, rid)
        st = read_beacon(os.path.join(run_dir, "run_state.json"))
        if st is not None:
            try:
                row["tick"] = max(row["tick"],
                                  int(st.get("tick", 0)))
            except (TypeError, ValueError):
                pass
        alerts = read_events(os.path.join(run_dir, "runlog.jsonl"),
                             kinds=("alert",))
        if alerts:
            row["alerts"] = len(alerts)
        live = _tail_field(os.path.join(run_dir, TIMELINE_NAME),
                           "live")
        if isinstance(live, list):     # chunked rows carry per-tick
            live = live[-1] if live else None       # lists; tail it
        row["live"] = live
        row["slo"] = None
        try:
            with open(os.path.join(run_dir, "slo.json")) as fh:
                row["slo"] = bool(json.load(fh).get("passed"))
        except (OSError, ValueError):
            pass
        replicas = [r for r in _replica_beacons(run_dir)
                    if not r["stale"]]
        if replicas:
            row["query_qps"] = round(sum(r.get("qps") or 0
                                         for r in replicas), 1)
            row["query_lag"] = max(
                (r["tick_lag"] for r in replicas
                 if r.get("tick_lag") is not None), default=None)
            row["query_replicas"] = len(replicas)
        rows.append(row)
    return {"root": root, "runs": rows}


def is_campaign_root(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, "campaign.jsonl"))


def campaign_report(root: str) -> dict:
    """Progress rows replayed from a chaos campaign's journal
    (chaos/campaign.py writes it torn-tolerantly; the replay skips any
    torn tail line).  Read-only like fleet_report — works on a live
    campaign AND a dead one."""
    from distributed_membership_tpu_torch.chaos.campaign import read_journal
    rep: dict = {"root": root, "digest": None, "mode": None,
                 "planned": None, "graded": 0, "violations": [],
                 "shrinking": [], "repros": [], "done": False,
                 "ok": None}
    shrunk = set()
    shrinking = []
    for row in read_journal(os.path.join(root, "campaign.jsonl")):
        kind = row.get("kind")
        if kind == "campaign":
            rep["digest"] = row.get("digest")
            rep["mode"] = row.get("mode")
            rep["planned"] = row.get("spec", {}).get("schedules")
        elif kind == "graded":
            rep["graded"] += 1
            if not row.get("ok"):
                rep["violations"].append(row.get("run_id"))
        elif kind == "shrinking":
            shrinking.append(row.get("run_id"))
        elif kind == "shrunk":
            shrunk.add(row.get("run_id"))
            rep["repros"].append(row.get("path"))
        elif kind == "done":
            rep["done"] = True
            rep["ok"] = row.get("ok")
    rep["shrinking"] = [r for r in shrinking if r not in shrunk]
    return rep


def render_campaign(report: dict) -> str:
    planned = report.get("planned")
    lines = [f"# campaign {report['root']} — "
             f"digest {report.get('digest') or '?'}"
             + (f" ({report['mode']})" if report.get("mode") else ""),
             f"graded {report['graded']}"
             + (f"/{planned}" if planned else "")
             + f"  violations {len(report['violations'])}"
             + f"  repros {len(report['repros'])}"]
    for rid in report["violations"]:
        lines.append(f"  VIOLATION {rid}")
    for rid in report["shrinking"]:
        lines.append(f"  shrinking {rid} ...")
    for path in report["repros"]:
        lines.append(f"  banked {path}")
    if report["done"]:
        lines.append("campaign done: "
                     + ("all invariants green" if report.get("ok")
                        else "violations found"))
    return "\n".join(lines)


def render_fleet(report: dict) -> str:
    lines = [f"# fleet {report['root']} — {len(report['runs'])} "
             "run(s)"]
    for r in report["runs"]:
        live = "-" if r["live"] is None else str(r["live"])
        slo = ("-" if r["slo"] is None
               else "pass" if r["slo"] else "FAIL")
        line = (f"{r['run_id']:<12} {r['state']:<13} "
                f"tick {r['tick']:>6}/{r['total']:<6} "
                f"live {live:<6} slo {slo}")
        if r.get("query_replicas"):
            lag = ("-" if r.get("query_lag") is None
                   else r["query_lag"])
            line += (f"  query {r['query_qps']} q/s "
                     f"x{r['query_replicas']} lag {lag}")
        if r.get("migrations"):
            line += (f"  mig x{r['migrations']}"
                     + (f" ({r['last_trigger']})"
                        if r.get("last_trigger") else "")
                     + (f" downtime {r['downtime_ticks']}t"
                        if r.get("downtime_ticks") is not None else ""))
        if r.get("alerts"):
            line += f"  ALERTS {r['alerts']}"
        lines.append(line)
    return "\n".join(lines)


def _root_report(directory: str, fleet: bool, campaign: bool):
    """Combined report + rendering for a directory that is a fleet
    root, a campaign root, or both (a fleet-backed campaign pointed at
    the same dir): campaign progress first, fleet rows alongside."""
    report: dict = {}
    parts = []
    if campaign:
        report["campaign"] = campaign_report(directory)
        parts.append(render_campaign(report["campaign"]))
    if fleet:
        report["fleet"] = fleet_report(directory)
        parts.append(render_fleet(report["fleet"]))
    if not campaign:
        report = report["fleet"]    # fleet-only: legacy JSON shape
    return report, "\n\n".join(parts)


def watch(args, iterations: int | None = None) -> int:
    """Poll-and-re-render loop (``--watch``).

    ``iterations`` caps the loop for tests; interactive use runs until
    KeyboardInterrupt (exit 0 — stopping a dashboard isn't an error).
    """
    i = 0
    fleet = bool(args.dir) and is_fleet_root(args.dir)
    campaign = bool(args.dir) and is_campaign_root(args.dir)
    try:
        while iterations is None or i < iterations:
            if fleet or campaign:
                report, text = _root_report(args.dir, fleet, campaign)
                if args.json:
                    text = json.dumps(report, indent=1)
            else:
                report = build_report(args.dir, args.ladder,
                                      slo=args.slo)
                text = (json.dumps(report, indent=1) if args.json
                        else render_markdown(report))
            if sys.stdout.isatty():
                sys.stdout.write("\x1b[2J\x1b[H")   # clear + home
            else:
                print(f"--- run_report watch #{i} ---")
            print(text, flush=True)
            i += 1
            if iterations is None or i < iterations:
                time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_membership_tpu_torch.run_report")
    ap.add_argument("--dir", default=None,
                    help="flight-recorder directory (TELEMETRY_DIR): "
                         "timeline.jsonl / summary.json / runlog.jsonl")
    ap.add_argument("--ladder", default=None,
                    help="ladder event log to render "
                         "(artifacts/ladder_events.jsonl)")
    ap.add_argument("--json", action="store_true",
                    help="print the report dict as JSON instead of "
                         "markdown")
    ap.add_argument("--out", default=None,
                    help="write the report to this file instead of "
                         "stdout")
    ap.add_argument("--slo", action="store_true",
                    help="add the detection-latency SLO verdict "
                         "(requires --dir with a hist-tier timeline); "
                         "also writes <dir>/slo.json")
    ap.add_argument("--compare", nargs=2, metavar=("DIR_A", "DIR_B"),
                    default=None,
                    help="diff two recorder directories series-by-series "
                         "and report the first diverging tick")
    ap.add_argument("--watch", action="store_true",
                    help="re-render every --interval seconds until "
                         "Ctrl-C (live view of a run in flight)")
    ap.add_argument("--interval", type=float, default=2.0, metavar="S",
                    help="polling period for --watch (default 2s)")
    args = ap.parse_args(argv)
    if args.watch and args.compare:
        ap.error("--watch and --compare are mutually exclusive")
    if args.watch and args.out:
        ap.error("--watch renders to stdout; drop --out")
    if args.compare:
        cmp = compare_dirs(*args.compare)
        text = (json.dumps(cmp, indent=1) if args.json
                else render_compare_markdown(cmp))
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(text + "\n")
            print(args.out)
        else:
            print(text)
        return 0 if cmp["identical"] else 2
    if not args.dir and not args.ladder:
        default_ladder = os.path.join(REPO, "artifacts",
                                      "ladder_events.jsonl")
        if os.path.exists(default_ladder):
            args.ladder = default_ladder
        else:
            ap.error("pass --dir and/or --ladder")

    if args.watch:
        return watch(args)

    if args.dir and (is_fleet_root(args.dir)
                     or is_campaign_root(args.dir)):
        report, text = _root_report(args.dir, is_fleet_root(args.dir),
                                    is_campaign_root(args.dir))
        if args.json:
            text = json.dumps(report, indent=1)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(text + "\n")
            print(args.out)
        else:
            print(text)
        return 0

    report = build_report(args.dir, args.ladder, slo=args.slo)
    if args.slo:
        if "slo" not in report:
            print("run_report: --slo needs a hist-tier timeline "
                  f"(TELEMETRY: hist) under {args.dir}", file=sys.stderr)
            return 2
        with open(os.path.join(args.dir, "slo.json"), "w") as fh:
            json.dump(report["slo"], fh, indent=1)
            fh.write("\n")
    text = (json.dumps(report, indent=1) if args.json
            else render_markdown(report))
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
        print(args.out)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
