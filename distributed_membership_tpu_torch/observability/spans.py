"""End-to-end span records for injected events (counterpart of the JAX
package's ``observability/spans.py``).

Every event accepted by ``POST /v1/events`` (service/events.py) gets a
trace through the stages an injection actually moves through:

  accepted            the POST passed validation (engine tick at accept)
  journaled           fsynced into service_events.jsonl — durable
  compiled            merged into a recompiled segment runner at a
                      boundary (the tick it takes effect from)
  first_detection     first tick >= the event's fire time where the
                      live timeline's ``detections`` series is non-zero
  removal             same, for the ``removals`` series
  visible_at_replica  a read replica served a snapshot at/after the
                      first-detection tick

Each stage is ONE appended JSONL line ``{"event_id", "stage", "tick",
"t_wall", ...}`` in ``spans.jsonl`` beside the run — the torn-tolerant
append/read posture of runlog.jsonl (a kill tears at most the trailing
line), and last-wins per (event_id, stage) so a resumed daemon may
re-stamp stages idempotently.  Event ids are deterministic in journal
order (``kind@time#seq``): a SIGKILL + ``--resume`` replays the journal
in the same order and re-derives the same ids, which is what keeps the
file consistent across lives (tests/test_torch_metrics_plane.py pins it).

The live stages (accepted/journaled/compiled) are stamped by the
service daemon; the observed stages (first_detection/removal/
visible_at_replica) are stamped OFF the engine thread by the watchdog
(observability/watchdog.py) from the flight-recorder timeline and the
replica beacons — the engine never does span work beyond an O(1)
append.  ``crosscheck`` reconciles span latencies against the scenario
oracle's detection verdicts in scripts/run_report.py.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

SPANS_NAME = "spans.jsonl"
STAGES = ("accepted", "journaled", "compiled", "first_detection",
          "removal", "visible_at_replica")


def event_id(ev: dict, seq: int) -> str:
    """Deterministic id: journal position + the event's own identity.

    ``seq`` is the event's 0-based position in the service journal —
    replaying the journal on resume reproduces the same ids, so resumed
    stamps land on the same spans."""
    t = ev.get("time", ev.get("start", "?"))
    return f"{ev.get('kind', '?')}@{t}#{seq}"


class SpanLog:
    """Append-only torn-tolerant JSONL span stream (runlog posture:
    one ``write`` per stamp, lead-newline repair after a torn tail)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def _tail_unterminated(self) -> bool:
        try:
            with open(self.path, "rb") as fh:
                fh.seek(-1, os.SEEK_END)
                return fh.read(1) != b"\n"
        except (OSError, ValueError):
            return False

    def stamp(self, eid: str, stage: str, tick: Optional[int] = None,
              **extra) -> dict:
        rec = {"event_id": eid, "stage": stage,
               "t_wall": round(time.time(), 3)}
        if tick is not None:
            rec["tick"] = int(tick)
        rec.update(extra)
        with self._lock:
            lead = "\n" if self._tail_unterminated() else ""
            try:
                with open(self.path, "a") as fh:
                    fh.write(lead + json.dumps(rec, default=str) + "\n")
            except OSError:
                pass            # spans are advisory; never kill the run
        return rec


def read_spans(path: str) -> Dict[str, Dict[str, dict]]:
    """→ {event_id: {stage: record}}, last-wins, torn lines skipped."""
    out: Dict[str, Dict[str, dict]] = {}
    if not os.path.exists(path):
        return out
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue        # torn trailing write
            eid, stage = rec.get("event_id"), rec.get("stage")
            if not eid or stage not in STAGES:
                continue
            out.setdefault(eid, {})[stage] = rec
    return out


def _first_nonzero_at_or_after(series: dict, field: str,
                               fire_tick: int) -> Optional[int]:
    vals = series.get(field)
    if vals is None:
        return None
    t0 = int(series.get("t0", 0))
    for i in range(max(fire_tick - t0, 0), len(vals)):
        if int(vals[i]) > 0:
            return t0 + i
    return None


def update_observed_stages(span_log: SpanLog,
                           spans: Dict[str, Dict[str, dict]],
                           series: Optional[dict],
                           replica_beacons: List[dict]) -> int:
    """Stamp the observed stages that have become decidable; → stamps
    written.  Idempotent: already-present stages are skipped, so the
    watchdog can call this at every evaluation (and a resumed run can
    call it over a spans file from a previous life)."""
    wrote = 0
    for eid, stages in spans.items():
        acc = stages.get("accepted")
        ev = (acc or {}).get("event") or {}
        fire = ev.get("time", ev.get("start"))
        if fire is None:
            continue
        det_tick = None
        if "first_detection" in stages:
            det_tick = stages["first_detection"].get("tick")
        elif series is not None:
            src = "detections"
            det_tick = _first_nonzero_at_or_after(
                series, "detections", int(fire))
            if det_tick is None:
                # EVENT_MODE full (the injection path) emits no
                # per-tick TRUE-detection scalar by design
                # (observability/timeline.py): the removal of the
                # crashed id IS the protocol's detection observation.
                src = "removals"
                det_tick = _first_nonzero_at_or_after(
                    series, "removals", int(fire))
            if det_tick is not None:
                span_log.stamp(eid, "first_detection", tick=det_tick,
                               latency_ticks=det_tick - int(fire),
                               source=src)
                wrote += 1
        if "removal" not in stages and series is not None:
            rm = _first_nonzero_at_or_after(series, "removals",
                                            int(fire))
            if rm is not None:
                span_log.stamp(eid, "removal", tick=rm)
                wrote += 1
        if ("visible_at_replica" not in stages and det_tick is not None
                and replica_beacons):
            best = None
            for b in replica_beacons:
                st = b.get("snapshot_tick")
                if isinstance(st, int) and st >= det_tick:
                    best = b if best is None else best
            if best is not None:
                span_log.stamp(eid, "visible_at_replica",
                               tick=best["snapshot_tick"],
                               replica=best.get("index"))
                wrote += 1
    return wrote


def crosscheck(spans: Dict[str, Dict[str, dict]],
               oracle_report: Optional[dict],
               series: Optional[dict] = None,
               tremove: Optional[int] = None) -> List[dict]:
    """Reconcile span stamps against the scenario oracle's verdicts
    (scenario/oracle.scenario_report) for every injected crash.

    Per crash event fired at tick T, three independently assessable
    consistency checks (unassessable ones pass vacuously — absence of
    an artifact stream is not an inconsistency, the oracle's own
    posture):

      * ``latency_supported`` — the span's detection latency
        (first_detection.tick − T) lands in a bucket the run's
        reconstructed h_latency distribution actually populated: the
        live trace and the flight recorder must tell the same story;
      * ``removal_in_window`` — when the oracle counted
        ``removals_within_2tremove`` for this crash, the span's
        removal stamp falls inside (T, T + 2*TREMOVE];
      * ``ordered`` — stage ticks are monotone: accepted <= compiled
        <= first_detection <= removal.

    → [{event_id, fire_tick, span_latency, ..., consistent}]."""
    from distributed_membership_tpu_torch.observability.latency_dist import (
        latency_counts)
    crashes = {}
    for c in (oracle_report or {}).get("crashes", []):
        crashes[int(c["time"])] = c
    counts = None
    if series is not None and "h_latency" in series:
        counts = latency_counts(series)
        if not counts.sum():
            # No detections recorded (EVENT_MODE full's injection
            # path): no distribution to support the span against —
            # unassessable, same posture as slo_verdict's None.
            counts = None
    out = []
    for eid in sorted(spans):
        stages = spans[eid]
        ev = (stages.get("accepted") or {}).get("event") or {}
        fire = ev.get("time")
        det = stages.get("first_detection")
        if fire is None or det is None or det.get("tick") is None:
            continue
        fire = int(fire)
        lat = int(det["tick"]) - fire
        row = {"event_id": eid, "fire_tick": fire,
               "span_latency": lat}
        checks = []
        if counts is not None:
            ok = bool(0 <= lat < len(counts) and counts[lat] > 0)
            row["latency_supported"] = ok
            checks.append(ok)
        chk = crashes.get(fire)
        rm = stages.get("removal", {}).get("tick")
        if (chk is not None and tremove
                and chk.get("removals_within_2tremove")):
            ok = rm is not None and fire < rm <= fire + 2 * tremove
            row["removal_tick"] = rm
            row["removal_in_window"] = ok
            checks.append(ok)
        order = [stages[s].get("tick") for s in
                 ("accepted", "compiled", "first_detection", "removal")
                 if s in stages and stages[s].get("tick") is not None]
        ok = all(a <= b for a, b in zip(order, order[1:]))
        row["ordered"] = ok
        checks.append(ok)
        row["consistent"] = all(checks)
        out.append(row)
    return out
