"""Mid-run SLO watchdog: degradation alerts while the run is alive
(counterpart of the JAX package's ``observability/watchdog.py``).

Every SLO this repo can grade — detection-latency distribution, replica
staleness, oracle invariants — used to be computed AFTER the run, in
run_report/the campaign grader.  The watchdog moves the cheap rule
evaluations into the run itself: a daemon thread owned by the service
daemon (service/daemon.py) wakes at every segment boundary (the engine
hook's ``notify`` is one Event.set — O(1) on the engine thread) and
evaluates four rules off-thread:

  ``tick_rate_collapse``   the latest segment's tick rate fell below
                           half the rolling median of earlier segments
  ``publisher_backlog``    the snapshot publisher's submitted-vs-
                           published gap grew monotonically across the
                           last evaluations (the engine is lapping the
                           query tier)
  ``replica_staleness``    a live replica beacon serves a snapshot
                           more than STALENESS_FACTOR snapshot periods
                           behind the engine tick
  ``detection_slo``        the live ``h_latency`` reconstruction
                           (hist tier) fails the banked reference SLO
                           (observability/latency_dist.slo_verdict)

Alerts are structured runlog records (``kind: "alert"`` —
observability/runlog.py) with rising-edge dedup: a rule alerts once
when it trips and re-arms only after it recovers, so a 500-boundary
stall is one record, not 500.  scripts/run_report.py renders them as
timeline markers; the fleet summary counts them per run.  The rule
functions are pure (inputs in, verdict-or-None out) so the unit tests
(tests/test_torch_metrics_plane.py) drive them with synthetic degradation —
no run needed.

The thread also owns the observed span stages (observability/spans.py
``update_observed_stages``) and the segment-timing metrics gauges:
everything that needs the timeline, the runlog, or the replica beacons
happens here, never on the engine thread.
"""

from __future__ import annotations

import glob
import os
import re
import threading
import time
from typing import List, Optional, Sequence

from distributed_membership_tpu_torch.observability.beacon import read_beacon

TICK_RATE_MIN_SEGMENTS = 4       # baseline needs this many rates
TICK_RATE_COLLAPSE_FRACTION = 0.5
BACKLOG_GROWTH_EVALS = 3         # strictly-growing evals that trip
BACKLOG_MIN_TICKS = 2            # ... and the gap must reach this
STALENESS_FACTOR = 4             # x the snapshot period, in ticks
BEACON_FRESH_S = 10.0            # replica beacons older than this are
                                 # some dead replica's leftovers
EVAL_INTERVAL_S = 2.0            # idle re-evaluation period


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


# ---- pure rules (unit-testable with synthetic inputs) -----------------

def rule_tick_rate(rates: Sequence[float],
                   min_segments: int = TICK_RATE_MIN_SEGMENTS,
                   fraction: float = TICK_RATE_COLLAPSE_FRACTION
                   ) -> Optional[dict]:
    """``rates`` is the per-segment ticks/s history, oldest first.
    Trips when the latest rate collapses below ``fraction`` x the
    median of the earlier ones (median, not mean: one slow compile
    segment must not drag the baseline down with it)."""
    if len(rates) < min_segments:
        return None
    baseline = _median(rates[:-1])
    latest = rates[-1]
    if baseline > 0 and latest < fraction * baseline:
        return {"rule": "tick_rate_collapse", "severity": "warn",
                "rate_per_s": round(latest, 2),
                "baseline_per_s": round(baseline, 2)}
    return None


def rule_backlog(backlogs: Sequence[float],
                 evals: int = BACKLOG_GROWTH_EVALS,
                 min_ticks: float = BACKLOG_MIN_TICKS
                 ) -> Optional[dict]:
    """``backlogs`` is the submitted-minus-published tick gap at each
    evaluation, oldest first.  A transiently busy publisher bounces
    between 0 and one period — only a STRICTLY growing gap across
    ``evals`` observations (reaching ``min_ticks``) means the engine
    is durably outrunning the query tier."""
    if len(backlogs) < evals:
        return None
    tail = list(backlogs[-evals:])
    if all(x < y for x, y in zip(tail, tail[1:])) \
            and tail[-1] >= min_ticks:
        return {"rule": "publisher_backlog", "severity": "warn",
                "backlog_ticks": tail[-1], "history": tail}
    return None


def rule_staleness(lag_ticks: Optional[float], bound_ticks: float
                   ) -> Optional[dict]:
    """``lag_ticks`` is the worst fresh replica's engine-minus-snapshot
    tick gap (None = no fresh replica beacons, nothing to judge)."""
    if lag_ticks is None or lag_ticks <= bound_ticks:
        return None
    return {"rule": "replica_staleness", "severity": "warn",
            "lag_ticks": int(lag_ticks),
            "bound_ticks": int(bound_ticks)}


def rule_detection_slo(series: Optional[dict]) -> Optional[dict]:
    """The live SLO check over the hist tier's ``h_latency`` series
    (None/scalars-only runs are unassessable, never alerting)."""
    if series is None or "h_latency" not in series:
        return None
    from distributed_membership_tpu_torch.observability.latency_dist import (
        slo_verdict)
    v = slo_verdict(series)
    if v["passed"] is False:
        return {"rule": "detection_slo", "severity": "error",
                "max_cdf_deviation": round(v["max_cdf_deviation"], 4),
                "threshold": v["threshold"],
                "detections_total": v["detections_total"]}
    return None


# ---- the daemon-owned thread ------------------------------------------

class Watchdog(threading.Thread):
    """Boundary-driven evaluator bound to a serve_run's ControlState.

    ``state`` duck-type: ``params``, ``total``, ``tick``, ``publisher``
    (or None), ``stop_event``, ``metrics`` (a MetricsRegistry), and
    optionally ``spans`` (a SpanLog).  ``runlog`` receives the alert
    records; None disables emission but rules still evaluate (the
    alert counter still counts).
    """

    def __init__(self, state, out_dir: str, runlog=None,
                 interval_s: float = EVAL_INTERVAL_S):
        super().__init__(daemon=True, name="slo-watchdog")
        self.state = state
        self.out_dir = out_dir
        self.runlog = runlog
        self.interval_s = interval_s
        self._wake = threading.Event()
        self._closing = False
        self._marks: List[tuple] = []      # (t_mono, tick) per notify
        self._backlogs: List[float] = []
        self._active = set()               # rules currently tripped
        self._lock = threading.Lock()
        self.alerts: List[dict] = []       # emitted (rising edges)
        p = state.params
        self.snapshot_period = max(
            p.CHECKPOINT_EVERY * max(p.SERVICE_SNAPSHOT_EVERY, 1), 1)
        self._m_alerts = state.metrics.counter(
            "dm_watchdog_alerts_total",
            "Watchdog alert rising edges by rule")
        self._m_rate = state.metrics.gauge(
            "dm_tick_rate_per_sec",
            "Engine ticks per second over the latest segment")
        self._m_wall = state.metrics.gauge(
            "dm_segment_wall_seconds",
            "Latest segment wall time (runlog)")
        self._m_sync = state.metrics.gauge(
            "dm_segment_device_sync_seconds",
            "Latest segment device-sync seconds (runlog)")
        self._m_ckpt = state.metrics.gauge(
            "dm_segment_ckpt_wait_seconds",
            "Latest segment checkpoint-wait seconds (runlog)")

    # O(1), called from the engine thread's boundary hook.
    def notify(self, tick: int) -> None:
        with self._lock:
            self._marks.append((time.monotonic(), int(tick)))
            if len(self._marks) > 256:
                del self._marks[:len(self._marks) - 256]
        self._wake.set()

    def close(self) -> None:
        self._closing = True
        self._wake.set()

    def alert_counts(self) -> dict:
        out: dict = {}
        for a in self.alerts:
            out[a["rule"]] = out.get(a["rule"], 0) + 1
        return out

    # ---- evaluation ---------------------------------------------------

    def _segment_rates(self) -> List[float]:
        with self._lock:
            marks = list(self._marks)
        rates = []
        for (t0, a), (t1, b) in zip(marks, marks[1:]):
            if t1 > t0 and b > a:
                rates.append((b - a) / (t1 - t0))
        return rates

    def _replica_lag(self) -> Optional[int]:
        worst = None
        for path in glob.glob(os.path.join(self.out_dir,
                                           "replica_*.json")):
            if not re.fullmatch(r"replica_\d+\.json",
                                os.path.basename(path)):
                continue
            doc = read_beacon(path, max_age_s=BEACON_FRESH_S)
            if doc is None:
                continue
            lag = doc.get("tick_lag")
            if isinstance(lag, (int, float)):
                worst = lag if worst is None else max(worst, lag)
        return worst

    def _timeline_series(self) -> Optional[dict]:
        path = self.state.timeline_path()
        if not path or not os.path.exists(path):
            return None
        from distributed_membership_tpu_torch.observability.timeline import (
            read_timeline)
        try:
            return read_timeline(path)
        except Exception:
            return None

    def _replica_beacons(self) -> List[dict]:
        out = []
        for path in sorted(glob.glob(os.path.join(
                self.out_dir, "replica_*.json"))):
            if not re.fullmatch(r"replica_\d+\.json",
                                os.path.basename(path)):
                continue
            doc = read_beacon(path, max_age_s=BEACON_FRESH_S)
            if doc is not None:
                out.append(doc)
        return out

    def _segment_gauges(self) -> None:
        tel_dir = self.state.params.TELEMETRY_DIR or None
        if not tel_dir:
            return
        from distributed_membership_tpu_torch.observability.runlog import (
            read_events)
        try:
            segs = read_events(os.path.join(tel_dir, "runlog.jsonl"),
                               kinds=("segment",),
                               include_rotated=False)
        except OSError:
            return
        if not segs:
            return
        s = segs[-1]
        sync = float(s.get("device_sync_s", 0.0))
        flush = float(s.get("flush_s", 0.0))
        ckpt = float(s.get("ckpt_wait_s", 0.0))
        self._m_wall.set(round(sync + flush + ckpt, 4))
        self._m_sync.set(sync)
        self._m_ckpt.set(ckpt)

    def _emit(self, alert: Optional[dict], boundary_tick: int) -> None:
        """Rising-edge dedup + emission for one rule evaluation."""
        if alert is None:
            return
        rule = alert["rule"]
        if rule in self._active:
            return
        self._active.add(rule)
        rec = dict(alert)
        rec["boundary_tick"] = int(boundary_tick)
        self.alerts.append(rec)
        self._m_alerts.inc(rule=rule)
        if self.runlog is not None:
            try:
                self.runlog.event("alert", **rec)
            except OSError:
                pass

    def evaluate(self) -> None:
        state = self.state
        tick = int(state.tick)
        rates = self._segment_rates()
        if rates:
            self._m_rate.set(round(rates[-1], 2))
        self._segment_gauges()

        backlog = 0.0
        pub = state.publisher
        if pub is not None:
            backlog = float(pub.backlog_ticks())
        self._backlogs.append(backlog)
        if len(self._backlogs) > 64:
            del self._backlogs[:len(self._backlogs) - 64]

        series = self._timeline_series()
        lag = self._replica_lag()

        verdicts = {
            "tick_rate_collapse": rule_tick_rate(rates),
            "publisher_backlog": rule_backlog(self._backlogs),
            "replica_staleness": rule_staleness(
                lag, STALENESS_FACTOR * self.snapshot_period),
            "detection_slo": rule_detection_slo(series),
        }
        for rule, alert in verdicts.items():
            if alert is None:
                self._active.discard(rule)   # recovered: re-arm
            else:
                self._emit(alert, tick)

        span_log = getattr(state, "spans", None)
        if span_log is not None:
            from distributed_membership_tpu_torch.observability.spans import (
                read_spans, update_observed_stages)
            try:
                update_observed_stages(
                    span_log, read_spans(span_log.path), series,
                    self._replica_beacons())
            except Exception:
                pass        # spans are advisory; keep evaluating

    def run(self) -> None:
        while not self._closing and not self.state.stop_event.is_set():
            self._wake.wait(self.interval_s)
            self._wake.clear()
            if self._closing:
                break
            try:
                self.evaluate()
            except Exception:
                # The watchdog must never take the run down with it.
                pass
        # Final pass so stamps/alerts for the last boundary land.
        try:
            self.evaluate()
        except Exception:
            pass
