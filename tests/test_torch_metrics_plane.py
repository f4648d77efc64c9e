"""The port's metrics plane against the JAX package's, at tolerance 0.

Mirrors ``tests/test_metrics_plane.py`` on the modules this port has
(``observability/metricsbus.py``, ``beacon.py``, ``spans.py``,
``watchdog.py`` and the /metrics routes of the daemon and the replica;
the multi-process merge waits for its item, and the fleet union is
mirrored in ``tests/test_torch_fleet.py``):

* the registry's rendered text for the same instrument sequence equals
  the JAX package's, byte for byte, and ``parse_text``/``relabel`` give
  the same results on the same inputs (their errors included);
* the four watchdog rules on synthetic series give the JAX verdicts, and
  the thread's rising-edge dedup holds;
* spans: ``event_id``, ``read_spans`` of a torn file,
  ``update_observed_stages`` and ``crosscheck`` on the same inputs;
* beacons written by either package read back in the other, with the
  same tolerance of torn, stale, newer-version and dead-pid files;
* a replica's /metrics state, and a served run's /metrics and span
  lifecycle across a SIGTERM stop, a torn spans tail and a resume.
"""

import http.client
import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from distributed_membership_tpu.observability import beacon as jax_beacon
from distributed_membership_tpu.observability import metricsbus as jax_mb
from distributed_membership_tpu.observability import spans as jax_spans
from distributed_membership_tpu.observability import watchdog as jax_wd
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.observability import beacon
from distributed_membership_tpu_torch.observability import metricsbus
from distributed_membership_tpu_torch.observability import spans
from distributed_membership_tpu_torch.observability import watchdog as wd
from distributed_membership_tpu_torch.observability.runlog import (
    RunLog, read_events)
from distributed_membership_tpu_torch.observability.timeline import (
    TIMELINE_NAME, read_timeline)


# ---------------------------------------------------------------------------
# metricsbus: the same text as the JAX registry


def _fill(mb, constlabels):
    """One instrument sequence, applied to a registry of module ``mb``."""
    reg = mb.MetricsRegistry(constlabels=constlabels)
    q = reg.counter("dm_queries_total", "Queries served")
    t = reg.gauge("dm_engine_tick", "Engine tick")
    h = reg.histogram("dm_lat_ms", "Query latency", buckets=(1, 5, 0.25))
    q.inc()
    q.inc(3, route="census")
    q.set_total(17, route="member")
    t.set(30)
    t.set(2.5, shard='a"b\\c\nd')
    for v in (0.5, 7, 0.1, 5, 1e-9, 123456.789):
        h.observe(v)
    h.observe(3, route="census")
    reg.gauge("dm_empty", "No samples")
    return reg, q


@pytest.mark.parametrize("constlabels", [None, {"proc": "0"},
                                         {"replica": "2", "proc": "1"}])
def test_registry_text_matches_jax(constlabels):
    reg, q = _fill(metricsbus, constlabels)
    want, _ = _fill(jax_mb, constlabels)
    assert reg.render() == want.render()
    assert metricsbus.parse_text(reg.render()) == jax_mb.parse_text(
        want.render())
    assert reg.counter("dm_queries_total", "dup") is q
    with pytest.raises(ValueError, match="different type"):
        reg.gauge("dm_queries_total", "flip")
    assert metricsbus.MetricsRegistry().render() == ""


def test_registry_golden_text():
    reg = metricsbus.MetricsRegistry(constlabels={"proc": "0"})
    q = reg.counter("dm_queries_total", "Queries served")
    t = reg.gauge("dm_engine_tick", "Engine tick")
    h = reg.histogram("dm_lat_ms", "Query latency", buckets=(1, 5))
    q.inc()
    q.inc()
    t.set(30)
    h.observe(0.5)
    h.observe(7)
    assert reg.render() == (
        "# HELP dm_queries_total Queries served\n"
        "# TYPE dm_queries_total counter\n"
        'dm_queries_total{proc="0"} 2\n'
        "# HELP dm_engine_tick Engine tick\n"
        "# TYPE dm_engine_tick gauge\n"
        'dm_engine_tick{proc="0"} 30\n'
        "# HELP dm_lat_ms Query latency\n"
        "# TYPE dm_lat_ms histogram\n"
        'dm_lat_ms_bucket{proc="0",le="1"} 1\n'
        'dm_lat_ms_bucket{proc="0",le="5"} 1\n'
        'dm_lat_ms_bucket{proc="0",le="+Inf"} 2\n'
        'dm_lat_ms_sum{proc="0"} 7.5\n'
        'dm_lat_ms_count{proc="0"} 2\n')


PARSE_CASES = {
    "plain": "dm_x 1\n",
    "labels": 'dm_y{a="1",b="x,y"} 2.5\n# HELP dm_y y\n\n',
    "escapes": 'dm_z{name="a\\"b\\\\c\\nd"} -3e-05\n',
    "inf": 'dm_h_bucket{le="+Inf"} 4\ndm_h_sum 1.5\n',
    "too_many_fields": "dm_x 1 2 3\n",
    "empty_value": "dm_x{a=} 1\n",
    "not_a_number": "dm_x nope\n",
    "unterminated": 'dm_x{a="1} 1\n',
    "junk_after_label": 'dm_x{a="1"b="2"} 1\n',
}


@pytest.mark.parametrize("case", list(PARSE_CASES))
def test_parse_text_matches_jax(case):
    text = PARSE_CASES[case]
    try:
        want = jax_mb.parse_text(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            metricsbus.parse_text(text)
        assert str(got.value) == str(e)
        return
    assert metricsbus.parse_text(text) == want


@pytest.mark.parametrize("extra", [{"run_id": "fleet"},
                                   {"run_id": "r", "zone": "b"}, {}])
def test_relabel_matches_jax(extra):
    text = ('# HELP dm_y y\ndm_y{run_id="mine"} 1\n'
            "dm_z 2\n"
            'dm_w{a="x\\"y"} 3\n'
            "garbage line here\n"
            "\n")
    got = metricsbus.relabel(text, extra)
    assert got == jax_mb.relabel(text, extra)
    out = metricsbus.parse_text(got)
    assert out[("dm_y", (("run_id", "mine"),) + tuple(
        sorted((k, v) for k, v in extra.items() if k != "run_id")))] == 1


def test_parse_and_relabel_roundtrip():
    reg = metricsbus.MetricsRegistry()
    g = reg.gauge("dm_x", "x")
    g.set(1, name='a"b\\c')
    ((_, labels),) = metricsbus.parse_text(reg.render()).keys()
    assert labels == (("name", 'a"b\\c'),)
    text = ('# HELP dm_y y\ndm_y{run_id="mine"} 1\n'
            "dm_z 2\n")
    out = metricsbus.parse_text(
        metricsbus.relabel(text, {"run_id": "fleet"}))
    assert out[("dm_y", (("run_id", "mine"),))] == 1
    assert out[("dm_z", (("run_id", "fleet"),))] == 2


def test_latency_reservoir_and_scrape_rate_match_jax():
    got = metricsbus.LatencyReservoir(sample_every=4, window=8)
    want = jax_mb.LatencyReservoir(sample_every=4, window=8)
    assert got.percentiles() == want.percentiles()
    rng = np.random.default_rng(5)
    for i, ms in enumerate(rng.exponential(2.0, 40)):
        assert got.should_sample(i) == want.should_sample(i)
        got.record(float(ms))
        want.record(float(ms))
        assert got.percentiles() == want.percentiles()
    assert metricsbus.ScrapeRate().rate(0) == 0.0


# ---------------------------------------------------------------------------
# Watchdog: the pure rules on synthetic series, and the dedup


def _h(**bins):
    h = np.zeros((64,), np.int64)
    for k, v in bins.items():
        h[int(k[1:])] = v
    return h


RULE_CASES = {
    "rate_short": ("rule_tick_rate", ([100.0, 100.0, 10.0],)),
    "rate_collapse": ("rule_tick_rate", ([100.0, 2.0, 100.0, 100.0, 10.0],)),
    "rate_ok": ("rule_tick_rate", ([100.0, 100.0, 100.0, 80.0],)),
    "rate_even_median": ("rule_tick_rate", ([50.0, 100.0, 60.0, 80.0,
                                             20.0],)),
    "backlog_bouncing": ("rule_backlog", ([0.0, 2.0, 0.0, 2.0],)),
    "backlog_growing": ("rule_backlog", ([0.0, 1.0, 2.0, 3.0],)),
    "backlog_small": ("rule_backlog", ([0.1, 0.2, 0.3],)),
    "stale_none": ("rule_staleness", (None, 120)),
    "stale_ok": ("rule_staleness", (100, 120)),
    "stale_trip": ("rule_staleness", (200, 120)),
    "slo_none": ("rule_detection_slo", (None,)),
    "slo_no_hist": ("rule_detection_slo", ({"ticks": 1},)),
    "slo_zero": ("rule_detection_slo", ({"h_latency": _h()},)),
    "slo_reference": ("rule_detection_slo",
                      ({"h_latency": _h(b21=4, b22=4, b23=1)},)),
    "slo_off": ("rule_detection_slo", ({"h_latency": _h(b5=9)},)),
    "slo_shifted": ("rule_detection_slo",
                    ({"h_latency": _h(b21=3, b22=6)},)),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_watchdog_rules_match_jax(case):
    rule, args = RULE_CASES[case]
    got = getattr(wd, rule)(*args)
    assert got == getattr(jax_wd, rule)(*args)
    trips = {"rate_collapse", "rate_even_median", "backlog_growing",
             "stale_trip", "slo_off", "slo_shifted"}
    assert (got is not None) == (case in trips), got


class _StubParams:
    CHECKPOINT_EVERY = 30
    SERVICE_SNAPSHOT_EVERY = 1
    TELEMETRY_DIR = ""


class _StubState:
    def __init__(self, registry):
        self.params = _StubParams()
        self.tick = 60
        self.publisher = None
        self.stop_event = threading.Event()
        self.metrics = registry

    def timeline_path(self):
        return None


def test_watchdog_rising_edge_dedup(tmp_path):
    reg = metricsbus.MetricsRegistry()
    runlog = RunLog(str(tmp_path / "runlog.jsonl"))
    dog = wd.Watchdog(_StubState(reg), str(tmp_path), runlog=runlog)
    collapsed = [100.0, 100.0, 100.0, 100.0, 10.0]
    healthy = [100.0] * 5

    dog._segment_rates = lambda: collapsed
    dog.evaluate()
    dog.evaluate()          # still tripped: no second record
    assert dog.alert_counts() == {"tick_rate_collapse": 1}
    dog._segment_rates = lambda: healthy
    dog.evaluate()          # recovered: re-arms
    dog._segment_rates = lambda: collapsed
    dog.evaluate()
    assert dog.alert_counts() == {"tick_rate_collapse": 2}
    alerts = read_events(str(tmp_path / "runlog.jsonl"), kinds=("alert",))
    assert len(alerts) == 2
    assert alerts[0]["rule"] == "tick_rate_collapse"
    assert alerts[0]["boundary_tick"] == 60
    assert alerts[0]["rate_per_s"] == 10.0
    assert metricsbus.parse_text(reg.render())[
        ("dm_watchdog_alerts_total",
         (("rule", "tick_rate_collapse"),))] == 2


# ---------------------------------------------------------------------------
# Spans


_EVENTS = [{"kind": "crash", "time": 70, "nodes": [3]},
           {"kind": "drop_window", "start": 40, "stop": 60,
            "drop_prob": 0.5},
           {"kind": "restart", "time": 90, "nodes": [[0, 4]]},
           {"kind": "crash", "time": 10, "nodes": [1]},
           {"something": "else"}]


def test_event_ids_match_jax():
    for seq, ev in enumerate(_EVENTS):
        assert spans.event_id(ev, seq) == jax_spans.event_id(ev, seq)
    assert spans.event_id(_EVENTS[0], 0) == "crash@70#0"
    assert spans.STAGES == jax_spans.STAGES


def _series(ticks=120, t0=0):
    det = np.zeros((ticks,), np.int64)
    rem = np.zeros((ticks,), np.int64)
    rem[84 - t0] = 2
    rem[86 - t0] = 1
    det[20 - t0] = 1
    return {"t0": t0, "ticks": ticks, "detections": det, "removals": rem,
            "h_latency": _h(b14=1, b16=2)}


def _stamps(path):
    """The span file's records without their wall-clock field."""
    out = []
    with open(path) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                out.append(("torn", line.strip()))
                continue
            rec.pop("t_wall", None)
            out.append(rec)
    return out


@pytest.mark.parametrize("t0", [0, 5])
def test_spans_lifecycle_matches_jax(tmp_path, t0):
    results = {}
    for tag, mod in (("port", spans), ("jax", jax_spans)):
        path = str(tmp_path / tag / mod.SPANS_NAME)
        log = mod.SpanLog(path)
        for seq, ev in enumerate(_EVENTS[:4]):
            eid = mod.event_id(ev, seq)
            log.stamp(eid, "accepted", tick=0, event=ev)
            log.stamp(eid, "journaled", tick=0)
            log.stamp(eid, "compiled", tick=30)
        with open(path, "a") as fh:       # a torn tail
            fh.write('{"event_id": "crash@70#0", "stage": "rem')
        beacons = [{"index": 0, "snapshot_tick": 60},
                   {"index": 1, "snapshot_tick": 90}]
        wrote = mod.update_observed_stages(
            log, mod.read_spans(path), _series(t0=t0), beacons)
        again = mod.update_observed_stages(
            log, mod.read_spans(path), _series(t0=t0), beacons)
        span_map = mod.read_spans(path)
        oracle = {"crashes": [{"time": 70, "removals_within_2tremove": 3},
                              {"time": 10}]}
        rows = mod.crosscheck(span_map, oracle, series=_series(t0=t0),
                              tremove=20)
        for stages in span_map.values():
            for rec in stages.values():
                rec.pop("t_wall")
        results[tag] = (wrote, again, span_map, rows, _stamps(path))
    assert results["port"] == results["jax"]
    wrote, again, span_map, rows, _ = results["port"]
    assert wrote > 0 and again == 0
    assert span_map["crash@70#0"]["first_detection"]["source"] == "removals"
    assert any(r["event_id"] == "crash@70#0" for r in rows)


# ---------------------------------------------------------------------------
# Beacons, across the two packages


def test_beacons_read_across_packages(tmp_path):
    for writer, reader in ((beacon, jax_beacon), (jax_beacon, beacon)):
        path = str(tmp_path / f"{writer.__name__}.json")
        assert writer.write_beacon(path, {"port": 5, "pid": os.getpid()})
        doc = reader.read_beacon(path, max_age_s=60, require_pid="pid")
        assert doc["port"] == 5 and doc["v"] == 1
        assert reader.read_beacon(path, max_age_s=-1) is None   # stale
    torn = tmp_path / "torn.json"
    torn.write_text('{"port": ')
    newer = tmp_path / "newer.json"
    newer.write_text(json.dumps({"v": 99, "port": 1}))
    dead = tmp_path / "dead.json"
    dead.write_text(json.dumps({"pid": 2**22 + 12345, "time": time.time()}))
    untimed = tmp_path / "untimed.json"
    untimed.write_text(json.dumps({"port": 3}))
    listy = tmp_path / "list.json"
    listy.write_text("[1, 2]")
    for path, kw in ((torn, {}), (newer, {}), (dead, {"require_pid": "pid"}),
                     (untimed, {"max_age_s": 10}), (listy, {}),
                     (tmp_path / "missing.json", {})):
        assert beacon.read_beacon(str(path), **kw) is None
        assert jax_beacon.read_beacon(str(path), **kw) is None
    assert beacon.read_beacon(str(untimed)) == {"port": 3}
    assert beacon.pid_alive(os.getpid()) and not beacon.pid_alive("x")
    # A write that cannot land reports False instead of raising.
    assert beacon.write_beacon(str(tmp_path / "no" / "dir.json"), {}) is False


# ---------------------------------------------------------------------------
# The read replica's /metrics state (ring-fed, const replica label)


def test_replica_metrics_surface():
    from test_torch_query_tier import World
    from distributed_membership_tpu_torch.service import shm_ring
    from distributed_membership_tpu_torch.service.replica import (
        ReplicaState)

    w = World(16, 4, 4, seed=7)
    w.started[:] = True
    snap = w.snap()
    snap.precompute(None)
    writer = shm_ring.ShmRingWriter(16, 4, np.uint32, np.int32, 4, 100, 2)
    reader = None
    state = None
    try:
        writer.set_engine("running", 42, 1)
        writer.publish(snap, None)
        reader = shm_ring.ShmRingReader(writer.name)
        state = ReplicaState(reader, index=2, timeline=None)
        state.count_query()
        parsed = metricsbus.parse_text(state.metrics_text())
        lbl = (("replica", "2"),)
        assert parsed[("dm_queries_total", lbl)] == 1
        assert parsed[("dm_engine_tick", lbl)] == 42
        assert parsed[("dm_snapshot_tick", lbl)] == snap.tick
        assert parsed[("dm_snapshot_lag_ticks", lbl)] == 42 - snap.tick
    finally:
        if state is not None:       # release the shm views first
            state.store._cached = None
        if reader is not None:
            reader.close()
        writer.close()


# ---------------------------------------------------------------------------
# Served end to end: /metrics mid-run and the span lifecycle across a
# boundary stop, a torn spans tail and a resume


def _get_text(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return (resp.status, resp.getheader("Content-Type"),
                resp.read().decode())
    finally:
        conn.close()


def test_served_metrics_and_span_lifecycle_across_resume(tmp_path,
                                                         monkeypatch):
    from test_torch_service import (
        EVENT, SEED, gate_boundaries, post, served, svc_params,
        wait_health)
    from distributed_membership_tpu_torch.service import daemon

    gates = gate_boundaries(monkeypatch, daemon)
    p = svc_params(Params, tmp_path, "m")
    out = tmp_path / "m"
    out.mkdir()
    span_path = str(out / spans.SPANS_NAME)
    box = {}

    def life1(port):
        wait_health(port, lambda h: h["snapshot_tick"] is not None)
        code, reply = post(port, "/v1/events", EVENT)
        assert code == 202 and reply["journaled"] is True
        code, ctype, text = _get_text(port, "/metrics")
        assert code == 200
        assert ctype == "text/plain; version=0.0.4; charset=utf-8"
        m = metricsbus.parse_text(text)
        assert m[("dm_engine_tick", ())] == 0
        assert m[("dm_run_total_ticks", ())] == 120
        assert m[("dm_pending_events", ())] == 1
        assert m[("dm_queries_total", ())] >= 1
        try:
            gates[0].set()
            wait_health(port, lambda h: h["snapshot_tick"] == 30)
            signal.raise_signal(signal.SIGTERM)
        finally:
            for g in gates.values():
                g.set()

    rc, _ = served(lambda: daemon.serve_run(p, seed=SEED, out_dir=str(out),
                                            device="cpu"),
                   str(out), life1)
    assert rc == 0
    eid = spans.event_id(EVENT, 0)
    first = spans.read_spans(span_path)
    assert set(first[eid]) == {"accepted", "journaled", "compiled"}
    assert first[eid]["accepted"]["tick"] == 0
    assert first[eid]["compiled"]["tick"] == 30
    with open(span_path, "a") as fh:
        fh.write('{"event_id": "crash@70#0", "stage": "rem')

    def life2(port):
        h = wait_health(port, lambda h: h["status"] == "complete")
        assert h["applied_events"] == 1
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            got = spans.read_spans(span_path).get(eid, {})
            if {"first_detection", "removal"} <= set(got):
                break
            time.sleep(0.2)
        _, _, text = _get_text(port, "/metrics")
        box["metrics"] = metricsbus.parse_text(text)

    pr = svc_params(Params, tmp_path, "m", resume=1)
    rc, _ = served(lambda: daemon.serve_run(pr, seed=SEED, out_dir=str(out),
                                            device="cpu"),
                   str(out), life2)
    assert rc == 0
    assert box["metrics"][("dm_engine_tick", ())] == 120
    assert box["metrics"][("dm_applied_events", ())] == 1
    stages = spans.read_spans(span_path)[eid]
    assert {"accepted", "journaled", "compiled", "first_detection",
            "removal"} <= set(stages)
    assert stages["accepted"]["tick"] == 0
    assert stages["compiled"]["tick"] == 30
    det = stages["first_detection"]
    assert det["tick"] >= EVENT["time"]
    assert det["latency_ticks"] == det["tick"] - EVENT["time"]
    assert det["source"] == "removals"
    assert stages["removal"]["tick"] >= det["tick"]
    with open(tmp_path / "m_tl" / "scenario.json") as fh:
        oracle = json.load(fh)
    series = read_timeline(str(tmp_path / "m_tl" / TIMELINE_NAME))
    span_map = spans.read_spans(span_path)
    (row,) = spans.crosscheck(span_map, oracle, series=series,
                              tremove=p.TREMOVE)
    assert row == jax_spans.crosscheck(span_map, oracle, series=series,
                                       tremove=p.TREMOVE)[0]
    assert row["event_id"] == eid and row["fire_tick"] == 70
    assert row["ordered"] is True and row["consistent"] is True, row
