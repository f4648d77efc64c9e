"""The port's query tier against the JAX package's, at tolerance 0.

Mirrors ``tests/test_query_tier.py`` (its fleet proxy test is mirrored
in ``tests/test_torch_fleet.py``):

* snapshots: the port's ``Snapshot`` (incremental and full derive) gives
  the JAX package's census and member documents on the same synthetic
  worlds, and at every published boundary of an N=256 served ring run in
  agg and full events, where the port's and the JAX package's daemons
  publish the same documents; a synthetic carry whose ``view`` holds
  entries >= 2^31 decodes as the JAX package decodes it;
* the shm ring: round trip, delta row accounting, the seqlock, unlink,
  and a ring the port writes read by the JAX package's reader;
* served grading scenarios and a kill/resume chain: every published
  boundary equals the full-derive oracle, derived off the engine thread;
* the replica pool end to end (two replica processes): each replica's
  census equals the daemon's at the same tick, and no ring segment is
  left in /dev/shm after shutdown;
* ``scripts/run_report.py``'s query-tier rows from the port's run dir.
"""

import http.client
import json
import os
import pathlib
import signal
import socket
import struct
import sys
import threading
import time
import warnings

import numpy as np
import pytest

from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.service import daemon as jax_daemon
from distributed_membership_tpu.service import shm_ring as jax_shm_ring
from distributed_membership_tpu.service import snapshot as jax_snapshot
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.service import daemon, shm_ring
from distributed_membership_tpu_torch.service.snapshot import (
    Snapshot, decode_state)
from test_torch_service import (
    EVENT, SEED, gate_boundaries, get, post, record_snapshots, request,
    served, svc_params, wait_health)

REPO = pathlib.Path(__file__).resolve().parent.parent
TESTDIR = REPO / "testcases"
EVERY = 50


def _oracle(snap, cls=Snapshot):
    """A fresh snapshot of ``cls`` over the same arrays, fully derived
    (``failed = removed`` reproduces live/removed exactly)."""
    o = cls(snap.tick, snap.n, snap.tfail, started=snap.started,
            in_group=snap.in_group, failed=snap.removed,
            self_hb=snap.self_hb, view=snap._view, view_ts=snap._view_ts)
    assert np.array_equal(o.live, snap.live)
    assert np.array_equal(o.removed, snap.removed)
    o._derive()
    return o


def assert_byte_identical(snap, tag=""):
    o = _oracle(snap)
    assert o.census_json() == snap.census_json(), tag
    for name in ("known_by", "suspected_by", "best_hb", "staleness"):
        assert np.array_equal(getattr(snap, name), getattr(o, name)), (
            tag, name)
    assert np.array_equal(snap.suspected, o.suspected), tag
    for i in range(snap.n):
        assert snap.member(i) == o.member(i), (tag, i)


class World:
    """A synthetic packed-view world that evolves adversarially:
    heartbeat churn in a few rows, liveness flips, and content churn in
    rows that are dead on both sides of a boundary."""

    def __init__(self, n, s, tfail, seed, hb_max=None):
        rng = np.random.default_rng(seed)
        self.n, self.s, self.tfail, self.rng = n, s, tfail, rng
        self.tick = 6
        self.started = np.ones(n, bool)
        self.started[0] = False
        self.in_group = np.ones(n, bool)
        self.failed = np.zeros(n, bool)
        self.self_hb = rng.integers(0, self.tick + 1, n)
        member = rng.integers(0, n, (n, s))
        hb = rng.integers(0, (hb_max or self.tick) + 1, (n, s))
        self.view = (member + n * hb + 1).astype(np.uint32)
        self.view[rng.random((n, s)) < 0.12] = 0
        self.view_ts = rng.integers(0, self.tick + 1,
                                    (n, s)).astype(np.int32)

    def snap(self, cls=Snapshot):
        return cls(self.tick, self.n, self.tfail,
                   started=self.started.copy(), in_group=self.in_group.copy(),
                   failed=self.failed.copy(), self_hb=self.self_hb.copy(),
                   view=self.view.copy(), view_ts=self.view_ts.copy())

    def _churn_row(self, r):
        rng, n = self.rng, self.n
        cols = rng.integers(0, self.s, 3)
        m = rng.integers(0, n, 3)
        hb = rng.integers(max(self.tick - 6, 0), self.tick + 1, 3)
        self.view[r, cols] = (m + n * hb + 1).astype(np.uint32)
        self.view_ts[r, cols] = rng.integers(max(self.tick - 6, 0),
                                             self.tick + 1, 3)

    def step(self):
        rng = self.rng
        self.tick += int(rng.integers(1, 5))
        for r in rng.integers(1, self.n, int(rng.integers(1, 5))):
            self._churn_row(int(r))
        if rng.random() < 0.5:
            i = int(rng.integers(1, self.n))
            self.failed[i] = not self.failed[i]
        self._churn_row(0)


def _docs(snap):
    return snap.census_json(), [snap.member(i) for i in range(snap.n)]


@pytest.mark.parametrize("n", [64, 48])     # pow2 and divmod unpack
def test_incremental_derive_matches_full_and_jax(n):
    w = World(n, 8, tfail=4, seed=n)
    prev, jprev = w.snap(), w.snap(jax_snapshot.Snapshot)
    assert prev.derive_incremental(None) is False
    prev.precompute(None)
    jprev.precompute(None)
    assert prev.derive_info["mode"] == "full"
    assert _docs(prev) == _docs(jprev)
    assert_byte_identical(prev, "first")
    for step in range(14):
        w.step()
        cur, jcur = w.snap(), w.snap(jax_snapshot.Snapshot)
        cur.precompute(prev)
        jcur.precompute(jprev)
        assert cur.derive_info["mode"] == "delta", step
        assert _docs(cur) == _docs(jcur), step
        assert_byte_identical(cur, f"step {step}")
        prev, jprev = cur, jcur
    stale = w.snap()
    stale.tick = prev.tick - 1
    assert stale.derive_incremental(prev) is False
    stale.precompute(prev)
    assert stale.derive_info["mode"] == "full"


@pytest.mark.parametrize("size,minlength", [(0, 5), (3, 0), (7, 4),
                                             (1000, 64), (1001, 2000)])
def test_sliced_bincount_equals_numpy(monkeypatch, size, minlength):
    """The derive's bincount, counted in slices so the GIL changes hands,
    equals one ``np.bincount`` (values, length and dtype)."""
    from distributed_membership_tpu_torch.service import snapshot
    monkeypatch.setattr(snapshot, "_BINCOUNT_SLICE", 8)
    x = np.random.default_rng(size).integers(0, 100, size)
    got = snapshot._bincount(x, minlength)
    want = np.bincount(x, minlength=minlength)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_view_entries_past_2_31_decode_as_jax():
    """A carry whose view holds packed entries >= 2^31 (heartbeats past
    2047 at N = 2^20; here N = 64 with heartbeats past 2^25): the port
    keeps the view as int32 bits on the device, ``pull_snapshot`` hands
    uint32 over, and the documents equal the JAX package's on the uint32
    plane.  The int32 bits would decode to negative members."""
    import torch
    n, s = 64, 16
    w = World(n, s, tfail=4, seed=11, hb_max=(2**32 - 1) // n - 1)
    w.tick = 2**20
    w.view_ts[:] = w.tick - 3
    assert (w.view >= 2**31).sum() > n * s // 3
    carry = type("Carry", (), {})()
    carry.view = torch.from_numpy(w.view.view(np.int32).copy())
    carry.view_ts = torch.from_numpy(w.view_ts.copy())
    for name in ("started", "in_group", "failed", "self_hb"):
        setattr(carry, name, torch.from_numpy(getattr(w, name).copy()))
    host = daemon.pull_snapshot(carry)
    assert host.view.dtype == np.uint32
    got = decode_state(host, w.tick, n, w.tfail)
    want = jax_snapshot.decode_state(w, w.tick, n, w.tfail)
    got.precompute(None)
    want.precompute(None)
    assert _docs(got) == _docs(want)
    assert min(got.member(i)["best_heartbeat"] for i in range(n)) >= -1
    assert max(got.member(i)["best_heartbeat"] for i in range(n)) > 2**25
    bad = decode_state(type(host)(**dict(
        vars(host), view=host.view.view(np.int32))), w.tick, n, w.tfail)
    bad._derive()
    assert bad.census() != got.census()


# ---------------------------------------------------------------------------
# Every boundary of an N=256 served ring run: port daemon == JAX daemon


_RING256 = ("MAX_NNB: 256\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
            "MSG_DROP_PROB: 0\nVIEW_SIZE: 128\nGOSSIP_LEN: 32\n"
            "PROBES: 16\nFANOUT: 3\nTFAIL: 8\nTREMOVE: 32\nTOTAL_TIME: 48\n"
            "FAIL_TIME: 12\nJOIN_MODE: warm\nEXCHANGE: ring\n"
            "BACKEND: tpu_hash\nCHECKPOINT_EVERY: 8\n"
            "FUSED_RECEIVE: 0\nFUSED_GOSSIP: 0\nFUSED_PROBE: 0\n")


@pytest.mark.parametrize("mode", ["agg", "full"])
def test_served_ring_snapshots_match_jax(tmp_path, monkeypatch, mode):
    runs = {}
    for tag, mod, params_cls, kw in (
            ("port", daemon, Params, {"device": "cpu"}),
            ("jax", jax_daemon, JaxParams, {})):
        with monkeypatch.context() as mp:
            docs = record_snapshots(mp, mod)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                p = params_cls.from_text(_RING256 + f"EVENT_MODE: {mode}\n")
            p.SERVICE_PORT = 0
            p.validate()
            out = tmp_path / tag
            out.mkdir()
            rc, h = served(
                lambda: mod.serve_run(p, seed=SEED, out_dir=str(out), **kw),
                str(out),
                lambda port: wait_health(port,
                                         lambda h: h["status"] == "complete"))
            assert rc == 0 and h["snapshot_tick"] == 48
            runs[tag] = docs
    assert [t for t, _, _ in runs["port"]] == list(range(0, 49, 8))
    assert runs["port"] == runs["jax"]
    census = json.loads(runs["port"][-1][1])
    assert census["removed"] == 1 and census["live"] == 255


# ---------------------------------------------------------------------------
# Shm ring


def test_shm_ring_roundtrip_delta_and_seqlock():
    n, s, tfail = 16, 4, 4
    w = World(n, s, tfail, seed=7)
    w.started[:] = True
    snaps = [w.snap()]
    for r in (2, 5, 9):
        w.tick += 2
        w._churn_row(r)
        snaps.append(w.snap())
    prev = None
    for sn in snaps:
        sn.precompute(prev)
        prev = sn

    with pytest.raises(ValueError, match=">= 2 slots"):
        shm_ring.ShmRingWriter(n, s, np.uint32, np.int32, tfail, 100, 1)
    writer = shm_ring.ShmRingWriter(n, s, np.uint32, np.int32, tfail, 100, 2)
    reader = jreader = None
    views = []
    try:
        writer.set_engine("running", 42, 3)
        writer.publish(snaps[0], None)
        reader = shm_ring.ShmRingReader(writer.name)
        assert reader.newest_gen() == 2
        assert (reader.n, reader.s, reader.tfail) == (n, s, tfail)
        assert reader.engine() == {"status": "running", "tick": 42,
                                   "applied_events": 3}
        v0 = reader.latest()
        views.append(v0)
        assert v0.tick == snaps[0].tick
        assert v0.census == snaps[0].census_json()
        writer.publish(snaps[1], snaps[0])
        v1 = reader.latest()
        views.append(v1)
        assert v1.tick == snaps[1].tick
        assert writer.stats["rows_written"] == 2 * n
        out = writer.publish(snaps[2], snaps[1])
        assert out["rows"] == 2
        assert writer.stats["rows_written"] == 2 * n + 2
        assert writer.stats["bytes_written"] < writer.stats["bytes_full"]
        v2 = reader.latest()
        views.append(v2)
        assert v2.census == snaps[2].census_json()
        assert np.array_equal(v2.view, snaps[2]._view)
        assert np.array_equal(v2.view_ts, snaps[2]._view_ts)
        for name in ("known_by", "suspected_by", "best_hb", "staleness"):
            assert np.array_equal(v2.arrays[name],
                                  getattr(snaps[2], name)), name
        # The JAX package's reader reads the port's ring: one format.
        jreader = jax_shm_ring.ShmRingReader(writer.name)
        jv = jreader.latest()
        views.append(jv)
        assert jv.tick == v2.tick and jv.census == v2.census
        assert np.array_equal(jv.view, v2.view)
        assert jreader.engine() == reader.engine()

        assert v1.valid()
        writer.publish(snaps[3], snaps[2])
        assert not v1.valid()
        v3 = reader.latest()
        views.append(v3)
        assert v3.tick == snaps[3].tick
        lay = writer.layout
        g0, g1 = reader.slot_gen(0), reader.slot_gen(1)
        struct.pack_into("<Q", writer.shm.buf, lay.slot_off(1), g1 + 1)
        torn = reader.latest()
        views.append(torn)
        assert torn.tick == snaps[2].tick
        struct.pack_into("<Q", writer.shm.buf, lay.slot_off(0), g0 + 1)
        assert reader.latest() is None
        assert reader.newest_gen() == 0
        struct.pack_into("<Q", writer.shm.buf, lay.slot_off(0), g0)
        struct.pack_into("<Q", writer.shm.buf, lay.slot_off(1), g1)
        v4 = reader.latest()
        views.append(v4)
        assert v4.tick == snaps[3].tick
    finally:
        for v in views:
            if v is not None:
                v.arrays = v.view = v.view_ts = None
        name = writer.name
        if jreader is not None:
            jreader.close()
        writer.close()
        assert not os.path.exists(f"/dev/shm/{name}")
        assert shm_ring.unlink(name) is False
        if reader is not None:
            reader.close()


# ---------------------------------------------------------------------------
# Served grading scenarios and a kill/resume chain: every boundary equals
# the full-derive oracle, and every derive ran on the publisher thread


def _spy_derives(monkeypatch):
    derive_threads, published = [], []
    orig_full = Snapshot._derive
    orig_inc = Snapshot.derive_incremental
    orig_pre = Snapshot.precompute

    def spy_full(self):
        if not self._derived:
            derive_threads.append(threading.current_thread().name)
        orig_full(self)

    def spy_inc(self, prev):
        if not self._derived and prev is not None:
            derive_threads.append(threading.current_thread().name)
        return orig_inc(self, prev)

    def spy_pre(self, prev=None):
        orig_pre(self, prev)
        published.append(self)

    monkeypatch.setattr(Snapshot, "_derive", spy_full)
    monkeypatch.setattr(Snapshot, "derive_incremental", spy_inc)
    monkeypatch.setattr(Snapshot, "precompute", spy_pre)
    return derive_threads, published


@pytest.mark.parametrize("scenario", ["singlefailure", "multifailure",
                                      "msgdropsinglefailure"])
def test_grading_identity(tmp_path, monkeypatch, scenario):
    derive_threads, published = _spy_derives(monkeypatch)
    conf = str(TESTDIR / f"{scenario}.conf")
    out = tmp_path / "srv"
    out.mkdir()
    rc, h = served(
        lambda: daemon.serve_conf(conf, out_dir=str(out), seed=SEED,
                                  device="cpu", backend="tpu_hash",
                                  checkpoint_every=EVERY),
        str(out),
        lambda port: wait_health(port, lambda h: h["status"] == "complete"))
    assert rc == 0
    assert derive_threads and set(derive_threads) == {"snapshot-publisher"}
    modes = [s.derive_info["mode"] for s in published]
    assert modes[0] == "full" and "delta" in modes, modes
    for sn in published:
        assert_byte_identical(sn, f"tick {sn.tick}")
    assert published[-1].tick == h["total"]


def test_kill_resume_identity_chain(tmp_path, monkeypatch):
    derive_threads, published = _spy_derives(monkeypatch)
    gates = gate_boundaries(monkeypatch, daemon)
    p = svc_params(Params, tmp_path, "kr")
    out = tmp_path / "kr"
    out.mkdir()

    def interrupt_script(port):
        try:
            wait_health(port, lambda h: h["snapshot_tick"] is not None)
            code, reply = post(port, "/v1/events", EVENT)
            assert code == 202 and reply["apply_at_tick"] == 30, reply
            gates[0].set()
            wait_health(port, lambda h: h["snapshot_tick"] == 30)
            signal.raise_signal(signal.SIGTERM)
            return reply
        finally:
            for g in gates.values():
                g.set()

    rc, _ = served(lambda: daemon.serve_run(p, seed=SEED, out_dir=str(out),
                                            device="cpu"),
                   str(out), interrupt_script)
    assert rc == 0
    n_before = len(published)
    pr = svc_params(Params, tmp_path, "kr", resume=1)

    def resume_script(port):
        h = wait_health(port, lambda h: h["status"] == "complete")
        assert h["applied_events"] == 1
        return get(port, "/v1/census")[1]

    rc, census = served(
        lambda: daemon.serve_run(pr, seed=SEED, out_dir=str(out),
                                 device="cpu"),
        str(out), resume_script)
    assert rc == 0 and census["removed"] == 1
    resumed = published[n_before:]
    assert resumed and resumed[0].derive_info["mode"] == "full"
    assert any(s.derive_info["mode"] == "delta" for s in resumed)
    assert set(derive_threads) == {"snapshot-publisher"}, derive_threads
    for sn in published:
        assert_byte_identical(sn, f"tick {sn.tick}")
    assert published[-1].tick == 120


# ---------------------------------------------------------------------------
# The replica pool end to end


class SSE:
    """A raw-socket SSE subscription with incremental event parsing."""

    def __init__(self, port, timeout=120):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=timeout)
        self.sock.sendall(b"GET /v1/stream HTTP/1.1\r\nHost: t\r\n\r\n")
        self.buf = b""
        while b"\r\n\r\n" not in self.buf:
            self.buf += self.sock.recv(4096)
        assert b"text/event-stream" in self.buf
        self.buf = self.buf.split(b"\r\n\r\n", 1)[1]
        self.eof = False

    def read_rows(self, count, timeout=120):
        rows = []
        self.sock.settimeout(timeout)
        while len(rows) < count and not self.eof:
            while b"\n\n" in self.buf and len(rows) < count:
                evt, self.buf = self.buf.split(b"\n\n", 1)
                for line in evt.splitlines():
                    if line.startswith(b"data: "):
                        rows.append(json.loads(line[6:]))
            if len(rows) >= count:
                break
            chunk = self.sock.recv(4096)
            if not chunk:
                self.eof = True
            self.buf += chunk
        return rows

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


def _wait_replica(rport, pred, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            code, h = get(rport, "/healthz")
            if code == 200 and pred(h):
                return h
        except (ConnectionError, socket.timeout, http.client.HTTPException):
            pass
        time.sleep(0.05)
    raise TimeoutError("replica predicate never satisfied")


def test_replica_pool_end_to_end(tmp_path, monkeypatch):
    gates = gate_boundaries(monkeypatch, daemon)
    p = svc_params(Params, tmp_path, "pool",
                   extra="SERVICE_PORT: 0\nSERVICE_WORKERS: 2\n"
                         "SERVICE_SHM_BUFFERS: 4\n")
    out = tmp_path / "pool"
    out.mkdir()
    box = {}

    def equal_bytes(eport, rport, paths):
        for path in paths:
            assert request(eport, "GET", path) == request(rport, "GET",
                                                          path), path

    def script(port):
        h = wait_health(port, lambda h: h.get("replicas")
                        and h.get("snapshot_tick") == 0)
        reps = h["replicas"]
        assert len(reps) == 2
        box["shm"] = json.load(
            open(os.path.join(str(out), daemon.SERVICE_JSON)))["shm"]
        r0, r1 = reps[0]["port"], reps[1]["port"]
        for rp in (r0, r1):
            rh = _wait_replica(rp, lambda h: h["snapshot_tick"] == 0)
            assert rh["role"] == "replica"
            equal_bytes(port, rp, ("/v1/census", "/v1/member/0",
                                   "/v1/member/3", "/v1/member/15"))
        code, err = post(r0, "/v1/events", EVENT)
        assert code == 405 and "engine daemon" in err["error"]
        sse0, sse1 = SSE(r0), SSE(r1)
        gates[0].set()
        h = wait_health(port, lambda h: h["snapshot_tick"] == 30)
        assert h["derive"]["mode"] == "delta", h["derive"]
        _wait_replica(r0, lambda h: h["snapshot_tick"] == 30)
        _wait_replica(r1, lambda h: h["snapshot_tick"] == 30)
        equal_bytes(port, r0, ("/v1/census", "/v1/member/3"))
        equal_bytes(port, r1, ("/v1/census", "/v1/member/3"))
        rows = sse0.read_rows(10)
        assert len(rows) == 10
        os.kill(reps[1]["pid"], signal.SIGKILL)
        try:
            sse1.read_rows(10 ** 6, timeout=30)
            assert sse1.eof
        except OSError:
            pass
        sse1.close()
        assert get(port, "/healthz")[0] == 200
        assert get(r0, "/healthz")[0] == 200
        gates[30].set()
        h = wait_health(port, lambda h: h["status"] == "complete")
        rest = sse0.read_rows(10 ** 6)
        assert len(rows) + len(rest) == h["total"]
        sse0.close()
        _wait_replica(r0, lambda h: h["status"] == "complete"
                      and h["snapshot_tick"] == 120)
        equal_bytes(port, r0, ("/v1/census", "/v1/member/3"))
        deadline = time.monotonic() + 30
        while True:
            try:
                b = json.load(open(os.path.join(str(out),
                                                "replica_0.json")))
                if b["role"] == "replica" and b["queries"] > 0:
                    break
            except (OSError, ValueError):
                pass
            assert time.monotonic() < deadline, "beacon never counted"
            time.sleep(0.1)
        return reps

    rc, reps = served(lambda: daemon.serve_run(p, seed=SEED,
                                               out_dir=str(out),
                                               device="cpu"),
                      str(out), script)
    assert rc == 0
    assert not os.path.exists(f"/dev/shm/{box['shm']}")
    assert not [f for f in os.listdir("/dev/shm")
                if f == box["shm"] or f.startswith(box["shm"])]
    for r in reps:
        with pytest.raises(ProcessLookupError):
            os.kill(r["pid"], 0)


# ---------------------------------------------------------------------------
# run_report: query-tier rows from the port's run dir


def test_run_report_query_tier_rows(tmp_path):
    """The replica beacons the port's replicas write (observability/
    beacon.py) feed ``scripts/run_report.py`` as the JAX package's do."""
    sys.path.insert(0, str(REPO / "scripts"))
    import run_report
    from distributed_membership_tpu_torch.observability.beacon import (
        write_beacon)

    live = {"role": "replica", "index": 0, "pid": 1, "port": 4001,
            "queries": 500, "qps": 120.5, "p50_ms": 0.4, "p99_ms": 1.9,
            "snapshot_tick": 90, "snapshot_gen": 4, "engine_tick": 95,
            "tick_lag": 5, "engine_status": "running"}
    assert write_beacon(str(tmp_path / "replica_0.json"), live)
    stale = dict(live, index=1, port=4002, qps=999.0, tick_lag=50,
                 time=time.time() - 3600)
    assert write_beacon(str(tmp_path / "replica_1.json"), stale)
    (tmp_path / "replica_2.json").write_text("{not json")
    report = run_report.build_report(str(tmp_path))
    qt = report["query_tier"]
    assert len(qt["replicas"]) == 2
    assert qt["qps_total"] == 120.5
    assert qt["tick_lag_max"] == 5
    assert qt["replicas"][1]["stale"] is True
    md = run_report.render_markdown(report)
    assert "Query tier (read replicas)" in md
    assert "120.5" in md and "stale" in md
