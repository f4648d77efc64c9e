"""The port's service daemon (``--serve``) against the JAX package's.

Mirrors ``tests/test_service.py`` on the port, each run held against the
JAX package's at tolerance 0:

* a served grader run (scatter exchange, N=10) under concurrent query
  load equals the port's batch run and the JAX package's, in dbg.log and
  grade;
* an event injected over HTTP, a SIGTERM at a boundary and a served
  ``RESUME``: the stitched run equals the JAX package's uninterrupted
  served run with the same injection, in dbg.log, timeline.jsonl and
  scenario.json, and so does every boundary's census and member
  documents;
* a stop requested over HTTP, then a headless ``run_conf`` resume that
  replays the journal; a backend that cannot replay it refuses;
* the sharded backend (eight shards on one device) takes a live
  injection and equals the JAX package's served run with it (logs,
  timeline, every boundary's documents) and the union-scenario twin;
* the CLI's ``--serve``, ``--port`` and ``--fleet`` as the JAX
  package's (usage errors; ``--fleet``'s gates, and a run conf with
  ``FLEET_PORT``, as the JAX package's);
* the injection gates answer with the JAX package's HTTP codes and
  messages; a bind failure exits 2 with its hint; torn and idle SSE
  clients are tolerated; the chunked driver's boundary hook stops a run
  with the writer barriered, and the resume is bit-exact.

The engine runs in pytest's main thread (where the graceful signal
handlers install) and the HTTP clients on threads.  Every run here is on
the CPU (``device="cpu"``).
"""

import http.client
import json
import os
import pathlib
import random
import signal
import socket
import struct
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.runtime import application as jax_app
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu.service import daemon as jax_daemon
from distributed_membership_tpu.service import events as jax_events
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.grader import SCENARIO_GRADERS
from distributed_membership_tpu_torch.runtime import application
from distributed_membership_tpu_torch.runtime import checkpoint as ck
from distributed_membership_tpu_torch.runtime.failures import resolve_plan
from distributed_membership_tpu_torch.service import daemon
from distributed_membership_tpu_torch.service.events import (
    JOURNAL_NAME, EventJournal, base_events)

REPO = pathlib.Path(__file__).resolve().parent.parent
TESTDIR = REPO / "testcases"
SEED = 3
EVERY = 50


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Client helpers (stdlib only), shared with the other service test files


def request(port, method, path, body=None, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def get(port, path):
    code, body = request(port, "GET", path)
    return code, json.loads(body)


def post(port, path, body=None):
    code, reply = request(port, "POST", path, body=body or {})
    return code, json.loads(reply)


def wait_port(out_dir, timeout=120):
    path = os.path.join(out_dir, daemon.SERVICE_JSON)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            try:
                return json.load(open(path))["port"]
            except (json.JSONDecodeError, KeyError):
                pass        # torn write; retry
        time.sleep(0.05)
    raise TimeoutError(f"no {daemon.SERVICE_JSON} under {out_dir}")


def wait_health(port, pred, timeout=300):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            code, h = get(port, "/healthz")
        except (ConnectionError, socket.timeout, http.client.HTTPException):
            time.sleep(0.1)
            continue
        if code == 200 and pred(h):
            return h
        time.sleep(0.05)
    raise TimeoutError("health predicate never satisfied")


def served(serve_call, out_dir, script):
    """Run the daemon in THIS thread and ``script(port)`` on a client
    thread; the daemon always gets a shutdown, and client exceptions
    re-raise here."""
    box = {}
    stale = os.path.join(out_dir, daemon.SERVICE_JSON)
    if os.path.exists(stale):
        os.unlink(stale)

    def runner():
        try:
            box["result"] = script(wait_port(out_dir))
        except BaseException as e:      # noqa: BLE001 - reraised below
            box["error"] = e
        finally:
            try:
                post(wait_port(out_dir), "/v1/admin/shutdown")
            except Exception:
                pass
    t = threading.Thread(target=runner, daemon=True, name="test-client")
    t.start()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = serve_call()
    t.join(timeout=60)
    if "error" in box:
        raise box["error"]
    assert not t.is_alive(), "client thread wedged"
    return rc, box.get("result")


def query_load(port, stop, errors):
    """One closed-loop query client, in the engine's own process (the
    daemon's query gate keeps such clients from stalling the engine):
    census/member reads until told to stop; 503 (before the first
    snapshot) is fine, anything else is recorded."""
    i = 0
    while not stop.is_set():
        try:
            code, _ = request(port, "GET",
                              "/v1/census" if i % 2 else "/v1/member/0")
            if code not in (200, 503):
                errors.append(code)
        except (ConnectionError, socket.timeout,
                http.client.HTTPException):
            pass
        i += 1


def gate_boundaries(monkeypatch, daemon_mod, ticks=(0, 30)):
    """Park the engine at the given boundaries until the client releases
    them: the hook runs first (snapshot published, injections merged,
    ``state.tick`` set), THEN the engine waits."""
    gates = {t: threading.Event() for t in ticks}
    orig = daemon_mod._make_hook

    def make_gated(state):
        hook = orig(state)

        def gated(carry, tick):
            upd = hook(carry, tick)
            gate = gates.get(tick)
            if gate is not None:
                gate.wait(timeout=120)
            return upd
        return gated
    monkeypatch.setattr(daemon_mod, "_make_hook", make_gated)
    return gates


def record_snapshots(monkeypatch, daemon_mod):
    """Every snapshot the daemon publishes, in order, with its derived
    documents: ``[(tick, census bytes, [member(i) for every i])]``."""
    docs = []
    base = daemon_mod.SnapshotStore

    class Recording(base):
        def publish(self, snap):
            docs.append((snap.tick, snap.census_json(),
                         [snap.member(i) for i in range(snap.n)]))
            super().publish(snap)
    monkeypatch.setattr(daemon_mod, "SnapshotStore", Recording)
    return docs


SVC_CONF = ("MAX_NNB: 16\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
            "MSG_DROP_PROB: 0.0\nVIEW_SIZE: 8\nTOTAL_TIME: 120\n"
            # FAIL_TIME past TOTAL_TIME: the injected crash is the
            # run's only scheduled event.
            "FAIL_TIME: 1000\nJOIN_MODE: warm\nBACKEND: tpu_hash\n"
            "EVENT_MODE: full\nCHECKPOINT_EVERY: 30\nTELEMETRY: scalars\n")
EVENT = {"kind": "crash", "time": 70, "nodes": [3]}


def svc_params(params_cls, tmp_path, tag, resume=0, extra=""):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        p = params_cls.from_text(SVC_CONF + extra)
    p.CHECKPOINT_DIR = str(tmp_path / f"{tag}_ck")
    p.TELEMETRY_DIR = str(tmp_path / f"{tag}_tl")
    p.SERVICE_PORT = 0
    p.RESUME = resume
    p.validate()
    return p


def inject_when_ticking(port, gates, stop=None):
    """Inject at the boundary-0 park (merged at tick 30).  ``stop``:
    ``"sigterm"`` raises SIGTERM at the boundary-30 park, after the
    merge and the tick-30 checkpoint; ``"shutdown"`` asks for a stop over
    HTTP at the boundary-0 park, which the hook at 30 relays.  Either
    way the run stops at 30."""
    wait_health(port, lambda h: h["snapshot_tick"] is not None)
    halt, errors = threading.Event(), []
    clients = [threading.Thread(target=query_load,
                                args=(port, halt, errors), daemon=True)
               for _ in range(3)]
    for c in clients:
        c.start()
    try:
        code, reply = post(port, "/v1/events", EVENT)
        assert code == 202, reply
        assert reply["apply_at_tick"] == 30
        assert reply["journaled"] is True
        if stop == "shutdown":
            assert post(port, "/v1/admin/shutdown")[0] == 200
        gates[0].set()
        if stop == "sigterm":
            wait_health(port, lambda h: h["snapshot_tick"] == 30)
            signal.raise_signal(signal.SIGTERM)
            gates[30].set()
            return reply
        gates[30].set()
        if stop is None:
            h = wait_health(port, lambda h: h["status"] == "complete")
            assert h["applied_events"] == 1
        return reply
    finally:
        for g in gates.values():    # never leave the engine parked
            g.set()
        halt.set()
        for c in clients:
            c.join(timeout=10)
        assert not errors, errors


def artifacts(out_dir, tl_dir):
    return {"dbg.log": (out_dir / "dbg.log").read_bytes(),
            "timeline.jsonl": (tl_dir / "timeline.jsonl").read_bytes(),
            "scenario.json": (tl_dir / "scenario.json").read_bytes()}


@pytest.fixture(scope="module")
def jax_injected(tmp_path_factory):
    """The JAX package's uninterrupted served run with the injection:
    its artifacts and every published boundary's documents."""
    tmp = tmp_path_factory.mktemp("jax_served")
    with pytest.MonkeyPatch.context() as mp:
        gates = gate_boundaries(mp, jax_daemon)
        docs = record_snapshots(mp, jax_daemon)
        p = svc_params(JaxParams, tmp, "a")
        out = tmp / "a"
        out.mkdir()
        rc, _ = served(
            lambda: jax_daemon.serve_run(p, seed=SEED, out_dir=str(out)),
            str(out), lambda port: inject_when_ticking(port, gates))
    assert rc == 0
    return artifacts(out, tmp / "a_tl"), {t: (c, m) for t, c, m in docs}


def assert_docs_equal(got, want):
    """Every boundary's census bytes and member documents equal."""
    by_tick = {t: (c, m) for t, c, m in got}
    assert sorted(by_tick) == sorted(want)
    for t in sorted(want):
        assert by_tick[t][0] == want[t][0], f"census at tick {t}"
        assert by_tick[t][1] == want[t][1], f"members at tick {t}"


# ---------------------------------------------------------------------------
# Served grader run == batch run (port and JAX), under query load


def test_served_grader_run_matches_batch(tmp_path):
    conf = str(TESTDIR / "singlefailure.conf")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = application.run_conf(conf, backend="tpu_hash", seed=SEED,
                                   out_dir=str(tmp_path / "ref"),
                                   checkpoint_every=EVERY, device="cpu")
        jref = jax_app.run_conf(conf, backend="tpu_hash", seed=SEED,
                                out_dir=str(tmp_path / "jref"),
                                checkpoint_every=EVERY)
    srv_dir = tmp_path / "srv"
    srv_dir.mkdir()

    def script(port):
        stop, errors = threading.Event(), []
        clients = [threading.Thread(target=query_load,
                                    args=(port, stop, errors), daemon=True)
                   for _ in range(4)]
        for c in clients:
            c.start()
        h = wait_health(port, lambda h: h["status"] == "complete")
        stop.set()
        for c in clients:
            c.join(timeout=10)
        assert not errors, errors
        assert h["queries_served"] > 0
        code, census = get(port, "/v1/census")
        assert code == 200 and census["tick"] == h["total"]
        code, member = get(port, "/v1/member/0")
        assert code == 200 and member["id"] == 0
        assert get(port, "/v1/member/zzz")[0] == 400
        assert get(port, "/v1/member/10")[0] == 404
        assert get(port, "/nope")[0] == 404
        return census

    rc, census = served(
        lambda: daemon.serve_conf(conf, out_dir=str(srv_dir), seed=SEED,
                                  device="cpu", backend="tpu_hash",
                                  checkpoint_every=EVERY),
        str(srv_dir), script)
    assert rc == 0
    srv_dbg = (srv_dir / "dbg.log").read_text()
    assert srv_dbg == ref.log.dbg_text() == jref.log.dbg_text()
    g_ref = SCENARIO_GRADERS["singlefailure"](jref.log.dbg_text(), 10)
    g_srv = SCENARIO_GRADERS["singlefailure"](srv_dbg, 10)
    assert (g_srv.points, g_srv.passed) == (g_ref.points, g_ref.passed)
    assert census["removed"] == 1 and census["live"] == 9


# ---------------------------------------------------------------------------
# Inject + SIGTERM + served resume == the JAX uninterrupted served run


def test_inject_sigterm_resume_matches_jax(tmp_path, monkeypatch,
                                           jax_injected):
    want, want_docs = jax_injected
    gates = gate_boundaries(monkeypatch, daemon)
    docs = record_snapshots(monkeypatch, daemon)

    # The port's uninterrupted served run with the same injection.
    pa = svc_params(Params, tmp_path, "a")
    out_a = tmp_path / "a"
    out_a.mkdir()
    rc, _ = served(
        lambda: daemon.serve_run(pa, seed=SEED, out_dir=str(out_a),
                                 device="cpu"),
        str(out_a), lambda port: inject_when_ticking(port, gates))
    assert rc == 0
    assert artifacts(out_a, tmp_path / "a_tl") == want
    assert_docs_equal(docs, want_docs)

    # The same run stopped by SIGTERM at tick 30, then resumed served.
    for g in gates.values():
        g.clear()
    docs.clear()
    pb = svc_params(Params, tmp_path, "b")
    out_b = tmp_path / "b"
    out_b.mkdir()
    rc, _ = served(
        lambda: daemon.serve_run(pb, seed=SEED, out_dir=str(out_b),
                                 device="cpu"),
        str(out_b),
        lambda port: inject_when_ticking(port, gates, stop="sigterm"))
    assert rc == 0
    assert ck.manifest_tick(pb.CHECKPOINT_DIR) == 30
    journal = EventJournal(os.path.join(pb.CHECKPOINT_DIR, JOURNAL_NAME))
    assert journal.read() == [EVENT]
    pr = svc_params(Params, tmp_path, "b", resume=1)

    def resume_script(port):
        h = wait_health(port, lambda h: h["status"] == "complete")
        assert h["applied_events"] == 1
        return get(port, "/v1/census")[1]

    rc, census = served(
        lambda: daemon.serve_run(pr, seed=SEED, out_dir=str(out_b),
                                 device="cpu"),
        str(out_b), resume_script)
    assert rc == 0
    assert census["removed"] == 1
    assert artifacts(out_b, tmp_path / "b_tl") == want
    assert_docs_equal(docs, want_docs)


# ---------------------------------------------------------------------------
# Stop over HTTP, then a headless resume replays the journal


def test_headless_resume_replays_journal(tmp_path, monkeypatch,
                                         jax_injected):
    want, _ = jax_injected
    gates = gate_boundaries(monkeypatch, daemon)
    p = svc_params(Params, tmp_path, "h")
    out = tmp_path / "h"
    out.mkdir()
    rc, _ = served(
        lambda: daemon.serve_run(p, seed=SEED, out_dir=str(out),
                                 device="cpu"),
        str(out),
        lambda port: inject_when_ticking(port, gates, stop="shutdown"))
    assert rc == 0
    assert ck.manifest_tick(p.CHECKPOINT_DIR) == 30
    assert not (out / "dbg.log").exists()     # stopped before the end

    # Restart WITHOUT --serve: run_conf replays the acknowledged
    # injection (the banner lines come from the merged plan only).
    conf = tmp_path / "h.conf"
    conf.write_text(SVC_CONF)
    out2 = tmp_path / "h2"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = application.run_conf(str(conf), seed=SEED, out_dir=str(out2),
                                 checkpoint_dir=p.CHECKPOINT_DIR,
                                 resume=True, device="cpu",
                                 telemetry_dir=str(tmp_path / "h2_tl"))
    assert r.log.dbg_text().encode() == want["dbg.log"]
    # A backend that cannot replay the journal refuses it.
    with pytest.raises(ValueError, match="journal"):
        application.run_conf(str(conf), backend="tpu_sparse", seed=SEED,
                             out_dir=str(tmp_path / "h3"), telemetry="off",
                             checkpoint_dir=p.CHECKPOINT_DIR, resume=True,
                             device="cpu")


# ---------------------------------------------------------------------------
# The sharded backend under the service: live injection == union twin


SHARDED_CONF = ("MAX_NNB: 256\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
                "MSG_DROP_PROB: 0.0\nVIEW_SIZE: 8\nTOTAL_TIME: 120\n"
                "FAIL_TIME: 1000\nJOIN_MODE: warm\n"
                "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8\n"
                "EVENT_MODE: full\nCHECKPOINT_EVERY: 30\n"
                "TELEMETRY: scalars\n")


def test_inject_sharded_matches_jax_union_twin(tmp_path, monkeypatch):
    """Eight shards (MESH_SHAPE 8, L=32): the daemon rebuilds the sharded
    runner on the run's own mesh.  The live injection equals the JAX
    package's served sharded run with the same injection (logs,
    timeline, every boundary's documents) and the port's twin handed the
    union scenario file up front."""
    runs = {}
    for tag, mod, cls, kw in (("jax", jax_daemon, JaxParams, {}),
                              ("port", daemon, Params, {"device": "cpu"})):
        with monkeypatch.context() as mp:
            gates = gate_boundaries(mp, mod)
            docs = record_snapshots(mp, mod)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                p = cls.from_text(SHARDED_CONF)
            p.CHECKPOINT_DIR = str(tmp_path / f"{tag}_ck")
            p.TELEMETRY_DIR = str(tmp_path / f"{tag}_tl")
            p.SERVICE_PORT = 0
            p.validate()
            out = tmp_path / tag
            out.mkdir()
            rc, reply = served(
                lambda: mod.serve_run(p, seed=SEED, out_dir=str(out), **kw),
                str(out), lambda port: inject_when_ticking(port, gates))
            assert rc == 0 and reply["journaled"] is True
            runs[tag] = ((out / "dbg.log").read_bytes(),
                         (tmp_path / f"{tag}_tl"
                          / "timeline.jsonl").read_bytes(), docs)
    assert runs["port"] == runs["jax"]
    assert b" removed " in runs["port"][0]   # the injected crash, detected

    scn = tmp_path / "union.json"
    scn.write_text(json.dumps({"name": "union", "events": [EVENT]}))
    conf_file = tmp_path / "twin.conf"
    conf_file.write_text(SHARDED_CONF)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pr = application.run_conf(str(conf_file), seed=SEED,
                                  out_dir=str(tmp_path / "ptwin"),
                                  scenario=str(scn), device="cpu",
                                  telemetry_dir=str(tmp_path / "ptwin_tl"))
    assert pr.extra["mesh_size"] == 8
    assert runs["port"][0] == pr.log.dbg_text().encode()
    assert runs["port"][1] == (tmp_path / "ptwin_tl"
                               / "timeline.jsonl").read_bytes()


# ---------------------------------------------------------------------------
# SSE: torn and idle clients


def test_sse_torn_connection_tolerated(tmp_path):
    p = Params.from_text(
        "MAX_NNB: 64\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
        "MSG_DROP_PROB: 0.0\nVIEW_SIZE: 8\nTOTAL_TIME: 24\n"
        "FAIL_TIME: 1000\nJOIN_MODE: warm\nBACKEND: tpu_hash\n"
        "EVENT_MODE: full\nCHECKPOINT_EVERY: 6\nTELEMETRY: scalars\n")
    p.TELEMETRY_DIR = str(tmp_path / "tl")
    p.SERVICE_PORT = 0
    p.validate()
    out = tmp_path / "out"
    out.mkdir()

    def script(port):
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        s.sendall(b"GET /v1/stream HTTP/1.1\r\nHost: t\r\n\r\n")
        buf = b""
        while b"data: " not in buf:
            chunk = s.recv(4096)
            if not chunk:
                break
            buf += chunk
        assert b"text/event-stream" in buf and b"data: " in buf
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))    # RST on close
        s.close()
        assert get(port, "/healthz")[0] == 200
        h = wait_health(port, lambda h: h["status"] == "complete")
        code, tl = get(port, "/v1/timeline?from=0")
        assert code == 200 and len(tl["rows"]) == h["total"]
        code, tail = get(port, f"/v1/timeline?from={h['total'] - 4}")
        assert code == 200 and len(tail["rows"]) == 4
        return h

    rc, h = served(lambda: daemon.serve_run(p, seed=SEED, out_dir=str(out),
                                            device="cpu"),
                   str(out), script)
    assert rc == 0 and h["status"] == "complete"


def test_sse_disconnect_while_idle_frees_thread(tmp_path, monkeypatch):
    gates = gate_boundaries(monkeypatch, daemon)
    p = svc_params(Params, tmp_path, "sse_idle")
    out = tmp_path / "sse_idle"
    out.mkdir()

    def script(port):
        wait_health(port, lambda h: h["snapshot_tick"] is not None)
        before = threading.active_count()
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        s.sendall(b"GET /v1/stream HTTP/1.1\r\nHost: t\r\n\r\n")
        buf = b""
        while b"text/event-stream" not in buf:
            buf += s.recv(4096)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))
        s.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if threading.active_count() <= before:
                break
            time.sleep(0.1)
        freed = threading.active_count() <= before
        assert get(port, "/healthz")[0] == 200
        for g in gates.values():
            g.set()
        wait_health(port, lambda h: h["status"] == "complete")
        return freed

    rc, freed = served(
        lambda: daemon.serve_run(p, seed=SEED, out_dir=str(out),
                                 device="cpu"),
        str(out), script)
    assert rc == 0
    assert freed, "SSE handler thread leaked after client disconnect"


# ---------------------------------------------------------------------------
# The chunked driver's boundary hook itself (no daemon)


def test_sigterm_mid_write_stops_at_boundary_and_resumes(tmp_path,
                                                         monkeypatch):
    conf = str(TESTDIR / "singlefailure.conf")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_app.run_conf(conf, backend="tpu_hash", seed=SEED,
                               out_dir=str(tmp_path / "ref"),
                               checkpoint_every=EVERY)
    ckdir = tmp_path / "ck"
    real_save = ck._save_checkpoint

    def slow_save(*a, **kw):
        time.sleep(0.2)
        return real_save(*a, **kw)
    monkeypatch.setattr(ck, "_save_checkpoint", slow_save)
    seen = []

    def fire(carry, tick):
        seen.append(tick)
        if tick == 150:
            signal.raise_signal(signal.SIGTERM)

    prev_handler = signal.getsignal(signal.SIGTERM)
    with ck.boundary_hook(fire):
        with pytest.raises(ck.RunInterrupted) as exc:
            application.run_conf(conf, backend="tpu_hash", seed=SEED,
                                 out_dir=str(tmp_path / "killed"),
                                 checkpoint_every=EVERY,
                                 checkpoint_dir=str(ckdir), device="cpu")
    assert exc.value.tick == 150 and "signal" in str(exc.value)
    assert seen == [0, 50, 100, 150]     # before the run, then each boundary
    assert ck.manifest_tick(str(ckdir)) == 150
    assert signal.getsignal(signal.SIGTERM) is prev_handler

    # A hook's ``stop`` stops the same way, and says so.
    with ck.boundary_hook(lambda carry, tick: {"stop": tick == 200}):
        with pytest.raises(ck.RunInterrupted, match="stop requested") as exc:
            application.run_conf(conf, backend="tpu_hash", seed=SEED,
                                 out_dir=str(tmp_path / "killed"),
                                 checkpoint_every=EVERY,
                                 checkpoint_dir=str(ckdir), resume=True,
                                 device="cpu")
    assert exc.value.tick == 200

    monkeypatch.setattr(ck, "_save_checkpoint", real_save)
    r = application.run_conf(conf, backend="tpu_hash", seed=SEED,
                             out_dir=str(tmp_path / "resumed"),
                             checkpoint_every=EVERY,
                             checkpoint_dir=str(ckdir), resume=True,
                             device="cpu")
    assert r.log.dbg_text() == ref.log.dbg_text()


# ---------------------------------------------------------------------------
# Injection gates: unit level, no HTTP, against the JAX ControlState


_GATE_BASE = ("MAX_NNB: 64\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
              "MSG_DROP_PROB: 0.0\nVIEW_SIZE: 8\nTOTAL_TIME: 100\n"
              "FAIL_TIME: 1000\nJOIN_MODE: warm\nBACKEND: tpu_hash\n"
              "EVENT_MODE: full\nCHECKPOINT_EVERY: 25\n")
_OK = {"kind": "crash", "time": 50, "nodes": [1]}
GATE_CASES = {
    "accepted": ("", [_OK], 0, "running"),
    "not_a_list": ("", "nope", 0, "running"),
    "malformed": ("", [{"kind": "crash", "time": 50}], 0, "running"),
    "history_rewrite": ("", [{"kind": "crash", "time": 60, "nodes": [1]}],
                        50, "running"),
    "run_over": ("", [_OK], 0, "complete"),
    "sharded": ("BACKEND: tpu_hash_sharded\n", [_OK], 0, "running"),
    "agg_mode": ("EVENT_MODE: agg\n", [_OK], 0, "running"),
    "scatter": ("EXCHANGE: scatter\n", [_OK], 0, "running"),
    "budget": ("ENFORCE_BUFFSIZE: 1\n", [_OK], 0, "running"),
    "pinned_gossip": ("FUSED_GOSSIP: 1\n", [_OK], 0, "running"),
    "window_start": ("", [{"kind": "drop_window", "start": 10, "stop": 40,
                           "drop_prob": 0.5}], 30, "running"),
}


def _state_for(pkg_params, pkg_resolve, pkg_base, pkg_state, text):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params = pkg_params.from_text(text)
    plan = pkg_resolve(params, random.Random("app:0"))
    return pkg_state(params, plan, 0, params.TOTAL_TIME, None,
                     pkg_base(params, plan))


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_injection_gates_match_jax(case):
    extra, events, tick, status = GATE_CASES[case]
    text = _GATE_BASE + extra
    got_state = _state_for(Params, resolve_plan, base_events,
                           daemon.ControlState, text)
    want_state = _state_for(JaxParams, jax_failures.resolve_plan,
                            jax_events.base_events, jax_daemon.ControlState,
                            text)
    for st in (got_state, want_state):
        st.tick, st.status = tick, status
    got, want = got_state.inject(events), want_state.inject(events)
    assert got == want
    assert got[0] == {"accepted": 202, "sharded": 202}.get(
        case, 400 if case in ("not_a_list", "malformed", "history_rewrite",
                              "window_start") else 409)


def test_params_identity_excludes_service_keys():
    base = ("MAX_NNB: 64\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
            "MSG_DROP_PROB: 0.0\nVIEW_SIZE: 8\nTOTAL_TIME: 100\n"
            "JOIN_MODE: warm\nBACKEND: tpu_hash\nCHECKPOINT_EVERY: 25\n")
    keys = ("SERVICE_PORT: 8080\nSERVICE_SNAPSHOT_EVERY: 4\n"
            "SERVICE_WORKERS: 2\nSERVICE_SHM_BUFFERS: 8\n")
    assert (ck.params_identity(Params.from_text(base))
            == ck.params_identity(Params.from_text(base + keys)))


# ---------------------------------------------------------------------------
# Bind failure: the JAX package's hint and exit 2


def test_serve_bind_failure_hints_and_exits_2(tmp_path, capsys):
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    port = taken.getsockname()[1]
    try:
        conf = tmp_path / "bind.conf"
        conf.write_text(
            "MAX_NNB: 16\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
            "MSG_DROP_PROB: 0.0\nVIEW_SIZE: 8\nTOTAL_TIME: 60\n"
            "FAIL_TIME: 1000\nJOIN_MODE: warm\nBACKEND: tpu_hash\n"
            "EVENT_MODE: full\nCHECKPOINT_EVERY: 30\n")
        errs = []
        for pkg, kw in ((daemon, {"device": "cpu"}), (jax_daemon, {})):
            out = tmp_path / pkg.__name__
            out.mkdir()
            (out / daemon.SERVICE_JSON).write_text(
                json.dumps({"port": port, "pid": 12345}))
            assert pkg.serve_conf(str(conf), port=port, out_dir=str(out),
                                  **kw) == 2
            errs.append(capsys.readouterr().err.replace(str(out), "OUT"))
        assert "cannot bind" in errs[0] and "12345" in errs[0]
        assert errs[0] == errs[1]
    finally:
        taken.close()


def test_query_gate_serializes_and_yields_to_a_live_run(monkeypatch):
    """While the run is live requests owe the daemon's query gate an idle
    hold of (1/share - 1) times their threads' CPU time, paid at most
    MAX_HOLD_S per request and carried over; a second request waits for
    the first; once the run is over nothing more is held or owed."""
    from distributed_membership_tpu_torch.service import api
    live, slept = [True], []
    monkeypatch.setattr(api.time, "sleep", slept.append)
    clock = iter([1.0, 1.004, 2.0, 2.0, 3.0]).__next__
    monkeypatch.setattr(api.time, "thread_time", clock)
    gate = api.QueryGate(lambda: live[0], share=0.2)
    t0 = gate.enter()                        # 1.0
    waiter = threading.Thread(target=gate.enter, daemon=True)
    waiter.start()
    waiter.join(timeout=0.2)
    assert waiter.is_alive()                 # the gate is held
    gate.leave(t0)                           # 4 ms of CPU: 16 ms owed
    waiter.join(timeout=10)                  # the waiter entered at 2.0
    assert not waiter.is_alive()
    assert slept == [pytest.approx(api.MAX_HOLD_S)]
    gate.leave(2.0)                          # no CPU: the rest of the debt
    assert slept[1] == pytest.approx(0.016 - api.MAX_HOLD_S)
    live[0] = False
    gate.enter()
    gate.leave(3.0)
    assert len(slept) == 2 and gate._owed == 0.0
    assert (api.QUERY_SHARE, api.MAX_HOLD_S) == (0.1, 0.01)


def test_pull_snapshot_is_a_fresh_host_copy():
    """The hook's pull copies the six fields in the JAX dtypes, so the
    engine's later writes to its own tensors never reach a published
    snapshot."""
    n, s = 8, 4
    carry = type("Carry", (), {})()
    carry.view = torch.full((n, s), -5, dtype=torch.int32)   # u32 bits
    carry.view_ts = torch.arange(n * s, dtype=torch.int32).view(n, s)
    carry.started = torch.ones(n, dtype=torch.bool)
    carry.in_group = torch.ones(n, dtype=torch.bool)
    carry.failed = torch.zeros(n, dtype=torch.bool)
    carry.self_hb = torch.arange(n, dtype=torch.int32)
    host = daemon.pull_snapshot(carry)
    assert host.view.dtype == np.uint32 and host.view_ts.dtype == np.int32
    assert int(host.view[0, 0]) == 2**32 - 5
    carry.view.fill_(0)
    carry.view_ts.fill_(0)
    assert int(host.view[0, 0]) == 2**32 - 5 and int(host.view_ts[1, 1]) == 5


# ---------------------------------------------------------------------------
# The CLI: --serve, --port and --fleet as the JAX package's


@pytest.mark.parametrize("argv", [
    ["c.conf", "--port", "0"],
    ["c.conf", "--serve", "--fleet"],
    ["--serve"],
])
def test_cli_usage_errors_match_jax(argv, capsys):
    errors = []
    for main in (application.main, jax_app.main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0].split("error: ")[1] == errors[1].split("error: ")[1]


def test_fleet_is_refused_with_its_item(tmp_path, capsys):
    """``--fleet`` runs now (fleet/daemon.py): what it refuses is a bad
    FLEET_* setting, with exit code 2 and the JAX package's message.  A
    run conf with ``FLEET_PORT: 0`` is no longer refused: it runs, with
    the JAX package's logs (only ``--fleet`` reads the key)."""
    errs = []
    for main, extra in ((application.main, ["--device", "cpu"]),
                        (jax_app.main, [])):
        assert main(["--fleet", "--port", "70000", "--out-dir",
                     str(tmp_path / "f")] + extra) == 2
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and "FLEET_PORT must be in 0..65535" in errs[0]
    assert not (tmp_path / "f").exists()
    conf = tmp_path / "fleet.conf"
    conf.write_text(SVC_CONF.replace("CHECKPOINT_EVERY: 30\n", "")
                    + "FLEET_PORT: 0\n")
    application.run_conf(str(conf), seed=SEED, out_dir=str(tmp_path / "p"),
                         device="cpu")
    jax_app.run_conf(str(conf), seed=SEED, out_dir=str(tmp_path / "j"))
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        assert ((tmp_path / "p" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name


def test_cli_serve_writes_the_batch_logs(tmp_path):
    """``--serve --port 0 --device cpu`` through ``main``: the served run
    writes the batch run's logs and exits 0 on the shutdown."""
    conf = tmp_path / "svc.conf"
    conf.write_text(SVC_CONF.replace("TELEMETRY: scalars\n", ""))
    out = tmp_path / "srv"
    out.mkdir()
    rc, h = served(
        lambda: application.main([str(conf), "--serve", "--port", "0",
                                  "--device", "cpu", "--seed", str(SEED),
                                  "--out-dir", str(out)]),
        str(out),
        lambda port: wait_health(port, lambda h: h["status"] == "complete"))
    assert rc == 0 and h["tick"] == 120
    ref = application.run_conf(str(conf), seed=SEED, device="cpu",
                               out_dir=str(tmp_path / "ref"))
    assert (out / "dbg.log").read_text() == ref.log.dbg_text()
