"""The port's fleet controller (fleet/registry.py, scheduler.py,
daemon.py; sweeps/fleet_submit.py) against the JAX package's, in
process, on the CPU.

Mirrors the in-process tests of ``tests/test_fleet.py`` and the two
fleet tests of ``tests/test_query_tier.py`` and
``tests/test_metrics_plane.py``, each result held against the JAX
module's on the same input:

* the registry and its journal: fsync before the ACK, torn-line
  tolerance, garbage-conf refusal (the JAX messages), priority + FIFO
  order, and ``recover``'s journal replay + disk probe, on journals
  written by either package;
* ``plan_mode`` gives the JAX answer on every conf of the repo and on
  the fleet tests' confs;
* ``worker_argv`` runs the port's module with ``--device`` (the fleet's
  device, ``cuda`` unless asked), absolute paths, mode-aware flags;
* the ``fleet_submit`` grid builder; a failed bind's hint and exit code
  2; ``fleet_conf``'s gates with the JAX messages;
* the proxy's replica routing and failover against stub upstreams;
* the ``/metrics`` union (own gauges, relabeled worker scrape, replica
  beacons) and the per-run alert counts of the summary.
"""

import http.client
import http.server
import json
import os
import pathlib
import socket
import threading

import pytest

from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.fleet import daemon as jax_fleet_daemon
from distributed_membership_tpu.fleet import registry as jax_registry
from distributed_membership_tpu.fleet import scheduler as jax_scheduler
from distributed_membership_tpu.sweeps import fleet_submit as jax_submit
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.fleet import daemon as fleet_daemon
from distributed_membership_tpu_torch.fleet.daemon import (
    FleetState, make_fleet_server)
from distributed_membership_tpu_torch.fleet.registry import (
    JOURNAL_NAME, FleetJournal, Registry, plan_mode)
from distributed_membership_tpu_torch.fleet.scheduler import (
    Scheduler, worker_argv)
from distributed_membership_tpu_torch.observability import metricsbus
from distributed_membership_tpu_torch.observability.beacon import (
    write_beacon)
from distributed_membership_tpu_torch.observability.runlog import RunLog
from distributed_membership_tpu_torch.runtime import application
from distributed_membership_tpu_torch.runtime.checkpoint import (
    read_run_state)
from distributed_membership_tpu_torch.sweeps import fleet_submit

REPO = pathlib.Path(__file__).resolve().parent.parent

_HASH_CONF = ("MAX_NNB: 16\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
              "MSG_DROP_PROB: 0.0\nVIEW_SIZE: 8\nFAIL_TIME: 1000\n"
              "JOIN_MODE: warm\nBACKEND: tpu_hash\nEVENT_MODE: full\n"
              "CHECKPOINT_EVERY: 30\nTELEMETRY: scalars\n")
_EMUL_CONF = ("MAX_NNB: 16\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
              "MSG_DROP_PROB: 0.0\nVIEW_SIZE: 8\nFAIL_TIME: 50\n"
              "BACKEND: emul\n")


def _hash_conf(total=120):
    return _HASH_CONF + f"TOTAL_TIME: {total}\n"


def _emul_conf(total=150):
    return _EMUL_CONF + f"TOTAL_TIME: {total}\n"


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except (ValueError, TypeError) as e:
        return (type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# Registry + journal


def test_submit_journals_before_ack_and_orders_queue(tmp_path):
    reg = Registry(str(tmp_path))
    rec = reg.submit(_emul_conf(), seed=7)
    rows = FleetJournal(str(tmp_path / JOURNAL_NAME)).read()
    assert [r["kind"] for r in rows] == ["submit"]
    assert rows[0]["run_id"] == rec.run_id == "r0001"
    assert rows[0]["conf"] == _emul_conf() and rows[0]["seed"] == 7
    assert rec.state == "queued" and rec.mode == "headless"
    assert rec.total == 150 and rec.backend == "emul"

    low = reg.submit(_emul_conf(), priority=5)
    hot = reg.submit(_emul_conf(), priority=-1)
    assert [r.run_id for r in reg.queued()] == [
        hot.run_id, rec.run_id, low.run_id]

    jreg = jax_registry.Registry(str(tmp_path / "jax"))
    jreg.submit(_emul_conf(), seed=7)
    for conf, kw in (("totally not a conf\n", {}),
                     (_emul_conf(), {"run_id": rec.run_id}),
                     (_emul_conf(), {"run_id": "bad/../id"}),
                     ("BACKEND: warpdrive\nTOTAL_TIME: 100\n", {})):
        got = _outcome(reg.submit, conf, **kw)
        if kw.get("run_id") == rec.run_id:
            want = _outcome(jreg.submit, conf, run_id="r0001")
        else:
            want = _outcome(jreg.submit, conf, **kw)
        assert got[0] != "ok" and got == want, conf
    assert len(reg.journal.read()) == 3


def _recover_fixture(root, registry_cls):
    reg = registry_cls(root)
    fin = reg.submit(_emul_conf(), run_id="fin")
    cut = reg.submit(_hash_conf(), run_id="cut")
    ended = reg.submit(_emul_conf(), run_id="ended")
    reg.submit(_emul_conf(), run_id="fresh")
    reg.set_state(fin, "running", pid=None)
    reg.set_state(cut, "running", pid=None)
    reg.set_state(ended, "killed")
    os.makedirs(fin.run_dir(root))
    with open(os.path.join(fin.run_dir(root), "dbg.log"), "w") as fh:
        fh.write("x\n")
    with open(os.path.join(root, JOURNAL_NAME), "a") as fh:
        fh.write('{"kind": "state", "run_id": "cu')


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_recover_replays_probes_and_tolerates_torn_lines(tmp_path, writer):
    """A journal written by either package (torn tail included) is
    recovered by the port as the JAX registry recovers it."""
    root = str(tmp_path / "root")
    _recover_fixture(root, Registry if writer == "port"
                     else jax_registry.Registry)
    mirror = str(tmp_path / "mirror")
    import shutil
    shutil.copytree(root, mirror)

    reg2 = Registry(root)
    summary = reg2.recover()
    assert summary == {"adopted": 1, "requeued": 2, "kept": 1}
    states = {r["run_id"]: r["state"] for r in reg2.listing()}
    assert states == {"fin": "done", "cut": "queued",
                      "ended": "killed", "fresh": "queued"}
    assert reg2.runs["fin"].adopted
    assert reg2.runs["fin"].tick == reg2.runs["fin"].total
    assert reg2.runs["cut"].pid is None
    reg3 = Registry(root)
    assert reg3.recover() == {"adopted": 0, "requeued": 2, "kept": 2}

    jreg = jax_registry.Registry(mirror)
    assert jreg.recover() == summary
    strip = ("submitted_at",)
    assert ([{k: v for k, v in r.items() if k not in strip}
             for r in jreg.listing()]
            == [{k: v for k, v in r.items() if k not in strip}
                for r in reg2.listing()])


# A ring conf at N=256 with VIEW_SIZE 16: served, it stays off the folded
# layout (FOLDED auto is off under SERVICE_PORT).
_VIEW16 = _hash_conf().replace("VIEW_SIZE: 8", "VIEW_SIZE: 16").replace(
    "MAX_NNB: 16", "MAX_NNB: 256")


def _plan_confs():
    """Every conf of the repo and the fleet tests' confs."""
    confs = {"hash": _hash_conf(), "emul": _emul_conf(),
             "dense": ("MAX_NNB: 16\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
                       "MSG_DROP_PROB: 0.0\nVIEW_SIZE: 8\nTOTAL_TIME: 120\n"
                       "FAIL_TIME: 50\nBACKEND: tpu\n"),
             "view16": _VIEW16,
             "folded_pinned": _VIEW16 + "FOLDED: 1\nEVENT_MODE: agg\n",
             "sharded": _hash_conf().replace("tpu_hash", "tpu_hash_sharded")
             + "MESH_SHAPE: 8\n",
             "sparse": _emul_conf().replace("emul", "tpu_sparse"),
             "no_every": _hash_conf().replace("CHECKPOINT_EVERY: 30\n", ""),
             "scatter": _hash_conf() + "EXCHANGE: scatter\n"}
    for d in (REPO / "distributed_membership_tpu_torch" / "confs",
              REPO / "testcases"):
        for path in sorted(d.glob("*.conf")):
            confs[f"{d.name}/{path.name}"] = path.read_text()
    return confs


def test_plan_mode_matches_worker_capabilities():
    serve = Params.from_text(_hash_conf())
    assert plan_mode(serve) == "serve"
    dense = Params.from_text(_plan_confs()["dense"])
    assert plan_mode(dense) == "headless-ck"
    assert plan_mode(Params.from_text(_emul_conf())) == "headless"
    assert plan_mode(Params.from_text(_plan_confs()["view16"])) == "serve"
    modes = set()
    cwd = os.getcwd()
    os.chdir(REPO)          # the confs' SCENARIO paths start here
    try:
        for name, text in _plan_confs().items():
            got = _outcome(lambda t: plan_mode(Params.from_text(t)), text)
            want = _outcome(lambda t: jax_registry.plan_mode(
                JaxParams.from_text(t)), text)
            assert got == want, name
            modes.add(got[1])
    finally:
        os.chdir(cwd)
    assert {"serve", "headless-ck", "headless"} <= modes


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_worker_argv_is_absolute_and_mode_aware(tmp_path, device):
    reg = Registry(str(tmp_path))
    rec = reg.submit(_hash_conf(), run_id="w", scenario=[
        {"kind": "crash", "time": 70, "nodes": [3]}])
    argv = worker_argv(rec, str(tmp_path), device)
    run_dir = os.path.abspath(os.path.join(str(tmp_path), "w"))
    assert os.path.join(run_dir, "run.conf") in argv
    assert "--resume" in argv and "--serve" in argv
    assert argv[argv.index("--checkpoint-dir") + 1] == \
        os.path.join(run_dir, "ck")
    assert argv[argv.index("--scenario") + 1] == \
        os.path.join(run_dir, "scenario.json")
    # The port's module, on the fleet's device.
    assert argv[1:3] == ["-m", "distributed_membership_tpu_torch"]
    assert argv[argv.index("--device") + 1] == device
    assert worker_argv(rec, str(tmp_path)) == worker_argv(
        rec, str(tmp_path), "cuda")
    # Everything else is the JAX package's command line.
    jreg = jax_registry.Registry(str(tmp_path / "j"))
    jrec = jreg.submit(_hash_conf(), run_id="w", scenario=rec.scenario)
    want = jax_scheduler.worker_argv(jrec, str(tmp_path))
    k = argv.index("--device")
    assert (argv[:k] + argv[k + 2:])[3:] == want[3:]
    hl = reg.submit(_emul_conf(), run_id="hl")
    hl_argv = worker_argv(hl, str(tmp_path), device)
    assert "--serve" not in hl_argv and "--resume" not in hl_argv
    # The argv the port's parser takes: the flags of a worker's run.
    args = application.parser().parse_args(argv[3:])
    assert args.serve and args.resume and args.device == device
    assert args.port == 0 and args.seed == rec.seed


def test_fleet_submit_grid_builder():
    conf = "BACKEND: emul\nTOTAL_TIME: 150\n"
    out = fleet_submit.override_conf(conf, "TOTAL_TIME", 99)
    assert "TOTAL_TIME: 99" in out and "TOTAL_TIME: 150" not in out
    out = fleet_submit.override_conf(conf, "MSG_DROP_PROB", 0.1)
    assert out.endswith("MSG_DROP_PROB: 0.1\n")
    axes = {"MSG_DROP_PROB": [0.0, 0.1], "FAIL_TIME": [40, 60]}
    subs = fleet_submit.grid(conf, axes, seeds=(1, 2), stem="g")
    assert len(subs) == 8
    ids = [s["run_id"] for s in subs]
    assert len(set(ids)) == 8
    assert "g-FAIL_TIME-40-MSG_DROP_PROB-0p0-s1" in ids
    for s in subs:
        assert "FAIL_TIME: 4" in s["conf"] or "FAIL_TIME: 6" in \
            s["conf"]
        assert s["seed"] in (1, 2)
    assert subs == jax_submit.grid(conf, axes, seeds=(1, 2), stem="g")
    assert fleet_submit.grid(conf, axes) == jax_submit.grid(conf, axes)
    for key, value in (("TOTAL_TIME", 7), ("NEW_KEY", "x")):
        for text in (conf, conf.rstrip("\n"), ""):
            assert fleet_submit.override_conf(text, key, value) == \
                jax_submit.override_conf(text, key, value)


def test_fleet_submit_scenario_dir_subs(tmp_path):
    d = tmp_path / "scn"
    d.mkdir()
    for name in ("b", "a"):
        (d / f"{name}.json").write_text(json.dumps(
            {"name": name, "events": [{"kind": "crash", "time": 5,
                                       "nodes": [1]}]}))
    (d / "note.txt").write_text("not a scenario")
    subs = fleet_submit.grid(_hash_conf(), {"FAIL_TIME": [40]},
                             seeds=(1,), stem="c")
    got = fleet_submit.scenario_dir_subs(subs, str(d))
    assert got == jax_submit.scenario_dir_subs(subs, str(d))
    assert [s["run_id"] for s in got] == ["c-FAIL_TIME-40-s1-a",
                                          "c-FAIL_TIME-40-s1-b"]
    (tmp_path / "empty").mkdir()
    assert _outcome(fleet_submit.scenario_dir_subs, subs,
                    str(tmp_path / "empty")) == _outcome(
        jax_submit.scenario_dir_subs, subs, str(tmp_path / "empty"))


def test_fleet_bind_failure_hints_and_exits_2(tmp_path, capsys):
    """--fleet on an in-use port: no traceback, a hint naming the owning
    controller (from fleet.json) and exit code 2, as the JAX
    package's."""
    root = str(tmp_path)
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    with open(os.path.join(root, fleet_daemon.FLEET_JSON), "w") as fh:
        json.dump({"port": port, "pid": 424242, "root": root}, fh)
    errs = []
    try:
        for main in (fleet_daemon.fleet_main, jax_fleet_daemon.fleet_main):
            kw = {"device": "cpu"} if main is fleet_daemon.fleet_main \
                else {}
            assert main(root, port=port, **kw) == 2
            errs.append(capsys.readouterr().err)
    finally:
        blocker.close()
    assert "cannot bind" in errs[0]
    assert "424242" in errs[0]
    assert errs[0] == errs[1]


@pytest.mark.parametrize("text,port", [
    ("FLEET_PORT: 70000\n", None),
    ("FLEET_MAX_CONCURRENCY: 0\n", None),
    ("FLEET_LINGER: 2\n", None),
    ("FLEET_MIGRATE_ON: death,teleport\n", None),
    ("FLEET_MIGRATE_MAX: -1\n", None),
    ("", 70000),
])
def test_fleet_conf_gates_match_jax(tmp_path, capsys, text, port):
    """``--fleet``'s own gates refuse a bad FLEET_* key with exit code 2
    and the JAX package's message, before anything binds."""
    conf = tmp_path / "fleet.conf"
    conf.write_text(text)
    assert fleet_daemon.fleet_conf(str(conf), port=port,
                                   out_dir=str(tmp_path / "a"),
                                   device="cpu") == 2
    got = capsys.readouterr().err
    assert jax_fleet_daemon.fleet_conf(str(conf), port=port,
                                       out_dir=str(tmp_path / "b")) == 2
    assert got == capsys.readouterr().err and got.startswith("fleet: ")
    assert not (tmp_path / "a").exists()


def test_read_run_state_reads_the_worker_beacon(tmp_path, monkeypatch):
    """The scheduler's progress reader takes the state file the chunked
    driver writes (``DM_RUN_STATE_FILE``), and the JAX reader takes it
    too; a torn file reads as None."""
    from distributed_membership_tpu.runtime import checkpoint as jax_ck
    path = tmp_path / "run_state.json"
    monkeypatch.setenv("DM_RUN_STATE_FILE", str(path))
    conf = tmp_path / "r.conf"
    conf.write_text(_hash_conf(60))
    application.run_conf(str(conf), seed=3, out_dir=str(tmp_path / "o"),
                         device="cpu")
    doc = read_run_state(str(path))
    assert doc["tick"] == 60 and doc["total"] == 60
    assert jax_ck.read_run_state(str(path)) == doc
    path.write_text('{"tick": 3')
    assert read_run_state(str(path)) is None
    assert read_run_state(str(tmp_path / "none.json")) is None


# ---------------------------------------------------------------------------
# The proxy: replica routing and failover (stub upstreams, no engine)

_EVENT = {"kind": "crash", "time": 60, "nodes": [3]}


class _StubHandler(http.server.BaseHTTPRequestHandler):
    def _reply(self):
        body = json.dumps({"who": self.server.tag,
                           "path": self.path}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    do_GET = _reply
    do_POST = _reply

    def log_message(self, *a):       # noqa: ARG002 - silence
        pass


def _stub(tag):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                          _StubHandler)
    srv.tag = tag
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _dead_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_fleet_proxy_replica_failover(tmp_path):
    registry = Registry(str(tmp_path))
    rec = registry.submit(_hash_conf(120), run_id="q0")
    registry.set_state(rec, "running")
    lock = threading.Lock()
    scheduler = Scheduler(registry, 1, lock)
    state = FleetState(registry, scheduler, lock)
    engine = _stub("engine")
    replica = _stub("replica")
    eport = engine.server_address[1]
    rport = replica.server_address[1]
    dead1, dead2 = _dead_port(), _dead_port()
    scheduler.worker_port = lambda rid: eport
    replicas = [dead1, rport]
    scheduler.replica_ports = lambda rid: list(replicas)
    server = make_fleet_server(state, 0)
    state.port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        fport = state.port
        for _ in range(4):
            code, doc = _get(fport, "/v1/runs/q0/v1/census")
            assert code == 200 and doc["who"] == "replica", doc
            assert doc["path"] == "/v1/census"
        code, doc = _get(fport, "/v1/runs/q0/v1/member/3")
        assert code == 200 and doc["who"] == "replica"
        code, doc = _get(fport, "/v1/runs/q0/healthz")
        assert code == 200 and doc["who"] == "engine"
        code, doc = _post(fport, "/v1/runs/q0/v1/events", _EVENT)
        assert code == 200 and doc["who"] == "engine"
        replicas[:] = [dead1, dead2]
        code, doc = _get(fport, "/v1/runs/q0/v1/census")
        assert code == 200 and doc["who"] == "engine"
        # The fleet's own routes: unknown run, unknown path, a verb on
        # nothing, the listing.
        assert _get(fport, "/v1/runs/nope/v1/census")[0] == 404
        assert _get(fport, "/v1/elsewhere")[0] == 404
        assert _post(fport, "/v1/runs/q0", {})[0] == 404
        code, doc = _get(fport, "/v1/runs")
        assert code == 200 and doc["runs"][0]["run_id"] == "q0"
        engine.shutdown()
        scheduler.worker_port = lambda rid: dead2
        code, doc = _get(fport, "/v1/runs/q0/v1/census")
        assert code == 502 and "did not answer" in doc["error"]
    finally:
        server.shutdown()
        server.server_close()
        replica.shutdown()
        replica.server_close()
        engine.server_close()


# ---------------------------------------------------------------------------
# The fleet's /metrics union and the summary's alert counts

_FLEET_CONF = ("MAX_NNB: 16\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
               "MSG_DROP_PROB: 0.0\nVIEW_SIZE: 8\nFAIL_TIME: 50\n"
               "TOTAL_TIME: 120\nJOIN_MODE: warm\nBACKEND: tpu_hash\n")

_WORKER_TEXT = ("# HELP dm_engine_tick Engine tick\n"
                "# TYPE dm_engine_tick gauge\n"
                "dm_engine_tick 42\n"
                'dm_queries_total{run_id="other"} 5\n')


class _SchedStub:
    max_concurrency = 1

    def __init__(self, workers):
        self.workers = workers

    def running_count(self):
        return len(self.workers)

    def worker_port(self, run_id):
        return self.workers[run_id].port


class _WorkerStub:
    def __init__(self, run_dir, port):
        self.run_dir = run_dir
        self.port = port


def test_fleet_metrics_union_and_alert_counts(tmp_path):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _H(BaseHTTPRequestHandler):
        def do_GET(self):
            body = _WORKER_TEXT.encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):      # quiet
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), _H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        root = str(tmp_path)
        reg = Registry(root)
        rec = reg.submit(_FLEET_CONF, run_id="w1")
        reg.set_state(rec, "running", tick=30)
        run_dir = rec.run_dir(root)
        os.makedirs(run_dir)
        log = RunLog(os.path.join(run_dir, "runlog.jsonl"))
        log.event("alert", rule="tick_rate_collapse", severity="warn")
        log.event("alert", rule="tick_rate_collapse", severity="warn")
        log.event("alert", rule="detection_slo", severity="error")
        assert write_beacon(
            os.path.join(run_dir, "replica_0.json"),
            {"pid": os.getpid(), "queries": 7, "qps": 1.5,
             "snapshot_tick": 30, "engine_tick": 60, "tick_lag": 30})
        assert write_beacon(
            os.path.join(run_dir, "replica_1.json"),
            {"pid": 2 ** 30, "queries": 1, "tick_lag": 99})

        sched = _SchedStub({"w1": _WorkerStub(
            run_dir, srv.server_address[1])})
        state = FleetState(reg, sched, threading.Lock())
        text = state.metrics_text()
        parsed = metricsbus.parse_text(text)

        assert parsed[("dm_fleet_runs", (("state", "running"),))] == 1
        assert parsed[("dm_fleet_workers_alive", ())] == 1
        assert parsed[("dm_fleet_watchdog_alerts",
                       (("rule", "detection_slo"),
                        ("run_id", "w1")))] == 1
        assert parsed[("dm_fleet_watchdog_alerts",
                       (("rule", "tick_rate_collapse"),
                        ("run_id", "w1")))] == 2
        assert parsed[("dm_engine_tick", (("run_id", "w1"),))] == 42
        assert parsed[("dm_queries_total",
                       (("run_id", "other"),))] == 5
        rep = (("replica", "0"), ("run_id", "w1"))
        assert parsed[("dm_snapshot_lag_ticks", rep)] == 30
        assert parsed[("dm_queries_total", rep)] == 7
        assert not any(("replica", "1") in labels
                       for _, labels in parsed)

        code, summary = state.summary()
        assert code == 200
        (row,) = summary["runs"]
        assert row["alerts"] == {"tick_rate_collapse": 2,
                                 "detection_slo": 1}
        assert summary["aggregate"]["alerts_total"] == 3

        # The JAX controller's union over the same registry, worker and
        # beacons: the same samples (the uptime gauge aside) and summary.
        jreg = jax_registry.Registry(root)
        jreg.recover()
        jreg.runs["w1"].state = "running"
        jreg.runs["w1"].tick = 30
        jstate = jax_fleet_daemon.FleetState(jreg, sched, threading.Lock())
        want = metricsbus.parse_text(jstate.metrics_text())
        up = ("dm_fleet_uptime_seconds", ())
        assert {k: v for k, v in parsed.items() if k != up} == {
            k: v for k, v in want.items() if k != up}
        assert jstate.summary() == state.summary()
    finally:
        srv.shutdown()
        srv.server_close()
