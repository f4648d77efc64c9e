"""The port's fleet controller end to end: a real controller
(``python -m distributed_membership_tpu_torch --fleet --device cpu``)
multiplexing real worker subprocesses, on the CPU at N=16.

Mirrors the subprocess tests of ``tests/test_fleet.py`` and
``tests/test_elastic.py``, each finished run held to the logs of the
same conf run by the JAX package:

* the SIGKILL of the controller mid-sweep (two runs in flight, one
  queued): the restarted fleet finishes every run with the dbg.log and
  stats.log of the uninterrupted run (the JAX package's batch run);
* ``FLEET_MIGRATE_ON: death``: a worker SIGKILLed past its first
  durable boundary is journaled ``migrating`` -> ``requeued`` (trigger
  ``death``) and finishes with the unkilled run's dbg.log; a running
  run drained by ``POST /v1/runs/<id>/migrate`` (trigger ``manual``)
  too.

The other subprocess mirrors (the concurrency cap, the byte-identical
prefix proxy, a worker that finds no card) are in
``tests/test_torch_fleet_workers.py``, so that the two files run side by
side under ``--dist loadfile``.
"""

import http.client
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

from distributed_membership_tpu.runtime import application as jax_app
from distributed_membership_tpu_torch.fleet.registry import (
    JOURNAL_NAME, FleetJournal)
from distributed_membership_tpu_torch.runtime.checkpoint import (
    load_manifest)

REPO = pathlib.Path(__file__).resolve().parent.parent

# A servable ring conf (the JAX fleet tests'); TOTAL_TIME is per-test.
_HASH_CONF = ("MAX_NNB: 16\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
              "MSG_DROP_PROB: 0.0\nVIEW_SIZE: 8\nFAIL_TIME: 1000\n"
              "JOIN_MODE: warm\nBACKEND: tpu_hash\nEVENT_MODE: full\n"
              "CHECKPOINT_EVERY: 30\nTELEMETRY: scalars\n")
# Every wait of these tests stays well inside the 60 s a test may take.
WAIT_S = 45


def hash_conf(total=120):
    return _HASH_CONF + f"TOTAL_TIME: {total}\n"


def fleet_env():
    """The controller's (and so its workers') environment: the repo on
    the path, one intra-op thread per worker (several share the cores
    under pytest-xdist)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(REPO) + os.pathsep +
                         env.get("PYTHONPATH", ""))
    env["OMP_NUM_THREADS"] = "1"
    return env


def req(port, method, path, body=None, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=timeout)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def jget(port, path):
    code, raw = req(port, "GET", path)
    return code, json.loads(raw)


def start_fleet(root, max_concurrency=2, linger=False, migrate_on="",
                device="cpu"):
    """``python -m distributed_membership_tpu_torch fleet.conf --fleet``
    on ``root``; -> (process, port) once its fleet.json names it."""
    conf = os.path.join(root, "fleet.conf")
    with open(conf, "w") as fh:
        fh.write(f"FLEET_MAX_CONCURRENCY: {max_concurrency}\n"
                 f"FLEET_LINGER: {int(linger)}\n"
                 f"FLEET_MIGRATE_ON: {migrate_on}\n")
    argv = [sys.executable, "-m", "distributed_membership_tpu_torch", conf,
            "--fleet", "--out-dir", root]
    if device is not None:
        argv += ["--device", device]
    log = open(os.path.join(root, "controller.log"), "ab")
    proc = subprocess.Popen(argv, env=fleet_env(), stdout=log,
                            stderr=subprocess.STDOUT)
    log.close()
    deadline = time.monotonic() + WAIT_S
    path = os.path.join(root, "fleet.json")
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(
                "controller died: "
                + open(os.path.join(root, "controller.log")).read())
        try:
            info = json.load(open(path))
            if info.get("pid") == proc.pid:
                return proc, info["port"]
        except (OSError, ValueError, KeyError):
            pass
        time.sleep(0.05)
    raise TimeoutError("controller never published fleet.json")


def stop_fleet(proc, port):
    try:
        req(port, "POST", "/v1/admin/shutdown")
    except OSError:
        pass
    proc.wait(timeout=WAIT_S)


def submit(port, conf, run_id, seed=3, scenario=None):
    body = {"conf": conf, "run_id": run_id, "seed": seed}
    if scenario is not None:
        body["scenario"] = scenario
    code, obj = req(port, "POST", "/v1/runs", body=body)
    obj = json.loads(obj)
    assert code == 202, obj
    return obj


def listing(port):
    code, obj = jget(port, "/v1/runs")
    assert code == 200
    return {r["run_id"]: r for r in obj["runs"]}


def wait_states(port, want, timeout=WAIT_S):
    """Poll /v1/runs until every run_id maps to a state in ``want``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        runs = listing(port)
        if all(rid in runs and runs[rid]["state"] in states
               for rid, states in want.items()):
            return runs
        time.sleep(0.05)
    raise TimeoutError(f"states never reached {want}: "
                       f"{ {k: v['state'] for k, v in runs.items()} }")


def wait_boundary(root, run_id, *, tick=30, timeout=WAIT_S):
    """Poll the run's checkpoint manifest on disk (1 ms cadence) for a
    durable boundary at >= tick, so that a kill lands mid-flight."""
    ck = os.path.join(root, run_id, "ck")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        m = load_manifest(ck)
        if m is not None and int(m["tick"]) >= tick:
            return int(m["tick"])
        time.sleep(0.001)
    raise TimeoutError(f"{run_id} never wrote a tick>={tick} boundary")


def worker_pids(root):
    """Worker processes alive for this fleet root, from the process
    table (cmdline names ``<root>/<id>/run.conf``)."""
    marker = os.path.abspath(root) + os.sep
    pids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmd = fh.read().decode(errors="replace")
        except OSError:
            continue
        if marker in cmd and "run.conf" in cmd:
            pids.append(int(pid))
    return pids


def bytes_of(path):
    with open(path, "rb") as fh:
        return fh.read()


def jax_logs(out, conf, seed):
    """dbg.log and stats.log of the JAX package's batch run of ``conf``."""
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "run.conf")
    with open(path, "w") as fh:
        fh.write(conf)
    jax_app.run_conf(path, seed=seed, out_dir=str(out))
    return {name: bytes_of(os.path.join(out, name))
            for name in ("dbg.log", "stats.log")}


def test_sigkill_recovery_is_bit_exact(tmp_path):
    """SIGKILL the controller with two runs in flight and one queued,
    restart it, and the fleet finishes every run with the dbg.log and
    stats.log of the uninterrupted run of its conf and seed (the JAX
    package's batch run, which an uninterrupted fleet's run equals)."""
    subs = [("a", hash_conf(300), 3), ("b", hash_conf(300), 4),
            ("c", hash_conf(120), 5)]
    root = str(tmp_path / "crashed")
    os.makedirs(root)
    proc, port = start_fleet(root, max_concurrency=2)
    try:
        for rid, conf, seed in subs:
            submit(port, conf, rid, seed=seed)
        # Mixed states: a and b running with durable progress (beacon
        # tick > 0: a boundary passed), c queued behind the cap.
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            runs = listing(port)
            if (all(runs[r]["state"] == "running" and runs[r]["tick"] > 0
                    for r in ("a", "b"))
                    and runs["c"]["state"] == "queued"):
                break
            time.sleep(0.02)
        else:
            raise TimeoutError(f"mixed states never reached: "
                               f"{listing(port)}")
        proc.kill()                      # SIGKILL, no goodbye
        proc.wait(timeout=30)
        # Restart IS recovery: reap orphans, replay the journal, requeue.
        proc, port = start_fleet(root, max_concurrency=2)
        wait_states(port, {rid: {"done"} for rid, _, _ in subs})
    finally:
        stop_fleet(proc, port)
    log = open(os.path.join(root, "controller.log")).read()
    assert "journal replayed" in log
    for rid, conf, seed in subs:
        ref = jax_logs(tmp_path / f"jax_{rid}", conf, seed)
        for art in ("dbg.log", "stats.log"):
            assert bytes_of(os.path.join(root, rid, art)) == ref[art], \
                f"{rid}/{art} diverged"
    # The interrupted runs were resumed, not rerun from scratch: the
    # journal records a running -> queued -> running round trip, and
    # the relaunch found a durable boundary.
    journal = FleetJournal(os.path.join(root, JOURNAL_NAME)).read()
    for rid in ("a", "b"):
        rows = [r for r in journal
                if r.get("kind") == "state" and r["run_id"] == rid]
        states = [r["state"] for r in rows]
        assert states.count("running") >= 2, states
        assert max(r.get("tick", 0) for r in rows
                   if r["state"] == "queued") > 0, rows


def test_fleet_death_migration_e2e(tmp_path):
    """FLEET_MIGRATE_ON: death: SIGKILL a worker past its first durable
    boundary; the fleet journals migrating -> requeued (trigger death),
    relaunches it, and the finished run's dbg.log equals the unkilled
    run's (the JAX package's batch run).  Then the
    manual drain: POST /v1/runs/<id>/migrate parks a running run at a
    boundary and requeues it (trigger manual, exempt from the cap)."""
    root = str(tmp_path / "fleet")
    os.makedirs(root)
    conf = hash_conf(240)
    proc, port = start_fleet(root, migrate_on="death")
    try:
        submit(port, conf, "vic")
        wait_states(port, {"vic": {"running"}})
        wait_boundary(root, "vic")
        (pid,) = worker_pids(root)
        os.kill(pid, signal.SIGKILL)

        runs = wait_states(port, {"vic": {"done"}})
        assert runs["vic"].get("migrations") == 1
        assert runs["vic"].get("last_trigger") == "death"
        rows = [json.loads(line) for line in
                open(os.path.join(root, "fleet_runs.jsonl"))
                if '"vic"' in line]
        trans = [(r.get("state"), r.get("trigger")) for r in rows
                 if r.get("kind") == "state"]
        assert ("migrating", "death") in trans
        assert ("requeued", "death") in trans
        req_row = next(r for r in rows if r.get("state") == "requeued")
        assert 30 <= req_row["resume_tick"] < 240

        submit(port, conf, "man")
        wait_states(port, {"man": {"running"}})
        wait_boundary(root, "man")
        code, raw = req(port, "POST", "/v1/runs/man/migrate")
        assert code == 202, raw
        runs = wait_states(port, {"man": {"done"}})
        assert runs["man"].get("migrations") is None   # manual: exempt
        assert runs["man"].get("last_trigger") == "manual"
        rows = FleetJournal(os.path.join(root, JOURNAL_NAME)).read()
        assert ("requeued", "manual") in [
            (r.get("state"), r.get("trigger")) for r in rows
            if r.get("run_id") == "man"]
    finally:
        stop_fleet(proc, port)
    ref = jax_logs(tmp_path / "jax", conf, 3)
    for rid in ("vic", "man"):
        assert bytes_of(os.path.join(root, rid, "dbg.log")) == \
            ref["dbg.log"], rid
