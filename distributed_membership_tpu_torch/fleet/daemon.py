"""Fleet controller daemon: HTTP surface + proxy + CLI entry
(counterpart of the JAX package's ``fleet/daemon.py``).

The controller serves two kinds of routes from one stdlib server:

  * fleet routes it owns — submit/list/inspect runs, pause/resume/
    kill, ``/v1/fleet/summary``, ``/healthz``, ``/metrics`` (the
    fleet-wide Prometheus union: controller gauges + every running
    worker's scrape relabeled with ``run_id`` + replica-beacon
    gauges), admin shutdown;
  * the ENTIRE single-run surface under ``/v1/runs/<id>/...`` — not
    re-implemented but forwarded verbatim to the run's worker daemon,
    whose handlers are the shared ``service/api.py`` route functions.
    The controller strips its mount prefix and proxies the remainder
    (``/v1/runs/r0001/v1/census`` -> worker's ``/v1/census``), which is
    what keeps the two surfaces identical by construction: there is
    exactly one implementation of every run endpoint.

Durability contract (mirrors service/events.py): a submission is
journaled + fsynced to ``fleet_runs.jsonl`` BEFORE the 202 ACK, so a
SIGKILLed controller loses no acknowledged run — restart replays the
journal, re-adopts runs whose artifacts finished on disk, and requeues
interrupted ones with ``--resume`` (bit-exact, the worker is the
port's chunked driver).  Workers run on the fleet's device: ``--fleet``
takes ``--device`` (``cuda`` unless ``cpu`` is asked for) and hands it to
every worker's command line (scheduler.py ``worker_argv``).
"""

from __future__ import annotations

import glob
import json
import os
import re
import signal
import sys
import threading
import time
from typing import Optional, Tuple

from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.fleet.registry import Registry
from distributed_membership_tpu_torch.fleet.scheduler import (
    Scheduler, reap_orphans, sweep_stale_rings)
from distributed_membership_tpu_torch.observability import metricsbus
from distributed_membership_tpu_torch.observability.beacon import (
    read_beacon, write_beacon)
from distributed_membership_tpu_torch.observability.runlog import (
    read_events)
from distributed_membership_tpu_torch.service import api

FLEET_JSON = "fleet.json"
_RUNS_PREFIX = "/v1/runs"
_VERBS = ("pause", "resume", "kill", "migrate")
# A worker scrape must never stall the fleet's own /metrics reply
# behind a wedged daemon: connection-level failures simply drop that
# worker's samples from this scrape.
_SCRAPE_TIMEOUT_S = 1.0
_BEACON_FRESH_S = 10.0


def _alert_counts(run_dir: str) -> dict:
    """Per-rule watchdog alert counts from a run's runlog; {} when the
    run has no runlog (headless, telemetry off) or it is unreadable."""
    counts: dict = {}
    try:
        events = read_events(os.path.join(run_dir, "runlog.jsonl"),
                             kinds=("alert",))
    except OSError:
        return counts
    for ev in events:
        rule = ev.get("rule", "?")
        counts[rule] = counts.get(rule, 0) + 1
    return counts


def _scrape(port: int, timeout: float = _SCRAPE_TIMEOUT_S) -> str:
    """One GET /metrics round-trip to a worker; '' on any failure."""
    import http.client
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=timeout)
        try:
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            if resp.status != 200:
                return ""
            return resp.read().decode("utf-8", errors="replace")
        finally:
            conn.close()
    except OSError:
        return ""


class FleetState:
    """Shared state behind the fleet handler threads: the registry +
    scheduler pair and the one lock that serializes both."""

    def __init__(self, registry: Registry, scheduler: Scheduler,
                 lock: threading.Lock, linger: bool = False):
        self.registry = registry
        self.scheduler = scheduler
        self.lock = lock
        self.linger = linger
        self.stop_event = threading.Event()
        self.started_at = time.time()
        self.port: Optional[int] = None
        self.queries = 0
        self.rr = 0             # replica round-robin cursor (proxy)
        m = self.metrics = metricsbus.MetricsRegistry()
        self._m_runs = m.gauge(
            "dm_fleet_runs", "Runs by registry state")
        self._m_workers = m.gauge(
            "dm_fleet_workers_alive", "Live (non-lingering) workers")
        self._m_queries = m.counter(
            "dm_fleet_queries_total", "Fleet-surface requests served")
        self._m_uptime = m.gauge(
            "dm_fleet_uptime_seconds", "Controller uptime")
        self._m_alerts = m.gauge(
            "dm_fleet_watchdog_alerts",
            "Watchdog alerts journaled per run and rule")

    # -- fleet routes (each returns (code, json-able)) -----------------
    def health(self) -> dict:
        with self.lock:
            states: dict = {}
            for rec in self.registry.runs.values():
                states[rec.state] = states.get(rec.state, 0) + 1
            self.queries += 1
            return {
                "status": "running",
                "role": "fleet",
                "pid": os.getpid(),
                "port": self.port,
                "root": self.registry.root,
                "max_concurrency": self.scheduler.max_concurrency,
                "linger": int(self.linger),
                "uptime_s": round(time.time() - self.started_at, 3),
                "workers_alive": self.scheduler.running_count(),
                "runs": states,
                "queries_served": self.queries,
            }

    def submit(self, body: dict) -> Tuple[int, dict]:
        conf = body.get("conf")
        if not isinstance(conf, str) or not conf.strip():
            return 400, {"error": "body must carry a 'conf' string "
                                  "(the run's .conf text)"}
        try:
            with self.lock:
                rec = self.registry.submit(
                    conf, seed=body.get("seed"),
                    priority=int(body.get("priority", 0)),
                    scenario=body.get("scenario"),
                    run_id=body.get("run_id"))
        except (ValueError, TypeError) as e:
            return 400, {"error": str(e)}
        self.scheduler.wake()
        # The journal append above fsynced before this reply is built:
        # once the client sees 202 the run survives any controller
        # death.
        return 202, {"run_id": rec.run_id, "state": rec.state,
                     "mode": rec.mode,
                     "dir": rec.run_dir(self.registry.root)}

    def list_runs(self) -> Tuple[int, dict]:
        with self.lock:
            self.queries += 1
            return 200, {"runs": self.registry.listing()}

    def run_detail(self, run_id: str) -> Tuple[int, dict]:
        with self.lock:
            self.queries += 1
            rec = self.registry.runs.get(run_id)
            if rec is None:
                return 404, {"error": f"unknown run {run_id!r}"}
            out = rec.public()
            out["dir"] = rec.run_dir(self.registry.root)
            return 200, out

    def verb(self, run_id: str, verb: str) -> Tuple[int, dict]:
        with self.lock:
            rec = self.registry.runs.get(run_id)
            if rec is None:
                return 404, {"error": f"unknown run {run_id!r}"}
            if verb == "pause":
                if rec.state != "running":
                    return 409, {"error": f"run is {rec.state}; only "
                                          "a running run can pause"}
                if rec.mode == "headless":
                    return 409, {"error": "run has no chunked driver "
                                          "(mode headless) — nothing "
                                          "durable to pause to"}
                if not self.scheduler.pause(rec):
                    return 409, {"error": "worker is not signallable"}
                return 202, {"run_id": run_id, "pausing": True}
            if verb == "resume":
                if rec.state not in ("checkpointed", "killed",
                                     "failed"):
                    return 409, {"error": f"run is {rec.state}; only "
                                          "checkpointed/killed/failed "
                                          "runs can resume"}
                self.registry.set_state(rec, "queued", pausing=False,
                                        killing=False)
                self.scheduler.wake()
                return 202, {"run_id": run_id, "state": "queued"}
            if verb == "migrate":
                # Operator drain (elastic/migrate.py): a RUNNING run is
                # SIGTERMed to park at a durable boundary and the reap
                # path journals migrating -> requeued; an already-parked
                # run (checkpointed/failed/killed) requeues immediately.
                if rec.state == "running":
                    if rec.mode == "headless":
                        return 409, {"error": "run has no chunked "
                                              "driver (mode headless) "
                                              "— nothing durable to "
                                              "migrate"}
                    if not self.scheduler.migrate(rec):
                        return 409, {"error": "worker is not "
                                              "signallable"}
                    return 202, {"run_id": run_id, "migrating": True}
                if rec.state in ("checkpointed", "failed", "killed"):
                    from distributed_membership_tpu_torch.elastic.migrate \
                        import migrate_record
                    detail = migrate_record(self.registry, rec,
                                            "manual")
                    self.scheduler.wake()
                    return 202, {"run_id": run_id, "state": rec.state,
                                 **detail}
                return 409, {"error": f"run is {rec.state}; only "
                                      "running/checkpointed/failed/"
                                      "killed runs can migrate"}
            # kill
            if rec.state == "queued":
                self.registry.set_state(rec, "killed")
                return 202, {"run_id": run_id, "state": "killed"}
            if rec.state == "running":
                if not self.scheduler.kill(rec):
                    return 409, {"error": "worker is not signallable"}
                return 202, {"run_id": run_id, "killing": True}
            w = self.scheduler.workers.get(run_id)
            if w is not None and w.lingering and w.proc.poll() is None:
                # FLEET_LINGER kept the finished worker serving; kill
                # stops the server, the run stays done.
                w.proc.kill()
                return 202, {"run_id": run_id, "state": rec.state,
                             "stopped_linger": True}
            return 409, {"error": f"run is {rec.state}; nothing to "
                                  "kill"}

    def summary(self) -> Tuple[int, dict]:
        """Aggregate census + per-run SLO verdicts (slo.json, written
        by ``scripts/run_report.py --slo``)."""
        with self.lock:
            self.queries += 1
            recs = [self.registry.runs[k]
                    for k in sorted(self.registry.runs,
                                    key=lambda k:
                                    self.registry.runs[k].seq)]
            root = self.registry.root
        rows, states = [], {}
        live_total = ticks_total = 0
        for rec in recs:
            states[rec.state] = states.get(rec.state, 0) + 1
            ticks_total += rec.tick
            row = {"run_id": rec.run_id, "state": rec.state,
                   "tick": rec.tick, "total": rec.total,
                   "live": None, "slo": None, "alerts": {}}
            if rec.migrations or rec.last_trigger:
                row["migrations"] = rec.migrations
                row["last_trigger"] = rec.last_trigger
            run_dir = rec.run_dir(root)
            row["alerts"] = _alert_counts(run_dir)
            tl = os.path.join(run_dir, "timeline.jsonl")
            if os.path.exists(tl):
                tail = api._timeline_rows(tl, 0)
                if tail:
                    row["live"] = tail[-1].get("live")
                    live_total += row["live"] or 0
            try:
                with open(os.path.join(run_dir, "slo.json")) as fh:
                    slo = json.load(fh)
                row["slo"] = {"passed": slo.get("passed"),
                              "max_cdf_deviation":
                                  slo.get("max_cdf_deviation")}
            except (OSError, ValueError):
                pass
            rows.append(row)
        alerts_total = sum(sum(r["alerts"].values()) for r in rows)
        return 200, {"runs": rows,
                     "aggregate": {"runs": len(rows), "states": states,
                                   "live_total": live_total,
                                   "ticks_total": ticks_total,
                                   "alerts_total": alerts_total}}

    def metrics_text(self) -> str:
        """The fleet-wide metrics union, Prometheus text.

        Three layers, one exposition: the controller's own gauges;
        every running serve worker's live ``/metrics`` relabeled with
        its ``run_id``; and gauges synthesized from replica
        beacons via the shared torn-tolerant reader — a replica's
        freshness story is its beacon, so a wedged replica simply ages
        out of the union instead of stalling the scrape.  Runs on a
        handler thread; no engine thread is ever involved.
        """
        with self.lock:
            self.queries += 1
            q = self.queries
            states: dict = {}
            for rec in self.registry.runs.values():
                states[rec.state] = states.get(rec.state, 0) + 1
            root = self.registry.root
            run_dirs = [(rec.run_id, rec.run_dir(root))
                        for rec in self.registry.runs.values()]
            targets = []
            for run_id in list(self.scheduler.workers):
                port = self.scheduler.worker_port(run_id)
                if port is not None:
                    targets.append(
                        (run_id, port,
                         self.scheduler.workers[run_id].run_dir))
            alive = self.scheduler.running_count()
        self._m_runs.clear()
        for st in sorted(states):
            self._m_runs.set(states[st], state=st)
        self._m_workers.set(alive)
        self._m_queries.set_total(q)
        self._m_uptime.set(round(time.time() - self.started_at, 3))
        self._m_alerts.clear()
        for run_id, run_dir in run_dirs:
            counts = _alert_counts(run_dir)
            for rule in sorted(counts):
                self._m_alerts.set(counts[rule], run_id=run_id,
                                   rule=rule)
        parts = [self.metrics.render()]
        for run_id, port, _ in targets:
            text = _scrape(port)
            if text:
                parts.append(metricsbus.relabel(text,
                                                {"run_id": run_id}))
        rep = metricsbus.MetricsRegistry()
        r_q = rep.counter("dm_queries_total",
                          "Replica queries served (from its beacon)")
        r_qps = rep.gauge("dm_queries_per_sec",
                          "Replica query rate (from its beacon)")
        r_snap = rep.gauge("dm_snapshot_tick",
                           "Replica's freshest served snapshot tick")
        r_eng = rep.gauge("dm_engine_tick",
                          "Engine tick as the replica sees it")
        r_lag = rep.gauge("dm_snapshot_lag_ticks",
                          "Replica staleness behind its engine")
        synthesized = False
        for run_id, _, run_dir in targets:
            for path in sorted(glob.glob(
                    os.path.join(run_dir, "replica_*.json"))):
                m = re.fullmatch(r"replica_(\d+)\.json",
                                 os.path.basename(path))
                if m is None:
                    continue
                doc = read_beacon(path, max_age_s=_BEACON_FRESH_S,
                                  require_pid="pid")
                if doc is None:
                    continue
                synthesized = True
                labels = {"run_id": run_id, "replica": m.group(1)}
                r_q.set_total(int(doc.get("queries") or 0), **labels)
                r_qps.set(float(doc.get("qps") or 0.0), **labels)
                if doc.get("snapshot_tick") is not None:
                    r_snap.set(int(doc["snapshot_tick"]), **labels)
                if doc.get("engine_tick") is not None:
                    r_eng.set(int(doc["engine_tick"]), **labels)
                if doc.get("tick_lag") is not None:
                    r_lag.set(int(doc["tick_lag"]), **labels)
        if synthesized:
            parts.append(rep.render())
        return "".join(parts)

    def request_shutdown(self) -> None:
        self.stop_event.set()


# -- the proxy ---------------------------------------------------------
# GETs a read replica answers byte-identically to the engine daemon —
# everything that reads the published snapshot/timeline.  /healthz is
# deliberately absent: proxied health means the RUN's health.
_REPLICA_ROUTES = ("/v1/census", "/v1/timeline", "/v1/stream")


def _replica_route(rest: str) -> bool:
    return rest in _REPLICA_ROUTES or rest.startswith("/v1/member/")


def proxy(h: api.ApiHandler, state: FleetState, run_id: str,
          rest: str, query: str, body: Optional[bytes]) -> None:
    """Forward one request to the run's worker daemon, verbatim.

    Endpoint-agnostic on purpose: the worker's handlers ARE the shared
    service/api.py routes, so forwarding the stripped remainder is what
    makes ``/v1/runs/<id>/X`` answer byte-identically to the worker's
    own ``X`` — no route is ever re-implemented here.  SSE responses
    are streamed chunk-by-chunk; everything else is relayed whole.

    Query routing: when the run's worker publishes a replica pool
    (SERVICE_WORKERS), snapshot GETs are spread round-robin over the
    replicas — the engine daemon answers the same bytes, so this is
    pure load distribution.  A dead replica fails over to the next
    candidate (survivors first, engine last); writes, admin verbs and
    ``/healthz`` (the RUN's health, not a replica's) always go to the
    engine.  502 only when every candidate refuses.
    """
    import http.client
    with state.lock:
        rec = state.registry.runs.get(run_id)
        port = (None if rec is None
                else state.scheduler.worker_port(run_id))
        replicas = ([] if rec is None or body is not None
                    or not _replica_route(rest)
                    else state.scheduler.replica_ports(run_id))
        state.rr += 1
        rr = state.rr
    if rec is None:
        h._json(404, {"error": f"unknown run {run_id!r}"})
        return
    if port is None:
        # One disk fallback, still shared code: the flight recorder
        # outlives its worker, so history stays queryable.
        if body is None and rest == "/v1/timeline":
            tl = os.path.join(rec.run_dir(state.registry.root),
                              "timeline.jsonl")
            if os.path.exists(tl):
                from urllib.parse import parse_qs
                start = int(parse_qs(query).get("from", ["0"])[0])
                h._json(200, {"from": start,
                              "rows": api._timeline_rows(tl, start)})
                return
        h._json(409, {"error": f"run {run_id!r} is {rec.state}; its "
                               "live surface needs a running worker "
                               "(FLEET_LINGER: 1 keeps finished "
                               "workers serving)",
                      "state": rec.state})
        return
    target = rest + (f"?{query}" if query else "")
    method = "GET" if body is None else "POST"
    # Candidate order: the replica pool rotated by the shared cursor
    # (so consecutive requests land on different replicas), engine
    # last as the always-correct fallback.  Failover advances on
    # connection-level failure, BEFORE any bytes went downstream.
    k = rr % len(replicas) if replicas else 0
    candidates = replicas[k:] + replicas[:k] + [port]
    last_err: Optional[OSError] = None
    for upstream in candidates:
        conn = http.client.HTTPConnection("127.0.0.1", upstream,
                                          timeout=None)
        try:
            # Upstream and downstream failures must not be conflated:
            # a worker dying mid-request raises RemoteDisconnected — a
            # ConnectionResetError subclass, i.e. the SAME type our
            # own client raises by hanging up — and treating it as
            # "our client left" would swallow the request and leave
            # the real client blocked with no reply.  So the worker
            # conversation runs in its own try (any OSError -> next
            # candidate, then 502), and only writes to ``h.wfile`` may
            # re-raise out to do_* (which handles a gone client).
            try:
                headers = {}
                if body is not None:
                    headers = {"Content-Type": "application/json",
                               "Content-Length": str(len(body))}
                conn.request(method, target, body=body,
                             headers=headers)
                resp = conn.getresponse()
                ctype = resp.getheader("Content-Type",
                                       "application/json")
                data = (None if ctype.startswith("text/event-stream")
                        else resp.read())
            except OSError as e:
                last_err = e
                continue           # dead candidate: try the next one
            if data is not None:
                h._body(resp.status, data)
                return
            h.send_response(resp.status)
            h.send_header("Content-Type", ctype)
            h.send_header("Cache-Control", "no-cache")
            h.send_header("Connection", "close")
            h.end_headers()
            while True:
                try:
                    chunk = resp.read1(65536)
                except OSError:
                    break          # upstream died mid-stream
                if not chunk:
                    break
                h.wfile.write(chunk)
                h.wfile.flush()
            h.close_connection = True
            return
        finally:
            conn.close()
    h._json(502, {"error": f"worker for run {run_id!r} did not "
                           f"answer ({last_err})"})


# -- routing -----------------------------------------------------------
def _split_run_path(upath: str):
    """``/v1/runs/<id>[/rest]`` -> (run_id, rest or '')."""
    tail = upath[len(_RUNS_PREFIX):].lstrip("/")
    run_id, _, rest = tail.partition("/")
    return run_id, ("/" + rest if rest else "")


def route_get(h: api.ApiHandler, state: FleetState, upath: str,
              query: str) -> None:
    if upath == "/healthz":
        h._json(200, state.health())
    elif upath == "/metrics":
        text = state.metrics_text()
        h._body(200, text.encode(),
                ctype="text/plain; version=0.0.4; charset=utf-8")
    elif upath == "/v1/fleet/summary":
        code, obj = state.summary()
        h._json(code, obj)
    elif upath == _RUNS_PREFIX:
        code, obj = state.list_runs()
        h._json(code, obj)
    elif upath.startswith(_RUNS_PREFIX + "/"):
        run_id, rest = _split_run_path(upath)
        if not rest:
            code, obj = state.run_detail(run_id)
            h._json(code, obj)
        else:
            proxy(h, state, run_id, rest, query, None)
    else:
        h._json(404, {"error": f"unknown path {upath!r}"})


def route_post(h: api.ApiHandler, state: FleetState,
               upath: str) -> None:
    if upath == _RUNS_PREFIX:
        body = h.read_json_body()
        if body is None:
            return
        if not isinstance(body, dict):
            h._json(400, {"error": "submission body must be a JSON "
                                   "object"})
            return
        code, obj = state.submit(body)
        h._json(code, obj)
    elif upath == "/v1/admin/shutdown":
        state.request_shutdown()
        h._json(200, {"stopping": True})
    elif upath.startswith(_RUNS_PREFIX + "/"):
        run_id, rest = _split_run_path(upath)
        if rest.lstrip("/") in _VERBS:
            code, obj = state.verb(run_id, rest.lstrip("/"))
            h._json(code, obj)
        elif rest:
            length = int(h.headers.get("Content-Length", 0))
            proxy(h, state, run_id, rest, "", h.rfile.read(length))
        else:
            h._json(404, {"error": "POST needs a verb or a proxied "
                                   "path after the run id"})
    else:
        h._json(404, {"error": f"unknown path {upath!r}"})


def make_fleet_server(state: FleetState, port: int):
    """Build (not start) the controller server; shares ApiHandler's
    transport plumbing with the single-run daemon."""

    class Handler(api.ApiHandler):
        def _route_get(self):
            upath, _, query = self.path.partition("?")
            route_get(self, state, upath, query)

        def _route_post(self):
            upath, _, _ = self.path.partition("?")
            route_post(self, state, upath)

    return api.bind_server(Handler, port)


# -- process entry -----------------------------------------------------
def port_in_use_hint(err, root: str) -> str:
    """Bind-failure message naming the fleet that owns the port when
    its discovery file says so (same UX as service/daemon.py)."""
    lines = [f"fleet: cannot bind — {err.strerror}; pick another "
             "--port (or 0 for ephemeral), or stop the owner"]
    info = read_beacon(os.path.join(root, FLEET_JSON))
    if info is not None and info.get("port") == err.port:
        lines.append(
            f"fleet: {FLEET_JSON} in {root!r} records pid "
            f"{info.get('pid')} running a fleet on port "
            f"{err.port} — that controller likely still owns it")
    return "\n".join(lines)


def fleet_main(root: str, port: int = 0, max_concurrency: int = 2,
               linger: bool = False, migrate_on: str = "",
               migrate_max: int = 2, device: str = "cuda") -> int:
    """Run the controller until shutdown; -> exit code.  Every worker
    runs on ``device``.

    Startup IS crash recovery: there is no separate repair path.  The
    journal replay + disk probe reconcile whatever a previous
    controller (cleanly stopped or SIGKILLed mid-sweep) left behind,
    then the scheduler simply dispatches the queue.
    """
    from distributed_membership_tpu_torch.elastic.migrate import (
        MigratePolicy)
    # Policy is always built (manual POST /migrate works regardless);
    # migrate_on decides which health signals trigger AUTOMATIC moves.
    policy = MigratePolicy.from_conf(migrate_on, migrate_max)
    os.makedirs(root, exist_ok=True)
    registry = Registry(root)
    orphans = reap_orphans(registry.journal.read(), root)
    if orphans:
        print(f"fleet: reaped {orphans} orphaned worker(s) from a "
              "previous controller", flush=True)
    rings = sweep_stale_rings()
    if rings:
        print(f"fleet: unlinked {rings} stale snapshot ring(s) from "
              "dead daemons", flush=True)
    recovered = registry.recover()
    lock = threading.Lock()
    scheduler = Scheduler(registry, max_concurrency, lock,
                          linger=linger, policy=policy, device=device)
    state = FleetState(registry, scheduler, lock, linger=linger)
    try:
        server = make_fleet_server(state, port)
    except api.PortInUseError as e:
        print(port_in_use_hint(e, root), file=sys.stderr, flush=True)
        return 2
    state.port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="fleet-api").start()
    write_beacon(os.path.join(root, FLEET_JSON),
                 {"port": state.port, "pid": os.getpid(),
                  "root": os.path.abspath(root),
                  "max_concurrency": int(max_concurrency),
                  "linger": int(linger), "device": device})
    print(f"fleet: listening on 127.0.0.1:{state.port} "
          f"(pid {os.getpid()}, max {max_concurrency} workers on "
          f"{device}"
          + (", linger" if linger else "") + ")", flush=True)
    if any(recovered.values()):
        print(f"fleet: journal replayed — {recovered['adopted']} "
              f"adopted from disk, {recovered['requeued']} requeued "
              f"for --resume, {recovered['kept']} kept", flush=True)
    if threading.current_thread() is threading.main_thread():
        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(
                    s, lambda *_: state.stop_event.set())
            except (ValueError, OSError):   # pragma: no cover
                pass
    scheduler.start()
    try:
        state.stop_event.wait()
    except KeyboardInterrupt:
        pass
    finally:
        print("fleet: stopping (checkpointing live workers)",
              flush=True)
        scheduler.shutdown()
        server.shutdown()
        server.server_close()
    return 0


def fleet_conf(conf_path: Optional[str], port: Optional[int] = None,
               out_dir: str = ".", device: str = "cuda") -> int:
    """CLI entry (``--fleet``): FLEET_* keys from an optional conf,
    ``--port``/``--out-dir`` winning over it, then :func:`fleet_main`.

    The conf is parsed without full validation — a fleet conf only
    needs the FLEET_* keys, not a runnable simulation — but the fleet
    keys themselves are range-checked here (same messages as
    ``Params.validate``)."""
    params = Params()
    if conf_path is not None:
        params = Params.from_file(conf_path, validate=False)
    if port is not None:
        params.FLEET_PORT = port
    elif params.FLEET_PORT < 0:
        params.FLEET_PORT = 0          # --fleet alone: ephemeral port
    if not 0 <= params.FLEET_PORT <= 65535:
        print(f"fleet: FLEET_PORT must be in 0..65535, got "
              f"{params.FLEET_PORT}", file=sys.stderr)
        return 2
    if params.FLEET_MAX_CONCURRENCY < 1 or params.FLEET_LINGER not in (
            0, 1):
        print("fleet: FLEET_MAX_CONCURRENCY must be >= 1 and "
              "FLEET_LINGER 0 or 1", file=sys.stderr)
        return 2
    try:
        from distributed_membership_tpu_torch.elastic.migrate import (
            MigratePolicy)
        MigratePolicy.from_conf(params.FLEET_MIGRATE_ON,
                                params.FLEET_MIGRATE_MAX)
    except ValueError as e:
        print(f"fleet: {e}", file=sys.stderr)
        return 2
    root = params.FLEET_DIR or out_dir
    return fleet_main(root, port=params.FLEET_PORT,
                      max_concurrency=params.FLEET_MAX_CONCURRENCY,
                      linger=bool(params.FLEET_LINGER),
                      migrate_on=params.FLEET_MIGRATE_ON,
                      migrate_max=params.FLEET_MIGRATE_MAX,
                      device=device)
