"""Stdlib threaded HTTP API for the membership control plane
(counterpart of the JAX package's ``service/api.py``).

No new dependencies: ``http.server.ThreadingHTTPServer`` with one
daemon thread per connection.  Every query is answered from the
published :class:`~service.snapshot.Snapshot` (or the on-disk flight
recorder for /v1/timeline and /v1/stream) — handler threads never
touch device state, never block the tick engine, and a torn client
connection kills only its own thread (BrokenPipe is swallowed).

The route logic lives in module-level functions (:func:`route_get`,
:func:`route_post`) that take the ControlState and a path with any
mount prefix ALREADY STRIPPED — so the same handlers answer the
single-run daemon's bare paths (``/v1/census``), the read replicas',
and the fleet controller's prefixed ones (fleet/daemon.py proxies
``/v1/runs/<id>/...`` to a worker daemon's handlers).

Endpoints (README "Service"):

  GET  /healthz               liveness + run phase + snapshot tick
  GET  /metrics               Prometheus text (observability/metricsbus)
  GET  /v1/census             cluster-level counts from the snapshot
  GET  /v1/member/<id>        one member's O(1) record
  GET  /v1/timeline?from=T    merged per-tick series from timeline.jsonl
  GET  /v1/stream             SSE of per-tick telemetry scalars
  POST /v1/events             inject scenario events (202 on accept)
  POST /v1/admin/checkpoint   wait for the next durable checkpoint
  POST /v1/admin/shutdown     graceful: finish segment, final
                              checkpoint + flush, exit 0
"""

from __future__ import annotations

import errno
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

SSE_POLL_SECONDS = 0.25
# The most of the interpreter the daemon's own API may take while the
# engine runs.  The engine (the main thread) gives up the GIL at every
# torch op and must win it back each time: closed-loop clients in its
# process, with a handler thread each, win it instead and stall the
# tick many times over.  So requests take turns on one lock, and while
# the engine runs they hold it idle for (1/QUERY_SHARE - 1) times the
# CPU time their threads took (not their wall time, which counts the
# waits for the GIL the engine holds): what a busy query tier loses is
# throughput, and its queueing shows in the sampled latency, which
# counts from arrival.  A thread's CPU clock may advance in whole
# scheduler ticks (10 ms), so the idle time owed is paid off at most
# MAX_HOLD_S per request and the rest carried to the next ones.
QUERY_SHARE = 0.1
MAX_HOLD_S = 0.01


class QueryGate:
    """One request at a time; while ``live()``, idle holds after them,
    so requests take at most ``share`` of the interpreter."""

    def __init__(self, live, share: float = QUERY_SHARE):
        self.live = live
        self.share = share
        self._lock = threading.Lock()
        self._owed = 0.0            # idle seconds not yet held

    def enter(self) -> float:
        self._lock.acquire()
        return time.thread_time()

    def leave(self, t0: float) -> None:
        try:
            if self.live():
                self._owed += ((time.thread_time() - t0)
                               * (1.0 / self.share - 1.0))
                hold = min(self._owed, MAX_HOLD_S)
                self._owed -= hold
                time.sleep(hold)
            else:
                self._owed = 0.0
        finally:
            self._lock.release()


class PortInUseError(OSError):
    """``bind()`` failed with EADDRINUSE — the CLI entries turn this
    into a run-dir hint + exit 2 instead of a raw traceback."""

    def __init__(self, port: int):
        super().__init__(errno.EADDRINUSE,
                         f"port {port} is already in use")
        self.port = port


def _timeline_rows(path: str, start: int):
    """Per-tick scalar dicts from tick ``start`` on (torn-tolerant)."""
    from distributed_membership_tpu_torch.observability.timeline import (
        TELEMETRY_FIELDS, read_timeline)
    series = read_timeline(path)
    ticks = int(series.get("ticks", 0))
    t0 = int(series.get("t0", 0))
    rows = []
    for i in range(max(start - t0, 0), ticks):
        row = {"t": t0 + i}
        row.update({f: int(series[f][i]) for f in TELEMETRY_FIELDS
                    if f in series})
        rows.append(row)
    return rows


class ApiHandler(BaseHTTPRequestHandler):
    """Shared HTTP plumbing for the service AND fleet servers.

    Subclasses implement ``_route_get``/``_route_post``; everything
    transport-level (keep-alive, Nagle, JSON replies, torn-client
    tolerance) lives here once.
    """

    # Content-Length is set on every JSON reply, so keep-alive is
    # safe — and it is what lets the bench's 8 query clients reuse
    # connections instead of paying a TCP handshake per query.
    protocol_version = "HTTP/1.1"
    # Every reply is two small writes on an unbuffered wfile (the
    # header buffer flush, then the body); with Nagle on, the body
    # write sits behind the peer's delayed ACK — a ~40 ms stall per
    # request that caps one keep-alive client near 25 queries/s.
    disable_nagle_algorithm = True

    # The daemon's server sets a QueryGate (make_server); the replicas'
    # run ungated, in processes of their own.
    gate = None
    _gate_t0 = None

    def log_message(self, fmt, *args):   # stdlib default is stderr
        pass

    def handle_one_request(self):
        try:
            super().handle_one_request()
        finally:
            self.leave_gate()

    def parse_request(self):
        # The request line has arrived: wait for the gate here, so the
        # header parse, the route and the reply all run under it.
        self.arrived = time.perf_counter()
        if self.gate is not None:
            self._gate_t0 = self.gate.enter()
        return super().parse_request()

    def leave_gate(self) -> None:
        """Give the gate back (a reply that blocks calls this first)."""
        if self._gate_t0 is not None:
            t0, self._gate_t0 = self._gate_t0, None
            self.gate.leave(t0)

    def _json(self, code: int, obj: dict) -> None:
        self._body(code, (json.dumps(obj) + "\n").encode())

    def _body(self, code: int, body: bytes,
              ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def read_json_body(self):
        """→ parsed JSON body, or None after replying 400."""
        length = int(self.headers.get("Content-Length", 0))
        try:
            return json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError as e:
            self._json(400, {"error": f"invalid JSON ({e})"})
            return None

    def do_GET(self):
        try:
            self._route_get()
        except (BrokenPipeError, ConnectionResetError):
            pass            # client went away; its thread exits

    def do_POST(self):
        try:
            self._route_post()
        except (BrokenPipeError, ConnectionResetError):
            pass


def route_get(h: ApiHandler, state, upath: str, query: str) -> None:
    """The run-surface GET routes, mount-point agnostic: ``upath`` has
    any prefix already stripped.  ``state`` is the daemon's
    ControlState; ``h`` the handler to reply on."""
    if upath == "/metrics":
        # Before count_query: a scraper polling every second must not
        # inflate the query-tier q/s it is trying to observe.
        text = state.metrics_text()
        h._body(200, text.encode(),
                ctype="text/plain; version=0.0.4; charset=utf-8")
        return
    state.count_query()

    def _snapshot():
        snap = state.store.get()
        if snap is None:
            h._json(503, {"error": "no snapshot published yet"})
        return snap

    if upath == "/healthz":
        h._json(200, state.health())
    elif upath == "/v1/census":
        snap = _snapshot()
        if snap is not None:
            h._body(200, snap.census_json())
    elif upath.startswith("/v1/member/"):
        snap = _snapshot()
        if snap is None:
            return
        try:
            i = int(upath[len("/v1/member/"):])
        except ValueError:
            h._json(400, {"error": "member id must be an int"})
            return
        if not 0 <= i < snap.n:
            h._json(404, {"error": f"member {i} out of range "
                                   f"[0, {snap.n})"})
            return
        h._json(200, snap.member(i))
    elif upath == "/v1/timeline":
        path = state.timeline_path()
        if not path or not os.path.exists(path):
            h._json(404, {"error": "no timeline (run with "
                                   "TELEMETRY scalars and a "
                                   "TELEMETRY_DIR)"})
            return
        q = parse_qs(query)
        start = int(q.get("from", ["0"])[0])
        h._json(200, {"from": start,
                      "rows": _timeline_rows(path, start)})
    elif upath == "/v1/stream":
        stream(h, state)
    else:
        h._json(404, {"error": f"unknown path {upath!r}"})


def route_post(h: ApiHandler, state, upath: str) -> None:
    """The run-surface POST routes (same stripping contract as
    :func:`route_get`)."""
    if upath == "/v1/events":
        body = h.read_json_body()
        if body is None:
            return
        events = (body.get("events", [body])
                  if isinstance(body, dict) else body)
        code, reply = state.inject(events)
        h._json(code, reply)
    elif upath == "/v1/admin/checkpoint":
        h.leave_gate()
        code, reply = state.checkpoint_barrier()
        h._json(code, reply)
    elif upath == "/v1/admin/shutdown":
        state.request_shutdown()
        h._json(200, {"stopping": True,
                      "status": state.status})
    else:
        h._json(404, {"error": f"unknown path {upath!r}"})


def stream(h: ApiHandler, state) -> None:
    """SSE: per-tick telemetry scalars as they reach the on-disk
    timeline, one ``data:`` message per tick.  The loop ends when the
    client disconnects (a write raises) or the daemon stops.  Idle
    polls write an SSE comment keepalive — without it a disconnected
    client is only noticed at the next data row, so a stream opened
    against a paused run would pin its handler thread (and the
    socket) until the daemon exits."""
    h.leave_gate()
    path = state.timeline_path()
    if not path:
        h._json(404, {"error": "no telemetry stream (run "
                               "with TELEMETRY scalars and "
                               "a TELEMETRY_DIR)"})
        return
    h.send_response(200)
    h.send_header("Content-Type", "text/event-stream")
    h.send_header("Cache-Control", "no-cache")
    h.send_header("Connection", "close")
    h.end_headers()
    sent_to = 0
    while not state.stopped():
        wrote = False
        if os.path.exists(path):
            for row in _timeline_rows(path, sent_to):
                msg = f"data: {json.dumps(row)}\n\n".encode()
                h.wfile.write(msg)
                sent_to = row["t"] + 1
                wrote = True
        if state.run_complete() and sent_to >= state.total:
            break
        if not wrote:
            # Keepalive comment: detects a gone client within one
            # poll period even when no new ticks are flowing.
            h.wfile.write(b": keepalive\n\n")
        h.wfile.flush()
        time.sleep(SSE_POLL_SECONDS)


def bind_server(handler_cls, port: int,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Bind (not start) a threaded server; EADDRINUSE becomes the
    typed :class:`PortInUseError` the CLI entries catch."""
    try:
        server = ThreadingHTTPServer((host, port), handler_cls)
    except OSError as e:
        if e.errno == errno.EADDRINUSE:
            raise PortInUseError(port) from e
        raise
    server.daemon_threads = True
    return server


def make_server(state, port: int) -> ThreadingHTTPServer:
    """Build (not start) the API server bound to 127.0.0.1:``port``
    (0 = ephemeral).  ``state`` is the daemon's ControlState."""

    class Handler(ApiHandler):
        gate = QueryGate(lambda: state.engine_running)

        def _route_get(self):
            # partition, not urlparse: census/member are the bench's
            # hot path and carry no query string.
            upath, _, query = self.path.partition("?")
            # Sampled server-side latency (the replica pool's scheme,
            # via the shared reservoir) when the state carries one,
            # from the request's arrival: the wait at the gate counts.
            lat = getattr(state, "lat", None)
            if lat is not None and lat.should_sample(state.queries):
                route_get(self, state, upath, query)
                lat.record((time.perf_counter() - self.arrived) * 1e3)
            else:
                route_get(self, state, upath, query)

        def _route_post(self):
            route_post(self, state, self.path)

    return bind_server(Handler, port)
