"""The control-plane daemon: serve driver + boundary hook (counterpart
of the JAX package's ``service/daemon.py``).

Layout of a served run (``--serve``):

  * the TICK ENGINE runs in the MAIN thread -- it is the unchanged
    backend entrypoint tail (``resolve_plan`` -> ``finish_run`` ->
    ``chunked_run``), so a served run computes byte-for-byte what the
    batch run computes, and the same as the JAX package's served run;
    it is the only thread that touches a CUDA tensor;
  * the HTTP API (service/api.py) runs on a daemon thread, answering
    from the published snapshot;
  * the seam between them is ``runtime/checkpoint.boundary_hook``: at
    every segment boundary the engine calls into :func:`_make_hook`'s
    closure with the device carry, which (a) at a publishing boundary
    (``SERVICE_SNAPSHOT_EVERY``) copies the six fields a
    :class:`~service.snapshot.Snapshot` reads to fresh host arrays in
    the JAX dtypes (:func:`pull_snapshot`, on the engine thread) and
    hands them to the publisher thread, (b) drains accepted injections
    into the segment runner of the merged plan (service/events.py,
    ``backends.tpu_hash.segment_runner`` or its sharded twin), and (c)
    relays a shutdown request as a ``stop``, which the engine honors by
    barriering the checkpoint writer and raising ``RunInterrupted`` --
    the graceful exit (finish segment, final checkpoint + timeline
    flush, exit 0).

After the run completes the daemon writes the batch artifacts
(dbg.log/stats.log/msgcount.log) and keeps serving the final snapshot
until ``POST /v1/admin/shutdown`` (or SIGTERM/SIGINT) stops it.
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace
from typing import List, Optional

from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.eventlog import EventLog
from distributed_membership_tpu_torch.observability import metricsbus, spans
from distributed_membership_tpu_torch.observability.beacon import (
    read_beacon, write_beacon)
from distributed_membership_tpu_torch.observability.metrics import (
    write_msgcount)
from distributed_membership_tpu_torch.service.events import (
    JOURNAL_NAME, EventJournal, apply_merge, base_events,
    injection_unsupported, validate_injection)
from distributed_membership_tpu_torch.service.snapshot import (
    SnapshotStore, decode_state)

SERVICE_JSON = "service.json"
# The carry fields decode_state reads.
SNAPSHOT_FIELDS = ("started", "in_group", "failed", "self_hb", "view",
                   "view_ts")


def pull_snapshot(carry) -> SimpleNamespace:
    """The six fields :func:`~service.snapshot.decode_state` reads, copied
    from the carry to fresh host arrays in the JAX dtypes (``view``
    uint32, ``view_ts`` int32): a published snapshot's arrays are never
    written again, whatever the engine does with its own buffers after
    this boundary."""
    from distributed_membership_tpu_torch.convert import host_leaf
    return SimpleNamespace(**{k: host_leaf(k, getattr(carry, k))
                              for k in SNAPSHOT_FIELDS})


class Pulled:
    """One publishing boundary's six fields: fresh host arrays already,
    or a pinned staging set lent by :class:`SnapshotStaging`."""

    def __init__(self, host=None, staging=None, bufs=None):
        self._host, self._staging, self._bufs = host, staging, bufs

    def arrays(self) -> SimpleNamespace:
        """Fresh host arrays in the JAX dtypes; a lent set goes back."""
        if self._bufs is None:
            return self._host
        try:
            return pull_snapshot(SimpleNamespace(**self._bufs))
        finally:
            self.release()

    def release(self) -> None:
        if self._bufs is not None:
            bufs, self._bufs = self._bufs, None
            self._staging.give_back(bufs)


class SnapshotStaging:
    """Where the hook pulls a CUDA carry's six fields: one of two pinned
    staging sets, filled at the pinned copy rate (a pageable ``cpu()``
    of a 1M S=128 view takes several times longer), then lent to the
    publisher thread, which copies it out to fresh host arrays
    (:meth:`Pulled.arrays`) off the engine thread and gives it back.
    The engine fills a set only once it has come back, so it waits only
    when the publisher is still copying one set while the other waits
    in its mailbox.  A CPU carry is copied to fresh arrays at once."""

    def __init__(self):
        self._free = [None, None]       # sets not lent out (None: unmade)
        self._cv = threading.Condition()

    def pull(self, carry) -> Pulled:
        import torch
        fields = {k: getattr(carry, k) for k in SNAPSHOT_FIELDS}
        if not fields["view"].is_cuda:
            return Pulled(host=pull_snapshot(carry))
        with self._cv:
            while not self._free:
                self._cv.wait()
            bufs = self._free.pop()
        if bufs is None or any(bufs[k].shape != x.shape
                               for k, x in fields.items()):
            bufs = {k: torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    for k, x in fields.items()}
        for k, x in fields.items():
            bufs[k].copy_(x, non_blocking=True)
        torch.cuda.current_stream(fields["view"].device).synchronize()
        return Pulled(staging=self, bufs=bufs)

    def give_back(self, bufs) -> None:
        with self._cv:
            self._free.append(bufs)
            self._cv.notify_all()


class SnapshotPublisher(threading.Thread):
    """The off-engine-thread snapshot pipeline.

    The boundary hook's only snapshot work is the pull of six fields
    (:class:`SnapshotStaging`) and :meth:`submit` -- stash the
    :class:`Pulled` fields and notify.  This thread does everything
    O(N*S): the copy out to fresh host arrays (never mutated
    afterwards), decode, the incremental (or fallback full) derive, the
    census pre-encode, the store swap, and the shm-ring write for the
    replica pool.  The mailbox is latest-wins: if the engine laps the
    publisher, intermediate boundaries are skipped (their staging sets
    given back), never queued -- boundary work on the engine thread
    stays the six-field pull regardless of publisher backlog, and no
    derive ever runs there (tests/test_torch_query_tier.py asserts it
    by thread identity).

    :meth:`drain` blocks until the newest submitted boundary is
    published — serve_run calls it before flipping the run status to
    complete, so the final snapshot is always visible to pollers that
    key on ``status``.
    """

    def __init__(self, state: "ControlState", ring=None):
        super().__init__(daemon=True, name="snapshot-publisher")
        self.state = state
        self.ring = ring
        self._cv = threading.Condition()
        self._item = None
        self._closing = False
        self._submitted: Optional[int] = None
        self._published: Optional[int] = None
        self.publishes = 0
        self.last_derive: Optional[dict] = None

    def submit(self, pulled: Pulled, tick: int) -> None:
        with self._cv:
            if self._item is not None:      # lapped: skip that boundary
                self._item[0].release()
            self._item = (pulled, int(tick))
            self._submitted = int(tick)
            self._cv.notify_all()

    def run(self) -> None:
        params = self.state.params
        n, tfail = params.EN_GPSZ, params.TFAIL
        prev = None
        while True:
            with self._cv:
                while self._item is None and not self._closing:
                    self._cv.wait()
                if self._item is None:
                    return
                pulled, tick = self._item
                self._item = None
            try:
                snap = decode_state(pulled.arrays(), tick, n, tfail)
                snap.precompute(prev)
            except AttributeError as e:   # undecodable carry layout
                self.state.snapshot_error = str(e)
                with self._cv:
                    self._published = tick
                    self._cv.notify_all()
                continue
            self.state.store.publish(snap)
            if self.ring is not None:
                try:
                    self.ring.publish(snap, prev)
                except Exception as e:
                    self.state.snapshot_error = f"shm publish: {e}"
            self.push_engine_meta()
            self.publishes += 1
            self.last_derive = snap.derive_info
            prev = snap
            with self._cv:
                self._published = tick
                self._cv.notify_all()

    def push_engine_meta(self) -> None:
        """Refresh the ring's lock-free engine-liveness fields (also
        called by serve_run on status transitions, so replicas see
        ``complete`` without waiting for another boundary)."""
        if self.ring is not None:
            try:
                self.ring.set_engine(self.state.status,
                                     self.state.tick,
                                     len(self.state.applied))
            except Exception:
                pass

    def backlog_ticks(self) -> int:
        """Submitted-minus-published tick gap — the watchdog's and
        /metrics' backlog signal (0 = the publisher is caught up)."""
        with self._cv:
            s, p = self._submitted, self._published
        if s is None:
            return 0
        return max(int(s) - int(p or 0), 0)

    def drain(self, timeout_s: float = 120.0) -> bool:
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while (self._item is not None
                   or self._published != self._submitted):
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
        return True

    def close(self) -> None:
        with self._cv:
            self._closing = True
            if self._item is not None:
                self._item[0].release()
                self._item = None
            self._cv.notify_all()


class ControlState:
    """Shared state between the engine (main thread) and the API
    handlers (per-connection daemon threads).  The lock covers the
    mutable command-queue fields; the snapshot path is lock-free
    (reference swap)."""

    def __init__(self, params: Params, plan, seed: int, total: int,
                 journal: Optional[EventJournal], base_evs: List[dict],
                 device="cuda"):
        self.params = params
        self.device = device
        self.plan = plan
        self.seed = int(seed)
        self.total = int(total)
        self.journal = journal
        self.base_events = base_evs
        self.store = SnapshotStore()
        self.status = "starting"   # running | complete | interrupted
        self.tick = 0
        self.port: Optional[int] = None
        self.queries = 0
        self.pending: List[dict] = []   # accepted, awaiting a boundary
        self.applied: List[dict] = []   # already merged into the plan
        self.applied_at: List[dict] = []  # [{tick, events}] audit trail
        self.snapshot_error = ""
        # The hook's host pulls (on the engine thread): how many, and
        # their seconds in all.
        self.staging = SnapshotStaging()
        self.pulls = 0
        self.pull_s = 0.0
        self.stop_event = threading.Event()
        # True while the engine runs segments: the query gate's cue
        # (service/api.py), which leaves the publisher's drain ungated.
        self.engine_running = False
        # serve_run arms these; unit-level ControlState uses stay None
        # (the boundary hook then publishes synchronously, underived).
        self.publisher: Optional[SnapshotPublisher] = None
        self.replicas: List[dict] = []      # [{index, port, pid}]
        self.shm_name: Optional[str] = None
        self._lock = threading.Lock()
        self._inject_unsupported = injection_unsupported(params)
        # Metrics plane: the engine daemon's /metrics registry.
        self.metrics = metricsbus.MetricsRegistry()
        m = self.metrics
        self._m_queries = m.counter(
            "dm_queries_total", "Queries served by this surface")
        self._m_qps = m.gauge(
            "dm_queries_per_sec", "Query rate since the last scrape")
        self._m_p50 = m.gauge(
            "dm_query_p50_ms", "Sampled query latency p50 (ms)")
        self._m_p99 = m.gauge(
            "dm_query_p99_ms", "Sampled query latency p99 (ms)")
        self._m_tick = m.gauge(
            "dm_engine_tick", "Engine tick at the last boundary")
        self._m_total = m.gauge(
            "dm_run_total_ticks", "Configured run length in ticks")
        self._m_snap_tick = m.gauge(
            "dm_snapshot_tick", "Tick of the freshest served snapshot")
        self._m_snap_age = m.gauge(
            "dm_snapshot_age_seconds",
            "Seconds since the served snapshot was decoded")
        self._m_snap_lag = m.gauge(
            "dm_snapshot_lag_ticks",
            "Engine tick minus served snapshot tick")
        self._m_pending = m.gauge(
            "dm_pending_events", "Accepted injections awaiting a "
            "segment boundary")
        self._m_applied = m.gauge(
            "dm_applied_events", "Injections merged into the plan")
        self._m_publishes = m.counter(
            "dm_publisher_publishes_total",
            "Snapshots the publisher thread derived and published")
        self._m_backlog = m.gauge(
            "dm_publisher_backlog_ticks",
            "Publisher submitted-minus-published tick gap")
        self.lat = metricsbus.LatencyReservoir()
        self._rate = metricsbus.ScrapeRate()
        # Event tracing (observability/spans.py): serve_run arms the
        # SpanLog; the seq counter is the journal position so resume
        # replay re-derives identical event ids.
        self.spans: Optional[spans.SpanLog] = None
        self.watchdog = None
        self._event_seq = 0
        self._pending_ids: List[str] = []
        # The run mesh (tpu_hash_sharded only), resolved ONCE by
        # serve_run and shared with the injection hook: the merged
        # runner must run on the very mesh the engine runs on, or the
        # swap would silently change the sharding.
        self.mesh = None

    # ---- query side -------------------------------------------------
    def count_query(self) -> None:
        with self._lock:
            self.queries += 1

    def record_latency(self, ms: float) -> None:
        self.lat.record(ms)

    def metrics_text(self) -> str:
        """GET /metrics: refresh the live gauges, render the registry.
        Runs on a handler thread — never the engine thread."""
        snap = self.store.get()
        q = self.queries
        self._m_queries.set_total(q)
        self._m_qps.set(self._rate.rate(q))
        pct = self.lat.percentiles()
        if pct["p50_ms"] is not None:
            self._m_p50.set(pct["p50_ms"])
            self._m_p99.set(pct["p99_ms"])
        self._m_tick.set(self.tick)
        self._m_total.set(self.total)
        self._m_snap_tick.set(-1 if snap is None else snap.tick)
        if snap is not None:
            self._m_snap_age.set(
                round(time.time() - snap.decoded_at, 3))
            self._m_snap_lag.set(max(self.tick - snap.tick, 0))
        self._m_pending.set(len(self.pending))
        self._m_applied.set(len(self.applied))
        if self.publisher is not None:
            self._m_publishes.set_total(self.publisher.publishes)
            self._m_backlog.set(self.publisher.backlog_ticks())
        return self.metrics.render()

    def health(self) -> dict:
        snap = self.store.get()
        h = {
            "status": self.status,
            "tick": self.tick,
            "total": self.total,
            "backend": self.params.BACKEND,
            "n": self.params.EN_GPSZ,
            "port": self.port,
            "queries_served": self.queries,
            "pending_events": len(self.pending),
            "applied_events": len(self.applied),
            "snapshot_tick": None if snap is None else snap.tick,
            "snapshot_age_s": (None if snap is None else
                               round(time.time() - snap.decoded_at, 3)),
        }
        if self.snapshot_error:
            h["snapshot_error"] = self.snapshot_error
        if self.publisher is not None:
            h["publishes"] = self.publisher.publishes
            h["derive"] = self.publisher.last_derive
            # Boundaries pulled but not published: lapped (latest-wins)
            # or still in the publisher's mailbox.
            h["publisher_skipped"] = self.pulls - self.publisher.publishes
        if self.pulls:
            h["host_pull"] = {"pulls": self.pulls,
                              "seconds": round(self.pull_s, 4)}
        if self.replicas:
            h["replicas"] = [{k: r[k] for k in ("index", "port", "pid")}
                             for r in self.replicas]
        return h

    def timeline_path(self) -> Optional[str]:
        if self.params.TELEMETRY_DIR and self.params.TELEMETRY != "off":
            from distributed_membership_tpu_torch.observability.timeline \
                import TIMELINE_NAME
            return os.path.join(self.params.TELEMETRY_DIR, TIMELINE_NAME)
        return None

    def stopped(self) -> bool:
        return self.stop_event.is_set()

    def run_complete(self) -> bool:
        return self.status in ("complete", "interrupted")

    # ---- command side -----------------------------------------------
    def inject(self, events) -> tuple:
        """POST /v1/events → (http_code, reply dict)."""
        if not isinstance(events, list):
            return 400, {"error": "body must be an event object or "
                                  "{'events': [...]}"}
        if self._inject_unsupported:
            return 409, {"error": self._inject_unsupported}
        if self.run_complete():
            return 409, {"error": f"run is {self.status}; no further "
                                  "segments to inject into"}
        with self._lock:
            # The hook drains under this lock and bumps self.tick at
            # the boundary FIRST, so this bound is the earliest
            # boundary the event is guaranteed to be merged at.
            next_tick = min(self.tick + self.params.CHECKPOINT_EVERY,
                            self.total)
            try:
                validate_injection(events, self.params, next_tick)
            except ValueError as e:
                return 400, {"error": str(e)}
            if self.journal is not None:
                # Durability before the ACK: an acknowledged event
                # survives any kill (RESUME replays the journal).
                self.journal.append(events)
            ids = []
            for ev in events:
                ids.append(spans.event_id(ev, self._event_seq))
                self._event_seq += 1
            self.pending.extend(events)
            self._pending_ids.extend(ids)
        if self.spans is not None:
            for eid, ev in zip(ids, events):
                self.spans.stamp(eid, "accepted", tick=self.tick,
                                 event=ev)
                if self.journal is not None:
                    self.spans.stamp(eid, "journaled", tick=self.tick)
        return 202, {"accepted": len(events), "apply_at_tick": next_tick,
                     "journaled": self.journal is not None}

    def checkpoint_barrier(self, timeout_s: float = 120.0) -> tuple:
        """POST /v1/admin/checkpoint: block until a checkpoint at or
        after the current tick is durable, return its tick."""
        from distributed_membership_tpu_torch.runtime.checkpoint import (
            manifest_tick)
        ckpt_dir = self.params.CHECKPOINT_DIR or None
        if not ckpt_dir:
            return 409, {"error": "no CHECKPOINT_DIR configured"}
        want = self.tick
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            t = manifest_tick(ckpt_dir)
            if t is not None and (t >= want or self.run_complete()):
                return 200, {"tick": int(t)}
            if self.stopped():
                break
            time.sleep(0.1)
        return 504, {"error": "timed out waiting for a durable "
                              "checkpoint", "durable_tick":
                     manifest_tick(ckpt_dir)}

    def request_shutdown(self) -> None:
        self.stop_event.set()


def _make_hook(state: ControlState):
    """The boundary-hook closure driving snapshots/injection/stop."""
    params = state.params
    n, tfail = params.EN_GPSZ, params.TFAIL
    decode_every = max(params.SERVICE_SNAPSHOT_EVERY, 1)
    boundary_no = [0]

    def hook(carry, tick: int):
        i, boundary_no[0] = boundary_no[0], boundary_no[0] + 1
        if i % decode_every == 0 or tick >= state.total:
            t_pull = time.perf_counter()
            try:
                pulled = state.staging.pull(carry)
            except AttributeError as e:   # undecodable carry
                state.snapshot_error = str(e)
            else:
                state.pulls += 1
                state.pull_s += time.perf_counter() - t_pull
                if state.publisher is not None:
                    # The pull is the engine thread's only O(N*S) work:
                    # the copy-out/decode/derive/census/shm pipeline
                    # runs on the publisher thread.
                    state.publisher.submit(pulled, tick)
                else:
                    state.store.publish(decode_state(pulled.arrays(), tick,
                                                     n, tfail))
        if i == 0 and state.spans is not None and state.applied:
            # Resume: the journal replay merged state.applied before
            # the first segment — stamp whatever stages the previous
            # life's spans.jsonl is missing (ids are deterministic in
            # journal order, so stamps land on the same spans; stages
            # already present are left alone — last-wins would clobber
            # the original wall clocks).
            have = spans.read_spans(state.spans.path)
            for seq, ev in enumerate(state.applied):
                eid = spans.event_id(ev, seq)
                stages = have.get(eid, {})
                if "accepted" not in stages:
                    state.spans.stamp(eid, "accepted", tick=tick,
                                      event=ev, replayed=True)
                if "journaled" not in stages:
                    state.spans.stamp(eid, "journaled", tick=tick,
                                      replayed=True)
                if "compiled" not in stages:
                    state.spans.stamp(eid, "compiled", tick=tick,
                                      replayed=True)
        upd = {}
        with state._lock:
            state.tick = tick
            drained, state.pending = state.pending, []
            drained_ids, state._pending_ids = state._pending_ids, []
        if state.watchdog is not None:
            state.watchdog.notify(tick)     # one Event.set — O(1)
        if drained:
            state.applied.extend(drained)
            state.applied_at.append({"tick": int(tick),
                                     "events": len(drained)})
            # Rebuild the segment runner from the merged plan and swap it
            # in from the NEXT segment on (its config, step and plan
            # tensors; the carry's shapes hold in EVENT_MODE full, the
            # injection gate).  The plan is mutated in place so
            # finish_run's tail (dbg lines, oracle) matches an
            # uninterrupted union-scenario run.
            apply_merge(params, state.plan, state.base_events,
                        state.applied, state.seed)
            if params.BACKEND == "tpu_hash_sharded":
                from distributed_membership_tpu_torch.backends \
                    .tpu_hash_sharded import sharded_segment_runner
                runner = sharded_segment_runner(
                    params, state.plan, state.seed, state.mesh, True,
                    state.total)
            else:
                from distributed_membership_tpu_torch.backends.tpu_hash \
                    import segment_runner
                runner = segment_runner(params, state.plan, state.seed,
                                        state.device, True, state.total)
            upd["segment_fn"] = runner.segment
            if state.spans is not None:
                # The merged runner takes effect from THIS boundary's
                # next segment — the tick the injection is live from.
                for eid in drained_ids:
                    state.spans.stamp(eid, "compiled", tick=tick)
        if state.stop_event.is_set():
            upd["stop"] = True
        return upd or None

    return hook


def _run_backend(params: Params, plan, log: EventLog, seed: int,
                 t0: float, device, mesh=None):
    """The backend entrypoint tail, with the resolved plan held by the
    CALLER (so the boundary hook can mutate it) -- otherwise identical
    to run_tpu_hash / run_tpu_hash_sharded.  ``mesh`` lets serve_run
    pass the mesh it already resolved for the injection hook."""
    from distributed_membership_tpu_torch.backends.tpu_sparse import (
        finish_run)
    if params.BACKEND == "tpu_hash_sharded":
        from distributed_membership_tpu_torch.backends.tpu_hash_sharded \
            import bind_run_scan, resolve_mesh
        mesh = mesh if mesh is not None else resolve_mesh(params, device)
        result = finish_run(params, plan, log, bind_run_scan(mesh), t0,
                            seed, mesh.device)
        result.extra["mesh_size"] = mesh.size
        return result
    from distributed_membership_tpu_torch.backends.tpu_hash import run_scan
    return finish_run(params, plan, log, run_scan, t0, seed, device)


def port_in_use_hint(err, out_dir: str) -> str:
    """Operator-facing message for a bind failure: name the run dir
    that owns the port when its discovery file says so (the common
    collision is re-serving an out-dir whose daemon is still up)."""
    lines = [f"service: cannot bind — {err.strerror}; pick another "
             "--port (or 0 for ephemeral), or stop the owner"]
    info = read_beacon(os.path.join(out_dir, SERVICE_JSON))
    if info is not None and info.get("port") == err.port:
        lines.append(
            f"service: {SERVICE_JSON} in {out_dir!r} records pid "
            f"{info.get('pid')} serving this run dir on port "
            f"{err.port} — that daemon likely still owns it")
    return "\n".join(lines)


def _write_service_json(out_dir: str, state: ControlState) -> None:
    os.makedirs(out_dir, exist_ok=True)
    doc = {"port": state.port, "pid": os.getpid(),
           "backend": state.params.BACKEND,
           "n": state.params.EN_GPSZ, "total": state.total}
    if state.replicas:
        doc["replicas"] = [{k: r[k] for k in ("index", "port", "pid")}
                           for r in state.replicas]
    if state.shm_name:
        doc["shm"] = state.shm_name
    write_beacon(os.path.join(out_dir, SERVICE_JSON), doc)


def _leash_sigterm():
    """preexec_fn for replicas: SIGTERM when the daemon dies (Linux
    PR_SET_PDEATHSIG) — the replica's handler distinguishes parent
    death (unlink the ring) from an individual kill (leave it)."""
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.prctl(1, signal.SIGTERM)      # PR_SET_PDEATHSIG = 1
    except Exception:
        pass


def spawn_replicas(state: ControlState, out_dir: str,
                   ring_name: str, workers: int) -> List[dict]:
    """Start ``workers`` read-replica processes against ``ring_name``
    and wait for each one's hello line (its bound port).  Replicas
    hold a stdin pipe (EOF = daemon gone, even on SIGKILL) and a
    PDEATHSIG leash; stdout carries exactly the one hello line, then
    beacons go to ``replica_<i>.json`` files."""
    import selectors
    timeline = state.timeline_path() or ""
    procs = []
    for i in range(workers):
        argv = [sys.executable, "-m",
                "distributed_membership_tpu_torch.service.replica",
                "--ring", ring_name, "--port", "0", "--dir", out_dir,
                "--index", str(i)]
        if timeline:
            argv += ["--timeline", timeline]
        kwargs = {}
        if os.name == "posix":
            kwargs["preexec_fn"] = _leash_sigterm
        procs.append(subprocess.Popen(
            argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, **kwargs))
    out = []
    try:
        for i, p in enumerate(procs):
            sel = selectors.DefaultSelector()
            sel.register(p.stdout, selectors.EVENT_READ)
            line = ""
            if sel.select(timeout=30):
                line = p.stdout.readline()
            sel.close()
            try:
                hello = json.loads(line)
                out.append({"index": i, "port": int(hello["port"]),
                            "pid": p.pid, "proc": p})
            except (ValueError, KeyError, TypeError):
                raise RuntimeError(
                    f"replica {i} failed to start (rc={p.poll()})")
    except BaseException:
        stop_replicas([{"proc": p} for p in procs])
        raise
    return out


def stop_replicas(replicas: List[dict]) -> None:
    """Tear the pool down: close stdin (the replicas' parent-death
    signal — they best-effort unlink the ring and exit), then
    escalate to kill for stragglers."""
    for r in replicas:
        p = r.get("proc")
        if p is None:
            continue
        for f in (p.stdin, p.stdout):
            try:
                if f:
                    f.close()
            except OSError:
                pass
    for r in replicas:
        p = r.get("proc")
        if p is None:
            continue
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


def resume_journal_run(params: Params, log: EventLog,
                       seed: Optional[int] = None, device="cuda"):
    """Headless ``--resume`` of a SERVED checkpoint: replay the
    acknowledged injections journaled beside the checkpoints, so a
    restart WITHOUT ``--serve`` still reproduces the served
    trajectory bit-exactly (dbg.log included — the merged plan also
    owns the 'Node failed' banner lines).

    Returns the RunResult, or None when there is nothing to replay
    (no journal / empty journal) and the plain backend path should
    run.  Called by ``run_conf`` whenever RESUME + CHECKPOINT_DIR are
    set; a non-empty journal on a backend the merge path cannot drive
    raises rather than silently dropping acknowledged events.  Runs on
    ``device`` (no CPU run when the card is missing:
    ``application.resolve_device``)."""
    from distributed_membership_tpu_torch.runtime.application import (
        resolve_device)
    from distributed_membership_tpu_torch.runtime.failures import resolve_plan
    device = resolve_device(device)
    path = os.path.join(params.CHECKPOINT_DIR, JOURNAL_NAME)
    if not os.path.exists(path):
        return None
    replay = EventJournal(path).read()
    if not replay:
        return None
    if params.BACKEND not in ("tpu_hash", "tpu_hash_sharded"):
        raise ValueError(
            f"checkpoint dir {params.CHECKPOINT_DIR!r} holds a service "
            f"event journal ({len(replay)} injected events) but backend "
            f"{params.BACKEND!r} cannot replay it — resume with the "
            "backend that served the run")
    t0 = time.time()
    seed = params.SEED if seed is None else seed
    plan = resolve_plan(params, random.Random(f"app:{seed}"))
    apply_merge(params, plan, base_events(params, plan), replay, seed)
    return _run_backend(params, plan, log, seed, t0, device)


def serve_run(params: Params, seed: Optional[int] = None,
              out_dir: str = ".", device="cuda") -> int:
    """Drive one served run to completion (or graceful stop); -> exit
    code.  ``params`` must already be validated with
    ``SERVICE_PORT >= 0``.  Runs the engine in the calling thread on
    ``device`` (no CPU run when the card is missing:
    ``application.resolve_device``) -- call from the main thread so
    SIGTERM/SIGINT get the graceful boundary-stop treatment
    (runtime/checkpoint.py)."""
    from distributed_membership_tpu_torch.runtime.application import (
        resolve_device)
    from distributed_membership_tpu_torch.runtime.checkpoint import (
        RunInterrupted, boundary_hook)
    from distributed_membership_tpu_torch.runtime.failures import resolve_plan
    from distributed_membership_tpu_torch.service import api

    device = resolve_device(device)
    t0 = time.time()
    seed = params.SEED if seed is None else seed
    log = EventLog(out_dir)
    plan = resolve_plan(params, random.Random(f"app:{seed}"))
    base_evs = base_events(params, plan)
    ckpt_dir = params.CHECKPOINT_DIR or None
    journal = (EventJournal(os.path.join(ckpt_dir, JOURNAL_NAME))
               if ckpt_dir else None)

    state = ControlState(params, plan, seed, params.TOTAL_TIME, journal,
                         base_evs, device)
    if params.BACKEND == "tpu_hash_sharded":
        from distributed_membership_tpu_torch.backends.tpu_hash_sharded \
            import resolve_mesh
        state.mesh = resolve_mesh(params, device)
    if journal is not None:
        if params.RESUME:
            # Replay acknowledged injections BEFORE the first segment:
            # the resumed run compiles the merged program from the
            # start (events are inert before their times, so the
            # pre-injection prefix is unchanged — bit-exactness pinned
            # in tests/test_torch_service.py).
            replay = journal.read()
            if replay:
                state.applied = list(replay)
                apply_merge(params, plan, base_evs, state.applied, seed)
        else:
            journal.reset()

    server = api.make_server(state, params.SERVICE_PORT)
    state.port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="service-api").start()

    # Query tier: every served run derives/encodes snapshots off the
    # engine thread; with SERVICE_WORKERS > 0 the publisher also lands
    # them in a shm ring feeding a pool of read-replica processes.
    ring = None
    workers = getattr(params, "SERVICE_WORKERS", 0)
    if workers > 0:
        import numpy as np

        from distributed_membership_tpu_torch.service.shm_ring import (
            ShmRingWriter)
        n = params.EN_GPSZ
        s = params.VIEW_SIZE if params.VIEW_SIZE > 0 else n
        ring = ShmRingWriter(
            n, s, np.uint32, np.int32, params.TFAIL, state.total,
            getattr(params, "SERVICE_SHM_BUFFERS", 4))
        state.shm_name = ring.name
    state.publisher = SnapshotPublisher(state, ring)
    state.publisher.start()
    replicas = []
    if workers > 0:
        try:
            replicas = spawn_replicas(state, out_dir, ring.name,
                                      workers)
        except BaseException:
            ring.close()
            raise
        state.replicas = replicas
        print(f"service: {len(replicas)} read replica(s) on ports "
              f"{[r['port'] for r in replicas]}", flush=True)

    # Event tracing: spans.jsonl beside the run (observability/
    # spans.py).  A fresh run clears the previous run's spans, the
    # same posture as journal.reset(); a resume keeps them so the
    # replay stamps land on the prior life's records.
    state.spans = spans.SpanLog(os.path.join(out_dir,
                                             spans.SPANS_NAME))
    if not params.RESUME:
        try:
            os.unlink(state.spans.path)
        except OSError:
            pass
    watchdog = None
    if getattr(params, "WATCHDOG", 1):
        from distributed_membership_tpu_torch.observability.runlog import (
            maybe_runlog)
        from distributed_membership_tpu_torch.observability.watchdog import (
            Watchdog)
        watchdog = Watchdog(
            state, out_dir,
            runlog=maybe_runlog(params.TELEMETRY_DIR or out_dir))
        state.watchdog = watchdog
        watchdog.start()

    _write_service_json(out_dir, state)
    print(f"service: listening on 127.0.0.1:{state.port} "
          f"(pid {os.getpid()})", flush=True)

    try:
        try:
            with boundary_hook(_make_hook(state)):
                state.status = "running"
                state.engine_running = True
                try:
                    result = _run_backend(params, plan, log, seed, t0,
                                          device, mesh=state.mesh)
                finally:
                    state.engine_running = False
        except RunInterrupted as e:
            state.status = "interrupted"
            state.publisher.drain()
            state.publisher.push_engine_meta()
            print(f"service: {e} — resume with --resume", flush=True)
            return 0
        # Final boundary visible BEFORE the status flips: pollers that
        # key on status == complete must see the final snapshot.
        state.publisher.drain()
        state.status = "complete"
        state.publisher.push_engine_meta()
        # The batch driver's artifact tail (runtime/application.py).
        result.log.flush(out_dir)
        if not result.extra.get("aggregate"):
            write_msgcount(result, out_dir)
        print(f"service: run complete at tick {state.tick}; serving "
              "until /v1/admin/shutdown", flush=True)
        try:
            state.stop_event.wait()
        except KeyboardInterrupt:
            pass
        return 0
    finally:
        if watchdog is not None:
            watchdog.close()
        server.shutdown()
        server.server_close()
        state.publisher.close()
        if replicas:
            stop_replicas(replicas)
        if ring is not None:
            ring.close()


def serve_conf(conf_path: str, port: Optional[int] = None,
               out_dir: str = ".", device="cuda", **overrides) -> int:
    """CLI entry (``--serve``): parse + override like ``run_conf``,
    arm SERVICE_PORT, validate, then :func:`serve_run`."""
    from distributed_membership_tpu_torch.runtime.application import (
        apply_overrides)
    from distributed_membership_tpu_torch.service.api import PortInUseError
    seed = overrides.pop("seed", None)
    params = Params.from_file(conf_path, validate=False)
    apply_overrides(params, **overrides)
    if port is not None:
        params.SERVICE_PORT = port
    elif params.SERVICE_PORT < 0:
        params.SERVICE_PORT = 0       # --serve alone: ephemeral port
    params.validate()
    try:
        return serve_run(params, seed=seed, out_dir=out_dir, device=device)
    except PortInUseError as e:
        print(port_in_use_hint(e, out_dir), file=sys.stderr, flush=True)
        return 2
