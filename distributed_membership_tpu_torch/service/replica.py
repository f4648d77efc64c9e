"""Read-replica worker: the GET surface served from the shm ring
(counterpart of the JAX package's ``service/replica.py``).  A replica is
a host process: it never initialises CUDA.

One replica is one OS process (``python -m
distributed_membership_tpu_torch.service.replica``) that maps the daemon's
snapshot ring (service/shm_ring.py) read-only and answers the full
query surface — ``/healthz``, ``/v1/census``, ``/v1/member/<id>``,
``/v1/timeline``, ``/v1/stream`` — through the very same
``api.route_get`` the engine daemon uses, so replies are byte-for-byte
what the engine would have sent (the census is the engine's own
pre-encoded bytes; member records re-encode the same scalar dict).
Writes never come here: ``/v1/events`` and the admin verbs stay on the
engine daemon (a direct POST answers 405 with that hint), which is
what keeps journaling/replay bit-exactness untouched by the pool.

Lifecycle: the daemon spawns replicas with a pipe on stdin and a
JSON hello line expected on stdout (``{"port": ..., "pid": ...}``).
Parent death — clean or SIGKILL — closes the pipe; the stdin watcher
then best-effort unlinks the ring segment (idempotent across the
pool) and exits, so a SIGKILLed daemon leaks no /dev/shm segment.  An
individually killed replica (SIGTERM) just exits WITHOUT unlinking:
the ring still feeds its surviving siblings.

Each replica drops a ``replica_<i>.json`` beacon (the shared
observability/beacon.py format) next to the run every second: queries
served,
q/s over the last interval, sampled server-side p50/p99, snapshot
tick/generation and the engine-tick lag — scripts/run_report.py
renders these as the query-tier rows.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from typing import Optional

from distributed_membership_tpu_torch.observability import metricsbus
from distributed_membership_tpu_torch.observability.beacon import write_beacon
from distributed_membership_tpu_torch.service import api
from distributed_membership_tpu_torch.service.shm_ring import ShmRingReader

BEACON_INTERVAL_S = 1.0


class ShmSnapshot:
    """Snapshot facade over one validated ring slot — the same duck
    type ``api.route_get`` consumes (``n``/``tick``/``census_json``/
    ``member``), built zero-copy: the [N,S] planes and derived [N]
    stats stay in shared memory; ``member`` copies ten scalars."""

    def __init__(self, slot, n: int):
        self._slot = slot
        self.n = n
        self.tick = slot.tick

    def census_json(self) -> bytes:
        return self._slot.census

    def member(self, i: int) -> dict:
        a = self._slot.arrays
        # Field order matches Snapshot.member exactly: the JSON bytes
        # must be identical to the engine daemon's reply.
        return {
            "id": int(i),
            "tick": self.tick,
            "live": bool(a["live"][i]),
            "suspected": bool(a["suspected"][i]),
            "removed": bool(a["removed"][i]),
            "started": bool(a["started"][i]),
            "in_group": bool(a["in_group"][i]),
            "self_hb": int(a["self_hb"][i]),
            "known_by": int(a["known_by"][i]),
            "suspected_by": int(a["suspected_by"][i]),
            "best_heartbeat": int(a["best_hb"][i]),
            "staleness": int(a["staleness"][i]),
        }

    def valid(self) -> bool:
        return self._slot.valid()


class _ShmStore:
    """SnapshotStore duck type: ``get`` re-validates the seqlock and
    hands back a fresh slot when the writer lapped the cached one."""

    def __init__(self, reader: ShmRingReader):
        self._reader = reader
        self._cached: Optional[ShmSnapshot] = None

    def get(self) -> Optional[ShmSnapshot]:
        # Freshness, not just validity: a slot stays valid until ITS
        # slot is rewritten — B-1 publications after it stopped being
        # the newest — so "cached and valid" alone would serve reads
        # up to B-1 boundaries stale.  The gen scan is 8 bytes/slot.
        snap = self._cached
        if (snap is not None and snap.valid()
                and snap._slot.gen == self._reader.newest_gen()):
            return snap
        slot = self._reader.latest()
        if slot is None:
            # Mid-write across every slot: keep serving the cached
            # snapshot while it holds rather than flapping to 503.
            return snap if snap is not None and snap.valid() else None
        self._cached = ShmSnapshot(slot, self._reader.n)
        return self._cached


class ReplicaState:
    """ControlState's GET surface, backed by the ring."""

    def __init__(self, reader: ShmRingReader, index: int,
                 timeline: Optional[str]):
        self.reader = reader
        self.index = index
        self.store = _ShmStore(reader)
        self.total = reader.total
        self.port: Optional[int] = None
        self.queries = 0
        self.stop_event = threading.Event()
        self._timeline = timeline or None
        self._lock = threading.Lock()
        self.lat = metricsbus.LatencyReservoir()
        self._metrics = metricsbus.MetricsRegistry(
            constlabels={"replica": str(index)})
        m = self._metrics
        self._m_queries = m.counter(
            "dm_queries_total", "Queries served by this surface")
        self._m_qps = m.gauge(
            "dm_queries_per_sec", "Query rate since the last scrape")
        self._m_p50 = m.gauge(
            "dm_query_p50_ms", "Sampled query latency p50 (ms)")
        self._m_p99 = m.gauge(
            "dm_query_p99_ms", "Sampled query latency p99 (ms)")
        self._m_snap_tick = m.gauge(
            "dm_snapshot_tick", "Tick of the freshest served snapshot")
        self._m_eng_tick = m.gauge(
            "dm_engine_tick", "Engine tick (from the ring header)")
        self._m_lag = m.gauge(
            "dm_snapshot_lag_ticks",
            "Engine tick minus served snapshot tick")
        self._rate = metricsbus.ScrapeRate()

    def count_query(self) -> None:
        with self._lock:
            self.queries += 1

    def record_latency(self, ms: float) -> None:
        self.lat.record(ms)

    def latency_percentiles(self) -> dict:
        return self.lat.percentiles()

    def metrics_text(self) -> str:
        eng = self.reader.engine()
        snap = self.store.get()
        q = self.queries
        self._m_queries.set_total(q)
        self._m_qps.set(self._rate.rate(q))
        pct = self.lat.percentiles()
        if pct["p50_ms"] is not None:
            self._m_p50.set(pct["p50_ms"])
            self._m_p99.set(pct["p99_ms"])
        self._m_eng_tick.set(eng["tick"])
        self._m_snap_tick.set(-1 if snap is None else snap.tick)
        self._m_lag.set(-1 if snap is None
                        else max(eng["tick"] - snap.tick, 0))
        return self._metrics.render()

    def health(self) -> dict:
        eng = self.reader.engine()
        snap = self.store.get()
        return {
            "status": eng["status"],
            "tick": eng["tick"],
            "total": self.total,
            "role": "replica",
            "replica_index": self.index,
            "n": self.reader.n,
            "port": self.port,
            "queries_served": self.queries,
            "applied_events": eng["applied_events"],
            "snapshot_tick": None if snap is None else snap.tick,
            "snapshot_gen": (None if snap is None
                             else snap._slot.gen // 2),
        }

    def timeline_path(self) -> Optional[str]:
        return self._timeline

    def stopped(self) -> bool:
        return self.stop_event.is_set()

    def run_complete(self) -> bool:
        return self.reader.engine()["status"] in ("complete",
                                                  "interrupted")


def make_replica_server(state: ReplicaState, port: int):
    class Handler(api.ApiHandler):
        def _route_get(self):
            upath, _, query = self.path.partition("?")
            if state.lat.should_sample(state.queries):
                t0 = time.perf_counter()
                api.route_get(self, state, upath, query)
                state.record_latency((time.perf_counter() - t0) * 1e3)
            else:
                api.route_get(self, state, upath, query)

        def _route_post(self):
            self._json(405, {"error": "read replica: POST to the "
                                      "engine daemon (see "
                                      "service.json port)"})

    return api.bind_server(Handler, port)


def beacon_path(out_dir: str, index: int) -> str:
    return os.path.join(out_dir, f"replica_{index}.json")


def _write_beacon(state: ReplicaState, out_dir: str,
                  prev: dict) -> dict:
    now = time.monotonic()
    q = state.queries
    dt = now - prev["t"]
    qps = (q - prev["q"]) / dt if dt > 0 else 0.0
    eng = state.reader.engine()
    snap = state.store.get()
    doc = {
        "role": "replica",
        "index": state.index,
        "pid": os.getpid(),
        "port": state.port,
        "queries": q,
        "qps": round(qps, 1),
        "snapshot_tick": None if snap is None else snap.tick,
        "snapshot_gen": (None if snap is None
                         else snap._slot.gen // 2),
        "engine_tick": eng["tick"],
        "engine_status": eng["status"],
        "tick_lag": (None if snap is None
                     else max(eng["tick"] - snap.tick, 0)),
    }
    doc.update(state.latency_percentiles())
    write_beacon(beacon_path(out_dir, state.index), doc)
    return {"t": now, "q": q}


def replica_main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="replica")
    ap.add_argument("--ring", required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--dir", default=".")
    ap.add_argument("--index", type=int, default=0)
    ap.add_argument("--timeline", default="")
    args = ap.parse_args(argv)

    reader = ShmRingReader(args.ring)
    state = ReplicaState(reader, args.index, args.timeline)
    server = make_replica_server(state, args.port)
    state.port = server.server_address[1]

    def _shutdown(signum, frame):
        # Individual kill: exit WITHOUT unlinking (siblings still
        # read the ring); the daemon owns normal teardown.
        state.stop_event.set()
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)

    def _watch_parent():
        try:
            sys.stdin.buffer.read()     # EOF = parent is gone
        except Exception:
            pass
        state.stop_event.set()
        # Parent died (possibly SIGKILL): last one out of the pool
        # turns off the lights.  Unlink is idempotent; attached
        # siblings keep their mappings.
        try:
            reader.unlink()
        except Exception:
            pass
        os._exit(0)

    threading.Thread(target=_watch_parent, daemon=True,
                     name="parent-watch").start()

    print(json.dumps({"port": state.port, "pid": os.getpid()}),
          flush=True)

    def _beacons():
        prev = {"t": time.monotonic(), "q": 0}
        while not state.stop_event.is_set():
            prev = _write_beacon(state, args.dir, prev)
            state.stop_event.wait(BEACON_INTERVAL_S)
        _write_beacon(state, args.dir, prev)

    threading.Thread(target=_beacons, daemon=True,
                     name="beacon").start()

    server.serve_forever()
    server.server_close()
    reader.close()
    return 0


if __name__ == "__main__":
    sys.exit(replica_main())
