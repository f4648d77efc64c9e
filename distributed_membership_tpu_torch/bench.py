"""Headline benchmark of the port: simulated node-ticks/s on one card (the
JAX package's root ``bench.py``, on the port).

Two legs, each run in a subprocess of its own (``python -m
distributed_membership_tpu_torch.bench --leg ...``):

  * ``hash``  -- the scale path (``tpu_hash``, bounded hashed views +
    SWIM round-robin probing), warm join, one crash, on-device event
    aggregation, at two view sizes: S=128 (K1-K3 on the card) and S=16
    (the folded layout, K5-K7, where ``FOLDED: -1`` folds on the card);
    the faster row headlines (the metric string carries its config);
  * ``dense`` -- the exact dense backend (``tpu``) at N=512.

On the card the size ladder climbs 2^16/100, 2^18/60 and 2^20/60 ticks
(the largest success headlines), then S=16 at 2^20 for 60 ticks, then
dense at N=512 for 100 ticks; with ``--device cpu`` one 2^16/40 rung.
``BENCH_N``, ``BENCH_TICKS`` and ``BENCH_DENSE_N`` override them.  Every
leg is timed live: a warm run (seed 0, the kernels' build included), then
the timed run (seed 1) between two ``torch.cuda.synchronize`` calls.  No
banked row ever stands in for a measurement, and nothing falls back to
the CPU: without a card (and without ``--device cpu``) the bench prints
one JSON line with ``"error"`` and exits 1; a leg that fails on the card
is reported under ``failed_legs`` (exit 1), never retried elsewhere.  A
leg that refuses its config (the port's ``NotImplementedError`` or a
``ValueError`` of the JAX package's gates) stops the bench.

``est_hbm_gbps`` is a model: the JAX program's passes over the ``[N, S]``
planes per tick over the wall, not a measured bandwidth.

Baseline: the C++ reference simulates 10 nodes x 700 ticks in 0.22-0.46 s
on one CPU core, ~15-32k node-ticks/s (BASELINE.md); ``vs_baseline`` is
against the top of that range.

Prints exactly one JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "platform": "cuda"|"cpu", "device": {"name", "power_limit"}, ...}

Env overrides, as the JAX bench: BENCH_N / BENCH_TICKS / BENCH_VIEW (hash
leg; gossip length and probes derive from the view size), BENCH_FUSED
(auto|off|recv|gossip|both|probe|all: ``auto`` and ``all`` run on the
card; the others pin some kernel off, which the port refuses there),
BENCH_FOLDED (auto|off|on), BENCH_SHIFT_SET, BENCH_DENSE_N, BENCH_TIMEOUT
(per-leg seconds), and the side legs, each re-timing the leg and adding
its fields: BENCH_CHECKPOINT=K (+ BENCH_CHECKPOINT_COMPRESS=1),
BENCH_TELEMETRY=1, BENCH_HIST=1, BENCH_MEGA=T, BENCH_RNG=1,
BENCH_SCENARIO=1, BENCH_CHAOS=1, BENCH_EXCHANGE=1, BENCH_RESHARD=1,
BENCH_SERVICE=1 (or BENCH_SERVICE_CONNECT=host:port), BENCH_METRICS=1 and
BENCH_FLEET=1.  The sharded legs (exchange, reshard) run eight shards on
the one device (:data:`SHARDS`).  BENCH_FPROBE is refused: its arms pin
``FUSED_PROBE`` off (refused on the card) and on (refused on the CPU).

Every live leg row is banked into the port's ledger (``--ledger``,
default ``artifacts/perf_ledger_torch.jsonl``; observability/perfdb.py),
keyed by the card's name, and checked against history: a regression
beyond the noise band prints a warning but never fails the bench.

Usage:
  python -m distributed_membership_tpu_torch.bench           # on the card
  BENCH_N=4096 BENCH_TICKS=20 python -m distributed_membership_tpu_torch.bench
  python -m distributed_membership_tpu_torch.bench --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

from distributed_membership_tpu_torch.observability.perfdb import (
    LEDGER_PATH)
from distributed_membership_tpu_torch.profile_step import sync as _sync

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "distributed_membership_tpu_torch.bench"
REFERENCE_NODE_TICKS_PER_SEC = 32_000.0  # BASELINE.md wall-clock row, best
# Shards of the one device the sharded legs run on: the JAX package's
# eight-device test mesh (its bench takes every local device).
SHARDS = 8
FPROBE_REFUSAL = (
    "BENCH_FPROBE: its unfused arm pins FUSED_PROBE: 0, which the port "
    "refuses on the card (the kernels are the path there), and its fused "
    "arm pins FUSED_PROBE: 1, which it refuses on the CPU; the probe "
    "kernels are timed against their plain versions in chip_smoke.py")
BANKED_REFUSAL = (
    "banked headlines: no banked row stands in for a live measurement; "
    "the port's bench times the card or fails")


def _child(*args: str) -> list:
    """The command line of this module in a child process."""
    return [sys.executable, "-m", MODULE, *args]


# --------------------------------------------------------------------------
# Legs (run in subprocesses; print one JSON line each)

def _timed_runs(run_scan, params, plan, ticks, device):
    """A warm run (seed 0; the kernels' build on a fresh tree), then the
    timed run (seed 1) between two synchronizes -> (wall seconds of the
    timed run, its final state)."""
    run_scan(params, plan, seed=0, device=device, collect_events=False,
             total_time=ticks)
    _sync(device)
    t0 = time.perf_counter()
    final_state, _ = run_scan(params, plan, seed=1, device=device,
                              collect_events=False, total_time=ticks)
    _sync(device)
    return time.perf_counter() - t0, final_state


def _interleaved_best(run_scan, ticks: int, base: tuple, arms: dict,
                      reps: int, base_wall: float, device) -> dict:
    """Interleaved best-of-R pairing, min per variant: single-shot walls
    on a busy host swing +-10%, drowning the few-percent overheads these
    comparison legs measure, so each arm is re-timed alongside the base
    and the per-variant minima are compared.  ``base``/``arms`` values
    are (params, plan) pairs; ``base_wall`` seeds the base's best with
    the wall the leg already measured.  Returns ``{"base": best, **{arm:
    best}}``."""
    walls = {"base": base_wall, **{name: None for name in arms}}
    for i in range(reps):
        if i > 0:
            b, _ = _timed_runs(run_scan, base[0], base[1], ticks, device)
            walls["base"] = min(walls["base"], b)
        for name, (pp, pl) in arms.items():
            w, _ = _timed_runs(run_scan, pp, pl, ticks, device)
            walls[name] = w if walls[name] is None else min(walls[name], w)
    return walls


def _bench_rng_micro(cfg, device) -> dict:
    """BENCH_RNG=1: the per-tick ring RNG plan (ops/rng_plan.hash_ring_rng)
    at this leg's geometry, with the drop-coin streams armed
    (use_drop=True), in ms.  The JAX bench prices two lowerings of the
    plan (scattered per-site draws against one batched vmapped draw); the
    port has one lowering, the batched plan's streams drawn by one
    function per tick (ops/rng_plan.py), so it reports ``rng_plan_ms``
    alone."""
    from distributed_membership_tpu_torch.ops.rng_plan import hash_ring_rng
    from distributed_membership_tpu_torch.ops.threefry import prng_key

    key = prng_key(0)

    def plan():
        return hash_ring_rng(
            key, n=cfg.n, s=cfg.s, g=cfg.g, k_max=min(cfg.fanout, cfg.s),
            p_cnt=max(cfg.probes, 0), seed_rows=min(cfg.seed_cap, cfg.n),
            use_drop=True, need_ctrl=True, need_burst=True, device=device,
            shift_set=cfg.shift_set)

    plan()
    _sync(device)
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        plan()
    _sync(device)
    return {"rng_plan_ms": round(1000 * (time.perf_counter() - t0) / reps,
                                 3)}


def _hostport(spec: str, default_host: str = "127.0.0.1"):
    """``"8080"`` or ``"host:8080"`` -> (host, port)."""
    host, _, p = spec.rpartition(":")
    return (host or default_host, int(p))


def _service_client_main(port: int, n: int, connect: str = "") -> int:
    """Hidden child mode (``--service-client``) for _bench_service.

    Hammers the daemon from a SEPARATE process — real clients do not
    share the engine's interpreter, so their own HTTP parsing must not
    be billed to the tick loop's GIL — with BENCH_SERVICE_CLIENTS
    paced keep-alive workers alternating ``/v1/census`` and
    ``/v1/member/<id>``.  The pacing (BENCH_SERVICE_QPS total offered
    load, default 800; 0 = unthrottled closed loop, for pricing the
    replica pool's ceiling rather than a dashboard workload) models
    polling dashboards rather than a closed-loop saturation attack:
    unthrottled in-process loops measure only how hard eight spinning
    clients can starve a shared host, not the serving overhead a
    dashboard's polling costs the engine.

    Targets: ``--connect host:port[,host:port...]`` (off-box service
    bench) or BENCH_SERVICE_PORTS (comma list, the replica pool)
    override the single local port; each client pins to one target, so
    K clients spread over the pool.  A dedicated depth-1 sampler
    connection measures request latency OUTSIDE the pipelined firehose
    (a pipelined stream's per-reply time is queueing, not service
    time) and polls ``/healthz`` for answer staleness (engine tick
    minus served snapshot tick).  Runs until stdin yields a line (or
    EOF), then prints one JSON line ``{"queries", "seconds",
    "p50_ms", "p99_ms", "staleness_mean_ticks", "staleness_max_ticks"}``.
    """
    import socket
    import threading

    clients = int(os.environ.get("BENCH_SERVICE_CLIENTS", "8"))
    target = float(os.environ.get("BENCH_SERVICE_QPS", "800"))
    throttled = target > 0
    interval = clients / max(target, 1e-9)
    stop = threading.Event()
    counts = [0] * clients

    depth = int(os.environ.get("BENCH_SERVICE_PIPELINE", "8"))
    # BENCH_SERVICE_PREFIX reroutes the same load through mount
    # prefixes — the fleet leg passes a comma-separated list of
    # ``/v1/runs/<id>`` mounts and each client sticks to one, so K
    # clients spread across the fleet's runs.
    prefixes = os.environ.get("BENCH_SERVICE_PREFIX", "").split(",")
    raw_ports = os.environ.get("BENCH_SERVICE_PORTS", "")
    if connect:
        targets = [_hostport(x) for x in connect.split(",") if x]
    elif raw_ports:
        targets = [_hostport(x) for x in raw_ports.split(",") if x]
    else:
        targets = [("127.0.0.1", port)]

    def worker(i):
        # Raw sockets, prebuilt request bytes, HTTP/1.1 pipelining
        # ``depth`` deep: on a box where the load generator shares
        # cores with the daemon, per-request object churn and a
        # scheduler wakeup per query would be billed to the tick loop.
        # BaseHTTPRequestHandler reads requests from a buffered rfile,
        # so pipelined requests are answered in order.
        pref = prefixes[i % len(prefixes)]
        host_i, port_i = targets[i % len(targets)]
        single = [(f"GET {pref}/v1/census HTTP/1.1\r\nHost: l\r\n\r\n"
                   .encode()
                   if (i + j) % 2 else
                   (f"GET {pref}/v1/member/{(j * 2654435761 + i) % n} "
                    "HTTP/1.1\r\nHost: l\r\n\r\n").encode())
                  for j in range(32)]
        batches = [b"".join(single[j % 32] for j in range(k, k + depth))
                   for k in range(32)]

        def connect():
            s = socket.create_connection((host_i, port_i),
                                         timeout=30)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return s

        sock = connect()
        buf = b""
        j = 0
        t_next = time.perf_counter()
        while not stop.is_set():
            try:
                sock.sendall(batches[j % 32])
                for _ in range(depth):
                    while b"\r\n\r\n" not in buf:
                        chunk = sock.recv(65536)
                        if not chunk:
                            raise ConnectionError("closed")
                        buf += chunk
                    head, _, buf = buf.partition(b"\r\n\r\n")
                    lo = head.lower()
                    k = lo.find(b"content-length:")
                    # Content-Length may be the LAST header (no
                    # trailing \r inside head), so split — a find(-1)
                    # slice would drop the final digit and desync the
                    # keep-alive stream.
                    clen = (int(lo[k + 15:].split(b"\r", 1)[0])
                            if k >= 0 else 0)
                    while len(buf) < clen:
                        chunk = sock.recv(65536)
                        if not chunk:
                            raise ConnectionError("closed")
                        buf += chunk
                    buf = buf[clen:]
                    if head[9:12] == b"200":
                        counts[i] += 1
            except (OSError, ValueError):
                try:
                    sock.close()
                except OSError:
                    pass
                if stop.is_set():
                    break
                try:
                    sock = connect()
                except OSError:
                    time.sleep(0.1)
                buf = b""
            j += 1
            if throttled:
                t_next += interval * depth
                lag = t_next - time.perf_counter()
                if lag > 0:
                    time.sleep(lag)
                else:
                    t_next = time.perf_counter()  # shed backlog
        try:
            sock.close()
        except OSError:
            pass

    lat_ms: list = []
    stale: list = []

    def sampler():
        """Depth-1 request/response round trips on a connection of
        their own: honest per-request latency, decoupled from the
        pipelined throughput streams; plus /healthz staleness probes
        (engine tick vs the tick of the snapshot answering reads)."""
        import http.client as _hc
        host_s, port_s = targets[0]
        pref = prefixes[0]
        conn = None
        next_health = 0.0
        k = 0
        while not stop.is_set():
            try:
                if conn is None:
                    conn = _hc.HTTPConnection(host_s, port_s,
                                              timeout=10)
                now = time.perf_counter()
                if now >= next_health:
                    next_health = now + 0.25
                    conn.request("GET", f"{pref}/healthz")
                    h = json.loads(conn.getresponse().read())
                    st, tick = h.get("snapshot_tick"), h.get("tick")
                    if st is not None and tick is not None:
                        stale.append(max(int(tick) - int(st), 0))
                    continue
                path = (f"{pref}/v1/census" if k % 2 else
                        f"{pref}/v1/member/{(k * 31) % n}")
                k += 1
                t0 = time.perf_counter()
                conn.request("GET", path)
                conn.getresponse().read()
                lat_ms.append((time.perf_counter() - t0) * 1e3)
                time.sleep(0.005)       # ~200 samples/s, off the path
            except (OSError, ValueError, _hc.HTTPException):
                try:
                    if conn is not None:
                        conn.close()
                except OSError:
                    pass
                conn = None
                time.sleep(0.1)

    workers = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(clients)]
    workers.append(threading.Thread(target=sampler, daemon=True))
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    sys.stdin.readline()
    seconds = max(time.perf_counter() - t0, 1e-9)
    stop.set()
    for w in workers:
        w.join(timeout=30)
    lat = sorted(lat_ms)
    out = {"queries": int(sum(counts)), "seconds": seconds,
           "p50_ms": (round(lat[len(lat) // 2], 4) if lat else None),
           "p99_ms": (round(lat[min(len(lat) - 1,
                                    int(len(lat) * 0.99))], 4)
                      if lat else None),
           "staleness_mean_ticks": (round(sum(stale) / len(stale), 2)
                                    if stale else None),
           "staleness_max_ticks": (max(stale) if stale else None)}
    print(json.dumps(out))
    return 0


def _bench_service(base_text: str, n: int, ticks: int, device) -> dict:
    """BENCH_SERVICE=1: price the membership control plane under load.

    The same leg re-run through the real batch tail (``resolve_plan`` ->
    ``finish_run`` -> chunked checkpointed run, artifacts flushed) twice:
    ``--serve`` off vs. the service daemon armed (service/daemon.py) with
    BENCH_SERVICE_CLIENTS (default 8) concurrent keep-alive HTTP clients
    alternating ``/v1/census`` and ``/v1/member/<id>`` reads off the
    boundary snapshot, driven from a subprocess
    (:func:`_service_client_main`).  Both arms run the same program, so
    the delta isolates the serving machinery: the API threads, the
    per-boundary snapshot publish, and answering the query load.
    Interleaved best-of-R as the telemetry leg; the client-side sustained
    query rate (successful responses over the first-snapshot->complete
    window, best rep) rides along."""
    import http.client as _hc
    import random as _pyrandom
    import shutil
    import tempfile
    import threading

    from distributed_membership_tpu_torch.backends.tpu_hash import run_scan
    from distributed_membership_tpu_torch.backends.tpu_sparse import (
        finish_run)
    from distributed_membership_tpu_torch.config import Params
    from distributed_membership_tpu_torch.eventlog import EventLog
    from distributed_membership_tpu_torch.observability.metrics import (
        write_msgcount)
    from distributed_membership_tpu_torch.runtime.failures import (
        resolve_plan)
    from distributed_membership_tpu_torch.service import daemon as _daemon

    clients = int(os.environ.get("BENCH_SERVICE_CLIENTS", "8"))
    reps = int(os.environ.get("BENCH_SERVICE_REPS", "2"))
    # BENCH_SERVICE_WORKERS=W arms the read-replica pool on the served
    # arm: the query load is then spread over the W replica processes
    # (BENCH_SERVICE_PORTS) instead of the engine daemon's own threads.
    workers = int(os.environ.get("BENCH_SERVICE_WORKERS", "0"))
    # Segment length sets the snapshot cadence; ticks//8 keeps one
    # segment shape while exercising several boundaries.
    every = int(os.environ.get("BENCH_SERVICE_EVERY",
                               str(max(ticks // 8, 1))))
    stats = []          # one {"queries", "seconds", ...} per served rep

    tmp = tempfile.mkdtemp(prefix="bench_service_")
    base_out = os.path.join(tmp, "base")
    serve_out = os.path.join(tmp, "serve")
    p_base = Params.from_text(
        base_text + f"CHECKPOINT_EVERY: {every}\n"
        f"CHECKPOINT_DIR: {os.path.join(base_out, 'ck')}\n")
    p_serve = Params.from_text(
        base_text + f"CHECKPOINT_EVERY: {every}\n"
        f"CHECKPOINT_DIR: {os.path.join(serve_out, 'ck')}\n"
        "SERVICE_PORT: 0\n"
        + (f"SERVICE_WORKERS: {workers}\n" if workers else ""))

    def _get(conn, path):
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()

    def _drive(out_dir, rec):
        """Client side of one served run: wait for the port, wait for
        the first snapshot, hammer with ``clients`` workers until the
        engine completes, then release the daemon's post-run serve
        loop.  Queries are counted over the snapshot->complete window
        only: the sustained rate while the tick loop is live."""
        sj = os.path.join(out_dir, _daemon.SERVICE_JSON)
        port, replicas = None, []
        deadline = time.time() + 600
        while time.time() < deadline:
            try:
                with open(sj) as fh:
                    info = json.load(fh)
                port = info["port"]
                replicas = [r["port"] for r in
                            info.get("replicas") or []]
                break
            except (OSError, ValueError, KeyError):
                time.sleep(0.02)
        if port is None:
            rec["error"] = "service.json never appeared"
            return
        mon = _hc.HTTPConnection("127.0.0.1", port, timeout=30)
        while True:
            _, body = _get(mon, "/healthz")
            h = json.loads(body)
            if (h.get("snapshot_tick") is not None
                    or h["status"] in ("complete", "interrupted")):
                break
            time.sleep(0.01)
        env = dict(os.environ)
        if replicas:
            # The load lands on the replica pool; the engine port is
            # only monitored.  Each client pins to one replica.
            env["BENCH_SERVICE_PORTS"] = ",".join(map(str, replicas))
        proc = subprocess.Popen(
            _child("--service-client", str(port), "--n", str(n)),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=env, cwd=REPO)
        try:
            while True:
                _, body = _get(mon, "/healthz")
                h = json.loads(body)
                if h["status"] in ("complete", "interrupted"):
                    rec["derive"] = h.get("derive")
                    break
                time.sleep(0.01)
        finally:
            try:
                out, _ = proc.communicate(input="stop\n", timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                out = ""
        for line in reversed((out or "").strip().splitlines()):
            try:
                rec.update(json.loads(line))
                break
            except json.JSONDecodeError:
                continue
        try:
            mon.request("POST", "/v1/admin/shutdown", body=b"")
            mon.getresponse().read()
        except (OSError, _hc.HTTPException):
            pass
        mon.close()

    def _svc_scan(params, plan, seed=0, device=None, collect_events=False,
                  total_time=None):
        """run_scan-shaped dispatch so _interleaved_best can interleave
        the two arms: SERVICE_PORT armed -> served run with clients,
        else the identical batch tail without the daemon."""
        out = serve_out if params.SERVICE_PORT >= 0 else base_out
        os.makedirs(out, exist_ok=True)
        if params.SERVICE_PORT < 0:
            plan2 = resolve_plan(params, _pyrandom.Random(f"app:{seed}"))
            result = finish_run(params, plan2, EventLog(out), run_scan,
                                time.time(), seed, device)
            result.log.flush(out)
            if not result.extra.get("aggregate"):
                write_msgcount(result, out)
            return None, None
        sj = os.path.join(out, _daemon.SERVICE_JSON)
        if os.path.exists(sj):
            os.unlink(sj)           # a client must never poll a dead port
        rec = {}
        th = threading.Thread(target=_drive, args=(out, rec), daemon=True)
        th.start()
        _daemon.serve_run(params, seed=seed, out_dir=out, device=device)
        th.join(timeout=60)
        if "queries" in rec:
            stats.append(rec)
        return None, None

    try:
        base_wall, _ = _timed_runs(_svc_scan, p_base, None, ticks, device)
        walls = _interleaved_best(_svc_scan, ticks, (p_base, None),
                                  {"serve": (p_serve, None)}, reps,
                                  base_wall, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    best = max(stats, key=lambda r: r["queries"] / r["seconds"],
               default=None)
    qps = (best["queries"] / best["seconds"]) if best else 0.0
    out = {
        "service_every": every,
        "service_clients": clients,
        "service_base_wall_seconds": round(walls["base"], 3),
        "service_wall_seconds": round(walls["serve"], 3),
        "service_overhead_pct": round(
            100 * (walls["serve"] - walls["base"])
            / max(walls["base"], 1e-9), 1),
        "service_queries_per_sec": round(qps, 1),
    }
    if workers:
        out["service_workers"] = workers
    if best:
        for src, dst in (("p50_ms", "service_p50_ms"),
                         ("p99_ms", "service_p99_ms"),
                         ("staleness_mean_ticks",
                          "service_staleness_mean_ticks"),
                         ("staleness_max_ticks",
                          "service_staleness_max_ticks")):
            if best.get(src) is not None:
                out[dst] = best[src]
        if best.get("derive"):
            out["service_derive_mode"] = best["derive"].get("mode")
            out["service_derive_ms"] = best["derive"].get("ms")
    return out


def _metrics_scraper_main(port: int, hz: float) -> int:
    """Hidden child mode (``--metrics-scraper``) for _bench_metrics.

    Scrapes ``GET /metrics`` at a paced cadence from a SEPARATE
    process — a real Prometheus scraper does not share the engine's
    interpreter, so its HTTP parsing must not be billed to the tick
    loop's GIL — until stdin says stop; prints one JSON stats line."""
    import http.client as _hc
    import threading

    stop = threading.Event()

    def _waiter():
        sys.stdin.readline()
        stop.set()

    threading.Thread(target=_waiter, daemon=True).start()
    conn = _hc.HTTPConnection("127.0.0.1", port, timeout=30)
    period = 1.0 / max(hz, 1e-9)
    scrapes, nbytes, lat_ms = 0, 0, []
    t_start = time.time()
    while not stop.is_set():
        t0 = time.perf_counter()
        try:
            conn.request("GET", "/metrics")
            r = conn.getresponse()
            body = r.read()
            if r.status == 200:
                scrapes += 1
                nbytes = len(body)
                lat_ms.append(1000 * (time.perf_counter() - t0))
        except (OSError, _hc.HTTPException):
            try:
                conn.close()
            except OSError:
                pass
            conn = _hc.HTTPConnection("127.0.0.1", port, timeout=30)
        stop.wait(max(0.0, period - (time.perf_counter() - t0)))
    lat = sorted(lat_ms)
    print(json.dumps({
        "scrapes": scrapes, "seconds": round(time.time() - t_start, 3),
        "payload_bytes": nbytes,
        "scrape_p50_ms": round(lat[len(lat) // 2], 3) if lat else None,
        "scrape_max_ms": round(lat[-1], 3) if lat else None}))
    return 0


def _bench_metrics(base_text: str, n: int, ticks: int, device) -> dict:
    """BENCH_METRICS=1: price the live /metrics scrape path under load.

    Two served arms of the same program, both under the same subprocess
    query load (:func:`_service_client_main`): the base arm never
    scrapes; the scrape arm adds a separate paced scraper process
    hammering ``GET /metrics`` at BENCH_METRICS_HZ (default 10/s).  The
    delta isolates what live metrics export costs the tick loop: the
    registry's instrument updates on the query path plus the text render
    and HTTP serve per scrape.  Interleaved best-of-R
    (BENCH_METRICS_REPS, default 5) as the other comparison legs."""
    import http.client as _hc
    import shutil
    import tempfile
    import threading

    from distributed_membership_tpu_torch.config import Params
    from distributed_membership_tpu_torch.service import daemon as _daemon

    hz = float(os.environ.get("BENCH_METRICS_HZ", "10"))
    reps = int(os.environ.get("BENCH_METRICS_REPS", "5"))
    every = int(os.environ.get("BENCH_SERVICE_EVERY",
                               str(max(ticks // 8, 1))))
    sstats = []         # one scraper {"scrapes", "seconds", ...} per rep

    tmp = tempfile.mkdtemp(prefix="bench_metrics_")
    plain_out = os.path.join(tmp, "plain")
    scrape_out = os.path.join(tmp, "scrape")
    p_plain = Params.from_text(
        base_text + f"CHECKPOINT_EVERY: {every}\n"
        f"CHECKPOINT_DIR: {os.path.join(plain_out, 'ck')}\n"
        "SERVICE_PORT: 0\n")
    p_scrape = Params.from_text(
        base_text + f"CHECKPOINT_EVERY: {every}\n"
        f"CHECKPOINT_DIR: {os.path.join(scrape_out, 'ck')}\n"
        "SERVICE_PORT: 0\n")

    def _health(mon):
        mon.request("GET", "/healthz")
        return json.loads(mon.getresponse().read())

    def _drive(out_dir, scrape):
        """Client side of one served rep: wait for the port and the
        first snapshot, start the query load (both arms) and, on the
        scrape arm only, the paced scraper process, run both until the
        engine completes, then release the post-run serve loop."""
        sj = os.path.join(out_dir, _daemon.SERVICE_JSON)
        port = None
        deadline = time.time() + 600
        while time.time() < deadline:
            try:
                with open(sj) as fh:
                    port = json.load(fh)["port"]
                break
            except (OSError, ValueError, KeyError):
                time.sleep(0.02)
        if port is None:
            return
        mon = _hc.HTTPConnection("127.0.0.1", port, timeout=30)
        while True:
            h = _health(mon)
            if (h.get("snapshot_tick") is not None
                    or h["status"] in ("complete", "interrupted")):
                break
            time.sleep(0.01)
        load = subprocess.Popen(
            _child("--service-client", str(port), "--n", str(n)),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=REPO)
        scraper = None
        if scrape:
            scraper = subprocess.Popen(
                _child("--metrics-scraper", str(port)),
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                env={**os.environ, "BENCH_METRICS_HZ": str(hz)}, cwd=REPO)
        try:
            while _health(mon)["status"] not in ("complete",
                                                 "interrupted"):
                time.sleep(0.01)
        finally:
            for proc, sink in ((load, None), (scraper, sstats)):
                if proc is None:
                    continue
                try:
                    out, _ = proc.communicate(input="stop\n", timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                    out = ""
                if sink is None:
                    continue
                for line in reversed((out or "").strip().splitlines()):
                    try:
                        sink.append(json.loads(line))
                        break
                    except json.JSONDecodeError:
                        continue
        try:
            mon.request("POST", "/v1/admin/shutdown", body=b"")
            mon.getresponse().read()
        except (OSError, _hc.HTTPException):
            pass
        mon.close()

    def _svc_scan(params, plan, seed=0, device=None, collect_events=False,
                  total_time=None):
        """run_scan-shaped dispatch (the _bench_service pattern) so
        _interleaved_best can interleave the two served arms; the
        scrape arm is told apart by params identity."""
        scrape = params is p_scrape
        out = scrape_out if scrape else plain_out
        os.makedirs(out, exist_ok=True)
        sj = os.path.join(out, _daemon.SERVICE_JSON)
        if os.path.exists(sj):
            os.unlink(sj)           # a client must never poll a dead port
        th = threading.Thread(target=_drive, args=(out, scrape),
                              daemon=True)
        th.start()
        _daemon.serve_run(params, seed=seed, out_dir=out, device=device)
        th.join(timeout=60)
        return None, None

    try:
        base_wall, _ = _timed_runs(_svc_scan, p_plain, None, ticks, device)
        walls = _interleaved_best(_svc_scan, ticks, (p_plain, None),
                                  {"scrape": (p_scrape, None)}, reps,
                                  base_wall, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {
        "metrics_hz": hz,
        "metrics_reps": reps,
        "metrics_base_wall_seconds": round(walls["base"], 3),
        "metrics_wall_seconds": round(walls["scrape"], 3),
        "metrics_overhead_pct": round(
            100 * (walls["scrape"] - walls["base"])
            / max(walls["base"], 1e-9), 1),
    }
    best = max(sstats, key=lambda r: r.get("scrapes", 0), default=None)
    if best:
        out["metrics_scrapes"] = best["scrapes"]
        if best.get("seconds"):
            out["metrics_scrapes_per_sec"] = round(
                best["scrapes"] / best["seconds"], 2)
        for k in ("payload_bytes", "scrape_p50_ms", "scrape_max_ms"):
            if best.get(k) is not None:
                out[f"metrics_{k}"] = best[k]
    return out


def _bench_service_connect(n: int) -> dict:
    """BENCH_SERVICE_CONNECT=host:port[,host:port...]: the off-box
    service bench.

    No engine runs here: the targets are an already-serving daemon or
    replica pool, so none of the load generator's CPU is billed to the
    engine under test.  Spawns the same ``--service-client`` subprocess
    against the targets for BENCH_SERVICE_SECONDS (default 10), and
    reports sustained q/s, sampled p50/p99 and answer staleness.  ``n``
    bounds the member-id space the clients probe (BENCH_SERVICE_N
    overrides)."""
    connect = os.environ["BENCH_SERVICE_CONNECT"]
    seconds = float(os.environ.get("BENCH_SERVICE_SECONDS", "10"))
    n = int(os.environ.get("BENCH_SERVICE_N", str(n)))
    proc = subprocess.Popen(
        _child("--service-client", "0", "--connect", connect, "--n", str(n)),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=REPO)
    try:
        time.sleep(seconds)
    finally:
        try:
            out_text, _ = proc.communicate(input="stop\n", timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            out_text = ""
    rec = {}
    for line in reversed((out_text or "").strip().splitlines()):
        try:
            rec = json.loads(line)
            break
        except json.JSONDecodeError:
            continue
    qps = rec.get("queries", 0) / max(rec.get("seconds", 1e-9), 1e-9)
    out = {
        "service_connect": connect,
        "service_clients": int(
            os.environ.get("BENCH_SERVICE_CLIENTS", "8")),
        "service_queries_per_sec": round(qps, 1),
    }
    for src, dst in (("p50_ms", "service_p50_ms"),
                     ("p99_ms", "service_p99_ms"),
                     ("staleness_mean_ticks",
                      "service_staleness_mean_ticks"),
                     ("staleness_max_ticks",
                      "service_staleness_max_ticks")):
        if rec.get(src) is not None:
            out[dst] = rec[src]
    if os.environ.get("BENCH_SERVICE_WORKERS"):
        out["service_workers"] = int(
            os.environ["BENCH_SERVICE_WORKERS"])
    return out


def _bench_fleet(device) -> dict:
    """BENCH_FLEET=1: price the fleet control plane (fleet/).

    One real controller subprocess (``python -m
    distributed_membership_tpu_torch <conf> --fleet``, its workers on
    ``device``) multiplexing BENCH_FLEET_RUNS (default 4) concurrent
    N=10 serve workers, the reference protocol size, so the leg prices
    the control plane, not the engine, through the same interleaved
    best-of-R pairing as the other comparison legs: an unloaded sweep vs
    the same sweep with BENCH_SERVICE_CLIENTS pipelined clients rerouted
    through the ``/v1/runs/<id>/`` proxy mounts.  Two numbers ride into
    the ledger: sustained proxied q/s across the fleet, and the per-run
    tick-loop slowdown (mean per-run post-compile segment seconds from
    runlog.jsonl, loaded vs not)."""
    import http.client as _hc
    import shutil
    import tempfile

    from distributed_membership_tpu_torch.observability.runlog import (
        read_events)
    from distributed_membership_tpu_torch.scale_smoke import device_info

    runs_n = int(os.environ.get("BENCH_FLEET_RUNS", "4"))
    n = int(os.environ.get("BENCH_FLEET_N", "10"))
    ticks = int(os.environ.get("BENCH_FLEET_TICKS", "3000"))
    every = int(os.environ.get("BENCH_FLEET_EVERY", "50"))
    reps = int(os.environ.get("BENCH_FLEET_REPS", "1"))
    clients = int(os.environ.get("BENCH_SERVICE_CLIENTS", "8"))
    conf = (f"MAX_NNB: {n}\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
            f"MSG_DROP_PROB: 0\nVIEW_SIZE: 8\n"
            f"FAIL_TIME: {ticks // 2}\nJOIN_MODE: warm\n"
            f"BACKEND: tpu_hash\nEVENT_MODE: full\n"
            f"CHECKPOINT_EVERY: {every}\nTELEMETRY: scalars\n"
            f"TOTAL_TIME: {ticks}\n")
    qps_stats = []          # one {"queries", "seconds"} per loaded rep

    def _rq(port, method, path, body=None):
        conn = _hc.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            conn.request(
                method, path,
                body=None if body is None else json.dumps(body),
                headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read() or b"{}")
        finally:
            conn.close()

    def _sweep(loaded: bool) -> float:
        """One controller + runs_n concurrent runs to completion;
        -> mean per-run post-compile tick-loop seconds."""
        root = tempfile.mkdtemp(prefix="bench_fleet_")
        fconf = os.path.join(root, "fleet.conf")
        with open(fconf, "w") as fh:
            fh.write(f"FLEET_MAX_CONCURRENCY: {runs_n}\n")
        with open(os.path.join(root, "fleet.log"), "ab") as log:
            ctrl = subprocess.Popen(
                [sys.executable, "-m", "distributed_membership_tpu_torch",
                 fconf, "--fleet", "--out-dir", root,
                 "--device", device.type],
                stdout=log, stderr=subprocess.STDOUT, cwd=REPO)
        client, port = None, None
        try:
            fj = os.path.join(root, "fleet.json")
            deadline = time.time() + 120
            while time.time() < deadline:
                try:
                    with open(fj) as fh:
                        info = json.load(fh)
                    if info.get("pid") == ctrl.pid:
                        port = info["port"]
                        break
                except (OSError, ValueError):
                    pass
                time.sleep(0.05)
            if port is None:
                raise RuntimeError("fleet.json never appeared")
            ids = [f"f{i}" for i in range(runs_n)]
            for i, rid in enumerate(ids):
                code, obj = _rq(port, "POST", "/v1/runs",
                                {"conf": conf, "run_id": rid,
                                 "seed": i + 1})
                if code != 202:
                    raise RuntimeError(f"fleet refused {rid}: {obj}")
            if loaded:
                env = dict(os.environ)
                env["BENCH_SERVICE_PREFIX"] = ",".join(
                    f"/v1/runs/{r}" for r in ids)
                client = subprocess.Popen(
                    _child("--service-client", str(port), "--n", str(n)),
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    text=True, env=env, cwd=REPO)
            deadline = time.time() + 600
            while time.time() < deadline:
                _, obj = _rq(port, "GET", "/v1/runs")
                states = [r["state"] for r in obj.get("runs", [])]
                if states and all(s == "done" for s in states):
                    break
                if any(s in ("failed", "killed") for s in states):
                    raise RuntimeError(f"fleet run died: {obj}")
                time.sleep(0.1)
            if client is not None:
                try:
                    out, _ = client.communicate(input="stop\n",
                                                timeout=60)
                except subprocess.TimeoutExpired:
                    client.kill()
                    client.wait()
                    out = ""
                client = None
                for line in reversed((out or "").strip().splitlines()):
                    try:
                        qps_stats.append(json.loads(line))
                        break
                    except json.JSONDecodeError:
                        continue
            per_run = []
            for rid in ids:
                segs = [e for e in read_events(
                            os.path.join(root, rid, "runlog.jsonl"))
                        if e.get("kind") == "segment"]
                # The first segment carries the first run's set-up; the
                # tick-loop cost is the warm remainder.
                warm = segs[1:] if len(segs) > 1 else segs
                per_run.append(sum(e.get("device_sync_s", 0.0)
                                   for e in warm))
            return sum(per_run) / max(len(per_run), 1)
        finally:
            if client is not None:
                client.kill()
                client.wait()
            if port is not None:
                try:
                    _rq(port, "POST", "/v1/admin/shutdown")
                except (OSError, _hc.HTTPException, ValueError):
                    pass
            try:
                ctrl.wait(timeout=60)
            except subprocess.TimeoutExpired:
                ctrl.kill()
                ctrl.wait()
            shutil.rmtree(root, ignore_errors=True)

    arm_means = {False: [], True: []}

    def _fleet_scan(params, plan, seed=0, device=None, collect_events=False,
                    total_time=None):
        """run_scan-shaped shim so _interleaved_best can interleave the
        arms (``params`` is the loaded flag); the sweep wall it times is
        reported, but the headline metric is the per-run tick-loop time
        recorded here from the runlogs."""
        arm_means[bool(params)].append(_sweep(loaded=bool(params)))
        return None, None

    base_wall, _ = _timed_runs(_fleet_scan, False, None, ticks, device)
    walls = _interleaved_best(_fleet_scan, ticks, (False, None),
                              {"loaded": (True, None)}, reps, base_wall,
                              device)
    base_s = min(arm_means[False])
    loaded_s = min(arm_means[True])
    qps = max((r["queries"] / r["seconds"] for r in qps_stats),
              default=0.0)
    warm_ticks = max(ticks - every, 1)
    return {
        "leg": "fleet",
        "platform": device.type,
        "fleet_runs": runs_n, "fleet_clients": clients,
        "n": n, "ticks": ticks, "view_size": 8,
        "fleet_sweep_wall_seconds": round(walls["base"], 3),
        "fleet_sweep_loaded_wall_seconds": round(walls["loaded"], 3),
        "fleet_base_run_seconds": round(base_s, 3),
        "fleet_loaded_run_seconds": round(loaded_s, 3),
        "fleet_run_slowdown_pct": round(
            100 * (loaded_s - base_s) / max(base_s, 1e-9), 1),
        "fleet_run_ticks_per_sec": round(
            warm_ticks / max(loaded_s, 1e-9), 1),
        "fleet_queries_per_sec": round(qps, 1),
        "device": device_info(device),
    }


def _check_ledger(perfdb, path: str) -> None:
    """Warn on every regression of the ledger at ``path``."""
    for reg in perfdb.check(perfdb.load_ledger(path)):
        print(f"warning: perf_ledger regression: {reg['rung']} "
              f"{reg['metric']} {reg['value']:.1f} vs best "
              f"{reg['best']:.1f} (-{reg['drop_pct']}%)", file=sys.stderr)


def _ledger_bank_fleet(row: dict, path: str) -> None:
    """Bank the fleet leg's two trends (proxied q/s, loaded per-run tick
    rate) into the ledger at ``path``; telemetry-tolerant like
    _ledger_bank."""
    try:
        from distributed_membership_tpu_torch.observability import perfdb
        knobs = {"runs": row["fleet_runs"],
                 "clients": row["fleet_clients"],
                 "ticks": row["ticks"],
                 "slowdown_pct": row["fleet_run_slowdown_pct"]}
        if isinstance(row.get("device"), dict):
            knobs["device"] = row["device"].get("name")
        rows = [
            perfdb.make_row(
                "bench:live:fleet", metric="fleet_queries_per_sec",
                value=row["fleet_queries_per_sec"], n=row["n"],
                s=row["view_size"], backend="tpu_hash",
                platform=row["platform"], knobs=knobs, source=MODULE),
            perfdb.make_row(
                "bench:live:fleet:tickloop",
                metric="fleet_run_ticks_per_sec",
                value=row["fleet_run_ticks_per_sec"], n=row["n"],
                s=row["view_size"], backend="tpu_hash",
                platform=row["platform"], knobs=knobs, source=MODULE),
        ]
        perfdb.append_rows(rows, path)
        _check_ledger(perfdb, path)
    except (OSError, KeyError, TypeError, ValueError) as e:
        print(f"warning: perf ledger update failed: {e}", file=sys.stderr)


def _mode_str(frecv, fgossip, folded, fprobe=False) -> str:
    """One mode vocabulary for every row ('folded', 'fused:recv|gossip|
    both|all', their '+' composition, or 'natural'), so identical
    programs never get distinct labels.  'fused:all' is recv+gossip+
    probe, 'fused:probe' the probe kernel alone, and partial pairs
    compose as 'fused:recv+probe' / 'fused:gossip+probe'."""
    fused = ("fused:all" if frecv and fgossip and fprobe else
             "fused:both" if frecv and fgossip else
             "fused:recv" if frecv else
             "fused:gossip" if fgossip else "")
    if fprobe and not (frecv and fgossip):
        fused = (fused + "+probe") if fused else "fused:probe"
    if folded:
        return "folded" + (f"+{fused}" if fused else "")
    return fused or "natural"


class HashLeg(NamedTuple):
    """The hash leg's conf, as the JAX bench builds it from the env."""
    s: int
    fused: str          # BENCH_FUSED
    folded: str         # BENCH_FOLDED
    shift_set: int      # BENCH_SHIFT_SET
    geom_text: str
    fused_keys: str
    tail_text: str

    @property
    def text(self) -> str:
        return self.geom_text + self.fused_keys + self.tail_text


def hash_leg_conf(n: int, ticks: int, view: int = 0) -> HashLeg:
    """The hash leg's conf: S from ``view`` or BENCH_VIEW (default 128),
    G = S/4, P = S/8, FANOUT 3, TFAIL 16, TREMOVE 40, warm join, one
    crash at ticks/2; the kernel keys from BENCH_FUSED and BENCH_FOLDED
    (``auto``: -1), SHIFT_SET from BENCH_SHIFT_SET."""
    s = view or int(os.environ.get("BENCH_VIEW", "128"))
    g = max(s // 4, 1)
    probes = max(s // 8, 1)
    fused = os.environ.get("BENCH_FUSED", "auto")
    if fused not in ("auto", "off", "recv", "gossip", "both", "probe",
                     "all"):
        raise SystemExit(f"BENCH_FUSED must be "
                         f"auto|off|recv|gossip|both|probe|all, "
                         f"got {fused!r}")
    folded = os.environ.get("BENCH_FOLDED", "auto")
    if folded not in ("auto", "off", "on"):
        raise SystemExit(f"BENCH_FOLDED must be auto|off|on, got {folded!r}")
    try:
        shift_set = int(os.environ.get("BENCH_SHIFT_SET", "0"))
    except ValueError:
        raise SystemExit("BENCH_SHIFT_SET must be an integer K (0 = off); "
                         "valid K are 2..64")
    if shift_set and not 2 <= shift_set <= 64:
        raise SystemExit(f"BENCH_SHIFT_SET must be 0 (off) or 2..64, "
                         f"got {shift_set}")
    fused_keys = (
        ("FUSED_RECEIVE: -1\nFUSED_GOSSIP: -1\nFUSED_PROBE: -1\n"
         if fused == "auto" else
         f"FUSED_RECEIVE: {int(fused in ('recv', 'both', 'all'))}\n"
         f"FUSED_GOSSIP: {int(fused in ('gossip', 'both', 'all'))}\n"
         f"FUSED_PROBE: {int(fused in ('probe', 'all'))}\n")
        + ("FOLDED: -1\n" if folded == "auto" else
           f"FOLDED: {int(folded == 'on')}\n"))
    geom_text = (
        f"MAX_NNB: {n}\nSINGLE_FAILURE: 1\nDROP_MSG: 0\nMSG_DROP_PROB: 0\n"
        f"VIEW_SIZE: {s}\nGOSSIP_LEN: {g}\nPROBES: {probes}\nFANOUT: 3\n"
        f"TFAIL: 16\nTREMOVE: 40\nTOTAL_TIME: {ticks}\n"
        f"FAIL_TIME: {ticks // 2}\nJOIN_MODE: warm\n")
    tail_text = f"SHIFT_SET: {shift_set}\nBACKEND: tpu_hash\n"
    return HashLeg(s, fused, folded, shift_set, geom_text, fused_keys,
                   tail_text)


def _overhead(walls: dict, arm: str, base: str = "base") -> float:
    return round(100 * (walls[arm] - walls[base])
                 / max(walls[base], 1e-9), 1)


def _speedup(walls: dict, arm: str) -> float:
    return round(100 * (walls["base"] - walls[arm])
                 / max(walls["base"], 1e-9), 1)


def leg_hash(n: int, ticks: int, device="cuda", view: int = 0) -> dict:
    """The hash leg's record (and the side legs' fields the env arms)."""
    import random as _pyrandom

    from distributed_membership_tpu_torch.backends.tpu_hash import run_scan
    from distributed_membership_tpu_torch.config import Params
    from distributed_membership_tpu_torch.profile_step import (
        resolved_config, resolved_kernels)
    from distributed_membership_tpu_torch.runtime.application import (
        resolve_device)
    from distributed_membership_tpu_torch.runtime.failures import make_plan
    from distributed_membership_tpu_torch.scale_smoke import device_info

    dev = resolve_device(device)
    if os.environ.get("BENCH_FPROBE", "0") not in ("", "0"):
        raise NotImplementedError(FPROBE_REFUSAL)
    leg = hash_leg_conf(n, ticks, view)
    s, params_text = leg.s, leg.text
    geom_text, fused_keys, tail_text = (leg.geom_text, leg.fused_keys,
                                        leg.tail_text)
    params = Params.from_text(params_text)
    plan = make_plan(params, _pyrandom.Random("app:0"))
    wall, final_state = _timed_runs(run_scan, params, plan, ticks, dev)

    # BENCH_CHECKPOINT=K: the resilient-run harness's overhead, the same
    # leg re-timed in K-tick checkpointed segments (runtime/checkpoint.py)
    # with snapshots written to a temp dir.  The headline stays the
    # monolithic run's.
    try:
        ckpt_every = int(os.environ.get("BENCH_CHECKPOINT", "0"))
    except ValueError:
        raise SystemExit("BENCH_CHECKPOINT must be an integer segment "
                         "length in ticks (0 = off)")
    fields = {}
    if ckpt_every > 0:
        import glob
        import tempfile

        compress = os.environ.get("BENCH_CHECKPOINT_COMPRESS",
                                  "0") not in ("", "0")
        with tempfile.TemporaryDirectory() as ckdir:
            params_ck = Params.from_text(
                params_text + f"CHECKPOINT_EVERY: {ckpt_every}\n"
                f"CHECKPOINT_DIR: {ckdir}\n"
                f"CHECKPOINT_COMPRESS: {int(compress)}\n")
            ck_wall, _ = _timed_runs(run_scan, params_ck, plan, ticks, dev)
            kept = glob.glob(os.path.join(ckdir, "ckpt_*.npz"))
            ck_bytes = sum(os.path.getsize(p) for p in kept)
        fields = {
            "checkpoint_every": ckpt_every,
            "checkpoint_compress": int(compress),
            "checkpoint_wall_seconds": round(ck_wall, 3),
            "checkpoint_overhead_pct": round(100 * (ck_wall - wall)
                                             / max(wall, 1e-9), 1),
            "checkpoint_bytes_per_snapshot": ck_bytes // max(len(kept), 1),
        }
    # BENCH_TELEMETRY=1: the flight recorder's per-tick scalars
    # (TELEMETRY: scalars), series computed and dropped (no recorder, no
    # disk): the pure in-loop overhead.
    if os.environ.get("BENCH_TELEMETRY", "0") not in ("", "0"):
        params_tel = Params.from_text(params_text + "TELEMETRY: scalars\n")
        reps = int(os.environ.get("BENCH_TELEMETRY_REPS", "3"))
        walls = _interleaved_best(run_scan, ticks, (params, plan),
                                  {"tel": (params_tel, plan)}, reps, wall,
                                  dev)
        fields.update({
            "telemetry_wall_seconds": round(walls["tel"], 3),
            "telemetry_overhead_pct": _overhead(walls, "tel"),
        })
    # BENCH_HIST=1: the histogram tier (TELEMETRY: hist), the scalars
    # plus the bucketed reductions (K3/K7's hist form on the card).
    if os.environ.get("BENCH_HIST", "0") not in ("", "0"):
        params_hist = Params.from_text(params_text + "TELEMETRY: hist\n")
        reps = int(os.environ.get("BENCH_HIST_REPS", "3"))
        walls = _interleaved_best(run_scan, ticks, (params, plan),
                                  {"hist": (params_hist, plan)}, reps, wall,
                                  dev)
        fields.update({
            "hist_wall_seconds": round(walls["hist"], 3),
            "hist_overhead_pct": _overhead(walls, "hist"),
        })
    # BENCH_CHAOS=1: a chaos-campaign schedule riding the run (a fuzzed
    # gray schedule: crash/restart churn, a one-way blackhole, a delay
    # window) against the clean leg and a drop-matched baseline.
    if os.environ.get("BENCH_CHAOS", "0") not in ("", "0"):
        fields.update(_bench_chaos(params, plan, params_text, n, ticks,
                                   wall, dev))
    # BENCH_MEGA=T: the T-tick block scan (MEGA_TICKS, ops/megakernel.py)
    # against the same per-tick chunked program, both in 4T-tick segments,
    # interleaved; positive = the blocked scan is faster.  The carry-byte
    # accounting rides along.
    try:
        mega_t = int(os.environ.get("BENCH_MEGA", "0"))
    except ValueError:
        raise SystemExit("BENCH_MEGA must be an integer block size T in "
                         "ticks (0 = off)")
    if mega_t > 0:
        from distributed_membership_tpu_torch.ops.megakernel import (
            carry_bytes)

        def _mega_params(t: int):
            return Params.from_text(params_text
                                    + f"CHECKPOINT_EVERY: {4 * mega_t}\n"
                                    + f"MEGA_TICKS: {t}\n")

        p_mg_off, p_mg_on = _mega_params(0), _mega_params(mega_t)
        reps = int(os.environ.get("BENCH_MEGA_REPS", "3"))
        mg_base_wall, _ = _timed_runs(run_scan, p_mg_off, plan, ticks, dev)
        walls = _interleaved_best(run_scan, ticks, (p_mg_off, plan),
                                  {"mega": (p_mg_on, plan)}, reps,
                                  mg_base_wall, dev)
        acct = carry_bytes(final_state, pack16=True)
        fields.update({
            "mega_ticks": mega_t,
            "mega_off_wall_seconds": round(walls["base"], 3),
            "mega_wall_seconds": round(walls["mega"], 3),
            "mega_speedup_pct": _speedup(walls, "mega"),
            "mega_carry_bytes_full": acct["full"],
            "mega_carry_bytes_packed": acct["packed"],
        })
    # BENCH_EXCHANGE=1: EXCHANGE_MODE batched (ops/exchange.py: every
    # gossip shift bucketed per destination and handed over once per
    # tick, K4 not launched) against legacy (K4 on the routed payloads),
    # both on the sharded backend over SHARDS shards of the device;
    # positive = batched wins.
    if os.environ.get("BENCH_EXCHANGE", "0") not in ("", "0"):
        from distributed_membership_tpu_torch.parallel.mesh import LocalMesh
        from distributed_membership_tpu_torch.profile_step import (
            sharded_scan)

        run_sharded = sharded_scan(LocalMesh((SHARDS,), dev))

        def _x_params(mode: str):
            return Params.from_text(
                geom_text + fused_keys
                + f"SHIFT_SET: {leg.shift_set}\nEXCHANGE: ring\n"
                f"EXCHANGE_MODE: {mode}\nBACKEND: tpu_hash_sharded\n")

        p_x_leg, p_x_bat = _x_params("legacy"), _x_params("batched")
        reps = int(os.environ.get("BENCH_EXCHANGE_REPS", "3"))
        x_base_wall, _ = _timed_runs(run_sharded, p_x_leg, plan, ticks, dev)
        walls = _interleaved_best(run_sharded, ticks, (p_x_leg, plan),
                                  {"batched": (p_x_bat, plan)}, reps,
                                  x_base_wall, dev)
        fields.update({
            "exchange_devices": SHARDS,
            "exchange_legacy_wall_seconds": round(walls["base"], 3),
            "exchange_batched_wall_seconds": round(walls["batched"], 3),
            "exchange_speedup_pct": _speedup(walls, "batched"),
        })
    # BENCH_RESHARD=1: elastic reshard-on-resume against a same-shape
    # resume (elastic/reshard.py).
    if os.environ.get("BENCH_RESHARD", "0") not in ("", "0"):
        fields.update(_bench_reshard(geom_text, fused_keys, leg.shift_set,
                                     ticks, dev))
    # BENCH_SCENARIO=1: the scenario engine's in-run plan
    # (scenario/compile.py): a half/half partition window against the
    # plain leg, and partition + cross-half link flake against a
    # drop-matched baseline (conf-window drops at the same probability
    # and window), so the armed coin streams are not billed to the
    # scenario engine.
    if os.environ.get("BENCH_SCENARIO", "0") not in ("", "0"):
        fields.update(_bench_scenario(params, plan, params_text, n, ticks,
                                      wall, dev))
    # BENCH_SERVICE=1: the membership control plane (service/), the daemon
    # with 8 concurrent HTTP query clients vs --serve off, both through
    # the real checkpointed batch tail.  The JAX bench pins FUSED_RECEIVE,
    # FUSED_GOSSIP and FOLDED to 0 there, the program its served run
    # ships; the port's served run ships its kernels, so both arms write
    # FUSED_*: -1 (the kernels on the card) with FOLDED: 0 (the service
    # reads the natural carry).
    served_text = (geom_text + "FUSED_RECEIVE: -1\nFUSED_GOSSIP: -1\n"
                   "FUSED_PROBE: -1\nFOLDED: 0\n" + tail_text)
    if os.environ.get("BENCH_SERVICE", "0") not in ("", "0"):
        if os.environ.get("BENCH_SERVICE_CONNECT"):
            # Off-box mode: the service under test is already running.
            fields.update(_bench_service_connect(n))
        else:
            fields.update(_bench_service(served_text, n, ticks, dev))
    # BENCH_METRICS=1: the live /metrics scrape path, the served run under
    # the same client load with vs. without a paced scraper process; the
    # served program as above.
    if os.environ.get("BENCH_METRICS", "0") not in ("", "0"):
        fields.update(_bench_metrics(served_text, n, ticks, dev))

    cfg = resolved_config(params, plan, dev)
    if os.environ.get("BENCH_RNG", "0") not in ("", "0"):
        fields.update(_bench_rng_micro(cfg, dev))
    kern = resolved_kernels(cfg, dev)
    # Approximate HBM traffic (a model, the JAX bench's): full passes over
    # the resident state per tick.  Scatter: view+ts+mail+amail [N,S] u32
    # + pmail [N,Qp], read and written.  Ring: view+ts+mail [N,S] read and
    # written, plus one read-modify-write of mail per circulant shift;
    # the gossip kernel cuts ~3F roll passes to ~2F+2.
    if cfg.exchange == "ring":
        gossip_passes = (2 * min(cfg.fanout, cfg.s) + 2
                         if kern["fused_gossip"]
                         else 3 * min(cfg.fanout, cfg.s))
        passes = 2 * 3 + gossip_passes
        est_gb_per_tick = passes * n * cfg.s * 4 / 1e9
    else:
        state_bytes = (4 * n * cfg.s + n * cfg.qp) * 4
        est_gb_per_tick = 2 * state_bytes / 1e9

    return {
        "leg": "hash", "platform": dev.type, "n": n, "ticks": ticks,
        # What ran, not the env ask: the ask travels under "requested".
        **{k: kern[k] for k in ("fused_receive", "fused_gossip",
                                "fused_probe", "folded")},
        "requested": {"fused": leg.fused, "folded": leg.folded},
        "mode": (_mode_str(kern["fused_receive"], kern["fused_gossip"],
                           kern["folded"], kern["fused_probe"])
                 + (f"+sw{cfg.shift_set}" if cfg.shift_set else "")),
        "shift_set": cfg.shift_set,
        "node_ticks_per_sec": round(n * ticks / wall, 1),
        "wall_seconds": round(wall, 3),
        "ticks_per_sec": round(ticks / wall, 2),
        "est_hbm_gb_per_tick": round(est_gb_per_tick, 3),
        "est_hbm_gbps": round(est_gb_per_tick * ticks / wall, 1),
        "view_size": cfg.s, "probes": cfg.probes, "fanout": cfg.fanout,
        "exchange": cfg.exchange,
        "device": device_info(dev),
        **fields,
    }


def _bench_chaos(params, plan, params_text: str, n: int, ticks: int,
                 wall: float, dev) -> dict:
    """BENCH_CHAOS=1 (see leg_hash): interleaved best-of-R of the clean
    leg, a drop-matched baseline (the flake's window) and the chaos
    schedule."""
    import random as _pyrandom
    import tempfile

    from distributed_membership_tpu_torch.backends.tpu_hash import run_scan
    from distributed_membership_tpu_torch.chaos.fuzz import (
        CampaignSpec, dump_schedule, fuzz_schedule)
    from distributed_membership_tpu_torch.config import Params
    from distributed_membership_tpu_torch.runtime.failures import (
        make_plan, resolve_plan)
    spec = CampaignSpec(seed=0, schedules=1, n=n, total=ticks,
                        tfail=max(3, ticks // 10),
                        tremove=max(4, ticks // 6), events=3,
                        mix={"crash": 1.0, "one_way_flake": 1.0,
                             "delay_window": 1.0}, name="bench")
    try:
        sch = fuzz_schedule(spec, 0)
    except ValueError as e:
        raise SystemExit(f"BENCH_CHAOS needs a larger tick budget at "
                         f"--ticks {ticks}: {e}")
    reps = int(os.environ.get("BENCH_CHAOS_REPS", "3"))
    fd, spath = tempfile.mkstemp(suffix=".json")
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(dump_schedule(sch))
        try:
            # resolve_plan, not make_plan: make_plan ignores SCENARIO.
            params_chaos = Params.from_text(
                params_text + f"SCENARIO: {spath}\n")
            plan_chaos = resolve_plan(params_chaos,
                                      _pyrandom.Random("app:0"))
        except ValueError as e:
            raise SystemExit(f"BENCH_CHAOS: {e}")
        flake = next(ev for ev in sch["events"]
                     if ev["kind"] == "one_way_flake")
        params_droppy = Params.from_text(
            params_text.replace("DROP_MSG: 0", "DROP_MSG: 1")
            .replace("MSG_DROP_PROB: 0", "MSG_DROP_PROB: 0.05")
            + f"DROP_START: {flake['start']}\n"
            f"DROP_STOP: {flake['stop']}\n")
        plan_droppy = make_plan(params_droppy, _pyrandom.Random("app:0"))
        walls = _interleaved_best(
            run_scan, ticks, (params, plan),
            {"droppy": (params_droppy, plan_droppy),
             "chaos": (params_chaos, plan_chaos)}, reps, wall, dev)
    finally:
        os.unlink(spath)
    return {
        "chaos_events": len(sch["events"]),
        "chaos_wall_seconds": round(walls["chaos"], 3),
        "chaos_overhead_pct": _overhead(walls, "chaos"),
        "chaos_droppy_baseline_wall_seconds": round(walls["droppy"], 3),
        "chaos_overhead_vs_droppy_pct": _overhead(walls, "chaos",
                                                  "droppy"),
    }


def _bench_scenario(params, plan, params_text: str, n: int, ticks: int,
                    wall: float, dev) -> dict:
    """BENCH_SCENARIO=1 (see leg_hash)."""
    import random as _pyrandom
    import tempfile

    from distributed_membership_tpu_torch.backends.tpu_hash import run_scan
    from distributed_membership_tpu_torch.config import Params
    from distributed_membership_tpu_torch.runtime.failures import (
        make_plan, resolve_plan)
    fl_lo, fl_hi = ticks // 2, (3 * ticks) // 4
    part_ev = [{"kind": "partition", "start": ticks // 4,
                "stop": ticks // 2,
                "groups": [[0, n // 2], [n // 2, n]]}]
    flake_ev = part_ev + [
        {"kind": "link_flake", "start": fl_lo, "stop": fl_hi,
         "src": [0, n // 2], "dst": [n // 2, n], "drop_prob": 0.05}]
    paths = []

    def _scn_params(events):
        with tempfile.NamedTemporaryFile("w", suffix=".json",
                                         delete=False) as fh:
            json.dump({"name": "bench", "events": events}, fh)
        paths.append(fh.name)
        p = Params.from_text(params_text + f"SCENARIO: {fh.name}\n")
        return p, resolve_plan(p, _pyrandom.Random("app:0"))

    try:
        p_part, plan_part = _scn_params(part_ev)
        p_flake, plan_flake = _scn_params(flake_ev)
        params_droppy = Params.from_text(
            params_text.replace("DROP_MSG: 0", "DROP_MSG: 1")
            .replace("MSG_DROP_PROB: 0", "MSG_DROP_PROB: 0.05")
            + f"DROP_START: {fl_lo}\nDROP_STOP: {fl_hi}\n")
        plan_droppy = make_plan(params_droppy, _pyrandom.Random("app:0"))
        reps = int(os.environ.get("BENCH_SCENARIO_REPS", "3"))
        walls = _interleaved_best(
            run_scan, ticks, (params, plan),
            {"part": (p_part, plan_part),
             "droppy": (params_droppy, plan_droppy),
             "flake": (p_flake, plan_flake)}, reps, wall, dev)
    finally:
        for path in paths:
            os.unlink(path)
    return {
        "scenario_partition_wall_seconds": round(walls["part"], 3),
        "scenario_partition_overhead_pct": _overhead(walls, "part"),
        "scenario_flake_wall_seconds": round(walls["flake"], 3),
        "scenario_droppy_baseline_wall_seconds": round(walls["droppy"], 3),
        "scenario_flake_overhead_pct": _overhead(walls, "flake", "droppy"),
    }


def _bench_reshard(geom_text: str, fused_keys: str, shift_set: int,
                   ticks: int, dev) -> dict:
    """BENCH_RESHARD=1: price elastic reshard-on-resume
    (elastic/reshard.py) against a same-shape resume at this leg's
    geometry.  One checkpointed sharded run on SHARDS shards is killed
    mid-run (the injected crash the chaos drills use), its durable
    checkpoint cloned into two arms: a plain resume on the same mesh
    shape, and a reshard to the transposed shape followed by a resume
    there.  The reshard's own wall (the codec round trip on ``dev``, the
    host redistribute, the manifest fan-out) is the banked number; both
    resume walls ride along."""
    import shutil
    import tempfile

    from distributed_membership_tpu_torch.backends import get_backend
    from distributed_membership_tpu_torch.config import Params
    from distributed_membership_tpu_torch.elastic.reshard import reshard
    from distributed_membership_tpu_torch.runtime.checkpoint import CRASH_ENV

    from_shape = str(SHARDS)
    to_shape = f"{SHARDS // 2}x2"
    every = max(ticks // 4, 1)

    def _params(shape: str, ckdir: str):
        return Params.from_text(
            geom_text + fused_keys
            + f"SHIFT_SET: {shift_set}\nEXCHANGE: ring\n"
            f"MESH_SHAPE: {shape}\nBACKEND: tpu_hash_sharded\n"
            f"CHECKPOINT_EVERY: {every}\nCHECKPOINT_DIR: {ckdir}\n"
            "RESUME: 1\n")

    def _timed(params) -> float:
        _sync(dev)
        t0 = time.perf_counter()
        run(params, seed=0, device=dev)
        _sync(dev)
        return time.perf_counter() - t0

    run = get_backend("tpu_hash_sharded")
    with tempfile.TemporaryDirectory() as td:
        seed_ck = os.path.join(td, "seed_ck")
        os.environ[CRASH_ENV] = str(ticks // 2)
        try:
            try:
                run(_params(from_shape, seed_ck), seed=0, device=dev)
                raise SystemExit("BENCH_RESHARD: injected crash never "
                                 f"fired at --ticks {ticks}")
            except RuntimeError:
                pass
        finally:
            os.environ.pop(CRASH_ENV, None)
        same_ck = os.path.join(td, "same_ck")
        moved_ck = os.path.join(td, "moved_ck")
        shutil.copytree(seed_ck, same_ck)
        shutil.copytree(seed_ck, moved_ck)
        same_wall = _timed(_params(from_shape, same_ck))
        stats = reshard([moved_ck], [moved_ck], to_mesh_shape=to_shape,
                        device=dev)
        moved_wall = _timed(_params(to_shape, moved_ck))
    return {
        "reshard_devices": SHARDS,
        "reshard_from_shape": from_shape,
        "reshard_to_shape": to_shape,
        "reshard_tick": stats["tick"],
        "reshard_seconds": round(stats["wall_seconds"], 3),
        "reshard_codec_seconds": round(stats["codec_seconds"], 3),
        "reshard_redistribute_seconds": round(
            stats["redistribute_seconds"], 3),
        "reshard_carry_bytes_full": stats["carry_bytes_full"],
        "reshard_carry_bytes_packed": stats["carry_bytes_packed"],
        "resume_same_shape_wall_seconds": round(same_wall, 3),
        "resume_reshard_wall_seconds": round(moved_wall, 3),
        "reshard_resume_overhead_pct": round(
            100 * (moved_wall + stats["wall_seconds"] - same_wall)
            / max(same_wall, 1e-9), 1),
    }


def leg_dense(n: int, ticks: int, device="cuda") -> dict:
    """The dense leg: the exact ``tpu`` step, batch join, one crash."""
    import random as _pyrandom

    from distributed_membership_tpu_torch.backends.tpu import run_scan
    from distributed_membership_tpu_torch.config import Params
    from distributed_membership_tpu_torch.runtime.application import (
        resolve_device)
    from distributed_membership_tpu_torch.runtime.failures import make_plan
    from distributed_membership_tpu_torch.scale_smoke import device_info

    dev = resolve_device(device)
    params = Params.from_text(dense_conf(n, ticks))
    plan = make_plan(params, _pyrandom.Random("app:0"))
    wall, _ = _timed_runs(run_scan, params, plan, ticks, dev)
    return {
        "leg": "dense", "platform": dev.type, "n": n, "ticks": ticks,
        "node_ticks_per_sec": round(n * ticks / wall, 1),
        "wall_seconds": round(wall, 3),
        "device": device_info(dev),
    }


def dense_conf(n: int, ticks: int) -> str:
    """The dense leg's conf (the JAX bench's)."""
    return (f"MAX_NNB: {n}\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
            f"MSG_DROP_PROB: 0.0\nFANOUT: 3\nTOTAL_TIME: {ticks}\n"
            f"FAIL_TIME: {ticks // 2}\nJOIN_MODE: batch\nBACKEND: tpu\n")


# --------------------------------------------------------------------------
# Orchestrator

def _best_banked_tpu(*_args, **_kw):
    """Not ported, by design: the JAX bench's headline from banked TPU
    rows."""
    raise NotImplementedError(BANKED_REFUSAL)


def _banked_displaces_live(*_args, **_kw):
    """Not ported, by design: a banked TPU row in place of a live one."""
    raise NotImplementedError(BANKED_REFUSAL)


def _ledger_bank(leg: str, row: dict, path: str) -> None:
    """Bank a live leg row into the port's ledger at ``path``, keyed by
    the card's name, and warn on regressions vs banked history
    (observability/perfdb.py).  The ledger is telemetry: any failure here
    is a warning, never a bench failure."""
    try:
        from distributed_membership_tpu_torch.observability import perfdb
        backend = "tpu_hash" if leg == "hash" else "dense"
        card = (row.get("device") or {}).get("name")
        common = dict(n=row.get("n"), s=row.get("view_size"),
                      platform=row.get("platform"), source=MODULE)

        def keyed(knobs: dict) -> dict:
            return {**knobs, "device": card}

        rows = [perfdb.make_row(
            f"bench:live:{leg}", metric="node_ticks_per_sec",
            value=row["node_ticks_per_sec"], backend=backend,
            knobs=keyed({k: row[k] for k in ("ticks", "exchange", "mode")
                         if k in row}), **common)]
        if row.get("service_queries_per_sec"):
            # The BENCH_SERVICE companion rows: sustained client-side
            # query rate against the live daemon, keyed apart from the
            # tick-rate rung; p50/p99 and staleness as lower-is-better
            # metrics on the same rung (rung:w{W} per pool width).
            svc_knobs = {"clients": row.get("service_clients"),
                         "ticks": row.get("ticks")}
            if row.get("service_overhead_pct") is not None:
                svc_knobs["overhead_pct"] = row["service_overhead_pct"]
            if row.get("service_workers"):
                svc_knobs["service_workers"] = row["service_workers"]
            if row.get("service_connect"):
                svc_knobs["connect"] = row["service_connect"]
            rows.append(perfdb.make_row(
                f"bench:live:{leg}:service",
                metric="service_queries_per_sec",
                value=row["service_queries_per_sec"], backend=backend,
                knobs=keyed(svc_knobs), **common))
            for metric, field in (
                    ("service_p50_ms", "service_p50_ms"),
                    ("service_p99_ms", "service_p99_ms"),
                    ("service_staleness_ticks",
                     "service_staleness_mean_ticks")):
                if row.get(field) is not None:
                    rows.append(perfdb.make_row(
                        f"bench:live:{leg}:service", metric=metric,
                        value=row[field], higher_is_better=False,
                        backend=backend, knobs=keyed(svc_knobs), **common))
        if row.get("metrics_wall_seconds"):
            # The BENCH_METRICS companion row (lower is better).
            rows.append(perfdb.make_row(
                f"bench:live:{leg}:metrics",
                metric="metrics_overhead_pct",
                value=row["metrics_overhead_pct"],
                higher_is_better=False, backend=backend,
                knobs=keyed({"hz": row.get("metrics_hz"),
                             "base_wall_seconds":
                             row.get("metrics_base_wall_seconds"),
                             "wall_seconds": row.get("metrics_wall_seconds"),
                             "ticks": row.get("ticks")}), **common))
        if row.get("exchange_batched_wall_seconds"):
            # The BENCH_EXCHANGE companion row (positive = batched wins);
            # a DM_DIST_* multi-process run keys it per process count.
            x_knobs = {"devices": row.get("exchange_devices"),
                       "legacy_wall_seconds":
                       row.get("exchange_legacy_wall_seconds"),
                       "batched_wall_seconds":
                       row.get("exchange_batched_wall_seconds"),
                       "ticks": row.get("ticks")}
            procs = int(os.environ.get("DM_DIST_PROCS", "1") or 1)
            if procs > 1:
                x_knobs["procs"] = procs
            rows.append(perfdb.make_row(
                f"bench:live:{leg}:exchange",
                metric="exchange_speedup_pct",
                value=row["exchange_speedup_pct"],
                backend="tpu_hash_sharded", knobs=keyed(x_knobs),
                **common))
        if row.get("reshard_seconds") is not None:
            # The BENCH_RESHARD companion row (lower is better), keyed
            # rung:...:reshard by the lifted knob.
            rows.append(perfdb.make_row(
                f"bench:live:{leg}:elastic",
                metric="reshard_wall_seconds",
                value=row["reshard_seconds"], higher_is_better=False,
                backend="tpu_hash_sharded",
                knobs=keyed({"reshard": 1,
                             "devices": row.get("reshard_devices"),
                             "from_shape": row.get("reshard_from_shape"),
                             "to_shape": row.get("reshard_to_shape"),
                             "carry_bytes_full":
                             row.get("reshard_carry_bytes_full"),
                             "resume_same_wall_seconds":
                             row.get("resume_same_shape_wall_seconds"),
                             "resume_reshard_wall_seconds":
                             row.get("resume_reshard_wall_seconds"),
                             "ticks": row.get("ticks")}), **common))
        if row.get("mega_ticks"):
            # The BENCH_MEGA companion row (positive = the blocks win),
            # keyed per block size (rung:t{T}).
            rows.append(perfdb.make_row(
                f"bench:live:{leg}:mega",
                metric="mega_speedup_pct",
                value=row["mega_speedup_pct"], backend=backend,
                knobs=keyed({"mega_ticks": row["mega_ticks"],
                             "off_wall_seconds":
                             row.get("mega_off_wall_seconds"),
                             "mega_wall_seconds":
                             row.get("mega_wall_seconds"),
                             "carry_bytes_full":
                             row.get("mega_carry_bytes_full"),
                             "carry_bytes_packed":
                             row.get("mega_carry_bytes_packed"),
                             "ticks": row.get("ticks")}), **common))
        perfdb.append_rows(rows, path)
        _check_ledger(perfdb, path)
    except (OSError, KeyError, TypeError, ValueError) as e:
        print(f"warning: perf ledger update failed: {e}", file=sys.stderr)


def _run_leg(leg: str, n: int, ticks: int, device: str, timeout: float,
             ledger: str, view: int = 0) -> dict | None:
    """One leg in a child process -> its row, or None when it failed (a
    warning says why).  A leg that refuses its config raises SystemExit:
    the refusal is deterministic, so the bench stops rather than report
    something the caller did not ask for."""
    cmd = _child("--leg", leg, "--n", str(n), "--ticks", str(ticks),
                 "--device", device)
    if view:
        cmd += ["--view", str(view)]
    try:
        r = subprocess.run(cmd, timeout=timeout, capture_output=True,
                           text=True, cwd=REPO)
    except subprocess.TimeoutExpired:
        print(f"warning: bench leg {leg} timed out after {timeout}s",
              file=sys.stderr)
        return None
    if r.returncode != 0:
        tail = (r.stderr or r.stdout or "").strip().splitlines()[-8:]
        if any(line.startswith(("ValueError", "NotImplementedError"))
               for line in tail):
            raise SystemExit(
                f"bench leg {leg} rejected its config:\n  "
                + "\n  ".join(tail))
        print(f"warning: bench leg {leg} failed rc={r.returncode}:\n  "
              + "\n  ".join(tail), file=sys.stderr)
        return None
    try:
        row = json.loads(r.stdout.strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError):
        print(f"warning: bench leg {leg} produced no JSON", file=sys.stderr)
        return None
    if isinstance(row, dict) and row.get("node_ticks_per_sec"):
        _ledger_bank(leg, row, ledger)
    elif isinstance(row, dict) and row.get("leg") == "fleet":
        _ledger_bank_fleet(row, ledger)
    return row


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=f"python -m {MODULE}", description=__doc__.split("\n")[0])
    ap.add_argument("--leg", choices=["hash", "dense", "fleet"],
                    default=None, help="run one leg here (child mode)")
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=0)
    ap.add_argument("--view", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the legs run (default: the card)")
    ap.add_argument("--ledger", default=os.path.join(REPO, LEDGER_PATH),
                    help="the perf ledger the rows are banked into")
    ap.add_argument("--service-client", type=int, default=None,
                    metavar="PORT", help=argparse.SUPPRESS)
    ap.add_argument("--metrics-scraper", type=int, default=None,
                    metavar="PORT", help=argparse.SUPPRESS)
    ap.add_argument("--connect", default="",
                    metavar="HOST:PORT", help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    if args.service_client is not None:   # _bench_service's query load
        return _service_client_main(args.service_client, args.n,
                                    connect=args.connect)
    if args.metrics_scraper is not None:  # _bench_metrics's scrape load
        return _metrics_scraper_main(
            args.metrics_scraper,
            float(os.environ.get("BENCH_METRICS_HZ", "10")))
    if args.leg:   # child mode
        if args.leg == "hash":
            row = leg_hash(args.n, args.ticks, args.device, args.view)
        elif args.leg == "fleet":
            import torch
            row = _bench_fleet(torch.device(args.device))
        else:
            row = leg_dense(args.n, args.ticks, args.device)
        print(json.dumps(row))
        return 0

    import torch

    from distributed_membership_tpu_torch.scale_smoke import device_info

    metric0 = "node_ticks_per_sec (tpu_hash scale leg)"
    if args.device == "cuda" and not torch.cuda.is_available():
        print(json.dumps({
            "metric": metric0, "value": None, "unit": "node-ticks/s/chip",
            "platform": "cuda", "error":
                "no card: torch.cuda.is_available() is false; no leg ran "
                "(--device cpu runs the legs' plain versions on the CPU)"}))
        return 1
    device = args.device
    info = device_info(torch.device(device))
    timeout = float(os.environ.get("BENCH_TIMEOUT", "1200"))
    dense_n = int(os.environ.get("BENCH_DENSE_N", "512"))
    # The S=16 leg is skipped when it would duplicate the first
    # (BENCH_VIEW=16) or pin a kernel at S=16 without the folded layout.
    want_s16 = (int(os.environ.get("BENCH_VIEW", "128")) != 16
                and (os.environ.get("BENCH_FUSED", "auto") in ("off", "auto")
                     or os.environ.get("BENCH_FOLDED", "auto") == "on"))
    failed = []

    def leg(name, n, ticks, leg_timeout, view=0):
        row = _run_leg(name, n, ticks, device, leg_timeout, args.ledger,
                       view)
        if row is None:
            failed.append(f"{name} N={n} ticks={ticks}"
                          + (f" S={view}" if view else ""))
        return row

    hash_res = None
    if device == "cuda":
        # The size ladder, upward: the largest success headlines; no rung
        # after a failed one.
        if "BENCH_N" in os.environ:
            ladder = [(int(os.environ["BENCH_N"]),
                       int(os.environ.get("BENCH_TICKS", "60")), timeout)]
        else:
            ladder = [(1 << 16, 100, min(timeout, 300.0)),
                      (1 << 18, 60, min(timeout, 480.0)),
                      (1 << 20, 60, min(timeout, 900.0))]
            if "BENCH_TICKS" in os.environ:
                bt = int(os.environ["BENCH_TICKS"])
                ladder = [(n, bt, to) for n, _, to in ladder]
        for n, ticks, rung_timeout in ladder:
            res = leg("hash", n, ticks, rung_timeout)
            if res is None:
                break
            hash_res = res
        s16_n = int(os.environ.get("BENCH_N", str(1 << 20)))
        s16_ticks = int(os.environ.get("BENCH_TICKS", "60"))
        s16_timeout = min(timeout, 900.0)
    else:
        s16_n = int(os.environ.get("BENCH_N", str(1 << 16)))
        s16_ticks = int(os.environ.get("BENCH_TICKS", "40"))
        s16_timeout = timeout
        hash_res = leg("hash", s16_n, s16_ticks, timeout)
    hash16_res = (leg("hash", s16_n, s16_ticks, s16_timeout, view=16)
                  if want_s16 else None)
    dense_res = leg("dense", dense_n, 100, timeout)

    # Two live hash regimes: the faster one headlines (both rows are
    # reported; the metric string names the winning config).
    hash_alt = None
    if hash16_res is not None and (
            hash_res is None
            or hash16_res["node_ticks_per_sec"]
            > hash_res["node_ticks_per_sec"]):
        hash_res, hash_alt = hash16_res, hash_res
    else:
        hash_alt = hash16_res

    if hash_res is None:
        print(json.dumps({
            "metric": metric0, "value": None, "unit": "node-ticks/s/chip",
            "error": "all hash legs failed", "platform": device,
            "device": info, "failed_legs": failed, "dense": dense_res}))
        return 1

    value = hash_res["node_ticks_per_sec"]
    mode = hash_res.get("mode", "natural")
    out = {
        "metric": (f"node_ticks_per_sec (tpu_hash N={hash_res['n']}, "
                   f"S={hash_res['view_size']}, P={hash_res['probes']}, "
                   f"fanout={hash_res['fanout']}, "
                   f"{hash_res.get('exchange', 'scatter')} exchange, "
                   f"{mode}, {hash_res['ticks']} ticks, "
                   f"{hash_res['platform']}, warm_cache, live)"),
        "value": value,
        "unit": "node-ticks/s/chip",
        "vs_baseline": round(value / REFERENCE_NODE_TICKS_PER_SEC, 2),
        "protocol_ticks_per_sec": hash_res["ticks_per_sec"],
        "est_hbm_gbps": hash_res["est_hbm_gbps"],
        "platform": hash_res["platform"],
        "device": info,
        "timing": "warm_cache",
        "source": "live",
        "mode": mode,
        "dense": dense_res,
    }
    row_keys = ("n", "ticks", "view_size", "exchange", "mode", "platform",
                "node_ticks_per_sec", "ticks_per_sec", "wall_seconds")
    out["hash"] = {k: hash_res[k] for k in row_keys if k in hash_res}
    if hash_alt is not None:
        out["hash_alt"] = {k: hash_alt[k] for k in row_keys if k in hash_alt}
    if dense_res is not None and (dense_res["node_ticks_per_sec"]
                                  < REFERENCE_NODE_TICKS_PER_SEC):
        # The dense leg is the O(N^2) exact-parity path at many times the
        # reference's node count: flag it when it loses to the C++
        # baseline, so the headline's vs_baseline is not read as covering
        # it.
        dense_res["note"] = ("below C++ reference wall-clock rate "
                             "(exact-parity O(N^2) path at "
                             f"N={dense_res['n']} vs reference N=10)")
    if os.environ.get("BENCH_FLEET", "0") not in ("", "0"):
        out["fleet"] = leg("fleet", 0, 0, timeout)
    if failed:
        out["failed_legs"] = failed
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
