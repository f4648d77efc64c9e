"""Bounded-worker scheduler (counterpart of the JAX package's
``fleet/scheduler.py``): each run is the port's driver in a subprocess.

One worker = ``python -m distributed_membership_tpu_torch run.conf
--device D`` on the fleet's device (``cuda`` unless the fleet was started
with ``--device cpu``; a worker that finds no card fails, it never falls
back to the CPU), with per-run isolation: its own out dir (artifacts), checkpoint dir
(``<run>/ck``) and telemetry dir, all under ``<fleet root>/<run_id>/``.
Chunkable backends always get ``--checkpoint-every``/``--resume`` so a
worker restart (pause, crash, controller restart) continues bit-exactly
from the last durable boundary; ring-family confs additionally get
``--serve --port 0`` so the controller can proxy the full single-run
API under ``/v1/runs/<id>/``.

Workers are leashed to the controller with PR_SET_PDEATHSIG (SIGKILL):
a SIGKILLed controller takes its workers down with it, which is what
makes the crash-recovery story honest — recovery never has to reason
about orphans still appending to the dirs it is probing, and a hard
kill is exactly the fault the checkpoint writer's atomic rename
discipline is built for.

Progress reporting needs no HTTP: the driver rewrites the
``DM_RUN_STATE_FILE`` beacon (runtime/checkpoint.py) at every boundary,
so headless workers are observable too.  Serve workers are additionally
health-polled to detect run completion (artifacts flushed), at which
point the controller either posts ``/v1/admin/shutdown`` or — with
FLEET_LINGER — leaves the worker serving its final snapshot.
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.fleet.registry import (
    DEFAULT_CHECKPOINT_EVERY, Registry, RunRecord)
from distributed_membership_tpu_torch.observability.beacon import (
    read_beacon)
from distributed_membership_tpu_torch.runtime.checkpoint import (
    STATE_FILE_ENV, read_run_state)
from distributed_membership_tpu_torch.service.daemon import SERVICE_JSON

POLL_SECONDS = 0.2
HEALTH_EVERY_SECONDS = 0.5


def _leash_to_parent():          # pragma: no cover - runs in the child
    """preexec_fn: die with the controller (Linux PR_SET_PDEATHSIG)."""
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)      # PR_SET_PDEATHSIG = 1
    except Exception:
        pass                               # non-Linux: best effort


def reap_orphans(journal_rows: list, root: str) -> int:
    """SIGKILL workers a dead controller left behind; -> count killed.

    PR_SET_PDEATHSIG already leashes workers on mainline Linux, but
    some kernels (and non-Linux hosts) never deliver it, so recovery
    re-derives the worker set from the journal's ``running`` pids and
    kills any that still exist — verifying first that the pid's command
    line names OUR run dir, so a recycled pid belonging to an innocent
    process is never signalled.  Runs BEFORE the disk probe: a probe
    racing a live orphan's checkpoint writer could adopt a manifest the
    orphan is about to supersede.
    """
    last: dict = {}
    for row in journal_rows:
        if row.get("kind") == "state" and row.get("run_id"):
            last[row["run_id"]] = row
    killed = 0
    for run_id, row in last.items():
        pid = row.get("pid")
        if row.get("state") != "running" or not pid:
            continue
        marker = os.path.join(os.path.abspath(root), run_id, "run.conf")
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmdline = fh.read().decode(errors="replace")
        except OSError:
            continue                       # gone (or no procfs)
        if marker not in cmdline.replace("\x00", " "):
            continue                       # pid was recycled
        try:
            os.kill(pid, signal.SIGKILL)
            killed += 1
        except OSError:
            continue
        for _ in range(50):                # until really gone
            try:
                os.kill(pid, 0)
            except OSError:
                break
            time.sleep(0.1)
    return killed


def sweep_stale_rings() -> int:
    """Unlink snapshot-ring shm segments whose creator daemon is gone;
    -> count unlinked.

    The ring name encodes the creating daemon's pid
    (``dmring_<pid:x>_<nonce>``), and every live consumer holds a
    mapping that survives the unlink — so removing a segment whose
    creator pid no longer exists (or belongs to another user's
    process, which a worker of ours can never be) is always safe.
    Covers the one leak path the in-band teardown can't: worker AND
    all its replicas SIGKILLed before any of them unlinked.
    """
    from distributed_membership_tpu_torch.service import shm_ring
    swept = 0
    for name in shm_ring.stale_segments():
        try:
            pid = int(name.split("_")[1], 16)
        except (IndexError, ValueError):
            continue
        try:
            os.kill(pid, 0)
            continue                       # creator alive: ring in use
        except ProcessLookupError:
            pass
        except OSError:
            continue                       # EPERM: not our process
        if shm_ring.unlink(name):
            swept += 1
    return swept


def _http(port: int, method: str, path: str,
          timeout: float = 2.0) -> Optional[dict]:
    """One JSON round-trip to a worker daemon; None on any failure."""
    import http.client
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=timeout)
        try:
            conn.request(method, path)
            resp = conn.getresponse()
            return json.loads(resp.read() or b"{}")
        finally:
            conn.close()
    except (OSError, ValueError):
        return None


class _Worker:
    """One live subprocess and its discovery/beacon files."""

    def __init__(self, rec: RunRecord, run_dir: str,
                 proc: subprocess.Popen, log_fh):
        self.rec = rec
        self.run_dir = run_dir
        self.proc = proc
        self.log_fh = log_fh
        self.port: Optional[int] = None
        self.lingering = False       # run done, still serving
        self.shutdown_sent = False
        self.next_health = 0.0
        self.started_wall = time.time()   # alert rows older than this
        self.migrate_trigger = ""         # are a previous incarnation's

    def state_path(self) -> str:
        return os.path.join(self.run_dir, "run_state.json")

    def discover_port(self) -> Optional[int]:
        """The worker's ephemeral service port, from ITS service.json
        (pid-checked: a stale file from a previous incarnation of this
        run dir must not be trusted)."""
        if self.port is not None:
            return self.port
        info = read_beacon(os.path.join(self.run_dir, SERVICE_JSON))
        if info is not None and info.get("pid") == self.proc.pid:
            self.port = int(info["port"])
        return self.port

    def discover_replicas(self) -> list:
        """Ports of the worker's read-replica pool (service.json
        ``replicas``, pid-checked like :meth:`discover_port`); [] when
        the worker runs without a query tier."""
        info = read_beacon(os.path.join(self.run_dir, SERVICE_JSON))
        if info is None or info.get("pid") != self.proc.pid:
            return []
        return [int(r["port"]) for r in info.get("replicas") or []
                if isinstance(r, dict) and r.get("port")]

    def log_tail(self, limit: int = 400) -> str:
        try:
            with open(os.path.join(self.run_dir, "worker.log"),
                      "rb") as fh:
                fh.seek(0, os.SEEK_END)
                fh.seek(max(fh.tell() - 4096, 0))
                text = fh.read().decode(errors="replace").strip()
            return text[-limit:]
        except OSError:
            return ""


def _override_mesh(conf_text: str, shape: str) -> str:
    """conf text with MESH_SHAPE pinned to ``shape`` (placement
    retarget) — any existing MESH_SHAPE line is dropped first."""
    lines = [ln for ln in conf_text.splitlines()
             if not re.match(r"\s*MESH_SHAPE\s*:", ln)]
    lines.append(f"MESH_SHAPE: {shape}")
    return "\n".join(lines) + "\n"


def worker_argv(rec: RunRecord, root: str, device: str = "cuda") -> list:
    """The exact command line a worker for ``rec`` runs with, on
    ``device``.

    Paths are absolute: the argv doubles as the orphan-reaper's
    identity check (``reap_orphans``), which must hold across
    controller restarts from a different working directory."""
    run_dir = os.path.abspath(rec.run_dir(root))
    argv = [sys.executable, "-m", "distributed_membership_tpu_torch",
            os.path.join(run_dir, "run.conf"),
            "--out-dir", run_dir, "--seed", str(rec.seed),
            "--device", device]
    if rec.mode in ("serve", "headless-ck"):
        argv += ["--checkpoint-dir", os.path.join(run_dir, "ck"),
                 "--resume", "--telemetry-dir", run_dir]
        conf = Params().parse(rec.conf_text, validate=False)
        if conf.CHECKPOINT_EVERY <= 0:
            argv += ["--checkpoint-every",
                     str(DEFAULT_CHECKPOINT_EVERY)]
        if rec.mode == "serve":
            argv += ["--serve", "--port", "0"]
            if conf.TELEMETRY == "off":
                # Trajectory-inert (excluded from the manifest's
                # params identity) — arms the snapshot/timeline the
                # proxied query surface answers from.
                argv += ["--telemetry", "scalars"]
    if rec.scenario is not None:
        argv += ["--scenario", os.path.join(run_dir, "scenario.json")]
    return argv


class Scheduler:
    """FIFO + priority dispatch onto at most ``max_concurrency``
    concurrent workers.  All mutation happens under ``lock`` — the
    same lock the fleet daemon's handler threads take, so the registry
    never needs its own."""

    def __init__(self, registry: Registry, max_concurrency: int,
                 lock: threading.Lock, linger: bool = False,
                 policy=None, placement=None, device: str = "cuda"):
        self.registry = registry
        self.device = device         # every worker's --device
        self.max_concurrency = int(max_concurrency)
        self.lock = lock
        self.linger = bool(linger)
        # Elastic mesh: the migration policy (elastic/migrate.py
        # MigratePolicy, None = manual /migrate only) and the capacity
        # model (fleet/placement.py HostCapacity, None = unconstrained —
        # the pre-elastic behavior every existing fleet keeps).
        self.policy = policy
        self.placement = placement
        self.workers: Dict[str, _Worker] = {}
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-scheduler",
                                        daemon=True)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        self._thread.start()

    def wake(self) -> None:
        self._wake.set()

    def running_count(self) -> int:
        return sum(1 for w in self.workers.values()
                   if not w.lingering and w.proc.poll() is None)

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self.lock:
                self._reap()
                self._poll()
                self._launch()
            self._wake.wait(POLL_SECONDS)
            self._wake.clear()

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop dispatching, then stop workers the graceful way:
        SIGTERM (the chunked driver checkpoints and exits at the next
        boundary), SIGKILL stragglers.  Interrupted runs are journaled
        ``checkpointed``/``queued`` so the next ``--fleet`` resumes
        them."""
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5.0)
        with self.lock:
            for w in self.workers.values():
                if w.proc.poll() is None:
                    if not w.lingering:
                        w.rec.pausing = True
                    try:
                        w.proc.send_signal(signal.SIGTERM)
                    except OSError:
                        pass
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self.lock:
                self._reap()
                if not any(w.proc.poll() is None
                           for w in self.workers.values()):
                    break
            time.sleep(0.1)
        with self.lock:
            for w in self.workers.values():
                if w.proc.poll() is None:
                    try:
                        w.proc.kill()
                        w.proc.wait(timeout=5.0)
                    except OSError:
                        pass
            self._reap()

    # -- control verbs (called under the fleet lock) -------------------
    def pause(self, rec: RunRecord) -> bool:
        w = self.workers.get(rec.run_id)
        if w is None or w.proc.poll() is not None or w.lingering:
            return False
        rec.pausing = True
        try:
            w.proc.send_signal(signal.SIGTERM)
        except OSError:
            return False
        return True

    def kill(self, rec: RunRecord) -> bool:
        w = self.workers.get(rec.run_id)
        if w is None or w.proc.poll() is not None:
            return False
        rec.killing = True
        try:
            w.proc.kill()
        except OSError:
            return False
        return True

    def migrate(self, rec: RunRecord) -> bool:
        """Operator drain (POST /v1/runs/<id>/migrate on a RUNNING
        run): SIGTERM so the chunked driver parks at the next durable
        boundary, then the reap path journals migrating -> requeued."""
        w = self.workers.get(rec.run_id)
        if (w is None or w.proc.poll() is not None or w.lingering
                or rec.mode == "headless"):
            return False
        rec.migrate_requested = True
        w.migrate_trigger = "manual"
        try:
            w.proc.send_signal(signal.SIGTERM)
        except OSError:
            return False
        return True

    def worker_port(self, run_id: str) -> Optional[int]:
        w = self.workers.get(run_id)
        if w is None or w.proc.poll() is not None:
            return None
        return w.discover_port()

    def replica_ports(self, run_id: str) -> list:
        w = self.workers.get(run_id)
        if w is None or w.proc.poll() is not None:
            return []
        return w.discover_replicas()

    # -- internals (under the fleet lock) ------------------------------
    def _spawn(self, rec: RunRecord) -> None:
        root = self.registry.root
        run_dir = rec.run_dir(root)
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "run.conf"), "w") as fh:
            fh.write(rec.conf_text)
        if rec.scenario is not None:
            scn = rec.scenario
            if isinstance(scn, list):
                scn = {"name": rec.run_id, "events": scn}
            with open(os.path.join(run_dir, "scenario.json"),
                      "w") as fh:
                json.dump(scn, fh, indent=1)
        # Stale discovery/beacon files from a previous incarnation of
        # this run dir must not be mistaken for the new worker's.
        for stale in (SERVICE_JSON, "run_state.json"):
            try:
                os.unlink(os.path.join(run_dir, stale))
            except OSError:
                pass
        env = dict(os.environ)
        env[STATE_FILE_ENV] = os.path.join(run_dir, "run_state.json")
        log_fh = open(os.path.join(run_dir, "worker.log"), "ab")
        kwargs = {}
        if os.name == "posix":
            kwargs["preexec_fn"] = _leash_to_parent
        proc = subprocess.Popen(worker_argv(rec, root, self.device),
                                env=env, stdout=log_fh,
                                stderr=subprocess.STDOUT, **kwargs)
        self.workers[rec.run_id] = _Worker(rec, run_dir, proc, log_fh)
        self.registry.set_state(rec, "running", pid=proc.pid,
                                pausing=False, killing=False,
                                exit_code=None, error="")

    def _launch(self) -> None:
        free = self.max_concurrency - self.running_count()
        for rec in self.registry.queued():
            if free <= 0:
                break
            if self.placement is not None and not self._place(rec):
                continue         # no capacity: stays queued, not lost
            self._spawn(rec)
            free -= 1

    def _place(self, rec: RunRecord) -> bool:
        """Consult the capacity model; retarget the run's mesh shape
        when the granted slice prescribes a different one (the
        'resharded if needed' leg: the durable checkpoint is rewritten
        by elastic/reshard.py and the conf change is journaled)."""
        from distributed_membership_tpu_torch.elastic.reshard import (
            ReshardError, mesh_size, reshard)
        from distributed_membership_tpu_torch.fleet.placement import (
            PlacementError)
        p = Params().parse(rec.conf_text, validate=False)
        sharded = p.BACKEND.endswith("_sharded")
        try:
            granted = self.placement.place(
                rec.run_id, sharded=sharded,
                devices=mesh_size(p.MESH_SHAPE, default=1))
        except PlacementError as e:
            rec.error = str(e)   # visible in GET /v1/runs while queued
            return False
        if (sharded and granted.mesh_shape
                and granted.mesh_shape != p.MESH_SHAPE):
            try:
                ck = rec.ckpt_dir(self.registry.root)
                if os.path.exists(os.path.join(ck, "MANIFEST.json")):
                    reshard([ck], [ck],
                            to_mesh_shape=granted.mesh_shape,
                            device=self.device)
                self.registry.update_conf(
                    rec, _override_mesh(rec.conf_text,
                                        granted.mesh_shape))
            except (ReshardError, ValueError) as e:
                self.placement.release(rec.run_id)
                rec.error = f"reshard to {granted.mesh_shape!r}: {e}"
                return False
        return True

    def _poll(self) -> None:
        now = time.monotonic()
        for w in self.workers.values():
            if w.proc.poll() is not None or w.lingering:
                continue
            st = read_run_state(w.state_path())
            if st is not None:
                w.rec.tick = max(w.rec.tick, int(st.get("tick", 0)))
            self._check_sick(w, st)
            if w.rec.mode != "serve" or now < w.next_health:
                continue
            w.next_health = now + HEALTH_EVERY_SECONDS
            port = w.discover_port()
            if port is None:
                continue
            w.rec.port = port
            health = _http(port, "GET", "/healthz")
            if health is None:
                continue
            w.rec.tick = max(w.rec.tick, int(health.get("tick", 0)))
            if health.get("status") == "complete":
                # Artifacts are flushed before the daemon reports
                # complete, so this is the safe adoption point.
                if self.linger:
                    w.lingering = True
                    self.registry.set_state(w.rec, "done",
                                            tick=w.rec.tick)
                elif not w.shutdown_sent:
                    w.shutdown_sent = True
                    _http(port, "POST", "/v1/admin/shutdown")

    def _check_sick(self, w: _Worker, beacon: Optional[dict]) -> None:
        """Watchdog-alert / stale-beacon migration triggers (the
        metrics plane's signals): a sick worker is drained — SIGTERM when it can still
        checkpoint (alerts), SIGKILL when it is wedged (stale beacon;
        the last durable boundary is adopted) — and the reap path
        journals the migration."""
        rec = w.rec
        if (self.policy is None or rec.migrate_requested
                or rec.mode == "headless"
                or rec.migrations >= self.policy.max_migrations):
            return
        trigger = self.policy.sick_trigger(
            run_dir=w.run_dir, beacon=beacon, total=rec.total,
            started_wall=w.started_wall)
        if trigger is None:
            return
        rec.migrate_requested = True
        w.migrate_trigger = trigger
        try:
            w.proc.send_signal(signal.SIGKILL
                               if trigger == "stale-beacon"
                               else signal.SIGTERM)
        except OSError:
            pass

    def _reap(self) -> None:
        for run_id in list(self.workers):
            w = self.workers[run_id]
            rc = w.proc.poll()
            if rc is None:
                continue
            try:
                w.log_fh.close()
            except OSError:
                pass
            del self.workers[run_id]
            rec = w.rec
            rec.pid = rec.port = None
            if self.placement is not None:
                self.placement.release(run_id)
            if w.lingering:
                continue             # already journaled done
            seen_tick = rec.tick     # beacon's last word before probing
            was_asked = rec.pausing or rec.killing
            state = self._classify(rec, rc)
            self.registry.set_state(rec, state,
                                    exit_code=rc, tick=rec.tick,
                                    pausing=False, killing=False,
                                    error=("" if rc == 0
                                           else w.log_tail()))
            trigger = w.migrate_trigger
            if (not trigger and not was_asked and self.policy is not None
                    and self.policy.on_death):
                trigger = "death"
            if trigger and state in ("checkpointed", "failed"):
                self._migrate_now(rec, trigger, from_tick=seen_tick)

    def _migrate_now(self, rec: RunRecord, trigger: str,
                     from_tick: int) -> None:
        """Journal the ``migrating`` -> ``requeued`` transition (both
        fsync-before-ACK via the registry journal).  The relaunch path
        (placement consult in ``_launch``) picks the target."""
        from distributed_membership_tpu_torch.elastic.migrate import (
            migrate_record)
        rec.migrate_requested = False
        if (trigger != "manual" and self.policy is not None
                and rec.migrations >= self.policy.max_migrations):
            return               # cap reached: terminal state stands
        migrate_record(self.registry, rec, trigger, from_tick=from_tick)

    def _classify(self, rec: RunRecord, rc: int) -> str:
        """Exit code + on-disk reality -> registry state."""
        if rec.killing:
            return "killed"
        probed = self.registry._probe_disk(rec)   # refreshes rec.tick
        if probed == "done":
            # Artifacts + (for chunked runs) a manifest at total are
            # durable proof, whatever the exit path was.
            return "done"
        if rec.pausing:
            # Graceful stop: chunked workers parked at a durable
            # boundary; a plain headless run has nothing durable and
            # goes back to the queue from scratch.
            return ("checkpointed" if rc == 0 and rec.tick > 0
                    else "queued")
        if rec.mode != "headless" and rec.tick > 0:
            # Graceful-but-unrequested exit (operator SIGTERMed the
            # worker directly), OR a crash that still left a COMPLETE
            # durable boundary — the disk probe above refreshed
            # rec.tick from the manifest, which only ever names fully
            # written snapshots (atomic rename).  A worker that died
            # DURING a checkpoint write therefore lands here too, and
            # failover resumes from the last boundary instead of
            # restarting from scratch.
            return "checkpointed"
        return "failed"
