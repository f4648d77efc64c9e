"""Checkpoint and resume (counterpart of the JAX package's
``runtime/checkpoint.py``): the chunked tick loop and its on-disk format.

:func:`chunked_run` drives a ring step in ``CHECKPOINT_EVERY``-tick
segments.  The carry stays on the run's device between segments; when
``CHECKPOINT_DIR`` is set it is copied to the host at every boundary and
written by one background thread as ``ckpt_<tick>.npz`` (atomic
write-rename), then ``MANIFEST.json`` names it, with the run's identity
``(params_text, seed, backend, total_time, collect_events,
process_count)``, the scenario file's digest and the carry's
``state_hash``.  A run of K processes (runtime/distributed.py) hands
:func:`chunked_run` the global carry at every boundary, so each process
writes the whole carry into its own ``CHECKPOINT_DIR`` and resumes
from it; the manifests differ from a one-process run's in
``process_count`` only.  The per-tick keys are ``fold_in(seed key,
t)``, so only the tick is persisted.  ``RESUME: 1`` checks the manifest
against the run and continues from its tick, bit for bit.

The files are the JAX package's, member for member: ``c0..cK`` are the
carry's leaves in the JAX flatten order (convert.py, u32 planes as
``uint32``), ``e_joins``/``e_removes``/``e_sent``/``e_recv`` the
compacted events of a full-event run, ``e_s0..e_s3`` the per-tick int32
totals (join, rm, sent, recv) of an agg-mode run.  So a directory
written by either package resumes in the other.

Fault injection: ``DM_CRASH_AT_TICK=k`` raises ``RuntimeError`` at the
first segment start ``a >= k``, after the in-flight write is durable.
``DM_RUN_STATE_FILE`` names a JSON file rewritten atomically with
``{tick, total, ts}`` at every boundary (read back by
:func:`read_run_state`).  SIGTERM and SIGINT stop the
run at the next boundary with :class:`RunInterrupted`, the boundary's
snapshot durable.  With ``TELEMETRY_DIR`` the segments are logged to
``runlog.jsonl`` (observability/runlog.py).  :class:`boundary_hook`
installs the service daemon's hook (service/daemon.py), called with the
carry before the first segment and at every boundary: it publishes
snapshots, swaps in the runner of a merged plan, and asks for a stop.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

import numpy as np
import torch

from distributed_membership_tpu_torch.backends.tpu_sparse import (
    CompactEvents, SparseTickEvents)
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import (
    carry_from_leaves, carry_leaves, host_leaf, leaf_specs)
from distributed_membership_tpu_torch.observability.runlog import (
    maybe_runlog)
from distributed_membership_tpu_torch.runtime.distributed import (
    process_count)
from distributed_membership_tpu_torch.ops.megakernel import named_leaves

CKPT_VERSION = 1
MANIFEST_NAME = "MANIFEST.json"
KEEP_CHECKPOINTS = 3       # versioned history depth; older files pruned
CRASH_ENV = "DM_CRASH_AT_TICK"
STATE_FILE_ENV = "DM_RUN_STATE_FILE"

# Fields that do not change what a tick computes: the clock, the
# checkpoint and block knobs (segment and block boundaries are
# trajectory-inert), the exchange wire, the flight recorder, and the
# service, fleet and watchdog keys (the JAX package's list).
_IDENTITY_EXCLUDE = frozenset(
    {"globaltime", "dropmsg", "CHECKPOINT_EVERY", "CHECKPOINT_DIR",
     "RESUME", "CHECKPOINT_COMPRESS", "MEGA_TICKS", "MEGA_PACK",
     "EXCHANGE_MODE", "TELEMETRY", "TELEMETRY_DIR",
     "SERVICE_PORT", "SERVICE_SNAPSHOT_EVERY", "SERVICE_WORKERS",
     "SERVICE_SHM_BUFFERS", "FLEET_PORT", "FLEET_MAX_CONCURRENCY",
     "FLEET_DIR", "FLEET_LINGER", "FLEET_MIGRATE_ON", "FLEET_MIGRATE_MAX",
     "WATCHDOG"})


def params_identity(params: Params) -> str:
    """Canonical text of every field that shapes the per-tick math: the
    manifest's ``params_text``, equal to the JAX package's for the same
    conf."""
    d = {k: v for k, v in dataclasses.asdict(params).items()
         if k not in _IDENTITY_EXCLUDE}
    return json.dumps(d, sort_keys=True)


def state_hash(leaves) -> str:
    """sha256 over the carry's leaves (dtype, shape, bytes), in the JAX
    dtypes (u32 planes as ``uint32``)."""
    h = hashlib.sha256()
    for leaf in leaves:
        a = np.ascontiguousarray(np.asarray(leaf))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.reshape(-1).view(np.uint8))     # the bytes, uncopied
    return h.hexdigest()


def compact_dense(events, t0: int = 0) -> CompactEvents:
    """Compact the dense step's TickEvents of ``[C, N, N]`` bool planes
    (the JAX ``compact_dense``): ``(t0 + c, logger, member)`` rows in
    tick, logger, member order.  The planes may be tensors on any device
    (their nonzeros are found there) or numpy arrays."""
    def triples(plane):
        rows = torch.nonzero(torch.as_tensor(plane)).cpu().numpy()
        rows = rows.astype(np.int64).reshape(-1, 3)
        rows[:, 0] += t0
        return rows

    sent = torch.as_tensor(events.sent).cpu().numpy()
    return CompactEvents(triples(events.joins), triples(events.removes),
                         sent, torch.as_tensor(events.recv).cpu().numpy(),
                         sent.shape[0])


def concat_compact(parts: List[CompactEvents]) -> CompactEvents:
    parts = [p for p in parts if p is not None]
    if len(parts) == 1:
        return parts[0]
    return CompactEvents(
        np.concatenate([p.joins for p in parts]),
        np.concatenate([p.removes for p in parts]),
        np.concatenate([p.sent for p in parts]),
        np.concatenate([p.recv for p in parts]),
        sum(p.total for p in parts))


def _empty_compact(n: int) -> CompactEvents:
    z3 = np.zeros((0, 3), np.int64)
    zn = np.zeros((0, n), np.int32)
    return CompactEvents(z3, z3.copy(), zn, zn.copy(), 0)


# --------------------------------------------------------------------------
# On-disk format

def _manifest_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, MANIFEST_NAME)


def load_manifest(ckpt_dir: Optional[str]) -> Optional[dict]:
    """The manifest, or None when absent or unreadable (a torn write is a
    fresh start)."""
    if not ckpt_dir:
        return None
    try:
        with open(_manifest_path(ckpt_dir)) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None


def manifest_tick(ckpt_dir: Optional[str]) -> Optional[int]:
    """The latest durable tick, or None."""
    m = load_manifest(ckpt_dir)
    return None if m is None else int(m.get("tick", 0)) or None


def _atomic_write(path: str, write_fn: Callable[[str], None]) -> None:
    tmp = path + ".tmp"
    write_fn(tmp)
    os.replace(tmp, path)


def _manifest_base(params: Params, seed: int, total: int,
                   collect_events: bool) -> dict:
    base = {
        "version": CKPT_VERSION,
        "params_text": params_identity(params),
        "seed": int(seed),
        "backend": params.BACKEND,
        "total_time": int(total),
        "collect_events": bool(collect_events),
        # Each of the run's processes writes its own directory with the
        # whole (global) carry, so any one of them resumes the run.
        "process_count": process_count(),
    }
    if params.SCENARIO:
        # The file's content, not only its path: an edited schedule must
        # not resume.
        from distributed_membership_tpu_torch.scenario.compile import (
            scenario_digest)
        try:
            base["scenario_digest"] = scenario_digest(params.SCENARIO)
        except OSError:
            base["scenario_digest"] = "unreadable"
    return base


def _save_checkpoint(ckpt_dir: str, base: dict, tick: int,
                     carry_leaves_: list, payload: dict,
                     compress: bool = False) -> None:
    """One snapshot: ``ckpt_<tick>.npz``, then the manifest naming it
    (each an atomic write-rename, so a crash between them leaves the
    previous manifest valid).  Runs on the writer thread."""
    os.makedirs(ckpt_dir, exist_ok=True)
    fname = f"ckpt_{tick:08d}.npz"
    arrays = {f"c{i}": np.asarray(leaf)
              for i, leaf in enumerate(carry_leaves_)}
    arrays.update({f"e_{k}": np.asarray(v) for k, v in payload.items()})

    def _write_npz(tmp):
        with open(tmp, "wb") as fh:
            (np.savez_compressed if compress else np.savez)(fh, **arrays)

    _atomic_write(os.path.join(ckpt_dir, fname), _write_npz)
    shash = state_hash(carry_leaves_)

    prev = load_manifest(ckpt_dir)
    history = []
    reshard_chain = None
    if prev is not None and all(prev.get(k) == base[k] for k in base):
        history = [h for h in prev.get("checkpoints", ())
                   if h["tick"] < tick]
        reshard_chain = prev.get("reshard")
    history.append({"tick": int(tick), "file": fname, "state_hash": shash})
    for stale in history[:-KEEP_CHECKPOINTS]:
        try:
            os.unlink(os.path.join(ckpt_dir, stale["file"]))
        except OSError:
            pass
    history = history[-KEEP_CHECKPOINTS:]
    manifest = dict(base)
    manifest.update({
        "tick": int(tick), "file": fname, "state_hash": shash,
        "checkpoints": history,
        "wrote_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    })
    if reshard_chain:
        manifest["reshard"] = reshard_chain

    def _write_manifest(tmp):
        with open(tmp, "w") as fh:
            json.dump(manifest, fh, indent=1)

    _atomic_write(_manifest_path(ckpt_dir), _write_manifest)


def _placeholder(a: np.ndarray, tmpl: np.ndarray) -> bool:
    """Is ``a`` a per-device placeholder the run's own ``tmpl`` stands
    for: the same dtype, both filled with one and the same value?"""
    if a.dtype != tmpl.dtype or a.size == 0 or tmpl.size == 0:
        return False
    v = a.reshape(-1)[0]
    return bool((a == v).all() and (tmpl == v).all())


def _load_for_resume(ckpt_dir: str, base: dict, template_specs: list,
                     template_leaf: Callable):
    """``(tick, carry leaves, payload)`` from the latest checkpoint, or
    None when there is none.  A manifest of a different run raises.

    ``template_leaf(i)`` is the fresh carry's leaf ``i`` on the host.  A stored leaf whose shape differs from it is taken as the
    run's own when both are placeholders of one fill value: the sharded
    step's ``[D, 1]`` scatter mailboxes (and its other never-written
    per-device leaves) keep the writer's shard count D, so a checkpoint
    resharded onto another D (elastic/reshard.py) resumes.  The JAX
    package refuses such a resume (ROADMAP.md Queue 3)."""
    manifest = load_manifest(ckpt_dir)
    if manifest is None:
        return None
    for k, want in base.items():
        if manifest.get(k) != want:
            raise ValueError(
                f"RESUME manifest mismatch in {ckpt_dir!r}: field {k!r} "
                f"was {manifest.get(k)!r}, this run wants {want!r} — "
                "point CHECKPOINT_DIR elsewhere or clear it")
    path = os.path.join(ckpt_dir, manifest["file"])
    try:
        npz = np.load(path)
    except OSError as e:
        raise ValueError(
            f"RESUME: checkpoint file {path!r} named by the manifest is "
            f"unreadable ({e})") from e
    adopted = {}
    with npz as data:
        leaves = []
        for i, tmpl in enumerate(template_specs):
            key = f"c{i}"
            if key not in data:
                raise ValueError(
                    f"RESUME: checkpoint {path!r} is missing carry leaf "
                    f"{i} (truncated or from an incompatible code "
                    "version)")
            a = data[key]
            mine = (template_leaf(i) if a.shape != tuple(tmpl.shape)
                    else None)
            if mine is not None and _placeholder(a, mine):
                adopted[i] = mine
            elif a.shape != tuple(tmpl.shape) or a.dtype != tmpl.dtype:
                raise ValueError(
                    f"RESUME: carry leaf {i} shape/dtype mismatch "
                    f"({a.shape}/{a.dtype} on disk vs "
                    f"{tuple(tmpl.shape)}/{tmpl.dtype}) — checkpoint is "
                    "from a different config")
            leaves.append(a)
        payload = {k[len("e_"):]: data[k] for k in data.files
                   if k.startswith("e_")}
    got = state_hash(leaves)
    if got != manifest["state_hash"]:
        raise ValueError(
            f"RESUME: state hash mismatch for {path!r} (manifest "
            f"{manifest['state_hash'][:12]}…, file {got[:12]}…) — "
            "checkpoint is corrupt")
    for i, leaf in adopted.items():
        leaves[i] = leaf
    return int(manifest["tick"]), leaves, payload


# --------------------------------------------------------------------------
# The chunked run

def _crash_tick() -> Optional[int]:
    v = os.environ.get(CRASH_ENV)
    return int(v) if v else None


def _state_reporter(total: int) -> Optional[Callable[[int], None]]:
    """A callable writing ``{tick, total, ts}`` (and the beacon's ``v`` and
    ``time``) to ``$DM_RUN_STATE_FILE`` atomically, or None when unset.
    Best effort: a failed write does not stop the run."""
    path = os.environ.get(STATE_FILE_ENV)
    if not path:
        return None

    def report(tick: int) -> None:
        now = time.time()
        doc = {"tick": int(tick), "total": int(total), "ts": now, "v": 1,
               "time": now}
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as fh:
                json.dump(doc, fh)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return report


def read_run_state(path: str) -> Optional[dict]:
    """The ``DM_RUN_STATE_FILE`` beacon's current value, or None when it
    is absent or torn (the fleet scheduler's progress reader)."""
    from distributed_membership_tpu_torch.observability.beacon import (
        read_beacon)
    return read_beacon(path)


class _HostCopies:
    """Where a CUDA carry lands on the host at a boundary: two sets of
    pinned buffers, used in turn, so the device-to-host copy runs at the
    pinned rate and the writer thread still reads the set it was handed
    (the set is reused two boundaries later, after the writer of the
    first has been awaited).  A CPU carry is copied as it is."""

    def __init__(self):
        self._sets = [None, None]
        self._turn = 0

    def pull(self, carry) -> list:
        tensors = [x for _, x in named_leaves(carry)]
        if not tensors[0].is_cuda:
            return carry_leaves(carry)
        bufs = self._sets[self._turn]
        if bufs is None or [b.shape for b in bufs] != [x.shape
                                                       for x in tensors]:
            bufs = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    for x in tensors]
            self._sets[self._turn] = bufs
        self._turn ^= 1
        for b, x in zip(bufs, tensors):
            b.copy_(x, non_blocking=True)
        torch.cuda.current_stream(tensors[0].device).synchronize()
        return [b.numpy().view(spec.dtype)
                for b, spec in zip(bufs, leaf_specs(carry))]


class RunInterrupted(RuntimeError):
    """A SIGTERM/SIGINT, or a boundary hook's ``stop``, stopped
    :func:`chunked_run` at a segment boundary.  The boundary is durable
    when this raises (the writer has finished and the manifest names
    ``tick``), so ``RESUME: 1`` continues from ``tick`` bit for bit."""

    def __init__(self, message: str, tick: int):
        super().__init__(message)
        self.tick = int(tick)


# One process-wide boundary hook (the service daemon runs one engine per
# process).  ``hook(carry, tick)`` is called on the engine thread with
# the DEVICE carry once before the first segment (with the start tick, a
# resumed carry included) and again at every boundary after the
# checkpoint hand-off; whatever it keeps of the carry it copies itself
# (service/daemon.py pulls the snapshot's six fields).  It returns None
# or a dict steering the remaining segments:
#
#   ``segment_fn``  a replacement ``segment_fn(carry, a, b)``, used from
#                   the next segment on (the daemon's live injection
#                   rebuilds it from the merged plan:
#                   ``backends.tpu_hash.segment_runner``)
#   ``stop``        truthy: stop before the next segment (raises
#                   :class:`RunInterrupted` after the writer barrier)
_BOUNDARY_HOOK: Optional[Callable] = None


class boundary_hook:
    """Context manager installing the process-wide boundary hook."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __enter__(self):
        global _BOUNDARY_HOOK
        self._prev = _BOUNDARY_HOOK
        _BOUNDARY_HOOK = self.fn
        return self

    def __exit__(self, *exc):
        global _BOUNDARY_HOOK
        _BOUNDARY_HOOK = self._prev
        return False


def chunked_run(params: Params, seed: int, total: int, *, device,
                init_carry, segment_fn, collect_events: bool,
                telemetry=None, with_series: bool = False, finalize=None,
                event_type=SparseTickEvents):
    """Run ticks ``[0, total)`` in ``CHECKPOINT_EVERY``-tick segments.

    ``init_carry()`` builds the fresh carry on ``device``;
    ``segment_fn(carry, a, b) -> (carry, events, series)`` runs ticks
    ``[a, b)`` (backends/tpu_hash.py ``run_segment``): ``events`` the
    segment's CompactEvents (full mode) or an ``event_type`` of four
    per-tick streams (agg mode: SparseTickEvents of ``[b-a]`` int32
    totals, or the dense step's TickEvents) on the host, ``series`` its telemetry series
    when ``with_series``, flushed to ``telemetry`` (a TimelineRecorder,
    or None) with ``t0 = a``.  The carry's snapshot is copied to the
    host only with ``CHECKPOINT_DIR``; its write overlaps the next
    segment, with a barrier at the following boundary.

    ``finalize(carry, events) -> (carry, events)``, when given, runs once
    after the last segment, also on a resume that finds the run complete
    (``PROBE_IO: approx_lag``'s epilogue); the snapshots stay as they
    were before it, so a resumed run applies it exactly once.

    Returns ``(final_carry, events)`` with the whole run's events, equal
    to the unchunked run's."""
    every = params.CHECKPOINT_EVERY
    if every <= 0:
        raise ValueError("chunked_run requires CHECKPOINT_EVERY > 0")
    ckpt_dir = params.CHECKPOINT_DIR or None
    compress = bool(params.CHECKPOINT_COMPRESS)
    runlog = maybe_runlog(params.TELEMETRY_DIR or None)
    base = _manifest_base(params, seed, total, collect_events)

    carry = init_carry()
    start = 0
    acc = _empty_compact(params.EN_GPSZ) if collect_events else None
    if params.RESUME and ckpt_dir:
        named = named_leaves(carry)
        loaded = _load_for_resume(ckpt_dir, base, leaf_specs(carry),
                                  lambda i: host_leaf(*named[i]))
        if loaded is not None:
            start, leaves, payload = loaded
            carry = carry_from_leaves(carry, leaves, device)
            if collect_events:
                acc = CompactEvents(
                    payload["joins"], payload["removes"],
                    payload["sent"], payload["recv"], start)
            elif start > 0:
                acc = tuple(payload[f"s{i}"] for i in range(4))

    executor = None
    pending = None
    if ckpt_dir:
        executor = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="ckpt-writer")
        host = _HostCopies()

    def _await_writer():
        nonlocal pending
        if pending is not None:
            fut, pending = pending, None
            fut.result()    # a failed write raises here

    crash_at = _crash_tick()
    report_state = _state_reporter(total)
    if report_state is not None:
        report_state(start)
    if runlog is not None:
        runlog.event("segments_start", backend=params.BACKEND,
                     total=int(total), every=int(every),
                     tick_start=int(start), resumed=bool(start > 0),
                     checkpoint_dir=ckpt_dir or "")

    def _apply_hook(tick):
        """Run the boundary hook; take the segment runner it returns.
        -> True when it asks for a stop."""
        nonlocal segment_fn
        if _BOUNDARY_HOOK is None:
            return False
        upd = _BOUNDARY_HOOK(carry, int(tick))
        if not upd:
            return False
        if "segment_fn" in upd:
            segment_fn = upd["segment_fn"]
        return bool(upd.get("stop"))

    # SIGTERM/SIGINT only set a flag, read at the next boundary (signals
    # install from the main thread only).
    stop_signal: list = []
    orig_handlers = {}
    if threading.current_thread() is threading.main_thread():
        def _graceful(signum, frame):
            stop_signal.append(signum)
        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                orig_handlers[s] = signal.signal(s, _graceful)
            except (ValueError, OSError):   # pragma: no cover
                pass

    def _stop_at_boundary(tick, hook_stop):
        if not (stop_signal or hook_stop) or tick >= total:
            return
        _await_writer()     # boundary `tick` is durable before we raise
        if runlog is not None:
            runlog.event("interrupted", tick=int(tick),
                         signal=int(stop_signal[0]) if stop_signal else 0,
                         durable_tick=int(manifest_tick(ckpt_dir) or 0))
        why = (f"signal {stop_signal[0]}" if stop_signal
               else "stop requested")
        raise RunInterrupted(
            f"run stopped at segment boundary {tick} ({why}); last "
            f"durable checkpoint: {manifest_tick(ckpt_dir) or 'none'}",
            tick)

    try:
        # The pre-run hook call: the first snapshot (a resume's restored
        # carry included).
        _stop_at_boundary(start, _apply_hook(start))
        for a in range(start, total, every):
            if crash_at is not None and a >= crash_at:
                _await_writer()
                raise RuntimeError(
                    f"injected crash at tick {a} ({CRASH_ENV}={crash_at}); "
                    f"last durable checkpoint: "
                    f"{manifest_tick(ckpt_dir) or 'none'}")
            b = min(a + every, total)
            t_seg = time.perf_counter()
            carry, ev, series = segment_fn(carry, a, b)
            # The snapshot leaves the device only when it is written.
            host_leaves = host.pull(carry) if ckpt_dir else None
            t_sync = time.perf_counter()
            if with_series and telemetry is not None:
                telemetry.flush(series, a)
            if collect_events:
                acc = concat_compact([acc, ev])
                payload = {"joins": acc.joins, "removes": acc.removes,
                           "sent": acc.sent, "recv": acc.recv}
            else:
                seg = tuple(np.asarray(x) for x in ev)
                acc = (seg if acc is None else
                       tuple(np.concatenate([p, s])
                             for p, s in zip(acc, seg)))
                payload = {f"s{i}": acc[i] for i in range(4)}
            ckpt_wait_s = 0.0
            if ckpt_dir:
                t_wait = time.perf_counter()
                _await_writer()
                ckpt_wait_s = time.perf_counter() - t_wait
                pending = executor.submit(_save_checkpoint, ckpt_dir, base,
                                          b, host_leaves, payload, compress)
            if report_state is not None:
                report_state(b)
            if runlog is not None:
                runlog.event(
                    "segment", t0=int(a), t1=int(b),
                    device_sync_s=round(t_sync - t_seg, 4),
                    flush_s=round(
                        time.perf_counter() - t_sync - ckpt_wait_s, 4),
                    ckpt_wait_s=round(ckpt_wait_s, 4))
            # After the checkpoint hand-off: the hook sees the state the
            # manifest will name, and a runner it returns takes effect
            # from the next segment.
            _stop_at_boundary(b, _apply_hook(b))
        _await_writer()
    finally:
        for s, h in orig_handlers.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):   # pragma: no cover
                pass
        if executor is not None:
            executor.shutdown(wait=True)
    if runlog is not None:
        runlog.event("segments_done", total=int(total),
                     tick_start=int(start))

    if collect_events:
        events = acc
    elif acc is None:        # zero-length run
        return carry, event_type(*(np.zeros((0,), np.int32)
                                   for _ in range(4)))
    else:
        events = event_type(*acc)
    if finalize is not None and total > 0:
        carry, events = finalize(carry, events)
    return carry, events
