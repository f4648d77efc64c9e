"""Shared-memory snapshot ring: publish once, map everywhere
(counterpart of the JAX package's ``service/shm_ring.py``).

One ``multiprocessing.shared_memory`` segment holds a ring of
``SERVICE_SHM_BUFFERS`` slots.  The daemon's snapshot publisher writes
each boundary's snapshot into the next slot; read-replica processes
(service/replica.py) map the segment READ-ONLY and serve queries from
numpy views constructed directly over the slot bytes — the [N,S]
planes and the derived [N] stats are never copied into a replica.

Consistency is a per-slot seqlock: the slot header's ``gen`` stamp is
bumped to an odd value before the writer touches the slot and to the
(even) publication sequence afterwards.  A reader picks the slot with
the highest even gen, reads, and re-validates the gen; a torn read
(writer lapped the ring mid-read) fails validation and the reader
retries on the new newest slot.  The writer never blocks on readers —
with B >= 2 slots a reader holding the previous slot has a full
publication interval to finish before its bytes are rewritten.

Delta writes: the planes of slot ``i`` were last written B
publications ago, so the writer keeps the last B per-publication
dirty-row masks (``Snapshot.dirty_rows``) and rewrites only the union
of rows that changed since — the same row diff the incremental derive
uses.  The derived [N] arrays and the pre-encoded census are always
written whole (staleness ages for everyone every boundary).  Per-slot
byte accounting (full vs actually written) feeds PERF.md.

Engine liveness (status/tick/applied-events) lives in the global
header as single 8-byte fields — aligned 8-byte stores, so replicas
read them without taking any lock.
"""

from __future__ import annotations

import os
import secrets
import struct
from collections import deque
from multiprocessing import resource_tracker, shared_memory
from typing import Optional

try:                            # POSIX only; stdlib shared_memory's own
    import _posixshmem          # unlink primitive, used tracker-free
except ImportError:             # pragma: no cover - non-POSIX fallback
    _posixshmem = None

import numpy as np

MAGIC = b"DMSHMRG1"
CENSUS_CAP = 4096               # pre-encoded census reply, bytes
_GLOBAL_FMT = "<8Q"             # nslots n s tfail total slot_size + dtypes
_ENGINE_FMT = "<3Q"             # status tick applied  (8-byte atomics)
_GLOBAL_SIZE = 4096
_SLOT_FMT = "<8Q"               # gen tick census_len mode dirty bytes r r
_SLOT_HEADER = struct.calcsize(_SLOT_FMT)
_ENGINE_OFF = len(MAGIC) + struct.calcsize(_GLOBAL_FMT) + 16

STATUS_CODES = {"starting": 0, "running": 1, "complete": 2,
                "interrupted": 3}
STATUS_NAMES = {v: k for k, v in STATUS_CODES.items()}

# name -> (dtype, per-member count multiplier is always n)
_DERIVED_FIELDS = (
    ("live", np.bool_), ("removed", np.bool_), ("started", np.bool_),
    ("in_group", np.bool_), ("suspected", np.bool_),
    ("self_hb", np.int64), ("known_by", np.int64),
    ("suspected_by", np.int64), ("best_hb", np.int64),
    ("staleness", np.int64),
)


def _unregister(shm: shared_memory.SharedMemory) -> None:
    """Detach this process's resource_tracker claim: Python 3.10's
    tracker registers EVERY SharedMemory (create and attach alike) and
    unlinks everything it saw at interpreter exit, which for an
    ATTACHED reader would tear the ring down under the writer (the
    3.13 ``track=False`` flag, backported by hand).  Ring teardown is
    ours explicitly — see ``_unlink_quiet``."""
    try:
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


def _unlink_quiet(raw_name: str) -> bool:
    """Remove the segment file WITHOUT touching the resource tracker
    (``SharedMemory.unlink`` unregisters internally, which double-fires
    against ``_unregister`` and misfires when the file is already
    gone).  ``raw_name`` is ``shm._name`` — leading slash included."""
    if _posixshmem is None:
        return False
    try:
        _posixshmem.shm_unlink(raw_name)
        return True
    except FileNotFoundError:
        return False
    except OSError:
        return False


def unlink(name: str) -> bool:
    """Best-effort unlink of a ring segment by name (idempotent)."""
    if _posixshmem is not None:
        return _unlink_quiet("/" + name.lstrip("/"))
    try:
        shm = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return False
    try:
        shm.unlink()
    finally:
        shm.close()
    return True


def stale_segments(prefix: str = "dmring_") -> list:
    """Names of ring segments present under /dev/shm (Linux), for the
    fleet scheduler's orphan sweep."""
    try:
        return sorted(f for f in os.listdir("/dev/shm")
                      if f.startswith(prefix))
    except OSError:
        return []


class _Layout:
    """Byte offsets for one ring geometry, shared by writer/reader."""

    def __init__(self, nslots: int, n: int, s: int,
                 view_dtype, ts_dtype):
        self.nslots, self.n, self.s = nslots, n, s
        self.view_dtype = np.dtype(view_dtype)
        self.ts_dtype = np.dtype(ts_dtype)
        off = _SLOT_HEADER + CENSUS_CAP
        self.derived_offsets = {}
        for fname, dt in _DERIVED_FIELDS:
            self.derived_offsets[fname] = (off, np.dtype(dt))
            off += n * np.dtype(dt).itemsize
        self.view_off = off
        off += n * s * self.view_dtype.itemsize
        self.ts_off = off
        off += n * s * self.ts_dtype.itemsize
        self.slot_size = (off + 63) & ~63       # cache-line pad
        self.total_size = _GLOBAL_SIZE + nslots * self.slot_size
        self.plane_bytes = (n * s * self.view_dtype.itemsize
                            + n * s * self.ts_dtype.itemsize)
        self.derived_bytes = sum(
            n * dt.itemsize for _, dt in self.derived_offsets.values())

    def slot_off(self, i: int) -> int:
        return _GLOBAL_SIZE + i * self.slot_size


def _pack_dtype(dt: np.dtype) -> int:
    code = np.dtype(dt).str.encode().ljust(8, b"\0")
    return int.from_bytes(code, "little")


def _unpack_dtype(q: int) -> np.dtype:
    return np.dtype(q.to_bytes(8, "little").rstrip(b"\0").decode())


class ShmRingWriter:
    """The daemon side: create the segment, publish snapshots."""

    def __init__(self, n: int, s: int, view_dtype, ts_dtype,
                 tfail: int, total: int, nslots: int,
                 name: Optional[str] = None):
        if nslots < 2:
            raise ValueError(f"ring needs >= 2 slots, got {nslots}")
        self.layout = _Layout(nslots, n, s, view_dtype, ts_dtype)
        self.name = name or f"dmring_{os.getpid():x}_{secrets.token_hex(4)}"
        self.shm = shared_memory.SharedMemory(
            create=True, size=self.layout.total_size, name=self.name)
        _unregister(self.shm)   # teardown is close(), not the tracker
        buf = self.shm.buf
        buf[:len(MAGIC)] = MAGIC
        struct.pack_into(
            _GLOBAL_FMT, buf, len(MAGIC), nslots, n, s, int(tfail),
            int(total), self.layout.slot_size,
            _pack_dtype(view_dtype), _pack_dtype(ts_dtype))
        self._seq = 0
        self._dirty_hist: deque = deque(maxlen=nslots)
        self._slot_seq = [None] * nslots    # last publication per slot
        self.stats = {"publishes": 0, "bytes_written": 0,
                      "bytes_full": 0, "rows_written": 0,
                      "rows_full": 0}

    # ---- engine liveness (lock-free 8-byte fields) -------------------
    def set_engine(self, status: str, tick: int, applied: int) -> None:
        struct.pack_into(_ENGINE_FMT, self.shm.buf, _ENGINE_OFF,
                         STATUS_CODES.get(status, 0), int(tick),
                         int(applied))

    # ---- publication -------------------------------------------------
    def publish(self, snap, prev=None) -> dict:
        """Write ``snap`` (derived + census precomputed) into the next
        slot; ``prev`` is the previously PUBLISHED snapshot, used for
        the per-publication dirty mask.  Returns per-publish stats."""
        lay = self.layout
        self._seq += 1
        seq = self._seq
        slot = (seq - 1) % lay.nslots
        base = lay.slot_off(slot)
        buf = self.shm.buf

        n, s = lay.n, lay.s
        if prev is not None and prev._view.shape == snap._view.shape:
            dirty = snap.dirty_rows(prev)
        else:
            dirty = np.ones(n, bool)
        self._dirty_hist.append(dirty)

        # Rows whose bytes in THIS slot are stale: union of the dirty
        # masks since the slot last held a snapshot (B publications
        # ago); full rewrite when the history doesn't reach back.
        last = self._slot_seq[slot]
        if last is None or seq - last > len(self._dirty_hist):
            rows = np.ones(n, bool)
        else:
            rows = np.zeros(n, bool)
            for mask in list(self._dirty_hist)[-(seq - last):]:
                rows |= mask
        ridx = np.flatnonzero(rows)

        census = snap.census_json()
        if len(census) > CENSUS_CAP:
            raise ValueError(f"census reply {len(census)}B exceeds "
                             f"shm slot cap {CENSUS_CAP}B")

        # Seqlock: odd while mutating, publication sequence when done.
        struct.pack_into("<Q", buf, base, 2 * seq - 1)
        off = base + _SLOT_HEADER
        buf[off:off + len(census)] = census
        written = len(census)
        for fname, (foff, dt) in lay.derived_offsets.items():
            arr = np.ascontiguousarray(
                getattr(snap, fname), dtype=dt)
            raw = arr.tobytes()
            buf[base + foff:base + foff + len(raw)] = raw
            written += len(raw)
        view_np = np.ndarray((n, s), dtype=lay.view_dtype,
                             buffer=buf, offset=base + lay.view_off)
        ts_np = np.ndarray((n, s), dtype=lay.ts_dtype,
                           buffer=buf, offset=base + lay.ts_off)
        if len(ridx) == n:
            view_np[:] = snap._view
            ts_np[:] = snap._view_ts
        elif len(ridx):
            view_np[ridx] = snap._view[ridx]
            ts_np[ridx] = snap._view_ts[ridx]
        row_bytes = (len(ridx) * s * (lay.view_dtype.itemsize
                                      + lay.ts_dtype.itemsize))
        written += row_bytes
        struct.pack_into(
            _SLOT_FMT, buf, base, 2 * seq, int(snap.tick), len(census),
            1 if (snap.derive_info or {}).get("mode") == "delta" else 0,
            int(dirty.sum()), written, 0, 0)
        self._slot_seq[slot] = seq
        st = self.stats
        st["publishes"] += 1
        st["bytes_written"] += written
        st["bytes_full"] += (lay.plane_bytes + lay.derived_bytes
                             + len(census))
        st["rows_written"] += int(len(ridx))
        st["rows_full"] += n
        return {"slot": slot, "seq": seq, "rows": int(len(ridx)),
                "bytes": written}

    def close(self, do_unlink: bool = True) -> None:
        raw = self.shm._name
        try:
            self.shm.close()
        finally:
            if do_unlink:
                _unlink_quiet(raw)


class SlotView:
    """A gen-validated view over one ring slot.  The numpy arrays are
    views STRAIGHT OVER the shared buffer (zero-copy); ``valid()``
    re-reads the gen stamp — call it after consuming whatever you
    read and retry on a newer slot if the writer lapped you."""

    def __init__(self, reader: "ShmRingReader", slot: int, gen: int,
                 tick: int, census: bytes):
        self._reader = reader
        self._slot = slot
        self.gen = gen
        self.tick = tick
        self.census = census
        lay = reader.layout
        base = lay.slot_off(slot)
        buf = reader.shm.buf
        self.arrays = {}
        for fname, (foff, dt) in lay.derived_offsets.items():
            self.arrays[fname] = np.ndarray(
                (lay.n,), dtype=dt, buffer=buf, offset=base + foff)
        self.view = np.ndarray((lay.n, lay.s), dtype=lay.view_dtype,
                               buffer=buf, offset=base + lay.view_off)
        self.view_ts = np.ndarray((lay.n, lay.s), dtype=lay.ts_dtype,
                                  buffer=buf, offset=base + lay.ts_off)

    def valid(self) -> bool:
        return self._reader.slot_gen(self._slot) == self.gen


class ShmRingReader:
    """The replica side: attach read-only, hand out validated slots."""

    def __init__(self, name: str):
        self.shm = shared_memory.SharedMemory(name=name)
        _unregister(self.shm)
        buf = self.shm.buf
        if bytes(buf[:len(MAGIC)]) != MAGIC:
            raise ValueError(f"shm segment {name!r} is not a snapshot "
                             "ring")
        (nslots, n, s, tfail, total, slot_size, vq,
         tq) = struct.unpack_from(_GLOBAL_FMT, buf, len(MAGIC))
        self.layout = _Layout(nslots, n, s, _unpack_dtype(vq),
                              _unpack_dtype(tq))
        assert self.layout.slot_size == slot_size, "layout mismatch"
        self.n, self.s, self.tfail, self.total = n, s, tfail, total

    def engine(self) -> dict:
        code, tick, applied = struct.unpack_from(
            _ENGINE_FMT, self.shm.buf, _ENGINE_OFF)
        return {"status": STATUS_NAMES.get(code, "starting"),
                "tick": int(tick), "applied_events": int(applied)}

    def slot_gen(self, i: int) -> int:
        return struct.unpack_from("<Q", self.shm.buf,
                                  self.layout.slot_off(i))[0]

    def newest_gen(self) -> int:
        """Highest stable gen across the ring (0 before the first
        publication) — the cheap per-query freshness probe: a cached
        slot at this gen is current, anything lower has been lapped by
        a newer publication in ANOTHER slot (still valid, but stale)."""
        return max((g for i in range(self.layout.nslots)
                    if (g := self.slot_gen(i)) and g % 2 == 0),
                   default=0)

    def latest(self, tries: int = 8) -> Optional[SlotView]:
        """The newest stable slot, seqlock-validated; None before the
        first publication (or if the writer outpaces every retry —
        callers treat that as "no snapshot yet")."""
        lay = self.layout
        for _ in range(tries):
            gens = [self.slot_gen(i) for i in range(lay.nslots)]
            stable = [(g, i) for i, g in enumerate(gens)
                      if g and g % 2 == 0]
            if not stable:
                return None
            gen, slot = max(stable)
            base = lay.slot_off(slot)
            hdr = struct.unpack_from(_SLOT_FMT, self.shm.buf, base)
            census = bytes(
                self.shm.buf[base + _SLOT_HEADER:
                             base + _SLOT_HEADER + hdr[2]])
            view = SlotView(self, slot, gen, hdr[1], census)
            if self.slot_gen(slot) == gen:
                return view
        return None

    def unlink(self) -> bool:
        """Reader-side teardown for orphaned rings (parent daemon died
        without cleaning up).  Idempotent across the pool; attached
        sibling mappings survive the unlink."""
        return _unlink_quiet(self.shm._name)

    def close(self) -> None:
        self.shm.close()
