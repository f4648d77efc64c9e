"""Host snapshots: the O(1)-queryable membership view (counterpart of
the JAX package's ``service/snapshot.py``).  The planes come in the JAX
dtypes: ``view`` uint32 (the port keeps int32 bits on the device, which
as int32 would decode every entry >= 2^31 to a negative member and
heartbeat) and ``view_ts`` int32.

At a publishing boundary the daemon's hook copies six carry fields off
the device (service/daemon.py ``SnapshotStaging``, then
``pull_snapshot`` on the publisher thread); the O(N*VIEW_SIZE)
view-derived statistics (who knows whom, freshest heartbeat, staleness)
never run on the engine thread: the daemon's snapshot publisher derives
them off-thread at publish time, and a snapshot nobody publishes against
still falls back to the lazy first-query derive.

Two derivation paths, one result:

  * :meth:`Snapshot._derive` — the full double-``np.sort`` pass over
    all N*S packed view entries (the grouped max/min without
    ``np.maximum.at``'s unbuffered per-element loop, several times
    slower than the sort).  This is the FALLBACK and the byte-identity
    ORACLE.
  * :meth:`Snapshot.derive_incremental` — the delta path: diff the
    ``view``/``view_ts`` planes against the previous boundary's
    snapshot, re-derive only the members touched by changed rows
    (subset sort), and advance everyone else arithmetically
    (``staleness += dt``; ``suspected_by`` += the entries whose age
    crossed TFAIL inside the boundary window — a vectorized window
    count, no sort).  Between quiet boundaries the dirty-row count is
    O(heartbeat fanout), not O(N), so the delta derive is far cheaper
    than the full one -- and it is byte-identical to the oracle
    (tests/test_torch_query_tier.py pins every stat at every boundary of
    the grading scenarios).  When every row changes between boundaries
    (a large run whose heartbeats move everywhere) the delta derive
    costs as much as the full one.

Publication is double-buffered by immutability: a :class:`Snapshot`'s
arrays are never mutated after derivation and :class:`SnapshotStore`
swaps the reference — readers that grabbed the old snapshot keep a
consistent view while the engine publishes the next one; no locks on
the query path (the derive lock is per-snapshot and taken at most for
one computation).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

import numpy as np

# numpy holds the GIL through most of a bincount: over the 2^27 view
# entries of a 1M S=128 snapshot that stalls the engine's launches and
# every query thread for tenths of a second at a time.  Counted in
# slices of this many entries, the GIL changes hands between slices.
_BINCOUNT_SLICE = 1 << 21


def _bincount(x: np.ndarray, minlength: int) -> np.ndarray:
    """``np.bincount(x, minlength=minlength)``, slice by slice."""
    parts = [np.bincount(x[i:i + _BINCOUNT_SLICE], minlength=minlength)
             for i in range(0, max(x.size, 1), _BINCOUNT_SLICE)]
    out = np.zeros(max(p.size for p in parts), parts[0].dtype)
    for p in parts:
        out[:p.size] += p
    return out


class Snapshot:
    """One membership view over host arrays.  All [N] numpy.

    Eager fields (engine-thread cheap): ``live`` (started & in_group &
    ~failed), ``removed`` (down: crashed or left), ``started``,
    ``in_group``, ``self_hb``.  Derived on first access (see
    :meth:`_derive`): ``known_by``/``suspected_by`` (live observers
    holding / suspecting an entry), ``best_hb`` (freshest heartbeat any
    live observer has seen, -1 = known by nobody), ``staleness`` (min
    over live observers of tick - view_ts, -1 = unknown), ``suspected``
    (live members some observer's entry has aged past TFAIL — the
    protocol's suspicion precondition, surfaced before the removal
    lands).
    """

    def __init__(self, tick: int, n: int, tfail: int, *, started,
                 in_group, failed, self_hb, view, view_ts):
        self.tick = int(tick)
        self.n = int(n)
        self.tfail = int(tfail)
        self.started = np.asarray(started).astype(bool)
        self.in_group = np.asarray(in_group).astype(bool)
        failed = np.asarray(failed).astype(bool)
        self.live = self.started & self.in_group & ~failed
        self.removed = self.started & failed
        self.self_hb = np.asarray(self_hb).astype(np.int64)
        self._view = np.asarray(view)
        self._view_ts = np.asarray(view_ts)
        self.decoded_at = time.time()
        self._lock = threading.Lock()
        self._derived = False
        self._census: Optional[dict] = None
        self._census_body: Optional[bytes] = None
        # How this snapshot's stats were computed: None until derived,
        # then {"mode": "full"|"delta", "ms": float, ...} — the PERF.md
        # derive-cost accounting and the identity tests read this.
        self.derive_info: Optional[dict] = None

    def _unpack_members(self, view):
        """Per-entry member ids from a packed [N,S] view plane.  Empty
        cells (v = 0) decode to SOME id in [0, n); callers must mask
        with their own ``present`` before trusting the values."""
        v = view.astype(np.int64) - 1
        n = self.n
        if n & (n - 1) == 0:
            return v >> n.bit_length() - 1, v & (n - 1)
        return np.divmod(v, n)

    def _derive(self) -> None:
        """The O(N*S) view statistics, once, on whichever thread asks
        first.  Unpacking mirrors ``tpu_hash.unpack``: a view cell
        holds ``member + n*heartbeat + 1`` (0 = empty), so ``member =
        (v-1) % n`` and ``hb = (v-1) // n`` — int64 math so 1M-node
        heartbeats never wrap the unpack arithmetic.

        Grouped max/min via two radix ``np.sort``s of packed uint64
        (member, value) keys: the group tail/head IS the per-member
        max/min.  No ``ufunc.at`` (unbuffered per-element loop) and no
        ``argsort`` + index gathers, both slower; empty cells go to a
        sentinel bucket ``n`` instead of a mask-compress pass."""
        if self._derived:
            return
        with self._lock:
            if self._derived:
                return
            t_start = time.perf_counter()
            n = self.n
            v = self._view.astype(np.int64) - 1          # -1 = empty
            present = (v >= 0) & self.live[:, None]
            hb, member = self._unpack_members(self._view)
            member = np.where(present, member, n).ravel()
            # Empty cells carry hb = -1 (from v = -1); zero them so the
            # uint64 pack can't smear sign bits into the member field.
            hb = np.where(present, hb, 0).ravel()
            stale = (self.tick
                     - self._view_ts.astype(np.int64)).ravel()

            counts = _bincount(member, minlength=n + 1)
            known_by = counts[:n].astype(np.int64)
            best_hb = np.full(n, -1, np.int64)
            staleness = np.full(n, -1, np.int64)

            key = np.sort((member.astype(np.uint64) << np.uint64(32))
                          | hb.astype(np.uint64))
            m = (key >> np.uint64(32)).astype(np.int64)
            ends = np.flatnonzero(np.r_[m[1:] != m[:-1], True])
            uniq = m[ends]
            keep = uniq < n
            best_hb[uniq[keep]] = (
                key[ends] & np.uint64(0xFFFFFFFF)).astype(
                    np.int64)[keep]

            # Staleness fits 41 bits (TOTAL_TIME is int32-bounded);
            # sentinel 1<<40 keeps empty cells out of the group min.
            sr = np.where(present.ravel(), stale, 1 << 40)
            key = np.sort((member.astype(np.uint64) << np.uint64(41))
                          | sr.astype(np.uint64))
            m = (key >> np.uint64(41)).astype(np.int64)
            starts = np.flatnonzero(np.r_[True, m[1:] != m[:-1]])
            uniq = m[starts]
            keep = uniq < n
            staleness[uniq[keep]] = (
                key[starts] & np.uint64((1 << 41) - 1)).astype(
                    np.int64)[keep]

            sus = np.where(present.ravel() & (stale >= self.tfail),
                           member, n)
            suspected_by = _bincount(
                sus, minlength=n + 1)[:n].astype(np.int64)
            self.known_by = known_by
            self.best_hb = best_hb
            self.staleness = staleness
            self.suspected_by = suspected_by
            self.suspected = self.live & (suspected_by > 0)
            self.derive_info = {
                "mode": "full",
                "ms": round((time.perf_counter() - t_start) * 1e3, 3),
            }
            self._derived = True

    def dirty_rows(self, prev: "Snapshot") -> np.ndarray:
        """Boolean [N]: observer rows whose CONTRIBUTION changed since
        ``prev`` — liveness flipped, or content changed while live.  A
        row that is down in both snapshots contributes to neither, so
        content churn there is invisible to every derived stat (and to
        the shm delta writer, which publishes the same row set)."""
        row_changed = ((self._view != prev._view).any(axis=1)
                       | (self._view_ts != prev._view_ts).any(axis=1))
        return ((self.live != prev.live)
                | (self.live & prev.live & row_changed))

    def derive_incremental(self, prev: Optional["Snapshot"]) -> bool:
        """Derive the view statistics as a DELTA against a fully
        derived predecessor; byte-identical to :meth:`_derive`.
        Returns False (nothing computed — caller falls back to the
        full derive) when ``prev`` is unusable: missing, not yet
        derived, a different world shape, or from a later tick.

        Exactness argument, per member m:
          * m untouched by any dirty row: every entry mentioning m
            lives in a clean row (identical packed cell, observer live
            in both) — ``known_by``/``best_hb`` depend only on those
            cells, so they carry over; ``staleness`` is
            ``tick - max(view_ts)`` over the same cells, so it
            advances by exactly ``dt``; ``suspected_by`` gains exactly
            the entries whose ``view_ts`` fell inside the window
            ``(t0 - TFAIL, t1 - TFAIL]`` (integer threshold crossing).
          * m mentioned by a dirty row (old or new side): ``known_by``
            and ``suspected_by`` update by exact entry-count deltas,
            and ``best_hb``/``staleness`` are recomputed from scratch
            over ALL of m's present entries (subset sort — the same
            packed-key group tail/head as the full path).
        """
        if self._derived:
            return True
        if (prev is None or not prev._derived or prev.n != self.n
                or prev.tfail != self.tfail or self.tick < prev.tick
                or self._view.shape != prev._view.shape):
            return False
        with self._lock:
            if self._derived:
                return True
            t_start = time.perf_counter()
            n, tfail = self.n, self.tfail
            t0, t1 = prev.tick, self.tick
            dt = t1 - t0
            dirty = self.dirty_rows(prev)
            d = np.flatnonzero(dirty)

            v1 = self._view.astype(np.int64) - 1
            present1 = (v1 >= 0) & self.live[:, None]
            hb1, mem1 = self._unpack_members(self._view)
            ts1 = self._view_ts.astype(np.int64)

            # Old/new contributing entries of the dirty rows only.
            v0d = prev._view[d].astype(np.int64) - 1
            p0d = (v0d >= 0) & prev.live[d, None]
            _, m0d = self._unpack_members(prev._view[d])
            ts0d = prev._view_ts[d].astype(np.int64)
            p1d, m1d, ts1d = present1[d], mem1[d], ts1[d]

            # Affected members: anyone a dirty row mentioned, before
            # or after.  Their sorted stats are recomputed exactly.
            a_mask = np.zeros(n, bool)
            a_mask[m0d[p0d]] = True
            a_mask[m1d[p1d]] = True

            # known_by: exact entry-count delta (dirty rows only).
            known_by = prev.known_by.copy()
            known_by -= _bincount(m0d[p0d], minlength=n)[:n]
            known_by += _bincount(m1d[p1d], minlength=n)[:n]

            # suspected_by: dirty-row delta + the clean-row entries
            # whose age crossed TFAIL inside (t0, t1] — a vectorized
            # window count, no sort.
            suspected_by = prev.suspected_by.copy()
            suspected_by -= _bincount(
                m0d[p0d & (t0 - ts0d >= tfail)], minlength=n)[:n]
            suspected_by += _bincount(
                m1d[p1d & (t1 - ts1d >= tfail)], minlength=n)[:n]
            clean_live = self.live & ~dirty
            win = (present1 & clean_live[:, None]
                   & (ts1 > t0 - tfail) & (ts1 <= t1 - tfail))
            suspected_by += _bincount(mem1[win], minlength=n)[:n]

            # best_hb carries over; staleness ages uniformly (-1 =
            # unknown stays -1).  Affected members are then re-derived
            # from scratch over all their present entries.
            best_hb = prev.best_hb.copy()
            staleness = np.where(prev.staleness >= 0,
                                 prev.staleness + dt, prev.staleness)
            aff = np.flatnonzero(a_mask)
            if len(aff):
                best_hb[aff] = -1
                staleness[aff] = -1
                asel = present1 & a_mask[mem1]
                am = mem1[asel]
                if len(am):
                    ah, ats = hb1[asel], ts1[asel]
                    key = np.sort(
                        (am.astype(np.uint64) << np.uint64(32))
                        | ah.astype(np.uint64))
                    m = (key >> np.uint64(32)).astype(np.int64)
                    ends = np.flatnonzero(np.r_[m[1:] != m[:-1], True])
                    best_hb[m[ends]] = (
                        key[ends] & np.uint64(0xFFFFFFFF)).astype(
                            np.int64)
                    key = np.sort(
                        (am.astype(np.uint64) << np.uint64(41))
                        | (t1 - ats).astype(np.uint64))
                    m = (key >> np.uint64(41)).astype(np.int64)
                    starts = np.flatnonzero(np.r_[True,
                                                  m[1:] != m[:-1]])
                    staleness[m[starts]] = (
                        key[starts] & np.uint64((1 << 41) - 1)).astype(
                            np.int64)
            self.known_by = known_by
            self.best_hb = best_hb
            self.staleness = staleness
            self.suspected_by = suspected_by
            self.suspected = self.live & (suspected_by > 0)
            self.derive_info = {
                "mode": "delta",
                "ms": round((time.perf_counter() - t_start) * 1e3, 3),
                "dirty_rows": int(len(d)),
                "affected_members": int(len(aff)),
                "dt": int(dt),
            }
            self._derived = True
        return True

    def precompute(self, prev: Optional["Snapshot"] = None) -> None:
        """Publish-time derivation (the daemon's snapshot publisher
        calls this OFF the engine thread): delta-derive against the
        previous published snapshot when possible, full derive
        otherwise, then pre-encode the census reply — so no query
        ever triggers a derive."""
        if not self.derive_incremental(prev):
            self._derive()
        self.census_json()

    def census(self) -> dict:
        if self._census is None:
            self._derive()
            self._census = {
                "tick": self.tick,
                "n": self.n,
                "live": int(self.live.sum()),
                "suspected": int(self.suspected.sum()),
                "removed": int(self.removed.sum()),
                "unstarted": int((~self.started).sum()),
                "known_members": int((self.known_by > 0).sum()),
                "view_entries": int(self.known_by.sum()),
                "max_staleness": int(self.staleness.max(initial=-1)),
            }
        return self._census

    def census_json(self) -> bytes:
        """The census reply pre-encoded: the hammering-dashboards hot
        path pays the JSON encode once per snapshot, not per query."""
        if self._census_body is None:
            self._census_body = (json.dumps(self.census())
                                 + "\n").encode()
        return self._census_body

    def member(self, i: int) -> dict:
        self._derive()
        return {
            "id": int(i),
            "tick": self.tick,
            "live": bool(self.live[i]),
            "suspected": bool(self.suspected[i]),
            "removed": bool(self.removed[i]),
            "started": bool(self.started[i]),
            "in_group": bool(self.in_group[i]),
            "self_hb": int(self.self_hb[i]),
            "known_by": int(self.known_by[i]),
            "suspected_by": int(self.suspected_by[i]),
            "best_heartbeat": int(self.best_hb[i]),
            "staleness": int(self.staleness[i]),
        }


def decode_state(carry, tick: int, n: int, tfail: int) -> Snapshot:
    """Wrap a host carry as a :class:`Snapshot` (numpy only, lazy).

    Works on any carry exposing the hash twins' field names
    (``view``/``view_ts`` packed membership, ``started``/``in_group``/
    ``failed``/``self_hb``): both :class:`~backends.tpu_hash.HashState`
    and the sharded twin qualify (``np.asarray`` on a sharded leaf
    yields the assembled global array).
    """
    return Snapshot(tick, n, tfail,
                    started=carry.started, in_group=carry.in_group,
                    failed=carry.failed, self_hb=carry.self_hb,
                    view=carry.view, view_ts=carry.view_ts)


class SnapshotStore:
    """Reference-swap publication of immutable snapshots.

    ``publish`` rebinds one attribute (atomic under the GIL);
    ``get`` hands back whatever snapshot is current.  Readers never
    block the engine and never see a half-written view.
    """

    def __init__(self):
        self._snap: Optional[Snapshot] = None

    def publish(self, snap: Snapshot) -> None:
        self._snap = snap

    def get(self) -> Optional[Snapshot]:
        return self._snap
