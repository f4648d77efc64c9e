"""The flight recorder (the JAX package's ``observability/timeline.py``):
per-tick telemetry of the ring steps (``TELEMETRY: scalars|hist``) and the
names of the protocol-phase scopes.

With ``TELEMETRY: scalars`` every ring step (natural, folded, sharded and
sharded folded) emits a :class:`TickTelemetry` of int32 scalar reductions
per tick over tensors the step already holds; it draws no random number
and touches no state, so the trajectory is that of a telemetry-off run.
``TELEMETRY: hist`` adds a :class:`TickHist` of fixed-bucket int32
histograms.  A step packs one tick's values into one int32 vector on the
device (:func:`pack_tick`); the tick loop stacks them once at the end of
the run and copies them to the host in one transfer
(:func:`unpack_series`), then :class:`TimelineRecorder` banks the series
and appends it to ``<TELEMETRY_DIR>/timeline.jsonl``.

Field semantics (int32 per tick): ``live`` active nodes; ``suspected``
view entries past TFAIL; ``joins`` admissions into empty slots;
``removals`` TREMOVE evictions; ``detections`` true detections (the
aggregate's delta, 0 in full event mode); ``msgs_sent`` / ``msgs_recv``
wire messages sent / delivered into the receive stream (``PROBE_IO
approx_lag``'s final-tick ack-send epilogue applies to run totals only,
not this series); ``dropped`` messages killed by drop coins (budget drops
under ENFORCE_BUFFSIZE are not counted here); ``probe_acks`` acks
applied; ``gossip_rows`` view
entries carried by gossip payloads.  Histograms (edges in
``HIST_BUCKETS``): ``h_staleness`` ``t - view_ts`` of present entries in
8 buckets of 8 ticks; ``h_suspicion`` the age past TFAIL, the same
buckets; ``h_latency`` ``t - fail_time`` at each detection, 64 unit
buckets; ``h_occupancy`` the view size of live nodes, 16 unit buckets;
``h_drops`` the tick's drop count on a log2 scale (bucket 0 = none,
bucket k = [2^(k-1), 2^k)).  The last bucket of each is the overflow.

``timeline.jsonl`` holds one JSON line per flushed segment, ``{"t0",
"ticks", <field>: [K ints] or [K][B] ints}``, positionally shared with
the JAX package; the readers skip a torn trailing line and keep the last
record per ``t0``.

The ``PHASE_*`` names label the protocol phases of the four ring steps as
``torch.profiler.record_function`` ranges, so a profile splits a tick's
device time by phase; :func:`scan_trace_for_phases` says which of them a
captured trace holds (``python -m distributed_membership_tpu_torch.
profile_step --trace-dir``).
"""

from __future__ import annotations

import gzip
import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

# The protocol-phase names (``dm_`` makes them greppable in a profile).
PHASE_RECEIVE = "dm_receive_sweep"      # admit + ack-merge + self + sweep
PHASE_ACK = "dm_ack_apply"              # ack-candidate gather pipeline
PHASE_GOSSIP = "dm_gossip_exchange"     # circulant shift delivery
PHASE_COLLECTIVE = "dm_exchange_collective"  # sharded block hop
PHASE_PROBE = "dm_probe_issue"          # probe window issue + counters
PHASE_AGG = "dm_aggregates"             # on-device event aggregation
PHASE_TELEMETRY = "dm_telemetry"        # the telemetry reductions

# The subset present in every ring step with probes.
PHASE_NAMES = (PHASE_RECEIVE, PHASE_ACK, PHASE_GOSSIP, PHASE_PROBE,
               PHASE_AGG)


class TickTelemetry(NamedTuple):
    """One tick's scalars (module docstring); a series holds ``[K]``
    arrays per field."""
    live: object
    suspected: object
    joins: object
    removals: object
    detections: object
    msgs_sent: object
    msgs_recv: object
    dropped: object
    probe_acks: object
    gossip_rows: object


class TickHist(NamedTuple):
    """One tick's histograms, ``[B]`` each; a series holds ``[K, B]``."""
    h_staleness: object
    h_suspicion: object
    h_latency: object
    h_occupancy: object
    h_drops: object


TELEMETRY_FIELDS = TickTelemetry._fields
HIST_FIELDS = TickHist._fields
TIMELINE_NAME = "timeline.jsonl"

# The bucket geometry is part of the timeline.jsonl schema (consumers
# read bucket counts by position).
HIST_BUCKETS = {"h_staleness": 8, "h_suspicion": 8, "h_latency": 64,
                "h_occupancy": 16, "h_drops": 16}
STALENESS_BUCKET_TICKS = 8
LATENCY_BUCKETS = HIST_BUCKETS["h_latency"]
I32 = torch.int32


# ---------------------------------------------------------------------------
# Histogram builders (integer reductions on the device; no random number)

def hist_bucket_counts(vals, mask, nbins: int, width: int):
    """``[nbins]`` int32 counts of ``vals`` under ``mask``: bucket ``b``
    counts masked elements with ``vals // width == b``, clipped into ``[0,
    nbins - 1]``.  Any shape; a fold is a reshape, so folded planes count
    as the natural ones."""
    ids = torch.div(vals, width, rounding_mode="floor") if width > 1 else vals
    ids = ids.clamp(0, nbins - 1).reshape(-1).to(torch.int64)
    out = torch.zeros((nbins,), dtype=I32, device=vals.device)
    return out.index_add_(0, ids, mask.reshape(-1).to(I32))


def scalar_one_hot(idx: int, nbins: int, count):
    """``[nbins]`` int32 with ``count`` (a device scalar) at ``clip(idx, 0,
    nbins - 1)`` (``idx`` a host int): every detection of a tick shares
    its latency ``t - fail_time``."""
    where = min(max(idx, 0), nbins - 1)
    hot = torch.arange(nbins, device=count.device) == where
    return hot.to(I32) * count.to(I32)


def drops_hist(dropped, nbins: int = HIST_BUCKETS["h_drops"]):
    """``[nbins]`` int32 log2 one-hot of the tick's drop count (a device
    scalar): bucket 0 = none, bucket k = ``[2^(k-1), 2^k)``."""
    # The edges are made on the device: a host list would be copied in,
    # and that copy waits for the device every tick.
    edges = 1 << torch.arange(nbins - 1, dtype=I32, device=dropped.device)
    idx = (dropped >= edges).sum(dtype=I32)
    return (torch.arange(nbins, device=dropped.device) == idx).to(I32)


def row_hists(*, difft, present, size, act, tfail: int, stale=None,
              susp=None) -> tuple:
    """The row-summed histograms of a tick, ``(h_staleness, h_suspicion,
    h_occupancy)``: sums over rows, so a mesh's processes add theirs.
    ``stale``/``susp`` are the ``[8]`` bucket counts the probe kernels
    emit as partials, which stand in for the two plane passes."""
    if stale is None:
        stale = hist_bucket_counts(difft, present,
                                   HIST_BUCKETS["h_staleness"],
                                   STALENESS_BUCKET_TICKS)
    if susp is None:
        susp = hist_bucket_counts(difft - tfail, present & (difft >= tfail),
                                  HIST_BUCKETS["h_suspicion"],
                                  STALENESS_BUCKET_TICKS)
    return stale, susp, hist_bucket_counts(size, act,
                                           HIST_BUCKETS["h_occupancy"], 1)


def build_tick_hist(*, difft, present, size, act, t: int, fail_time: int,
                    tfail: int, det_tick, dropped, stale=None,
                    susp=None, occupancy=None) -> TickHist:
    """The TickHist of every ring step: ``difft``/``present`` the
    post-receive staleness planes (natural or folded; all shards of a
    mesh), ``size``/``act`` the per-node occupancy and liveness,
    ``det_tick`` and ``dropped`` the tick's (global) detection and drop
    counts; ``stale``/``susp``/``occupancy`` the row histograms where
    the caller has them (:func:`row_hists`)."""
    if occupancy is None:
        stale, susp, occupancy = row_hists(
            difft=difft, present=present, size=size, act=act, tfail=tfail,
            stale=stale, susp=susp)
    return TickHist(
        h_staleness=stale, h_suspicion=susp,
        h_latency=scalar_one_hot(t - fail_time, LATENCY_BUCKETS, det_tick),
        h_occupancy=occupancy,
        h_drops=drops_hist(dropped))


def pack_tick(telem: TickTelemetry, hist: Optional[TickHist] = None):
    """One tick's values as one int32 vector on the device: the ten
    scalars, then the histograms' buckets in field order."""
    parts = [torch.stack([v.to(I32) for v in telem])]
    if hist is not None:
        parts += [h.to(I32) for h in hist]
    return torch.cat(parts)


def unpack_series(series: np.ndarray, hist: bool):
    """``[K, W]`` stacked :func:`pack_tick` rows back to a TickTelemetry of
    ``[K]`` arrays, or with ``hist`` a ``(TickTelemetry, TickHist)`` pair
    whose histograms are ``[K, B]`` (the form
    :meth:`TimelineRecorder.flush` takes)."""
    nf = len(TELEMETRY_FIELDS)
    telem = TickTelemetry(*(series[:, i] for i in range(nf)))
    if not hist:
        return telem
    at, cols = nf, []
    for f in HIST_FIELDS:
        cols.append(series[:, at:at + HIST_BUCKETS[f]])
        at += HIST_BUCKETS[f]
    return telem, TickHist(*cols)


# ---------------------------------------------------------------------------
# The recorder and its readers (numpy)

class TimelineRecorder:
    """Banks per-segment telemetry series and, given a directory, appends
    them to ``<dir>/timeline.jsonl``: one JSON line per flushed segment,
    ``{"t0": <first tick>, "ticks": K, "<field>": [K ints], ...}``."""

    def __init__(self, directory: Optional[str] = None):
        self.path = None
        if directory:
            os.makedirs(directory, exist_ok=True)
            self.path = os.path.join(directory, TIMELINE_NAME)
        self._chunks: list = []      # [(t0, {field: np.ndarray[K]})]

    def flush(self, telem, t0: int) -> None:
        """Bank one segment starting at tick ``t0``: a TickTelemetry of
        ``[K]`` series, or a ``(TickTelemetry, TickHist)`` pair whose
        histograms are ``[K, B]`` (nested ``[K][B]`` lists in the line)."""
        hist = None
        if type(telem) is tuple:
            telem, hist = telem
        rec = {f: np.asarray(getattr(telem, f)).astype(np.int64).reshape(-1)
               for f in TELEMETRY_FIELDS}
        if hist is not None:
            k = len(rec["live"])
            rec.update({f: np.asarray(getattr(hist, f))
                        .astype(np.int64).reshape(k, -1)
                        for f in HIST_FIELDS})
        self._chunks.append((int(t0), rec))
        if self.path:
            line = {"t0": int(t0), "ticks": int(len(rec["live"]))}
            line.update({f: rec[f].tolist() for f in rec})
            with open(self.path, "a") as fh:
                fh.write(json.dumps(line) + "\n")

    def series(self) -> dict:
        """The merged per-tick series (dict of arrays plus ``t0``,
        ``ticks`` and ``detections_cum``), read back from the file when
        one is written."""
        if self.path and os.path.exists(self.path):
            return read_timeline(self.path)
        return _merge_chunks(self._chunks)


def _merge_chunks(chunks) -> dict:
    dedup = {}
    for t0, rec in chunks:          # a later flush of a t0 wins
        dedup[t0] = rec
    if not dedup:
        out = {f: np.zeros((0,), np.int64) for f in TELEMETRY_FIELDS}
        out.update(t0=0, ticks=0, detections_cum=np.zeros((0,), np.int64))
        return out
    t0s = sorted(dedup)
    # A field merges only when every chunk carries it (hist fields are
    # only on hist records).
    fields = set(dedup[t0s[0]])
    for t in t0s[1:]:
        fields &= set(dedup[t])
    out = {f: np.concatenate([dedup[t][f] for t in t0s]) for f in fields}
    out["t0"] = t0s[0]
    out["ticks"] = int(sum(len(dedup[t]["live"]) for t in t0s))
    out["detections_cum"] = np.cumsum(out["detections"])
    return out


def read_timeline(path: str) -> dict:
    """Parse ``timeline.jsonl`` into the merged series; a torn trailing
    line is skipped and the last record per ``t0`` wins."""
    chunks = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue            # torn trailing write
            chunks.append((int(rec["t0"]),
                           {f: np.asarray(rec[f], np.int64)
                            for f in TELEMETRY_FIELDS + HIST_FIELDS
                            if f in rec}))
    return _merge_chunks(chunks)


def timeline_summary(series: dict) -> dict:
    """Totals, extremes and first/last detection tick of a series (and,
    for the hist tier, its cross-check totals)."""
    if not series or series.get("ticks", 0) == 0:
        return {"ticks": 0}
    det = series["detections"]
    det_ticks = np.nonzero(det)[0]
    hist_extra = {}
    if "h_latency" in series:
        # The latency histogram's mass equals the detections series.
        hist_extra = {
            "hist": True,
            "latency_hist_detections": int(series["h_latency"].sum()),
            "occupancy_mean": (
                round(float((series["h_occupancy"]
                             * np.arange(series["h_occupancy"].shape[1])
                             ).sum())
                      / max(int(series["h_occupancy"].sum()), 1), 2)),
            "staleness_overflow_total": int(
                series["h_staleness"][:, -1].sum()),
        }
    return {
        **hist_extra,
        "ticks": int(series["ticks"]),
        "t0": int(series["t0"]),
        "joins_total": int(series["joins"].sum()),
        "removals_total": int(series["removals"].sum()),
        "detections_total": int(det.sum()),
        "msgs_sent_total": int(series["msgs_sent"].sum()),
        "msgs_recv_total": int(series["msgs_recv"].sum()),
        "dropped_total": int(series["dropped"].sum()),
        "probe_acks_total": int(series["probe_acks"].sum()),
        "gossip_rows_total": int(series["gossip_rows"].sum()),
        "live_min": int(series["live"].min()),
        "live_max": int(series["live"].max()),
        "suspected_peak": int(series["suspected"].max()),
        "first_detection_tick": (int(series["t0"] + det_ticks[0])
                                 if det_ticks.size else None),
        "last_detection_tick": (int(series["t0"] + det_ticks[-1])
                                if det_ticks.size else None),
    }


def scan_trace_for_phases(trace_dir: str, names=PHASE_NAMES) -> list:
    """Which phase names appear in a captured profiler trace, sorted: a
    byte scan of every file under ``trace_dir``, gzip-aware (a
    ``torch.profiler`` chrome trace names each ``record_function`` range
    verbatim)."""
    want = {n: n.encode() for n in names}
    found = set()
    for root, _, files in os.walk(trace_dir):
        for fname in files:
            path = os.path.join(root, fname)
            try:
                with open(path, "rb") as fh:
                    blob = fh.read()
            except OSError:
                continue
            if fname.endswith(".gz"):
                try:
                    blob = gzip.decompress(blob)
                except OSError:
                    pass
            found.update(name for name, pat in want.items() if pat in blob)
    return sorted(found)
