"""Cross-process telemetry merge: K per-process timeline shards ->
one global series, with a consistency cross-check (the JAX package's
``observability/merge.py``, on the port's ``observability/timeline.py``).

A multi-process run (``python -m
distributed_membership_tpu_torch.multiproc_launch``) gives every process
its own artifact dir, so process i appends its own
``p{i}/timeline.jsonl``.  Those shards are NOT per-process partials:
every per-tick value a process flushes is already the GLOBAL quantity
-- the steps reduce each tick's record over the processes before it
leaves the device (backends/tpu_hash.py ``tick_telemetry``), so all K
shards describe the same global run.  The merge therefore must never
re-sum across shards (that would overcount every series K times); it
VERIFIES the shards against each other record-by-record and takes the
union:

  * within a shard, duplicate ``t0`` records keep the last write
    (kill/resume re-flushes a segment -- same rule as
    :func:`~distributed_membership_tpu_torch.observability.timeline.
    read_timeline`);
  * across shards, a ``t0`` present in several shards must carry
    bit-identical field lists; any disagreement is a hard
    :class:`MergeError` naming the shard pair, field and first
    diverging tick -- a disagreeing shard means the run itself diverged,
    and silently picking one shard would bury exactly the bug the
    cross-check exists to catch;
  * the union covers tick ranges only some shards flushed (a process
    killed after its peers' boundary flush) -- the merged file is the
    most complete honest view of the run.

The merged records serialize back into the SAME ``timeline.jsonl``
schema, so every consumer (read_timeline, run_report, the SLO verdict)
works on a merged file unchanged, and a merged K-process timeline
parses into a series bit-identical to the one-process twin's.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from distributed_membership_tpu_torch.observability.timeline import (
    HIST_FIELDS, TELEMETRY_FIELDS, TIMELINE_NAME, _merge_chunks)

_SHARD_DIR_RE = re.compile(r"p(\d+)")


class MergeError(ValueError):
    """Two shards disagree on an overlapping segment — the run itself
    diverged across processes; there is no honest merged series."""


def _read_records(path: str) -> Dict[int, dict]:
    """Raw per-``t0`` records of one shard, last write per ``t0``
    winning (torn trailing lines skipped, like read_timeline)."""
    dedup: Dict[int, dict] = {}
    try:
        with open(path) as fh:
            lines = fh.readlines()
    except OSError:
        return dedup
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue                    # torn trailing write
        if isinstance(rec, dict) and "t0" in rec:
            dedup[int(rec["t0"])] = rec
    return dedup


def _check_equal(a: dict, b: dict, t0: int, la: str, lb: str) -> None:
    """Field-by-field bitwise comparison of two shards' records for
    the same segment; raises :class:`MergeError` on the first
    divergence (field + tick index within the segment)."""
    fields = sorted((set(a) | set(b)) - {"t0"})
    for f in fields:
        va, vb = a.get(f), b.get(f)
        if va == vb:
            continue
        detail = ""
        if isinstance(va, list) and isinstance(vb, list):
            k = next((i for i in range(min(len(va), len(vb)))
                      if va[i] != vb[i]), min(len(va), len(vb)))
            detail = f" (first divergence at tick {t0 + k})"
        raise MergeError(
            f"shards {la!r} and {lb!r} disagree on segment t0={t0}, "
            f"field {f!r}{detail} — the per-process runs diverged; "
            "refusing to merge")


def merge_paths(paths: List[Tuple[str, str]]) -> Dict[int, dict]:
    """Verify + union (label, timeline path) shards ->
    ``{t0: record}``.  Raises :class:`MergeError` on any overlapping
    disagreement."""
    merged: Dict[int, dict] = {}
    source: Dict[int, str] = {}
    for label, path in paths:
        for t0, rec in _read_records(path).items():
            if t0 in merged:
                _check_equal(merged[t0], rec, t0, source[t0], label)
            else:
                merged[t0] = rec
                source[t0] = label
    return merged


def shard_dirs(root: str) -> List[Tuple[str, str]]:
    """The ``p{i}`` shard dirs under a multiproc out-root, ordered by
    process id -> [(label, timeline path)] for those with a
    timeline."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        m = _SHARD_DIR_RE.fullmatch(name)
        if m is None:
            continue
        path = os.path.join(root, name, TIMELINE_NAME)
        if os.path.exists(path):
            out.append((int(m.group(1)), name, path))
    return [(name, path) for _, name, path in sorted(out)]


def merged_series(records: Dict[int, dict]) -> dict:
    """The concatenated per-tick series of merged records — the same
    dict shape :func:`~observability.timeline.read_timeline` returns,
    via the same chunk merger (so ``detections_cum`` etc. match)."""
    chunks = [(t0, {f: np.asarray(rec[f], np.int64)
                    for f in TELEMETRY_FIELDS + HIST_FIELDS
                    if f in rec})
              for t0, rec in records.items()]
    return _merge_chunks(chunks)


def write_merged(records: Dict[int, dict], out_path: str) -> None:
    """Serialize merged records back into the timeline.jsonl schema,
    atomically (tmp + rename: a crashed merge never leaves a torn
    global file next to intact shards)."""
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        for t0 in sorted(records):
            fh.write(json.dumps(records[t0]) + "\n")
    os.replace(tmp, out_path)


def merge_run(root: str, out_name: str = TIMELINE_NAME,
              write: bool = True) -> Optional[dict]:
    """Merge every ``<root>/p{i}/timeline.jsonl`` shard into
    ``<root>/<out_name>`` -> an info dict, or None when there are no
    shards.  The consistency cross-check is load-bearing: MergeError
    propagates."""
    shards = shard_dirs(root)
    if not shards:
        return None
    records = merge_paths(shards)
    series = merged_series(records)
    if write:
        write_merged(records, os.path.join(root, out_name))
    return {"shards": [label for label, _ in shards],
            "segments": len(records),
            "ticks": int(series.get("ticks", 0)),
            "t0": int(series.get("t0", 0)),
            "path": os.path.join(root, out_name) if write else None}
