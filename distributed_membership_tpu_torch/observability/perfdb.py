"""Perf ledger: one append-only JSONL bank of the port's throughput
numbers (the JAX package's ``observability/perfdb.py``).

Rows share one shape, keyed by

    (rung, n, s, backend, platform, knobs_digest)

where ``knobs_digest`` is a stable hash of the remaining run-identity
knobs (mode, exchange, timing, mesh, ...), so rows are comparable iff
they measured the same configuration.  A record of the port's scale smoke
(``python -m distributed_membership_tpu_torch.scale_smoke``, banked in
``artifacts/SCALE_SMOKE_TORCH.json``) carries the card it ran on, and its
row puts the card's name in ``knobs``: rows of two cards never share a
key, so :func:`check` never compares them.  Rows append to
``artifacts/perf_ledger_torch.jsonl``, never to the JAX package's
``artifacts/perf_ledger.jsonl``; ingestion is idempotent (a row identical
up to ingestion timestamp is skipped), writes are single-line appends
(the reader skips damaged lines).

The ``rows_from_*`` parsers read the JAX package's banked artifacts
(``BENCH_r*.json``, ``MULTICHIP_r*.json``, ``artifacts/TPU_PROFILE.json``,
``artifacts/SCALE_SMOKE.json``) into the same rows as its perfdb does;
:func:`collect_all` ingests only the port's own records.

:func:`check` is the regression tripwire ``python -m
distributed_membership_tpu_torch.perf_ledger --check`` calls: within each
key group it compares every row against the best earlier row and flags
drops beyond a noise band (default :data:`DEFAULT_NOISE_BAND`).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from typing import Dict, Iterable, List, Optional

LEDGER_PATH = os.path.join("artifacts", "perf_ledger_torch.jsonl")
SCALE_SMOKE_PATH = os.path.join("artifacts", "SCALE_SMOKE_TORCH.json")

# Fractional drop vs the best banked row for the same key before a row
# counts as a regression.  Higher-is-better metrics only (throughput);
# lower-is-better metrics are stored with ``higher_is_better: False``.
DEFAULT_NOISE_BAND = 0.30

# Row fields that define identity for idempotent re-ingestion (the
# ingestion timestamp deliberately excluded).
_IDENTITY_FIELDS = ("key", "metric", "value", "source", "timestamp")


def knobs_digest(knobs: Optional[dict]) -> str:
    blob = json.dumps(knobs or {}, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def make_row(rung: str, *, metric: str, value: float,
             n: Optional[int] = None, s: Optional[int] = None,
             backend: Optional[str] = None, platform: Optional[str] = None,
             knobs: Optional[dict] = None, source: Optional[str] = None,
             timestamp: Optional[str] = None,
             higher_is_better: bool = True) -> dict:
    knobs = dict(knobs or {})
    # Multi-tick-residency rows key per BLOCK SIZE: a truthy
    # knobs["mega_ticks"] lifts T into the rung itself (rung:t{T}), so
    # --check trends T=8 and T=32 separately — the knobs digest alone
    # would also separate them, but only the rung is human-readable in
    # the regression report, and a T=8 trend must never mask a T=32
    # regression behind an opaque digest.
    if knobs.get("mega_ticks"):
        rung = f"{rung}:t{int(knobs['mega_ticks'])}"
    # Multi-process rows key per PROCESS TOPOLOGY the same way: a truthy
    # knobs["procs"] lifts the process count into the rung (rung:p{P}),
    # so a single-process trend never masks a pod-run regression (the
    # cross-process collective legs dominate at P > 1 and the two
    # operating points move independently).
    if knobs.get("procs"):
        rung = f"{rung}:p{int(knobs['procs'])}"
    # Query-tier rows key per POOL WIDTH too: a truthy
    # knobs["service_workers"] lifts W into the rung (rung:w{W}) — the
    # engine-serves-queries point (W=0) and the replica-pool points
    # scale differently (one GIL vs W processes) and must trend
    # separately in the regression report.
    if knobs.get("service_workers"):
        rung = f"{rung}:w{int(knobs['service_workers'])}"
    # Elastic-resume rows key per RESUME KIND: a truthy
    # knobs["reshard"] lifts the reshard arm into the rung
    # (rung:reshard) — a same-shape resume trend must never mask a
    # reshard-path regression (the host-side redistribute + codec
    # round-trip exist only on that arm).
    if knobs.get("reshard"):
        rung = f"{rung}:reshard"
    digest = knobs_digest(knobs)
    key = "|".join([rung, str(n), str(s), str(backend), str(platform),
                    metric, digest])
    return {
        "key": key, "rung": rung, "n": n, "s": s, "backend": backend,
        "platform": platform, "knobs": knobs, "knobs_digest": digest,
        "metric": metric, "value": float(value),
        "higher_is_better": bool(higher_is_better),
        "source": source, "timestamp": timestamp,
        "ingested_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def load_ledger(path: str = LEDGER_PATH) -> List[dict]:
    """All ledger rows, oldest first; torn/non-JSON lines skipped."""
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and "key" in rec and "value" in rec:
                rows.append(rec)
    return rows


def append_rows(rows: Iterable[dict], path: str = LEDGER_PATH) -> int:
    """Append rows not already banked (identity up to ingestion time);
    returns how many were actually written."""
    existing = {tuple(r.get(f) for f in _IDENTITY_FIELDS)
                for r in load_ledger(path)}
    fresh = [r for r in rows
             if tuple(r.get(f) for f in _IDENTITY_FIELDS) not in existing]
    if fresh:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a") as fh:
            for r in fresh:
                fh.write(json.dumps(r, sort_keys=True) + "\n")
    return len(fresh)


def check(rows: List[dict],
          band: float = DEFAULT_NOISE_BAND) -> List[dict]:
    """Regressions: rows whose value dropped more than ``band`` below the
    best earlier row of the same key (or rose above it, for
    lower-is-better metrics).  Returns one record per offending row."""
    best: Dict[str, dict] = {}
    out = []
    for row in rows:
        key = row["key"]
        prior = best.get(key)
        if prior is not None:
            hib = row.get("higher_is_better", True)
            ref = prior["value"]
            val = row["value"]
            if ref > 0:
                drop = (ref - val) / ref if hib else (val - ref) / ref
                if drop > band:
                    out.append({
                        "key": key, "rung": row.get("rung"),
                        "metric": row.get("metric"),
                        "best": ref, "value": val,
                        "drop_pct": round(drop * 100, 1),
                        "band_pct": round(band * 100, 1),
                        "source": row.get("source"),
                    })
        if (prior is None
                or (row["value"] > prior["value"]) == row.get(
                    "higher_is_better", True)):
            best[key] = row
    return out


# ---------------------------------------------------------------------------
# Collectors: one per producer artifact family.

_BENCH_NS_RE = re.compile(r"N=(\d+)(?:, S=(\d+))?")
_BENCH_BACKEND_RE = re.compile(r"\((\w+) N=")
_MULTICHIP_RE = re.compile(r"mesh=(\d+) nodes=(\d+)")


def rows_from_bench(doc: dict, source: str) -> List[dict]:
    """BENCH_r*.json: headline parsed metric + the dense/live_cpu/
    hash_alt/hist side legs bench.py banks alongside it."""
    rows: List[dict] = []
    if doc.get("rc") not in (0, None):
        return rows
    parsed = doc.get("parsed")
    if not isinstance(parsed, dict):
        return rows
    metric_str = str(parsed.get("metric", ""))
    m = _BENCH_NS_RE.search(metric_str)
    n = int(m.group(1)) if m else None
    s = int(m.group(2)) if m and m.group(2) else None
    bk = _BENCH_BACKEND_RE.search(metric_str)
    if parsed.get("value") is not None:
        rows.append(make_row(
            "bench:headline", metric="node_ticks_per_sec",
            value=parsed["value"], n=n, s=s,
            backend=bk.group(1) if bk else None,
            platform=parsed.get("platform"),
            knobs={"timing": parsed.get("timing"),
                   "mode": parsed.get("mode"),
                   "unit": parsed.get("unit")},
            source=source))
    for leg in ("dense", "live_cpu", "hash_alt", "hist"):
        sub = parsed.get(leg)
        if not isinstance(sub, dict):
            continue
        if sub.get("node_ticks_per_sec") is None:
            continue
        rows.append(make_row(
            f"bench:{leg}", metric="node_ticks_per_sec",
            value=sub["node_ticks_per_sec"],
            n=sub.get("n"), s=sub.get("view_size"),
            backend=sub.get("leg") if leg == "dense" else "tpu_hash",
            platform=sub.get("platform", "cpu"),
            knobs={k: sub.get(k) for k in ("ticks", "exchange", "mode")
                   if sub.get(k) is not None},
            source=source))
    return rows


def rows_from_multichip(doc: dict, source: str) -> List[dict]:
    if doc.get("skipped"):
        return []
    m = _MULTICHIP_RE.search(str(doc.get("tail", "")))
    return [make_row(
        "multichip:dryrun", metric="ok",
        value=1.0 if doc.get("ok") else 0.0,
        n=int(m.group(2)) if m else None,
        platform="multichip",
        knobs={"mesh": int(m.group(1)) if m else None},
        source=source)]


def rows_from_tpu_profile(records: List[dict], source: str) -> List[dict]:
    rows = []
    for rec in records:
        if not isinstance(rec, dict):
            continue
        if rec.get("node_ticks_per_sec") is None:
            continue
        rows.append(make_row(
            f"ladder:{rec.get('rung')}", metric="node_ticks_per_sec",
            value=rec["node_ticks_per_sec"],
            n=rec.get("n"), s=rec.get("s"),
            backend=rec.get("backend"), platform=rec.get("platform"),
            knobs={k: rec.get(k) for k in ("timing", "mode", "exchange")
                   if rec.get(k) is not None},
            source=source, timestamp=rec.get("timestamp")))
    return rows


def rows_from_scale_smoke(records: List[dict], source: str) -> List[dict]:
    """Scale-smoke records, the JAX package's and the port's: a port
    record's ``device`` (the card's name and power limit) puts the card's
    name in ``knobs``."""
    rows = []
    for rec in records:
        if not isinstance(rec, dict):
            continue
        if rec.get("node_ticks_per_sec") is None:
            continue
        knobs = {k: rec.get(k) for k in
                 ("mesh_size", "ticks", "probes", "fanout")
                 if rec.get(k) is not None}
        if isinstance(rec.get("device"), dict):
            knobs["device"] = rec["device"].get("name")
        rows.append(make_row(
            f"scale_smoke:{rec.get('n')}_s{rec.get('view_size')}",
            metric="node_ticks_per_sec",
            value=rec["node_ticks_per_sec"],
            n=rec.get("n"), s=rec.get("view_size"),
            backend=rec.get("backend"), platform=rec.get("platform"),
            knobs=knobs, source=source, timestamp=rec.get("timestamp")))
    return rows


def collect_all(root: str = ".") -> List[dict]:
    """Every row of the port's banked records under ``root``: the scale
    smoke's ``artifacts/SCALE_SMOKE_TORCH.json``."""
    try:
        with open(os.path.join(root, SCALE_SMOKE_PATH)) as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return []
    if not isinstance(doc, list):
        return []
    return rows_from_scale_smoke(doc, SCALE_SMOKE_PATH)
