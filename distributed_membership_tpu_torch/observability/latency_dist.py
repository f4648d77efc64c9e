"""Detection-latency SLO, trimmed from the JAX package's
``observability/latency_dist.py``: what the scenario oracle's
``detection_slo`` invariant reads (scenario/oracle.py).

The hist telemetry tier records ``h_latency``, a per-tick ``[64]``
one-hot of ``t - fail_time`` scaled by that tick's true detections, so
its sum over ticks is the detection-latency distribution.  The SLO
compares it with the banked reference by the Kolmogorov statistic (the
largest gap between the two normalized CDFs) and passes within
:data:`SLO_MAX_DEVIATION`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

# Banked reference distribution: latency tick -> removal count.
# Measured on testcases/singlefailure.conf (N=10, fail @ t=100) with
# BACKEND tpu_hash / EXCHANGE ring / seed 3 — byte-identical between the
# eventlog parse (metrics.removal_latencies) and the h_latency
# reconstruction (tests/test_latency_dist.py pins the exact match), and
# inside the C++ reference's measured window (BASELINE.md: removals @
# t=121-123, latencies 21-23).
REFERENCE_DISTRIBUTION: Dict[int, int] = {21: 4, 22: 4, 23: 1}

# BASELINE.md north-star: "detection-latency distribution within 5% of
# the C++ EmulNet reference".
SLO_MAX_DEVIATION = 0.05


def latency_counts(series) -> np.ndarray:
    """Total removals per unit latency bucket, ``[64]`` i64.

    ``series`` is either the dict :func:`..timeline.read_timeline`
    returns (uses its ``h_latency`` field) or a ``[K, 64]`` array."""
    if isinstance(series, Mapping):
        series = series["h_latency"]
    arr = np.asarray(series, dtype=np.int64)
    if arr.ndim == 1:
        return arr
    return arr.sum(axis=0)


def counts_from_mapping(dist: Mapping[int, int],
                        nbins: Optional[int] = None) -> np.ndarray:
    """A ``{latency: count}`` mapping as a dense bucket vector."""
    hi = max(dist) if dist else 0
    n = nbins if nbins is not None else hi + 1
    out = np.zeros((max(n, hi + 1),), dtype=np.int64)
    for k, v in dist.items():
        out[int(k)] += int(v)
    return out


def max_cdf_deviation(a, b) -> float:
    """Kolmogorov statistic between two bucket-count vectors: the max
    absolute difference of their normalized CDFs (0.0 when either side
    is empty — "no data" is reported separately, not as deviation)."""
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    n = max(len(a), len(b))
    a = np.pad(a, (0, n - len(a)))
    b = np.pad(b, (0, n - len(b)))
    if a.sum() == 0 or b.sum() == 0:
        return 0.0
    return float(np.abs(np.cumsum(a / a.sum()) -
                        np.cumsum(b / b.sum())).max())


def slo_verdict(series,
                reference: Optional[Mapping[int, int]] = None,
                threshold: float = SLO_MAX_DEVIATION) -> dict:
    """The SLO report record: observed distribution, reference, the
    Kolmogorov deviation, and the pass/fail verdict.

    ``passed`` is None (verdict withheld, not failed) when the run saw
    zero detections — an all-zero histogram carries no distribution to
    compare, and failing it would turn every failure-free run red."""
    ref = dict(REFERENCE_DISTRIBUTION if reference is None else reference)
    counts = latency_counts(series)
    observed = {int(k): int(v) for k, v in enumerate(counts) if v}
    total = int(counts.sum())
    dev = max_cdf_deviation(counts, counts_from_mapping(ref, len(counts)))
    return {
        "slo": "detection_latency_distribution",
        "threshold": float(threshold),
        "max_cdf_deviation": dev,
        "detections_total": total,
        "observed": observed,
        "reference": {int(k): int(v) for k, v in sorted(ref.items())},
        "passed": None if total == 0 else bool(dev <= threshold),
    }
