"""Typed in-process metrics registry with a Prometheus-text encoder
(counterpart of the JAX package's ``observability/metricsbus.py``; the
rendered text is the same bytes for the same instrument sequence).

The metrics plane's one shared vocabulary: every running surface (the
engine daemon, each read replica, the fleet controller) builds a
:class:`MetricsRegistry`, registers counters/gauges/histograms once,
and serves ``registry.render()`` from ``GET /metrics`` (wired through
``service/api.route_get`` so all three surfaces share one route).

Design constraints, in order:

  * **Zero new dependencies** — the text exposition format
    (``# HELP`` / ``# TYPE`` + ``name{label="v"} value`` lines) is
    trivial to emit from the stdlib, and any Prometheus-compatible
    scraper parses it.  No client library is vendored or imported.
  * **Cheap on the hot path** — ``Counter.inc`` / ``Gauge.set`` are a
    dict store under one registry lock; no allocation beyond the label
    key tuple.  Nothing here ever runs on the engine thread: the
    instruments are updated by the API handler threads and the
    watchdog thread, so the tick loop launches what it launched
    without the service.
  * **Deterministic text** — families render in registration order and
    label sets in sorted order, so the golden-format test
    (tests/test_torch_metrics_plane.py) can pin the shape without fuzzing.

``parse_text`` is the strict inverse used by the golden test and by
the fleet daemon's scrape-union path; ``relabel`` rewrites sample
lines to inject the fleet's ``run_id``/``proc``/``replica`` labels
without re-parsing values.  :class:`LatencyReservoir` is the sampled
sliding-window p50/p99 estimator shared by the engine daemon's query
tier and the replicas, so both report latency the same way.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")


def _fmt(v: float) -> str:
    """Prometheus sample value: integers without the trailing .0 (so
    counters read naturally), floats via repr (round-trip exact)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _unescape(v: str) -> str:
    return (v.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def _label_str(labels: Sequence[Tuple[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
    return "{" + inner + "}"


class _Instrument:
    """One metric family: a name, a help line, and per-label-set
    values.  The label key is the sorted (k, v) tuple so ``inc(a=1,
    b=2)`` and ``inc(b=2, a=1)`` hit the same series."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 lock: threading.Lock):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help_text
        self._lock = lock
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    @staticmethod
    def _key(labels: dict) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def render_into(self, out: List[str],
                    const: Sequence[Tuple[str, str]]) -> None:
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.kind}")
        for key in sorted(self._values):
            out.append(f"{self.name}{_label_str(tuple(const) + key)} "
                       f"{_fmt(self._values[key])}")


class Counter(_Instrument):
    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def set_total(self, value: float, **labels) -> None:
        """For counters mirrored from an external monotonic source
        (e.g. ControlState.queries): store the absolute total."""
        with self._lock:
            self._values[self._key(labels)] = value


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = value

    def clear(self) -> None:
        """Drop every series (fleet scrape gauges are rebuilt whole
        each pass; stale workers must not linger)."""
        with self._lock:
            self._values.clear()


class Histogram(_Instrument):
    """Cumulative-bucket histogram (native Prometheus shape).

    ``observe`` bins into the first bucket whose upper bound holds the
    value; render emits the cumulative ``_bucket{le=...}`` ladder plus
    ``_sum``/``_count``, one ladder per label set.
    """

    kind = "histogram"

    def __init__(self, name, help_text, lock,
                 buckets: Sequence[float]):
        super().__init__(name, help_text, lock)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs >= 1 bucket bound")
        self._counts: Dict[Tuple[Tuple[str, str], ...], List] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            rec = self._counts.get(key)
            if rec is None:
                rec = self._counts[key] = [
                    [0] * (len(self.buckets) + 1), 0.0, 0]
            counts, _, _ = rec
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            rec[1] += value
            rec[2] += 1

    def render_into(self, out, const) -> None:
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.kind}")
        for key in sorted(self._counts):
            counts, total, n = self._counts[key]
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += counts[i]
                lbl = _label_str(tuple(const) + key
                                 + (("le", _fmt(b)),))
                out.append(f"{self.name}_bucket{lbl} {cum}")
            lbl = _label_str(tuple(const) + key + (("le", "+Inf"),))
            out.append(f"{self.name}_bucket{lbl} {n}")
            base = _label_str(tuple(const) + key)
            out.append(f"{self.name}_sum{base} {_fmt(total)}")
            out.append(f"{self.name}_count{base} {n}")


class MetricsRegistry:
    """Registration-ordered family set with shared const labels.

    ``constlabels`` (e.g. ``{"proc": "0"}`` under multi-process,
    ``{"replica": "2"}`` on a replica) are stamped onto every sample
    line at render time — instruments never need to know them.
    """

    def __init__(self, constlabels: Optional[dict] = None):
        self._lock = threading.Lock()
        self._families: List[_Instrument] = []
        self._names: Dict[str, _Instrument] = {}
        self.constlabels = tuple(sorted(
            (k, str(v)) for k, v in (constlabels or {}).items()))

    def _add(self, inst: _Instrument) -> _Instrument:
        prior = self._names.get(inst.name)
        if prior is not None:
            if type(prior) is not type(inst):
                raise ValueError(
                    f"metric {inst.name!r} re-registered as a "
                    f"different type")
            return prior
        self._families.append(inst)
        self._names[inst.name] = inst
        return inst

    def counter(self, name: str, help_text: str) -> Counter:
        return self._add(Counter(name, help_text, self._lock))

    def gauge(self, name: str, help_text: str) -> Gauge:
        return self._add(Gauge(name, help_text, self._lock))

    def histogram(self, name: str, help_text: str,
                  buckets: Sequence[float]) -> Histogram:
        return self._add(Histogram(name, help_text, self._lock,
                                   buckets))

    def render(self) -> str:
        out: List[str] = []
        with self._lock:
            for fam in self._families:
                fam.render_into(out, self.constlabels)
        return "\n".join(out) + "\n" if out else ""


def parse_text(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str],
                                                   ...]], float]:
    """Strict exposition-format parser → {(name, labels): value}.

    The golden test's oracle and the fleet union's reader.  Raises
    ValueError on any malformed sample line (comments and blanks are
    skipped) — strictness is the point: the encoder above must produce
    text this accepts, which is exactly what an external scraper
    needs.
    """
    out: Dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed sample line {line!r}")
        name, labelstr, value = m.groups()
        labels = _parse_labels(labelstr) if labelstr else ()
        try:
            val = float(value)
        except ValueError as e:
            raise ValueError(
                f"malformed value in {line!r}") from e
        out[(name, labels)] = val
    return out


def _parse_labels(s: str) -> Tuple[Tuple[str, str], ...]:
    """``a="x",b="y\\"z"`` → sorted ((a, x), (b, y"z)).  A tiny state
    machine rather than a regex: label values may contain escaped
    quotes and commas."""
    labels = []
    i, n = 0, len(s)
    while i < n:
        j = s.index("=", i)
        key = s[i:j].strip()
        if not _NAME_RE.match(key):
            raise ValueError(f"malformed label name {key!r}")
        if j + 1 >= n or s[j + 1] != '"':
            raise ValueError(f"unquoted label value after {key!r}")
        k = j + 2
        buf = []
        while k < n:
            c = s[k]
            if c == "\\" and k + 1 < n:
                buf.append(s[k:k + 2])
                k += 2
                continue
            if c == '"':
                break
            buf.append(c)
            k += 1
        else:
            raise ValueError(f"unterminated label value for {key!r}")
        labels.append((key, _unescape("".join(buf))))
        i = k + 1
        if i < n:
            if s[i] != ",":
                raise ValueError(f"junk after label {key!r}: "
                                 f"{s[i:]!r}")
            i += 1
    return tuple(sorted(labels))


def relabel(text: str, extra: dict) -> str:
    """Inject ``extra`` labels into every sample line of ``text``.

    The fleet daemon's union step: a worker's own exposition comes
    back verbatim, gains ``run_id="..."`` (and keeps whatever
    ``proc``/``replica`` labels the worker stamped), and is
    concatenated into the fleet reply.  Existing keys are NOT
    overridden — the surface closest to the data wins.
    """
    add = tuple(sorted((k, str(v)) for k, v in extra.items()))
    out = []
    for line in text.splitlines():
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            out.append(line)
            continue
        m = _SAMPLE_RE.match(stripped)
        if m is None:
            continue                 # drop malformed, keep the rest
        name, labelstr, value = m.groups()
        have = dict(_parse_labels(labelstr)) if labelstr else {}
        for k, v in add:
            have.setdefault(k, v)
        merged = tuple(sorted(have.items()))
        out.append(f"{name}{_label_str(merged)} {value}")
    return "\n".join(out) + "\n" if out else ""


class LatencyReservoir:
    """Sampled sliding-window latency estimator (p50/p99).

    Hoisted from service/replica.py so the engine daemon and the
    replicas report query latency identically: every ``sample_every``-th
    request is timed, the last ``window`` samples are kept, and the
    percentiles read from the sorted window.  ``should_sample`` is a
    modulo on the caller's own request counter so the reservoir needs
    no counter of its own.
    """

    SAMPLE_EVERY = 16
    WINDOW = 512

    def __init__(self, sample_every: int = SAMPLE_EVERY,
                 window: int = WINDOW):
        self.sample_every = sample_every
        self.window = window
        self._lock = threading.Lock()
        self._ms: List[float] = []

    def should_sample(self, request_index: int) -> bool:
        return request_index % self.sample_every == 0

    def record(self, ms: float) -> None:
        with self._lock:
            self._ms.append(ms)
            if len(self._ms) > self.window:
                del self._ms[:len(self._ms) - self.window]

    def percentiles(self) -> dict:
        with self._lock:
            lat = sorted(self._ms)
        if not lat:
            return {"p50_ms": None, "p99_ms": None}
        return {
            "p50_ms": round(lat[len(lat) // 2], 4),
            "p99_ms": round(lat[min(len(lat) - 1,
                                    int(len(lat) * 0.99))], 4),
        }


class ScrapeRate:
    """q/s between scrapes: remembers (t, count) at the last render
    and reports the delta rate, the same shape the replica beacons
    use for their 1 Hz qps field."""

    def __init__(self):
        self._lock = threading.Lock()
        self._t = time.monotonic()
        self._count = 0

    def rate(self, count: int) -> float:
        now = time.monotonic()
        with self._lock:
            dt = now - self._t
            dq = count - self._count
            self._t, self._count = now, count
        return round(dq / dt, 1) if dt > 0 else 0.0
