"""Seeded schedule fuzzer: campaign spec -> random-but-valid scenarios
(a copy of the JAX package's ``chaos/fuzz.py``: the same spec gives the
same bytes and digests in both packages).

Design constraints, in order:

1. **Deterministic.**  Schedule ``i`` of a campaign is a pure function
   of ``(spec, i)`` — ``random.Random(f"chaos:{seed}:{i}")``, nothing
   else.  Same spec, same index, byte-identical JSON
   (:func:`dump_schedule` is the canonical encoding the digests pin).

2. **One ScenarioStatic per campaign.**  The JAX package's jitted
   runner caches on ``ScenarioStatic`` — tensor shapes, i.e. per-kind
   event counts — and the port's steps take the same hook sites.  The
   fuzzer therefore fixes the per-kind counts ONCE per campaign
   (largest-remainder apportionment of ``spec.events`` over the mix
   weights, :func:`kind_counts`) and randomizes only times, node
   ranges, and probabilities.

3. **Green on a healthy protocol.**  Schedules are random but not
   adversarial to the ORACLE: every generated schedule leaves
   ``settle_ticks`` of quiet tail (so excused false removals heal and
   permanent failures finish removing), and windows that would trip
   ``no_false_removals`` WITHOUT qualifying for one of its
   schedule-derived excuses are bounded away from the tripwire — mild
   flakes stay under the ``heavy_loss`` probability threshold, hard
   one-way blackholes and long delay windows are stretched PAST the
   excuse thresholds (>= TFAIL ticks) so the oracle knows the schedule
   masked liveness.  A violation on an unmodified protocol is therefore
   a real bug, not fuzzer noise.

Churn storms (clustered crash/restart pairs on disjoint ranges) and
flapping nodes (repeated crash/restart cycles on ONE range) are
composed from the existing crash/restart primitives — no new event
kinds, just time-sequenced reuse of a range.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import random
from typing import Mapping, Optional, Tuple

# Default event-mix weights (relative; zero drops a kind entirely).
DEFAULT_MIX: Mapping[str, float] = {
    "crash": 2.0,
    "restart": 1.5,
    "leave": 0.5,
    "partition": 1.0,
    "link_flake": 1.0,
    "drop_window": 0.5,
    "one_way_flake": 1.0,
    "delay_window": 1.0,
}

# Mild loss stays strictly under oracle._masking_excuses' heavy_loss
# probability threshold (0.5): no excuse needed, none granted.
_MILD_PROBS = (0.05, 0.1, 0.15, 0.2, 0.25, 0.3)


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """Everything that defines a campaign; the digest pins it."""
    seed: int = 0
    schedules: int = 64
    n: int = 10
    total: int = 160          # tick budget per run
    tfail: int = 8
    tremove: int = 20
    events: int = 6           # events per schedule (pre-apportionment)
    mix: Optional[Mapping[str, float]] = None   # None -> DEFAULT_MIX
    name: str = "chaos"

    def weights(self) -> Mapping[str, float]:
        return DEFAULT_MIX if self.mix is None else self.mix

    def settle_ticks(self) -> int:
        """Quiet tail after the last event: long enough for a removal
        to complete (TFAIL + TREMOVE) and for excused false removals to
        heal by re-admission."""
        return max(2 * self.tremove, 3 * self.tfail)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mix"] = {k: float(v) for k, v in sorted(self.weights().items())}
        return d


def _canonical(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def campaign_digest(spec: CampaignSpec) -> str:
    return hashlib.sha256(
        _canonical(spec.to_dict()).encode()).hexdigest()[:16]


def schedule_digest(schedule: dict) -> str:
    return hashlib.sha256(
        dump_schedule(schedule).encode()).hexdigest()[:16]


def dump_schedule(schedule: dict) -> str:
    """The canonical byte encoding (digest + byte-stability contract)."""
    return json.dumps(schedule, sort_keys=True, indent=1) + "\n"


def kind_counts(spec: CampaignSpec) -> Mapping[str, int]:
    """Largest-remainder apportionment of ``spec.events`` over the mix.

    Deterministic, and the SAME for every schedule in the campaign —
    this is what keeps ``ScenarioStatic`` constant (fuzzer contract #2).
    Restarts never outnumber crashes (each restart re-raises a crashed
    range); the excess is reassigned to ``crash``.
    """
    weights = {k: float(v) for k, v in spec.weights().items() if v > 0}
    if not weights:
        raise ValueError("campaign mix has no positive weights")
    wsum = sum(weights.values())
    quota = {k: spec.events * w / wsum for k, w in weights.items()}
    counts = {k: int(q) for k, q in quota.items()}
    short = spec.events - sum(counts.values())
    # Stable remainder order: largest fraction first, name breaks ties.
    order = sorted(weights, key=lambda k: (-(quota[k] - counts[k]), k))
    for k in order[:short]:
        counts[k] += 1
    extra = counts.get("restart", 0) - counts.get("crash", 0)
    if extra > 0:
        counts["restart"] -= extra
        counts["crash"] = counts.get("crash", 0) + extra
    return {k: v for k, v in sorted(counts.items()) if v > 0}


class _NodeAlloc:
    """Disjoint contiguous node-range allocator for down-events.

    Crash/restart chains, permanent crashes, and leaves get ranges that
    never overlap each other (overlapping down-chains can be VALID but
    make time-sequencing ambiguous — the fuzzer does not need them to
    cover the vocabulary).  At most half the group is ever allocated,
    so the membership always has a live majority to heal from.
    """

    def __init__(self, rng: random.Random, n: int):
        self.rng = rng
        self.n = n
        self.used: set = set()
        self.budget = max(1, n // 2)

    def take(self, width: int) -> Tuple[int, int]:
        """A free range; narrows down to width 1 under fragmentation
        (range WIDTH does not touch ScenarioStatic — only the range
        COUNT does — so narrowing preserves the one-compile contract
        while dropping the event would break it)."""
        if len(self.used) >= self.budget:
            raise ValueError(
                f"down-event node budget exhausted ({self.budget} of "
                f"{self.n}) — fuzz_schedule's upfront check is wrong")
        width = max(1, min(width, self.budget - len(self.used)))
        for w in range(width, 0, -1):
            for _ in range(32):
                lo = self.rng.randrange(0, self.n - w + 1)
                span = range(lo, lo + w)
                if not self.used.intersection(span):
                    self.used.update(span)
                    return (lo, lo + w)
            for lo in range(self.n - w + 1):   # deterministic sweep
                span = range(lo, lo + w)
                if not self.used.intersection(span):
                    self.used.update(span)
                    return (lo, lo + w)
        raise AssertionError("unreachable: width-1 always fits "
                             "under budget")


def _any_range(rng: random.Random, n: int, max_width: int) -> Tuple[int, int]:
    w = rng.randint(1, max(1, max_width))
    lo = rng.randrange(0, n - w + 1)
    return (lo, lo + w)


def fuzz_schedule(spec: CampaignSpec, index: int) -> dict:
    """Schedule ``index`` of the campaign (module docstring contracts)."""
    if not 0 <= index:
        raise ValueError(f"index {index} out of range")
    rng = random.Random(f"chaos:{spec.seed}:{index}")
    n, tfail = spec.n, spec.tfail
    counts = dict(kind_counts(spec))
    lo_t = max(4, tfail // 2)
    hi_t = spec.total - spec.settle_ticks()
    if hi_t - lo_t < 6 * len(counts):
        raise ValueError(
            f"tick budget {spec.total} too small for {spec.events} "
            f"events with a {spec.settle_ticks()}-tick settle tail")
    # Every apportioned event MUST be emitted (dropping one would
    # change ScenarioStatic and break the one-compile contract), so the
    # node and tick budgets are checked upfront, loudly.
    down_takes = (counts.get("crash", 0) - counts.get("restart", 0)
                  + counts.get("restart", 0) + counts.get("leave", 0))
    if down_takes > max(1, n // 2):
        raise ValueError(
            f"campaign mix asks for {down_takes} disjoint down-event "
            f"ranges but N={n} budgets only {max(1, n // 2)}; lower "
            "the crash/leave weights or events per schedule")
    alloc = _NodeAlloc(rng, n)
    events = []

    # -- crash/restart chains: churn storms + flapping ------------------
    pairs = counts.pop("restart", 0)
    permanent = counts.pop("crash", 0) - pairs
    chains = []                 # [(range, n_cycles)]
    for _ in range(pairs):
        if chains and rng.random() < 0.35:
            # Flap: another crash/restart cycle on an existing range.
            j = rng.randrange(len(chains))
            chains[j] = (chains[j][0], chains[j][1] + 1)
            continue
        chains.append((alloc.take(rng.randint(1, max(1, n // 8))), 1))
    for r, cycles in chains:
        # 2*cycles strictly increasing ticks: crash/restart alternate.
        ticks = sorted(rng.sample(range(lo_t, hi_t), 2 * cycles))
        for c in range(cycles):
            events.append({"kind": "crash", "time": ticks[2 * c],
                           "range": [r[0], r[1]]})
            events.append({"kind": "restart", "time": ticks[2 * c + 1],
                           "range": [r[0], r[1]]})
    for _ in range(max(0, permanent)):
        r = alloc.take(1)
        events.append({"kind": "crash", "time": rng.randrange(lo_t, hi_t),
                       "range": [r[0], r[1]]})

    # -- leaves ---------------------------------------------------------
    for _ in range(counts.pop("leave", 0)):
        r = alloc.take(1)
        events.append({"kind": "leave", "time": rng.randrange(lo_t, hi_t),
                       "range": [r[0], r[1]]})

    # -- migrations (harness-level; opt-in via --mix, NOT in
    # DEFAULT_MIX — adding it there would shift every pinned campaign
    # digest).  Not a scenario-engine kind: the campaign runner
    # executes a migrate by killing the checkpointed run at this tick,
    # resharding the durable carry, and resuming (chaos/campaign.py).
    # Byte-exact chunked resume keeps the graded trajectory identical,
    # so the oracle verdict is unchanged by WHERE the migrations land.
    for _ in range(counts.pop("migrate", 0)):
        events.append({"kind": "migrate",
                       "time": rng.randrange(lo_t, hi_t)})

    # -- partitions (2-group, non-overlapping in time) ------------------
    # Segmented placement: partition j draws inside its own slice of
    # the active window, so any count fits without overlap and none is
    # ever dropped.
    n_parts = counts.pop("partition", 0)
    if n_parts:
        per = (hi_t - lo_t) // n_parts
        if per < tfail + 4:
            raise ValueError(
                f"tick budget {spec.total} too small for {n_parts} "
                f"partition windows of >= {tfail} ticks")
        for j in range(n_parts):
            seg_lo = lo_t + j * per
            length = rng.randint(tfail, min(3 * tfail, per - 4))
            start = rng.randrange(seg_lo, seg_lo + per - length - 2)
            cut = rng.randint(1, n - 1) if n > 2 else 1
            events.append({"kind": "partition", "start": start,
                           "stop": start + length,
                           "groups": [[0, cut], [cut, n]]})

    # -- loss / delay windows ------------------------------------------
    def window(min_len, max_len):
        length = rng.randint(min_len, max(min_len, max_len))
        start = rng.randrange(lo_t, max(lo_t + 1, hi_t - length))
        return start, start + length

    for _ in range(counts.pop("link_flake", 0)):
        start, stop = window(3, 3 * tfail)
        events.append({"kind": "link_flake", "start": start, "stop": stop,
                       "src": list(_any_range(rng, n, n)),
                       "dst": list(_any_range(rng, n, n)),
                       "drop_prob": rng.choice(_MILD_PROBS)})
    for _ in range(counts.pop("drop_window", 0)):
        start, stop = window(3, 3 * tfail)
        events.append({"kind": "drop_window", "start": start, "stop": stop,
                       "drop_prob": rng.choice(_MILD_PROBS[:4])})
    for _ in range(counts.pop("one_way_flake", 0)):
        # Hard blackhole (drop_prob defaults to 1.0): stretched PAST the
        # heavy_loss excuse threshold so the oracle excuses the false
        # removals it may cause — healing is the binding check.
        start, stop = window(tfail, 2 * tfail)
        events.append({"kind": "one_way_flake", "start": start,
                       "stop": stop,
                       "src": list(_any_range(rng, n, n)),
                       "dst": list(_any_range(rng, n, max(1, n // 4)))})
    for _ in range(counts.pop("delay_window", 0)):
        # Short windows stay comfortably under TFAIL (no removals, no
        # excuse needed); long ones clear the long_delay excuse.
        if tfail > 5 and rng.random() < 0.5:
            start, stop = window(2, tfail - 3)
        else:
            start, stop = window(tfail, 2 * tfail)
        events.append({"kind": "delay_window", "start": start,
                       "stop": stop,
                       "dst": list(_any_range(rng, n, max(1, n // 4)))})
    if counts:
        raise ValueError(f"unknown kinds in campaign mix: {sorted(counts)}")

    # Stable order (time, then kind/fields) — part of byte-stability.
    events.sort(key=lambda e: (e.get("time", e.get("start", 0)),
                               e["kind"], _canonical(e)))
    return {
        "name": f"{spec.name}-{spec.seed}-{index:04d}",
        "events": events,
        "meta": {"campaign": campaign_digest(spec), "seed": spec.seed,
                 "index": index},
    }
