"""Deterministic delta debugging of violating chaos schedules (a copy of
the JAX package's ``chaos/shrink.py``).

A fuzzed schedule that trips an oracle invariant usually carries five
events of noise around the one interaction that matters.  The shrinker
reduces it to a minimal repro by re-running the oracle predicate after
every candidate edit, in a FIXED order:

  1. **Event ddmin** — classic delta debugging over the event list
     (drop chunks at doubling granularity; keep any reduction that
     still violates).  Crash/restart pairing is respected as a
     side-effect of the predicate: dropping a restart whose crash
     remains yields a valid (harsher) schedule, dropping a crash and
     keeping its restart fails validation and the predicate treats an
     invalid candidate as non-violating.
  2. **Window narrowing** — for each surviving window event, repeatedly
     halve the span (from the stop side, then the start side) while the
     violation persists.
  3. **Range shrinking** — for each surviving node selector
     (``range``/``src``/``dst``), halve the width (keeping the low
     side, then the high side).  Partition ``groups`` are left alone:
     they must tile ``[0, N)`` exactly, so the only shrink is dropping
     the whole event (phase 1's job).

Phases repeat until a full pass changes nothing.  Everything is a pure
function of ``(schedule, predicate)`` — no RNG, no wall clock — so the
same violating input always shrinks to the SAME minimal repro (pinned
by tests/test_chaos.py and tests/test_torch_chaos.py).  The predicate is
typically "run it and check the oracle verdicts" (chaos/campaign.py),
which is deterministic too.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Callable, Tuple

from distributed_membership_tpu_torch.chaos.fuzz import (
    dump_schedule, schedule_digest)

_WINDOW_KINDS = ("partition", "link_flake", "drop_window",
                 "one_way_flake", "delay_window")
_RANGE_KEYS = ("range", "src", "dst")


def _with_events(schedule: dict, events: list) -> dict:
    out = dict(schedule)
    out["events"] = events
    return out


def _ddmin_events(schedule: dict, violates, stats) -> dict:
    """Minimal violating event subset (ddmin over the event list)."""
    events = list(schedule["events"])
    gran = 2
    while len(events) >= 2:
        chunk = max(1, len(events) // gran)
        reduced = False
        i = 0
        while i < len(events):
            keep = events[:i] + events[i + chunk:]
            if keep and violates(_with_events(schedule, keep), stats):
                events = keep
                gran = max(gran - 1, 2)
                reduced = True
            else:
                i += chunk
        if not reduced:
            if gran >= len(events):
                break
            gran = min(len(events), gran * 2)
    return _with_events(schedule, events)


def _narrow_windows(schedule: dict, violates, stats) -> dict:
    events = [dict(e) for e in schedule["events"]]
    for ev in events:
        if ev["kind"] not in _WINDOW_KINDS:
            continue
        changed = True
        while changed and ev["stop"] - ev["start"] > 1:
            changed = False
            span = ev["stop"] - ev["start"]
            # Halving steps first (log convergence), then 1-tick trims
            # (halving stalls at span 3 when the live tick is mid-span).
            for key, val in (("stop", ev["start"] + span // 2),
                             ("start", ev["stop"] - span // 2),
                             ("stop", ev["stop"] - 1),
                             ("start", ev["start"] + 1)):
                cand = dict(ev, **{key: val})
                trial = [cand if e is ev else e for e in events]
                if violates(_with_events(schedule, trial), stats):
                    ev[key] = val
                    changed = True
                    break
    return _with_events(schedule, events)


def _shrink_ranges(schedule: dict, violates, stats) -> dict:
    events = [dict(e) for e in schedule["events"]]
    for ev in events:
        for key in _RANGE_KEYS:
            if key not in ev:
                continue
            changed = True
            while changed and ev[key][1] - ev[key][0] > 1:
                changed = False
                lo, hi = ev[key]
                w = hi - lo
                for cand_range in ([lo, hi - w // 2], [lo + w // 2, hi]):
                    cand = dict(ev, **{key: list(cand_range)})
                    trial = [cand if e is ev else e for e in events]
                    if violates(_with_events(schedule, trial), stats):
                        ev[key] = list(cand_range)
                        changed = True
                        break
    return _with_events(schedule, events)


def shrink_schedule(schedule: dict,
                    is_violating: Callable[[dict], bool],
                    max_rounds: int = 8) -> Tuple[dict, dict]:
    """-> ``(minimal_schedule, stats)``; module docstring contract.

    ``is_violating(schedule) -> bool`` must treat an INVALID candidate
    (one the schema rejects) as non-violating — campaign.py's oracle
    predicate does.  ``stats`` reports ``probes`` (predicate calls) and
    ``rounds``; both are part of the determinism pin.
    """
    stats = {"probes": 0}

    def violates(cand: dict, st) -> bool:
        st["probes"] += 1
        return bool(is_violating(cand))

    if not violates(schedule, stats):
        raise ValueError("shrink_schedule: input does not violate — "
                         "nothing to shrink")
    cur = copy.deepcopy(schedule)
    rounds = 0
    for _ in range(max_rounds):
        before = dump_schedule(cur)
        cur = _ddmin_events(cur, violates, stats)
        cur = _narrow_windows(cur, violates, stats)
        cur = _shrink_ranges(cur, violates, stats)
        rounds += 1
        if dump_schedule(cur) == before:
            break
    stats["rounds"] = rounds
    stats["events_before"] = len(schedule["events"])
    stats["events_after"] = len(cur["events"])
    return cur, stats


def bank_repro(minimal: dict, bank_dir: str, meta: dict) -> str:
    """Write the minimal repro under ``bank_dir`` and return its path.

    The file is a runnable scenario (``--scenario`` accepts it as-is —
    ``Scenario.from_dict`` ignores the ``meta`` key) named by its own
    digest, so re-banking the same repro is idempotent and two
    different bugs can never collide."""
    banked = dict(minimal)
    banked["meta"] = {**minimal.get("meta", {}), **meta}
    # Digest over the EVENTS alone: the repro's identity is the
    # minimal schedule, not which fuzzed run first found it.
    digest = schedule_digest({"events": banked["events"]})
    banked["name"] = f"repro-{digest}"
    os.makedirs(bank_dir, exist_ok=True)
    path = os.path.join(bank_dir, f"repro-{digest}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(json.dumps(banked, sort_keys=True, indent=1) + "\n")
    os.replace(tmp, path)
    return path
