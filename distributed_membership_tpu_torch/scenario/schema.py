"""Scenario schema: declarative timed chaos events (the JAX package's
``scenario/schema.py``, with the same error texts).

A scenario file is JSON: ``{"name": ..., "events": [...]}``.  Event kinds:

* ``crash`` / ``leave`` -- the selected nodes go down at the END of tick
  ``time`` (they act through it); ``leave`` is mechanically a crash, which
  the oracle classifies as an expected departure;
* ``restart`` -- the selected nodes come back at the end of ``time`` as a
  fresh incarnation (state wiped, heartbeat ``max(hb, 2*(time+1))``),
  rejoining warm through gossip;
* ``partition`` -- for ``start < t <= stop`` messages crossing the
  ``groups`` (ascending contiguous ranges tiling ``[0, N)``) are dropped;
  at most one partition is active per tick;
* ``link_flake`` / ``one_way_flake`` -- directed ``src`` -> ``dst`` loss
  with ``drop_prob`` (``one_way_flake`` defaults to 1.0, a blackhole),
  combined with any global window as independent loss ``p + q - p*q``;
* ``drop_window`` -- a global Bernoulli drop window (the legacy DROP_MSG
  window); the max of the active probabilities applies;
* ``delay_window`` -- inbound delivery to the ``dst`` range (all nodes
  when omitted) is held for ``start < t <= stop``; acks landing in the
  window are lost.

Node selectors for crash/restart/leave (exactly one per event):
``"range": [lo, hi]``, ``"nodes": [i, ...]``, or ``"draw": "single" |
"multi" | "racks"`` (crash only; the seeded draw of the legacy planner).
Probabilities are quantized to integer percent at compile time.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List

EVENT_KINDS = ("crash", "restart", "leave", "partition", "link_flake",
               "drop_window", "one_way_flake", "delay_window")
DRAW_KINDS = ("single", "multi", "racks")
_POINT_KINDS = ("crash", "restart", "leave")


@dataclasses.dataclass
class Scenario:
    """A parsed (but not yet compiled) scenario."""
    name: str
    events: List[dict]
    source: str = ""          # file path, for provenance/manifests

    @classmethod
    def from_dict(cls, d: dict, source: str = "") -> "Scenario":
        if not isinstance(d, dict) or "events" not in d:
            raise ValueError(
                f"scenario {source or '<dict>'}: expected an object with "
                "an 'events' list")
        events = d["events"]
        if not isinstance(events, list) or not events:
            raise ValueError(
                f"scenario {source or '<dict>'}: 'events' must be a "
                "non-empty list")
        return cls(name=str(d.get("name", "unnamed")),
                   events=[dict(e) for e in events], source=source)


def load_scenario(path: str) -> Scenario:
    with open(path) as fh:
        try:
            d = json.load(fh)
        except json.JSONDecodeError as e:
            raise ValueError(f"scenario {path!r}: invalid JSON ({e})") from e
    return Scenario.from_dict(d, source=path)


def _check_range(ev: dict, key: str, n: int, what: str) -> None:
    r = ev.get(key)
    if (not isinstance(r, (list, tuple)) or len(r) != 2
            or not all(isinstance(x, int) for x in r)
            or not 0 <= r[0] < r[1] <= n):
        raise ValueError(
            f"scenario event {ev}: {what} {key!r} must be [lo, hi] with "
            f"0 <= lo < hi <= N={n}")


def validate_scenario(scn: Scenario, n: int, total: int) -> None:
    """Structural validation against a concrete (N, TOTAL_TIME).

    Raises ``ValueError`` on the first violation — a scenario typo must
    fail at config time, never silently simulate something else.
    """
    part_spans = []
    for ev in scn.events:
        kind = ev.get("kind")
        if kind not in EVENT_KINDS:
            raise ValueError(
                f"scenario {scn.name!r}: unknown event kind {kind!r} "
                f"(known: {EVENT_KINDS})")
        if kind in _POINT_KINDS:
            t = ev.get("time")
            if not isinstance(t, int) or not 0 <= t < total:
                raise ValueError(
                    f"scenario event {ev}: 'time' must be an int in "
                    f"[0, TOTAL_TIME={total})")
            sels = [k for k in ("range", "nodes", "draw") if k in ev]
            if len(sels) != 1:
                raise ValueError(
                    f"scenario event {ev}: exactly one of range/nodes/"
                    "draw is required")
            if "range" in ev:
                _check_range(ev, "range", n, kind)
            elif "nodes" in ev:
                nodes = ev["nodes"]
                if (not isinstance(nodes, list) or not nodes
                        or not all(isinstance(x, int) and 0 <= x < n
                                   for x in nodes)):
                    raise ValueError(
                        f"scenario event {ev}: 'nodes' must be a "
                        f"non-empty list of indices in [0, N={n})")
            else:
                if ev["draw"] not in DRAW_KINDS:
                    raise ValueError(
                        f"scenario event {ev}: 'draw' must be one of "
                        f"{DRAW_KINDS}")
                if kind != "crash":
                    raise ValueError(
                        f"scenario event {ev}: 'draw' selectors are "
                        "crash-only (restart/leave need a determined set)")
        else:
            start, stop = ev.get("start"), ev.get("stop")
            if (not isinstance(start, int) or not isinstance(stop, int)
                    or not 0 <= start < stop):
                raise ValueError(
                    f"scenario event {ev}: needs int 'start' < 'stop'")
            if kind == "partition":
                groups = ev.get("groups")
                if (not isinstance(groups, list) or len(groups) < 2):
                    raise ValueError(
                        f"scenario event {ev}: 'groups' must list >= 2 "
                        "contiguous index ranges")
                prev = 0
                for g in groups:
                    if (not isinstance(g, (list, tuple)) or len(g) != 2
                            or g[0] != prev or g[1] <= g[0]):
                        raise ValueError(
                            f"scenario event {ev}: groups must be "
                            "ascending contiguous ranges tiling [0, N) "
                            f"(got {groups})")
                    prev = g[1]
                if prev != n:
                    raise ValueError(
                        f"scenario event {ev}: groups cover [0, {prev}) "
                        f"but N={n}")
                part_spans.append((start, stop))
            elif kind in ("link_flake", "one_way_flake"):
                _check_range(ev, "src", n, kind)
                _check_range(ev, "dst", n, kind)
            elif kind == "delay_window":
                if "dst" in ev:
                    _check_range(ev, "dst", n, kind)
            if kind in ("link_flake", "drop_window") or (
                    kind == "one_way_flake" and "drop_prob" in ev):
                p = ev.get("drop_prob")
                if not isinstance(p, (int, float)) or not 0 < p <= 1:
                    raise ValueError(
                        f"scenario event {ev}: 'drop_prob' must be in "
                        "(0, 1]")
    part_spans.sort()
    for (s1, e1), (s2, e2) in zip(part_spans, part_spans[1:]):
        if s2 < e1:
            raise ValueError(
                f"scenario {scn.name!r}: partition windows ({s1}, {e1}] "
                f"and ({s2}, {e2}] overlap — at most one partition may "
                "be active per tick (one group vector applies)")
