"""Scenario compiler: events -> tick-indexed plans (the JAX package's
``scenario/compile.py``).

Two lowerings, as there:

* **Legacy** -- crashes at ONE time plus at most one global drop window is
  the failure shape the reference injects, so it lowers straight to a
  :class:`~distributed_membership_tpu_torch.runtime.failures.FailurePlan`;
  draw selectors consume the seeded ``random.Random`` stream exactly as
  ``make_plan`` does, so ``scenarios/{singlefailure,...}.json`` reproduce
  the testcases' plans.
* **General** -- restart/leave/partition/flakes/delays or crashes at
  several times compile to a :class:`ScenarioProgram` whose
  :class:`ScenarioTensors` are small numpy arrays (windows, ranges,
  cuts), equal to the JAX package's.

The ring steps take ``t`` as a host int, so a tick's activation (which
events fire, which windows are open, the active partition's cuts, the
drop probabilities) is read on the host from those arrays, and only the
per-node masks are tensor operations on the run's device -- no host sync
per tick.  The six in-step helpers below are that split: each returns
what the JAX helper returns, with ``None`` where nothing is active at
``t`` (an all-false mask, a window-free probability stays a Python
float).

Probabilities are integer percents in float32 (``_quant``).  A link
flake combines with the global window as ``p + q - p*q``; inside the
JAX package's jitted step XLA on the CPU contracts that into one fused
multiply-add, ``fma(-p, q, f32(p + q))``, rounded once.  PyTorch has no
fused multiply-add, so :func:`combine_prob` computes that value exactly
on the host for each (p, q) pair a tick needs (a handful: the inputs are
percents), and the device picks it by the matched flake.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from fractions import Fraction
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from distributed_membership_tpu_torch.scenario.schema import (
    Scenario, load_scenario, validate_scenario)

DOWN_KINDS = ("crash", "leave")

# Backends implementing the general path in the JAX package (the error
# text below names them); the port has the two hash backends.
GENERAL_BACKENDS = ("emul", "tpu_hash", "tpu_hash_sharded")


class ScenarioStatic(NamedTuple):
    """Hashable structural descriptor (which hook sites exist)."""
    n: int
    n_events: int         # point-event rows (crash/leave/restart ranges)
    n_parts: int          # partition windows
    n_cuts: int           # group-boundary cut columns
    n_flakes: int         # link_flake / one_way_flake windows
    n_windows: int        # global drop windows
    n_delays: int         # delay_window (hold-inbound) windows
    has_drop: bool        # any coin-consuming loss (windows or flakes)
    has_updown: bool      # any crash/leave/restart event


class ScenarioTensors(NamedTuple):
    """The plan as numpy arrays (shapes per ScenarioStatic, each padded to
    length >= 1 with inert rows), the JAX package's leaves."""
    ev_time: np.ndarray       # [E] i32 (pad -9: never fires)
    ev_down: np.ndarray       # [E] bool -- crash | leave rows
    ev_up: np.ndarray         # [E] bool -- restart rows
    ev_lo: np.ndarray         # [E] i32
    ev_hi: np.ndarray         # [E] i32
    part_start: np.ndarray    # [P] i32 (pad -9)
    part_stop: np.ndarray     # [P] i32 (pad -9)
    part_cut: np.ndarray      # [P, C] i32 (pad N -- group 0 everywhere)
    fl_start: np.ndarray      # [F] i32 (pad -9)
    fl_stop: np.ndarray       # [F] i32
    fl_slo: np.ndarray        # [F] i32
    fl_shi: np.ndarray        # [F] i32
    fl_dlo: np.ndarray        # [F] i32
    fl_dhi: np.ndarray        # [F] i32
    fl_prob: np.ndarray       # [F] f32 (quantized)
    dw_lo: np.ndarray         # [W] i32 (pad -9)
    dw_hi: np.ndarray         # [W] i32
    dw_prob: np.ndarray       # [W] f32 (quantized)
    dl_start: np.ndarray      # [D] i32 (pad -9)
    dl_stop: np.ndarray       # [D] i32
    dl_lo: np.ndarray         # [D] i32 -- dst range held during the window
    dl_hi: np.ndarray         # [D] i32


def _quant(p: float) -> float:
    """Integer-percent quantization (EmulNet.cpp:92 semantics)."""
    return int(float(p) * 100) / 100.0


def _f32_nearest(x: Fraction) -> float:
    """``x`` rounded once to float32 (nearest, ties to even); x >= 0 and
    normal-range, as probabilities are."""
    if x == 0:
        return 0.0
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1                                  # 2^e <= x < 2^(e+1)
    m = round(x * Fraction(2) ** (23 - e))      # 24-bit significand
    return float(np.float32(m * 2.0 ** (e - 23)))


@functools.lru_cache(maxsize=None)
def combine_prob(p: float, q: float) -> float:
    """``p + q - p*q`` for float32 ``p``, ``q`` as the JAX package's step
    computes it on the CPU: ``fma(-p, q, f32(p + q))``."""
    r1 = Fraction(float(np.float32(p) + np.float32(q)))
    return _f32_nearest(r1 - Fraction(p) * Fraction(q))


# ---------------------------------------------------------------------------
# In-step helpers: activation on the host (``t`` is a host int), masks as
# tensor operations on the device of ``node_ids`` / ``src`` / ``dst``.

def _in(x, lo: int, hi: int):
    return (x >= lo) & (x < hi)


def updown_masks(scn: ScenarioTensors, t: int, node_ids):
    """``(down_now, up_now)`` bool masks shaped like ``node_ids``: which
    nodes crash/leave resp. restart at the end of tick ``t``; ``(None,
    None)`` when no event fires at ``t``."""
    rows = np.nonzero(scn.ev_time == t)[0]
    if not len(rows):
        return None, None
    down = torch.zeros(node_ids.shape, dtype=torch.bool,
                       device=node_ids.device)
    up = torch.zeros_like(down)
    for j in rows:              # a crash/leave row or a restart row
        hit = _in(node_ids, int(scn.ev_lo[j]), int(scn.ev_hi[j]))
        if scn.ev_down[j]:
            down |= hit
        else:
            up |= hit
    return down, up


def cuts_at(scn: ScenarioTensors, t: int, n: int) -> np.ndarray:
    """The active partition's ``[C]`` group-boundary cuts at tick ``t``
    (all ``n``, one group, when no partition is active)."""
    act = (t > scn.part_start) & (t <= scn.part_stop)
    return np.where(act[:, None], scn.part_cut, n).min(0)


def cut_active(cuts: np.ndarray, n: int) -> bool:
    """Whether ``cuts`` splits ``[0, n)`` into more than one group."""
    return bool((cuts < n).any())


def cross_group(cuts: np.ndarray, src, dst):
    """``group[src] != group[dst]`` under the host cut row (``group(x) =
    sum(x >= cuts)``), elementwise over broadcastable ``src``/``dst``
    (tensors, or a Python int for one side)."""
    gs = gd = 0
    for c in np.unique(cuts).tolist():
        gs = gs + (src >= c if isinstance(src, int)
                   else (src >= c).to(torch.int32))
        gd = gd + (dst >= c if isinstance(dst, int)
                   else (dst >= c).to(torch.int32))
    return gs != gd


def delayed_mask(scn: ScenarioTensors, t: int, node_ids):
    """Bool mask shaped like ``node_ids``: which nodes have inbound
    delivery held at tick ``t``; None when no delay window is open."""
    rows = np.nonzero((t > scn.dl_start) & (t <= scn.dl_stop))[0]
    if not len(rows):
        return None
    held = torch.zeros(node_ids.shape, dtype=torch.bool,
                       device=node_ids.device)
    for j in rows:
        held |= _in(node_ids, int(scn.dl_lo[j]), int(scn.dl_hi[j]))
    return held


def base_drop_prob(scn: ScenarioTensors, t: int) -> float:
    """The max active global drop-window probability at ``t`` (a float32
    value, 0.0 when no window is open)."""
    act = (t > scn.dw_lo) & (t <= scn.dw_hi)
    return float(np.where(act, scn.dw_prob, np.float32(0)).max())


def site_drop_prob(static: ScenarioStatic, scn: ScenarioTensors, t: int,
                   src, dst):
    """Per-message drop probability of a send site: the global window's
    ``p`` combined with the largest matching link-flake ``q`` as
    independent loss (:func:`combine_prob`).  A Python float where no
    flake is open at ``t`` (``combine_prob(p, 0) == p``), else a float32
    tensor broadcast over ``src``/``dst``."""
    p = base_drop_prob(scn, t)
    if static.n_flakes == 0:
        return p
    rows = np.nonzero((t > scn.fl_start) & (t <= scn.fl_stop))[0]
    if not len(rows):
        return p
    # q as an integer percent (the flake probabilities are percents), so
    # the max over matching flakes is an integer max.
    q_pct = None
    pcts = set()
    for j in rows:
        m = ((src >= int(scn.fl_slo[j])) & (src < int(scn.fl_shi[j]))
             & (dst >= int(scn.fl_dlo[j])) & (dst < int(scn.fl_dhi[j])))
        pct = round(float(scn.fl_prob[j]) * 100)
        pcts.add(pct)
        q = m.to(torch.int32) * pct
        q_pct = q if q_pct is None else torch.maximum(q_pct, q)
    out = torch.full(q_pct.shape, p, dtype=torch.float32,
                     device=q_pct.device)
    for pct in sorted(pcts):
        q = float(np.float32(pct / 100.0))
        out = torch.where(q_pct == pct, combine_prob(p, q), out)
    return out


# ---------------------------------------------------------------------------
# Compiled program

@dataclasses.dataclass
class ScenarioProgram:
    """A compiled general-path scenario: the resolved event list plus the
    plan arrays, attached to the run's ``FailurePlan`` (``plan.scenario``)."""
    scenario: Scenario
    n: int
    static: ScenarioStatic
    point_events: List[dict]      # {kind, time, ranges: [(lo, hi)...]}
    partitions: List[dict]        # {start, stop, cuts: [..]}
    flakes: List[dict]            # {start, stop, src, dst, drop_prob}
    drop_windows: List[dict]      # {start, stop, drop_prob}
    delays: List[dict] = dataclasses.field(default_factory=list)
    # ^ {start, stop, dst: (lo, hi)} -- hold-inbound windows

    _tensors: Optional[ScenarioTensors] = dataclasses.field(
        default=None, repr=False, compare=False)

    def tensors(self) -> ScenarioTensors:
        """The plan arrays (built once per program)."""
        if self._tensors is None:
            self._tensors = self.numpy_tensors()
        return self._tensors

    def numpy_tensors(self) -> ScenarioTensors:
        st = self.static
        e = max(st.n_events, 1)
        ev_time = np.full((e,), -9, np.int32)
        ev_down = np.zeros((e,), bool)
        ev_up = np.zeros((e,), bool)
        ev_lo = np.zeros((e,), np.int32)
        ev_hi = np.zeros((e,), np.int32)
        i = 0
        for ev in self.point_events:
            for lo, hi in ev["ranges"]:
                ev_time[i] = ev["time"]
                ev_down[i] = ev["kind"] in DOWN_KINDS
                ev_up[i] = ev["kind"] == "restart"
                ev_lo[i], ev_hi[i] = lo, hi
                i += 1
        p = max(st.n_parts, 1)
        c = max(st.n_cuts, 1)
        part_start = np.full((p,), -9, np.int32)
        part_stop = np.full((p,), -9, np.int32)
        part_cut = np.full((p, c), self.n, np.int32)
        for j, w in enumerate(self.partitions):
            part_start[j], part_stop[j] = w["start"], w["stop"]
            part_cut[j, :len(w["cuts"])] = w["cuts"]
        f = max(st.n_flakes, 1)
        fl = {k: np.full((f,), -9, np.int32) for k in ("start", "stop")}
        fl.update({k: np.zeros((f,), np.int32)
                   for k in ("slo", "shi", "dlo", "dhi")})
        fl_prob = np.zeros((f,), np.float32)
        for j, w in enumerate(self.flakes):
            fl["start"][j], fl["stop"][j] = w["start"], w["stop"]
            fl["slo"][j], fl["shi"][j] = w["src"]
            fl["dlo"][j], fl["dhi"][j] = w["dst"]
            fl_prob[j] = w["drop_prob"]
        wn = max(st.n_windows, 1)
        dw_lo = np.full((wn,), -9, np.int32)
        dw_hi = np.full((wn,), -9, np.int32)
        dw_prob = np.zeros((wn,), np.float32)
        for j, w in enumerate(self.drop_windows):
            dw_lo[j], dw_hi[j] = w["start"], w["stop"]
            dw_prob[j] = w["drop_prob"]
        d = max(st.n_delays, 1)
        dl_start = np.full((d,), -9, np.int32)
        dl_stop = np.full((d,), -9, np.int32)
        dl_lo = np.zeros((d,), np.int32)
        dl_hi = np.zeros((d,), np.int32)
        for j, w in enumerate(self.delays):
            dl_start[j], dl_stop[j] = w["start"], w["stop"]
            dl_lo[j], dl_hi[j] = w["dst"]
        return ScenarioTensors(
            ev_time, ev_down, ev_up, ev_lo, ev_hi,
            part_start, part_stop, part_cut,
            fl["start"], fl["stop"], fl["slo"], fl["shi"], fl["dlo"],
            fl["dhi"], fl_prob, dw_lo, dw_hi, dw_prob,
            dl_start, dl_stop, dl_lo, dl_hi)

    def host(self) -> "ScenarioHost":
        return ScenarioHost(self)


class ScenarioHost:
    """Host-side twin of the plan, evaluated per message in Python (the
    JAX package's twin for its ``emul`` backend; the port has no emul
    backend, and keeps this as the plain reading of the plan)."""

    def __init__(self, program: ScenarioProgram):
        self.program = program
        self._t = program.numpy_tensors()
        self.n = program.n

    def down_at(self, t: int) -> List[int]:
        return self._fire(t, self._t.ev_down)

    def up_at(self, t: int) -> List[int]:
        return self._fire(t, self._t.ev_up)

    def _fire(self, t: int, kind_mask) -> List[int]:
        out: List[int] = []
        tt = self._t
        for j in range(len(tt.ev_time)):
            if tt.ev_time[j] == t and kind_mask[j]:
                out.extend(range(int(tt.ev_lo[j]), int(tt.ev_hi[j])))
        return sorted(set(out))

    def blocked(self, t: int, src: int, dst: int) -> bool:
        if self.program.static.n_parts == 0:
            return False
        cuts = cuts_at(self._t, t, self.n)
        return int((src >= cuts).sum()) != int((dst >= cuts).sum())

    def delayed(self, t: int, idx: int) -> bool:
        if self.program.static.n_delays == 0:
            return False
        tt = self._t
        return bool(((t > tt.dl_start) & (t <= tt.dl_stop)
                     & (idx >= tt.dl_lo) & (idx < tt.dl_hi)).any())

    def drop_pct(self, t: int, src: int, dst: int) -> int:
        """Effective drop percentage for one message (reference-style
        integer percent of ``p + q - p*q`` in float64)."""
        tt = self._t
        act = (t > tt.dw_lo) & (t <= tt.dw_hi)
        p = float(np.where(act, tt.dw_prob, 0.0).max())
        q = 0.0
        if self.program.static.n_flakes:
            m = ((t > tt.fl_start) & (t <= tt.fl_stop)
                 & (src >= tt.fl_slo) & (src < tt.fl_shi)
                 & (dst >= tt.fl_dlo) & (dst < tt.fl_dhi))
            q = float(np.where(m, tt.fl_prob, 0.0).max())
        return int((p + q - p * q) * 100)


# ---------------------------------------------------------------------------
# Compilation

def _resolve_ranges(ev: dict, params, rng) -> Tuple[List[Tuple[int, int]],
                                                    str]:
    """``(ranges, plan_kind_hint)`` for one point event; draw selectors
    consume ``rng`` exactly as the legacy planner does."""
    from distributed_membership_tpu_torch.runtime.failures import (
        draw_multi, draw_racks, draw_single)

    if "range" in ev:
        lo, hi = ev["range"]
        return [(int(lo), int(hi))], "multi"
    if "nodes" in ev:
        return [(int(i), int(i) + 1) for i in sorted(set(ev["nodes"]))], \
            "multi"
    draw = ev["draw"]
    if draw == "single":
        idx = draw_single(params.EN_GPSZ, rng)
        return [(idx, idx + 1)], "single"
    if draw == "multi":
        lo, hi = draw_multi(params.EN_GPSZ, rng)
        return ([(lo, hi)] if hi > lo else []), "multi"
    indices = draw_racks(params, rng)
    return [(i, i + 1) for i in indices], "racks"


def _indices(ranges: List[Tuple[int, int]]) -> List[int]:
    return sorted({i for lo, hi in ranges for i in range(lo, hi)})


def scenario_digest(path: str) -> str:
    """sha256 of the scenario file bytes (a checkpoint's provenance)."""
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def compile_scenario(scn: Scenario, params, rng, force_general: bool = False):
    """A FailurePlan: ``plan.scenario`` is the :class:`ScenarioProgram` on
    the general path and None on the legacy lowering, where ``params`` may
    be mutated to carry the scenario's drop window through the legacy
    code.  ``force_general`` compiles a legacy-shaped scenario on the
    general path (never mutating ``params``)."""
    from distributed_membership_tpu_torch.runtime.failures import FailurePlan

    n, total = params.EN_GPSZ, params.TOTAL_TIME
    validate_scenario(scn, n, total)

    point, parts, flakes, windows, delays = [], [], [], [], []
    kind_hint = "multi"
    for ev in scn.events:
        kind = ev["kind"]
        if kind in ("crash", "restart", "leave"):
            ranges, hint = _resolve_ranges(ev, params, rng)
            if kind == "crash":
                kind_hint = hint
            point.append({"kind": kind, "time": int(ev["time"]),
                          "ranges": ranges})
        elif kind == "partition":
            parts.append({"start": int(ev["start"]),
                          "stop": int(ev["stop"]),
                          "cuts": [int(g[0]) for g in ev["groups"][1:]]})
        elif kind in ("link_flake", "one_way_flake"):
            flakes.append({"start": int(ev["start"]),
                           "stop": int(ev["stop"]),
                           "src": (int(ev["src"][0]), int(ev["src"][1])),
                           "dst": (int(ev["dst"][0]), int(ev["dst"][1])),
                           "drop_prob": _quant(ev.get("drop_prob", 1.0))})
        elif kind == "delay_window":
            dst = ev.get("dst", (0, n))
            delays.append({"start": int(ev["start"]),
                           "stop": int(ev["stop"]),
                           "dst": (int(dst[0]), int(dst[1]))})
        else:
            windows.append({"start": int(ev["start"]),
                            "stop": int(ev["stop"]),
                            "drop_prob": _quant(ev["drop_prob"])})

    crashes = [e for e in point if e["kind"] in DOWN_KINDS]
    crash_times = sorted({e["time"] for e in crashes})
    restarts = [e for e in point if e["kind"] == "restart"]

    # A conf-level drop window coexists with a scenario window on the
    # legacy lowering only when they are the same window.
    conf_window_ok = (not windows or not params.DROP_MSG or (
        len(windows) == 1
        and windows[0]["start"] == params.DROP_START
        and windows[0]["stop"] == params.DROP_STOP
        and windows[0]["drop_prob"] == params.effective_drop_prob()))
    legacy_shape = (
        not parts and not flakes and not delays and not restarts
        and all(e["kind"] == "crash" for e in point)
        and len(crash_times) <= 1 and len(windows) <= 1
        and conf_window_ok)
    if legacy_shape and not force_general:
        if windows and not params.DROP_MSG:
            w = windows[0]
            params.DROP_MSG = 1
            params.MSG_DROP_PROB = w["drop_prob"]
            params.DROP_START = w["start"]
            params.DROP_STOP = w["stop"]
        drop_start = params.DROP_START if params.DROP_MSG else None
        drop_stop = params.DROP_STOP if params.DROP_MSG else None
        fail_time = crash_times[0] if crash_times else None
        failed = _indices([r for e in crashes for r in e["ranges"]])
        return FailurePlan(kind_hint if failed else "none",
                           fail_time if failed else None, failed,
                           drop_start, drop_stop)

    if params.BACKEND not in GENERAL_BACKENDS:
        raise ValueError(
            f"scenario {scn.name!r} needs the general tensor-plan path "
            f"(restart/partition/link_flake/multi-time events), which "
            f"BACKEND {params.BACKEND!r} does not implement "
            f"(supported: {GENERAL_BACKENDS}; legacy-shaped scenarios — "
            "crashes at one time + one drop window — run everywhere)")

    # The conf-level drop window composes as one more global window.
    if params.DROP_MSG:
        windows.append({"start": params.DROP_START,
                        "stop": params.DROP_STOP,
                        "drop_prob": params.effective_drop_prob()})

    # Permanent failures: the last down transition not followed by a
    # restart covering the node.  They seed the detection oracle's id set
    # (FastAgg's failed ids, fail_time the earliest such crash).
    last_down: dict = {}
    last_up: dict = {}
    for e in point:
        for i in _indices(e["ranges"]):
            if e["kind"] in DOWN_KINDS:
                last_down[i] = max(last_down.get(i, -1), e["time"])
            else:
                last_up[i] = max(last_up.get(i, -1), e["time"])
    perm_set = {i for i, td in last_down.items()
                if td > last_up.get(i, -1)}
    permanent = sorted(perm_set)
    fail_time = (min(e["time"] for e in crashes
                     if perm_set.intersection(_indices(e["ranges"])))
                 if permanent else None)

    n_events = sum(len(e["ranges"]) for e in point)
    static = ScenarioStatic(
        n=n, n_events=n_events, n_parts=len(parts),
        n_cuts=max((len(p["cuts"]) for p in parts), default=0),
        n_flakes=len(flakes), n_windows=len(windows),
        n_delays=len(delays),
        has_drop=bool(windows or flakes), has_updown=n_events > 0)
    program = ScenarioProgram(
        scenario=scn, n=n, static=static, point_events=point,
        partitions=parts, flakes=flakes, drop_windows=windows,
        delays=delays)
    return FailurePlan("scenario", fail_time, permanent, None, None,
                       scenario=program)


def resolve_scenario_plan(params, rng):
    """Load ``params.SCENARIO`` and compile it."""
    return compile_scenario(load_scenario(params.SCENARIO), params, rng)
