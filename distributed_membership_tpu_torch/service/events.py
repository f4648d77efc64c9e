"""Live event injection: validation, journal, and plan merging
(counterpart of the JAX package's ``service/events.py``, on the port's
scenario compiler).

An injected event is a scenario/schema.py event dict POSTed to
``/v1/events`` while the run is ticking.  The contract that keeps the
whole thing bit-exact (pinned by tests/test_torch_service.py):

  * injected events are merged with the BASE schedule (the conf's
    SCENARIO file, or the legacy failure plan converted to explicit
    events) into one union scenario, recompiled on the general plan
    path (``compile_scenario(..., force_general=True)``) with a fresh
    ``Random(f"app:{seed}")`` — so the merged program is exactly what
    an uninterrupted run with the union scenario file would compile;
  * the merged runner takes effect from the NEXT segment boundary, and
    every injected time/start must be >= that boundary — history is
    never rewritten, so the pre-injection ticks already computed are
    identical to the union run's (events are inert before they fire);
  * events are journaled (append + fsync) BEFORE the POST is
    acknowledged, so a kill after the ACK cannot lose them: ``--resume``
    replays the journal into the plan before the first resumed segment.

The merge happens at the PLAN level, never by editing ``params``: the
checkpoint manifest pins ``params_text`` (and the SCENARIO digest), so
a resumed daemon must present the exact base config — injected events
live in ``service_events.jsonl`` beside the checkpoints instead.
"""

from __future__ import annotations

import json
import os
import random
from typing import List, Optional

from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.scenario.schema import (
    Scenario, load_scenario, validate_scenario)

JOURNAL_NAME = "service_events.jsonl"
_POINT_KINDS = ("crash", "restart", "leave")


def injection_unsupported(params: Params) -> Optional[str]:
    """Why live injection is unavailable for this run (None = ok).

    Narrower than serving itself: queries work on both ring-family
    backends in either event mode, but swapping the segment runner
    mid-run needs (a) a hash-twin step -- single-chip tpu_hash, or
    tpu_hash_sharded, whose merged runner the daemon rebuilds on the
    SAME mesh through the backend's segment-runner factory, so the
    swapped runner is exactly what an uninterrupted union-scenario run
    builds -- (b) the ring exchange (make_config rejects general
    scenarios on scatter), and (c) EVENT_MODE full -- the aggregate
    carry bakes the static failed-id set (FastAgg) into its shapes,
    which an injected crash would have to reshape mid-run.
    """
    if params.BACKEND not in ("tpu_hash", "tpu_hash_sharded"):
        return ("live injection is implemented on the hash twins only "
                "(BACKEND tpu_hash / tpu_hash_sharded; got "
                f"{params.BACKEND!r})")
    if params.resolved_exchange() != "ring":
        return ("live injection requires the ring exchange (the "
                "scatter lowering runs legacy-shaped plans only)")
    if params.resolved_event_mode() != "full":
        return ("live injection requires EVENT_MODE full (the "
                "aggregate carry bakes the failed-id set into its "
                "shapes; an injected crash cannot reshape it mid-run)")
    if params.ENFORCE_BUFFSIZE:
        return ("live injection and ENFORCE_BUFFSIZE are incompatible "
                "(general scenario programs reject the send budget)")
    if params.FUSED_GOSSIP == 1:
        return ("live injection and FUSED_GOSSIP are incompatible "
                "(general scenario programs reject the fused kernel)")
    return None


def validate_injection(events: List[dict], params: Params,
                       next_tick: int) -> None:
    """Structural + service-constraint validation; raises ValueError.

    Reuses ``scenario.schema.validate_scenario`` wholesale, then adds
    the no-rewriting-history rule: every point time and window start
    must be at or after ``next_tick`` (the earliest boundary the merged
    plan can take effect).
    """
    if not events:
        raise ValueError("no events given")
    validate_scenario(Scenario(name="injected", events=events),
                      params.EN_GPSZ, params.TOTAL_TIME)
    for ev in events:
        if ev["kind"] in _POINT_KINDS:
            if ev["time"] < next_tick:
                raise ValueError(
                    f"injected event {ev}: 'time' {ev['time']} is "
                    f"before the next segment boundary ({next_tick}) — "
                    "the merged plan takes effect from the next "
                    "segment; history is never rewritten")
        elif ev["start"] < next_tick:
            raise ValueError(
                f"injected event {ev}: 'start' {ev['start']} is before "
                f"the next segment boundary ({next_tick})")


class EventJournal:
    """Append-only JSONL journal of accepted injections.

    One event dict per line, fsynced before the POST is acknowledged.
    ``read`` is torn-line tolerant (the same posture as the timeline
    readers): a kill mid-append loses at most the un-ACKed trailing
    line, never an acknowledged event.
    """

    def __init__(self, path: str):
        self.path = path

    def reset(self) -> None:
        """Fresh (non-resume) run: acknowledged events of a PREVIOUS
        run at this checkpoint dir must not leak into this one."""
        if os.path.exists(self.path):
            os.unlink(self.path)

    def append(self, events: List[dict]) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as fh:
            for ev in events:
                fh.write(json.dumps(ev) + "\n")
            fh.flush()
            os.fsync(fh.fileno())

    def read(self) -> List[dict]:
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue        # torn trailing write
        return out


def base_events(params: Params, plan) -> List[dict]:
    """The base schedule as explicit scenario events.

    With a SCENARIO conf key the file's raw events are reused (draw
    selectors re-consume the same seeded stream on recompile, in the
    same order — base events precede injected ones).  A legacy conf
    plan is converted from its RESOLVED form (the draw already
    happened), so the union compiles to the same victims the base run
    computed.  The conf-level drop window needs no conversion: the
    general compile path appends it from ``params.DROP_MSG`` itself.
    """
    if params.SCENARIO:
        return [dict(e) for e in load_scenario(params.SCENARIO).events]
    if (plan.fail_time is not None and len(plan.failed_indices)
            and 0 <= int(plan.fail_time) < params.TOTAL_TIME):
        # A FAIL_TIME at/after TOTAL_TIME never fires — dropping it is
        # bit-exact and keeps the union within the schema's time bound.
        return [{"kind": "crash", "time": int(plan.fail_time),
                 "nodes": [int(i) for i in plan.failed_indices]}]
    return []


def merged_plan(params: Params, base: List[dict], injected: List[dict],
                seed: int):
    """Compile the union schedule on the forced-general path.

    Returns a fresh FailurePlan whose ``scenario`` program contains
    base + injected events — bit-exact vs. compiling a union scenario
    FILE, because the event list and the RNG stream
    (``Random(f"app:{seed}")``, draws consumed in event order) are
    identical in both constructions.
    """
    from distributed_membership_tpu_torch.scenario.compile import (
        compile_scenario)
    scn = Scenario(name="service-injected",
                   events=[dict(e) for e in base + injected],
                   source="<service>")
    return compile_scenario(scn, params, random.Random(f"app:{seed}"),
                            force_general=True)


def apply_merge(params: Params, plan, base: List[dict],
                injected: List[dict], seed: int) -> None:
    """Mutate ``plan`` in place to the merged program.

    In place because the run tail (``finish_run``: events_to_log,
    log_failures, the scenario oracle) holds THIS plan object — after
    the mutation its dbg lines and oracle verdicts match the union
    run's exactly.
    """
    new = merged_plan(params, base, injected, seed)
    plan.kind = new.kind
    plan.fail_time = new.fail_time
    plan.failed_indices = new.failed_indices
    plan.drop_start = new.drop_start
    plan.drop_stop = new.drop_stop
    plan.scenario = new.scenario
