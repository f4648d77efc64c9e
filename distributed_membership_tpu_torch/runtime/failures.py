"""Failure injection plans (the JAX package's ``runtime/failures.py``).

The plan is drawn up front from Python's seeded ``random.Random`` (the
reference's crash-stop of one random node, or of ``EN_GPSZ/2`` contiguous
nodes, or of whole racks, at ``FAIL_TIME``; DROP_MSG's drop window), so
the port injects the same failures as the JAX package for the same seed.
``SCENARIO:`` names a declarative schedule instead (scenario/compile.py):
a legacy-shaped one lowers to the same plan, a general one rides the
plan as ``plan.scenario``.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional

import torch

from distributed_membership_tpu_torch.addressing import index_to_id
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.ops import rbg, threefry


@dataclasses.dataclass
class FailurePlan:
    kind: str                    # 'single' | 'multi' | 'racks' | 'none'
    #                              | 'scenario' (general scenario path)
    fail_time: Optional[int]
    failed_indices: List[int]    # crashed at fail_time (general scenarios:
    #                              the permanently failed set, fail_time
    #                              the earliest crash among them)
    drop_start: Optional[int]
    drop_stop: Optional[int]
    # The compiled general-path scenario (scenario/compile.py
    # ScenarioProgram), None for legacy plans.
    scenario: Optional[object] = None


def draw_single(n: int, rng: random.Random) -> int:
    """Application.cpp:182: removed = rand() % EN_GPSZ."""
    return rng.randrange(n)


def draw_multi(n: int, rng: random.Random):
    """Application.cpp:189, C precedence ``(rand() % N) / 2``: the ``[lo,
    hi)`` range of the N/2 contiguous nodes from there."""
    start = rng.randrange(n) // 2
    return start, min(start + n // 2, n)


def draw_racks(params: Params, rng: random.Random) -> List[int]:
    """RACK_FAILURES distinct racks of RACK_SIZE contiguous nodes."""
    n = params.EN_GPSZ
    n_racks = max(n // params.RACK_SIZE, 1)
    racks = rng.sample(range(n_racks), min(params.RACK_FAILURES, n_racks))
    return sorted(i for r in racks
                  for i in range(r * params.RACK_SIZE,
                                 min((r + 1) * params.RACK_SIZE, n)))


def make_plan(params: Params, rng: random.Random) -> FailurePlan:
    n = params.EN_GPSZ
    drop_start = params.DROP_START if params.DROP_MSG else None
    drop_stop = params.DROP_STOP if params.DROP_MSG else None
    if params.RACK_SIZE > 0 and params.RACK_FAILURES > 0:
        return FailurePlan("racks", params.FAIL_TIME,
                           draw_racks(params, rng), drop_start, drop_stop)
    if params.SINGLE_FAILURE:
        return FailurePlan("single", params.FAIL_TIME, [draw_single(n, rng)],
                           drop_start, drop_stop)
    lo, hi = draw_multi(n, rng)
    return FailurePlan("multi", params.FAIL_TIME, list(range(lo, hi)),
                       drop_start, drop_stop)


def resolve_plan(params: Params, rng: random.Random) -> FailurePlan:
    """The legacy seeded draw, or the compiled ``SCENARIO:`` schedule."""
    if params.SCENARIO:
        from distributed_membership_tpu_torch.scenario.compile import (
            resolve_scenario_plan)
        return resolve_scenario_plan(params, rng)
    return make_plan(params, rng)


def make_run_key(params: Params, seed: int) -> threefry.Key:
    """Root key of the run under ``PRNG_IMPL``: ``PRNGKey(seed)`` for
    threefry2x32, else ``jax.random.key(seed, impl=PRNG_IMPL)``
    (ops/rbg.py)."""
    if params.PRNG_IMPL == "threefry2x32":
        return threefry.prng_key(seed)
    return rbg.seed(seed, params.PRNG_IMPL)


@dataclasses.dataclass
class PlanTensors:
    """The schedule the tick loop consumes.  Scalars stay host ints (the
    loop branches on them without a device sync); ``fail_mask`` lives on
    the run's device.  Under a general scenario ``scenario`` holds the
    program's plan arrays (scenario/compile.py ScenarioTensors, read on
    the host per tick) and ``scenario_static`` its descriptor; the legacy
    drop window is then closed and ``fail_mask``/``fail_time`` are the
    permanently failed set and its earliest crash, for FastAgg only."""
    root: threefry.Key
    start_ticks: torch.Tensor    # [N] int32 tick each node starts, -1 warm
    fail_mask: torch.Tensor      # [N] bool
    fail_time: int               # -1 = never
    drop_lo: int
    drop_hi: int
    scenario: Optional[object] = None
    scenario_static: Optional[object] = None

    def tick_key(self, t: int) -> threefry.Key:
        """Row ``t`` of the JAX package's ``jax.vmap(lambda t:
        fold_in(root, t))(arange(total))``: ``fold_in(root, t)``, but
        under unsafe_rbg that vmapped fold_in draws every tick's bits from
        tick 0's seed (ops/rbg.py)."""
        return threefry.fold_in_vmapped(self.root, t, 0, t)

    def drop_active(self, t: int) -> bool:
        return self.drop_lo < t <= self.drop_hi


def plan_tensors(params: Params, plan: FailurePlan, seed: int, total: int,
                 device) -> PlanTensors:
    n = params.EN_GPSZ
    fail_mask = torch.zeros((n,), dtype=torch.bool)
    fail_time = -1
    if plan.fail_time is not None:
        fail_mask[plan.failed_indices] = True
        fail_time = plan.fail_time
    program = plan.scenario
    return PlanTensors(
        root=make_run_key(params, seed),
        start_ticks=torch.tensor([params.start_tick(i) for i in range(n)],
                                 dtype=torch.int32, device=device),
        fail_mask=fail_mask.to(device),
        fail_time=fail_time,
        drop_lo=(plan.drop_start if plan.drop_start is not None
                 else total + 1),
        drop_hi=(plan.drop_stop if plan.drop_stop is not None
                 else total + 1),
        scenario=None if program is None else program.tensors(),
        scenario_static=None if program is None else program.static)


def log_failures(plan: FailurePlan, log, t: int) -> None:
    """The 'Node failed at time...' lines of Application.cpp:184,192."""
    if plan.fail_time != t:
        return
    if plan.kind == "single":
        log.node_failed_single(index_to_id(plan.failed_indices[0]), t)
    else:
        for i in plan.failed_indices:
            log.node_failed_multi(index_to_id(i), t)
