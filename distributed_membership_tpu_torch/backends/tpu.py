"""`tpu` backend: the protocol as one dense tensor step per tick (the JAX
package's ``backends/tpu.py``), on the run's device.

Every node's member list is a row of dense ``[N, N]`` tables indexed by
member (``present``/``hb``/``ts``), and the messages in flight are
``[N, N]`` planes max-combined per receiver (``infl_has``/``infl_hb``):
EmulNet's buffer, reduced as it fills.  The receiver merge keeps the max
heartbeat and refreshes the timestamp only on a strict increase
(MP1Node.cpp:278-288), a combine that ignores message order, and nodes
interact only through the one-tick message latency, so a synchronous
step computes the reference's state trajectory.  Gossip rides
``ops/merge.py``: ``fanout_deliver_indexed`` for the FANOUT targets
sampled per node, ``broadcast_deliver`` for the introducer's burst to new
joiners.  The random streams are the JAX step's (``ops/threefry.py``).

Memory is O(N^2): at N = 10^4 each int32 plane is 0.4 GB, and a tick
with events keeps the ``[N, N]`` join and removal planes until they are
compacted to ``(tick, logger, member)`` rows on the host.
"""

from __future__ import annotations

import dataclasses
import random as _pyrandom
import time as _time
from typing import NamedTuple, Optional

import numpy as np
import torch

from distributed_membership_tpu_torch.addressing import INTRODUCER_INDEX
from distributed_membership_tpu_torch.backends import RunResult, register
from distributed_membership_tpu_torch.backends.tpu_sparse import (
    CompactEvents, events_to_log)
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.eventlog import EventLog
from distributed_membership_tpu_torch.ops.merge import (
    broadcast_deliver, fanout_deliver_indexed)
from distributed_membership_tpu_torch.ops.sampling import sample_k_indices
from distributed_membership_tpu_torch.ops.threefry import (
    Key, bernoulli, split, uniform)
from distributed_membership_tpu_torch.runtime.failures import (
    PlanTensors, plan_tensors, resolve_plan)

I32 = torch.int32
I64 = torch.int64


class State(NamedTuple):
    present: torch.Tensor       # [N, N] bool
    hb: torch.Tensor            # [N, N] int32
    ts: torch.Tensor            # [N, N] int32
    started: torch.Tensor       # [N] bool
    in_group: torch.Tensor      # [N] bool
    failed: torch.Tensor        # [N] bool
    self_hb: torch.Tensor       # [N] int32
    infl_has: torch.Tensor      # [N, N] bool
    infl_hb: torch.Tensor       # [N, N] int32
    joinreq_infl: torch.Tensor  # [N] bool: JOINREQ awaiting the introducer
    joinrep_infl: torch.Tensor  # [N] bool: JOINREP awaiting the joiner
    pending_recv: torch.Tensor  # [N] int32


class TickEvents(NamedTuple):
    joins: torch.Tensor         # [N, N] bool: logger i added entry j
    removes: torch.Tensor       # [N, N] bool
    sent: torch.Tensor          # [N] int32
    recv: torch.Tensor          # [N] int32


@dataclasses.dataclass(frozen=True)
class StepConfig:
    n: int
    tfail: int
    tremove: int
    fanout: int
    drop_prob: float        # effective int(p*100)/100; 0 disables drops
    collect_events: bool = True


def init_state(n: int, device) -> State:
    """The all-empty state."""
    i32 = dict(dtype=I32, device=device)
    no = dict(dtype=torch.bool, device=device)
    return State(
        present=torch.zeros((n, n), **no),
        hb=torch.zeros((n, n), **i32),
        ts=torch.zeros((n, n), **i32),
        started=torch.zeros((n,), **no),
        in_group=torch.zeros((n,), **no),
        failed=torch.zeros((n,), **no),
        self_hb=torch.zeros((n,), **i32),
        infl_has=torch.zeros((n, n), **no),
        infl_hb=torch.full((n, n), -1, **i32),
        joinreq_infl=torch.zeros((n,), **no),
        joinrep_infl=torch.zeros((n,), **no),
        pending_recv=torch.zeros((n,), **i32),
    )


def deliver(state: State, t: int, recv_mask):
    """Pass 1's merge of the in-flight planes into the receiving rows
    (MP1Node::recvLoop + checkMessages): ``(present, hb, ts, infl_has,
    infl_hb, newly)``, ``newly`` the rows' join events."""
    rcol = recv_mask[:, None]
    dlv = state.infl_has & rcol
    newly = dlv & ~state.present
    fresh = newly | (dlv & state.present & (state.infl_hb > state.hb))
    return (state.present | newly,
            torch.where(fresh, state.infl_hb, state.hb),
            torch.where(fresh, t, state.ts),
            state.infl_has & ~rcol,
            torch.where(rcol, -1, state.infl_hb), newly)


def make_step(cfg: StepConfig):
    """The per-tick transition (the JAX ``make_step``):
    ``step(state, t, key, plan) -> (state, TickEvents)`` with ``t`` a
    host int, ``key`` the tick key and ``plan`` the run's PlanTensors.
    Drop coins are drawn only inside the drop window, where the JAX step
    masks them with it; every draw has its own split key, so the bits are
    the same."""
    from distributed_membership_tpu_torch.backends.tpu_hash import (
        join_plane)
    n = cfg.n
    intro = INTRODUCER_INDEX
    use_drop = cfg.drop_prob > 0.0

    def step(state: State, t: int, key: Key, plan: PlanTensors):
        dev = state.hb.device
        idx = torch.arange(n, dtype=I64, device=dev)
        k_targets, k_drop, k_ctrl = split(key, 3)
        coins = use_drop and plan.drop_active(t)
        jp = join_plane(cfg, state, t, plan, idx,
                        ~bernoulli(k_ctrl, cfg.drop_prob, (2, n), dev)
                        if coins else None)
        present, hb, ts, infl_has, infl_hb, join_events = deliver(
            state, t, jp.recv_mask)

        # ---- nodeStart: the introducer boots the group, joiners send
        # their JOINREQ into its in-flight row (MP1Node.cpp:73-163) ----
        boot = plan.start_ticks[intro] == t
        present[intro, intro] |= boot
        hb[intro, intro] = torch.where(boot, 0, hb[intro, intro])
        ts[intro, intro] = torch.where(boot, t, ts[intro, intro])
        infl_has[intro] |= jp.joiner_req
        infl_hb[intro] = torch.where(jp.joiner_req,
                                     infl_hb[intro].clamp_min(0),
                                     infl_hb[intro])

        # ---- nodeLoopOps: the self refresh (odd intermediate heartbeat,
        # MP1Node.cpp:412-415), then the TFAIL / TREMOVE sweep ----
        act = jp.act
        present[idx, idx] |= act
        hb[idx, idx] = torch.where(act, jp.own_hb, hb[idx, idx])
        ts[idx, idx] = torch.where(act, t, ts[idx, idx])
        difft = t - ts
        stale = present & (difft >= cfg.tfail) & act[:, None]
        numfailed = stale.sum(1, dtype=I32)
        removes = stale & (difft >= cfg.tremove)
        present &= ~removes

        # ---- gossip: a uniform k-subset of fresh non-self entries, k
        # bounded by the reference's potential count (MP1Node.cpp:463) --
        numpotential = present.sum(1, dtype=I32) - 1 - numfailed
        fresh = present & (difft < cfg.tfail)
        seed_burst = jp.seeds & act[intro]
        eligible = fresh & (idx[None, :] != idx[:, None]) & act[:, None]
        eligible[intro] &= ~seed_burst
        n_seeds_row = torch.where((idx == intro) & act[intro], jp.n_seeds, 0)
        k_extra = (numpotential.clamp(max=cfg.fanout)
                   - n_seeds_row).clamp_min(0)
        tgt_idx, tgt_valid = sample_k_indices(
            uniform(k_targets, (n, n), dev), eligible, k_extra,
            min(cfg.fanout, n))

        # One message per (sender, target, live entry); stale entries are
        # withheld (MP1Node.cpp:376).
        send_hb = torch.where(fresh, hb, -1)
        k_drop_f, k_drop_s = split(k_drop)
        contrib, sent_list, recv_add = fanout_deliver_indexed(
            k_drop_f, tgt_idx, tgt_valid, send_hb, n, coins, cfg.drop_prob)
        contrib_seed, sent_seed, recv_seed = broadcast_deliver(
            k_drop_s, seed_burst, send_hb[intro], coins, cfg.drop_prob)
        contrib = torch.maximum(contrib, contrib_seed)
        infl_has |= contrib >= 0
        infl_hb = torch.maximum(infl_hb, contrib)
        sent_list[intro] += sent_seed
        sent_tick = sent_list + jp.sent_req + jp.sent_rep

        failed = (state.failed | plan.fail_mask if t == plan.fail_time
                  else state.failed)
        new_state = State(present, hb, ts, jp.started, jp.in_group, failed,
                          jp.self_hb, infl_has, infl_hb, jp.joinreq_infl,
                          jp.joinrep_infl,
                          jp.pending_recv + recv_add + recv_seed)
        if cfg.collect_events:
            out = TickEvents(join_events, removes, sent_tick, jp.recv_tick)
        else:
            out = TickEvents(join_events.sum(dtype=I32),
                             removes.sum(dtype=I32), sent_tick, jp.recv_tick)
        return new_state, out

    return step


def step_config(params: Params, collect_events: bool = True) -> StepConfig:
    return StepConfig(
        n=params.EN_GPSZ, tfail=params.TFAIL, tremove=params.TREMOVE,
        fanout=params.FANOUT, drop_prob=params.effective_drop_prob(),
        collect_events=collect_events)


def run_segment(step, state, plan_t: PlanTensors, a: int, b: int,
                collect_events: bool, n: int):
    """Ticks ``[a, b)``: ``(state, events, None)`` with ``events`` the
    segment's CompactEvents (each tick's planes compacted on the device
    as they come, runtime/checkpoint.py ``compact_dense``) or, in
    aggregate mode, a TickEvents of ``[b - a]`` join/removal totals and
    ``[b - a, N]`` counts."""
    from distributed_membership_tpu_torch.runtime.checkpoint import (
        compact_dense, concat_compact)
    parts, totals = [], []
    for t in range(a, b):
        state, out = step(state, t, plan_t.tick_key(t), plan_t)
        if collect_events:
            parts.append(compact_dense(TickEvents(*(x[None] for x in out)),
                                       t))
        else:
            totals.append(out)
    if collect_events:
        return state, (concat_compact(parts) if parts else CompactEvents(
            np.zeros((0, 3), np.int64), np.zeros((0, 3), np.int64),
            np.zeros((0, n), np.int32), np.zeros((0, n), np.int32), 0)), None
    if not totals:
        return state, TickEvents(np.zeros((0,), np.int32),
                                 np.zeros((0,), np.int32),
                                 np.zeros((0, n), np.int32),
                                 np.zeros((0, n), np.int32)), None
    return state, TickEvents(*(torch.stack(col).cpu().numpy()
                               for col in zip(*totals))), None


def run_scan(params: Params, plan, seed: int, device,
             collect_events: bool = True,
             total_time: Optional[int] = None):
    """The whole run: ``(final_state, events)``, in ``CHECKPOINT_EVERY``
    segments when set (runtime/checkpoint.py)."""
    cfg = step_config(params, collect_events)
    total = total_time if total_time is not None else params.TOTAL_TIME
    plan_t = plan_tensors(params, plan, seed, total, device)
    step = make_step(cfg)

    def segment(state, a: int, b: int):
        return run_segment(step, state, plan_t, a, b, collect_events, cfg.n)

    if params.CHECKPOINT_EVERY > 0:
        from distributed_membership_tpu_torch.runtime.checkpoint import (
            chunked_run)
        return chunked_run(params, seed, total, device=device,
                           init_carry=lambda: init_state(cfg.n, device),
                           segment_fn=segment,
                           collect_events=collect_events,
                           event_type=TickEvents)
    state, events, _ = segment(init_state(cfg.n, device), 0, total)
    return state, events


@register("tpu")
def run_tpu(params: Params, log: Optional[EventLog] = None,
            seed: Optional[int] = None, device="cuda") -> RunResult:
    t0 = _time.time()
    seed = params.SEED if seed is None else seed
    log = log if log is not None else EventLog()
    plan = resolve_plan(params, _pyrandom.Random(f"app:{seed}"))
    final_state, events = run_scan(params, plan, seed, device)
    events_to_log(params, plan, events, log)
    return RunResult(
        params=params, log=log, sent=events.sent.T, recv=events.recv.T,
        failed_indices=plan.failed_indices if plan.fail_time is not None
        else [],
        fail_time=plan.fail_time, wall_seconds=_time.time() - t0,
        extra={"final_state": final_state})
