"""`tpu_sparse` backend: bounded member views for large N (the JAX
package's ``backends/tpu_sparse.py``), and the parts the hash backends
share: the per-tick event record, the seed-burst cap, dbg.log
reconstruction from events, and the run tail (with the scenario oracle's
report).

Each node keeps ``M = VIEW_SIZE`` slots ``(member id, heartbeat,
timestamp)`` and gossips ``G = GOSSIP_LEN`` of them to ``FANOUT``
targets per tick.  The receive is the sorted merge of
``ops/view_merge.merge_views``; messages in flight sit in per-receiver
hash-slotted mailboxes with max-combine (``scatter_mailbox``), one tick
of latency, lossless while ``MAILBOX_SIZE >= N``.  ``PROBES > 0`` adds
SWIM's direct probes: a round-robin window of ``P`` view slots is pinged
each tick through a probe mailbox, and each probed node acks with its
heartbeat the next tick through an ack mailbox.  All per-tick work is
static-shaped tensor code on the run's device; the random streams are
the JAX step's (``ops/threefry.py``), so the same seed gives the same
state at every tick.

``JOIN_MODE: warm`` starts every node in the group with a random M-slot
neighbourhood; staggered and batch joins run the introducer handshake.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random as _pyrandom
import time as _time
from typing import NamedTuple, Optional

import numpy as np
import torch

from distributed_membership_tpu_torch.addressing import INTRODUCER_INDEX
from distributed_membership_tpu_torch.backends import RunResult, register
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.eventlog import EventLog
from distributed_membership_tpu_torch.observability.aggregates import (
    AggStats, detection_summary, init_agg, update_agg)
from distributed_membership_tpu_torch.observability.timeline import (
    TimelineRecorder)
from distributed_membership_tpu_torch.ops.sampling import sample_k_indices
from distributed_membership_tpu_torch.ops.threefry import (
    Key, bernoulli, bernoulli_at, randint, split, uniform)
from distributed_membership_tpu_torch.ops.view_merge import (
    EMPTY, count_at, merge_views, scatter_mailbox, unpack_mailbox)
from distributed_membership_tpu_torch.runtime.failures import (
    PlanTensors, log_failures, make_run_key, plan_tensors, resolve_plan)

I32 = torch.int32
I64 = torch.int64
SEED_CAP = 8  # max JOINREQs the introducer answers with a burst per tick
_COPY_SALT = 0x2545F49   # salt offset of a message's second hashed copy


class SparseTickEvents(NamedTuple):
    join_ids: torch.Tensor   # [N, M] int32 id joined into this slot, -1 none
    rm_ids: torch.Tensor     # [N, M] int32 id removed from this slot, -1 none
    sent: torch.Tensor       # [N] int32
    recv: torch.Tensor       # [N] int32


class CompactEvents(NamedTuple):
    """Host form of a full-event run: ``(tick, logger, member)`` rows for
    joins and removals, in tick, logger, slot order, plus ``[T, N]``
    message counts."""
    joins: np.ndarray
    removes: np.ndarray
    sent: np.ndarray
    recv: np.ndarray
    total: int


def compact_tick(t: int, ids: torch.Tensor) -> np.ndarray:
    """``(t, row, id)`` rows of one tick's event plane (-1 = none)."""
    ids = ids.cpu().numpy()
    rows, slots = np.nonzero(ids >= 0)
    return np.stack([np.full(rows.shape, t, np.int64), rows.astype(np.int64),
                     ids[rows, slots].astype(np.int64)], axis=1)


def events_to_log(params, plan, events: CompactEvents, log) -> None:
    """Reconstruct dbg.log from the compacted events (the JAX
    ``events_to_log``).  Cold joins add each node's start line in
    descending index order and the introducer's ``@@time`` line every 500
    ticks; under warm join every node starts in the group, so neither is
    logged."""
    n = params.EN_GPSZ
    starts = [params.start_tick(i) for i in range(n)]
    for i in range(n):
        log.log(i + 1, 0, "APP")
    join_by_tick: dict = {}
    for t, i, j in events.joins:
        join_by_tick.setdefault(int(t), []).append((int(i), int(j)))
    remove_by_tick: dict = {}
    for t, i, j in events.removes:
        remove_by_tick.setdefault(int(t), []).append((int(i), int(j)))
    intro_failed = (plan.fail_time is not None
                    and INTRODUCER_INDEX in plan.failed_indices)
    warm = params.JOIN_MODE == "warm"
    for t in range(events.total):
        if not warm:
            for i in range(n - 1, -1, -1):
                if starts[i] == t:
                    log.log(i + 1, t, "Starting up group..."
                            if i == INTRODUCER_INDEX else "Trying to join...")
        for i, j in join_by_tick.get(t, ()):
            log.node_add(i + 1, j + 1, t)
        for i, j in remove_by_tick.get(t, ()):
            log.node_remove(i + 1, j + 1, t)
        if (not warm and t % 500 == 0 and t > starts[INTRODUCER_INDEX]
                and not (intro_failed and t > plan.fail_time)):
            log.log(INTRODUCER_INDEX + 1, t, f"@@time={t}")
        if plan.fail_time == t:
            log_failures(plan, log, t)


def finish_run(params, plan, log, run_scan_fn, t0: float, seed: int,
               device) -> RunResult:
    """Run the tick loop in the resolved event mode, then either rebuild
    dbg.log (full) or summarize the on-device aggregates (agg).  Under
    ``TELEMETRY: scalars|hist`` the per-tick series land in
    ``extra["timeline"]`` and, with ``TELEMETRY_DIR``, in its
    ``timeline.jsonl`` (and in agg mode the detection summary in its
    ``summary.json``).  A general scenario's oracle report lands in
    ``extra["scenario_report"]`` and ``TELEMETRY_DIR/scenario.json``."""
    aggregate = params.resolved_event_mode() == "agg"
    recorder = (TimelineRecorder(params.TELEMETRY_DIR or None)
                if params.TELEMETRY in ("scalars", "hist") else None)
    final_state, events = run_scan_fn(params, plan, seed, device,
                                      collect_events=not aggregate,
                                      telemetry=recorder)
    failed = plan.failed_indices if plan.fail_time is not None else []
    if aggregate:
        if plan.fail_time is not None:
            log_failures(plan, log, plan.fail_time)
        fail_mask = np.zeros((params.EN_GPSZ,), bool)
        fail_mask[failed] = True
        summary = detection_summary(final_state.agg, fail_mask,
                                    plan.fail_time)
        if params.BACKEND.startswith("tpu_hash"):
            # Whether probe traffic is charged to the prober's row
            # (tpu_hash.probe_attribution_exact), in the summary itself.
            from distributed_membership_tpu_torch.backends.tpu_hash import (
                probe_attribution_exact)
            summary["approx_probe_attribution"] = (
                not probe_attribution_exact(params))
        sent = final_state.agg.sent_total.cpu().numpy()[:, None]
        recv = final_state.agg.recv_total.cpu().numpy()[:, None]
        extra = {"final_state": final_state, "aggregate": True,
                 "detection_summary": summary}
    else:
        events_to_log(params, plan, events, log)
        sent = events.sent.T
        recv = events.recv.T
        extra = {"final_state": final_state}
    if plan.scenario is not None:
        # The scenario oracle (scenario/oracle.py): the run graded against
        # its schedule from what it recorded -- the telemetry series, else
        # the dbg.log events -- and its final state; beside the timeline
        # as scenario.json.
        from distributed_membership_tpu_torch.scenario.oracle import (
            scenario_report)
        report = scenario_report(
            plan.scenario, params, final_state=final_state,
            summary=extra.get("detection_summary"),
            timeline=recorder.series() if recorder is not None else None,
            dbg_text=log.dbg_text() if not aggregate else None)
        extra["scenario_report"] = report
        if params.TELEMETRY_DIR:
            with open(os.path.join(params.TELEMETRY_DIR, "scenario.json"),
                      "w") as fh:
                json.dump(report, fh, indent=1)
    if recorder is not None:
        extra["timeline"] = recorder.series()
        extra["timeline_path"] = recorder.path
        if params.TELEMETRY_DIR and aggregate:
            # The detection verdicts beside the series they reconcile
            # with, for scripts/run_report.py.
            with open(os.path.join(params.TELEMETRY_DIR, "summary.json"),
                      "w") as fh:
                json.dump(extra["detection_summary"], fh, indent=1)
    return RunResult(
        params=params, log=log, sent=sent, recv=recv,
        failed_indices=failed, fail_time=plan.fail_time,
        wall_seconds=_time.time() - t0, extra=extra)


# ---------------------------------------------------------------------------
# The bounded-view step

class SparseState(NamedTuple):
    """The JAX ``SparseState``, field for field: the packed mailboxes are
    int32 tensors holding the u32 bits."""
    slot_id: torch.Tensor    # [N, M] int32, EMPTY = free
    slot_hb: torch.Tensor    # [N, M] int32
    slot_ts: torch.Tensor    # [N, M] int32
    started: torch.Tensor    # [N] bool
    in_group: torch.Tensor   # [N] bool
    failed: torch.Tensor     # [N] bool
    self_hb: torch.Tensor    # [N] int32
    mail: torch.Tensor       # [N, Q] packed (hb * N + id + 1), 0 = empty
    pmail: torch.Tensor      # [N, Qp] probe mailbox (prober id + 1)
    amail: torch.Tensor      # [N, Qa] ack mailbox, packed as mail
    joinreq_infl: torch.Tensor   # [N] bool
    joinrep_infl: torch.Tensor   # [N] bool
    pending_recv: torch.Tensor   # [N] int32
    agg: AggStats            # updated only in EVENT_MODE agg


@dataclasses.dataclass(frozen=True)
class SparseConfig:
    n: int
    m: int          # view slots per node
    q: int          # mailbox slots per node
    g: int          # entries piggybacked per gossip message
    tfail: int
    tremove: int
    fanout: int
    drop_prob: float
    probes: int = 0  # direct probes per tick (0 = pure gossip)
    qp: int = 16     # probe-mailbox slots
    qa: int = 16     # ack-mailbox slots
    seed_cap: int = SEED_CAP  # max JOINREQs answered with a burst per tick
    collect_events: bool = True


def auto_mailbox_size(n: int, m: int, g: int, fanout: int) -> int:
    """Default Q: lossless (== N) while affordable, else sized so the
    expected distinct incoming ids per tick (~ fanout * G) hash with low
    collision."""
    if n <= 1024:
        return n
    return max(256, 4 * fanout * g)


def init_state(cfg: SparseConfig, device) -> SparseState:
    n, m = cfg.n, cfg.m
    i32 = dict(dtype=I32, device=device)
    no = dict(dtype=torch.bool, device=device)
    return SparseState(
        slot_id=torch.full((n, m), EMPTY, **i32),
        slot_hb=torch.zeros((n, m), **i32),
        slot_ts=torch.zeros((n, m), **i32),
        started=torch.zeros((n,), **no),
        in_group=torch.zeros((n,), **no),
        failed=torch.zeros((n,), **no),
        self_hb=torch.zeros((n,), **i32),
        mail=torch.zeros((n, cfg.q), **i32),
        pmail=torch.zeros((n, cfg.qp), **i32),
        amail=torch.zeros((n, cfg.qa), **i32),
        joinreq_infl=torch.zeros((n,), **no),
        joinrep_infl=torch.zeros((n,), **no),
        pending_recv=torch.zeros((n,), **i32),
        agg=init_agg(n, device),
    )


def init_state_warm(cfg: SparseConfig, key: Key, device) -> SparseState:
    """Every node in the group at t=0 with itself and M-1 random
    neighbours ``i + U[1, N-1] mod N`` (hb 0, ts 0), drawn with
    replacement; the first tick's merge collapses duplicates."""
    n, m = cfg.n, cfg.m
    st = init_state(cfg, device)
    idx = torch.arange(n, dtype=I32, device=device)
    offs = randint(key, (n, m - 1), 1, max(n, 2), device)
    nbrs = (idx[:, None] + offs) % n
    return st._replace(
        slot_id=torch.cat([idx[:, None], nbrs], dim=1).to(I32),
        started=torch.ones((n,), dtype=torch.bool, device=device),
        in_group=torch.ones((n,), dtype=torch.bool, device=device))


def _top_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of ``lax.top_k(x, k)`` along the last axis: largest
    first, ties lowest index first (a stable descending sort)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def make_step(cfg: SparseConfig):
    """The per-tick transition (the JAX ``make_step``):
    ``step(state, t, key, plan) -> (state, SparseTickEvents)`` with ``t``
    a host int, ``key`` the tick key and ``plan`` the run's PlanTensors.
    The drop coins are drawn only on ticks inside the drop window: the
    JAX step draws them every tick and masks them with the window, and
    every stream comes from its own split key, so the bits are the
    same."""
    from distributed_membership_tpu_torch.backends.tpu_hash import (
        join_plane)
    n, m, g = cfg.n, cfg.m, cfg.g
    intro = INTRODUCER_INDEX
    k_max = min(cfg.fanout, m)
    use_drop = cfg.drop_prob > 0.0
    p_drop = cfg.drop_prob

    def step(state: SparseState, t: int, key: Key, plan: PlanTensors):
        dev = state.slot_id.device
        idx = torch.arange(n, dtype=I64, device=dev)
        (k_targets, k_entries, k_drop, k_ctrl,
         _k_probe, k_drop_p) = split(key, 6)
        coins = use_drop and plan.drop_active(t)
        jp = join_plane(cfg, state, t, plan, idx,
                        ~bernoulli(k_ctrl, p_drop, (2, n), dev)
                        if coins else None)
        recv_mask, act = jp.recv_mask, jp.act
        rcol = recv_mask[:, None]

        # ---- receive: gossip and acks merge; probes to answer ----
        in_id, in_hb, in_valid = unpack_mailbox(state.mail, n)
        mail = torch.where(rcol, 0, state.mail)
        ack_tgt, _, ack_valid = unpack_mailbox(state.pmail, n)
        ack_valid = ack_valid & rcol
        pmail = torch.where(rcol, 0, state.pmail)
        a_id, a_hb, a_valid = unpack_mailbox(state.amail, n)
        amail = torch.where(rcol, 0, state.amail)
        in_id = torch.cat([in_id, a_id], dim=1)
        in_hb = torch.cat([in_hb, a_hb], dim=1)
        in_valid = torch.cat([in_valid, a_valid], dim=1) & rcol

        boot_row = (idx == intro) & (plan.start_ticks[intro] == t)
        mail = scatter_mailbox(mail, torch.full_like(idx, intro), idx,
                               torch.zeros_like(idx), jp.joiner_req,
                               n, salt=t)

        # ---- merge: mailbox + self refresh into the bounded view ----
        merged = merge_views(
            state.slot_id, state.slot_hb, state.slot_ts, in_id, in_hb,
            in_valid, idx, torch.where(boot_row, 0, jp.own_hb),
            jp.self_on, t, apply_row=recv_mask | boot_row)
        slot_id, slot_hb, slot_ts = (merged.slot_id, merged.slot_hb,
                                     merged.slot_ts)
        join_ids = torch.where(merged.join_mask, slot_id, EMPTY)
        # The introducer's boot self-insert is silent in the reference
        # (updateMyPos, MP1Node.cpp:308-322).
        join_ids = torch.where(boot_row[:, None]
                               & (join_ids == idx[:, None]), EMPTY, join_ids)

        # ---- TFAIL / TREMOVE sweep (MP1Node.cpp:429-446) ----
        present = slot_id != EMPTY
        difft = t - slot_ts
        stale = present & (difft >= cfg.tfail) & act[:, None]
        numfailed = stale.sum(1, dtype=I32)
        removes = stale & (difft >= cfg.tremove)
        rm_ids = torch.where(removes, slot_id, EMPTY)
        slot_id = torch.where(removes, EMPTY, slot_id)
        present = present & ~removes

        # ---- gossip (MP1Node.cpp:449-495) ----
        size = present.sum(1, dtype=I32)
        numpotential = size - 1 - numfailed
        fresh = present & (difft < cfg.tfail)
        is_self_slot = slot_id == idx[:, None]
        eligible = fresh & ~is_self_slot & act[:, None]
        in_seed = jp.seeds[slot_id[intro].clamp_min(0).to(I64)] & present[intro]
        eligible[intro] &= ~in_seed
        seed_burst_on = act[intro]
        n_seeds_row = torch.where((idx == intro) & seed_burst_on, jp.n_seeds,
                                  0)
        k_extra = (numpotential.clamp(max=cfg.fanout)
                   - n_seeds_row).clamp_min(0)
        tgt_slot, tgt_valid = sample_k_indices(
            uniform(k_targets, (n, m), dev), eligible, k_extra, k_max)
        tgt = slot_id.gather(1, tgt_slot)

        # Entries: every fresh one when G >= M, else self and a uniform
        # (G-1)-subset of the rest.
        if g >= m:
            e_ids, e_hbs, e_valid = slot_id, slot_hb, fresh
        else:
            scores = torch.where(is_self_slot, -1.0,
                                 uniform(k_entries, (n, m), dev))
            scores = torch.where(fresh, scores, 2.0)
            e_idx = _top_indices(-scores, g)
            e_valid = fresh.gather(1, e_idx)
            e_ids = slot_id.gather(1, e_idx)
            e_hbs = slot_hb.gather(1, e_idx)
        g_eff = e_ids.shape[1]
        shape3 = (n, k_max, g_eff)
        msg_valid = tgt_valid[:, :, None] & e_valid[:, None, :]
        k_drop_f, k_drop_s = split(k_drop) if use_drop else (None, k_drop)
        if coins:
            msg_valid = msg_valid & ~bernoulli(k_drop_f, p_drop, shape3, dev)
        mail = scatter_mailbox(mail, tgt[:, :, None].expand(shape3),
                               e_ids[:, None, :].expand(shape3),
                               e_hbs[:, None, :].expand(shape3), msg_valid,
                               n, salt=t)
        sent_tick = (msg_valid.sum((1, 2), dtype=I32) + jp.sent_req
                     + jp.sent_rep)
        recv_add = count_at(tgt, tgt_valid, msg_valid.sum(2, dtype=I32), n)

        # Introducer burst to this tick's joiners: its full fresh view
        # (sendMemberList to each newNode, MP1Node.cpp:240-242,454).
        seed_idx = _top_indices(jp.seeds.to(I32), min(cfg.seed_cap, n))
        seed_valid = jp.seeds[seed_idx] & seed_burst_on
        burst_valid = seed_valid[:, None] & fresh[intro][None, :]
        if coins:
            burst_valid = burst_valid & ~bernoulli(
                k_drop_s, p_drop, burst_valid.shape, dev)
        shape_b = burst_valid.shape
        mail = scatter_mailbox(mail, seed_idx[:, None].expand(shape_b),
                               slot_id[intro][None, :].expand(shape_b),
                               slot_hb[intro][None, :].expand(shape_b),
                               burst_valid, n, salt=t)
        sent_tick[intro] += burst_valid.sum(dtype=I32)
        recv_add.index_add_(0, seed_idx, burst_valid.sum(1, dtype=I32)
                            * seed_valid.to(I32))

        # ---- SWIM probes: round-robin window of P slots ----
        # The JAX step masks [N, M] probe and [N, Qa] ack planes; only the
        # window's P columns can probe and only the due acks send, so the
        # port scatters those alone (a scatter-max and its counts do not
        # depend on which masked-out entries ride along), and draws their
        # coins at their flat indices of the JAX draws.
        if cfg.probes > 0:
            cols = ((t * cfg.probes + torch.arange(cfg.probes, device=dev))
                    % m if cfg.probes < m else torch.arange(m, device=dev))
            p_valid = (present[:, cols] & ~is_self_slot[:, cols]
                       & act[:, None])
            p_tgt = slot_id[:, cols]
            due = (ack_valid & act[:, None]).reshape(-1).nonzero()[:, 0]
            if coins:
                kd1, kd2 = split(k_drop_p)
                p_valid = p_valid & ~bernoulli_at(
                    kd1, p_drop, idx[:, None] * m + cols[None, :], n * m)
                due = due[~bernoulli_at(kd2, p_drop, due, n * cfg.qa)]
            own_id_p = idx[:, None].expand(p_tgt.shape)
            # Lossy probe/ack slot maps (Qp/Qa < N) send each message
            # twice with independent hashes; duplicates merge
            # idempotently.
            p_copies = 1 if cfg.qp >= n else 2
            for c in range(p_copies):
                pmail = scatter_mailbox(pmail, p_tgt, own_id_p,
                                        torch.zeros_like(p_tgt), p_valid, n,
                                        salt=t + c * _COPY_SALT)
            mail = scatter_mailbox(mail, p_tgt, own_id_p,
                                   jp.own_hb[:, None].expand(p_tgt.shape),
                                   p_valid, n, salt=t)
            # Acks: my (id, heartbeat) back to each due prober.
            acker = due // cfg.qa
            prober = ack_tgt.reshape(-1)[due]
            sent = torch.ones_like(due, dtype=torch.bool)
            a_copies = 1 if cfg.qa >= n else 2
            for c in range(a_copies):
                amail = scatter_mailbox(amail, prober, acker,
                                        jp.own_hb[acker], sent, n,
                                        salt=t + c * _COPY_SALT)
            sent_tick = (sent_tick + p_valid.sum(1, dtype=I32) * p_copies
                         + count_at(acker, sent, a_copies, n))
            recv_add = (recv_add + count_at(p_tgt, p_valid, p_copies, n)
                        + count_at(prober, sent, a_copies, n))

        failed = (state.failed | plan.fail_mask if t == plan.fail_time
                  else state.failed)
        agg = state.agg
        out = SparseTickEvents(join_ids, rm_ids, sent_tick, jp.recv_tick)
        if not cfg.collect_events:
            agg = update_agg(
                agg, t=t, join_ids=join_ids, rm_ids=rm_ids,
                view_ids=slot_id, view_present=present,
                fail_mask=plan.fail_mask, fail_time=plan.fail_time,
                sent_tick=sent_tick, recv_tick=jp.recv_tick)
            out = SparseTickEvents(*(x.sum(dtype=I32) for x in (
                join_ids != EMPTY, rm_ids != EMPTY, sent_tick,
                jp.recv_tick)))
        new_state = SparseState(
            slot_id, slot_hb, slot_ts, jp.started, jp.in_group, failed,
            jp.self_hb, mail, pmail, amail, jp.joinreq_infl,
            jp.joinrep_infl, jp.pending_recv + recv_add, agg)
        return new_state, out

    return step


def make_config(params: Params, collect_events: bool = True) -> SparseConfig:
    """The JAX ``make_config``: M (``VIEW_SIZE``, 0 = N), G, the mailbox
    sizes (lossless up to N = 1024, else sized to the traffic) and the
    seed-burst cap (all N - 1 joiners under batch join)."""
    n = params.EN_GPSZ
    m = params.VIEW_SIZE if params.VIEW_SIZE > 0 else n
    g = params.GOSSIP_LEN if params.GOSSIP_LEN > 0 else m
    q = (params.MAILBOX_SIZE if params.MAILBOX_SIZE > 0
         else auto_mailbox_size(n, m, g, params.FANOUT))
    qp = qa = n if n <= 1024 else max(128, 32 * params.PROBES)
    seed_cap = n if params.JOIN_MODE == "batch" else SEED_CAP
    return SparseConfig(
        n=n, m=m, q=q, g=min(g, m), tfail=params.TFAIL,
        tremove=params.TREMOVE, fanout=params.FANOUT,
        drop_prob=params.effective_drop_prob(),
        probes=params.PROBES, qp=qp, qa=qa, seed_cap=seed_cap,
        collect_events=collect_events)


def run_segment(step, state, plan_t: PlanTensors, a: int, b: int,
                collect_events: bool, n: int):
    """Ticks ``[a, b)``: ``(state, events, None)`` with ``events`` the
    segment's CompactEvents (full mode) or its ``[b - a]`` int32 totals
    (agg mode), as ``runtime/checkpoint.chunked_run`` takes them."""
    joins, removes, sent, recv, totals = [], [], [], [], []
    for t in range(a, b):
        state, out = step(state, t, plan_t.tick_key(t), plan_t)
        if collect_events:
            joins.append(compact_tick(t, out.join_ids))
            removes.append(compact_tick(t, out.rm_ids))
            sent.append(out.sent)
            recv.append(out.recv)
        else:
            totals.append(torch.stack(tuple(out)))
    if not collect_events:
        cols = (torch.stack(totals).cpu().numpy().T if totals
                else np.zeros((4, 0), np.int32))
        return state, SparseTickEvents(*(np.ascontiguousarray(c)
                                         for c in cols)), None
    empty = np.zeros((0, 3), np.int64)
    zeros = np.zeros((0, n), np.int32)
    return state, CompactEvents(
        np.concatenate(joins) if joins else empty,
        np.concatenate(removes) if removes else empty,
        torch.stack(sent).cpu().numpy() if sent else zeros,
        torch.stack(recv).cpu().numpy() if recv else zeros, b - a), None


def run_scan(params: Params, plan, seed: int, device,
             collect_events: bool = True, total_time: Optional[int] = None,
             telemetry=None):
    """The whole run: ``(final_state, events)``, in ``CHECKPOINT_EVERY``
    segments when set (runtime/checkpoint.py).  ``telemetry`` is taken
    for ``finish_run``'s call and unused: TELEMETRY is a ring-step knob
    (``Params.validate``)."""
    cfg = make_config(params, collect_events)
    total = total_time if total_time is not None else params.TOTAL_TIME
    # The effective run length can exceed TOTAL_TIME (sweeps):
    # check the u32 (heartbeat, id) packing against it.
    params.validate_sparse_packing(total)
    warm = params.JOIN_MODE == "warm"
    plan_t = plan_tensors(params, plan, seed, total, device)
    warm_key = make_run_key(params, seed ^ 0x5EED)
    step = make_step(cfg)

    def init_carry():
        return (init_state_warm(cfg, warm_key, device) if warm
                else init_state(cfg, device))

    def segment(state, a: int, b: int):
        return run_segment(step, state, plan_t, a, b, collect_events, cfg.n)

    if params.CHECKPOINT_EVERY > 0:
        from distributed_membership_tpu_torch.runtime.checkpoint import (
            chunked_run)
        return chunked_run(params, seed, total, device=device,
                           init_carry=init_carry, segment_fn=segment,
                           collect_events=collect_events)
    state, events, _ = segment(init_carry(), 0, total)
    return state, events


@register("tpu_sparse")
def run_tpu_sparse(params: Params, log: Optional[EventLog] = None,
                   seed: Optional[int] = None, device="cuda") -> RunResult:
    t0 = _time.time()
    seed = params.SEED if seed is None else seed
    log = log if log is not None else EventLog()
    plan = resolve_plan(params, _pyrandom.Random(f"app:{seed}"))
    return finish_run(params, plan, log, run_scan, t0, seed, device)
