"""``tpu_hash_sharded`` backend, ring exchange, warm or cold joins
(counterpart of the JAX package's ``backends/tpu_hash_sharded.py``).

The JAX backend shards the node rows of the ``tpu_hash`` state over a
device mesh: shard ``d`` owns rows ``[d*L, (d+1)*L)``, runs the ring step
on them inside ``shard_map`` and reaches the other shards through
collectives.  The port holds the mesh on one device
(:class:`~distributed_membership_tpu_torch.parallel.mesh.LocalMesh`): the
state keeps the flat ``[N, ...]`` layout, every per-shard computation runs
once over all rows, and each collective is a tensor operation on that
layout.  With ``MESH_SHAPE`` unset the mesh has one shard, which is what a
user runs on one card; ``MESH_SHAPE: 8`` (or ``2x4``) runs the eight-shard
program of the JAX package's eight-device mesh, bit for bit.

Per tick (``make_ring_sharded_step``), as in the JAX ring step:

* the per-shard RNG plan (ops/rng_plan.py ``sharded_ring_rng``, each
  shard's streams from ``fold_in(key, shard)``, concatenated in shard
  order);
* under cold joins, the join control plane (tpu_hash.py ``join_plane``).
  The JAX step computes it replicated on every shard from the shared
  tick key, with one ``all_gather`` of the in-flight JOINREQ bits and the
  introducer's row broadcast by ``psum`` for the seed burst; on the flat
  layout those collectives are the identity, so it is the single-chip
  computation with the sharded step's replicated coin streams;
* the ack candidates from one gathered probe table (``all_gather``);
* the receive pass -- K1 (ops/fused_receive.py) over all rows, with
  global row ids;
* gossip as torus-product shifts ``u = b*L + c``: per shift the sender
  masks its payload (fanout, drop coins), the block hop routes it to
  shard ``d + b`` (``block_send``), and one pass of K4
  (ops/fused_gossip.py ``gossip_fused_stacked``) rolls every shift's
  payload by ``c`` rows within each shard, aligns its columns by that
  shard's ``s1``/``s2`` and maxes it into the mailbox;
* the probe window and the FastAgg row partials -- K3
  (ops/fused_probe.py) over all rows -- then the message counters
  (exact per-target histograms through ``psum_scatter``, or the prober's
  row with the orphans re-credited to the globally first flushing row);
* per-shard FastAgg partials, reduced once after the run
  (:func:`reduce_fast_agg`), or after each segment under
  ``CHECKPOINT_EVERY`` (runtime/checkpoint.py; ``MEGA_TICKS`` blocks
  too), or per-tick event planes in full event mode;
* under ``TELEMETRY`` the flight recorder's record of the tick, over all
  rows (the JAX step's psums are sums over the flat layout).

``FOLDED`` runs the sharded folded step (backends/tpu_hash_folded.py
``make_ring_sharded_folded_step``, K5-K7 over every shard) behind the JAX
``sharded_config`` gates on the per-shard rows.

``EVENT_MODE: agg`` with more than 8 failed ids folds into ``AggStats``
over all rows (the JAX step's per-shard partials and their reduction in
one update), started from zero per segment and merged under
``CHECKPOINT_EVERY``; ``PROBE_IO: none`` zeroes the probe-recv and
ack-send counters.  ``PROBE_IO approx_lag``, ``SHIFT_SET`` and
``ENFORCE_BUFFSIZE`` raise the JAX package's ValueErrors.

Refused with ``NotImplementedError`` naming the ROADMAP.md item: the
scatter exchange (the JAX ``make_sharded_step``, which ``EXCHANGE: auto``
picks under cold joins), ``EXCHANGE_MODE: batched`` and ``PROBE_GATHER:
split`` (item 6c).  Refused by design, as on ``tpu_hash``: on CUDA
``VIEW_SIZE % 128 != 0`` outside the folded layout, fewer than 8 folded
plane rows per shard, and a pinned ``FUSED_*: 0``.
"""

from __future__ import annotations

import dataclasses
import random as _pyrandom
import time as _time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from distributed_membership_tpu_torch.addressing import INTRODUCER_INDEX
from distributed_membership_tpu_torch.backends import RunResult, register
from distributed_membership_tpu_torch.backends.tpu_hash import (
    I32, I64, HashConfig, _credit_orphan_recvs_sharded, _gathered_act,
    _gathered_flush, _gathered_hb, _pack_probe_table, _refuse, _refuse_on,
    coin_at,
    count_ctrl_dropped, failed_after, join_plane, joinreq_to_intro,
    make_config, no_coin, pack_u, plan_fail_ids, plan_scenario,
    resolve_mega_pack, restart_wipe, run_segment, run_ticks, seed_burst,
    tick_faults, tick_telemetry, uses_drop, warm_view, will_flush_of)
from distributed_membership_tpu_torch.backends.tpu_hash_folded import (
    folded_supported, init_local_state_warm_folded,
    make_ring_sharded_folded_step)
from distributed_membership_tpu_torch.backends.tpu_sparse import (
    SparseTickEvents, finish_run)
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.eventlog import EventLog
from distributed_membership_tpu_torch.observability.aggregates import (
    FastAgg, init_agg, init_fast_agg, merge_agg, update_agg,
    update_fast_agg)
from distributed_membership_tpu_torch.observability.timeline import (
    PHASE_ACK, PHASE_AGG, PHASE_COLLECTIVE, PHASE_GOSSIP, PHASE_PROBE,
    PHASE_RECEIVE, PHASE_TELEMETRY)
from distributed_membership_tpu_torch.ops.fused_gossip import (
    gossip_fused_stacked)
from distributed_membership_tpu_torch.ops.fused_probe import (
    probe_window_fused)
from distributed_membership_tpu_torch.ops.fused_receive import receive_fused
from distributed_membership_tpu_torch.ops.rng_plan import sharded_ring_rng
from distributed_membership_tpu_torch.ops.threefry import Key, fold_in, randint
from distributed_membership_tpu_torch.ops.view_merge import (
    EMPTY, STRIDE, member_of, to_bits)
from distributed_membership_tpu_torch.parallel.mesh import (
    LocalMesh, mesh_shape)
from distributed_membership_tpu_torch.runtime.failures import (
    FailurePlan, PlanTensors, make_run_key, plan_tensors, resolve_plan)
from distributed_membership_tpu_torch.scenario.compile import cross_group


class ShardedHashState(NamedTuple):
    """The JAX ``ShardedHashState`` leaves in their global shapes (the
    shards' rows concatenated); u32 planes as int32 bits.  During a run in
    agg mode ``agg`` holds per-shard FastAgg partials (``init_fast_agg(...,
    shards=D)``); the finished run's is reduced (:func:`reduce_fast_agg`)."""
    view: torch.Tensor          # [N, S]
    view_ts: torch.Tensor       # [N, S]
    started: torch.Tensor       # [N] bool
    in_group: torch.Tensor      # [N] bool
    failed: torch.Tensor        # [N] bool
    self_hb: torch.Tensor       # [N] int32
    mail: torch.Tensor          # [N, S]
    amail: torch.Tensor         # [D, 1] placeholder (scatter exchange)
    pmail: torch.Tensor         # [D, 1] placeholder (scatter exchange)
    joinreq_infl: torch.Tensor  # [N] bool
    joinrep_infl: torch.Tensor  # [N] bool
    pending_recv: torch.Tensor  # [N] int32
    agg: NamedTuple             # FastAgg, or the AggStats placeholder
    probe_ids1: torch.Tensor    # [N, P] ids probed last tick (id + 1)
    probe_ids2: torch.Tensor    # [N, P] ids probed two ticks ago
    act_prev: torch.Tensor      # [N] bool


def init_local_state(cfg: HashConfig, mesh: LocalMesh) -> ShardedHashState:
    n, s, d = cfg.n, cfg.s, mesh.size
    dev = mesh.device
    i32 = dict(dtype=I32, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    probe_shape = (n, cfg.probes) if cfg.probes > 0 else (d, 1)
    return ShardedHashState(
        view=torch.zeros((n, s), **i32),
        view_ts=torch.zeros((n, s), **i32),
        started=torch.zeros((n,), **b),
        in_group=torch.zeros((n,), **b),
        failed=torch.zeros((n,), **b),
        self_hb=torch.zeros((n,), **i32),
        mail=torch.zeros((n, s), **i32),
        amail=torch.zeros((d, 1), **i32),
        pmail=torch.zeros((d, 1), **i32),
        joinreq_infl=torch.zeros((n,), **b),
        joinrep_infl=torch.zeros((n,), **b),
        pending_recv=torch.zeros((n,), **i32),
        # FastAgg: per-shard partials.  AggStats in agg mode: the global
        # value (on the flat layout the sum, min/max and gathers of the
        # JAX step's per-shard partials are one update over all rows).
        # Full event mode carries one shard's never-updated placeholder.
        agg=(init_fast_agg(len(cfg.fail_ids), n, dev, shards=d)
             if cfg.fast_agg else
             init_agg(n, dev) if not cfg.collect_events
             else init_agg(n, dev, rows=mesh.rows_per_shard(n))),
        probe_ids1=torch.zeros(probe_shape, **i32),
        probe_ids2=torch.zeros(probe_shape, **i32),
        act_prev=torch.zeros((n,), **b),
    )


def init_local_state_warm(cfg: HashConfig, mesh: LocalMesh,
                          key: Key) -> ShardedHashState:
    """Every node in the group at t=0 with itself and ~S/2 random
    neighbours (JAX ``init_local_state_warm``): shard ``d`` draws its rows'
    neighbour offsets from ``fold_in(key, d)``."""
    n, d = cfg.n, mesh.size
    n_local = mesh.rows_per_shard(n)
    fill = max(cfg.s // 2, 1)
    st = init_local_state(cfg, mesh)
    offs = torch.cat([randint(fold_in(key, me), (n_local, fill), 1,
                              max(n, 2), mesh.device) for me in range(d)])
    ones = torch.ones((n,), dtype=torch.bool, device=mesh.device)
    return st._replace(view=warm_view(cfg, st.view, offs), started=ones,
                       in_group=ones.clone())


def make_ring_sharded_step(cfg: HashConfig, mesh: LocalMesh):
    """``step(state, t, key, plan) -> (state, SparseTickEvents)``: the JAX
    ``make_ring_sharded_step`` (``cold_join`` under JOIN_MODE staggered
    or batch) with the legacy exchange, on every shard of ``mesh`` at
    once."""
    n, s, g, p_cnt = cfg.n, cfg.s, cfg.g, cfg.probes
    intro = INTRODUCER_INDEX
    d = mesh.size
    n_local = mesh.rows_per_shard(n)
    k_max = min(cfg.fanout, s)
    p_red = 1 if cfg.qp >= n else 2
    cstride = STRIDE % s
    # The wrapped rows' column shift equals the unwrapped one iff this.
    single_col = (n_local * STRIDE) % s == 0
    if p_cnt >= s:
        raise ValueError("ring mode needs PROBES < VIEW_SIZE "
                         f"(got {p_cnt} >= {s})")
    if cfg.scenario is not None and cfg.cold_join:
        raise ValueError(
            "SCENARIO general events on tpu_hash_sharded require "
            "JOIN_MODE warm (the cold-join control plane does not "
            "model partitions/flakes)")
    use_drop = uses_drop(cfg)
    p_drop = float(np.float32(cfg.drop_prob))
    want_agg = cfg.fast_agg and not cfg.collect_events
    want_hist = cfg.telemetry_hist and p_cnt > 0
    fail_ids = cfg.fail_ids if want_agg else ()
    rng_kw = dict(n=n, n_local=n_local, s=s, g=g, k_max=k_max,
                  p_cnt=max(p_cnt, 0), seed_rows=min(cfg.seed_cap, n),
                  use_drop=use_drop, cold_join=cfg.cold_join)

    def total(x):
        return mesh.psum(mesh.shard_sums(x))

    def hist(tgt, valid, weight, shard):
        """Per-shard ``[D, N]`` histograms of ``tgt`` over the global ids
        (the JAX step's local ``.at[].add``), for ``psum_scatter``."""
        idx = torch.where(valid, tgt, n) + shard[:, None] * (n + 1)
        out = torch.zeros((d * (n + 1),), dtype=I32, device=tgt.device)
        out.index_add_(0, idx.reshape(-1), torch.full(
            (idx.numel(),), weight, dtype=I32, device=tgt.device))
        return out.view(d, n + 1)[:, :n]

    def step(state: ShardedHashState, t: int, key: Key, plan: PlanTensors):
        if t < 0:
            raise ValueError("ticks start at 0")
        dev = state.view.device
        rows = torch.arange(n, dtype=I64, device=dev)   # global row ids
        rng = sharded_ring_rng(key, range(d), device=dev, **rng_kw)
        # The scenario's tensors are replicated on every shard: each
        # shard's rows read them elementwise, with no collective.
        f = tick_faults(plan, t, rows, n, p_drop)
        coins = use_drop and plan.drop_active(t)
        # The coins that kill a message this tick, counted for TELEMETRY
        # (each replicated coin once, as the JAX step's local slices).
        dropped = [] if cfg.telemetry else None

        # ---- join control plane (inert under warm join), self refresh
        # (cold joins run the legacy plan only: the gate above)
        ctrl_drop = (rng.ctrl_u.reshape(2, n) < p_drop
                     if coins and cfg.cold_join else None)
        jp = join_plane(cfg, state, t, plan, rows,
                        None if ctrl_drop is None else ~ctrl_drop, f.held)
        if dropped is not None and ctrl_drop is not None:
            dropped.append(count_ctrl_dropped(jp, plan, t, rows, ctrl_drop))
        recv_mask, act, recv_tick = jp.recv_mask, jp.act, jp.recv_tick
        rcol = recv_mask[:, None]

        # ---- ack candidates (probes issued at t-2): one all_gather of
        # the packed probe table, one gather on [id2, tgt1] ----
        cand_full = torch.zeros((n, s), dtype=I32, device=dev)
        ack_recv_cnt = torch.zeros((n,), dtype=I32, device=dev)
        if p_cnt > 0:
            with record_function(PHASE_ACK):
                ids2 = state.probe_ids2
                id2 = (ids2.to(I64) - 1).clamp_min(0)
                ids1 = state.probe_ids1
                v1 = ids1 != 0
                tgt1 = (ids1.to(I64) - 1).clamp_min(0)
                vec = torch.where(state.act_prev, state.self_hb - 1, 0)
                will_flush = will_flush_of(plan, t, recv_mask, f)
                tbl_g = mesh.all_gather(_pack_probe_table(vec, will_flush,
                                                          act))
                will_flush_g = _gathered_flush(tbl_g)
                gcat = tbl_g[torch.cat([id2, tgt1], dim=1)]
                hb_ack = _gathered_hb(gcat[:, :p_cnt])
                probe_bits1 = gcat[:, p_cnt:]
                valid2 = (ids2 != 0) & (hb_ack > 0)
                if f.cuts_prev is not None:
                    # The ack crossed target -> prober during tick t-1.
                    valid2 &= ~cross_group(f.cuts_prev, id2, rows[:, None])
                p_ack = f.prob(t - 1, id2, rows[:, None])
                if not no_coin(p_ack):
                    coin = coin_at(rng.ack_u.reshape(n, p_cnt), p_ack)
                    if dropped is not None:
                        dropped.append((valid2 & coin).sum(dtype=I32))
                    valid2 = valid2 & ~coin
                cand = torch.where(valid2, to_bits(pack_u(cfg, hb_ack, id2)),
                                   0)
                ptr2 = ((t - 2) * p_cnt) % s
                cand_full[:, (ptr2 + torch.arange(p_cnt, device=dev))
                          % s] = cand
                ack_recv_cnt = (valid2 & rcol).sum(1, dtype=I32)

        # ---- receive (K1; row-local, so one launch covers every shard)
        with record_function(PHASE_RECEIVE):
            (view, view_ts, mail, join_mask, rm_ids, numfailed,
             size) = receive_fused(n, s, cfg.tfail, cfg.tremove, STRIDE, t,
                                   state.view, state.view_ts, state.mail,
                                   cand_full, recv_mask, act, jp.self_on,
                                   jp.self_val)
        if cfg.cold_join:
            mail = joinreq_to_intro(cfg, mail, jp.joiner_req, rows)
        present = view != 0
        cur_id = torch.where(present, member_of(view, n), EMPTY)
        difft = t - view_ts

        # ---- gossip: torus-product shifts u = b*L + c (K4) ----
        numpotential = size - 1 - numfailed
        fresh = present & (difft < cfg.tfail)
        k_eff = numpotential.clamp(max=cfg.fanout).clamp_min(0)
        if cfg.cold_join:
            # Seeded joiners take gossip slots on the introducer's row.
            k_eff = (k_eff - torch.where((rows == intro) & act, jp.n_seeds,
                                         0)).clamp_min(0)
        if g >= s:
            keep = fresh
        else:
            fresh_cnt = fresh.sum(1, dtype=I32)
            p_keep = torch.where(
                fresh_cnt > 1,
                (g - 1) / (fresh_cnt - 1).clamp_min(1).to(torch.float32),
                1.0)
            keep = fresh & ((rng.thin_u.reshape(n, s) < p_keep[:, None])
                            | (cur_id == rows[:, None]))
        keep = keep & act[:, None]
        sent_gossip = torch.zeros((n,), dtype=I32, device=dev)
        recv_add = torch.zeros((n,), dtype=I32, device=dev)
        if k_max > 0:
            u = rng.shift_draw.to(I64)
            b, c = u // n_local, u % n_local
            # Receiver slot = sender slot + delta * STRIDE with delta = b'L
            # + c, b' = b - D on shards me < b (block wrap), and c - L on
            # the rows l < c (row wrap): per shard and shift.
            me = torch.arange(d, dtype=I64, device=dev)[:, None]
            bp = torch.where(me < b, b - d, b)
            s1 = ((bp * n_local + c) % s * cstride % s).to(I32)
            s2 = ((bp * n_local + c - n_local) % s * cstride % s).to(I32)
            with record_function(PHASE_GOSSIP):
                payloads = torch.empty((k_max, n, s), dtype=I32, device=dev)
                for j in range(k_max):
                    m = keep & (j < k_eff)[:, None]
                    # Shift u sends global row i to (i + u) mod n.
                    dst = (rows + u[j]) % n
                    if f.cuts is not None:
                        m &= ~cross_group(f.cuts, rows, dst)[:, None]
                    p_g = f.prob(t, rows, dst)
                    if not no_coin(p_g):
                        coin = coin_at(rng.gossip_u[j].reshape(n, s), p_g)
                        if dropped is not None:
                            dropped.append((m & coin).sum(dtype=I32))
                        m &= ~coin
                    cnt = m.sum(1, dtype=I32)
                    sent_gossip += cnt
                    torch.mul(view, m, out=payloads[j])  # where(m, view, 0)
                    with record_function(PHASE_COLLECTIVE):  # the block hop
                        if d > 1:
                            payloads[j] = mesh.block_send(payloads[j], b[j])
                        recv_add += mesh.local_roll(
                            mesh.block_send(cnt, b[j]), c[j])
                mail = gossip_fused_stacked(n_local, s, k_max, single_col,
                                            mail, payloads, c.to(I32), s1,
                                            s2)
                del payloads
        sent_tick = sent_gossip + jp.sent_req + jp.sent_rep
        if cfg.cold_join:
            # The introducer's burst (its row broadcast, delivered by each
            # seed's owner), with the replicated burst coins.
            cap = min(cfg.seed_cap, n)
            burst_drop = ((rng.burst_u.reshape(cap, s) < p_drop) if coins
                          else None)
            mail, seed_idx, seed_valid, burst_valid = seed_burst(
                cfg, mail, view, fresh[intro], jp.seeds, act[intro],
                burst_drop)
            if dropped is not None and coins:
                dropped.append((seed_valid[:, None] & fresh[intro][None, :]
                                & burst_drop).sum(dtype=I32))
            sent_tick = sent_tick + torch.where(
                (rows == intro) & act, burst_valid.sum(dtype=I32), 0)
            recv_add.index_add_(0, seed_idx, burst_valid.sum(1, dtype=I32)
                                * seed_valid.to(I32))

        # ---- SWIM round-robin probing (K3; row-local, global ids) ----
        probe_ids1, probe_ids2 = state.probe_ids1, state.probe_ids2
        act_prev = state.act_prev
        pfo = None
        if p_cnt > 0:
            with record_function(PHASE_PROBE):
                pfo = probe_window_fused(
                    n, s, p_cnt, cfg.tfail, fail_ids, want_hist, want_agg,
                    t, (t * p_cnt) % s, 0, view,
                    view_ts if want_hist else None, act,
                    rm_ids if want_agg else None)
                window_ids = pfo["ids"]
                p_valid = window_ids != 0
                w_id = (window_ids.to(I64) - 1).clamp_min(0)
                if f.cuts is not None:
                    p_valid = p_valid & ~cross_group(f.cuts, rows[:, None],
                                                     w_id)
                p_pr = f.prob(t, rows[:, None], w_id)
                if not no_coin(p_pr):
                    coin = coin_at(rng.probe_u.reshape(n, p_cnt), p_pr)
                    if dropped is not None:
                        dropped.append((p_valid & coin).sum(dtype=I32))
                    p_valid = p_valid & ~coin
                probe_ids2 = probe_ids1
                probe_ids1 = torch.where(p_valid, window_ids, 0)
                act_prev = act
                sent_probes = p_valid.sum(1, dtype=I32) * p_red
                if cfg.count_probe_io:
                    # Exact per-target attribution: each shard's
                    # histograms over the global ids, summed and sliced
                    # back to owners.
                    shard = mesh.shard_of_rows(n)
                    ack_send = v1 & _gathered_act(probe_bits1)
                    recv_probe = mesh.psum_scatter(hist(tgt1, v1, p_red,
                                                        shard))
                    sent_ack = mesh.psum_scatter(hist(tgt1, ack_send, 1,
                                                      shard))
                elif cfg.probe_io_none:
                    recv_probe = sent_ack = torch.zeros_like(sent_probes)
                else:
                    per_prober = (v1 & _gathered_flush(probe_bits1)).sum(
                        1, dtype=I32) * p_red
                    recv_probe = _credit_orphan_recvs_sharded(
                        per_prober, will_flush, will_flush_g, rows, mesh)
                    sent_ack = (v1 & _gathered_act(probe_bits1)).sum(
                        1, dtype=I32)
                sent_tick = sent_tick + sent_probes + sent_ack
                recv_add = recv_add + recv_probe + ack_recv_cnt
        pending_recv = jp.pending_recv + recv_add

        if cfg.collect_events:
            agg = state.agg
            out = SparseTickEvents(
                torch.where(join_mask, cur_id, EMPTY).to(I32), rm_ids,
                sent_tick, recv_tick)
        elif not want_agg:
            # AggStats: the JAX step's per-shard partials reduced (psum,
            # pmin/pmax, all_gather) are the one update over every row.
            with record_function(PHASE_AGG):
                join_ids = torch.where(join_mask, cur_id, EMPTY)
                agg = update_agg(
                    state.agg, t=t, join_ids=join_ids, rm_ids=rm_ids,
                    view_ids=cur_id, view_present=present,
                    fail_mask=plan.fail_mask, fail_time=plan.fail_time,
                    sent_tick=sent_tick, recv_tick=recv_tick)
                out = SparseTickEvents(total(join_ids != EMPTY),
                                       total(rm_ids != EMPTY),
                                       total(sent_tick), total(recv_tick))
        else:
            with record_function(PHASE_AGG):
                # Per-shard partials of the probe pass's row sums.
                rm_cnt = (pfo["rm_cnt"] if pfo is not None
                          else (rm_ids >= 0).sum(1, dtype=I32))
                det = None
                if fail_ids:
                    det = (pfo["det"] if pfo is not None else torch.stack(
                        [(rm_ids == f).sum(1, dtype=I32) for f in fail_ids]))
                agg = update_fast_agg(
                    state.agg, t=t, fail_ids=fail_ids,
                    join_events=join_mask,
                    rm_total_tick=mesh.shard_sums(rm_cnt),
                    det_tick=(None if det is None else det.view(
                        len(fail_ids), d, n_local).sum(2, dtype=I32).t()),
                    any_true_rm=None if det is None else (det > 0).any(0),
                    view_ids=(cur_id if t == plan.fail_time and fail_ids
                              else None),
                    view_present=present, fail_time=plan.fail_time,
                    holder_failed=plan.fail_mask, sent_tick=sent_tick,
                    recv_tick=recv_tick, part=mesh.shard_sums)
                out = SparseTickEvents(total(join_mask), total(rm_cnt),
                                       total(sent_tick), total(recv_tick))
        # End-of-tick crash/leave/restart transitions, after the agg fold.
        new_state = restart_wipe(ShardedHashState(
            view, view_ts, jp.started, jp.in_group,
            failed_after(plan, t, state.failed, f), jp.self_hb, mail,
            state.amail, state.pmail, jp.joinreq_infl, jp.joinrep_infl,
            pending_recv, agg, probe_ids1, probe_ids2, act_prev),
            f, t, n, p_cnt)
        if not cfg.telemetry:
            return new_state, out
        with record_function(PHASE_TELEMETRY):
            rec = tick_telemetry(
                cfg, state.agg, agg, out, dropped, act=act,
                numfailed=numfailed, ack_recv_cnt=ack_recv_cnt,
                sent_gossip=sent_gossip, difft=difft, present=present,
                size=size, t=t, fail_time=plan.fail_time, pfo=pfo)
        return new_state, (out, rec)

    return step


def reduce_fast_agg(agg: FastAgg, mesh: LocalMesh) -> FastAgg:
    """Reduce per-shard FastAgg partials to the global value: sums of the
    counts and histogram, gathers of the per-row fields."""
    return FastAgg(
        det_count=mesh.psum(agg.det_count),
        trackers=mesh.psum(agg.trackers),
        tracker_obs=mesh.all_gather(agg.tracker_obs),
        det_obs=mesh.all_gather(agg.det_obs),
        lat_hist=mesh.psum(agg.lat_hist),
        join_total=mesh.psum(agg.join_total),
        rm_total=mesh.psum(agg.rm_total),
        sent_total=mesh.all_gather(agg.sent_total),
        recv_total=mesh.all_gather(agg.recv_total),
    )


def sharded_config(params: Params, collect_events: bool, fail_ids: tuple,
                   n_local: int, device="cpu", scenario=None) -> HashConfig:
    """``tpu_hash.make_config`` plus the JAX ``sharded_config`` gates on
    the per-shard rows (same messages), and the refusals of what the
    port's sharded steps do not run yet.  Where the rows of a shard do
    not fold, a pinned ``FOLDED: 1`` raises and ``-1`` falls back to the
    natural layout, as in the JAX package; on CUDA the natural kernels
    then need ``VIEW_SIZE % 128 == 0``, and the folded kernels at least 8
    plane rows per shard (the JAX package runs its unfused folded path
    below that, which the port runs on the CPU only)."""
    if params.resolved_exchange() != "ring":
        _refuse("the scatter exchange on tpu_hash_sharded "
                "(make_sharded_step)", "Queue 1 item 6c")
    if params.EXCHANGE_MODE == "batched":
        _refuse("EXCHANGE_MODE batched (ops/exchange.py)", "Queue 1 item 6c")
    if params.PROBE_GATHER == "split":
        _refuse("PROBE_GATHER split", "Queue 1 item 6c")
    cfg = make_config(params, collect_events, fail_ids=fail_ids,
                      device=device, scenario=scenario)
    if cfg.probe_io_lag:
        raise ValueError(
            "PROBE_IO approx_lag is single-chip tpu_hash only (the "
            "sharded twins keep the two-gather attribution)")
    on_cuda = torch.device(device).type == "cuda"
    s = cfg.s
    if cfg.folded and not folded_supported(n_local, s, cfg.probes):
        if params.FOLDED == 1:
            raise ValueError(
                f"FOLDED on tpu_hash_sharded needs the per-shard row "
                f"count to fold (L={n_local}, S={s}, P={cfg.probes}: "
                "L must be a multiple of 128/S and 128/P)")
        cfg = dataclasses.replace(cfg, folded=False)
        if on_cuda and s % 128 != 0:
            _refuse_on(f"VIEW_SIZE {s} on CUDA outside FOLDED",
                       "the natural kernels take whole 128-slot rows "
                       "(VIEW_SIZE % 128 == 0); the per-shard rows do not "
                       f"fold: L={n_local}, S={s}, P={cfg.probes}")
    if cfg.folded:
        if on_cuda and (n_local * s) // 128 < 8:
            msg = (f"FOLDED FUSED_* on tpu_hash_sharded needs at least 8 "
                   f"local plane rows (L*S/128 >= 8; got L={n_local}, "
                   f"S={s})")
            if params.FUSED_RECEIVE == 1 or params.FUSED_GOSSIP == 1:
                raise ValueError(msg)
            _refuse_on(msg, "the unfused folded path runs on CPU tensors "
                       "only")
        return cfg
    if params.FUSED_GOSSIP == 1 and (n_local < 8 or s % 128 != 0):
        raise ValueError(
            f"FUSED_GOSSIP on tpu_hash_sharded needs S % 128 == 0 "
            f"and at least 8 rows per shard "
            f"(got L={n_local}, S={s}); "
            "for S < 128 it requires the FOLDED layout, which the "
            "per-shard row count rejected")
    if params.FUSED_RECEIVE == 1 and not (s % 128 == 0 and n_local >= 8):
        raise ValueError(
            f"FUSED_RECEIVE on tpu_hash_sharded needs the "
            f"per-shard row count to support the kernel tiling "
            f"(got L={n_local}, S={s}; need S % 128 == 0 "
            f"and L >= 8)")
    return cfg


def expand_fast_agg(agg: FastAgg, mesh: LocalMesh) -> FastAgg:
    """The global FastAgg (:func:`reduce_fast_agg`'s form) as per-shard
    partials: shard 0's partial holds the global value and the others
    zeros.  Every field is a sum or an or over the shards, so reducing
    the result gives the global value back."""
    def lead(x):
        out = x.new_zeros((mesh.size,) + tuple(x.shape))
        out[0] = x
        return out

    return agg._replace(det_count=lead(agg.det_count),
                        trackers=lead(agg.trackers),
                        lat_hist=lead(agg.lat_hist),
                        join_total=lead(agg.join_total),
                        rm_total=lead(agg.rm_total))


class ShardedSegmentRunner(NamedTuple):
    """The sharded twin of ``tpu_hash.SegmentRunner`` (the JAX
    ``tpu_hash_sharded._get_segment_runner`` with its init), built by
    :func:`sharded_segment_runner` for :func:`run_scan_sharded` and for
    the service daemon's live injection on the run's own mesh."""
    cfg: HashConfig
    step: Callable
    init: Callable           # init() -> the per-shard carry
    plan_t: PlanTensors
    mesh: LocalMesh
    collect_events: bool

    def reduced(self, state):
        """The carry with a FastAgg reduced to its global form."""
        if self.collect_events or not self.cfg.fast_agg:
            return state
        return state._replace(agg=reduce_fast_agg(state.agg, self.mesh))

    def init_carry(self):
        return self.reduced(self.init())

    def segment(self, state, a: int, b: int):
        """``chunked_run``'s ``segment_fn``: ticks ``[a, b)`` from a
        carry that holds the reduced global aggregates, as the JAX
        chunked carry does: a FastAgg is expanded to shard partials
        (:func:`expand_fast_agg`) and reduced at the end, an AggStats
        starts from zero and is merged into the carried one."""
        cfg, carried = self.cfg, state.agg
        if cfg.fast_agg and not self.collect_events:
            state = state._replace(agg=expand_fast_agg(carried, self.mesh))
        elif not self.collect_events:
            state = state._replace(agg=init_agg(cfg.n, self.mesh.device))
        state, events, series = run_segment(self.step, state, self.plan_t,
                                            a, b, cfg)
        if not (cfg.fast_agg or self.collect_events):
            state = state._replace(agg=merge_agg(carried, state.agg))
        return self.reduced(state), events, series


def sharded_segment_runner(params: Params, plan: FailurePlan, seed: int,
                           mesh: LocalMesh, collect_events: bool,
                           total: int) -> ShardedSegmentRunner:
    """The runner of ``plan`` on ``mesh``: the natural or the folded
    sharded step, as the config resolves."""
    n_local = mesh.rows_per_shard(params.EN_GPSZ)
    cfg = sharded_config(params, collect_events, plan_fail_ids(plan),
                         n_local, device=mesh.device,
                         scenario=plan_scenario(plan))
    params.validate_sparse_packing(total)
    cfg = resolve_mega_pack(cfg, params, total)
    key = make_run_key(params, seed ^ 0x5EED)
    if cfg.folded:
        step = make_ring_sharded_folded_step(cfg, mesh)

        def init():
            return init_local_state_warm_folded(cfg, mesh, key)
    else:
        step = make_ring_sharded_step(cfg, mesh)

        def init():
            return (init_local_state(cfg, mesh) if cfg.cold_join
                    else init_local_state_warm(cfg, mesh, key))
    return ShardedSegmentRunner(
        cfg, step, init, plan_tensors(params, plan, seed, total,
                                      mesh.device),
        mesh, collect_events)


def run_scan_sharded(params: Params, plan: FailurePlan, seed: int,
                     mesh: LocalMesh, collect_events: bool = True,
                     telemetry=None):
    """Run the whole simulation on ``mesh``: ``(final_state, events)`` as
    ``tpu_hash.run_scan``, the final agg reduced.  Under
    ``CHECKPOINT_EVERY`` the segments run through ``chunked_run``
    (:meth:`ShardedSegmentRunner.segment`)."""
    total = params.TOTAL_TIME
    runner = sharded_segment_runner(params, plan, seed, mesh,
                                    collect_events, total)
    if params.CHECKPOINT_EVERY > 0:
        from distributed_membership_tpu_torch.runtime.checkpoint import (
            chunked_run)
        return chunked_run(
            params, seed, total, device=mesh.device,
            init_carry=runner.init_carry, segment_fn=runner.segment,
            collect_events=collect_events, telemetry=telemetry,
            with_series=runner.cfg.telemetry)
    state, events = run_ticks(runner.step, runner.init(), runner.plan_t,
                              total, runner.cfg, telemetry)
    return runner.reduced(state), events


def resolve_mesh(params: Params, device) -> LocalMesh:
    """The run's mesh: ``MESH_SHAPE`` when set, else one shard."""
    return LocalMesh(mesh_shape(params), device)


def bind_run_scan(mesh: LocalMesh):
    """A ``run_scan``-shaped callable closed over ``mesh`` (the form
    ``finish_run`` drives, which passes the mesh's own device)."""
    def run_scan_bound(params, plan, seed, device, collect_events=True,
                       telemetry=None):
        return run_scan_sharded(params, plan, seed, mesh, collect_events,
                                telemetry)
    return run_scan_bound


@register("tpu_hash_sharded")
def run_tpu_hash_sharded(params: Params, log: Optional[EventLog] = None,
                         seed: Optional[int] = None,
                         device="cuda") -> RunResult:
    t0 = _time.time()
    seed = params.SEED if seed is None else seed
    log = log if log is not None else EventLog()
    plan = resolve_plan(params, _pyrandom.Random(f"app:{seed}"))
    mesh = resolve_mesh(params, device)
    result = finish_run(params, plan, log, bind_run_scan(mesh), t0, seed,
                        mesh.device)
    result.extra["mesh_size"] = mesh.size
    return result
