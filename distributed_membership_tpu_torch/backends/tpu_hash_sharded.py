"""``tpu_hash_sharded`` backend: the ring and scatter exchanges, warm or
cold joins (counterpart of the JAX package's
``backends/tpu_hash_sharded.py``).

The JAX backend shards the node rows of the ``tpu_hash`` state over a
device mesh: shard ``d`` owns rows ``[d*L, (d+1)*L)``, runs the step on
them inside ``shard_map`` and reaches the other shards through
collectives.  The port holds the mesh on one device
(:class:`~distributed_membership_tpu_torch.parallel.mesh.LocalMesh`): the
state keeps the flat ``[N, ...]`` layout, every per-shard computation runs
once over all rows, and each collective is a tensor operation on that
layout.  With ``MESH_SHAPE`` unset the mesh has one shard, which is what a
user runs on one card; ``MESH_SHAPE: 8`` (or ``2x4``) runs the eight-shard
program of the JAX package's eight-device mesh, bit for bit.

In a run of K processes (runtime/distributed.py) the mesh is a
:class:`~distributed_membership_tpu_torch.parallel.mesh.ProcessMesh`:
each process holds ``D/K`` consecutive shards, the same flat layout over
its rows ``[p*N/K, (p+1)*N/K)``, and draws only its shards' streams; the
collectives below are ``torch.distributed`` calls, the plan's per-row
masks are cut to the process's rows, and every boundary (each
``CHECKPOINT_EVERY`` segment, the run's end) gathers the global carry,
so every process writes the logs of the one-process run with the same
``MESH_SHAPE``.

Per tick of the ring exchange (``make_ring_sharded_step``), as in the JAX
ring step:

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
  ``PROBE_GATHER: split`` runs it too on one process, where the JAX
  split arm's three gathers are the identity and give the same bits,
  and gathers the heartbeats, will-flush and act bits apart across
  processes;
* the receive pass -- K1 (ops/fused_receive.py) over all rows, with
  global row ids;
* gossip as torus-product shifts ``u = b*L + c``: per shift the sender
  masks its payload (fanout, drop coins), the block hop routes it to
  shard ``d + b`` (``block_send``), and one pass of K4
  (ops/fused_gossip.py ``gossip_fused_stacked``) rolls every shift's
  payload by ``c`` rows within each shard, aligns its columns by that
  shard's ``s1``/``s2`` and maxes it into the mailbox.  Under
  ``EXCHANGE_MODE: batched`` the senders align each shift for its
  destination into that destination's bucket (ops/exchange.py, where
  the buckets already sit at their destinations: the ``all_to_all`` has
  nothing to move), and the next tick's head merges them: no K4;
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

``EXCHANGE: scatter`` (which ``auto`` picks under cold joins, as for the
grader's testcases) runs :func:`make_sharded_step`, the JAX bucketed
``all_to_all`` exchange: PyTorch ops only, no kernel, in either package.

``FOLDED`` runs the sharded folded step (backends/tpu_hash_folded.py
``make_ring_sharded_folded_step``, K5-K7 over every shard) behind the JAX
``sharded_config`` gates on the per-shard rows; on CUDA it also takes
AggStats (below) where the shards' rows fold.

``EVENT_MODE: agg`` with more than 8 failed ids, or on the scatter
exchange, folds into ``AggStats`` over all rows (the JAX step's per-shard
partials and their ``reduce_agg`` in one update), started from zero per
segment and merged under ``CHECKPOINT_EVERY``; ``PROBE_IO: none`` zeroes
the probe-recv and ack-send counters.  ``PROBE_IO approx_lag``,
``SHIFT_SET`` and ``ENFORCE_BUFFSIZE`` raise the JAX package's
ValueErrors, as does a 2-D ``MESH_SHAPE`` with the scatter exchange.
On CUDA the kernels take every geometry the JAX package runs, as on
``tpu_hash``: K1, K4 and K3 rows of any width and shards of any size
(``L * S % 4 != 0`` included), K5-K7 any number of local plane rows.  A
pinned ``FUSED_*: 1`` keeps the JAX package's ValueErrors (natural: ``S
% 128 == 0`` and ``L >= 8``; folded: at least 8 local plane rows), and a
pinned ``FUSED_*: 0`` is refused by design.
"""

from __future__ import annotations

import dataclasses
import math
import random as _pyrandom
import time as _time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from distributed_membership_tpu_torch.addressing import INTRODUCER_INDEX
from distributed_membership_tpu_torch.backends import RunResult, register
from distributed_membership_tpu_torch.backends.tpu_hash import (
    I32, I64, HashConfig, _admit, _credit_orphan_recvs_sharded,
    _gathered_act, _gathered_flush, _gathered_hb, _pack_probe_table,
    coin_at, count_ctrl_dropped, failed_after,
    join_plane, joinreq_to_intro, make_config, no_coin, pack_u,
    plan_fail_ids, plan_scenario, resolve_mega_pack, restart_wipe, run_segment, seed_burst, slot_of,
    tick_faults, tick_telemetry, uses_drop, warm_view, will_flush_of)
from distributed_membership_tpu_torch.backends.tpu_hash_folded import (
    folded_supported, init_local_state_warm_folded,
    make_ring_sharded_folded_step)
from distributed_membership_tpu_torch.backends.tpu_sparse import (
    SparseTickEvents, finish_run)
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.eventlog import EventLog
from distributed_membership_tpu_torch.observability.aggregates import (
    AggStats, FastAgg, init_agg, init_fast_agg, merge_agg, update_agg,
    update_fast_agg)
from distributed_membership_tpu_torch.observability.timeline import (
    PHASE_ACK, PHASE_AGG, PHASE_COLLECTIVE, PHASE_GOSSIP, PHASE_PROBE,
    PHASE_RECEIVE, PHASE_TELEMETRY)
from distributed_membership_tpu_torch.ops.exchange import BatchedExchange
from distributed_membership_tpu_torch.ops.fused_gossip import (
    gossip_fused_stacked)
from distributed_membership_tpu_torch.ops.fused_probe import (
    probe_window_fused)
from distributed_membership_tpu_torch.ops.fused_receive import receive_fused
from distributed_membership_tpu_torch.ops.rng_plan import sharded_ring_rng
from distributed_membership_tpu_torch.ops.sampling import sample_k_indices
from distributed_membership_tpu_torch.ops.threefry import (
    Key, fold_in, randint, split, uniform, uniform_each)
from distributed_membership_tpu_torch.ops.view_merge import (
    EMPTY, M32, STRIDE, as_u32, hash_slot, member_of, scatter_umax, to_bits)
from distributed_membership_tpu_torch.parallel.mesh import (
    LocalMesh, ProcessMesh, gather_carry, local_plan, mesh_shape)
from distributed_membership_tpu_torch.runtime.distributed import (
    count_ticks, device_put_global, process_count, process_index,
    transport_stats)
from distributed_membership_tpu_torch.runtime.failures import (
    FailurePlan, PlanTensors, make_run_key, plan_tensors, resolve_plan)
from distributed_membership_tpu_torch.scenario.compile import cross_group


class ShardedHashState(NamedTuple):
    """The JAX ``ShardedHashState`` leaves in their global shapes (the
    shards' rows concatenated; during a segment of a run of many
    processes, this process's shards'); u32 planes as int32 bits.
    During a run in agg mode ``agg`` holds per-shard FastAgg partials
    (``init_fast_agg(..., shards=D)``); the finished run's is reduced
    (:func:`reduce_fast_agg`)."""
    view: torch.Tensor          # [N, S]
    view_ts: torch.Tensor       # [N, S]
    started: torch.Tensor       # [N] bool
    in_group: torch.Tensor      # [N] bool
    failed: torch.Tensor        # [N] bool
    self_hb: torch.Tensor       # [N] int32
    mail: torch.Tensor          # [N, S]
    amail: torch.Tensor         # [N, S] ack mailbox (scatter), ring [D, 1]
    pmail: torch.Tensor         # [N, Qp] probe mailbox (scatter), ring [D, 1]
    joinreq_infl: torch.Tensor  # [N] bool
    joinrep_infl: torch.Tensor  # [N] bool
    pending_recv: torch.Tensor  # [N] int32
    agg: NamedTuple             # FastAgg, or the AggStats placeholder
    probe_ids1: torch.Tensor    # [N, P] ids probed last tick (id + 1;
    #                             ring), else [D, 1]
    probe_ids2: torch.Tensor    # [N, P] ids probed two ticks ago (ring)
    act_prev: torch.Tensor      # [N] bool (ring), else [D]


def init_local_state(cfg: HashConfig, mesh: LocalMesh) -> ShardedHashState:
    """The all-zero state (JAX ``init_local_state``, the shards' leaves
    concatenated): the scatter exchange's ack and probe mailboxes are
    ``[N, S]`` and ``[N, Qp]``, the ring's gather pipeline replaces them
    with one-per-shard placeholders and keeps the probe pipeline."""
    n, s, d = cfg.n, cfg.s, mesh.local_size
    nr = mesh.local_rows(n)
    dev = mesh.device
    i32 = dict(dtype=I32, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    ring = cfg.exchange == "ring"
    probe_shape = (nr, cfg.probes) if ring and cfg.probes > 0 else (d, 1)
    return ShardedHashState(
        view=torch.zeros((nr, s), **i32),
        view_ts=torch.zeros((nr, s), **i32),
        started=torch.zeros((nr,), **b),
        in_group=torch.zeros((nr,), **b),
        failed=torch.zeros((nr,), **b),
        self_hb=torch.zeros((nr,), **i32),
        mail=torch.zeros((nr, s), **i32),
        amail=torch.zeros((nr, s) if not ring else (d, 1), **i32),
        pmail=torch.zeros((nr, cfg.qp) if not ring else (d, 1), **i32),
        joinreq_infl=torch.zeros((nr,), **b),
        joinrep_infl=torch.zeros((nr,), **b),
        pending_recv=torch.zeros((nr,), **i32),
        # FastAgg: per-shard partials.  AggStats in agg mode: this
        # process's partial (on the flat layout the sum, min/max and
        # gathers of the JAX step's per-shard partials are one update
        # over the process's rows, reduced over the processes by
        # reduce_agg_stats).  Full event mode carries one shard's
        # never-updated placeholder.
        agg=(init_fast_agg(len(cfg.fail_ids), nr, dev, shards=d)
             if cfg.fast_agg else
             init_agg(n, dev, rows=nr) if not cfg.collect_events
             else init_agg(n, dev, rows=mesh.rows_per_shard(n))),
        probe_ids1=torch.zeros(probe_shape, **i32),
        probe_ids2=torch.zeros(probe_shape, **i32),
        act_prev=torch.zeros((nr,) if ring else (d,), **b),
    )


def init_local_state_warm(cfg: HashConfig, mesh: LocalMesh,
                          key: Key) -> ShardedHashState:
    """Every node in the group at t=0 with itself and ~S/2 random
    neighbours (JAX ``init_local_state_warm``): shard ``d`` draws its rows'
    neighbour offsets from ``fold_in(key, d)``."""
    n = cfg.n
    n_local = mesh.rows_per_shard(n)
    fill = max(cfg.s // 2, 1)
    st = init_local_state(cfg, mesh)
    offs = torch.cat([randint(fold_in(key, me), (n_local, fill), 1,
                              max(n, 2), mesh.device) for me in mesh.shards])
    ones = torch.ones((mesh.local_rows(n),), dtype=torch.bool,
                      device=mesh.device)
    return st._replace(view=warm_view(cfg, st.view, offs,
                                      mesh.row_lo(n)),
                       started=ones, in_group=ones.clone())


def make_ring_sharded_step(cfg: HashConfig, mesh: LocalMesh):
    """``step(state, t, key, plan) -> (state, SparseTickEvents)``: the JAX
    ``make_ring_sharded_step`` (``cold_join`` under JOIN_MODE staggered
    or batch) on every shard of ``mesh`` at once.  Under ``EXCHANGE_MODE:
    batched`` the step carries ``(state, xbuf)``: the head merges last
    tick's exchange into the mailbox and pending receives, the senders
    align every shift into its destination's bucket (ops/exchange.py, no
    K4 launch), and the buckets are the new xbuf; ``step.batched_exchange``
    is the BatchedExchange, else None."""
    n, s, g, p_cnt = cfg.n, cfg.s, cfg.g, cfg.probes
    intro = INTRODUCER_INDEX
    d = mesh.size
    n_local = mesh.rows_per_shard(n)
    # This process's rows and shards (all of them on a LocalMesh).
    nr, row0, dl = mesh.local_rows(n), mesh.row_lo(n), mesh.local_size
    multi = mesh.procs > 1
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
                  use_drop=use_drop, cold_join=cfg.cold_join,
                  batched=cfg.rng_mode != "scattered")
    bx = (BatchedExchange(mesh=mesh, n_local=n_local, s=s, cstride=cstride,
                          single_col_roll=single_col)
          if cfg.batched_exchange else None)
    # PROBE_GATHER split's three gathers are the identity on one process,
    # where the packed gather gives the same bits.
    split_gathers = cfg.probe_gather_split and multi

    def total(x):
        return mesh.psum(mesh.shard_sums(x))

    def hist(tgt, valid, weight, shard):
        """Per-shard ``[D_local, N]`` histograms of ``tgt`` over the global
        ids (the JAX step's local ``.at[].add``), for ``psum_scatter``."""
        idx = torch.where(valid, tgt, n) + (shard - mesh.shard_lo)[
            :, None] * (n + 1)
        out = torch.zeros((dl * (n + 1),), dtype=I32, device=tgt.device)
        out.index_add_(0, idx.reshape(-1), torch.full(
            (idx.numel(),), weight, dtype=I32, device=tgt.device))
        return out.view(dl, n + 1)[:, :n]

    def step(state, t: int, key: Key, plan: PlanTensors):
        if t < 0:
            raise ValueError("ticks start at 0")
        if bx is not None:
            # Last tick's exchange lands where the legacy merge is first
            # read: the receive pass's mailbox and the pending receives.
            state = bx.flush(*state)
        dev = state.view.device
        # This process's global row ids, and the plan's per-row masks
        # cut to them (update_agg reads the fail mask by member id).
        rows = torch.arange(nr, dtype=I64, device=dev) + row0
        plan_g, plan = plan, local_plan(plan, mesh)
        rng = sharded_ring_rng(key, mesh.shards, device=dev, **rng_kw)
        # The scenario's tensors are replicated on every shard: each
        # shard's rows read them elementwise, with no collective.
        f = tick_faults(plan, t, rows, n, p_drop)
        coins = use_drop and plan.drop_active(t)
        # The coins that kill a message this tick, counted for TELEMETRY
        # (each replicated coin once, as the JAX step's local slices).
        dropped = [] if cfg.telemetry else None

        # ---- join control plane (inert under warm join), self refresh
        # (cold joins run the legacy plan only: the gate above)
        ctrl_drop = (rng.ctrl_u.reshape(2, n)[:, row0:row0 + nr] < p_drop
                     if coins and cfg.cold_join else None)
        jp = join_plane(cfg, state, t, plan, rows,
                        None if ctrl_drop is None else ~ctrl_drop, f.held,
                        mesh=mesh)
        if dropped is not None and ctrl_drop is not None:
            dropped.append(count_ctrl_dropped(jp, plan, t, rows, ctrl_drop))
        recv_mask, act, recv_tick = jp.recv_mask, jp.act, jp.recv_tick
        rcol = recv_mask[:, None]

        # ---- ack candidates (probes issued at t-2): one all_gather of
        # the packed probe table, one gather on [id2, tgt1] ----
        cand_full = torch.zeros((nr, s), dtype=I32, device=dev)
        ack_recv_cnt = torch.zeros((nr,), dtype=I32, device=dev)
        if p_cnt > 0:
            with record_function(PHASE_ACK):
                ids2 = state.probe_ids2
                id2 = (ids2.to(I64) - 1).clamp_min(0)
                ids1 = state.probe_ids1
                v1 = ids1 != 0
                tgt1 = (ids1.to(I64) - 1).clamp_min(0)
                vec = torch.where(state.act_prev, state.self_hb - 1, 0)
                will_flush = will_flush_of(plan, t, recv_mask, f)
                if split_gathers:
                    # The JAX split arm: the heartbeats, will-flush and
                    # act bits in three gathers (the same packed bits).
                    tbl_g = _pack_probe_table(mesh.all_gather(vec),
                                              mesh.all_gather(will_flush),
                                              mesh.all_gather(act))
                else:
                    tbl_g = mesh.all_gather(_pack_probe_table(
                        vec, will_flush, act))
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
                    coin = coin_at(rng.ack_u.reshape(nr, p_cnt), p_ack)
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
                                   jp.self_val, row0=row0)
        if cfg.cold_join:
            mail = joinreq_to_intro(cfg, mail, jp.joiner_req, mesh=mesh)
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
            keep = fresh & ((rng.thin_u.reshape(nr, s) < p_keep[:, None])
                            | (cur_id == rows[:, None]))
        keep = keep & act[:, None]
        sent_gossip = torch.zeros((nr,), dtype=I32, device=dev)
        recv_add = torch.zeros((nr,), dtype=I32, device=dev)
        xnew = None
        if k_max > 0:
            u = rng.shift_draw.to(I64)
            b, c = u // n_local, u % n_local
            # Receiver slot = sender slot + delta * STRIDE with delta = b'L
            # + c, b' = b - D on shards me < b (block wrap), and c - L on
            # the rows l < c (row wrap): per shard and shift.
            me = torch.arange(mesh.shard_lo, mesh.shard_lo + dl,
                              dtype=I64, device=dev)[:, None]
            bp = torch.where(me < b, b - d, b)
            s1 = ((bp * n_local + c) % s * cstride % s).to(I32)
            s2 = ((bp * n_local + c - n_local) % s * cstride % s).to(I32)
            # Across processes the hops need the shifts on the host: one
            # read for the tick.
            hops = mesh.hop_shifts(b) if d > 1 and bx is None else b
            with record_function(PHASE_GOSSIP):
                if bx is None:
                    payloads = torch.empty((k_max, nr, s), dtype=I32,
                                           device=dev)
                else:
                    xnew = bx.buckets(dev)
                for j in range(k_max):
                    m = keep & (j < k_eff)[:, None]
                    # Shift u sends global row i to (i + u) mod n.
                    dst = (rows + u[j]) % n
                    if f.cuts is not None:
                        m &= ~cross_group(f.cuts, rows, dst)[:, None]
                    p_g = f.prob(t, rows, dst)
                    if not no_coin(p_g):
                        coin = coin_at(rng.gossip_u[j].reshape(nr, s), p_g)
                        if dropped is not None:
                            dropped.append((m & coin).sum(dtype=I32))
                        m &= ~coin
                    cnt = m.sum(1, dtype=I32)
                    sent_gossip += cnt
                    if bx is not None:
                        # Aligned on the sender, into its
                        # destination's bucket (no K4).
                        bx.add_shift(*xnew,
                                     torch.mul(view, m).view(dl, n_local, s),
                                     cnt.view(dl, n_local), b[j], c[j])
                        continue
                    torch.mul(view, m, out=payloads[j])  # where(m, view, 0)
                    with record_function(PHASE_COLLECTIVE):  # the block hop
                        if d > 1:
                            payloads[j] = mesh.block_send(payloads[j],
                                                          hops[j])
                        recv_add += mesh.local_roll(
                            mesh.block_send(cnt, hops[j]), c[j])
                if bx is not None:
                    with record_function(PHASE_COLLECTIVE):
                        xnew = bx.ship(*xnew)
                else:
                    mail = gossip_fused_stacked(n_local, s, k_max,
                                                single_col, mail, payloads,
                                                c.to(I32), s1, s2)
                    del payloads
        sent_tick = sent_gossip + jp.sent_req + jp.sent_rep
        if cfg.cold_join:
            # The introducer's burst (its row broadcast, delivered by each
            # seed's owner), with the replicated burst coins.
            cap = min(cfg.seed_cap, n)
            burst_drop = ((rng.burst_u.reshape(cap, s) < p_drop) if coins
                          else None)
            fresh_intro = mesh.row_value(fresh, intro)
            mail, seed_idx, seed_valid, burst_valid = seed_burst(
                cfg, mail, view, fresh_intro, jp.seeds,
                mesh.row_value(act, intro), burst_drop, mesh=mesh)
            if dropped is not None and coins and row0 <= intro < row0 + nr:
                # The replicated burst coins, counted by one process.
                dropped.append((seed_valid[:, None] & fresh_intro[None, :]
                                & burst_drop).sum(dtype=I32))
            sent_tick = sent_tick + torch.where(
                (rows == intro) & act, burst_valid.sum(dtype=I32), 0)
            # Each process credits its own seeds' receives.
            seed_row = seed_idx.to(I64) - row0
            here = (seed_row >= 0) & (seed_row < nr)
            recv_add.index_add_(0, seed_row.clamp(0, nr - 1), torch.where(
                here, burst_valid.sum(1, dtype=I32) * seed_valid.to(I32), 0))

        # ---- SWIM round-robin probing (K3; row-local, global ids) ----
        probe_ids1, probe_ids2 = state.probe_ids1, state.probe_ids2
        act_prev = state.act_prev
        pfo = None
        if p_cnt > 0:
            with record_function(PHASE_PROBE):
                pfo = probe_window_fused(
                    n, s, p_cnt, cfg.tfail, fail_ids, want_hist, want_agg,
                    t, (t * p_cnt) % s, row0, view,
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
                    coin = coin_at(rng.probe_u.reshape(nr, p_cnt), p_pr)
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
                    fail_mask=plan_g.fail_mask, fail_time=plan.fail_time,
                    sent_tick=sent_tick, recv_tick=recv_tick,
                    holder_failed=plan.fail_mask)
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
                        len(fail_ids), dl, n_local).sum(2, dtype=I32).t()),
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
            f, t, nr, p_cnt)
        if bx is not None:
            if xnew is None:                     # no gossip shift
                xnew = bx.zero(dev)
            if f.up is not None:
                # The legacy merge precedes the restart wipe: the wipe
                # chases the deferred gossip into the xbuf.
                xnew = bx.wipe(*xnew, f.up)
            new_state = (new_state, xnew)
        rec = None
        if cfg.telemetry:
            with record_function(PHASE_TELEMETRY):
                rec = tick_telemetry(
                    cfg, state.agg, agg, out, dropped, act=act,
                    numfailed=numfailed, ack_recv_cnt=ack_recv_cnt,
                    sent_gossip=sent_gossip, difft=difft, present=present,
                    size=size, t=t, fail_time=plan.fail_time, pfo=pfo,
                    reduce=mesh.allreduce if multi else None)
        if cfg.collect_events:
            # Every process logs every row's events.
            out = SparseTickEvents(*(mesh.all_gather(x) for x in out))
        return new_state, out if rec is None else (out, rec)

    step.batched_exchange = bx
    return step


# Message channels of the scatter exchange (3 bits beside the target id).
# Their numeric order is the bucket priority: a full bucket drops its
# highest channel, the gossip, first (JAX ``CH_*``).
CH_ACK, CH_PROBE0, CH_PROBE1, CH_JOIN, CH_GOSSIP = range(5)
N_CH = 5
EMPTY_SLOT = -1             # 0xFFFFFFFF as int32 bits: an empty wire slot


def bucket_capacity(cfg: HashConfig, n_local: int, n_shards: int) -> int:
    """The messages one shard may send another per tick (JAX
    ``bucket_capacity``): 2.5 times the expected traffic plus 64, and no
    more than a shard can send; a fuller bucket drops its tail, as
    EmulNet's bounded buffer does."""
    k = min(cfg.fanout, cfg.s)
    per_sender = k * cfg.g + 6 * cfg.probes + 2
    seed_total = cfg.seed_cap * cfg.s
    expect = (n_local * per_sender + seed_total) / n_shards
    cap = int(2.5 * expect) + 64
    return min(cap, n_local * per_sender + seed_total)


def make_sharded_step(cfg: HashConfig, mesh: LocalMesh):
    """``step(state, t, key, plan) -> (state, SparseTickEvents)``: the JAX
    ``make_sharded_step``, the scatter exchange of ``tpu_hash_sharded``
    (cold or warm joins), on every shard of ``mesh`` at once.

    Each shard lists its tick's messages as ``(target, entry, channel)``
    -- gossip to ``k_eff`` sampled view occupants with ``G`` sampled
    entries each, JOINREQs, the introducer's seed burst, both probe copies
    and the acks -- sorts them by (destination shard, channel), cuts them
    into per-destination buckets of :func:`bucket_capacity`, and one
    ``all_to_all`` ships the buckets; each shard scatter-maxes what it
    got into its mailboxes (``mail``, ``amail``, ``pmail``).  The JAX sort
    (packed ``key * 2^26 + position`` keys) orders a shard's messages by
    key, then position; here the valid messages of every shard, listed
    in position order, take one stable sort by (shard, destination,
    channel), which gives that order, and the invalid tail is never
    listed.  The JAX fallback sort (more than 2^26 messages a shard, or
    more than 64 keys) is not stable; it can differ from this order only
    inside a bucket that overflows.  Random streams per shard from
    ``fold_in(key, shard)`` split 4 ways, the control coins from
    ``split(key, 1)[0]``.  The join handshake's all-gathers are the
    identity on the flat layout.  In EVENT_MODE agg the events fold into
    AggStats over every row (the JAX per-shard partials, reduced).
    ``step.stats`` holds the buckets' numbers (host ints: the bucketing
    reads its counts on the host): ``messages`` per shard (the JAX
    message list's length, which sets its sort: packed keys need at most
    2^26) and ``cap``, and over the ``ticks`` stepped the valid messages
    ``sent`` over all shards and those that full buckets dropped,
    ``truncated`` (``truncated_max`` in one tick).  The backend returns
    them in ``RunResult.extra["buckets"]``."""
    n, s, g, p_cnt, qp = cfg.n, cfg.s, cfg.g, cfg.probes, cfg.qp
    intro = INTRODUCER_INDEX
    d = mesh.size
    n_local = mesh.rows_per_shard(n)
    # This process's rows and shards (all of them on a LocalMesh).
    nr, row0, dl = mesh.local_rows(n), mesh.row_lo(n), mesh.local_size
    multi = mesh.procs > 1
    k_max = min(cfg.fanout, s)
    g_eff = s if g >= s else g
    cap = bucket_capacity(cfg, n_local, d)
    seed_rows = min(cfg.seed_cap, n)
    p_copies = 1 if qp >= n else 2
    p_drop = float(np.float32(cfg.drop_prob))
    intro_shard = intro // n_local
    intro_here = intro_shard in mesh.shards
    # Each shard's message list, piece by piece (the JAX emit order):
    # (channel, per-row width or None for the burst's [cap, S] block),
    # and its length (the JAX list's, invalid messages included).
    pieces = [(CH_GOSSIP, k_max * g_eff), (CH_JOIN, 1), (CH_GOSSIP, None)]
    if p_cnt > 0:
        pieces += [(CH_PROBE0, p_cnt)] + (
            [(CH_PROBE1, p_cnt)] if p_copies == 2 else []) + [(CH_ACK, qp)]
    m_shard = sum(n_local * w if w else seed_rows * s for _, w in pieces)
    stats = {"messages": m_shard, "cap": cap, "ticks": 0, "sent": 0,
             "truncated": 0, "truncated_max": 0}

    def draw(keys, shape, dev):
        """Each shard's ``uniform(key, shape)``, in shard order (in one
        pass under threefry)."""
        return uniform_each(keys, math.prod(shape), dev).view(
            (len(keys) * shape[0],) + tuple(shape[1:]))

    def step(state: ShardedHashState, t: int, key: Key, plan: PlanTensors):
        if t < 0:
            raise ValueError("ticks start at 0")
        dev = state.view.device
        # This process's global row ids, and the plan's per-row masks cut
        # to them (update_agg reads the fail mask by member id).
        rows = torch.arange(nr, dtype=I64, device=dev) + row0
        plan_g, plan = plan, local_plan(plan, mesh)
        keys_l = [split(fold_in(key, me), 4) for me in mesh.shards]
        k_ctrl = split(key, 1)[0]                  # replicated
        coins = cfg.drop_prob > 0.0 and plan.drop_active(t)
        st = plan.start_ticks
        st_intro = plan_g.start_ticks[intro]
        self_slot = slot_of(cfg, rows, rows)
        self_mask = (torch.arange(s, device=dev)[None, :]
                     == self_slot[:, None])
        ctrl_kept = (~(uniform(k_ctrl, (2, n), dev) < p_drop)[
            :, row0:row0 + nr] if coins
            else torch.ones((2, nr), dtype=torch.bool, device=dev))

        with record_function(PHASE_RECEIVE):
            # ---- receive: acks, then gossip, by sticky admission ----
            recv_mask = state.started & (t > st) & ~state.failed
            rcol = recv_mask[:, None]
            v0 = as_u32(state.view)
            view = torch.where(rcol, _admit(n, self_mask, rows, v0,
                                            as_u32(state.amail)), v0)
            view = torch.where(rcol, _admit(n, self_mask, rows, view,
                                            as_u32(state.mail)), view)
            changed = view > v0
            view_ts = torch.where(changed, t, state.view_ts)
            mail = torch.where(rcol, 0, state.mail)
            amail = torch.where(rcol, 0, state.amail)
            join_ids = torch.where(changed & (v0 == 0),
                                   ((view - 1) & M32) % n, EMPTY).to(I32)
            ack_valid = (state.pmail != 0) & rcol
            ack_tgt = torch.where(ack_valid, as_u32(state.pmail) - 1, 0)
            pmail = torch.where(rcol, 0, state.pmail)
            recv_tick = torch.where(recv_mask, state.pending_recv, 0)
            pending_recv = torch.where(recv_mask, 0, state.pending_recv)
            in_group = state.in_group | (state.joinrep_infl & recv_mask)
            joinrep_infl = state.joinrep_infl & ~recv_mask

            # ---- join handshake (the introducer's row read from its
            # process, the seeds gathered: the identity on one process) ----
            intro_recv = (mesh.row_value(state.started & ~state.failed, intro)
                          & (t > st_intro))
            seeds = state.joinreq_infl & intro_recv
            seeds_g = mesh.all_gather(seeds)
            joinreq_infl = state.joinreq_infl & ~intro_recv
            rep_ok = seeds & ctrl_kept[1]
            joinrep_infl = joinrep_infl | rep_ok
            n_seeds = seeds_g.sum(dtype=I32)
            is_intro_row = rows == intro
            n_rep = rep_ok.sum(dtype=I32)
            sent_rep = torch.where(is_intro_row & intro_recv,
                                   mesh.allreduce(n_rep), 0)
            pending_recv = pending_recv + rep_ok.to(I32)
            start_now = st == t
            started = state.started | start_now
            boot = st_intro == t
            in_group = in_group | (is_intro_row & boot)
            joiner_req = start_now & ~is_intro_row & ctrl_kept[0]
            joinreq_infl = joinreq_infl | joiner_req
            sent_req = joiner_req.to(I32)

            # ---- self refresh, then the TFAIL / TREMOVE sweep ----
            act = started & (t > st) & ~state.failed & in_group
            own_hb = state.self_hb + 1
            self_hb = torch.where(act, state.self_hb + 2, state.self_hb)
            self_on = act | (is_intro_row & boot)
            self_val = pack_u(cfg, torch.where(act, own_hb, 0), rows)
            loc = rows - row0
            view[loc, self_slot] = torch.where(self_on, self_val,
                                               view[loc, self_slot])
            view_ts[loc, self_slot] = torch.where(self_on, t,
                                                  view_ts[loc, self_slot])
            present = view > 0
            cur_id = torch.where(present, ((view - 1) & M32) % n, EMPTY)
            cur_hb = torch.where(present, ((view - 1) & M32) // n, -1)
            difft = t - view_ts
            stale = present & (difft >= cfg.tfail) & act[:, None]
            numfailed = stale.sum(1, dtype=I32)
            removes = stale & (difft >= cfg.tremove)
            rm_ids = torch.where(removes, cur_id, EMPTY).to(I32)
            view = torch.where(removes, 0, view)
            present = present & ~removes

        with record_function(PHASE_GOSSIP):
            # ---- gossip selection ----
            size = present.sum(1, dtype=I32)
            numpotential = size - 1 - numfailed
            fresh = present & (difft < cfg.tfail)
            is_self_slot = cur_id == rows[:, None]
            eligible = fresh & ~is_self_slot & act[:, None]
            in_seed = seeds_g[cur_id.clamp_min(0)] & present
            eligible = torch.where(is_intro_row[:, None], eligible & ~in_seed,
                                   eligible)
            intro_act = mesh.row_value(act, intro)
            n_seeds_row = torch.where(is_intro_row & act, n_seeds, 0)
            k_extra = (numpotential.clamp(max=cfg.fanout)
                       - n_seeds_row).clamp_min(0)
            tgt_slot, tgt_valid = sample_k_indices(
                draw([k[0] for k in keys_l], (n_local, s), dev), eligible,
                k_extra, k_max)
            tgt = cur_id.gather(1, tgt_slot)
            if g >= s:
                e_ids, e_hbs, e_valid = cur_id, cur_hb, fresh
            else:
                scores = torch.where(is_self_slot, -1.0, draw(
                    [k[1] for k in keys_l], (n_local, s), dev))
                scores = torch.where(fresh, scores, 2.0)
                e_idx = torch.sort(-scores, dim=1, descending=True,
                                   stable=True).indices[:, :g]
                e_valid = fresh.gather(1, e_idx)
                e_ids = cur_id.gather(1, e_idx)
                e_hbs = cur_hb.gather(1, e_idx)
            msg_valid = tgt_valid[:, :, None] & e_valid[:, None, :]
            kd = [split(k[2]) for k in keys_l] if coins else None
            if coins:
                msg_valid = msg_valid & ~(draw(
                    [k[0] for k in kd], (n_local, k_max, g_eff), dev) < p_drop)

            # ---- the introducer's burst (its shard's rows only) ----
            seed_idx = torch.sort(seeds_g.to(I32), descending=True,
                                  stable=True).indices[:seed_rows]
            burst_valid = ((seeds_g[seed_idx] & intro_act)[:, None]
                           & mesh.row_value(fresh, intro)[None, :])
            if coins:
                k_burst = split(split(fold_in(key, intro_shard), 4)[2])[1]
                burst_valid = burst_valid & ~(uniform(
                    k_burst, (seed_rows, s), dev) < p_drop)

        with record_function(PHASE_PROBE):
            # ---- probes and acks ----
            # Each piece of a shard's list: (valid, target of, entry of), the
            # last two on flat indices into ``valid``.
            gval = pack_u(cfg, e_hbs, e_ids)                       # [N, G']
            li = intro - row0 if intro_here else 0   # not sent elsewhere
            bval = pack_u(cfg, cur_hb[li], cur_id[li])             # [S]
            parts = [
                (msg_valid, lambda i: tgt.reshape(-1)[i // g_eff],
                 lambda i: gval[i // (k_max * g_eff), i % g_eff]),
                (joiner_req, lambda i: torch.full_like(i, intro),
                 lambda i: pack_u(cfg, 0 * i, i + row0)),
                # Only the introducer's process sends its burst.
                (burst_valid if intro_here else torch.zeros_like(
                    burst_valid), lambda i: seed_idx[i // s],
                 lambda i: bval[i % s])]
            sent_probe_ack = torch.zeros_like(sent_req)
            if p_cnt > 0:
                widx = (t * p_cnt + torch.arange(p_cnt, device=dev)) % s
                p_tgt = cur_id[:, widx]
                p_ok = (present & ~is_self_slot)[:, widx] & act[:, None]
                ack_ok = ack_valid & act[:, None]
                if coins:
                    kp = [split(k[3]) for k in keys_l]
                    p_ok = p_ok & ~(draw([k[0] for k in kp], (n_local, p_cnt),
                                         dev) < p_drop)
                    ack_ok = ack_ok & ~(draw([k[1] for k in kp],
                                             (n_local, qp), dev) < p_drop)
                own = pack_u(cfg, own_hb, rows)
                parts += [(p_ok, lambda i: p_tgt.reshape(-1)[i],
                           lambda i: own[i // p_cnt])] * p_copies
                parts.append((ack_ok, lambda i: ack_tgt.reshape(-1)[i],
                              lambda i: own[i // qp]))
                sent_probe_ack = (p_ok.sum(1, dtype=I32) * p_copies
                                  + ack_ok.sum(1, dtype=I32))

        with record_function(PHASE_COLLECTIVE):
            # ---- bucket by destination shard, ship, deliver ----
            recv_a, recv_b, sent, truncated = bucket_and_ship(parts, dev)
            if multi:
                sent, truncated = mesh.allreduce(torch.tensor(
                    [sent, truncated], dtype=I64)).tolist()
            stats["ticks"] += 1
            stats["sent"] += sent
            stats["truncated"] += truncated
            stats["truncated_max"] = max(stats["truncated_max"], truncated)
            got = (recv_a != EMPTY_SLOT).nonzero().squeeze(1)
            a = as_u32(recv_a[got])
            r_tgt, r_chan = a >> 3, a & 7
            val = as_u32(recv_b[got])
            r_id = ((val - 1) & M32) % n
            # Each mailbox takes its channels' messages only: a sink
            # address would draw every other message's atomic max.
            r_row = r_tgt - row0
            addr = r_row * s + slot_of(cfg, r_tgt, r_id)
            ack = r_chan == CH_ACK
            mail = scatter_umax(mail, addr[~ack], val[~ack])
            amail = scatter_umax(amail, addr[ack], val[ack])
            copies = ((CH_PROBE0, 0), (CH_PROBE1, 0x2545F49))[:p_copies]
            for ch, salt in copies if p_cnt > 0 else ():
                sel = r_chan == ch
                pid = r_id[sel]
                pmail = scatter_umax(
                    pmail, r_row[sel] * qp + hash_slot(pid, t + salt, qp, n),
                    pid + 1)
            pending_recv = pending_recv + torch.bincount(
                r_row, minlength=nr).to(I32)

        sent_tick = (msg_valid.sum((1, 2), dtype=I32) + sent_req + sent_rep
                     + sent_probe_ack + torch.where(
                         is_intro_row, burst_valid.sum(dtype=I32), 0))
        failed = (state.failed | plan.fail_mask if t == plan.fail_time
                  else state.failed)
        agg = state.agg
        out = SparseTickEvents(join_ids, rm_ids, sent_tick, recv_tick)
        if not cfg.collect_events:
            # The JAX per-shard partials and their reduce_agg (psum,
            # pmin/pmax, all_gather) are one update over every row.
            with record_function(PHASE_AGG):
                agg = update_agg(
                    agg, t=t, join_ids=join_ids, rm_ids=rm_ids,
                    view_ids=cur_id, view_present=present,
                    fail_mask=plan_g.fail_mask, fail_time=plan.fail_time,
                    sent_tick=sent_tick, recv_tick=recv_tick,
                    holder_failed=plan.fail_mask)
            out = SparseTickEvents(*(x.sum(dtype=I32) for x in (
                join_ids != EMPTY, rm_ids != EMPTY, sent_tick, recv_tick)))
            if multi:
                out = SparseTickEvents(*mesh.allreduce(torch.stack(out)))
        else:
            # Every process logs every row's events.
            out = SparseTickEvents(*(mesh.all_gather(x) for x in out))
        new_state = ShardedHashState(
            to_bits(view), view_ts, started, in_group, failed, self_hb,
            mail, amail, pmail, joinreq_infl, joinrep_infl, pending_recv,
            agg, state.probe_ids1, state.probe_ids2, state.act_prev)
        return new_state, out

    def bucket_and_ship(parts, dev):
        """Each shard's valid messages in the JAX bucket order, the first
        ``cap`` of each (source, destination) bucket written to the wire
        buffers, and one ``all_to_all`` (``mesh.all_to_all``).  The
        pieces are listed in the JAX emit order, each shard-major, so a
        stable sort by (shard, destination, channel) leaves each key's
        messages in list order.  Returns ``(recv_a, recv_b, sent,
        truncated)``: the received ``[D * D * cap]`` planes (``target * 8
        + channel`` and the entry, int32 u32 bits, :data:`EMPTY_SLOT`
        where empty), and host counts."""
        keys, avals, bvals = [], [], []
        for (chan, width), (ok_p, tgt_of, val_of) in zip(pieces, parts):
            flat = ok_p.reshape(-1).nonzero().squeeze(1)
            # This process's source shards, from 0.
            shard = (torch.full_like(flat, intro_shard - mesh.shard_lo)
                     if width is None else flat // (n_local * width))
            tg = tgt_of(flat)
            keys.append(((shard * d + tg // n_local) * N_CH + chan).to(I32))
            avals.append(to_bits(tg * 8 + chan))
            bvals.append(to_bits(val_of(flat)))
        key_s, order = torch.sort(torch.cat(keys), stable=True)
        group = key_s // N_CH                      # src * D + dst
        del key_s
        counts = torch.bincount(group, minlength=dl * d)
        first = torch.cumsum(counts, 0) - counts
        rank = torch.arange(group.numel(), device=dev) - first[group]
        keep = rank < cap
        slot = (group * cap + rank)[keep]
        order = order[keep]
        send_a = torch.full((dl * d * cap,), EMPTY_SLOT, dtype=I32,
                            device=dev)
        send_b = torch.zeros((dl * d * cap,), dtype=I32, device=dev)
        send_a[slot] = torch.cat(avals)[order]
        send_b[slot] = torch.cat(bvals)[order]
        sent = int(group.numel())
        truncated = sent - int(slot.numel())
        if multi:
            # One all_to_all: the two planes side by side.
            both = mesh.all_to_all(torch.stack([send_a, send_b], 1))
            return both[:, 0], both[:, 1], sent, truncated
        return (mesh.all_to_all(send_a), mesh.all_to_all(send_b), sent,
                truncated)

    step.stats = stats
    step.batched_exchange = None
    return step


def reduce_fast_agg(agg: FastAgg, mesh: LocalMesh) -> FastAgg:
    """Reduce per-shard FastAgg partials to the global value: sums of the
    counts and histogram over every shard.  The per-row fields stay
    this process's rows (:func:`~distributed_membership_tpu_torch.
    parallel.mesh.gather_carry` gathers them with the state's)."""
    return agg._replace(
        det_count=mesh.psum(agg.det_count),
        trackers=mesh.psum(agg.trackers),
        lat_hist=mesh.psum(agg.lat_hist),
        join_total=mesh.psum(agg.join_total),
        rm_total=mesh.psum(agg.rm_total))


def reduce_agg_stats(agg: AggStats, mesh: LocalMesh) -> AggStats:
    """This process's AggStats partial (its rows' events counted by member
    id) reduced over the processes: the counts and histogram summed, the
    first and last removal ticks as min and max (their init values are
    the identities).  The per-row fields stay this process's rows.  The
    identity on a LocalMesh, whose one update covers every row."""
    if mesh.procs == 1:
        return agg
    counts = ("rm_count", "det_count", "join_count", "trackers",
              "lat_hist")
    flat = mesh.allreduce(torch.cat([getattr(agg, f) for f in counts]))
    summed = dict(zip(counts, flat.split([getattr(agg, f).numel()
                                          for f in counts])))
    return agg._replace(rm_first=mesh.allreduce(agg.rm_first, "min"),
                        rm_last=mesh.allreduce(agg.rm_last, "max"),
                        **summed)


def sharded_config(params: Params, collect_events: bool, fail_ids: tuple,
                   n_local: int, device="cpu", scenario=None) -> HashConfig:
    """``tpu_hash.make_config`` plus the JAX ``sharded_config`` gates on
    the per-shard rows (same messages).  Where the rows of a shard do not
    fold, a pinned ``FOLDED: 1`` raises and ``-1`` falls back to the
    natural layout, as in the JAX package, whose kernels on CUDA take any
    ``VIEW_SIZE``; the folded kernels take shards of any number of plane
    rows, and only a pinned ``FUSED_*: 1`` raises the JAX package's
    8-row gate.  On CUDA, in
    EVENT_MODE agg at S < 128 with more than 8 failed ids, ``FOLDED: -1``
    takes the folded layout with AggStats where the shards' rows fold
    (tpu_hash.make_config); the JAX package runs that on its natural
    layout.  The scatter exchange takes no kernel."""
    cfg = make_config(params, collect_events, fail_ids=fail_ids,
                      device=device, scenario=scenario)
    cfg = dataclasses.replace(
        cfg, probe_gather_split=params.PROBE_GATHER == "split")
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
    if cfg.folded:
        if (on_cuda and (n_local * s) // 128 < 8
                and (params.FUSED_RECEIVE == 1 or params.FUSED_GOSSIP == 1)):
            raise ValueError(
                f"FOLDED FUSED_* on tpu_hash_sharded needs at least 8 "
                f"local plane rows (L*S/128 >= 8; got L={n_local}, "
                f"S={s})")
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
        out = x.new_zeros((mesh.local_size,) + tuple(x.shape))
        if mesh.shard_lo == 0:
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
        """The carry with its aggregate reduced to the global form: a
        FastAgg's per-shard partials summed, an AggStats's per-process
        partials reduced over the processes (on one process its update
        covers every row at once, so the JAX ``reduce_agg`` has nothing
        left to do)."""
        if self.collect_events:
            return state
        if not self.cfg.fast_agg:
            return state._replace(agg=reduce_agg_stats(state.agg,
                                                       self.mesh))
        return state._replace(agg=reduce_fast_agg(state.agg, self.mesh))

    def global_carry(self, state):
        """The reduced carry's process-sharded leaves gathered to their
        global values (runtime/distributed.py: every process holds the
        same whole carry at a boundary); the identity on a LocalMesh."""
        return gather_carry(self.reduced(state), self.mesh,
                            self.collect_events)

    def init_carry(self):
        return self.global_carry(self.init())

    def ticks(self, state, a: int, b: int):
        """``run_segment`` of ticks ``[a, b)``.  Under ``EXCHANGE_MODE:
        batched`` the xbuf rides inside the segment only: it starts empty
        and the last one is flushed into the mailbox and pending receives
        at the end (the JAX ``_flush_xbuf``), so the boundary carry --
        checkpoints, the resume identity, the service's snapshots --
        keeps the legacy shape."""
        bx = self.step.batched_exchange
        if bx is not None:
            state = (state, bx.zero(self.mesh.device))
        before, t0 = transport_stats(), _time.perf_counter()
        state, events, series = run_segment(self.step, state, self.plan_t,
                                            a, b, self.cfg)
        after = transport_stats()
        count_ticks(b - a, _time.perf_counter() - t0,
                    after["bytes"] - before["bytes"],
                    after["comm_s"] - before["comm_s"])
        if bx is not None:
            state = bx.flush(*state)
        return state, events, series

    def segment(self, state, a: int, b: int):
        """``chunked_run``'s ``segment_fn``: ticks ``[a, b)`` from a
        global carry that holds the reduced aggregates, as the JAX
        chunked carry does: cut to this process's rows
        (:func:`~distributed_membership_tpu_torch.runtime.distributed.
        device_put_global`), a FastAgg expanded to shard partials
        (:func:`expand_fast_agg`) and reduced at the end, an AggStats
        started from zero and merged into the carried one, and the
        result gathered back to the global carry."""
        cfg, mesh = self.cfg, self.mesh
        state = device_put_global(state, mesh, self.collect_events)
        carried = state.agg
        if cfg.fast_agg and not self.collect_events:
            state = state._replace(agg=expand_fast_agg(carried, mesh))
        elif not self.collect_events:
            state = state._replace(agg=init_agg(
                cfg.n, mesh.device, rows=mesh.local_rows(cfg.n)))
        state, events, series = self.ticks(state, a, b)
        if not (cfg.fast_agg or self.collect_events):
            state = state._replace(agg=merge_agg(
                carried, reduce_agg_stats(state.agg, mesh)))
            return gather_carry(state, mesh), events, series
        return self.global_carry(state), events, series


def sharded_segment_runner(params: Params, plan: FailurePlan, seed: int,
                           mesh: LocalMesh, collect_events: bool,
                           total: int) -> ShardedSegmentRunner:
    """The runner of ``plan`` on ``mesh``: the natural or the folded
    sharded ring step, or the scatter step, as the config resolves."""
    n_local = mesh.rows_per_shard(params.EN_GPSZ)
    cfg = sharded_config(params, collect_events, plan_fail_ids(plan),
                         n_local, device=mesh.device,
                         scenario=plan_scenario(plan))
    if len(mesh.shape) > 1 and cfg.exchange != "ring":
        raise ValueError(
            "2-D torus meshes require EXCHANGE ring (the bucketed "
            "all_to_all exchange is 1-D only)")
    params.validate_sparse_packing(total)
    cfg = resolve_mega_pack(cfg, params, total)
    key = make_run_key(params, seed ^ 0x5EED)
    if cfg.folded:
        step = make_ring_sharded_folded_step(cfg, mesh)

        def init():
            return init_local_state_warm_folded(cfg, mesh, key)
    else:
        step = (make_ring_sharded_step(cfg, mesh) if cfg.exchange == "ring"
                else make_sharded_step(cfg, mesh))

        def init():
            return (init_local_state(cfg, mesh) if cfg.cold_join
                    else init_local_state_warm(cfg, mesh, key))
    return ShardedSegmentRunner(
        cfg, step, init, plan_tensors(params, plan, seed, total,
                                      mesh.device),
        mesh, collect_events)


def run_scan_sharded(params: Params, plan: FailurePlan, seed: int,
                     mesh: LocalMesh, collect_events: bool = True,
                     telemetry=None, buckets: Optional[dict] = None):
    """Run the whole simulation on ``mesh``: ``(final_state, events)`` as
    ``tpu_hash.run_scan``, the final agg reduced.  Under
    ``CHECKPOINT_EVERY`` the segments run through ``chunked_run``
    (:meth:`ShardedSegmentRunner.segment`).  ``buckets``, a dict,
    receives the scatter step's ``stats`` at the end."""
    total = params.TOTAL_TIME
    runner = sharded_segment_runner(params, plan, seed, mesh,
                                    collect_events, total)
    if params.CHECKPOINT_EVERY > 0:
        from distributed_membership_tpu_torch.runtime.checkpoint import (
            chunked_run)
        out = chunked_run(
            params, seed, total, device=mesh.device,
            init_carry=runner.init_carry, segment_fn=runner.segment,
            collect_events=collect_events, telemetry=telemetry,
            with_series=runner.cfg.telemetry)
    else:
        state, events, series = runner.ticks(runner.init(), 0, total)
        if series is not None and telemetry is not None:
            telemetry.flush(series, 0)
        out = runner.global_carry(state), events
    if buckets is not None:
        buckets.update(getattr(runner.step, "stats", {}))
    return out


def resolve_mesh(params: Params, device) -> LocalMesh:
    """The run's mesh: ``MESH_SHAPE`` when set, else one shard per
    process.  In a run of K processes (runtime/distributed.py) it is a
    ProcessMesh over all of them, as the JAX mesh spans every global
    device: with ``MESH_SHAPE`` unset, K shards."""
    procs = process_count()
    if procs == 1:
        return LocalMesh(mesh_shape(params), device)
    shape = mesh_shape(params) if params.MESH_SHAPE else (procs,)
    return ProcessMesh(shape, device, process_index(), procs)


def bind_run_scan(mesh: LocalMesh, buckets: Optional[dict] = None):
    """A ``run_scan``-shaped callable closed over ``mesh`` (the form
    ``finish_run`` drives, which passes the mesh's own device)."""
    def run_scan_bound(params, plan, seed, device, collect_events=True,
                       telemetry=None):
        return run_scan_sharded(params, plan, seed, mesh, collect_events,
                                telemetry, buckets)
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
    buckets = {}
    result = finish_run(params, plan, log, bind_run_scan(mesh, buckets), t0,
                        seed, mesh.device)
    result.extra["mesh_size"] = mesh.size
    if buckets:
        # The scatter exchange's bucket numbers (make_sharded_step).
        result.extra["buckets"] = buckets
    return result
