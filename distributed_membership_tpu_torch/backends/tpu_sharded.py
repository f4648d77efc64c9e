"""`tpu_sharded` backend: the dense step on a mesh of node shards (the
JAX package's ``backends/tpu_sharded.py``), for parity and debugging.

Shard ``d`` of a :class:`~distributed_membership_tpu_torch.parallel.mesh.LocalMesh`
owns nodes ``[d*L, (d+1)*L)``: their member-list rows, in-flight rows and
per-node vectors.  All ``D`` shards sit on one device in the flat
``[N, ...]`` layout of the dense step, so the JAX ``shard_map`` body runs
once over all rows and its collectives are ``parallel/collectives.py``'s
reductions: each shard's senders max-reduce their gossip into a partial
``[N, E]`` (stacked ``[D, N, E]``), delivered by the ring reduce-scatter
with max; the message counts by a sum reduce-scatter; the join handshake's
``[N]`` vectors by ``all_gather`` (the identity on the flat layout).

Random streams, as in the JAX package: the target scores are drawn per
shard (``[L, N]`` under ``fold_in(k_targets, d)``), and the drop coins
per shard under ``fold_in(k_drop, d)``, so a run depends on ``D``.
``replicated_rng=True`` draws the full ``[N, N]`` scores once and slices
them, which makes a drop-free run equal the dense ``tpu`` run bit for bit
at any ``D`` -- the JAX package's debug mode.  With no ``mesh`` the run
takes one shard: one card or one CPU is one device (the JAX package takes
the largest device count dividing N).  Memory is the dense step's plus
the ``[D, N, N]`` partials of the delivery.
"""

from __future__ import annotations

import random as _pyrandom
import time as _time
from typing import Optional

import numpy as np
import torch

from distributed_membership_tpu_torch.addressing import INTRODUCER_INDEX
from distributed_membership_tpu_torch.backends import RunResult, register
from distributed_membership_tpu_torch.backends.tpu import (
    I32, I64, State, StepConfig, TickEvents, deliver, init_state,
    run_segment, step_config)
from distributed_membership_tpu_torch.backends.tpu_sparse import (
    events_to_log)
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.eventlog import EventLog
from distributed_membership_tpu_torch.ops.merge import (
    broadcast_deliver, fanout_deliver_indexed)
from distributed_membership_tpu_torch.ops.sampling import sample_k_indices
from distributed_membership_tpu_torch.ops.threefry import (
    Key, bernoulli, fold_in, split, uniform, uniform_each)
from distributed_membership_tpu_torch.parallel.collectives import (
    all_gather_vec, reduce_scatter_sum, ring_reduce_scatter_max)
from distributed_membership_tpu_torch.parallel.mesh import LocalMesh
from distributed_membership_tpu_torch.runtime.failures import (
    PlanTensors, plan_tensors, resolve_plan)

INTRO = INTRODUCER_INDEX


def make_sharded_step(cfg: StepConfig, mesh: LocalMesh,
                      replicated_rng: bool = False):
    """The per-tick transition of all ``D`` shards (the JAX
    ``make_sharded_step``): ``step(state, t, key, plan) -> (state,
    TickEvents)`` on the flat ``[N, ...]`` state, events always full."""
    from distributed_membership_tpu_torch.backends.tpu_hash import (
        join_plane)
    n = cfg.n
    d = mesh.size
    n_local = mesh.rows_per_shard(n)
    intro_shard, intro_local_row = divmod(INTRO, n_local)
    use_drop = cfg.drop_prob > 0.0
    k_max = min(cfg.fanout, n)

    def step(state: State, t: int, key: Key, plan: PlanTensors):
        dev = state.hb.device
        idx = torch.arange(n, dtype=I64, device=dev)     # global row ids
        k_targets, k_drop, k_ctrl = split(key, 3)
        coins = use_drop and plan.drop_active(t)
        # The control coins are one replicated draw.
        jp = join_plane(cfg, state, t, plan, idx,
                        ~bernoulli(k_ctrl, cfg.drop_prob, (2, n), dev)
                        if coins else None)
        present, hb, ts, infl_has, infl_hb, join_events = deliver(
            state, t, jp.recv_mask)
        # The join handshake's global view of the [N] vectors.
        in_group_g = all_gather_vec(state.in_group
                                    | (state.joinrep_infl & jp.recv_mask))
        intro_recv = all_gather_vec(jp.recv_mask)[INTRO]

        boot = plan.start_ticks[INTRO] == t
        present[INTRO, INTRO] |= boot
        hb[INTRO, INTRO] = torch.where(boot, 0, hb[INTRO, INTRO])
        ts[INTRO, INTRO] = torch.where(boot, t, ts[INTRO, INTRO])
        infl_has[INTRO] |= jp.joiner_req
        infl_hb[INTRO] = torch.where(jp.joiner_req,
                                     infl_hb[INTRO].clamp_min(0),
                                     infl_hb[INTRO])

        act = jp.act
        present[idx, idx] |= act
        hb[idx, idx] = torch.where(act, jp.own_hb, hb[idx, idx])
        ts[idx, idx] = torch.where(act, t, ts[idx, idx])
        difft = t - ts
        stale = present & (difft >= cfg.tfail) & act[:, None]
        numfailed = stale.sum(1, dtype=I32)
        removes = stale & (difft >= cfg.tremove)
        present &= ~removes

        numpotential = present.sum(1, dtype=I32) - 1 - numfailed
        fresh = present & (difft < cfg.tfail)
        seed_burst_g = jp.seeds & in_group_g[INTRO] & intro_recv
        eligible = fresh & (idx[None, :] != idx[:, None]) & act[:, None]
        eligible[INTRO] &= ~seed_burst_g
        n_seeds_row = torch.where((idx == INTRO) & act, jp.n_seeds, 0)
        k_extra = (numpotential.clamp(max=cfg.fanout)
                   - n_seeds_row).clamp_min(0)
        if replicated_rng:
            scores = uniform(k_targets, (n, n), dev)
        else:
            scores = uniform_each([fold_in(k_targets, s) for s in range(d)],
                                  n_local * n, dev).reshape(n, n)
        tgt_idx, tgt_valid = sample_k_indices(scores, eligible, k_extra,
                                              k_max)

        # ---- gossip: per-shard partials, then the ring reduce-scatter --
        send_hb = torch.where(fresh, hb, -1)
        shard_keys = [split(fold_in(k_drop, s)) for s in range(d)]
        drop = None
        if coins:
            drop = (uniform_each([kf for kf, _ in shard_keys],
                                 n_local * k_max * n, dev)
                    < float(np.float32(cfg.drop_prob))).reshape(n, k_max, n)
        # Shard s's senders scatter into its own block of D (N + 1) rows.
        row_base = (mesh.shard_of_rows(n) * (n + 1))[:, None]
        contrib_all, sent_list, recv_all = fanout_deliver_indexed(
            None, row_base + tgt_idx, tgt_valid, send_hb, d * (n + 1),
            coins, cfg.drop_prob, drop=drop)
        contrib_partial = contrib_all.view(d, n + 1, n)[:, :n]
        recv_partial = recv_all.view(d, n + 1)[:, :n]
        # The introducer's burst to new joiners: only its shard sends it.
        contrib_seed, sent_seed, recv_seed = broadcast_deliver(
            shard_keys[intro_shard][1], seed_burst_g, send_hb[INTRO], coins,
            cfg.drop_prob)
        contrib_partial[intro_shard] = torch.maximum(
            contrib_partial[intro_shard], contrib_seed)
        recv_partial[intro_shard] += recv_seed
        sent_list[INTRO] += sent_seed
        contrib = ring_reduce_scatter_max(contrib_partial)
        infl_has |= contrib >= 0
        infl_hb = torch.maximum(infl_hb, contrib)
        pending_recv = jp.pending_recv + reduce_scatter_sum(recv_partial)
        sent_tick = sent_list + jp.sent_req + jp.sent_rep

        failed = (state.failed | plan.fail_mask if t == plan.fail_time
                  else state.failed)
        new_state = State(present, hb, ts, jp.started, jp.in_group, failed,
                          jp.self_hb, infl_has, infl_hb, jp.joinreq_infl,
                          jp.joinrep_infl, pending_recv)
        return new_state, TickEvents(join_events, removes, sent_tick,
                                     jp.recv_tick)

    return step


def init_local_state(n: int, mesh: LocalMesh, device) -> State:
    """Every shard's ``[L, N]`` local state (the JAX
    ``init_local_state``), stacked in the flat ``[D*L, N]`` layout: the
    dense step's ``[N, N]`` state (N must divide into the D shards)."""
    mesh.rows_per_shard(n)
    return init_state(n, device)


def run_scan_sharded(params: Params, plan, seed: int, mesh: LocalMesh,
                     total_time: Optional[int] = None,
                     replicated_rng: bool = False):
    """The whole run on ``mesh``'s device: ``(final_state, events)``,
    the events compacted per tick."""
    n = params.EN_GPSZ
    if n % mesh.size != 0:
        raise ValueError(f"EN_GPSZ={n} not divisible by mesh size "
                         f"{mesh.size}")
    total = total_time if total_time is not None else params.TOTAL_TIME
    cfg = step_config(params)
    plan_t = plan_tensors(params, plan, seed, total, mesh.device)
    step = make_sharded_step(cfg, mesh, replicated_rng)
    state, events, _ = run_segment(
        step, init_local_state(n, mesh, mesh.device), plan_t, 0, total,
        True, n)
    return state, events


@register("tpu_sharded")
def run_tpu_sharded(params: Params, log: Optional[EventLog] = None,
                    seed: Optional[int] = None, device="cuda",
                    mesh: Optional[LocalMesh] = None,
                    replicated_rng: bool = False) -> RunResult:
    t0 = _time.time()
    seed = params.SEED if seed is None else seed
    log = log if log is not None else EventLog()
    from distributed_membership_tpu_torch.runtime.distributed import (
        process_count)
    if process_count() > 1:
        # The JAX run's mesh would span the processes, and it reads the
        # mesh's outputs on the host, which no process can do whole.
        raise ValueError(
            "tpu_sharded runs in one process: its dense sharded step has "
            "no multi-process path in either package (unset DM_DIST_PROCS, "
            "or run tpu_hash_sharded across processes)")
    plan = resolve_plan(params, _pyrandom.Random(f"app:{seed}"))
    if mesh is None:
        mesh = LocalMesh((1,), device)
    final_state, events = run_scan_sharded(params, plan, seed, mesh,
                                           replicated_rng=replicated_rng)
    events_to_log(params, plan, events, log)
    return RunResult(
        params=params, log=log, sent=events.sent.T, recv=events.recv.T,
        failed_indices=plan.failed_indices if plan.fail_time is not None
        else [],
        fail_time=plan.fail_time, wall_seconds=_time.time() - t0,
        extra={"final_state": final_state, "mesh_size": mesh.size})
