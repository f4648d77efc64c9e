"""The folded ring step (counterpart of the JAX package's
``backends/tpu_hash_folded.py``): the ``tpu_hash`` ring step for ``S <
128`` on ``[N*S/128, 128]`` planes.

``F = 128 // S`` nodes share each plane row (node ``row*F + lane//S``,
slot ``lane % S``), and the probe state folds at its own factor ``FP =
128 // P`` to ``[N*P/128, 128]``.  Those are the bytes of the natural
``[N, S]`` and ``[N, P]`` tensors, so the JAX step's lane arithmetic
(``rep``, ``rowsum``, ``rowany``, the ``window_idx``/``cand_idx`` gathers,
``ptr_switch``) is a reshape or a column slice here.  The step is defined
to equal the natural ring step (backends/tpu_hash.py ``make_step``) bit
for bit at the same seed, and runs three kernels:

* K5 ``receive_folded_fused`` (ops/fused_folded.py);
* K6 ``gossip_folded_stacked`` with the per-shift payloads masked here,
  drop coins included (ops/fused_folded.py);
* K7 ``probe_folded_window_fused`` with the FastAgg partials
  (ops/fused_probe.py); with ``PROBES: 0`` (the ``Params`` default) no
  probe traversal runs, the probe state keeps the JAX ``(1, 1)``
  placeholders, and FastAgg sums the removal plane itself
  (``folded_agg_partials``).

With more than FAST_AGG_MAX_FAILED failed ids (``cfg.fast_agg`` false;
one card, one shard or D) the events fold into ``AggStats`` through the
natural ``update_agg`` on the ``[N, S]`` view of the planes, so each
node's S slots are one row of its per-node reductions; K7 then runs its
form with no failed id (window ids and removal counts).  The JAX package has
no such route (its folded layout requires FastAgg): it is the port's
card route for what the JAX package runs on the natural layout.
``dynamic_knobs`` takes the cell's fanout and drop probability per call,
as the natural step's (``tpu_hash.make_step``).

It mirrors the JAX ``make_folded_step`` for the ring exchange under warm
join in EVENT_MODE agg, with the flight recorder (``TELEMETRY``, K7's hist
partials), the protocol-phase ranges of the natural step and the
scenario engine's hooks (backends/tpu_hash.py ``tick_faults``): per-node
masks and probabilities broadcast over each node's slots, so the payloads
stay pre-masked and K6 stays pure data movement.  The JAX step's join
machinery is inert under warm join and omitted, as there.  ``SHIFT_SET``
(single chip) takes its shifts from the static table
(``tpu_hash.shift_table``) and delivers them through K6 as the dynamic
ones; ``PROBE_IO: none`` zeroes the probe-recv and ack-send counters.

The same step on a LocalMesh (parallel/mesh.py) is the sharded folded
step (JAX ``make_ring_sharded_folded_step``, ``tpu_hash_sharded`` with
``FOLDED``): the per-shard random streams, gossip as torus-product shifts
(the block hop on the folded planes, then one K6 launch over every
shard), FastAgg partials per shard, and the warm init
:func:`init_local_state_warm_folded`.  One shard of N nodes is the
single-chip step.  Under ``EXCHANGE_MODE: batched`` the sharded step
carries ``(state, xbuf)`` and delivers through ops/exchange.py instead of
the block hop and K6.  On a ProcessMesh (runtime/distributed.py) each
process runs its own shards' rows, K6 over them in one launch, with the
probe table gathered and the tick's totals summed over the processes.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from distributed_membership_tpu_torch.backends.tpu_hash import (
    HashState, _credit_orphan_recvs, _credit_orphan_recvs_sharded,
    _pack_probe_table, _roll,
    check_dynamic_knobs, coin_at, failed_after, init_state_warm,
    knob_values, no_coin, pack_u, restart_wipe, ring_rng_plans, shift_table,
    table_shifts, tick_faults, tick_telemetry, uses_drop, will_flush_of)
from distributed_membership_tpu_torch.backends.tpu_sparse import (
    SparseTickEvents)
from distributed_membership_tpu_torch.observability.aggregates import (
    update_agg, update_fast_agg)
from distributed_membership_tpu_torch.ops.exchange import BatchedExchange
from distributed_membership_tpu_torch.ops.fused_folded import (
    LANES, gossip_folded_stacked, receive_folded_fused, roll_nodes,
    roll_slots)
from distributed_membership_tpu_torch.ops.fused_probe import (
    folded_agg_partials, probe_folded_window_fused)
from distributed_membership_tpu_torch.observability.timeline import (
    PHASE_ACK, PHASE_AGG, PHASE_COLLECTIVE, PHASE_GOSSIP, PHASE_PROBE,
    PHASE_RECEIVE, PHASE_TELEMETRY)
from distributed_membership_tpu_torch.ops.rng_plan import sharded_ring_rng
from distributed_membership_tpu_torch.ops.view_merge import (
    EMPTY, STRIDE, count_at, member_of, to_bits)
from distributed_membership_tpu_torch.parallel.mesh import local_plan
from distributed_membership_tpu_torch.scenario.compile import cross_group

__all__ = ["folded_supported", "roll_nodes", "roll_slots",
           "init_state_warm_folded", "init_local_state_warm_folded",
           "make_folded_step", "make_ring_sharded_folded_step"]

I32 = torch.int32
I64 = torch.int64


def folded_supported(n: int, s: int, probes: int) -> bool:
    """The JAX ``folded_supported``: S and P divide 128, N folds evenly at
    both factors, and the probe window is narrower than the view."""
    return (0 < s < LANES and LANES % s == 0 and n % (LANES // s) == 0
            and (probes <= 0 or (probes < s and LANES % probes == 0
                                 and n % (LANES // probes) == 0)))


def _fold_state(cfg, st):
    """``st``'s planes reshaped to ``[-1, 128]``; with no probes the
    probe state keeps its ``(1, 1)`` placeholders, as the JAX folded
    runners size them."""
    fold = lambda x: x.reshape(-1, LANES)  # noqa: E731
    probes = {} if cfg.probes <= 0 else dict(
        probe_ids1=fold(st.probe_ids1), probe_ids2=fold(st.probe_ids2))
    return st._replace(view=fold(st.view), view_ts=fold(st.view_ts),
                       mail=fold(st.mail), **probes)


def init_state_warm_folded(cfg, key, device) -> HashState:
    """The natural warm state (``tpu_hash.init_state_warm``), reshaped."""
    return _fold_state(cfg, init_state_warm(cfg, key, device))


def init_local_state_warm_folded(cfg, mesh, key):
    """The sharded warm state (``tpu_hash_sharded.init_local_state_warm``:
    per-shard offsets, FastAgg partials per shard), reshaped (the JAX
    ``init_local_state_warm_folded``)."""
    from distributed_membership_tpu_torch.backends.tpu_hash_sharded import (
        init_local_state_warm)
    return _fold_state(cfg, init_local_state_warm(cfg, mesh, key))


def make_folded_step(cfg, mesh=None, dynamic_knobs: bool = False):
    """``step(state, t, key, plan, rng=None) -> (state, SparseTickEvents)``
    on folded state, with the arguments of ``tpu_hash.make_step``; under
    ``cfg.telemetry`` the events come paired with the tick's packed
    record, as there.  With ``mesh`` (a LocalMesh of D shards of L rows)
    it is the sharded folded step (JAX ``make_ring_sharded_folded_step``)
    on the flat layout: per-shard random streams, gossip as torus-product
    shifts ``u = b*L + c`` -- the block hop to shard ``d + b`` on the
    payloads, then one D-shard K6 launch that rolls every shift by ``c``
    within each shard and aligns its slots by that shard's column shifts
    -- and FastAgg partials per shard.  One shard is the single-chip
    step, whose shifts are ``b = 0, c = u``.  Without ``cfg.fast_agg``
    the events fold into AggStats (module docstring); under
    ``cfg.batched_exchange`` (a mesh) the carry is ``(state, xbuf)`` and
    ``step.batched_exchange`` the BatchedExchange, else None;
    ``dynamic_knobs`` as in ``tpu_hash.make_step``."""
    n, s, g, p_cnt = cfg.n, cfg.s, cfg.g, cfg.probes
    # This process's nodes and plane rows (every node without a process
    # mesh).
    nr = n if mesh is None else mesh.local_rows(n)
    row0 = 0 if mesh is None else mesh.row_lo(n)
    multi = mesh is not None and mesh.procs > 1
    rows = nr * s // LANES
    k_max = min(cfg.fanout, s)
    if dynamic_knobs:
        check_dynamic_knobs(cfg)
    use_drop = dynamic_knobs or uses_drop(cfg)
    p_red = 1 if cfg.qp >= n else 2
    cstride = STRIDE % s
    d = 1 if mesh is None else mesh.size
    dl = 1 if mesh is None else mesh.local_size
    n_local = n if mesh is None else mesh.rows_per_shard(n)
    # The wrapped rows' slot shift equals the unwrapped one iff this.
    single_col = (n_local * STRIDE) % s == 0
    fail_ids = cfg.fail_ids
    want_hist = cfg.telemetry_hist
    # SHIFT_SET (single chip): the draw indexes the static table, whose
    # shifts go to K6 as the dynamic ones do.
    table = shift_table(n, cfg.shift_set) if cfg.shift_set else None
    tables = {}
    bx = None
    if mesh is None:
        def plan_rng(key, dev):
            return ring_rng_plans(cfg, [key], dev, use_drop)[0]
        part = None
    else:
        def plan_rng(key, dev):
            return sharded_ring_rng(key, mesh.shards, n=n, n_local=n_local,
                                    s=s, g=g, k_max=k_max, p_cnt=p_cnt,
                                    seed_rows=min(cfg.seed_cap, n),
                                    use_drop=use_drop, cold_join=False,
                                    device=dev,
                                    batched=cfg.rng_mode != "scattered")
        part = mesh.shard_sums
        if cfg.batched_exchange:
            bx = BatchedExchange(mesh=mesh, n_local=n_local, s=s,
                                 cstride=cstride, single_col_roll=single_col,
                                 folded=True, lanes=LANES)

    def step(state, t: int, key, plan, rng=None, fanout=None,
             drop_prob=None):
        if bx is not None:
            # Last tick's exchange merged where the legacy merge is read.
            state = bx.flush(*state)
        dev = state.view.device
        idx = torch.arange(nr, dtype=I64, device=dev) + row0
        plan_g = plan
        if mesh is not None:
            plan = local_plan(plan, mesh)
        fanout_eff, p_drop = knob_values(cfg, fanout, drop_prob)
        if rng is None:
            rng = plan_rng(key, dev)
        f = tick_faults(plan, t, idx, n, p_drop)
        dropped = [] if cfg.telemetry else None

        # ---- warm join: every node started before tick 0; a delay
        # window holds delivery, and act keeps the ungated mask ----
        live = state.started & ~state.failed
        recv_mask = live if f.held is None else live & ~f.held
        recv_tick = torch.where(recv_mask, state.pending_recv, 0)
        pending_recv = torch.where(recv_mask, 0, state.pending_recv)
        act = live & state.in_group
        self_hb = torch.where(act, state.self_hb + 2, state.self_hb)
        self_val = to_bits(pack_u(
            cfg, torch.where(act, state.self_hb + 1, 0), idx))

        # ---- ack candidates of the probes issued at t-2 (P-folded
        # probe state is the [N, P] bytes; the probe table is the one
        # all_gather of the sharded step); none with no probes ----
        will_flush = will_flush_of(plan, t, recv_mask, f)
        cand_sf = torch.zeros((rows, LANES), dtype=I32, device=dev)
        ack_recv_cnt = torch.zeros((nr,), dtype=I32, device=dev)
        if p_cnt > 0:
            with record_function(PHASE_ACK):
                ids1 = state.probe_ids1.view(nr, p_cnt)
                ids2 = state.probe_ids2.view(nr, p_cnt)
                id2 = (ids2.to(I64) - 1).clamp_min(0)
                tgt1 = (ids1.to(I64) - 1).clamp_min(0)
                v1 = ids1 != 0
                vec = torch.where(state.act_prev, state.self_hb - 1, 0)
                tbl = _pack_probe_table(vec, will_flush, act)
                if mesh is not None:
                    tbl = mesh.all_gather(tbl)
                # One gather; PROBE_IO none reads no counter bits.
                gcat = tbl[id2 if cfg.probe_io_none
                           else torch.cat([id2, tgt1], dim=1)]
                hb_ack = (gcat[:, :p_cnt] >> 2).to(I32)
                bits1 = gcat[:, p_cnt:]
                valid2 = (ids2 != 0) & (hb_ack > 0)
                if f.cuts_prev is not None:
                    # The ack crossed target -> prober during tick t-1.
                    valid2 &= ~cross_group(f.cuts_prev, id2, idx[:, None])
                p_ack = f.prob(t - 1, id2, idx[:, None])
                if not no_coin(p_ack):
                    coin = coin_at(rng.ack_u.view(nr, p_cnt), p_ack)
                    if dropped is not None:
                        dropped.append((valid2 & coin).sum(dtype=I32))
                    valid2 = valid2 & ~coin
                cand = torch.zeros((nr, s), dtype=I32, device=dev)
                cand[:, :p_cnt] = torch.where(
                    valid2, to_bits(pack_u(cfg, hb_ack, id2)), 0)
                cand_sf = roll_slots(cand.view(rows, LANES),
                                     ((t - 2) * p_cnt) % s, s)
                ack_recv_cnt = (valid2 & recv_mask[:, None]).sum(
                    1, dtype=I32)

        # ---- receive (K5); the caller reduces the stale plane ----
        with record_function(PHASE_RECEIVE):
            (view, view_ts, mail, join_mask, rm_ids,
             stale) = receive_folded_fused(
                n, s, cfg.tfail, cfg.tremove, STRIDE, t, state.view,
                state.view_ts, state.mail, cand_sf, recv_mask, act,
                self_val, row0)
        vn = view.view(nr, s)
        present = vn != 0
        difft = t - view_ts.view(nr, s)
        numfailed = stale.view(nr, s).sum(1, dtype=I32)
        size = present.sum(1, dtype=I32)
        cur_id = torch.where(present, member_of(vn, n), EMPTY)

        # ---- gossip: per-shift payloads, drop coins applied here; the
        # block hop, then K6 ----
        numpotential = size - 1 - numfailed
        fresh = present & (difft < cfg.tfail)
        k_eff = numpotential.clamp(max=fanout_eff).clamp_min(0)
        if g >= s:
            keep = fresh
        else:
            fresh_cnt = fresh.sum(1, dtype=I32)
            p_keep = torch.where(
                fresh_cnt > 1,
                (g - 1) / (fresh_cnt - 1).clamp_min(1).to(torch.float32),
                1.0)
            keep = fresh & ((rng.thin_u.view(nr, s) < p_keep[:, None])
                            | (cur_id == idx[:, None]))
        keep = keep & act[:, None]
        u = (rng.shift_draw.to(I64) if table is None
             else table_shifts(tables, table, rng.shift_draw, I64))
        b, c = u // n_local, u % n_local
        # Receiver slot = sender slot + delta * STRIDE with delta = b'L +
        # c, b' = b - D on the shards me < b (block wrap), and c - L on the
        # rows l < c (row wrap): per shard and shift.
        shard_lo = 0 if mesh is None else mesh.shard_lo
        me = torch.arange(shard_lo, shard_lo + dl, dtype=I64,
                          device=dev)[:, None]
        bp = torch.where(me < b, b - d, b)
        s1 = ((bp * n_local + c) % s * cstride % s).to(I32)
        s2 = ((bp * n_local + c - n_local) % s * cstride % s).to(I32)
        sent_gossip = torch.zeros((nr,), dtype=I32, device=dev)
        recv_add = torch.zeros((nr,), dtype=I32, device=dev)
        # Across processes the hops need the shifts on the host: one read
        # for the tick.
        hops = (mesh.hop_shifts(b) if mesh is not None and d > 1
                and bx is None else b)
        with record_function(PHASE_GOSSIP):
            if bx is None:
                payloads = torch.empty((k_max, nr, s), dtype=I32,
                                       device=dev)
            else:
                xnew = bx.buckets(dev)
            for j in range(k_max):
                m = keep & (j < k_eff)[:, None]
                # Shift u sends global row i to (i + u) mod n.
                dst = (idx + u[j]) % n
                if f.cuts is not None:
                    m = m & ~cross_group(f.cuts, idx, dst)[:, None]
                p_g = f.prob(t, idx, dst)
                if not no_coin(p_g):
                    coin = coin_at(rng.gossip_u[j].view(nr, s), p_g)
                    if dropped is not None:
                        dropped.append((m & coin).sum(dtype=I32))
                    m = m & ~coin
                cnt = m.sum(1, dtype=I32)
                sent_gossip += cnt
                if bx is not None:
                    # Aligned on the sender, into its destination's
                    # bucket (no K6).
                    bx.add_shift(*xnew,
                                 torch.mul(vn, m).view(dl, -1, LANES),
                                 cnt.view(dl, n_local), b[j], c[j])
                    continue
                torch.mul(vn, m, out=payloads[j])      # where(m, view, 0)
                if mesh is None:
                    recv_add += _roll(cnt, c[j], idx, n)
                    continue
                with record_function(PHASE_COLLECTIVE):   # the block hop
                    if d > 1:
                        payloads[j] = mesh.block_send(payloads[j], hops[j])
                    recv_add += mesh.local_roll(
                        mesh.block_send(cnt, hops[j]), c[j])
            if bx is not None:
                with record_function(PHASE_COLLECTIVE):
                    xnew = bx.ship(*xnew)
            else:
                mail = gossip_folded_stacked(
                    rows, s, k_max, single_col, mail,
                    payloads.view(k_max, rows, LANES), c.to(I32), s1, s2,
                    n_local=n_local)
                del payloads

        # ---- SWIM probes from the window (K7), coins in [N, P] space;
        # none with no probes ----
        pfo = None
        probe_ids1, probe_ids2 = state.probe_ids1, state.probe_ids2
        act_prev = state.act_prev
        sent_tick = sent_gossip
        if p_cnt > 0:
            with record_function(PHASE_PROBE):
                pfo = probe_folded_window_fused(
                    n, s, p_cnt, cfg.tfail, fail_ids, want_hist, True, t,
                    (t * p_cnt) % s, row0, view,
                    view_ts if want_hist else None, act, rm_ids)
                window = pfo["ids"]
                p_valid = window != 0
                w_id = (window.to(I64) - 1).clamp_min(0)
                if f.cuts is not None:
                    p_valid = p_valid & ~cross_group(f.cuts, idx[:, None],
                                                     w_id)
                p_pr = f.prob(t, idx[:, None], w_id)
                if not no_coin(p_pr):
                    coin = coin_at(rng.probe_u.view(nr, p_cnt), p_pr)
                    if dropped is not None:
                        dropped.append((p_valid & coin).sum(dtype=I32))
                    p_valid = p_valid & ~coin
                new_ids1 = torch.where(p_valid, window, 0).reshape(-1,
                                                                   LANES)
                sent_probes = p_valid.sum(1, dtype=I32) * p_red
                # Per-target counts over the global ids: on the flat layout
                # the sharded step's psum_scatter of per-shard histograms.
                if cfg.count_probe_io:
                    recv_probe = count_at(tgt1, v1, p_red, n)
                    sent_ack = count_at(tgt1, v1 & ((bits1 & 2) != 0), 1,
                                         n)
                    if mesh is not None:
                        recv_probe = mesh.scatter_sum(recv_probe)
                        sent_ack = mesh.scatter_sum(sent_ack)
                elif cfg.probe_io_none:
                    recv_probe = sent_ack = torch.zeros_like(sent_probes)
                else:
                    per_prober = (v1 & ((bits1 & 1) != 0)).sum(
                        1, dtype=I32) * p_red
                    recv_probe = (_credit_orphan_recvs_sharded(
                        per_prober, will_flush, (tbl & 1) != 0, idx, mesh)
                        if multi else
                        _credit_orphan_recvs(per_prober, will_flush))
                    sent_ack = (v1 & ((bits1 & 2) != 0)).sum(1, dtype=I32)
            probe_ids1, probe_ids2, act_prev = new_ids1, probe_ids1, act
            sent_tick = sent_tick + sent_probes + sent_ack
            recv_add = recv_add + recv_probe
        pending_recv = pending_recv + recv_add + ack_recv_cnt
        with record_function(PHASE_AGG):
            if not cfg.fast_agg:
                # AggStats on the [N, S] view: the natural step's fold.
                join_ids = torch.where(join_mask.view(nr, s), cur_id, EMPTY)
                rm_n = rm_ids.view(nr, s)
                agg = update_agg(
                    state.agg, t=t, join_ids=join_ids, rm_ids=rm_n,
                    view_ids=cur_id, view_present=present,
                    fail_mask=plan_g.fail_mask, fail_time=plan.fail_time,
                    sent_tick=sent_tick, recv_tick=recv_tick,
                    holder_failed=plan.fail_mask)
                joins = (join_ids != EMPTY).sum(dtype=I32)
                rm_total = (rm_n != EMPTY).sum(dtype=I32)
            else:
                # FastAgg on per-node [N, S] views, from K7's partials (per
                # shard with a mesh), or with no probes (so no K7) the same
                # sums over the removal plane.
                if pfo is None:
                    pfo = folded_agg_partials(rm_ids, fail_ids, s)
                det_tick = any_true_rm = None
                if fail_ids:
                    det_tick = torch.stack(
                        [dc.view(dl, -1).sum(1, dtype=I32)
                         for dc in pfo["det_cols"]], dim=1)
                    if mesh is None:
                        det_tick = det_tick[0]
                    any_true_rm = pfo["det_any"]
                rm_cnt = pfo["rm_cnt"]
                agg = update_fast_agg(
                    state.agg, t=t, fail_ids=fail_ids, join_events=join_mask,
                    rm_total_tick=(rm_cnt.sum(dtype=I32) if mesh is None
                                   else mesh.shard_sums(rm_cnt)),
                    det_tick=det_tick, any_true_rm=any_true_rm,
                    view_ids=(cur_id if t == plan.fail_time and fail_ids
                              else None),
                    view_present=present, fail_time=plan.fail_time,
                    holder_failed=plan.fail_mask, sent_tick=sent_tick,
                    recv_tick=recv_tick, part=part)
                joins, rm_total = join_mask.sum(dtype=I32), rm_cnt.sum(
                    dtype=I32)
        out = SparseTickEvents(joins, rm_total, sent_tick.sum(dtype=I32),
                               recv_tick.sum(dtype=I32))
        if multi:
            out = SparseTickEvents(*mesh.allreduce(torch.stack(out)))
        # End-of-tick crash/leave/restart transitions, after the agg fold.
        new_state = restart_wipe(state._replace(
            view=view, view_ts=view_ts,
            failed=failed_after(plan, t, state.failed, f), self_hb=self_hb,
            mail=mail, pending_recv=pending_recv, agg=agg,
            probe_ids1=probe_ids1, probe_ids2=probe_ids2,
            act_prev=act_prev), f, t, nr, p_cnt)
        if bx is not None:
            if f.up is not None:
                # The restart wipe chases the deferred gossip.
                xnew = bx.wipe(*xnew, f.up)
            new_state = (new_state, xnew)
        if not cfg.telemetry:
            return new_state, out
        with record_function(PHASE_TELEMETRY):
            rec = tick_telemetry(
                cfg, state.agg, agg, out, dropped, act=act,
                numfailed=numfailed, ack_recv_cnt=ack_recv_cnt,
                sent_gossip=sent_gossip, difft=difft, present=present,
                size=size, t=t, fail_time=plan.fail_time, pfo=pfo,
                reduce=mesh.allreduce if multi else None)
        return new_state, (out, rec)

    step.batched_exchange = bx
    return step


def make_ring_sharded_folded_step(cfg, mesh):
    """The sharded folded step on ``mesh`` (:func:`make_folded_step`)."""
    return make_folded_step(cfg, mesh)
