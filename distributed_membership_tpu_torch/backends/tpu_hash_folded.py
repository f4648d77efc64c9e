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
  (ops/fused_probe.py).

It mirrors the JAX ``make_folded_step`` for the ring exchange under warm
join in EVENT_MODE agg; TELEMETRY and SCENARIO stay refused by
``tpu_hash.make_config`` (ROADMAP.md Queue 1 items 4 and 5).  The JAX
step's join machinery is inert under warm join and omitted, as there.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_membership_tpu_torch.backends.tpu_hash import (
    HashState, _credit_orphan_recvs, _pack_probe_table, _roll,
    init_state_warm, pack_u)
from distributed_membership_tpu_torch.backends.tpu_sparse import (
    SparseTickEvents)
from distributed_membership_tpu_torch.observability.aggregates import (
    update_fast_agg)
from distributed_membership_tpu_torch.ops.fused_folded import (
    LANES, gossip_folded_stacked, receive_folded_fused, roll_nodes,
    roll_slots)
from distributed_membership_tpu_torch.ops.fused_probe import (
    probe_folded_window_fused)
from distributed_membership_tpu_torch.ops.rng_plan import hash_ring_rng
from distributed_membership_tpu_torch.ops.view_merge import (
    EMPTY, STRIDE, member_of, to_bits)

__all__ = ["folded_supported", "roll_nodes", "roll_slots",
           "init_state_warm_folded", "make_folded_step"]

I32 = torch.int32
I64 = torch.int64


def folded_supported(n: int, s: int, probes: int) -> bool:
    """The JAX ``folded_supported``: S and P divide 128, N folds evenly at
    both factors, and the probe window is narrower than the view."""
    return (0 < s < LANES and LANES % s == 0 and n % (LANES // s) == 0
            and (probes <= 0 or (probes < s and LANES % probes == 0
                                 and n % (LANES // probes) == 0)))


def init_state_warm_folded(cfg, key, device) -> HashState:
    """The natural warm state (``tpu_hash.init_state_warm``), reshaped."""
    st = init_state_warm(cfg, key, device)
    fold = lambda x: x.reshape(-1, LANES)  # noqa: E731
    return st._replace(view=fold(st.view), view_ts=fold(st.view_ts),
                       mail=fold(st.mail), probe_ids1=fold(st.probe_ids1),
                       probe_ids2=fold(st.probe_ids2))


def make_folded_step(cfg):
    """``step(state, t, key, plan) -> (state, SparseTickEvents)`` on
    folded state, with the arguments of ``tpu_hash.make_step``."""
    n, s, g, p_cnt = cfg.n, cfg.s, cfg.g, cfg.probes
    rows = n * s // LANES
    k_max = min(cfg.fanout, s)
    use_drop = cfg.drop_prob > 0.0
    p_drop = float(np.float32(cfg.drop_prob))  # coins: uniform < f32(p)
    p_red = 1 if cfg.qp >= n else 2
    cstride = STRIDE % s
    single_col = (n * STRIDE) % s == 0
    fail_ids = cfg.fail_ids

    def step(state: HashState, t: int, key, plan):
        dev = state.view.device
        idx = torch.arange(n, dtype=I64, device=dev)
        rng = hash_ring_rng(key, n=n, s=s, g=g, k_max=k_max, p_cnt=p_cnt,
                            seed_rows=min(cfg.seed_cap, n),
                            use_drop=use_drop, need_ctrl=False,
                            need_burst=False, device=dev)
        coins = use_drop and plan.drop_active(t)

        # ---- warm join: every node started before tick 0 ----
        recv_mask = state.started & ~state.failed
        recv_tick = torch.where(recv_mask, state.pending_recv, 0)
        pending_recv = torch.where(recv_mask, 0, state.pending_recv)
        act = recv_mask & state.in_group
        self_hb = torch.where(act, state.self_hb + 2, state.self_hb)
        self_val = to_bits(pack_u(
            cfg, torch.where(act, state.self_hb + 1, 0), idx))

        # ---- ack candidates of the probes issued at t-2 (P-folded
        # probe state is the [N, P] bytes) ----
        ids1 = state.probe_ids1.view(n, p_cnt)
        ids2 = state.probe_ids2.view(n, p_cnt)
        id2 = (ids2.to(I64) - 1).clamp_min(0)
        tgt1 = (ids1.to(I64) - 1).clamp_min(0)
        v1 = ids1 != 0
        vec = torch.where(state.act_prev, state.self_hb - 1, 0)
        will_flush = (recv_mask & ~plan.fail_mask if t == plan.fail_time
                      else recv_mask)
        tbl = _pack_probe_table(vec, will_flush, act)
        gcat = tbl[torch.cat([id2, tgt1], dim=1)]            # one gather
        hb_ack = (gcat[:, :p_cnt] >> 2).to(I32)
        bits1 = gcat[:, p_cnt:]
        valid2 = (ids2 != 0) & (hb_ack > 0)
        if use_drop and plan.drop_active(t - 1):
            valid2 = valid2 & ~(rng.ack_u.view(n, p_cnt) < p_drop)
        cand = torch.zeros((n, s), dtype=I32, device=dev)
        cand[:, :p_cnt] = torch.where(valid2, to_bits(pack_u(cfg, hb_ack,
                                                             id2)), 0)
        cand_sf = roll_slots(cand.view(rows, LANES), ((t - 2) * p_cnt) % s, s)
        ack_recv_cnt = (valid2 & recv_mask[:, None]).sum(1, dtype=I32)

        # ---- receive (K5); the caller reduces the stale plane ----
        (view, view_ts, mail, join_mask, rm_ids,
         stale) = receive_folded_fused(
            n, s, cfg.tfail, cfg.tremove, STRIDE, t, state.view,
            state.view_ts, state.mail, cand_sf, recv_mask, act, self_val)
        vn = view.view(n, s)
        present = vn != 0
        numfailed = stale.view(n, s).sum(1, dtype=I32)
        size = present.sum(1, dtype=I32)
        cur_id = torch.where(present, member_of(vn, n), EMPTY)

        # ---- gossip: per-shift payloads, drop coins applied here (K6) --
        numpotential = size - 1 - numfailed
        fresh = present & ((t - view_ts.view(n, s)) < cfg.tfail)
        k_eff = numpotential.clamp(max=cfg.fanout).clamp_min(0)
        if g >= s:
            keep = fresh
        else:
            fresh_cnt = fresh.sum(1, dtype=I32)
            p_keep = torch.where(
                fresh_cnt > 1,
                (g - 1) / (fresh_cnt - 1).clamp_min(1).to(torch.float32),
                1.0)
            keep = fresh & ((rng.thin_u.view(n, s) < p_keep[:, None])
                            | (cur_id == idx[:, None]))
        keep = keep & act[:, None]
        shifts = rng.shift_draw
        sent_gossip = torch.zeros((n,), dtype=I32, device=dev)
        recv_add = torch.zeros((n,), dtype=I32, device=dev)
        payloads = torch.empty((k_max, n, s), dtype=I32, device=dev)
        for j in range(k_max):
            m = keep & (j < k_eff)[:, None]
            if coins:
                m = m & ~(rng.gossip_u[j].view(n, s) < p_drop)
            payloads[j] = torch.where(m, vn, 0)
            cnt = m.sum(1, dtype=I32)
            sent_gossip += cnt
            recv_add += _roll(cnt, shifts[j], idx, n)
        r = shifts.to(I64)
        c1 = ((r % s) * cstride % s).to(I32)
        c2 = (torch.zeros_like(c1) if single_col
              else (((r - n) % s) * cstride % s).to(I32))
        mail = gossip_folded_stacked(rows, s, k_max, single_col, mail,
                                     payloads.view(k_max, rows, LANES),
                                     shifts, c1, c2)

        # ---- SWIM probes from the window (K7), coins in [N, P] space ----
        pfo = probe_folded_window_fused(
            n, s, p_cnt, cfg.tfail, fail_ids, False, True, t,
            (t * p_cnt) % s, 0, view, None, act, rm_ids)
        window = pfo["ids"].view(n, s)[:, :p_cnt]
        p_valid = window != 0
        if coins:
            p_valid = p_valid & ~(rng.probe_u.view(n, p_cnt) < p_drop)
        probe_ids1 = torch.where(p_valid, window, 0).reshape(-1, LANES)
        sent_probes = p_valid.sum(1, dtype=I32) * p_red
        if cfg.count_probe_io:
            ack_send = v1 & ((bits1 & 2) != 0)
            zeros = torch.zeros((n + 1,), dtype=I32, device=dev)
            recv_probe = zeros.index_add(
                0, torch.where(v1, tgt1, n).reshape(-1),
                torch.full((n * p_cnt,), p_red, dtype=I32, device=dev))[:n]
            sent_ack = zeros.index_add(
                0, torch.where(ack_send, tgt1, n).reshape(-1),
                torch.ones((n * p_cnt,), dtype=I32, device=dev))[:n]
        else:
            per_prober = (v1 & ((bits1 & 1) != 0)).sum(1, dtype=I32) * p_red
            recv_probe = _credit_orphan_recvs(per_prober, will_flush)
            sent_ack = (v1 & ((bits1 & 2) != 0)).sum(1, dtype=I32)
        sent_tick = sent_gossip + sent_probes + sent_ack
        pending_recv = pending_recv + recv_add + recv_probe + ack_recv_cnt

        failed = (state.failed | plan.fail_mask if t == plan.fail_time
                  else state.failed)
        # FastAgg on per-node [N, S] views, from K7's partials.
        rm_total = pfo["rm_cnt"].sum(dtype=I32)
        det_tick = any_true_rm = None
        if fail_ids:
            det_tick = torch.stack([d.sum(dtype=I32)
                                    for d in pfo["det_cols"]])
            any_true_rm = pfo["det_any"].view(n, s).any(1)
        agg = update_fast_agg(
            state.agg, t=t, fail_ids=fail_ids, join_events=join_mask,
            rm_total_tick=rm_total, det_tick=det_tick,
            any_true_rm=any_true_rm,
            view_ids=cur_id if t == plan.fail_time and fail_ids else None,
            view_present=present, fail_time=plan.fail_time,
            holder_failed=plan.fail_mask, sent_tick=sent_tick,
            recv_tick=recv_tick)
        out = SparseTickEvents(join_mask.sum(dtype=I32), rm_total,
                               sent_tick.sum(dtype=I32),
                               recv_tick.sum(dtype=I32))
        new_state = state._replace(
            view=view, view_ts=view_ts, failed=failed, self_hb=self_hb,
            mail=mail, pending_recv=pending_recv, agg=agg,
            probe_ids1=probe_ids1, probe_ids2=state.probe_ids1,
            act_prev=act)
        return new_state, out

    return step
