"""``tpu_hash`` backend: the port's main path (counterpart of the JAX
package's ``backends/tpu_hash.py``), on the ring or the scatter exchange,
with warm or cold (staggered, batch) joins.

Node ``i`` stores member ``id`` at slot ``(id + i * STRIDE) mod S`` of a
``[N, S]`` table of packed u32 ``(heartbeat, id)`` entries; the mailbox
uses the same slot map, so delivery and merge are one elementwise max,
and occupancy is sticky (an occupied slot only takes its occupant's id).
Per tick of the ring exchange (``make_step``):

* the join control plane (JOINREP, nodeStart with the introducer's boot
  and the joiners' JOINREQ) and the self refresh (heartbeat + 2);
* the ack candidates of the probe/ack gather pipeline (probes issued two
  ticks ago, answered from a one-tick-lagged heartbeat vector);
* the receive pass -- K1 (ops/fused_receive.py);
* gossip: entry thinning to ~G per row, then ``fanout`` circulant shifts
  delivered in one pass -- K2 (ops/fused_gossip.py), with per-shift keep
  masks when messages drop;
* the introducer's seed burst to joiners (with the JOINREQs, the only
  scatter of the ring step; under warm join nobody starts during the run,
  so the JOINREQ scatter is skipped);
* the probe window and the aggregate partials -- K3
  (ops/fused_probe.py), then the message counters;
* on-device aggregates (EVENT_MODE agg) or per-tick event planes (full);
* under ``TELEMETRY: scalars|hist`` the flight recorder's record of the
  tick (:func:`tick_telemetry`, observability/timeline.py): reductions
  over what the step holds, with K3's staleness and suspicion partials,
  and the coins that killed a message counted where they are drawn.

Each protocol phase runs inside a ``torch.profiler.record_function``
range named as the JAX package's ``jax.named_scope`` (``dm_ack_apply``,
``dm_receive_sweep``, ``dm_gossip_exchange``, ``dm_probe_issue``,
``dm_aggregates``, ``dm_telemetry``), so a profile splits a tick by
phase.

The scatter exchange (``make_scatter_step``, the JAX step's ``not ring``
branches) is the reference-shaped delivery the grader's testcases resolve
to: sampled view-occupant targets, scatter-max message delivery and the
slot-addressed probe (``pmail``) and ack (``amail``) mailboxes.  The JAX
package runs it with no Pallas kernel, so on CUDA it is PyTorch ops on
CUDA tensors, with no kernel of its own.

The tick loop is a Python loop: the tick ``t``, the window pointer, the
drop window and the failure tick are host ints, so the step never waits
on the device.  Everything the JAX step computes with ``u32`` is carried
as int32 bits and widened to int64 where order or ``%`` matters
(ops/view_merge.py).  Random streams are the JAX ones, bit for bit
(ops/threefry.py, ops/rng_plan.py).

``FOLDED`` selects the folded layout for ``S < 128``
(backends/tpu_hash_folded.py, kernels K5-K7), behind the JAX package's
gates (``make_config``, same messages, ``ValueError``).  ``FOLDED: 1`` is
honoured on both devices; ``-1`` picks it on CUDA when the gates pass and
``S < 128``, and the natural layout otherwise (always on the CPU, as the
JAX package's auto is off away from its accelerator).  On one card ``-1``
also takes it where the only failed gate is FastAgg's (more than
FAST_AGG_MAX_FAILED failed ids): the folded step then folds AggStats on
its planes' ``[N, S]`` view, the port's card route for what the JAX
package runs on its natural layout; a pinned ``FOLDED: 1`` keeps the JAX
gate.

``SCENARIO`` (scenario/compile.py) runs on the ring step of every layout:
a legacy-shaped schedule lowers to the usual FailurePlan (on the scatter
exchange too); a general one rides PlanTensors, and each tick's
activation is read on the host (:func:`tick_faults`) while its masks are
tensor operations -- the delay window's held rows, partition cuts and
link-flake drop probabilities at every send site, and the end-of-tick
crash/leave/restart transitions (:func:`restart_wipe`).  The JAX
package's gates hold (ring exchange only, no ENFORCE_BUFFSIZE).

``CHECKPOINT_EVERY`` runs the tick loop in segments through
runtime/checkpoint.py (snapshots, ``RESUME``, the run log);
``RNG_MODE: hoisted`` draws each segment's RNG plans before its first
tick, and ``MEGA_TICKS`` runs T-tick blocks with the shrunk carry
(ops/megakernel.py).  Neither changes the trajectory.

The ring step's options, each as the JAX step computes it:

* ``EVENT_MODE: agg`` with more than FAST_AGG_MAX_FAILED failed ids, or on
  the scatter exchange: the scatter-based ``AggStats`` update
  (observability/aggregates.py ``update_agg``), on either layout;
* ``SHIFT_SET: K``: the gossip shifts are a static K-table
  (:func:`shift_table`) indexed by the tick's draw.  The JAX step
  delivers them through static-roll branches equal to its dynamic roll;
  here the table's shifts feed K2 (any shift vector), so a pinned
  ``FUSED_GOSSIP: 1`` raises the JAX package's ValueError and ``-1``
  takes K2;
* ``ENFORCE_BUFFSIZE``: a per-tick global send budget of ``EN_BUFFSIZE``
  messages (:class:`SendBudget`), consumed in the JAX step's order -- join
  control, gossip shift by shift, the seed burst, probes -- with the
  budgeted gossip masks delivered by K2's masks form (the merge is a
  max, so applying them in one launch is exact);
* ``PROBE_IO: none`` (probe-recv and ack-send counters zeroed) and
  ``approx_lag`` (the counter bits ride the ack gather one tick late,
  ``wf_prev`` carries the will-flush mask, and the final tick's ack
  sends are added to the run totals once: :func:`lag_tail`).

``make_step(cfg, dynamic_knobs=True)`` (and the folded and scatter
steps' own) is the phase sweep's step (sweeps/phase.py): each call takes
the cell's ``fanout`` and ``drop_prob``.

``SERVICE_PORT`` runs the step under the service daemon
(service/daemon.py), which drives :func:`segment_runner`'s runner and
swaps in the runner of a merged plan on a live injection; auto
``FOLDED`` stays off there, as in the JAX package (the snapshot reads
the natural carry).  On CUDA the ring's kernels are the path, at every
geometry the JAX package runs: K1-K3 take any ``VIEW_SIZE`` (full event
mode, ``VIEW_SIZE: 0`` at any N, S = 10, 100, ...) and K5-K7 any number
of folded plane rows, so ``FUSED_*: -1`` resolves to them; a pinned
``FUSED_*: 1`` keeps the JAX package's ValueErrors of its TPU tiling,
word for word (natural: ``VIEW_SIZE % 128 == 0``, ``N >= 8``; folded:
at least 8 plane rows), and a pinned ``FUSED_*: 0`` is refused there
(the plain versions run on CPU tensors only).  ``FOLDED: -1`` on the
card picks the folded layout wherever its gates pass, under 8 plane rows
too, as the JAX package's layout knob does (its kernel knobs, not its
layout, look at the row count), and the natural layout where they
refuse (full events, S not dividing 128, N off the fold, ...), as the
JAX package does.  On the CPU the wrappers run their plain versions and
``FUSED_*: 1`` is refused.  On the scatter exchange ``FUSED_*: 1``
raises the JAX package's ValueError and ``-1`` resolves off on both
devices.
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
from distributed_membership_tpu_torch.backends.tpu_sparse import (
    SEED_CAP, CompactEvents, SparseTickEvents, compact_tick, finish_run)
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.eventlog import EventLog
from distributed_membership_tpu_torch.observability.aggregates import (
    FAST_AGG_MAX_FAILED, init_agg, init_fast_agg, update_agg,
    update_fast_agg)
from distributed_membership_tpu_torch.observability.timeline import (
    PHASE_ACK, PHASE_AGG, PHASE_GOSSIP, PHASE_PROBE, PHASE_RECEIVE,
    PHASE_TELEMETRY, TickTelemetry, build_tick_hist, row_hists, pack_tick,
    unpack_series)
from distributed_membership_tpu_torch.ops.fused_gossip import gossip_fused
from distributed_membership_tpu_torch.ops.fused_probe import (
    probe_window_fused)
from distributed_membership_tpu_torch.ops.fused_receive import receive_fused
from distributed_membership_tpu_torch.ops.megakernel import (
    PACK_SAFE_TICKS, mega_ticks, pack_fits)
from distributed_membership_tpu_torch.ops.rng_plan import (
    hash_ring_rng_keys)
from distributed_membership_tpu_torch.ops.sampling import sample_k_indices
from distributed_membership_tpu_torch.ops.threefry import (
    Key, randint, split, uniform, uniform_at)
from distributed_membership_tpu_torch.ops.view_merge import (
    EMPTY, M32, STRIDE, as_u32, count_at, hash_slot, member_of,
    scatter_umax, to_bits)
from distributed_membership_tpu_torch.runtime.failures import (
    FailurePlan, PlanTensors, make_run_key, plan_tensors, resolve_plan)
from distributed_membership_tpu_torch.scenario.compile import (
    cross_group, cut_active, cuts_at, delayed_mask, site_drop_prob,
    updown_masks)

I32 = torch.int32
I64 = torch.int64
# Above this node count probe-recv / ack-send counters are attributed to
# the prober's row (totals stay exact), as in the JAX package.
PROBE_IO_EXACT_MAX = 1 << 17


def probe_attribution_exact(params: Params) -> bool:
    if params.resolved_exchange() != "ring" or params.PROBES <= 0:
        return True
    if params.PROBE_IO != "auto":
        return params.PROBE_IO == "exact"
    return params.EN_GPSZ <= PROBE_IO_EXACT_MAX


class HashState(NamedTuple):
    """The JAX ``HashState`` leaves; u32 planes as int32 bits."""
    view: torch.Tensor          # [N, S] packed entries, 0 = empty
    view_ts: torch.Tensor       # [N, S] int32 tick of last strict increase
    started: torch.Tensor       # [N] bool
    in_group: torch.Tensor      # [N] bool
    failed: torch.Tensor        # [N] bool
    self_hb: torch.Tensor       # [N] int32
    mail: torch.Tensor          # [N, S] receiver-slot-mapped mailbox
    amail: torch.Tensor         # [N, S] ack mailbox (scatter), ring [1, 1]
    pmail: torch.Tensor         # [N, Qp] probe mailbox (scatter), ring [1, 1]
    joinreq_infl: torch.Tensor  # [N] bool
    joinrep_infl: torch.Tensor  # [N] bool
    pending_recv: torch.Tensor  # [N] int32
    agg: NamedTuple             # FastAgg (agg mode) or AggStats placeholder
    probe_ids1: torch.Tensor    # [N, P] ids probed last tick (ring; id + 1)
    probe_ids2: torch.Tensor    # [N, P] ids probed two ticks ago (ring)
    act_prev: torch.Tensor      # [N] bool act mask of last tick (ring)
    wf_prev: torch.Tensor       # [N] bool will-flush of the last tick
    #                             (PROBE_IO approx_lag), else [1]


@dataclasses.dataclass(frozen=True)
class HashConfig:
    n: int
    s: int                 # view / mailbox slots per node
    g: int                 # entries piggybacked per gossip message
    tfail: int
    tremove: int
    fanout: int
    drop_prob: float
    probes: int = 0
    qp: int = 16           # scatter-mode probe mailbox width (sets p_red)
    seed_cap: int = SEED_CAP
    collect_events: bool = True
    exchange: str = "ring"  # 'ring' (make_step) or 'scatter'
    cold_join: bool = False  # JOIN_MODE staggered or batch
    fail_ids: tuple = ()   # static failed ids for the FastAgg path
    fast_agg: bool = False
    count_probe_io: bool = True
    folded: bool = False   # [N*S/128, 128] planes (tpu_hash_folded.py)
    telemetry: bool = False       # TELEMETRY scalars (or hist)
    telemetry_hist: bool = False  # TELEMETRY hist
    # General-path scenario (scenario/compile.py ScenarioStatic): which
    # hook sites the ring steps run; its plan arrays ride PlanTensors.
    scenario: object = None
    rng_mode: str = "batched"     # 'hoisted': a segment's plans pre-drawn
    mega_ticks: int = 0           # T-tick blocks (ops/megakernel.py)
    mega_pack: bool = False       # the 16-bit shrunk block carry
    probe_io_none: bool = False   # PROBE_IO none: no probe-recv/ack-send
    probe_io_lag: bool = False    # PROBE_IO approx_lag
    send_budget: int = 0          # ENFORCE_BUFFSIZE: EN_BUFFSIZE, else 0
    shift_set: int = 0            # SHIFT_SET: K-table gossip shifts
    batched_exchange: bool = False  # EXCHANGE_MODE batched (sharded ring)
    probe_gather_split: bool = False  # PROBE_GATHER split (sharded ring)


def uses_drop(cfg: HashConfig) -> bool:
    """Whether the ring steps draw drop coins: a conf drop probability,
    or a scenario with drop windows or link flakes (whose coins are drawn
    on every tick, at the probability the tick's windows give)."""
    return cfg.drop_prob > 0.0 or (cfg.scenario is not None
                                   and cfg.scenario.has_drop)


def slot_of(cfg: HashConfig, node, member):
    """``(member + node * STRIDE) mod S`` computed modularly (the naive
    product overflows int32 above ~271k nodes)."""
    return (member % cfg.s + (node % cfg.s) * (STRIDE % cfg.s)) % cfg.s


def shift_table(n: int, k: int) -> tuple:
    """The static gossip-shift candidates of ``SHIFT_SET: K`` (JAX
    ``shift_table``): golden-ratio-spread values in [1, n), entry 0 the
    shift 1, so the union of the K circulants holds the full ring cycle."""
    tab = tuple(1 + (h * 2654435761) % (n - 1) for h in range(k))
    # K distinct shifts is what the uniform K-way draw means; a change of
    # the formula must fail here, not skew the shift distribution.
    assert len(set(tab)) == k, (
        f"shift_table({n}, {k}) produced duplicate shifts: {tab}")
    return tab


def table_shifts(tables: dict, table: tuple, draw, dtype):
    """SHIFT_SET: the shifts ``table[draw]`` (``draw`` the tick's int32
    index draw) on the draw's device; ``tables`` caches the table there,
    so a tick copies nothing from the host."""
    dev = draw.device
    if dev not in tables:
        tables[dev] = torch.tensor(table, dtype=dtype, device=dev)
    return tables[dev][draw.to(I64)]


class SendBudget:
    """One tick's global send budget (``ENFORCE_BUFFSIZE``, the JAX step's
    ``_budget_take``): messages are accepted in traversal order, row
    major, until ``budget`` are spent, and what comes later in the tick
    is dropped.  ``used`` is an int32 device scalar, so no call waits on
    the device."""

    def __init__(self, budget: int, device):
        self.budget = budget
        self.used = torch.zeros((), dtype=I32, device=device)

    def take(self, mask):
        """``mask`` with the messages past the budget cleared.  A 2-D
        mask takes the JAX row-count/clip form (equal to a flat cumsum
        over the rows in order)."""
        if mask.dim() == 1:
            csum = torch.cumsum(mask.to(I32), 0, dtype=I32) + self.used
            kept = mask & (csum <= self.budget)
            self.used = self.used + kept.sum(dtype=I32)
            return kept
        cnt0 = mask.sum(1, dtype=I32)
        starts = self.used + torch.cumsum(cnt0, 0, dtype=I32) - cnt0
        allowed = (self.budget - starts).clamp_min(0).minimum(cnt0)
        kept = mask & (torch.cumsum(mask.to(I32), 1, dtype=I32)
                       <= allowed[:, None])
        self.used = self.used + allowed.sum(dtype=I32)
        return kept

    def take_probes(self, p_valid, p_red: int):
        """Probes after everything else, ``p_red`` wire messages each; a
        probe is accepted only whole."""
        pc = p_valid.sum(1, dtype=I32) * p_red
        starts = self.used + torch.cumsum(pc, 0, dtype=I32) - pc
        accepted = (self.budget - starts).clamp_min(0).minimum(pc) // p_red
        self.used = self.used + (accepted * p_red).sum(dtype=I32)
        return p_valid & (torch.cumsum(p_valid.to(I32), 1, dtype=I32)
                          <= accepted[:, None])


def pack_u(cfg: HashConfig, hb, member):
    """Packed entry ``hb * N + member + 1`` as int64 holding the u32."""
    return ((hb.to(I64) & M32) * cfg.n + (member.to(I64) & M32) + 1) & M32


def _scatter_msgs(cfg: HashConfig, mail, tgt, msg_id, msg_hb, msg_valid,
                  node=None):
    """Max-combine messages into receiver-slot-mapped mailboxes (the JAX
    ``_scatter_msgs``): message ``k`` lands at row ``tgt[k]``, slot
    ``slot_of(node[k], msg_id[k])`` with ``node`` the receiver's global id
    (``tgt`` itself unless ``mail`` holds a subset of the rows); invalid
    ones go to the sink address ``rows*S``, which is dropped.  Returns a
    new plane."""
    r, s = mail.shape
    tgt = tgt.to(I64)
    msg_id = msg_id.to(I64)
    node = tgt if node is None else node
    addr = torch.where(msg_valid, tgt * s + slot_of(cfg, node, msg_id), r * s)
    return scatter_umax(mail, addr, pack_u(cfg, msg_hb, msg_id))


def _scatter_rows(cfg: HashConfig, plane, rows, local_tgt, msg_id, msg_hb,
                  msg_valid, nodes=None):
    """:func:`_scatter_msgs` into the mailboxes of ``rows`` (distinct row
    indices of ``plane``, holding the nodes ``nodes``, by default the
    same ids) in place; message ``k`` goes to ``rows[local_tgt[k]]``.
    Only those rows are widened."""
    nodes = rows if nodes is None else nodes
    sub = _scatter_msgs(cfg, plane.index_select(0, rows), local_tgt, msg_id,
                        msg_hb, msg_valid, node=nodes[local_tgt])
    return plane.index_copy_(0, rows, sub)


def init_state(cfg: HashConfig, device) -> HashState:
    """The all-zero cold state (JAX ``init_state``): the scatter
    exchange's ack and probe mailboxes are ``[N, S]`` and ``[N, Qp]``, the
    ring's gather pipeline replaces them with placeholders."""
    n, s = cfg.n, cfg.s
    ring = cfg.exchange == "ring"
    i32 = dict(dtype=I32, device=device)
    b = dict(dtype=torch.bool, device=device)
    probe_shape = (n, cfg.probes) if ring and cfg.probes > 0 else (1, 1)
    return HashState(
        view=torch.zeros((n, s), **i32),
        view_ts=torch.zeros((n, s), **i32),
        started=torch.zeros((n,), **b),
        in_group=torch.zeros((n,), **b),
        failed=torch.zeros((n,), **b),
        self_hb=torch.zeros((n,), **i32),
        mail=torch.zeros((n, s), **i32),
        amail=torch.zeros((n, s) if not ring else (1, 1), **i32),
        pmail=torch.zeros((n, cfg.qp) if not ring else (1, 1), **i32),
        joinreq_infl=torch.zeros((n,), **b),
        joinrep_infl=torch.zeros((n,), **b),
        pending_recv=torch.zeros((n,), **i32),
        agg=(init_fast_agg(len(cfg.fail_ids), n, device) if cfg.fast_agg
             else init_agg(n, device)),
        probe_ids1=torch.zeros(probe_shape, **i32),
        probe_ids2=torch.zeros(probe_shape, **i32),
        act_prev=torch.zeros((n,) if ring else (1,), **b),
        wf_prev=torch.zeros((n,) if cfg.probe_io_lag else (1,), **b),
    )


def init_state_cold(cfg: HashConfig, key: Key, device) -> HashState:
    """Cold joins start from the all-zero state; ``key`` is unused (the
    ``init(cfg, key, device)`` form of :func:`step_and_init`)."""
    return init_state(cfg, device)


def warm_view(cfg: HashConfig, view, offs, row0: int = 0):
    """Seed ``view`` in place: node ``i`` holds nodes ``(i + offs[i, k])
    mod N`` at heartbeat 0 in their hashed slots (unsigned max on a
    collision) and itself in its own slot, which admission reserves.
    ``view``'s rows are nodes ``row0, row0 + 1, ...``."""
    n = cfg.n
    loc = torch.arange(view.shape[0], dtype=I64, device=view.device)
    idx = loc + row0
    nbrs = (idx[:, None] + offs) % n
    view.copy_(_scatter_msgs(
        cfg, view, loc[:, None].expand(nbrs.shape), nbrs,
        torch.zeros_like(nbrs),
        torch.ones(nbrs.shape, dtype=torch.bool, device=view.device),
        node=idx[:, None].expand(nbrs.shape)))
    view[loc, slot_of(cfg, idx, idx)] = to_bits(
        pack_u(cfg, torch.zeros_like(idx), idx))
    return view


def init_state_warm(cfg: HashConfig, key: Key, device) -> HashState:
    """Every node in the group at t=0 with itself and ~S/2 random
    neighbours (JAX ``init_state_warm``)."""
    n, s = cfg.n, cfg.s
    st = init_state(cfg, device)
    offs = randint(key, (n, max(s // 2, 1)), 1, max(n, 2), device)
    ones = torch.ones((n,), dtype=torch.bool, device=device)
    return st._replace(view=warm_view(cfg, st.view, offs), started=ones,
                       in_group=ones.clone())


def _pack_probe_table(hb, wf, act):
    """Ack heartbeat in the high 30 bits, will-flush (bit 0) and act
    (bit 1) below: one u32 per target, one gather per tick."""
    return (((hb.to(I64) & M32) << 2) & M32) | wf.to(I64) | (act.to(I64) << 1)


def _gathered_flush(packed):
    return (packed & 1) != 0


def _gathered_act(packed):
    return (packed & 2) != 0


def _gathered_hb(packed):
    """The ack heartbeat back out of a :func:`_pack_probe_table` gather."""
    return (packed >> 2).to(I32)


def _credit_orphan_recvs(per_prober, will_flush):
    """Approximate attribution: probe recvs counted for a prober that will
    not flush are re-credited to the first row that will (``argmax`` of a
    bool picks the first true), so totals match exact attribution."""
    orphan = torch.where(will_flush, 0, per_prober).sum(dtype=I32)
    safe = torch.argmax(will_flush.to(I32)).reshape(1)
    out = torch.where(will_flush, per_prober, 0)
    return out.index_add_(0, safe, (orphan * will_flush.any()).reshape(1))


def _credit_orphan_recvs_sharded(per_prober, will_flush_l, will_flush_g,
                                 rows, mesh):
    """The sharded twin of :func:`_credit_orphan_recvs`: the orphan sum is
    the sum over shards of their local orphans, and it lands on the
    globally first row that will flush, whichever shard owns it.  On a
    LocalMesh ``rows`` are the global row ids of the flat layout."""
    orphan = mesh.psum(mesh.shard_sums(torch.where(will_flush_l, 0,
                                                   per_prober)))
    safe_g = torch.argmax(will_flush_g.to(I32))
    return torch.where(will_flush_l, per_prober, 0) + torch.where(
        (rows == safe_g) & will_flush_g.any(), orphan, 0)


def _roll(vec, shift, idx, n: int):
    """``jnp.roll(vec, shift)`` for a device scalar shift: out[i] =
    vec[(i - shift) mod n], without a host sync."""
    return vec.index_select(0, (idx - shift.to(I64)) % n)


class JoinPlane(NamedTuple):
    """One tick's join control plane and self-refresh vectors (all
    ``[N]``), as every step of the JAX package computes them."""
    recv_mask: torch.Tensor     # started, past its start tick, not failed
    recv_tick: torch.Tensor     # pending receives flushed this tick
    pending_recv: torch.Tensor  # after the flush, JOINREPs and JOINREQs
    in_group: torch.Tensor
    joinrep_infl: torch.Tensor
    joinreq_infl: torch.Tensor
    seeds: torch.Tensor         # joiners whose JOINREQ the introducer reads
    n_seeds: torch.Tensor       # [] int32
    sent_req: torch.Tensor
    sent_rep: torch.Tensor
    started: torch.Tensor
    joiner_req: torch.Tensor    # JOINREQs sent this tick (and not dropped)
    act: torch.Tensor
    self_on: torch.Tensor       # act, or the introducer's boot tick
    self_hb: torch.Tensor
    own_hb: torch.Tensor        # the heartbeat this tick's messages carry
    self_val: torch.Tensor      # packed self entry (int32 bits)


def join_plane(cfg: HashConfig, state, t: int, plan: PlanTensors, idx,
               ctrl_kept=None, held=None, budget=None,
               mesh=None) -> JoinPlane:
    """JOINREP delivery, nodeStart (the introducer boots its group, the
    others send a JOINREQ) and the double heartbeat increment
    (MP1Node.cpp:126-163,226-251,412-415).  ``ctrl_kept`` is the ``[2,
    N]`` control-message keep mask (row 0 JOINREQ, row 1 JOINREP) under
    drops, None when nothing drops.  ``held`` masks the rows a scenario's
    delay window holds (no delivery; ``act`` does not depend on it), or
    None.  ``idx`` holds the global row ids of the flat layout.  Under
    warm join every start tick is -1, so nobody starts and no JOINREQ is
    sent.  ``budget`` (a SendBudget or None) takes the JOINREPs, then the
    JOINREQs; one it drops is dropped for good (the reference never
    retries a join).  ``mesh`` (a sharded step's) holds the rows ``idx``
    of one process of a ProcessMesh, whose introducer bits and counts
    over every row it reads (:meth:`~distributed_membership_tpu_torch.
    parallel.mesh.LocalMesh.row_value`, ``allreduce``)."""
    intro = INTRODUCER_INDEX
    start = plan.start_ticks
    is_intro = idx == intro
    if mesh is None:
        def at_intro(x):
            return x[intro]

        def total(x):
            return x
    else:
        def at_intro(x):
            return mesh.row_value(x, intro)
        total = mesh.allreduce
    recv_mask = state.started & (start < t) & ~state.failed
    if held is not None:
        recv_mask = recv_mask & ~held
    recv_tick = torch.where(recv_mask, state.pending_recv, 0)
    pending_recv = torch.where(recv_mask, 0, state.pending_recv)
    in_group = state.in_group | (state.joinrep_infl & recv_mask)
    joinrep_infl = state.joinrep_infl & ~recv_mask
    intro_recv = at_intro(recv_mask)
    seeds = state.joinreq_infl & intro_recv
    joinreq_infl = state.joinreq_infl & ~intro_recv
    rep_ok = seeds if ctrl_kept is None else seeds & ctrl_kept[1]
    if budget is not None:
        rep_ok = budget.take(rep_ok)
    joinrep_infl = joinrep_infl | rep_ok
    sent_rep = torch.where(is_intro & intro_recv,
                           total(rep_ok.sum(dtype=I32)), 0)
    pending_recv = pending_recv + rep_ok.to(I32)

    # ---- nodeStart ----
    start_now = start == t
    started = state.started | start_now
    boot = at_intro(start_now)
    in_group = in_group | (is_intro & boot)
    joiner_req = start_now & ~is_intro
    if ctrl_kept is not None:
        joiner_req = joiner_req & ctrl_kept[0]
    if budget is not None:
        joiner_req = budget.take(joiner_req)
    joinreq_infl = joinreq_infl | joiner_req
    pending_recv = pending_recv + torch.where(
        is_intro, total(joiner_req.sum(dtype=I32)), 0)

    # ---- self refresh (double heartbeat increment) ----
    act = started & (start < t) & ~state.failed & in_group
    own_hb = state.self_hb + 1
    return JoinPlane(
        recv_mask, recv_tick, pending_recv, in_group, joinrep_infl,
        joinreq_infl, seeds, total(seeds.sum(dtype=I32)), joiner_req.to(I32),
        sent_rep, started, joiner_req, act, act | (is_intro & boot),
        torch.where(act, state.self_hb + 2, state.self_hb), own_hb,
        to_bits(pack_u(cfg, torch.where(act, own_hb, 0), idx)))


def joinreq_to_intro(cfg: HashConfig, mail, joiner_req, mesh=None):
    """This tick's JOINREQs (hb 0, the joiner's id) into the introducer's
    mailbox row, in place; only that row is widened.  With a ``mesh``,
    ``mail`` and ``joiner_req`` hold its process's rows: every joiner's
    bit is gathered, and the introducer's process takes them."""
    intro = INTRODUCER_INDEX
    row0 = 0
    if mesh is not None:
        row0 = mesh.row_lo(cfg.n)
        joiner_req = mesh.all_gather(joiner_req)
    if not row0 <= intro < row0 + mail.shape[0]:
        return mail
    ids = torch.arange(cfg.n, dtype=I64, device=mail.device)
    zeros = torch.zeros_like(ids)
    return _scatter_rows(cfg, mail, ids[intro - row0:][:1], zeros, ids,
                         zeros, joiner_req, nodes=ids[intro:][:1])


def seed_burst(cfg: HashConfig, mail, view, fresh_intro, seeds,
               burst_on, burst_drop=None, budget=None, mesh=None):
    """The introducer's burst of its fresh view row to this tick's seeded
    joiners (MP1Node.cpp:240-242): the first ``min(seed_cap, N)`` seeds in
    index order (``lax.top_k`` ties go lowest index first, hence the
    stable sort), ``burst_drop`` the ``[cap, S]`` dropped mask or None,
    ``budget`` a SendBudget (one message per entry) or None.  Updates
    ``mail`` in place; returns ``(mail, seed_idx, seed_valid,
    burst_valid)``, the seeds as global ids.  With a ``mesh`` of
    processes ``mail``, ``view`` and ``seeds`` hold one process's rows:
    the seeds are gathered, the introducer's row is read from its
    process, and each process takes its own seeds' bursts."""
    n, s = cfg.n, cfg.s
    intro = INTRODUCER_INDEX
    cap = min(cfg.seed_cap, n)
    dev = mail.device
    multi = mesh is not None and mesh.procs > 1
    if multi:
        row0, rows = mesh.row_lo(n), mesh.local_rows(n)
        seeds = mesh.all_gather(seeds)
    seed_idx = torch.sort(seeds.to(I32), descending=True,
                          stable=True).indices[:cap]
    seed_valid = seeds[seed_idx] & burst_on
    burst_valid = seed_valid[:, None] & fresh_intro[None, :]
    if burst_drop is not None:
        burst_valid = burst_valid & ~burst_drop
    if budget is not None:
        burst_valid = budget.take(burst_valid)
    iv = as_u32(mesh.row_value(view, intro) if multi else view[intro])
    ipres = iv > 0
    intro_id = torch.where(ipres, ((iv - 1) & M32) % n, EMPTY)
    intro_hb = torch.where(ipres, ((iv - 1) & M32) // n, -1)
    mine = seed_idx
    valid = burst_valid
    if multi:
        here = (seed_idx >= row0) & (seed_idx < row0 + rows)
        mine, valid = seed_idx[here], burst_valid[here]
    k = mine.shape[0]
    local = torch.arange(k, dtype=I64, device=dev)[:, None].expand(k, s)
    mail = _scatter_rows(cfg, mail, mine - row0 if multi else mine, local,
                         intro_id[None, :].expand(k, s),
                         intro_hb[None, :].expand(k, s), valid, nodes=mine)
    return mail, seed_idx, seed_valid, burst_valid


def count_ctrl_dropped(jp: JoinPlane, plan: PlanTensors, t: int, idx,
                       ctrl_drop):
    """The control messages the coins killed this tick (TELEMETRY):
    JOINREPs to the introducer's seeds and the joiners' JOINREQs."""
    joiners = (plan.start_ticks == t) & (idx != INTRODUCER_INDEX)
    return ((jp.seeds & ctrl_drop[1]).sum(dtype=I32)
            + (joiners & ctrl_drop[0]).sum(dtype=I32))


class TickFaults(NamedTuple):
    """One tick's fault plan, read on the host: the legacy crash and drop
    window, or a general scenario's activation (scenario/compile.py).
    Masks are ``[N]`` over the global row ids, None where inactive."""
    down: Optional[torch.Tensor]   # crash/leave at the end of the tick
    up: Optional[torch.Tensor]     # restart at the end of the tick
    held: Optional[torch.Tensor]   # inbound delivery held (delay window)
    cuts: Optional[np.ndarray]     # active partition's cuts at t
    cuts_prev: Optional[np.ndarray]  # ... at t - 1 (the ack leg)
    prob: object                   # prob(tt, src, dst): coin threshold


def tick_faults(plan: PlanTensors, t: int, rows, n: int,
                p_drop: float) -> TickFaults:
    """The fault plan of tick ``t`` for ``rows`` (the global ids of the
    flat layout).  ``prob(tt, src, dst)`` is the drop probability of a
    message sent at tick ``tt`` (a float32 value, or a tensor over
    ``src``/``dst`` under link flakes); a coin drops where ``u < prob``,
    so a probability of 0.0 needs no coin.  It is 0.0 wherever the step
    draws no coin stream (:func:`uses_drop` false: no conf drop
    probability, no scenario window or flake)."""
    scn, static = plan.scenario, plan.scenario_static
    if scn is None:
        return TickFaults(None, None, None, None, None,
                          lambda tt, src=None, dst=None: (
                              p_drop if plan.drop_active(tt) else 0.0))
    down, up = (updown_masks(scn, t, rows) if static.has_updown
                else (None, None))

    def active_cuts(tt):
        if not static.n_parts:
            return None
        cuts = cuts_at(scn, tt, n)
        return cuts if cut_active(cuts, n) else None
    return TickFaults(
        down, up, delayed_mask(scn, t, rows) if static.n_delays else None,
        active_cuts(t), active_cuts(t - 1),
        lambda tt, src, dst: site_drop_prob(static, scn, tt, src, dst))


def no_coin(p) -> bool:
    """A probability that drops nothing (``u < 0.0`` never holds)."""
    return isinstance(p, float) and p == 0.0


def coin_at(u, p):
    """The drop coin ``u < p`` with ``p`` a float or a tensor that
    broadcasts against ``u`` from the left (a per-row ``[R]`` probability
    against ``[R, S]`` coins)."""
    if torch.is_tensor(p) and p.dim() < u.dim():
        p = p.reshape(p.shape + (1,) * (u.dim() - p.dim()))
    return u < p


def will_flush_of(plan: PlanTensors, t: int, recv_mask, f: TickFaults):
    """Rows whose pending receives flush at t+1: under a scenario this
    tick's down/up transitions stop them, else the legacy crash does."""
    if plan.scenario is not None:
        return recv_mask if f.down is None else recv_mask & ~(f.down | f.up)
    return (recv_mask & ~plan.fail_mask if t == plan.fail_time
            else recv_mask)


def failed_after(plan: PlanTensors, t: int, failed, f: TickFaults):
    """The failed mask after the end-of-tick transitions."""
    if plan.scenario is not None:
        return failed if f.down is None else (failed | f.down) & ~f.up
    return failed | plan.fail_mask if t == plan.fail_time else failed


def restart_wipe(state, f: TickFaults, t: int, n: int, p_cnt: int):
    """A restart at the end of tick ``t`` brings its rows back as a fresh
    incarnation: view, view_ts, mail, pending receives and the probe
    pipeline cleared, the heartbeat raised to at least ``2 * (t + 1)``.
    Planes of any layout are wiped through their ``[N, -1]`` view."""
    up = f.up
    if up is None:
        return state
    col = up[:, None]

    def wipe(x):
        return torch.where(col, 0, x.view(n, -1)).view(x.shape)
    fields = dict(
        view=wipe(state.view), view_ts=wipe(state.view_ts),
        mail=wipe(state.mail),
        pending_recv=torch.where(up, 0, state.pending_recv),
        self_hb=torch.where(up, state.self_hb.clamp_min(2 * (t + 1)),
                            state.self_hb))
    if p_cnt > 0:
        fields.update(probe_ids1=wipe(state.probe_ids1),
                      probe_ids2=wipe(state.probe_ids2),
                      act_prev=state.act_prev & ~up)
    return state._replace(**fields)


def tick_telemetry(cfg: HashConfig, agg_before, agg, out: SparseTickEvents,
                   dropped: list, *, act, numfailed, ack_recv_cnt,
                   sent_gossip, difft, present, size, t: int,
                   fail_time: int, pfo, reduce=None):
    """One tick's flight-recorder record (observability/timeline.py) as
    one packed int32 vector on the device, from what a ring step holds:
    ``out`` the tick's events (planes in full event mode, totals in agg
    mode), ``dropped`` its coin-kill counts, the other tensors over all
    rows (every shard of a mesh; the JAX steps' psums are these sums).
    ``pfo`` carries the probe kernel's staleness and suspicion partials
    under the hist tier.  ``reduce`` (a ProcessMesh's ``allreduce``)
    sums the process's partials over the processes, in one call: every
    sum of rows, the detections and drops (which the latency and drop
    histograms then read), and in full event mode the event counts; the
    agg-mode totals in ``out`` are global already."""
    zero = torch.zeros((), dtype=I32, device=act.device)
    if cfg.collect_events:
        det_tick = zero
        joins = (out.join_ids != EMPTY).sum(dtype=I32)
        removals = (out.rm_ids != EMPTY).sum(dtype=I32)
        sent, recv = out.sent.sum(dtype=I32), out.recv.sum(dtype=I32)
    else:
        det_tick = (agg.det_count.sum(dtype=I32)
                    - agg_before.det_count.sum(dtype=I32))
        joins, removals, sent, recv = out
    sums = [act.sum(dtype=I32), numfailed.sum(dtype=I32),
            ack_recv_cnt.sum(dtype=I32), sent_gossip.sum(dtype=I32),
            sum(dropped, zero), det_tick]
    if cfg.collect_events:
        sums += [joins, removals, sent, recv]
    hists = []
    if cfg.telemetry_hist:
        stale = susp = None
        if pfo is not None and "stale_rows" in pfo:
            stale = pfo["stale_rows"].sum(0, dtype=I32)
            susp = pfo["susp_rows"].sum(0, dtype=I32)
        hists = list(row_hists(difft=difft, present=present, size=size,
                               act=act, tfail=cfg.tfail, stale=stale,
                               susp=susp))
    if reduce is not None:
        flat = reduce(torch.cat([torch.stack([v.to(I32) for v in sums])]
                                + hists))
        sums = list(flat[:len(sums)])
        hists = list(flat[len(sums):].split([h.numel() for h in hists]))
    if cfg.collect_events:
        joins, removals, sent, recv = sums[6:]
    live, suspected, probe_acks, gossip_rows, drop_tick, det_tick = sums[:6]
    telem = TickTelemetry(
        live=live, suspected=suspected,
        joins=joins, removals=removals, detections=det_tick,
        msgs_sent=sent, msgs_recv=recv, dropped=drop_tick,
        probe_acks=probe_acks, gossip_rows=gossip_rows)
    if not cfg.telemetry_hist:
        return pack_tick(telem)
    return pack_tick(telem, build_tick_hist(
        difft=difft, present=present, size=size, act=act, t=t,
        fail_time=fail_time, tfail=cfg.tfail, det_tick=det_tick,
        dropped=drop_tick, stale=hists[0], susp=hists[1],
        occupancy=hists[2]))


def ring_rng_plans(cfg: HashConfig, keys, device,
                   use_drop: Optional[bool] = None) -> list:
    """The single-chip ring step's RingRng for each tick key of ``keys``
    (the JAX ``_ring_rng_builder``), each stream drawn for all keys in
    one pass: the per-tick draw is one key, ``RNG_MODE: hoisted`` a
    segment's keys.  The natural step draws the control and burst coins,
    the folded step neither.  ``use_drop`` (default :func:`uses_drop`)
    draws the drop coins; the dynamic-knob steps always draw them."""
    return hash_ring_rng_keys(
        keys, n=cfg.n, s=cfg.s, g=cfg.g, k_max=min(cfg.fanout, cfg.s),
        p_cnt=max(cfg.probes, 0), seed_rows=min(cfg.seed_cap, cfg.n),
        use_drop=uses_drop(cfg) if use_drop is None else use_drop,
        need_ctrl=not cfg.folded,
        need_burst=not cfg.folded, device=device, shift_set=cfg.shift_set,
        batched=cfg.rng_mode != "scattered")


def check_dynamic_knobs(cfg: HashConfig) -> None:
    """The JAX ``make_step`` gate of ``dynamic_knobs``: a general scenario
    needs the plain ring step (its message, word for word)."""
    if cfg.scenario is not None:
        raise ValueError(
            "cfg.scenario requires the plain ring exchange (no "
            "dynamic knobs or ENFORCE_BUFFSIZE)")


def knob_values(cfg: HashConfig, fanout, drop_prob) -> tuple:
    """A dynamic-knob call's ``(fanout, p)``: the cell's values, or the
    config's where the call gives none; ``p`` rounded to float32, as
    every drop coin compares ``uniform < f32(p)``."""
    return (cfg.fanout if fanout is None else int(fanout),
            float(np.float32(cfg.drop_prob if drop_prob is None
                             else drop_prob)))


def make_step(cfg: HashConfig, dynamic_knobs: bool = False):
    """``step(state, t, key, plan, rng=None) -> (state,
    SparseTickEvents)``; ``t`` is a host int, ``key`` the tick's threefry
    key, ``plan`` the run's PlanTensors, ``rng`` the tick's pre-drawn
    RingRng (``RNG_MODE: hoisted``), else drawn from ``key``.  The ring
    exchange is built here, the scatter exchange by
    :func:`make_scatter_step`.  Under a general scenario (``cfg.scenario``)
    every hook site of the JAX step runs: the delay window's held rows,
    partition cuts and link-flake probabilities at each send site (the
    ack leg at t-1), K2's masks form whenever partitions or flakes exist,
    and the end-of-tick crash/leave/restart transitions.

    With ``dynamic_knobs`` (the JAX ``make_step(cfg, dynamic_knobs=True)``
    of the phase sweep, sweeps/phase.py) the step also takes ``fanout``
    and ``drop_prob``, the cell's values: ``cfg.fanout`` then only bounds
    ``k_max``, the drop coins are drawn on every tick (at drop 0 too),
    ``k_eff`` takes the cell's fanout, and every keep mask compares its
    uniform against the cell's probability (K2's masks form)."""
    if cfg.exchange != "ring":
        return make_scatter_step(cfg, dynamic_knobs)
    n, s, g, p_cnt = cfg.n, cfg.s, cfg.g, cfg.probes
    intro = INTRODUCER_INDEX
    k_max = min(cfg.fanout, s)
    # Scatter mode sends each probe twice when its probe mailbox is lossy;
    # the ring keeps the wire-message counters comparable.
    p_red = 1 if cfg.qp >= n else 2
    if p_cnt >= s:
        raise ValueError(f"ring mode needs PROBES < VIEW_SIZE "
                         f"(got {p_cnt} >= {s})")
    if dynamic_knobs:
        check_dynamic_knobs(cfg)
    use_drop = dynamic_knobs or uses_drop(cfg)
    want_agg = cfg.fast_agg and not cfg.collect_events
    want_hist = cfg.telemetry_hist and p_cnt > 0
    fail_ids = cfg.fail_ids if want_agg else ()
    scn = cfg.scenario
    track_budget = cfg.send_budget > 0
    # Partitions, flakes and the send budget mask every shift: K2's masks
    # form throughout.
    gossip_masks = use_drop or track_budget or (
        scn is not None and bool(scn.n_parts or scn.n_flakes))
    table = shift_table(n, cfg.shift_set) if cfg.shift_set else None
    tables = {}                 # the SHIFT_SET table on each device

    def step(state: HashState, t: int, key: Key, plan: PlanTensors,
             rng=None, fanout=None, drop_prob=None):
        if t < 0:
            raise ValueError("ticks start at 0")
        dev = state.view.device
        idx = torch.arange(n, dtype=I64, device=dev)
        fanout_eff, p_drop = knob_values(cfg, fanout, drop_prob)
        if rng is None:
            rng = ring_rng_plans(cfg, [key], dev, use_drop)[0]
        f = tick_faults(plan, t, idx, n, p_drop)
        # Consumed in the JAX step's order: join control, gossip, the
        # seed burst, probes.
        budget = SendBudget(cfg.send_budget, dev) if track_budget else None
        # The coins that kill a message this tick, counted for TELEMETRY.
        dropped = [] if cfg.telemetry else None

        # ---- join control plane, nodeStart, self refresh ----
        # (Under warm join nobody starts or asks to join: no control
        # message exists, so none is masked.)
        ctrl_drop = None
        if cfg.cold_join:
            p_ctrl = [f.prob(t, idx, intro), f.prob(t, intro, idx)]
            if not all(no_coin(p) for p in p_ctrl):
                ctrl_drop = torch.stack([
                    coin_at(u, p) for u, p in
                    zip(rng.ctrl_u.reshape(2, n), p_ctrl)])
            if f.cuts is not None:
                cut = cross_group(f.cuts, idx, intro)[None, :]
                ctrl_drop = (cut.expand(2, n) if ctrl_drop is None
                             else ctrl_drop | cut)
        jp = join_plane(cfg, state, t, plan, idx,
                        None if ctrl_drop is None else ~ctrl_drop, f.held,
                        budget)
        if dropped is not None and use_drop and ctrl_drop is not None:
            dropped.append(count_ctrl_dropped(jp, plan, t, idx, ctrl_drop))
        recv_mask, act, recv_tick = jp.recv_mask, jp.act, jp.recv_tick
        rcol = recv_mask[:, None]

        # ---- ack candidates: probes issued at t-2, answered with the
        # target's heartbeat at t-1 (0 if it was not act) ----
        cand_full = torch.zeros((n, s), dtype=I32, device=dev)
        ack_recv_cnt = torch.zeros((n,), dtype=I32, device=dev)
        will_flush = will_flush_of(plan, t, recv_mask, f)
        if p_cnt > 0:
            with record_function(PHASE_ACK):
                ids2 = state.probe_ids2
                id2 = (ids2.to(I64) - 1).clamp_min(0)
                vec = torch.where(state.act_prev, state.self_hb - 1, 0)
                ids1 = state.probe_ids1
                v1 = ids1 != 0
                tgt1 = (ids1.to(I64) - 1).clamp_min(0)
                if cfg.probe_io_lag:
                    # The counter bits of the probes issued at t-2 ride the
                    # ack gather: last tick's will-flush and act.
                    lag_bits = _pack_probe_table(vec, state.wf_prev,
                                                 state.act_prev)[id2]
                    hb_ack = _gathered_hb(lag_bits)
                elif cfg.probe_io_none:
                    hb_ack = vec[id2]
                else:
                    tbl = _pack_probe_table(vec, will_flush, act)
                    gcat = tbl[torch.cat([id2, tgt1], dim=1)]  # one gather
                    hb_ack = _gathered_hb(gcat[:, :p_cnt])
                    probe_bits1 = gcat[:, p_cnt:]
                valid2 = (ids2 != 0) & (hb_ack > 0)
                if f.cuts_prev is not None:
                    # The ack crossed target -> prober during tick t-1.
                    valid2 &= ~cross_group(f.cuts_prev, id2, idx[:, None])
                p_ack = f.prob(t - 1, id2, idx[:, None])
                if not no_coin(p_ack):
                    coin = coin_at(rng.ack_u.reshape(n, p_cnt), p_ack)
                    if dropped is not None:
                        dropped.append((valid2 & coin).sum(dtype=I32))
                    valid2 = valid2 & ~coin
                cand = torch.where(valid2, to_bits(pack_u(cfg, hb_ack, id2)),
                                   0)
                ptr2 = ((t - 2) * p_cnt) % s
                cols2 = (ptr2 + torch.arange(p_cnt, device=dev)) % s
                cand_full[:, cols2] = cand
                ack_recv_cnt = (valid2 & rcol).sum(1, dtype=I32)

        # ---- receive: admit, ack refresh, self refresh, sweep (K1) ----
        with record_function(PHASE_RECEIVE):
            (view, view_ts, mail, join_mask, rm_ids, numfailed,
             size) = receive_fused(n, s, cfg.tfail, cfg.tremove, STRIDE, t,
                                   state.view, state.view_ts, state.mail,
                                   cand_full, recv_mask, act, jp.self_on,
                                   jp.self_val)
        if cfg.cold_join:
            mail = joinreq_to_intro(cfg, mail, jp.joiner_req)
        present = view != 0
        difft = t - view_ts

        # ---- gossip (K2) ----
        numpotential = size - 1 - numfailed
        fresh = present & (difft < cfg.tfail)
        is_self_slot = present & (member_of(view, n) == idx[:, None])
        seed_burst_on = act[intro]
        n_seeds_row = torch.where((idx == intro) & seed_burst_on, jp.n_seeds,
                                  0)
        k_eff = (numpotential.clamp(max=fanout_eff)
                 - n_seeds_row).clamp_min(0).to(I32)
        if g >= s:
            keep = fresh
        else:
            fresh_cnt = fresh.sum(1, dtype=I32)
            p_keep = torch.where(
                fresh_cnt > 1,
                (g - 1) / (fresh_cnt - 1).clamp_min(1).to(torch.float32),
                1.0)
            u = rng.thin_u.reshape(n, s)
            keep = fresh & ((u < p_keep[:, None]) | is_self_slot)
        keep = keep & act[:, None]
        shifts = (rng.shift_draw if table is None
                  else table_shifts(tables, table, rng.shift_draw, I32))
        sent_gossip = torch.zeros((n,), dtype=I32, device=dev)
        recv_add = torch.zeros((n,), dtype=I32, device=dev)
        with record_function(PHASE_GOSSIP):
            if k_max > 0 and not gossip_masks:
                # Payload is nonzero exactly where keep holds, so a row's
                # message count per shift is its kept count under the
                # fanout.
                mail = gossip_fused(n, s, k_max, mail,
                                    torch.where(keep, view, 0), k_eff, shifts)
                c0 = keep.sum(1, dtype=I32)
                for j in range(k_max):
                    cnt = torch.where(j < k_eff, c0, 0)
                    sent_gossip += cnt
                    recv_add += _roll(cnt, shifts[j], idx, n)
            elif k_max > 0:
                masks = torch.empty((k_max, n, s), dtype=torch.bool,
                                    device=dev)
                for j in range(k_max):
                    m = keep & (j < k_eff)[:, None]
                    # Shift j sends row i to row (i + shift) mod n.
                    dst = (idx + shifts[j]) % n
                    if f.cuts is not None:
                        m &= ~cross_group(f.cuts, idx, dst)[:, None]
                    p_g = f.prob(t, idx, dst)
                    if not no_coin(p_g):
                        coin = coin_at(rng.gossip_u[j].reshape(n, s), p_g)
                        if dropped is not None:
                            dropped.append((m & coin).sum(dtype=I32))
                        m &= ~coin
                    if budget is not None:
                        m = budget.take(m)
                    masks[j] = m
                    cnt = m.sum(1, dtype=I32)
                    sent_gossip += cnt
                    recv_add += _roll(cnt, shifts[j], idx, n)
                mail = gossip_fused(n, s, k_max, mail, view, k_eff, shifts,
                                    masks=masks)
        sent_tick = sent_gossip + jp.sent_req + jp.sent_rep

        # ---- introducer burst to this tick's joiners (full fresh view) --
        cap = min(cfg.seed_cap, n)
        burst_drop = None
        if cfg.cold_join:
            seed_rows = torch.sort(jp.seeds.to(I32), descending=True,
                                   stable=True).indices[:cap]
            if f.cuts is not None:
                burst_drop = cross_group(f.cuts, intro,
                                         seed_rows)[:, None].expand(cap, s)
            p_b = f.prob(t, intro, seed_rows)
            if not no_coin(p_b):
                burst_coin = coin_at(rng.burst_u.reshape(cap, s), p_b)
                if dropped is not None:
                    live = (jp.seeds[seed_rows] & seed_burst_on)[:, None] \
                        & fresh[intro][None, :]
                    if burst_drop is not None:
                        live &= ~burst_drop
                    dropped.append((live & burst_coin).sum(dtype=I32))
                burst_drop = (burst_coin if burst_drop is None
                              else burst_drop | burst_coin)
        mail, seed_idx, seed_valid, burst_valid = seed_burst(
            cfg, mail, view, fresh[intro], jp.seeds, seed_burst_on,
            burst_drop, budget)
        sent_tick[intro] += burst_valid.sum(dtype=I32)
        recv_add.index_add_(0, seed_idx, burst_valid.sum(1, dtype=I32)
                            * seed_valid.to(I32))

        # ---- SWIM round-robin probing (K3) ----
        probe_ids1, probe_ids2 = state.probe_ids1, state.probe_ids2
        act_prev = state.act_prev
        pfo = None
        if p_cnt > 0:
            with record_function(PHASE_PROBE):
                ptr = (t * p_cnt) % s
                pfo = probe_window_fused(
                    n, s, p_cnt, cfg.tfail, fail_ids, want_hist, want_agg,
                    t, ptr, 0, view, view_ts if want_hist else None, act,
                    rm_ids if want_agg else None)
                window_ids = pfo["ids"]
                p_valid = window_ids != 0
                w_id = (window_ids.to(I64) - 1).clamp_min(0)
                if f.cuts is not None:
                    p_valid = p_valid & ~cross_group(f.cuts, idx[:, None],
                                                     w_id)
                p_pr = f.prob(t, idx[:, None], w_id)
                if not no_coin(p_pr):
                    coin = coin_at(rng.probe_u.reshape(n, p_cnt), p_pr)
                    if dropped is not None:
                        dropped.append((p_valid & coin).sum(dtype=I32))
                    p_valid = p_valid & ~coin
                if budget is not None:
                    # A budget-dropped probe is never recorded, as a
                    # coin-dropped one.
                    p_valid = budget.take_probes(p_valid, p_red)
                probe_ids2 = probe_ids1
                probe_ids1 = torch.where(p_valid, window_ids, 0)
                act_prev = act
                sent_probes = p_valid.sum(1, dtype=I32) * p_red
                if cfg.count_probe_io:
                    # Probes issued at t-1 arrive now; act targets ack.
                    ack_send = v1 & _gathered_act(probe_bits1)
                    recv_probe = count_at(tgt1, v1, p_red, n)
                    sent_ack = count_at(tgt1, ack_send, 1, n)
                elif cfg.probe_io_none:
                    recv_probe = sent_ack = torch.zeros_like(sent_probes)
                elif cfg.probe_io_lag:
                    # Arrivals at t-1 counted from last tick's bits; the
                    # recvs go straight into this tick's stream, where the
                    # exact count's pending flush lands.
                    v2 = ids2 != 0
                    recv_probe = torch.zeros_like(sent_probes)
                    recv_tick = recv_tick + (
                        v2 & _gathered_flush(lag_bits)).sum(
                            1, dtype=I32) * p_red
                    sent_ack = (v2 & _gathered_act(lag_bits)).sum(
                        1, dtype=I32)
                else:
                    per_prober = (v1 & _gathered_flush(probe_bits1)).sum(
                        1, dtype=I32) * p_red
                    recv_probe = _credit_orphan_recvs(per_prober, will_flush)
                    sent_ack = (v1 & _gathered_act(probe_bits1)).sum(
                        1, dtype=I32)
                sent_tick = sent_tick + sent_probes + sent_ack
                recv_add = recv_add + recv_probe + ack_recv_cnt
        pending_recv = jp.pending_recv + recv_add

        if cfg.collect_events:
            agg = state.agg
            join_ids = torch.where(join_mask & present, member_of(view, n),
                                   EMPTY).to(I32)
            out = SparseTickEvents(join_ids, rm_ids, sent_tick, recv_tick)
        elif not want_agg:
            with record_function(PHASE_AGG):
                cur_id = torch.where(present, member_of(view, n), EMPTY)
                join_ids = torch.where(join_mask, cur_id, EMPTY)
                agg = update_agg(
                    state.agg, t=t, join_ids=join_ids, rm_ids=rm_ids,
                    view_ids=cur_id, view_present=present,
                    fail_mask=plan.fail_mask, fail_time=plan.fail_time,
                    sent_tick=sent_tick, recv_tick=recv_tick)
                out = SparseTickEvents((join_ids != EMPTY).sum(dtype=I32),
                                       (rm_ids != EMPTY).sum(dtype=I32),
                                       sent_tick.sum(dtype=I32),
                                       recv_tick.sum(dtype=I32))
        else:
            with record_function(PHASE_AGG):
                # K3's row partials, or (with no probes, so no K3) the
                # same sums over the removal plane.
                rm_cnt = (pfo["rm_cnt"] if pfo is not None
                          else (rm_ids >= 0).sum(1, dtype=I32))
                det = None
                if fail_ids:
                    det = (pfo["det"] if pfo is not None else torch.stack(
                        [(rm_ids == f).sum(1, dtype=I32) for f in fail_ids]))
                view_ids = (torch.where(present, member_of(view, n), EMPTY)
                            if t == plan.fail_time and fail_ids else None)
                agg = update_fast_agg(
                    state.agg, t=t, fail_ids=fail_ids, join_events=join_mask,
                    rm_total_tick=rm_cnt.sum(dtype=I32),
                    det_tick=None if det is None else det.sum(1, dtype=I32),
                    any_true_rm=None if det is None else (det > 0).any(0),
                    view_ids=view_ids, view_present=present,
                    fail_time=plan.fail_time, holder_failed=plan.fail_mask,
                    sent_tick=sent_tick, recv_tick=recv_tick)
                out = SparseTickEvents((join_mask & present).sum(dtype=I32),
                                       rm_cnt.sum(dtype=I32),
                                       sent_tick.sum(dtype=I32),
                                       recv_tick.sum(dtype=I32))
        # End-of-tick crash/leave/restart transitions: after the agg fold,
        # which reads this tick's views.
        new_state = restart_wipe(HashState(
            view, view_ts, jp.started, jp.in_group,
            failed_after(plan, t, state.failed, f), jp.self_hb, mail,
            state.amail, state.pmail, jp.joinreq_infl, jp.joinrep_infl,
            pending_recv, agg, probe_ids1, probe_ids2, act_prev,
            will_flush if cfg.probe_io_lag else state.wf_prev),
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


def _admit(n: int, self_mask, idx, view, incoming):
    """Sticky admit-or-refresh (JAX ``make_admit``) on int64 planes
    holding u32 values: an occupied slot takes only its occupant's id, an
    empty one the incoming winner, and the self slot only the node's own
    id."""
    in_id = ((incoming - 1) & M32) % n
    matches = in_id == ((view - 1) & M32) % n
    ok = ((self_mask & (in_id == idx[:, None]))
          | (~self_mask & ((view == 0) | matches)))
    take = (incoming > 0) & ok
    return torch.where(take, torch.maximum(view, incoming), view)


def make_scatter_step(cfg: HashConfig, dynamic_knobs: bool = False):
    """The scatter exchange (the JAX ``make_step``'s ``not ring``
    branches): the amail and mail merge by sticky admission, the JOINREQ
    scatter, gossip to ``k_eff`` sampled view occupants with ``G`` sampled
    entries each, the seed burst, and SWIM probes through the hashed
    probe mailbox (``pmail``, twice when ``Qp < N``) answered into the ack
    mailbox (``amail``).  Its random streams are the JAX ones: the tick key
    split 8 ways, ``bernoulli(k, p, shape)`` as ``uniform(k, shape) <
    f32(p)``.  In EVENT_MODE agg the events fold into ``AggStats``.
    ``dynamic_knobs`` as in :func:`make_step`: the drop keys are split and
    the coins drawn on every tick of the drop window."""
    n, s, g, p_cnt, qp = cfg.n, cfg.s, cfg.g, cfg.probes, cfg.qp
    intro = INTRODUCER_INDEX
    k_max = min(cfg.fanout, s)
    p_red = 1 if qp >= n else 2
    use_drop = dynamic_knobs or cfg.drop_prob > 0.0
    cap = min(cfg.seed_cap, n)

    def step(state: HashState, t: int, key: Key, plan: PlanTensors,
             fanout=None, drop_prob=None):
        if t < 0:
            raise ValueError("ticks start at 0")
        fanout_eff, p_drop = knob_values(cfg, fanout, drop_prob)
        dev = state.view.device
        idx = torch.arange(n, dtype=I64, device=dev)
        (k_targets, k_entries, k_drop, k_ctrl, k_drop_p, _k_shifts,
         _k_ack1, _k_ack2) = split(key, 8)
        coins = use_drop and plan.drop_active(t)

        def dropped(k, shape):
            return uniform(k, shape, dev) < p_drop

        jp = join_plane(cfg, state, t, plan, idx,
                        ~dropped(k_ctrl, (2, n)) if coins else None)
        recv_mask, act = jp.recv_mask, jp.act
        rcol = recv_mask[:, None]

        # ---- receive: acks, then gossip, by sticky admission ----
        self_slot = slot_of(cfg, idx, idx)
        self_mask = (torch.arange(s, device=dev)[None, :]
                     == self_slot[:, None])
        v0 = as_u32(state.view)
        view = torch.where(rcol, _admit(n, self_mask, idx, v0,
                                        as_u32(state.amail)), v0)
        view = torch.where(rcol, _admit(n, self_mask, idx, view,
                                        as_u32(state.mail)), view)
        changed = view > v0
        view_ts = torch.where(changed, t, state.view_ts)
        mail = torch.where(rcol, 0, state.mail)
        amail = torch.where(rcol, 0, state.amail)
        join_ids = torch.where(changed & (v0 == 0),
                               ((view - 1) & M32) % n, EMPTY).to(I32)
        # The probe mailbox holds bare prober ids (id + 1, 0 = empty).
        ack_valid = (state.pmail != 0) & rcol
        pmail = torch.where(rcol, 0, state.pmail)
        mail = _scatter_msgs(cfg, mail, torch.full_like(idx, intro), idx,
                             torch.zeros_like(idx), jp.joiner_req)

        # ---- self refresh, then the TFAIL / TREMOVE sweep ----
        view[idx, self_slot] = torch.where(
            jp.self_on, as_u32(jp.self_val), view[idx, self_slot])
        view_ts[idx, self_slot] = torch.where(
            jp.self_on, t, view_ts[idx, self_slot])
        present = view > 0
        cur_id = torch.where(present, ((view - 1) & M32) % n, EMPTY)
        cur_hb = torch.where(present, ((view - 1) & M32) // n, -1)
        difft = t - view_ts
        stale = present & (difft >= cfg.tfail) & act[:, None]
        numfailed = stale.sum(1, dtype=I32)
        removes = stale & (difft >= cfg.tremove)
        rm_ids = torch.where(removes, cur_id, EMPTY).to(I32)
        view = to_bits(torch.where(removes, 0, view))
        present = present & ~removes
        size = present.sum(1, dtype=I32)

        # ---- gossip to sampled view occupants ----
        numpotential = size - 1 - numfailed
        fresh = present & (difft < cfg.tfail)
        is_self_slot = cur_id == idx[:, None]
        seed_burst_on = act[intro]
        n_seeds_row = torch.where((idx == intro) & seed_burst_on, jp.n_seeds,
                                  0)
        k_eff = (numpotential.clamp(max=fanout_eff)
                 - n_seeds_row).clamp_min(0)
        eligible = fresh & ~is_self_slot & act[:, None]
        in_seed = jp.seeds[cur_id[intro].clamp_min(0)] & present[intro]
        eligible[intro] &= ~in_seed
        tgt_slot, tgt_valid = sample_k_indices(
            uniform(k_targets, (n, s), dev), eligible, k_eff, k_max)
        tgt = cur_id.gather(1, tgt_slot)
        if g >= s:
            e_ids, e_hbs, e_valid = cur_id, cur_hb, fresh
        else:
            scores = torch.where(is_self_slot, -1.0,
                                 uniform(k_entries, (n, s), dev))
            scores = torch.where(fresh, scores, 2.0)
            e_idx = torch.sort(-scores, dim=1, descending=True,
                               stable=True).indices[:, :g]
            e_valid = fresh.gather(1, e_idx)
            e_ids = cur_id.gather(1, e_idx)
            e_hbs = cur_hb.gather(1, e_idx)
        g_eff = e_ids.shape[1]
        msg_valid = tgt_valid[:, :, None] & e_valid[:, None, :]
        k_drop_f, k_drop_s = split(k_drop) if use_drop else (None, k_drop)
        if coins:
            msg_valid = msg_valid & ~dropped(k_drop_f, (n, k_max, g_eff))
        shape3 = (n, k_max, g_eff)
        mail = _scatter_msgs(cfg, mail, tgt[:, :, None].expand(shape3),
                             e_ids[:, None, :].expand(shape3),
                             e_hbs[:, None, :].expand(shape3), msg_valid)
        sent_tick = (msg_valid.sum((1, 2), dtype=I32) + jp.sent_req
                     + jp.sent_rep)
        recv_add = count_at(tgt, tgt_valid, msg_valid.sum(2, dtype=I32), n)

        # ---- introducer burst to this tick's joiners (full fresh view) --
        mail, seed_idx, seed_valid, burst_valid = seed_burst(
            cfg, mail, view, fresh[intro], jp.seeds, seed_burst_on,
            dropped(k_drop_s, (cap, s)) if coins else None)
        sent_tick[intro] += burst_valid.sum(dtype=I32)
        recv_add.index_add_(0, seed_idx, burst_valid.sum(1, dtype=I32)
                            * seed_valid.to(I32))

        # ---- SWIM round-robin probes into the hashed probe mailbox ----
        # Only the window's P columns can probe and only the acks due can
        # ack, so both run on those entries alone: the JAX step's [N, S]
        # and [N, Qp] planes send nothing elsewhere, and element i of a
        # coin draw depends on i alone.
        if p_cnt > 0:
            cols = (t * p_cnt + torch.arange(p_cnt, device=dev)) % s
            p_valid = (present[:, cols] & ~is_self_slot[:, cols]
                       & act[:, None])
            p_tgt = cur_id[:, cols]
            due = (ack_valid & act[:, None]).reshape(-1).nonzero().squeeze(1)
            if coins:
                kd1, kd2 = split(k_drop_p)
                p_valid &= ~(uniform_at(kd1, idx[:, None] * s + cols[None, :],
                                        n * s) < p_drop)
                due = due[~(uniform_at(kd2, due, n * qp) < p_drop)]
            own_id_p = idx[:, None].expand(n, p_cnt)
            for c in range(p_red):
                paddr = p_tgt * qp + hash_slot(own_id_p, t + c * 0x2545F49,
                                               qp, n)
                pmail = scatter_umax(pmail,
                                      torch.where(p_valid, paddr, n * qp),
                                      own_id_p + 1)
            mail = _scatter_msgs(cfg, mail, p_tgt, own_id_p,
                                 jp.own_hb[:, None].expand(n, p_cnt), p_valid)
            # Ack: my (id, current hb) into each prober's ack mailbox.
            acker = due // qp
            prober = as_u32(state.pmail).reshape(-1)[due] - 1
            sent = torch.ones_like(due, dtype=torch.bool)
            amail = _scatter_msgs(cfg, amail, prober, acker,
                                  jp.own_hb[acker], sent)
            sent_tick = (sent_tick + p_valid.sum(1, dtype=I32) * p_red
                         + count_at(acker, sent, 1, n))
            recv_add = (recv_add + count_at(p_tgt, p_valid, p_red, n)
                        + count_at(prober, sent, 1, n))

        failed = (state.failed | plan.fail_mask if t == plan.fail_time
                  else state.failed)
        agg = state.agg
        out = SparseTickEvents(join_ids, rm_ids, sent_tick, jp.recv_tick)
        if not cfg.collect_events:
            agg = update_agg(
                agg, t=t, join_ids=join_ids, rm_ids=rm_ids, view_ids=cur_id,
                view_present=present, fail_mask=plan.fail_mask,
                fail_time=plan.fail_time, sent_tick=sent_tick,
                recv_tick=jp.recv_tick)
            out = SparseTickEvents(*(x.sum(dtype=I32) for x in (
                join_ids != EMPTY, rm_ids != EMPTY, sent_tick,
                jp.recv_tick)))
        new_state = HashState(
            view, view_ts, jp.started, jp.in_group, failed,
            jp.self_hb, mail, amail, pmail, jp.joinreq_infl,
            jp.joinrep_infl, jp.pending_recv + recv_add, agg,
            state.probe_ids1, state.probe_ids2, state.act_prev,
            state.wf_prev)
        return new_state, out

    return step


def _refuse_on(what: str, why: str) -> None:
    """A refusal by design: ``what`` cannot run here, for ``why``."""
    raise NotImplementedError(f"{what}: {why}")


def _folded_gates(params: Params, n: int, s: int, collect_events: bool,
                  fast_agg: bool, pinned_kernels: bool) -> Optional[str]:
    """Why the folded layout cannot run this config, in the JAX package's
    words (``tpu_hash.make_config``), or None.  ``pinned_kernels``: a
    ``FUSED_*: 1`` pins the folded kernels (on CUDA), which the JAX
    package gates on at least 8 plane rows; the port's K5-K7 take any
    number of plane rows, so auto knobs pass here."""
    from distributed_membership_tpu_torch.backends.tpu_hash_folded import (
        folded_supported)
    p_cnt = params.PROBES
    if params.resolved_exchange() != "ring" or params.JOIN_MODE != "warm":
        return "FOLDED requires EXCHANGE ring and JOIN_MODE warm"
    if collect_events:
        return "FOLDED requires aggregate events (EVENT_MODE agg)"
    if not folded_supported(n, s, p_cnt):
        return (f"FOLDED needs 0 < VIEW_SIZE < 128 dividing 128, N a "
                f"multiple of 128/VIEW_SIZE, and PROBES dividing 128 "
                f"(got N={n}, S={s}, P={p_cnt})")
    if not fast_agg:
        return ("FOLDED requires the FastAgg event path (a static failed "
                f"set of at most {FAST_AGG_MAX_FAILED} ids)")
    if pinned_kernels and (n * s) // 128 < 8:
        return (f"FOLDED FUSED_* kernels need at least 8 plane rows "
                f"(N*VIEW_SIZE/128 >= 8; got N={n}, S={s})")
    # The folded step runs the probe traversal (K7 or its plain version)
    # only with probes, so the JAX FUSED_PROBE gate holds where P > 0.
    if p_cnt > 0 and not p_cnt < s:
        return (f"FUSED_PROBE needs 0 < PROBES < VIEW_SIZE "
                f"(got PROBES={p_cnt}, S={s})")
    return None


def make_config(params: Params, collect_events: bool = True,
                fail_ids: tuple = (), device="cpu",
                scenario=None) -> HashConfig:
    """The JAX ``make_config`` for the ported layouts (natural or folded
    ring, scatter), with the refusals of the ported slices (module
    docstring).  ``scenario`` is a general scenario's ScenarioStatic."""
    n = params.EN_GPSZ
    s = params.VIEW_SIZE if params.VIEW_SIZE > 0 else n
    g = params.GOSSIP_LEN if params.GOSSIP_LEN > 0 else s
    exchange = params.resolved_exchange()
    ring = exchange == "ring"
    if scenario is not None:
        # The JAX package's gates, word for word.
        if not ring:
            raise ValueError(
                "SCENARIO files with restart/partition/link_flake "
                "events require the ring exchange on the hash backends "
                "(EXCHANGE ring / the warm-join auto regime); the "
                "scatter lowering runs legacy-shaped scenarios only")
        if params.ENFORCE_BUFFSIZE:
            raise ValueError(
                "SCENARIO general events and ENFORCE_BUFFSIZE are "
                "incompatible (the sequential send budget does not "
                "model the per-shift partition/flake masks)")
    if params.PROBE_IO == "approx_lag" and not ring:
        raise ValueError(
            "PROBE_IO approx_lag requires EXCHANGE ring (scatter keeps "
            "exact slot-addressed counters)")
    on_cuda = torch.device(device).type == "cuda"
    fast_agg = (not collect_events and ring
                and len(fail_ids) <= FAST_AGG_MAX_FAILED)
    send_budget = params.EN_BUFFSIZE if params.ENFORCE_BUFFSIZE else 0
    knobs = {k: getattr(params, k)
             for k in ("FUSED_RECEIVE", "FUSED_GOSSIP", "FUSED_PROBE")}
    pinned = on_cuda and 1 in knobs.values()
    why_not_folded = _folded_gates(params, n, s, collect_events, fast_agg,
                                   pinned_kernels=pinned)
    if params.FOLDED == 1 and why_not_folded:
        raise ValueError(why_not_folded)
    if (why_not_folded and params.FOLDED == -1 and on_cuda and ring
            and not collect_events
            and params.BACKEND in ("tpu_hash", "tpu_hash_sharded")):
        # The card's route for AggStats (more than FAST_AGG_MAX_FAILED
        # failed ids) at S < 128: the folded planes are the natural
        # [N, S] bytes, so the folded step updates AggStats on their
        # [N, S] view and equals the natural step bit for bit.  Auto
        # takes it on one card (for tpu_hash_sharded where its shards'
        # rows fold, sharded_config); a pinned FOLDED: 1 keeps the JAX
        # gate.
        why_not_folded = _folded_gates(params, n, s, collect_events, True,
                                       pinned_kernels=pinned)
    # Auto keeps the folded layout off where a pinned FOLDED would raise
    # (the budget, approx_lag: JAX gates below and in step_and_init) and
    # under the service, whose snapshot reads the natural carry.
    folded = params.FOLDED == 1 or (
        params.FOLDED == -1 and on_cuda and s < 128 and not why_not_folded
        and not send_budget and params.PROBE_IO != "approx_lag"
        and params.SERVICE_PORT < 0)
    if ring and knobs["FUSED_PROBE"] == 1 and params.PROBES <= 0:
        raise ValueError(
            "FUSED_PROBE requires the ring exchange with PROBES > 0")
    if not ring:
        # The JAX gates, word for word; -1 resolves off (the scatter step
        # has no kernel in either package).
        if knobs["FUSED_RECEIVE"] == 1:
            raise ValueError("FUSED_RECEIVE requires the ring exchange")
        if knobs["FUSED_GOSSIP"] == 1:
            raise ValueError("FUSED_GOSSIP requires the ring exchange")
        if knobs["FUSED_PROBE"] == 1:
            raise ValueError(
                "FUSED_PROBE requires the ring exchange with PROBES > 0")
    if ring and on_cuda and not folded:
        # A pinned kernel on the natural layout: the JAX gates of its
        # 128-lane tiling, word for word.  The CUDA kernels take any
        # geometry, so auto (-1) takes them there.
        tiled = s % 128 == 0 and n >= 8
        if knobs["FUSED_RECEIVE"] == 1 and not tiled:
            raise ValueError(
                f"FUSED_RECEIVE needs VIEW_SIZE % 128 == 0 and N >= 8 "
                f"(got N={n}, S={s}); for S < 128 combine it with FOLDED")
        if knobs["FUSED_GOSSIP"] == 1 and not (
                tiled and (n * STRIDE) % s == 0):
            raise ValueError(
                f"FUSED_GOSSIP needs VIEW_SIZE % 128 == 0 and "
                f"(N*STRIDE) % VIEW_SIZE == 0 (got N={n}, S={s}); for "
                f"S < 128 combine it with FOLDED")
        if knobs["FUSED_PROBE"] == 1 and not (
                tiled and 0 < params.PROBES < s):
            raise ValueError(
                f"FUSED_PROBE needs VIEW_SIZE % 128 == 0, N >= 8 and "
                f"0 < PROBES < VIEW_SIZE (got N={n}, S={s}, "
                f"P={params.PROBES}); for S < 128 combine it with FOLDED")
    # Multi-tick blocks: auto (-1) resolves off, as the JAX package's
    # does away from a TPU; its gates, word for word.
    mega = max(params.MEGA_TICKS, 0)
    if mega > 0 and not ring:
        raise ValueError(
            "MEGA_TICKS requires the ring exchange (the scatter "
            "lowering keeps the per-tick scan)")
    mega_pack = params.MEGA_PACK
    if mega_pack == -1:
        mega_pack = int(mega > 1 and pack_fits(params.TOTAL_TIME))
    elif mega_pack == 1:
        if mega <= 1:
            raise ValueError(
                "MEGA_PACK: 1 requires MEGA_TICKS >= 2 (resolved "
                f"T={mega}: no T-block boundary exists to shrink)")
        if not pack_fits(params.TOTAL_TIME):
            raise ValueError(
                f"MEGA_PACK: 1 cannot prove the 16-bit carry bound for "
                f"TOTAL_TIME={params.TOTAL_TIME} (heartbeats/timestamps "
                f"must stay under 2**16 after the +1 sentinel offset: "
                f"at most {PACK_SAFE_TICKS} ticks — "
                "ops/megakernel.PACK_SAFE_TICKS); use MEGA_PACK 0 or "
                "-1 (auto widens to the full-width carry)")
    # The JAX gates of SHIFT_SET and ENFORCE_BUFFSIZE, word for word.  A
    # pinned FUSED_GOSSIP: 1 conflicts with both there, though K2 takes
    # the table's shifts and the budgeted masks here (auto takes K2).
    fused_g = knobs["FUSED_GOSSIP"] == 1
    if params.SHIFT_SET:
        if not ring:
            raise ValueError("SHIFT_SET requires the ring exchange")
        if params.BACKEND != "tpu_hash":
            raise ValueError(
                "SHIFT_SET is single-chip tpu_hash only (the sharded "
                "step's local rolls + collectives are a different "
                "lowering; measure the mitigation single-chip first)")
        if fused_g:
            raise ValueError(
                "SHIFT_SET and FUSED_GOSSIP are incompatible (the "
                "Pallas kernel rolls in VMEM — dynamic shifts are not "
                "its bottleneck)")
        if n <= params.SHIFT_SET:
            raise ValueError(
                f"SHIFT_SET ({params.SHIFT_SET}) must be < N ({n})")
    if send_budget:
        if not ring:
            raise ValueError(
                "ENFORCE_BUFFSIZE on tpu_hash requires the ring exchange "
                "(the emul backends enforce the cap natively; the scatter "
                "lowering does not model it — README fidelity notes)")
        if params.BACKEND == "tpu_hash_sharded":
            raise ValueError(
                "ENFORCE_BUFFSIZE is not modeled on tpu_hash_sharded "
                "(its scatter exchange bounds per-destination buckets "
                "instead — bucket_capacity; README fidelity notes)")
        if folded:
            raise ValueError(
                "ENFORCE_BUFFSIZE is not modeled on the FOLDED layout")
        if fused_g:
            raise ValueError(
                "ENFORCE_BUFFSIZE and FUSED_GOSSIP are incompatible (the "
                "budget is a per-slot send mask; the natural-layout kernel "
                "applies its fanout mask in-kernel)")
    # EXCHANGE_MODE batches the shifts that cross shards: the sharded ring
    # steps only ('-1' is legacy, as the JAX package off its TPU).
    batched_x = (params.BACKEND == "tpu_hash_sharded"
                 and params.EXCHANGE_MODE == "batched")
    if batched_x and not ring:
        raise ValueError(
            "EXCHANGE_MODE batched requires the ring exchange on "
            "tpu_hash_sharded (the scatter lowering has no per-shift "
            "collective round to batch)")
    if ring and n < 4:
        raise ValueError("the ring step's packed probe table needs N >= 4")
    if on_cuda and ring:
        pinned_off = [k for k, v in knobs.items() if v == 0]
        if pinned_off:
            _refuse_on(f"{'/'.join(pinned_off)}: 0 on CUDA",
                       "the kernels are the path there; the plain versions "
                       "run on CPU tensors only")
    elif not on_cuda:
        pinned_on = [k for k, v in knobs.items() if v == 1]
        if pinned_on:
            _refuse_on(f"{'/'.join(pinned_on)}: 1 on the CPU",
                       "it pins the CUDA kernels, which run only on the "
                       "card; use -1 or 0")
    return HashConfig(
        n=n, s=s, g=min(g, s), tfail=params.TFAIL, tremove=params.TREMOVE,
        fanout=params.FANOUT, drop_prob=params.effective_drop_prob(),
        probes=params.PROBES,
        qp=n if n <= 1024 else max(128, 32 * params.PROBES),
        seed_cap=n if params.JOIN_MODE == "batch" else SEED_CAP,
        collect_events=collect_events,
        exchange=exchange, cold_join=params.JOIN_MODE != "warm",
        fail_ids=tuple(int(f) for f in fail_ids) if fast_agg else (),
        fast_agg=fast_agg,
        count_probe_io=probe_attribution_exact(params),
        folded=folded,
        telemetry=params.TELEMETRY in ("scalars", "hist"),
        telemetry_hist=params.TELEMETRY == "hist",
        scenario=scenario,
        rng_mode=params.RNG_MODE if ring else "scattered",
        mega_ticks=mega, mega_pack=bool(mega_pack),
        probe_io_none=params.PROBE_IO == "none",
        probe_io_lag=params.PROBE_IO == "approx_lag",
        send_budget=send_budget, shift_set=params.SHIFT_SET,
        batched_exchange=batched_x)


def resolve_mega_pack(cfg: HashConfig, params: Params,
                      total: int) -> HashConfig:
    """Re-prove the shrunk-carry bound for the run's effective length
    (JAX ``resolve_mega_pack``): auto widens to the full-width carry, a
    pinned ``MEGA_PACK: 1`` raises."""
    if not cfg.mega_pack or pack_fits(total):
        return cfg
    if params.MEGA_PACK == 1:
        raise ValueError(
            f"MEGA_PACK: 1 cannot prove the 16-bit carry bound for the "
            f"effective run length {total} (at most {PACK_SAFE_TICKS} "
            "ticks — ops/megakernel.PACK_SAFE_TICKS); use MEGA_PACK 0 "
            "or -1 (auto widens to the full-width carry)")
    return dataclasses.replace(cfg, mega_pack=False)


def step_and_init(cfg: HashConfig, dynamic_knobs: bool = False):
    """``(step, init)`` for the config's layout and join mode (the JAX
    ``_get_step_and_init``); ``init(cfg, key, device)``.  With
    ``dynamic_knobs`` the step takes the cell's ``fanout`` and
    ``drop_prob`` (:func:`make_step`) on either layout."""
    if cfg.folded and cfg.probe_io_lag:
        raise ValueError(
            "PROBE_IO approx_lag requires the natural layout "
            "(FOLDED: 0) — the folded step keeps the two-gather "
            "attribution")
    if cfg.folded:
        from distributed_membership_tpu_torch.backends.tpu_hash_folded import (
            init_state_warm_folded, make_folded_step)
        return (make_folded_step(cfg, dynamic_knobs=dynamic_knobs),
                init_state_warm_folded)
    return make_step(cfg, dynamic_knobs), (init_state_cold if cfg.cold_join
                                           else init_state_warm)


def plan_fail_ids(plan: FailurePlan) -> tuple:
    return tuple(plan.failed_indices) if plan.fail_time is not None else ()


def plan_scenario(plan: FailurePlan):
    """The general scenario's ScenarioStatic, or None."""
    return None if plan.scenario is None else plan.scenario.static


class SegmentRunner(NamedTuple):
    """A run's config, step, carry init and plan tensors (the JAX
    ``_get_segment_runner`` with the init beside it), built by
    :func:`segment_runner`: :func:`run_scan` drives it, and the service
    daemon's live injection builds another from the merged plan at a
    boundary and swaps its :meth:`segment` in (service/daemon.py), so
    both build the runner the same way."""
    cfg: HashConfig
    step: Callable
    init: Callable           # init(cfg, key, device)
    plan_t: PlanTensors
    key: Key
    device: object

    def init_carry(self):
        return self.init(self.cfg, self.key, self.device)

    def segment(self, state, a: int, b: int):
        """``chunked_run``'s ``segment_fn``: ticks ``[a, b)``."""
        return run_segment(self.step, state, self.plan_t, a, b, self.cfg)


def segment_runner(params: Params, plan: FailurePlan, seed: int, device,
                   collect_events: bool, total: int) -> SegmentRunner:
    """The :class:`SegmentRunner` of ``plan``: the config ``make_config``
    resolves for it (its general scenario included), its step and init,
    and its plan tensors over ``total`` ticks."""
    cfg = make_config(params, collect_events, fail_ids=plan_fail_ids(plan),
                      device=device, scenario=plan_scenario(plan))
    params.validate_sparse_packing(total)
    cfg = resolve_mega_pack(cfg, params, total)
    step, init = step_and_init(cfg)
    return SegmentRunner(cfg, step, init,
                         plan_tensors(params, plan, seed, total, device),
                         make_run_key(params, seed ^ 0x5EED), device)


def run_scan(params: Params, plan: FailurePlan, seed: int, device,
             collect_events: bool = True, total_time: Optional[int] = None,
             telemetry=None):
    """Run the whole simulation; returns ``(final_state, events)`` with
    ``events`` the host-compacted per-tick planes in full event mode and
    the per-tick ``[T]`` totals (a SparseTickEvents of int32 arrays) in
    agg mode.  ``telemetry``, a TimelineRecorder, receives the per-tick
    series under ``TELEMETRY: scalars|hist``: once, ``t0 = 0``, or per
    segment under ``CHECKPOINT_EVERY`` (runtime/checkpoint.py
    ``chunked_run``, which also writes and resumes snapshots)."""
    total = total_time if total_time is not None else params.TOTAL_TIME
    runner = segment_runner(params, plan, seed, device, collect_events,
                            total)
    cfg = runner.cfg
    finalize = None
    if cfg.probe_io_lag and cfg.probes > 0:
        def finalize(state, events):
            return lag_tail(cfg, state, events)
    if params.CHECKPOINT_EVERY > 0:
        from distributed_membership_tpu_torch.runtime.checkpoint import (
            chunked_run)
        return chunked_run(
            params, seed, total, device=device,
            init_carry=runner.init_carry, segment_fn=runner.segment,
            collect_events=collect_events, telemetry=telemetry,
            with_series=cfg.telemetry, finalize=finalize)
    state, events = run_ticks(runner.step, runner.init_carry(),
                              runner.plan_t, total, cfg, telemetry)
    if finalize is not None and total > 0:
        state, events = finalize(state, events)
    return state, events


def lag_tail(cfg: HashConfig, state: HashState, events):
    """``PROBE_IO: approx_lag``'s run-total epilogue (the JAX runner's lag
    tail and its chunked ``finalize``): the lagged counters cover the ack
    sends of arrivals up to the second-to-last tick; the last tick's (the
    probes in the final ``probe_ids2``, answered where ``act_prev``
    holds) are added to the last tick's sends and, in agg mode, to the
    per-node totals, so run totals equal exact mode's.  Recvs need none:
    exact mode's last arrivals strand in ``pending_recv``.  The
    telemetry series keeps its per-tick counters."""
    ids2 = state.probe_ids2
    corr = ((ids2 != 0) & state.act_prev[(ids2.to(I64) - 1).clamp_min(0)]
            ).sum(1, dtype=I32)
    sent = np.array(events.sent, copy=True)
    if cfg.collect_events:
        sent[-1] += corr.cpu().numpy()
    else:
        state = state._replace(agg=state.agg._replace(
            sent_total=state.agg.sent_total + corr))
        sent[-1] += int(corr.sum())
    return state, events._replace(sent=sent)


def run_segment(step, state, plan_t: PlanTensors, a: int, b: int,
                cfg: HashConfig):
    """Ticks ``[a, b)`` of a ring step: ``(state, events, series)``.

    ``events`` is the segment's host form: the compacted planes (a
    CompactEvents of absolute ticks) in full event mode, the ``[b - a]``
    int32 totals (join, rm, sent, recv) in agg mode, stacked on the
    device and copied once.  ``series`` is the flight recorder's
    unpacked series of the segment under ``cfg.telemetry``, else None:
    each tick's packed record stays on the device until the segment
    ends.  Under ``RNG_MODE: hoisted`` the segment's RNG plans are drawn
    before its first tick, one pass per stream
    (:func:`ring_rng_plans`); under ``MEGA_TICKS`` the ticks run in
    T-tick blocks (ops/megakernel.py)."""
    joins, removes, sent, recv, totals, recs = [], [], [], [], [], []
    plans = None
    if cfg.rng_mode == "hoisted":
        if cfg.exchange != "ring":
            raise ValueError("RNG_MODE hoisted requires the ring exchange")
        plans = ring_rng_plans(cfg, [plan_t.tick_key(t)
                                     for t in range(a, b)],
                               state.view.device)

    def tick(state, t: int):
        kw = {} if plans is None else {"rng": plans[t - a]}
        state, out = step(state, t, plan_t.tick_key(t), plan_t, **kw)
        if cfg.telemetry:
            out, rec = out
            recs.append(rec)
        if cfg.collect_events:
            joins.append(compact_tick(t, out.join_ids))
            removes.append(compact_tick(t, out.rm_ids))
            sent.append(out.sent)
            recv.append(out.recv)
        else:
            totals.append(torch.stack(tuple(out)))
        return state

    state = mega_ticks(tick, state, a, b, cfg.mega_ticks, cfg.mega_pack)
    series = (unpack_series(torch.stack(recs).cpu().numpy(),
                            cfg.telemetry_hist) if recs else None)
    if not cfg.collect_events:
        cols = (torch.stack(totals).cpu().numpy().T if totals
                else np.zeros((4, 0), np.int32))
        return state, SparseTickEvents(*(np.ascontiguousarray(c)
                                         for c in cols)), series
    empty = np.zeros((0, 3), np.int64)
    zeros = np.zeros((0, cfg.n), np.int32)
    return state, CompactEvents(
        np.concatenate(joins) if joins else empty,
        np.concatenate(removes) if removes else empty,
        torch.stack(sent).cpu().numpy() if sent else zeros,
        torch.stack(recv).cpu().numpy() if recv else zeros,
        b - a), series


def run_ticks(step, state, plan_t: PlanTensors, total: int,
              cfg: HashConfig, telemetry=None):
    """The whole run as one segment (:func:`run_segment`): ``(final_state,
    events)``, with the series flushed to ``telemetry`` (a
    TimelineRecorder, or None to drop them) at ``t0 = 0``."""
    state, events, series = run_segment(step, state, plan_t, 0, total, cfg)
    if series is not None and telemetry is not None:
        telemetry.flush(series, 0)
    return state, events


@register("tpu_hash")
def run_tpu_hash(params: Params, log: Optional[EventLog] = None,
                 seed: Optional[int] = None, device="cuda") -> RunResult:
    t0 = _time.time()
    seed = params.SEED if seed is None else seed
    log = log if log is not None else EventLog()
    plan = resolve_plan(params, _pyrandom.Random(f"app:{seed}"))
    return finish_run(params, plan, log, run_scan, t0, seed, device)
