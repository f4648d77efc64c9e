"""`emul` backend: faithful queue-level host simulator (the JAX
package's ``backends/emul.py``, kept whole: numpy and Python ``random``,
the same seeds drawn in the same order).  It runs on the host whatever
``--device`` says, as the JAX package's ``emul`` runs off the TPU.

This is the executable specification the TPU backends are validated against.
It reproduces the reference's semantics message-for-message:

  * global bounded in-memory buffer with swap-remove receive scans
    (EmulNet.cpp:87-177) — here keyed by integer id (fixing defect D5, the
    strcmp aliasing on binary addresses at EmulNet.cpp:154);
  * the two-pass synchronous tick: all receives (ascending node order), then
    all protocol steps (descending), exactly as Application::mp1Run
    (Application.cpp:121-164) — giving a 1-tick minimum message latency;
  * the staggered join schedule, JOINREQ/JOINREP handshake through the
    introducer, full-member-list gossip to FANOUT random targets per tick,
    and the TFAIL/TREMOVE sweep (MP1Node.cpp:182-495).

Protocol-visible quirks of the reference are replicated deliberately
(SURVEY.md §7 "faithful quirks policy"):

  * the double heartbeat increment: +2 per tick, own list entry gets the
    odd intermediate value (MP1Node.cpp:412-414);
  * gossip skips entries whose timestamp is stale by >= TFAIL
    (MP1Node.cpp:376) — this is what prevents failed-node resurrection;
  * the fanout bound ``numpotential = len(list) - 1 - numfailed`` computed
    with the post-removal length but the pre-removal stale count
    (MP1Node.cpp:463);
  * new joiners (JOINREQs processed this tick) are guaranteed gossip targets
    (MP1Node.cpp:240-242,454).

Reference *defects* are fixed, not replicated: D3 (the ``&&`` in
updateMyPos' self-insert test, MP1Node.cpp:316) becomes a correct
"insert-if-absent"; D4 (per-message leak) and D1/D2 (log truncation /
shutdown UB) have no analog here.

Messages are Python tuples, never serialized: ('LIST', id, port, hb) etc.
Wire sizes (19 B per LIST/JOINREQ, 4 B JOINREP; MP1Node.cpp:143,364,247)
are retained only for the buffer/size checks and counters.
"""

from __future__ import annotations

import bisect
import random
import time as _time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from distributed_membership_tpu_torch.addressing import (
    INTRODUCER_ID, index_to_id)
from distributed_membership_tpu_torch.backends import RunResult, register
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.eventlog import EventLog
from distributed_membership_tpu_torch.runtime.failures import (
    FailurePlan, log_failures, resolve_plan)

# Wire sizes (bytes), for buffer accounting only.
LIST_MSG_SIZE = 19      # hdr 4 + addr 6 + pad 1 + heartbeat 8 (MP1Node.cpp:364)
JOINREQ_MSG_SIZE = 19   # same layout (MP1Node.cpp:143)
JOINREP_MSG_SIZE = 4    # bare header (MP1Node.cpp:246-250)
EN_MSG_HDR = 16         # sizeof(en_msg): int + 2 x 6-byte Address (EmulNet.h:23-30)


class EmulNetwork:
    """In-memory packet network (reference EmulNet, EmulNet.{h,cpp})."""

    def __init__(self, params: Params, rng: random.Random, total_time: int):
        self.params = params
        self.rng = rng
        # buffer of (src_id, dst_id, payload_tuple, size)
        self.buff: List[Tuple[int, int, tuple, int]] = []
        n = params.EN_GPSZ
        self.sent = np.zeros((n + 1, total_time), dtype=np.int64)
        self.recv = np.zeros((n + 1, total_time), dtype=np.int64)
        # General-path scenario (scenario/compile.ScenarioHost): owns
        # the drop windows, partitions, and link flakes when set; the
        # legacy dropmsg toggle never fires then (the plan carries no
        # drop window).
        self.scenario = None

    def send(self, src_id: int, dst_id: int, payload: tuple, size: int, t: int) -> int:
        """ENsend (EmulNet.cpp:87-118): drop on full buffer, oversize, or
        Bernoulli when the drop window is open; count only accepted sends.
        With a general scenario attached, partition cuts drop the message
        deterministically and the Bernoulli threshold is the per-link
        effective percentage (windows + flakes)."""
        p = self.params
        if (len(self.buff) >= p.EN_BUFFSIZE
                or size + EN_MSG_HDR >= p.MAX_MSG_SIZE):
            return 0
        if self.scenario is not None:
            si, di = src_id - 1, dst_id - 1        # EmulNet ids are idx+1
            if self.scenario.blocked(t, si, di):
                return 0
            pct = self.scenario.drop_pct(t, si, di)
            if pct and self.rng.randrange(100) < pct:
                return 0
        elif p.dropmsg and self.rng.randrange(100) < int(p.MSG_DROP_PROB * 100):
            return 0
        self.buff.append((src_id, dst_id, payload, size))
        self.sent[src_id, t] += 1
        return size

    def recv_all(self, dst_id: int, t: int) -> List[tuple]:
        """ENrecv (EmulNet.cpp:144-177): scan the whole buffer top-down,
        swap-remove matches; delivery order is therefore newest-first."""
        out: List[tuple] = []
        buff = self.buff
        i = len(buff) - 1
        while i >= 0:
            if buff[i][1] == dst_id:
                out.append(buff[i][2])
                last = buff.pop()
                if i < len(buff):
                    buff[i] = last
                self.recv[dst_id, t] += 1
            i -= 1
        return out


def _entry_key(e: List[int]) -> Tuple[int, int]:
    # Reference ordering: by (id, port) (MemberCompareLessThan, MP1Node.cpp:13-18).
    return (e[0], e[1])


class EmulNode:
    """One protocol participant (reference MP1Node + Member state)."""

    __slots__ = ("idx", "id", "port", "params", "net", "log", "rng",
                 "failed", "inited", "in_group", "hb", "members", "queue")

    def __init__(self, idx: int, params: Params, net: EmulNetwork,
                 log: EventLog, rng: random.Random):
        self.idx = idx
        self.id = index_to_id(idx)
        self.port = 0  # ENinit forces port 0 (EmulNet.cpp:75)
        self.params = params
        self.net = net
        self.log = log
        self.rng = rng
        self.failed = False
        self.inited = False
        self.in_group = False
        self.hb = 0
        # member list entries [id, port, heartbeat, timestamp], sorted by (id, port)
        self.members: List[List[int]] = []
        self.queue: deque = deque()

    # -- lifecycle (MP1Node::nodeStart, MP1Node.cpp:73-119) ---------------
    def node_start(self, t: int) -> None:
        self.failed = False
        self.inited = True
        self.in_group = False
        self.hb = 0
        self.members = []
        if self.id == INTRODUCER_ID:
            self.log.log(self.id, t, "Starting up group...")
            self._update_my_pos(t)
            self.in_group = True
        else:
            self.log.log(self.id, t, "Trying to join...")
            self.net.send(self.id, INTRODUCER_ID,
                          ("JOINREQ", self.id, self.port, self.hb),
                          JOINREQ_MSG_SIZE, t)

    # -- pass 1 (MP1Node::recvLoop, MP1Node.cpp:47-54) --------------------
    def recv_loop(self, t: int) -> None:
        if self.failed:
            return
        for payload in self.net.recv_all(self.id, t):
            self.queue.append(payload)

    # -- pass 2 (MP1Node::nodeLoop, MP1Node.cpp:182-201) ------------------
    def node_loop(self, t: int) -> None:
        if self.failed:
            return
        new_nodes: List[List[int]] = []
        while self.queue:
            self._dispatch(self.queue.popleft(), new_nodes, t)
        if not self.in_group:
            return
        self._node_loop_ops(new_nodes, t)

    # -- message handlers (MP1Node::recvCallBack, MP1Node.cpp:329-353) ----
    def _dispatch(self, payload: tuple, new_nodes: List[List[int]], t: int) -> None:
        kind = payload[0]
        if kind == "JOINREQ":
            _, src_id, src_port, src_hb = payload
            if self._update_list(src_id, src_port, src_hb, t):
                new_nodes.append([src_id, src_port, src_hb, t])
            self.net.send(self.id, src_id, ("JOINREP",), JOINREP_MSG_SIZE, t)
        elif kind == "JOINREP":
            self.in_group = True
        elif kind == "LIST":
            _, src_id, src_port, src_hb = payload
            self._update_list(src_id, src_port, src_hb, t)

    def _update_list(self, eid: int, eport: int, ehb: int, t: int) -> bool:
        """Merge one (id, heartbeat) into the member list
        (MP1Node::updatelistCallBack, MP1Node.cpp:259-301).

        Existing entry: update heartbeat *and* timestamp only if the incoming
        heartbeat is strictly greater.  New entry: insert sorted + log the
        join.  This merge is commutative in the incoming set — the fact the
        whole TPU design rests on.
        """
        members = self.members
        pos = bisect.bisect_left(members, (eid, eport), key=_entry_key)
        if pos < len(members) and members[pos][0] == eid and members[pos][1] == eport:
            if members[pos][2] < ehb:
                members[pos][2] = ehb
                members[pos][3] = t
            return False
        members.insert(pos, [eid, eport, ehb, t])
        self.log.node_add(self.id, eid, t)
        return True

    def _update_my_pos(self, t: int) -> int:
        """Locate (insert if absent) this node's own entry
        (MP1Node::updateMyPos, MP1Node.cpp:308-322, with defect D3 — the
        ``&&`` self-insert condition — fixed to a plain membership test)."""
        members = self.members
        pos = bisect.bisect_left(members, (self.id, self.port), key=_entry_key)
        if pos == len(members) or members[pos][0] != self.id or members[pos][1] != self.port:
            members.insert(pos, [self.id, self.port, self.hb, t])
        return pos

    # -- the per-tick protocol kernel (MP1Node::nodeLoopOps, MP1Node.cpp:404-495)
    def _node_loop_ops(self, new_nodes: List[List[int]], t: int) -> None:
        p = self.params
        members = self.members

        mypos = self._update_my_pos(t)
        # Double heartbeat increment: own entry receives the odd intermediate
        # value (MP1Node.cpp:412-414) — protocol-visible, replicated.
        self.hb += 1
        members[mypos][2] = self.hb
        self.hb += 1
        members[mypos][3] = t

        # TFAIL / TREMOVE sweep (MP1Node.cpp:429-444).  The reference walks
        # indices downward with swap-remove; every pre-sweep entry is
        # examined exactly once, so a single filtering pass is equivalent.
        numfailed = 0
        kept: List[List[int]] = []
        for e in members:
            difft = t - e[3]
            if difft >= p.TFAIL:
                numfailed += 1
                if difft >= p.TREMOVE:
                    self.log.node_remove(self.id, e[0], t)
                    continue
            kept.append(e)
        # (filtering a sorted list preserves order — no re-sort needed, unlike
        # the reference whose swap-remove shuffles and re-sorts at :446)
        self.members = members = kept

        # Gossip target selection (MP1Node.cpp:449-489): start from this
        # tick's new joiners, then rejection-sample distinct live non-self
        # entries until FANOUT targets or the (quirky) potential bound.
        gossip: List[List[int]] = list(new_nodes)
        n = len(gossip)
        numpotential = len(members) - 1 - numfailed
        while n < p.FANOUT and n < numpotential:
            e = members[self.rng.randrange(len(members))]
            if e[0] == self.id and e[1] == self.port:
                continue
            if t - e[3] >= p.TFAIL:
                continue  # never gossip *to* a suspected-failed node
            if any(g[0] == e[0] and g[1] == e[1] for g in gossip):
                continue
            gossip.append(e)
            n += 1

        for target in gossip:
            self._send_member_list(target[0], t)

    def _send_member_list(self, to_id: int, t: int) -> None:
        """One LIST message per live entry (MP1Node::sendMemberList,
        MP1Node.cpp:360-395); entries stale by >= TFAIL are withheld
        (MP1Node.cpp:376)."""
        for e in self.members:
            if t - e[3] >= self.params.TFAIL:
                continue
            self.net.send(self.id, to_id, ("LIST", e[0], e[1], e[2]),
                          LIST_MSG_SIZE, t)


@register("emul")
def run_emul(params: Params, log: Optional[EventLog] = None,
             seed: Optional[int] = None, device=None) -> RunResult:
    """Full simulation with the faithful host backend.

    Replicates Application::run / mp1Run (Application.cpp:90-164): for each of
    TOTAL_TIME ticks, pass 1 receives for every eligible node in ascending
    order, pass 2 starts/steps nodes in descending order, then failures are
    injected.  Node i becomes eligible after its staggered start tick
    (``t > int(STEP_RATE*i)``, Application.cpp:130,143,153).
    ``device`` is accepted and ignored: the run is host code.
    """
    t0 = _time.time()
    seed = params.SEED if seed is None else seed
    log = log if log is not None else EventLog()

    # Deterministic per-purpose streams (random.Random(str) hashes the string
    # with a stable algorithm, unlike Python's per-process salted str hash).
    rng_app = random.Random(f"app:{seed}")
    rng_net = random.Random(f"net:{seed}")
    rng_gossip = random.Random(f"gossip:{seed}")

    n = params.EN_GPSZ
    total = params.TOTAL_TIME
    net = EmulNetwork(params, rng_net, total)
    nodes = [EmulNode(i, params, net, log, rng_gossip) for i in range(n)]
    for node in nodes:
        log.log(node.id, 0, "APP")  # constructor APP lines (Application.cpp:67)

    plan = resolve_plan(params, rng_app)
    scn_prog = getattr(plan, "scenario", None)
    host = None
    if scn_prog is not None:
        host = scn_prog.host()
        net.scenario = host
    starts = [params.start_tick(i) for i in range(n)]

    for t in range(total):
        params.globaltime = t
        for i in range(n):                      # pass 1: receive
            # delay_window: a covered node skips its receive pass — its
            # messages stay queued in net.buff and drain the first tick
            # after the window (EN_BUFFSIZE overflow during the hold is
            # honest bounded-queue behavior).  The node still acts in
            # pass 2: asymmetric gray failure, not isolation.
            if (t > starts[i] and not nodes[i].failed
                    and (host is None or not host.delayed(t, i))):
                nodes[i].recv_loop(t)
        for i in range(n - 1, -1, -1):          # pass 2: start / act
            if t == starts[i]:
                nodes[i].node_start(t)
            elif t > starts[i] and not nodes[i].failed:
                nodes[i].node_loop(t)
                if i == 0 and t % 500 == 0:
                    log.log(nodes[i].id, t, f"@@time={t}")  # Application.cpp:156-160
        if host is not None:
            _inject_scenario(host, nodes, log, t)
        else:
            _inject(plan, nodes, params, log, t)

    extra = {"final_lists": {node.id: [list(e) for e in node.members]
                             for node in nodes}}
    if scn_prog is not None:
        from distributed_membership_tpu_torch.scenario.oracle import (
            scenario_report)
        extra["scenario_report"] = scenario_report(
            scn_prog, params, dbg_text=log.dbg_text(),
            final_live=sum(1 for nd in nodes
                           if nd.inited and nd.in_group and not nd.failed),
            final_failed=sum(1 for nd in nodes if nd.failed),
            final_failed_indices=[nd.idx for nd in nodes if nd.failed])
    return RunResult(
        params=params, log=log,
        sent=net.sent[1:, :], recv=net.recv[1:, :],
        failed_indices=plan.failed_indices if plan.fail_time is not None else [],
        fail_time=plan.fail_time,
        wall_seconds=_time.time() - t0,
        extra=extra,
    )


def _inject(plan: FailurePlan, nodes, params: Params, log: EventLog, t: int) -> None:
    """Application::fail (Application.cpp:173-202)."""
    if plan.drop_start is not None and t == plan.drop_start:
        params.dropmsg = 1
    if plan.fail_time == t:
        log_failures(plan, log, t)
        for i in plan.failed_indices:
            nodes[i].failed = True
    if plan.drop_stop is not None and t == plan.drop_stop:
        params.dropmsg = 0


def _inject_scenario(host, nodes, log: EventLog, t: int) -> None:
    """End-of-tick scenario transitions (scenario/compile.ScenarioHost)
    — the host twin of the jitted steps' up/down block.  Crash/leave
    nodes go dark (reference-faithfully: the queue strands); restarted
    nodes come back as a fresh incarnation: empty member list with only
    their own entry, heartbeat bumped past anything the old incarnation
    gossiped, warm rejoin (in-group, no introducer round trip)."""
    for i in host.down_at(t):
        if not nodes[i].failed:
            log.node_failed_multi(index_to_id(i), t)
        nodes[i].failed = True
    for i in host.up_at(t):
        node = nodes[i]
        node.failed = False
        node.inited = True
        node.in_group = True
        node.hb = max(node.hb, 2 * (t + 1))
        node.members = []
        node.queue.clear()
        node._update_my_pos(t)
