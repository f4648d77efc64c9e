"""The multi-process runtime: one sharded run whose shards span K
processes (counterpart of the JAX package's ``runtime/distributed.py``).

The JAX package joins ``jax.distributed`` and lets XLA carry the
cross-process legs of its ``shard_map`` collectives.  The port's sharded
steps run on a mesh of shards (parallel/mesh.py): one process holds all
``D`` shards in a :class:`~distributed_membership_tpu_torch.parallel.mesh.
LocalMesh`, and under ``DM_DIST_PROCS = K > 1`` process ``p`` holds shards
``[p*D/K, (p+1)*D/K)`` in a :class:`~distributed_membership_tpu_torch.
parallel.mesh.ProcessMesh`, whose collectives are ``torch.distributed``
calls on the process group this module opens.

* :func:`maybe_initialize` -- ``init_process_group`` over
  ``tcp://$DM_DIST_COORD`` with the rank and size of the environment; a
  no-op when ``DM_DIST_PROCS`` is unset or 1.  Call it before the first
  CUDA call of the process: on the card it also selects the process's
  device, ``cuda:{local_rank % torch.cuda.device_count()}``, where the
  local rank counts the ranks before it on its host.
* :func:`to_host` -- a carry's process-sharded leaves gathered to their
  global values and copied to the host, so every process holds (and
  writes) the same complete artifacts.
* :func:`device_put_global` -- the reverse: a global carry cut back to
  this process's rows on its device.

Environment contract (all unset = one process, no-op), the JAX
package's word for word:

* ``DM_DIST_PROCS``     -- total process count K (> 1 arms the init)
* ``DM_DIST_PROC_ID``   -- this process's rank in [0, K)
* ``DM_DIST_COORD``     -- coordinator address, e.g. ``localhost:9911``
* ``DM_DIST_CPU_COLL``  -- the collectives of a CPU run (default
  ``gloo``)

The transport, resolved by rule and printed once to stderr
(:func:`resolve_transport`): ``DM_DIST_CPU_COLL`` (gloo) on the CPU;
``nccl`` on CUDA where every host has a card for each of its
processes; ``gloo`` over CUDA tensors where processes share a card
(NCCL refuses two ranks on one device).  Every rank reads the hosts and
cards of every rank through the gloo group the run always opens first
and applies the rule to that one list, so all ranks choose alike.  An
nccl group that fails to come up raises, and never gives way to gloo.
"""

from __future__ import annotations

import datetime
import os
import socket
import sys
from typing import Optional

import torch

PROCS_ENV = "DM_DIST_PROCS"
PROC_ID_ENV = "DM_DIST_PROC_ID"
COORD_ENV = "DM_DIST_COORD"
CPU_COLL_ENV = "DM_DIST_CPU_COLL"

# A collective that waits longer than this fails the run (a process that
# died or took another branch), rather than hanging it.
TIMEOUT_S = 300

_STATE: dict = {}
# What this process's collectives (ProcessMesh) moved and took: bytes
# in all and inside the tick loop (the boundaries' gathers excluded),
# seconds in the transport, and the tick loop's seconds and ticks, for
# the multi-process run's bytes and ms per tick; and the last transport.
_STATS = {"bytes": 0, "tick_bytes": 0, "comm_s": 0.0, "tick_comm_s": 0.0,
          "tick_s": 0.0, "ticks": 0, "transport": None}


def env_procs() -> int:
    """``DM_DIST_PROCS`` (1 when unset)."""
    return int(os.environ.get(PROCS_ENV, "1") or 1)


def resolve_transport(device_type: str, hosts) -> str:
    """The transport of a run on ``device_type``, where ``hosts`` holds
    every rank's ``(host name, cards on that host)``: the CPU collectives
    on the CPU; nccl where every host has at least as many cards as it
    has processes; gloo over CUDA tensors where any host's processes
    share a card.  Every rank gets the same answer from the same list."""
    if device_type != "cuda":
        return os.environ.get(CPU_COLL_ENV, "gloo") or "gloo"
    procs, cards = {}, {}
    for name, n in hosts:
        procs[name] = procs.get(name, 0) + 1
        cards[name] = n
    return "nccl" if all(cards[h] >= procs[h] for h in procs) else "gloo"


def local_rank(hosts, rank: int) -> int:
    """The ranks before ``rank`` on its host (``hosts`` as in
    :func:`resolve_transport`): its card is this modulo the host's
    cards."""
    return sum(1 for name, _ in hosts[:rank] if name == hosts[rank][0])


def _nccl_group(rank: int, procs: int, device):
    """The nccl group beside the gloo one, brought up with one
    all_reduce so that a failure raises here."""
    import torch.distributed as dist
    if not dist.is_nccl_available():
        raise RuntimeError(
            "transport nccl: this torch build has no NCCL; the run does "
            "not fall back to gloo")
    group = dist.new_group(backend="nccl",
                           timeout=datetime.timedelta(seconds=TIMEOUT_S))
    probe = torch.ones((1,), device=device)
    dist.all_reduce(probe, group=group)
    torch.cuda.synchronize(device)
    if int(probe.item()) != procs:
        raise RuntimeError(f"transport nccl: probe all_reduce gave "
                           f"{probe.item()} on rank {rank}, want {procs}")
    return group


def maybe_initialize(device="cpu", transport: Optional[str] = None) -> tuple:
    """Join the run's process group from ``DM_DIST_*`` when requested.

    Returns ``(process_index, process_count)``; idempotent; ``(0, 1)``
    without touching ``torch.distributed`` when ``DM_DIST_PROCS`` is
    unset or <= 1.  ``device`` is the run's device type (``cuda`` or
    ``cpu``); ``transport`` pins one instead of the rule (a probe)."""
    procs = env_procs()
    if procs <= 1:
        return 0, 1
    if _STATE:
        return _STATE["rank"], _STATE["procs"]
    if PROC_ID_ENV not in os.environ:
        raise ValueError(f"{PROCS_ENV}={procs} requires {PROC_ID_ENV} "
                         "(this process's rank in [0, K))")
    rank = int(os.environ[PROC_ID_ENV])
    if not 0 <= rank < procs:
        raise ValueError(f"{PROC_ID_ENV}={rank} is outside [0, {procs})")
    coord = os.environ.get(COORD_ENV)
    if not coord:
        raise ValueError(
            f"{PROCS_ENV}={procs} requires {COORD_ENV} "
            "(coordinator host:port shared by every process)")
    import torch.distributed as dist
    dev_type = torch.device(device).type
    dev = torch.device("cpu")
    cards = 0
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "false; pass --device cpu to run on the CPU")
        cards = torch.cuda.device_count()
    cpu_coll = os.environ.get(CPU_COLL_ENV, "gloo") or "gloo"
    dist.init_process_group(
        backend=cpu_coll, init_method=f"tcp://{coord}", rank=rank,
        world_size=procs, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        hosts = [None] * procs
        dist.all_gather_object(hosts, (socket.gethostname(), cards))
        here = sum(1 for h in hosts if h[0] == hosts[rank][0])
        if dev_type == "cuda":
            dev = torch.device("cuda", local_rank(hosts, rank) % cards)
            torch.cuda.set_device(dev)
        chosen = transport or resolve_transport(dev_type, hosts)
        group = None
        if chosen == "nccl":
            if dev_type != "cuda":
                raise ValueError("transport nccl moves CUDA tensors only; "
                                 "a CPU run takes " + repr(cpu_coll))
            group = _nccl_group(rank, procs, dev)
        elif chosen != cpu_coll:
            raise ValueError(f"transport {chosen!r}: a {dev_type} run "
                             f"takes nccl or {cpu_coll!r}")
    except BaseException:
        dist.destroy_process_group()
        raise
    _STATE.update(rank=rank, procs=procs, transport=chosen, group=group,
                  device=dev)
    _STATS["transport"] = chosen
    if rank == 0:
        print(f"[distributed] {procs} processes, transport {chosen} "
              f"({dev_type}; {here} processes and {cards} cards on "
              f"this host)", file=sys.stderr, flush=True)
    return rank, procs


def process_count() -> int:
    """Global process count (1 before or without the init)."""
    return _STATE.get("procs", 1)


def process_index() -> int:
    return _STATE.get("rank", 0)


def count_sent(nbytes: int) -> None:
    _STATS["bytes"] += int(nbytes)


def count_seconds(seconds: float) -> None:
    _STATS["comm_s"] += seconds


def count_ticks(ticks: int, seconds: float, nbytes: int,
                comm_s: float) -> None:
    """A segment's ticks: their wall seconds, and the bytes and
    transport seconds of ``count_sent``/``count_seconds`` inside them."""
    _STATS["ticks"] += int(ticks)
    _STATS["tick_s"] += seconds
    _STATS["tick_bytes"] += int(nbytes)
    _STATS["tick_comm_s"] += comm_s


def transport_stats() -> dict:
    """This process's transport counters (they survive :func:`shutdown`):
    ``bytes``/``comm_s`` in all, ``tick_bytes``/``tick_comm_s`` inside
    the ``ticks`` of the tick loop, which took ``tick_s``."""
    return dict(_STATS)


def transport() -> Optional[str]:
    """The resolved transport of this process's run (kept after
    :func:`shutdown`), None in a one-process run."""
    return _STATS["transport"]


def group_for(x: torch.Tensor):
    """``(group, stage)`` for a collective on ``x``: the nccl group for
    CUDA tensors under nccl, else the default gloo group, staging a CUDA
    tensor through the host (``stage`` true)."""
    if x.is_cuda and _STATE.get("group") is not None:
        return _STATE["group"], False
    return None, x.is_cuda


def shutdown(barrier: bool = True) -> None:
    """Leave the process group (the end of a CLI run), after a barrier
    unless the run failed."""
    if not _STATE:
        return
    import torch.distributed as dist
    if dist.is_initialized():
        if barrier:
            dist.barrier()
        dist.destroy_process_group()
    _STATE.clear()


def to_host(tree, mesh, collect_events: bool = False):
    """The carry ``tree`` with its process-sharded leaves gathered to
    their global values (``mesh.all_gather``), copied to the host.  A
    one-process mesh only copies."""
    from distributed_membership_tpu_torch.parallel.mesh import gather_carry
    return _map(gather_carry(tree, mesh, collect_events), lambda x: x.cpu())


def device_put_global(tree, mesh, collect_events: bool = False):
    """A global carry (host or device) cut to this process's rows on the
    mesh's device; a one-process mesh only moves it."""
    from distributed_membership_tpu_torch.parallel.mesh import local_carry
    return local_carry(_map(tree, lambda x: x.to(mesh.device)), mesh,
                       collect_events)


def _map(tree, fn):
    from distributed_membership_tpu_torch.ops.megakernel import (
        named_leaves, rebuild_carry)
    return rebuild_carry(tree, [fn(x) for _, x in named_leaves(tree)])
