"""A mesh of node shards, held on one device or spread over processes
(counterpart of the JAX package's ``parallel/mesh.py`` and
``tpu_hash_sharded.resolve_mesh``).

The JAX sharded backend splits the node axis over a ``jax.sharding.Mesh``:
shard ``d`` owns rows ``[d*L, (d+1)*L)`` of the ``[N, ...]`` state and the
step runs per shard inside ``shard_map``, talking to the other shards
through collectives.  :class:`LocalMesh` keeps that decomposition but
holds all ``D`` shards on one device, in the ordinary flat ``[N, ...]``
layout: shard ``d``'s rows are rows ``[d*L, (d+1)*L)`` of the flat
tensor.  Each collective of the step becomes a tensor operation on that
layout, and a per-shard computation becomes one computation over all rows
(the kernels are row-local and take global row ids).

An N-D torus shape (``MESH_SHAPE: 2x4``) flattens outer-major, exactly as
the JAX mesh's axis tuple does; the JAX ``make_block_send`` decomposes a
flat block shift into per-axis ring rotations whose composition is the
flat rotation, so on one device every shape with the same ``D`` runs the
same program and gives the same trajectory.

Collectives, on flat tensors whose leading axis is the node axis:

* :meth:`block_send` -- shard ``d`` receives what shard ``(d - b) mod D``
  sent (a roll of the rows by ``b * L``);
* :meth:`all_gather` -- the identity (the flat tensor is the gathered one);
* :meth:`all_to_all` -- shard ``d``'s bucket ``k`` becomes shard ``k``'s
  slice ``d`` (a transpose of the source and destination block axes);
* :meth:`psum` / :meth:`psum_scatter` -- the sum of per-shard partials
  ``[D, ...]``; for ``psum_scatter`` over the global ``[N]`` index space,
  the flat result's rows ``[d*L, (d+1)*L)`` are shard ``d``'s slice.

:class:`ProcessMesh` is the same mesh spread over K processes
(runtime/distributed.py): process ``p`` holds the ``D/K`` consecutive
shards from ``p*D/K`` (an N-D shape flattens outer-major, so they are
consecutive flat shards), which are rows ``[p*N/K, (p+1)*N/K)`` in the
same flat layout, and its collectives are ``torch.distributed`` calls
over the process's rows.  Every mesh offers the process's view through
``local_size``, ``shard_lo``, :attr:`shards`, :meth:`local_rows` and
:meth:`row_lo` (the whole mesh on a LocalMesh), and the carry's
process-sharded leaves through :func:`gather_carry` and
:func:`local_carry` (the identity on a LocalMesh).
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch


def mesh_shape(params) -> tuple:
    """``MESH_SHAPE`` as a tuple of axis sizes (major first), else one
    shard: one card and one CPU each hold one device."""
    if params.MESH_SHAPE:
        return tuple(int(x) for x in params.MESH_SHAPE.lower().split("x"))
    return (1,)


class LocalMesh:
    """``D = prod(shape)`` node shards held on one device."""

    def __init__(self, shape, device):
        self.shape = tuple(int(x) for x in shape)
        if not self.shape or min(self.shape) < 1:
            raise ValueError(f"mesh shape must be positive ints, got {shape}")
        self.size = math.prod(self.shape)
        self.device = torch.device(device)
        self.procs, self.rank = 1, 0
        self.local_size, self.shard_lo = self.size, 0

    def __repr__(self) -> str:
        return f"LocalMesh({'x'.join(map(str, self.shape))}, {self.device})"

    def rows_per_shard(self, n: int) -> int:
        if n % self.size != 0:
            raise ValueError(f"EN_GPSZ={n} not divisible by mesh size "
                             f"{self.size}")
        return n // self.size

    @property
    def shards(self) -> range:
        """The global ids of this process's shards."""
        return range(self.shard_lo, self.shard_lo + self.local_size)

    def local_rows(self, n: int) -> int:
        """The rows of ``n`` this process holds."""
        return self.rows_per_shard(n) * self.local_size

    def row_lo(self, n: int) -> int:
        """The global id of this process's first row."""
        return self.rows_per_shard(n) * self.shard_lo

    def shard_of_rows(self, n: int) -> torch.Tensor:
        """``[rows]`` int64: the global shard that owns each of this
        process's rows."""
        rows = torch.arange(self.local_rows(n), dtype=torch.int64,
                            device=self.device) + self.row_lo(n)
        return rows // self.rows_per_shard(n)

    def hop_shifts(self, b: torch.Tensor):
        """The block shifts ``b`` as :meth:`block_send` takes them: device
        scalars here (no host sync)."""
        return b

    def block_send(self, x: torch.Tensor, b) -> torch.Tensor:
        """Shard ``d`` receives shard ``(d - b) mod D``'s rows of ``x``.
        ``b`` is an int or a device scalar (no host sync)."""
        if self.size == 1:
            return x
        n = x.shape[0]
        rows = torch.arange(n, dtype=torch.int64, device=x.device)
        shift = (b.to(torch.int64) if torch.is_tensor(b) else b) \
            * self.rows_per_shard(n)
        return x.index_select(0, (rows - shift) % n)

    def local_roll(self, x: torch.Tensor, c) -> torch.Tensor:
        """``jnp.roll(x, c, axis=0)`` on every shard's own rows: row ``l``
        of shard ``d`` takes row ``(l - c) mod L`` of the same shard."""
        n = x.shape[0]
        n_local = n // self.local_size
        rows = torch.arange(n, dtype=torch.int64, device=x.device)
        local = rows % n_local
        c = c.to(torch.int64) if torch.is_tensor(c) else c
        return x.index_select(0, rows - local + (local - c) % n_local)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """A process-sharded tensor's global value (the leading axis holds
        each process's equal block in process order): the flat tensor
        itself on one process."""
        return x

    def local_part(self, x: torch.Tensor) -> torch.Tensor:
        """This process's block of a global tensor's leading axis."""
        return x

    def scatter_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A global ``[N]`` vector of per-process partials, summed over
        the processes, cut to this process's rows."""
        return x

    def allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced elementwise over the processes (sum, min, max)."""
        return x

    def row_value(self, x: torch.Tensor, r: int) -> torch.Tensor:
        """Row ``r`` (a global id) of the per-row tensor ``x``, on every
        process."""
        return x[r]

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_to_all(x, AX, 0, 0, tiled=True)`` on the flat layout:
        the leading axis holds each shard's ``D`` equal buckets in shard
        order (``[D_src * D_dst * m, ...]``), and shard ``d``'s bucket
        ``k`` becomes shard ``k``'s slice ``d``.  The identity at D = 1."""
        d = self.size
        if d == 1:
            return x
        return x.reshape((d, d, -1) + tuple(x.shape[1:])).transpose(
            0, 1).reshape(x.shape)

    def psum(self, parts: torch.Tensor) -> torch.Tensor:
        """Sum of this process's per-shard partials ``[D_local, ...]``
        over every shard (integers stay int32)."""
        return self.allreduce(parts.sum(0, dtype=parts.dtype))

    def psum_scatter(self, parts: torch.Tensor) -> torch.Tensor:
        """Per-shard partials ``[D_local, N]`` over the global index space,
        summed; each shard's slice of the sum lies at its own rows."""
        return self.scatter_sum(parts.sum(0, dtype=parts.dtype))

    def shard_sums(self, x: torch.Tensor) -> torch.Tensor:
        """``[D_local]`` int32: each of this process's shards' sum of a
        flat ``[rows, ...]`` tensor."""
        return x.reshape(self.local_size, -1).sum(1, dtype=torch.int32)


class ProcessMesh(LocalMesh):
    """``D = prod(shape)`` node shards over the ``procs`` processes of the
    run's process group (runtime/distributed.py), ``D / procs`` of them
    on this process's ``device``.  Tensors hold this process's rows in
    the flat layout; each collective is one ``torch.distributed`` call on
    them (a CUDA tensor under gloo is staged through the host), and every
    process calls the same collectives in the same order.  The bytes this
    process puts on the transport and the seconds it spends there are
    counted (runtime/distributed.py ``transport_stats``)."""

    def __init__(self, shape, device, rank: int, procs: int):
        super().__init__(shape, device)
        if procs < 1 or self.size % procs != 0:
            raise ValueError(
                f"mesh of {self.size} shards cannot be split over {procs} "
                "processes (MESH_SHAPE's shard count must be a multiple of "
                "DM_DIST_PROCS)")
        self.procs, self.rank = int(procs), int(rank)
        self.local_size = self.size // self.procs
        self.shard_lo = self.rank * self.local_size
        self._pins = {}

    def __repr__(self) -> str:
        return (f"ProcessMesh({'x'.join(map(str, self.shape))}, "
                f"{self.device}, rank {self.rank}/{self.procs})")

    # ---- the transport ----------------------------------------------
    def _pinned(self, kind: str, shape, dtype) -> torch.Tensor:
        """A ``shape`` view of this mesh's pinned host buffer ``kind``
        (grown as needed, reused across calls)."""
        nbytes = math.prod(shape) * dtype.itemsize
        buf = self._pins.get(kind)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty((max(nbytes, 1),), dtype=torch.uint8,
                              pin_memory=True)
            self._pins[kind] = buf
        return buf[:nbytes].view(dtype).view(shape)

    def _run(self, fn, x: torch.Tensor):
        """``fn(tensor, group, alloc)`` on ``x``, where ``alloc(shape,
        dtype)`` gives the output's memory; staged through pinned host
        buffers where the transport cannot take a CUDA tensor (gloo).
        The seconds it takes, waits for the other processes included,
        are counted (runtime/distributed.py ``transport_stats``).  A
        staged tensor's copy to the host would first wait for this
        process's queued kernels, so that wait is taken before the clock
        starts: the count holds the copies and the transport alone.  An
        nccl call counts the time to enqueue it."""
        from distributed_membership_tpu_torch.runtime.distributed import (
            count_seconds, group_for)
        group, stage = group_for(x)
        if stage:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        if not stage:
            out = fn(x, group, lambda shape, dtype: torch.empty(
                shape, dtype=dtype, device=x.device))
        else:
            host = self._pinned("in", tuple(x.shape), x.dtype)
            host.copy_(x)
            out = fn(host, group, lambda shape, dtype: self._pinned(
                "out", tuple(shape), dtype)).to(x.device)
        count_seconds(time.perf_counter() - t0)
        return out

    def _all_to_all(self, send: torch.Tensor, in_splits: list,
                    out_splits: list) -> torch.Tensor:
        """``all_to_all_single`` of ``send``'s leading axis."""
        import torch.distributed as dist
        _sent((sum(in_splits) - in_splits[self.rank])
              * math.prod(send.shape[1:]) * send.element_size())

        def go(x, group, alloc):
            out = alloc((sum(out_splits),) + tuple(x.shape[1:]), x.dtype)
            dist.all_to_all_single(out, x.contiguous(), out_splits,
                                   in_splits, group=group)
            return out
        return self._run(go, send)

    def allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        import torch.distributed as dist
        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        _sent(x.numel() * x.element_size())

        def go(y, group, alloc):
            out = alloc(tuple(y.shape), y.dtype)
            out.copy_(y)
            dist.all_reduce(out, op=red, group=group)
            return out
        return self._run(go, x.contiguous())

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        _sent(x.numel() * x.element_size())

        def go(y, group, alloc):
            out = alloc((self.procs * y.shape[0],) + tuple(y.shape[1:]),
                        y.dtype)
            dist.all_gather(list(out.chunk(self.procs)), y, group=group)
            return out
        return self._run(go, x.contiguous())

    def local_part(self, x: torch.Tensor) -> torch.Tensor:
        return x.chunk(self.procs)[self.rank]

    def row_value(self, x: torch.Tensor, r: int) -> torch.Tensor:
        """Row ``r`` of the per-row tensor ``x`` (this process's rows), from
        the process that holds it: the others add zeros."""
        row0 = self.rank * x.shape[0]
        here = row0 <= r < row0 + x.shape[0]
        v = (x[r - row0] if here else torch.zeros_like(x[0])).to(
            torch.int32 if x.dtype == torch.bool else x.dtype)
        out = self.allreduce(v.reshape(-1)).reshape(v.shape)
        return out.to(torch.bool) if x.dtype == torch.bool else out

    def scatter_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.local_part(self.allreduce(x))

    # ---- the step's collectives ---------------------------------------
    def hop_shifts(self, b: torch.Tensor) -> list:
        """The tick's block shifts as host ints, read in one sync."""
        return b.tolist()

    def block_send(self, x: torch.Tensor, b) -> torch.Tensor:
        """Shard ``d`` receives shard ``(d - b) mod D``'s rows; ``b`` a
        host int (:meth:`hop_shifts`), the same on every process.  Blocks
        that stay in the process move by ``index_select``; the others go
        through one ``all_to_all``, ordered by destination shard."""
        d, dl, lo = self.size, self.local_size, self.shard_lo
        b = int(b) % d
        if b == 0:
            return x
        blocks = x.reshape((dl, -1) + tuple(x.shape[1:]))
        # My source block i lands on shard lo+i+b; my block j comes from
        # shard lo+j-b.  Both lists in destination order.
        src_of = [(lo + j - b) % d for j in range(dl)]
        dst_of = [(lo + i + b) % d for i in range(dl)]
        out = torch.empty_like(blocks)
        stay = [j for j in range(dl) if src_of[j] // dl == self.rank]
        if stay:
            take = torch.tensor([src_of[j] - lo for j in stay],
                                dtype=torch.int64, device=x.device)
            out[torch.tensor(stay, dtype=torch.int64,
                             device=x.device)] = blocks.index_select(0, take)
        sends = sorted((i for i in range(dl)
                        if dst_of[i] // dl != self.rank),
                       key=lambda i: (dst_of[i] // dl, dst_of[i]))
        recvs = sorted((j for j in range(dl)
                        if src_of[j] // dl != self.rank),
                       key=lambda j: (src_of[j] // dl, j))
        in_splits = [sum(dst_of[i] // dl == q for i in sends)
                     for q in range(self.procs)]
        out_splits = [sum(src_of[j] // dl == q for j in recvs)
                      for q in range(self.procs)]
        send = blocks[torch.tensor(sends, dtype=torch.int64,
                                   device=x.device)]
        got = self._all_to_all(send, in_splits, out_splits)
        if recvs:
            out[torch.tensor(recvs, dtype=torch.int64,
                             device=x.device)] = got
        return out.reshape(x.shape)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """The leading axis holds each local shard's ``D`` equal buckets
        (``[D_local * D * m, ...]``); shard ``d``'s bucket ``k`` becomes
        shard ``k``'s slice ``d``: the result is ``[D_local, D, m, ...]``
        flat, every destination's slices in source-shard order."""
        d, dl, k = self.size, self.local_size, self.procs
        tail = tuple(x.shape[1:])
        b = x.reshape((dl, k, dl, -1) + tail)
        # To process q: [D_dst(q), D_src(me), m] blocks.
        send = b.transpose(0, 1).transpose(1, 2).reshape(
            (k * dl * dl, -1) + tail)
        got = self._all_to_all(send, [dl * dl] * k, [dl * dl] * k)
        # From process q: [D_dst(me), D_src(q), m] -> [D_dst, D_src, m].
        got = got.reshape((k, dl, dl, -1) + tail).transpose(0, 1)
        return got.reshape(x.shape)


def _sent(nbytes: int) -> None:
    from distributed_membership_tpu_torch.runtime.distributed import (
        count_sent)
    count_sent(nbytes)


def local_plan(plan, mesh: LocalMesh):
    """A run's PlanTensors with its per-row masks (start ticks, the fail
    mask) cut to this process's rows; the plan itself on a LocalMesh."""
    if mesh.procs == 1:
        return plan
    return dataclasses.replace(
        plan, start_ticks=mesh.local_part(plan.start_ticks),
        fail_mask=mesh.local_part(plan.fail_mask))


def _sharded_leaf(name: str, collect_events: bool) -> bool:
    """Is carry leaf ``name`` split over the processes along its leading
    axis?  Every state leaf (per-row planes and vectors, and the
    per-shard placeholders) is; of the aggregates, the per-observer-row
    fields of a run in agg mode (the id-indexed ones are reduced to the
    global value at every boundary, and full event mode carries one
    never-updated placeholder)."""
    if not name.startswith("agg."):
        return True
    return (not collect_events and name[4:] in (
        "tracker_obs", "det_obs", "sent_total", "recv_total"))


def gather_carry(carry, mesh: LocalMesh, collect_events: bool = False):
    """``carry`` with every process-sharded leaf gathered to its global
    value (one all_gather per leaf); the identity on a LocalMesh."""
    from distributed_membership_tpu_torch.ops.megakernel import (
        named_leaves, rebuild_carry)
    if mesh.procs == 1:
        return carry
    return rebuild_carry(carry, [
        mesh.all_gather(x) if _sharded_leaf(name, collect_events) else x
        for name, x in named_leaves(carry)])


def local_carry(carry, mesh: LocalMesh, collect_events: bool = False):
    """A global ``carry`` cut to this process's block of every
    process-sharded leaf; the identity on a LocalMesh."""
    from distributed_membership_tpu_torch.ops.megakernel import (
        named_leaves, rebuild_carry)
    if mesh.procs == 1:
        return carry
    return rebuild_carry(carry, [
        mesh.local_part(x).clone() if _sharded_leaf(name, collect_events)
        else x for name, x in named_leaves(carry)])
