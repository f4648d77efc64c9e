"""A mesh of node shards held on one device (counterpart of the JAX
package's ``parallel/mesh.py`` and ``tpu_hash_sharded.resolve_mesh``).

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
"""

from __future__ import annotations

import math

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

    def __repr__(self) -> str:
        return f"LocalMesh({'x'.join(map(str, self.shape))}, {self.device})"

    def rows_per_shard(self, n: int) -> int:
        if n % self.size != 0:
            raise ValueError(f"EN_GPSZ={n} not divisible by mesh size "
                             f"{self.size}")
        return n // self.size

    def shard_of_rows(self, n: int) -> torch.Tensor:
        """``[N]`` int64: the shard that owns each row."""
        rows = torch.arange(n, dtype=torch.int64, device=self.device)
        return rows // self.rows_per_shard(n)

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
        n_local = self.rows_per_shard(n)
        rows = torch.arange(n, dtype=torch.int64, device=x.device)
        local = rows % n_local
        c = c.to(torch.int64) if torch.is_tensor(c) else c
        return x.index_select(0, rows - local + (local - c) % n_local)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

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
        """Sum of per-shard partials ``[D, ...]`` (integers stay int32)."""
        return parts.sum(0, dtype=parts.dtype)

    def psum_scatter(self, parts: torch.Tensor) -> torch.Tensor:
        """Per-shard partials ``[D, N]`` over the global index space,
        summed; each shard's slice of the sum lies at its own rows."""
        return parts.sum(0, dtype=parts.dtype)

    def shard_sums(self, x: torch.Tensor) -> torch.Tensor:
        """``[D]`` int32: each shard's sum of a flat ``[N, ...]`` tensor."""
        return x.reshape(self.size, -1).sum(1, dtype=torch.int32)
