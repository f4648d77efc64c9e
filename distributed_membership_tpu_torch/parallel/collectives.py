"""The dense sharded step's collectives (the JAX package's
``parallel/collectives.py``), on a :class:`~.mesh.LocalMesh`.

In the JAX package each shard of a ``shard_map`` holds its own partial
and the shards combine them over ICI: ``pmax``, a ``ppermute`` ring
reduce-scatter with ``max``, ``psum_scatter`` and ``all_gather``.  Here
the ``D`` shards live on one device, so a per-shard partial is one row of
a stacked ``[D, ...]`` tensor and each collective is a reduction over its
leading axis; the node axis of a per-shard result stays in the flat
``[N, ...]`` layout, shard ``d`` owning rows ``[d*B, (d+1)*B)``.  The
reductions are integer max and sum, so the combine order of the JAX
ring does not show in the bits.
"""

from __future__ import annotations

import torch


def allreduce_max(parts: torch.Tensor) -> torch.Tensor:
    """``lax.pmax``: every shard's ``[D, ...]`` partial replaced by the
    elementwise max over the shards."""
    return parts.amax(0, keepdim=True).expand(parts.shape)


def ring_reduce_scatter_max(parts: torch.Tensor) -> torch.Tensor:
    """The ring reduce-scatter with ``max``: per-shard partials ``[D,
    D*B, ...]`` over the whole node axis in, the flat ``[D*B, ...]``
    result out, shard ``d``'s rows being the max of every shard's rows
    ``[d*B, (d+1)*B)``."""
    return parts.amax(0)


def reduce_scatter_sum(parts: torch.Tensor) -> torch.Tensor:
    """``lax.psum_scatter(..., tiled=True)``: per-shard partials ``[D,
    D*B, ...]`` summed, in the flat layout (integers stay in their
    dtype)."""
    return parts.sum(0, dtype=parts.dtype)


def all_gather_vec(x: torch.Tensor) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)`` of the shards' ``[B, ...]``
    pieces: the flat ``[D*B, ...]`` tensor already is the gathered one."""
    return x
