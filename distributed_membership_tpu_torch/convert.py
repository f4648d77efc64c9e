"""Carry a step's state across implementations.

``state_to_numpy`` flattens a port state (a ring step's ``HashState`` or
``ShardedHashState``, the dense step's ``State``, ``SparseState``)
into a dict of numpy arrays with the JAX leaf names (``agg.<field>`` for
the aggregate leaves) and the JAX dtypes (u32 planes as ``uint32``);
``state_from_numpy`` builds a ring step's state from such a dict, e.g. the
leaves of a JAX state (a ``ShardedHashState`` when the leaves have no
``wf_prev``, which only the single-chip state carries).  Both copy, so
neither side aliases the other.  A folded state, single-chip or sharded
(backends/tpu_hash_folded.py), has the same leaves with folded shapes;
both directions keep whatever shape a leaf has.

The carry of a checkpoint (runtime/checkpoint.py) is these leaves in the
JAX flatten order -- the state's fields in order, the aggregate's fields
inline -- as the npz members ``c0..cK``: :func:`carry_leaves` copies a
state to that list, :func:`carry_from_leaves` builds one of a template
state's types from it on a device, and :func:`leaf_specs` gives the names, shapes and dtypes a
resume checks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributed_membership_tpu_torch.backends.tpu_hash import HashState
from distributed_membership_tpu_torch.backends.tpu_hash_sharded import (
    ShardedHashState)
from distributed_membership_tpu_torch.observability.aggregates import (
    AggStats, FastAgg)
from distributed_membership_tpu_torch.ops.megakernel import (
    named_leaves, rebuild_carry)

U32_LEAVES = frozenset({"view", "mail", "amail", "pmail", "probe_ids1",
                        "probe_ids2"})


class LeafSpec(NamedTuple):
    name: str
    shape: tuple
    dtype: np.dtype


def _dtype(name: str, x: torch.Tensor) -> np.dtype:
    return (np.dtype(np.uint32) if name in U32_LEAVES
            else np.dtype(torch.empty((), dtype=x.dtype).numpy().dtype))


def leaf_specs(state) -> list:
    """The LeafSpec of every leaf, in the JAX flatten order; nothing is
    copied."""
    return [LeafSpec(name, tuple(x.shape), _dtype(name, x))
            for name, x in named_leaves(state)]


def host_leaf(name: str, x: torch.Tensor) -> np.ndarray:
    """A host copy of a leaf in its JAX dtype (a CUDA tensor's ``cpu()``
    is already a copy)."""
    arr = x.cpu().numpy() if x.is_cuda else x.numpy().copy()
    return arr.view(np.uint32) if name in U32_LEAVES else arr


def state_to_numpy(state) -> dict:
    return {name: host_leaf(name, x) for name, x in named_leaves(state)}


def carry_leaves(state) -> list:
    """The state's leaves on the host, in the JAX flatten order and
    dtypes: a checkpoint's ``c0..cK``."""
    return [host_leaf(name, x) for name, x in named_leaves(state)]


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")        # a copy; keeps 0-d leaves 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a, device=device)


def carry_from_leaves(template, leaves: list, device):
    """A carry of ``template``'s types (any of the port's states) from
    ``carry_leaves``-ordered host arrays, on ``device``."""
    return rebuild_carry(template, [_tensor(a, device) for a in leaves])


def state_from_numpy(leaves: dict, device="cpu"):
    def tensor(a):
        return _tensor(a, device)

    agg_type = FastAgg if "agg.join_total" in leaves else AggStats
    agg = agg_type(*(tensor(leaves[f"agg.{f}"]) for f in agg_type._fields))
    state_type = HashState if "wf_prev" in leaves else ShardedHashState
    return state_type(**{name: agg if name == "agg" else tensor(leaves[name])
                         for name in state_type._fields})
