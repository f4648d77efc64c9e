"""Carry a ring-step state across implementations.

``state_to_numpy`` flattens a port ``HashState`` or ``ShardedHashState``
into a dict of numpy arrays with the JAX leaf names (``agg.<field>`` for
the aggregate leaves) and the JAX dtypes (u32 planes as ``uint32``);
``state_from_numpy`` builds the port's state from such a dict, e.g. the
leaves of a JAX state (a ``ShardedHashState`` when the leaves have no
``wf_prev``, which only the single-chip state carries).  Both copy, so
neither side aliases the other.  A folded state, single-chip or sharded
(backends/tpu_hash_folded.py), has the same leaves with folded shapes;
both directions keep whatever shape a leaf has.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_membership_tpu_torch.backends.tpu_hash import HashState
from distributed_membership_tpu_torch.backends.tpu_hash_sharded import (
    ShardedHashState)
from distributed_membership_tpu_torch.observability.aggregates import (
    AggStats, FastAgg)

U32_LEAVES = frozenset({"view", "mail", "amail", "pmail", "probe_ids1",
                        "probe_ids2"})


def state_to_numpy(state) -> dict:
    out = {}
    for name, leaf in state._asdict().items():
        if name == "agg":
            for field, x in leaf._asdict().items():
                out[f"agg.{field}"] = x.cpu().numpy().copy()
            continue
        arr = leaf.cpu().numpy().copy()
        out[name] = arr.view(np.uint32) if name in U32_LEAVES else arr
    return out


def state_from_numpy(leaves: dict, device="cpu"):
    def tensor(a):
        a = np.array(a, order="C")        # a copy; keeps 0-d leaves 0-d
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.tensor(a, device=device)

    agg_type = FastAgg if "agg.join_total" in leaves else AggStats
    agg = agg_type(*(tensor(leaves[f"agg.{f}"]) for f in agg_type._fields))
    state_type = HashState if "wf_prev" in leaves else ShardedHashState
    return state_type(**{name: agg if name == "agg" else tensor(leaves[name])
                         for name in state_type._fields})
