"""Gossip-target sampling (the JAX package's ``ops/sampling.py``).

The reference picks ``FANOUT`` distinct eligible view entries by
rejection sampling (MP1Node.cpp:449-489); the JAX package draws an iid
uniform score per slot and keeps the ``k`` smallest, the same uniform
k-subset in one pass.
"""

from __future__ import annotations

import torch


def sample_k_indices(scores: torch.Tensor, eligible: torch.Tensor,
                     k: torch.Tensor, k_max: int):
    """``([N, k_max] slot indices, [N, k_max] valid)`` from the ``[N, M]``
    float32 ``scores`` (``uniform(k_targets, (N, M))``), as the JAX
    ``sample_k_indices``: the ``min(k_max, M)`` largest ``-score`` of the
    eligible slots, ineligible slots scoring ``-2.0``.  ``lax.top_k``
    breaks ties lowest index first, and so does the stable descending
    sort here; every ineligible slot ties at ``-2.0``, so the order of
    the invalid tail matters to the indices returned."""
    m = eligible.shape[1]
    neg = torch.where(eligible, -scores, -2.0)
    top_vals, top_idx = torch.sort(neg, dim=1, descending=True, stable=True)
    kk = min(k_max, m)
    top_vals, top_idx = top_vals[:, :kk], top_idx[:, :kk]
    arange_k = torch.arange(kk, device=scores.device)
    valid = (arange_k[None, :] < k[:, None]) & (top_vals > -2.0)
    return top_idx, valid
