"""Per-tick RNG plan for the ring step (counterpart of the JAX package's
``ops/rng_plan.py``).

The key derivation is exactly the JAX step's: ``split(key, 8)`` into
``(k_targets, k_entries, k_drop, k_ctrl, k_drop_p, k_shifts, k_ack1,
k_ack2)``, per-shift drop keys ``fold_in(k_drop, j)``, and the seed-burst
coin on the raw ``k_drop``.  The JAX package groups same-size draws into
one vmapped threefry call; a vmapped draw equals the per-key draw, so the
port simply draws each request on its own.

Drop coins are kept as float32 uniforms: ``bernoulli(k, p)`` is
``uniform(k) < f32(p)``, compared at the use site.

The sharded ring step draws per shard (:func:`sharded_ring_rng`): its
per-shard streams, concatenated in shard order, are the flat draws the
step reads on the ``[N, ...]`` layout.  Each stream is drawn for every
shard in one pass (``uniform_keys``), as the JAX package's batched mode
vmaps same-size draws.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from distributed_membership_tpu_torch.ops.threefry import (
    Key, fold_in, randint, split, uniform, uniform_keys)


class RingRng(NamedTuple):
    """One tick's random material, flat float32 draws (consumers reshape).
    Streams a config does not consume are empty tensors."""
    shift_draw: torch.Tensor       # [k_max] int32 gossip shifts in [1, N)
    thin_u: torch.Tensor           # [N*S] entry-thinning uniforms (g < s)
    gossip_u: Tuple[torch.Tensor, ...]  # k_max x [N*S] per-shift drop coins
    ctrl_u: torch.Tensor           # [2*N] control-plane drop coins
    burst_u: torch.Tensor          # [seed_rows*S] seed-burst drop coins
    probe_u: torch.Tensor          # [N*P] probe-leg drop coins
    ack_u: torch.Tensor            # [N*P] ack-leg drop coins


def hash_ring_rng(key: Key, *, n: int, s: int, g: int, k_max: int,
                  p_cnt: int, seed_rows: int, use_drop: bool,
                  need_ctrl: bool, need_burst: bool, device) -> RingRng:
    """The single-chip ring step's plan (JAX ``hash_ring_rng`` with
    ``shift_set=0``).  The natural step draws the control and burst coins
    (``need_ctrl``/``need_burst``); the folded step reads neither, and
    their keys are separate, so leaving them out changes no other
    stream."""
    (_k_targets, k_entries, k_drop, k_ctrl, _k_drop_p, k_shifts,
     k_ack1, k_ack2) = split(key, 8)
    empty = torch.zeros((0,), dtype=torch.float32, device=device)
    shift_draw = randint(k_shifts, (k_max,), 1, max(n, 2), device)
    thin_u = uniform(k_entries, (n * s,), device) if g < s else empty
    if not use_drop:
        return RingRng(shift_draw, thin_u, (), empty, empty, empty, empty)
    probe_u = ack_u = empty
    if p_cnt > 0:
        probe_u = uniform(k_ack1, (n * p_cnt,), device)
        ack_u = uniform(k_ack2, (n * p_cnt,), device)
    return RingRng(
        shift_draw=shift_draw,
        thin_u=thin_u,
        gossip_u=tuple(uniform(fold_in(k_drop, j), (n * s,), device)
                       for j in range(k_max)),
        ctrl_u=uniform(k_ctrl, (2 * n,), device) if need_ctrl else empty,
        burst_u=(uniform(k_drop, (seed_rows * s,), device) if need_burst
                 else empty),
        probe_u=probe_u,
        ack_u=ack_u,
    )


def sharded_ring_rng(key: Key, shards: range, *, n: int, n_local: int,
                     s: int, g: int, k_max: int, p_cnt: int, seed_rows: int,
                     use_drop: bool, cold_join: bool, device) -> RingRng:
    """The plan of the shards ``shards`` for the sharded ring step (JAX
    ``sharded_ring_rng``, shard by shard, concatenated in shard order):
    shard ``me``'s streams come from ``split(fold_in(key, me), 4)`` as
    ``(k_entries, k_probe_drop, k_ack2, k_dropg)`` and are drawn over its
    ``L = n_local`` rows; the replicated ones, drawn once, from the tick
    key: the gossip shifts at ``fold_in(key, 0x517F)``, drawn in ``[1,
    N)``, and with ``cold_join`` the control and burst coins at
    ``0xC281`` and ``0xB125``."""
    per = [split(fold_in(key, me), 4) for me in shards]
    empty = torch.zeros((0,), dtype=torch.float32, device=device)

    def draw(stream: int, numel: int, j=None):
        return uniform_keys([k[stream] if j is None else fold_in(k[stream], j)
                             for k in per], numel, device)

    shift_draw = randint(fold_in(key, 0x517F), (k_max,), 1, max(n, 2),
                         device)
    thin_u = draw(0, n_local * s) if g < s else empty
    if not use_drop:
        return RingRng(shift_draw, thin_u, (), empty, empty, empty, empty)
    probe_u = ack_u = empty
    if p_cnt > 0:
        probe_u = draw(1, n_local * p_cnt)
        ack_u = draw(2, n_local * p_cnt)
    return RingRng(
        shift_draw=shift_draw,
        thin_u=thin_u,
        gossip_u=tuple(draw(3, n_local * s, j) for j in range(k_max)),
        ctrl_u=(uniform(fold_in(key, 0xC281), (2 * n,), device) if cold_join
                else empty),
        burst_u=(uniform(fold_in(key, 0xB125), (seed_rows * s,), device)
                 if cold_join else empty),
        probe_u=probe_u,
        ack_u=ack_u,
    )
