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

Every draw follows the stream of ops/threefry.py in force (partitionable
or legacy), as the JAX package's follow jax's flag.

The sharded ring step draws per shard (:func:`sharded_ring_rng`): its
per-shard streams, concatenated in shard order, are the flat draws the
step reads on the ``[N, ...]`` layout.  Each stream is drawn for every
shard in one pass (``uniform_keys``), as the JAX package's batched mode
vmaps same-size draws.  :func:`hash_ring_rng_keys` draws the plans of
many ticks the same way, one pass per stream (``RNG_MODE: hoisted``).
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
                  need_ctrl: bool, need_burst: bool, device,
                  shift_set: int = 0) -> RingRng:
    """The single-chip ring step's plan (JAX ``hash_ring_rng``).  The
    natural step draws the control and burst coins
    (``need_ctrl``/``need_burst``); the folded step reads neither, and
    their keys are separate, so leaving them out changes no other
    stream.  With ``shift_set`` K the shift draw is K-table indices in
    ``[0, K)`` (``SHIFT_SET``)."""
    return hash_ring_rng_keys(
        [key], n=n, s=s, g=g, k_max=k_max, p_cnt=p_cnt,
        seed_rows=seed_rows, use_drop=use_drop, need_ctrl=need_ctrl,
        need_burst=need_burst, device=device, shift_set=shift_set)[0]


# Elements per pass of a multi-key draw: the threefry's int64 working
# set is ~24 bytes per element, so a pass stays under ~24 GiB.
HOIST_PASS_ELEMENTS = 1 << 30


def _draw_keys(keys, numel: int, device) -> list:
    """``[uniform(k, (numel,)) for k in keys]``, one pass per group of
    keys of at most HOIST_PASS_ELEMENTS elements."""
    per = max(1, HOIST_PASS_ELEMENTS // max(numel, 1))
    out = []
    for i in range(0, len(keys), per):
        group = keys[i:i + per]
        out.extend(uniform_keys(group, numel, device).view(len(group),
                                                           numel).unbind(0))
    return out


def hash_ring_rng_keys(keys, *, n: int, s: int, g: int, k_max: int,
                       p_cnt: int, seed_rows: int, use_drop: bool,
                       need_ctrl: bool, need_burst: bool,
                       device, shift_set: int = 0) -> list:
    """:func:`hash_ring_rng` for each key of ``keys``, each stream drawn
    for every key in one pass (``uniform_keys``): the per-tick plans of a
    whole segment at once, for ``RNG_MODE: hoisted`` (the JAX
    ``vmap(_ring_rng_builder(...))`` over the segment's keys).  One key
    is the per-tick draw."""
    k = len(keys)
    subs = [split(key, 8) for key in keys]
    empty = torch.zeros((0,), dtype=torch.float32, device=device)

    def draw(stream: int, numel: int, j=None) -> list:
        ks = [sk[stream] if j is None else fold_in(sk[stream], j)
              for sk in subs]
        return _draw_keys(ks, numel, device)

    lo, hi = (0, shift_set) if shift_set else (1, max(n, 2))
    shift_draw = [randint(sk[5], (k_max,), lo, hi, device) for sk in subs]
    thin_u = draw(1, n * s) if g < s else [empty] * k
    if not use_drop:
        return [RingRng(shift_draw[i], thin_u[i], (), empty, empty, empty,
                        empty) for i in range(k)]
    probe_u = ack_u = [empty] * k
    if p_cnt > 0:
        probe_u = draw(6, n * p_cnt)
        ack_u = draw(7, n * p_cnt)
    gossip_u = [draw(2, n * s, j) for j in range(k_max)]
    ctrl_u = draw(3, 2 * n) if need_ctrl else [empty] * k
    burst_u = draw(2, seed_rows * s) if need_burst else [empty] * k
    return [RingRng(shift_draw=shift_draw[i], thin_u=thin_u[i],
                    gossip_u=tuple(gu[i] for gu in gossip_u),
                    ctrl_u=ctrl_u[i], burst_u=burst_u[i],
                    probe_u=probe_u[i], ack_u=ack_u[i]) for i in range(k)]


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
