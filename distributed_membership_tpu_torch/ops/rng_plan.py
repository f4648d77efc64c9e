"""Per-tick RNG plan for the ring step (counterpart of the JAX package's
``ops/rng_plan.py``).

The key derivation is exactly the JAX step's: ``split(key, 8)`` into
``(k_targets, k_entries, k_drop, k_ctrl, k_drop_p, k_shifts, k_ack1,
k_ack2)``, per-shift drop keys ``fold_in(k_drop, j)``, and the seed-burst
coin on the raw ``k_drop``.  The JAX package groups same-size draws into
one vmapped call (``RNG_MODE`` batched, the default; scattered draws
each on its own).  Under threefry a vmapped draw equals the per-key
draw, so batched and scattered give the same bits and the port simply
draws each request on its own.  That holds under threefry alone: under
``PRNG_IMPL: rbg|unsafe_rbg`` a vmapped draw is the first key's draw of
the whole batch (ops/rbg.py), so the port groups the requests as the
JAX package does and draws each group from its first key
(:func:`_rbg_plans`).

Drop coins are kept as float32 uniforms: ``bernoulli(k, p)`` is
``uniform(k) < f32(p)``, compared at the use site.

Every draw follows the stream of ops/threefry.py in force (partitionable
or legacy), as the JAX package's follow jax's flag.

The sharded ring step draws per shard (:func:`sharded_ring_rng`): its
per-shard streams, concatenated in shard order, are the flat draws the
step reads on the ``[N, ...]`` layout.  Under threefry each stream is
drawn for every shard in one pass (``uniform_keys``).
:func:`hash_ring_rng_keys` draws the plans of many ticks the same way,
one pass per stream (``RNG_MODE: hoisted``, the JAX package's
``vmap(build)(keys)``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from distributed_membership_tpu_torch.ops import rbg
from distributed_membership_tpu_torch.ops.threefry import (
    Key, fold_in, is_rbg, randint, randint_keys, split, split_keys,
    uniform, uniform_keys)


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
                  shift_set: int = 0, batched: bool = True) -> RingRng:
    """The single-chip ring step's plan (JAX ``hash_ring_rng``).  The
    natural step draws the control and burst coins
    (``need_ctrl``/``need_burst``); the folded step reads neither, and
    their keys are separate, so leaving them out changes no other
    stream.  With ``shift_set`` K the shift draw is K-table indices in
    ``[0, K)`` (``SHIFT_SET``).  ``batched`` is ``RNG_MODE`` not
    scattered (it changes the bits under rbg only)."""
    return hash_ring_rng_keys(
        [key], n=n, s=s, g=g, k_max=k_max, p_cnt=p_cnt,
        seed_rows=seed_rows, use_drop=use_drop, need_ctrl=need_ctrl,
        need_burst=need_burst, device=device, shift_set=shift_set,
        batched=batched)[0]


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


def _rows_of_first(keys, numel: int, device) -> list:
    """The rows of the vmapped draw ``jax.vmap(lambda k: uniform(k,
    (numel,)))(keys)`` under rbg: the first key's flat draw of
    ``len(keys) * numel`` elements, cut into rows, in passes of at most
    HOIST_PASS_ELEMENTS elements (one kernel launch each on the card)."""
    per = max(1, HOIST_PASS_ELEMENTS // max(numel, 1))
    out = []
    for i in range(0, len(keys), per):
        rows = min(per, len(keys) - i)
        out.extend(rbg.uniform(keys[0], rows * numel, device,
                               start=i * numel).view(rows, numel).unbind(0))
    return out


def _rbg_draws(requests, k: int, batched: bool, device) -> dict:
    """The JAX ``batched_uniforms`` under ``jax.vmap`` over ``k`` tick
    keys (``k = 1``: no outer vmap), for rbg keys.  ``requests`` is the
    JAX request list, ``(name, [key of each tick], count)`` in its order;
    returns ``{name: [flat draw of each tick]}``.  Batched, requests of
    one count form a group in order of first appearance, drawn by one
    vmapped call (nested inside the outer vmap: flattened tick-major, so
    every row comes from the first tick's first key); else each request
    is a group of its own."""
    groups: dict = {}
    for i, (_, _, cnt) in enumerate(requests):
        groups.setdefault(cnt if batched else i, []).append(i)
    out = {}
    for idxs in groups.values():
        cnt = requests[idxs[0]][2]
        flat = [requests[i][1][b] for b in range(k) for i in idxs]
        rows = _rows_of_first(flat, cnt, device)
        for r, i in enumerate(idxs):
            out[requests[i][0]] = rows[r::len(idxs)]
    return out


def _rbg_requests(keys: dict, *, rows, n, s, g, k_max, p_cnt, seed_rows,
                  use_drop) -> list:
    """The JAX request list (``hash_ring_rng``'s, or ``sharded_ring_rng``'s
    over a shard's ``rows``), in its order.  ``keys`` maps each stream to
    its key of each tick (the gossip coins fold ``drop``'s in); the
    control and burst coins are drawn where they have keys."""
    req = [("thin", keys["thin"], rows * s)] if g < s else []
    if use_drop:
        req += [(f"gossip{j}", [fold_in(k, j) for k in keys["drop"]],
                 rows * s) for j in range(k_max)]
        if "ctrl" in keys:
            req += [("ctrl", keys["ctrl"], 2 * n)]
        if "burst" in keys:
            req += [("burst", keys["burst"], seed_rows * s)]
        if p_cnt > 0:
            req += [("probe", keys["probe"], rows * p_cnt),
                    ("ack", keys["ack"], rows * p_cnt)]
    return req


def _plan_of(drawn: dict, b: int, shift_draw, k_max: int, use_drop: bool,
             device) -> RingRng:
    """Tick ``b``'s RingRng from :func:`_rbg_draws`' output."""
    empty = torch.zeros((0,), dtype=torch.float32, device=device)

    def got(name):
        return drawn[name][b] if name in drawn else empty

    return RingRng(shift_draw=shift_draw, thin_u=got("thin"),
                   gossip_u=(tuple(got(f"gossip{j}") for j in range(k_max))
                             if use_drop else ()),
                   ctrl_u=got("ctrl"), burst_u=got("burst"),
                   probe_u=got("probe"), ack_u=got("ack"))


def _rbg_plans(keys, *, n, s, g, k_max, p_cnt, seed_rows, use_drop,
               need_ctrl, need_burst, device, shift_set, batched) -> list:
    """:func:`hash_ring_rng_keys` for rbg and unsafe_rbg keys: the JAX
    ``vmap(build)(keys)`` (one key: ``build(key)``), every draw site the
    vmapped draw of ops/rbg.py."""
    subs = split_keys(keys, 8)
    lo, hi = (0, shift_set) if shift_set else (1, max(n, 2))
    shift_draw = randint_keys([sk[5] for sk in subs], (k_max,), lo, hi,
                              device)
    streams = {"thin": 1, "drop": 2, "probe": 6, "ack": 7}
    if need_ctrl:
        streams["ctrl"] = 3
    if need_burst:
        streams["burst"] = 2
    req = _rbg_requests({name: [sk[i] for sk in subs]
                         for name, i in streams.items()},
                        rows=n, n=n, s=s, g=g, k_max=k_max, p_cnt=p_cnt,
                        seed_rows=seed_rows, use_drop=use_drop)
    drawn = _rbg_draws(req, len(keys), batched, device)
    return [_plan_of(drawn, b, shift_draw[b], k_max, use_drop, device)
            for b in range(len(keys))]


def hash_ring_rng_keys(keys, *, n: int, s: int, g: int, k_max: int,
                       p_cnt: int, seed_rows: int, use_drop: bool,
                       need_ctrl: bool, need_burst: bool,
                       device, shift_set: int = 0,
                       batched: bool = True) -> list:
    """:func:`hash_ring_rng` for each key of ``keys``, each stream drawn
    for every key in one pass (``uniform_keys``): the per-tick plans of a
    whole segment at once, for ``RNG_MODE: hoisted`` (the JAX
    ``vmap(_ring_rng_builder(...))`` over the segment's keys).  One key
    is the per-tick draw.  Under rbg the plans are the vmapped builder's,
    not each key's own (:func:`_rbg_plans`)."""
    if is_rbg(keys[0]):
        return _rbg_plans(keys, n=n, s=s, g=g, k_max=k_max, p_cnt=p_cnt,
                          seed_rows=seed_rows, use_drop=use_drop,
                          need_ctrl=need_ctrl, need_burst=need_burst,
                          device=device, shift_set=shift_set,
                          batched=batched)
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
                     use_drop: bool, cold_join: bool, device,
                     batched: bool = True) -> RingRng:
    """The plan of the shards ``shards`` for the sharded ring step (JAX
    ``sharded_ring_rng``, shard by shard, concatenated in shard order):
    shard ``me``'s streams come from ``split(fold_in(key, me), 4)`` as
    ``(k_entries, k_probe_drop, k_ack2, k_dropg)`` and are drawn over its
    ``L = n_local`` rows; the replicated ones, drawn once, from the tick
    key: the gossip shifts at ``fold_in(key, 0x517F)``, drawn in ``[1,
    N)``, and with ``cold_join`` the control and burst coins at
    ``0xC281`` and ``0xB125``.  ``batched`` as :func:`hash_ring_rng`'s.
    """
    if is_rbg(key):
        return _rbg_sharded(key, shards, n=n, n_local=n_local, s=s, g=g,
                            k_max=k_max, p_cnt=p_cnt, seed_rows=seed_rows,
                            use_drop=use_drop, cold_join=cold_join,
                            device=device, batched=batched)
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


def _rbg_sharded(key, shards: range, *, n, n_local, s, g, k_max, p_cnt,
                 seed_rows, use_drop, cold_join, device, batched) -> RingRng:
    """:func:`sharded_ring_rng` for rbg keys.  Each shard runs the JAX
    request list under ``shard_map`` (not a vmap), so each draws from its
    own keys, grouped as its ``batched_uniforms`` groups them.  The
    replicated control and burst coins are drawn once; a group that
    would draw them from a shard's own key is refused, since each shard
    of the JAX step would then hold other "replicated" coins."""
    shift_draw = randint(fold_in(key, 0x517F), (k_max,), 1, max(n, 2),
                         device)
    shared = ({"ctrl": [fold_in(key, 0xC281)],
               "burst": [fold_in(key, 0xB125)]} if cold_join else {})
    drawn = {}
    for me in shards:
        own = dict(zip(("thin", "probe", "ack", "drop"),
                       ([k] for k in split(fold_in(key, me), 4))))
        req = _rbg_requests({**own, **shared}, rows=n_local, n=n, s=s, g=g,
                            k_max=k_max, p_cnt=p_cnt, seed_rows=seed_rows,
                            use_drop=use_drop)
        if batched:
            _refuse_shared_rows(req, shared, key.impl)
        for name, rows in _rbg_draws(req, 1, batched, device).items():
            drawn.setdefault(name, []).extend(rows)
    # Per-shard streams in shard order; a replicated stream leads its
    # group, so every shard drew the same, and one copy is kept.
    flat = {name: [v[0] if name in shared else torch.cat(v)]
            for name, v in drawn.items()}
    return _plan_of(flat, 0, shift_draw, k_max, use_drop, device)


def _refuse_shared_rows(req, shared: dict, impl: str) -> None:
    """Raise where a replicated stream of ``shared`` would be drawn in a
    batched group led by a per-shard stream."""
    lead = {}
    for name, _, cnt in req:
        lead.setdefault(cnt, name)
    for name, _, cnt in req:
        if name in shared and lead[cnt] not in shared:
            raise NotImplementedError(
                f"PRNG_IMPL {impl} on the sharded ring with cold joins: "
                f"the {name} coins ({cnt} elements) share a batched draw "
                f"with the per-shard {lead[cnt]} stream, so each shard of "
                "the JAX step would hold other replicated coins")
