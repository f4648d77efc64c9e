"""``PRNG_IMPL: rbg|unsafe_rbg`` in the port against the JAX package.

Under either implementation jax draws through XLA's ``rng_bit_generator``,
which XLA's CPU backend compiles to Philox4x32-10; the port's
``ops/rbg.py`` computes that stream.  Here its pieces are held against
``jax.random`` at tolerance 0: the keys (seed, ``split``, ``fold_in``,
rbg's ``split`` under both threefry streams), bits, uniforms and
``randint`` at odd counts and rank-2 shapes, a key whose counter carries
into its high half, draws at chosen elements, and the vmapped draws
(first-key rule: ``uniform_keys``, ``split_keys``, ``randint_keys``, the
tick keys of ``plan_tensors``).  Then the RNG plans of the ring steps:
the natural plan under batched and scattered, the folded plan, the
hoisted plans of a segment and the per-shard plan, with and without
drops.  Whole runs are in ``test_torch_rbg_paths.py``.
"""

import contextlib
import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.ops import rng_plan as jax_rng_plan
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.ops import rbg, threefry
from distributed_membership_tpu_torch.ops.rng_plan import (
    hash_ring_rng, hash_ring_rng_keys, sharded_ring_rng)
from distributed_membership_tpu_torch.runtime import failures

IMPLS = ["rbg", "unsafe_rbg"]
SEEDS = [0, 3, 0x5EED, 2**31 - 1]
COUNTS = [1, 3, 4, 5, 7, 1001]
M32 = 0xFFFFFFFF


@contextlib.contextmanager
def legacy():
    """Both packages on the legacy threefry stream; both flags restored."""
    prev = jax.config.jax_threefry_partitionable
    try:
        with jax.threefry_partitionable(False), threefry.partitionable(
                False):
            yield
    finally:
        jax.config.update("jax_threefry_partitionable", prev)


def _words(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


def _key(k, impl):
    return rbg.RbgKey(_words(k), impl)


def _bits(x):
    return np.asarray(x).view(np.uint32)


def _eq(got, want, what=""):
    got = np.asarray(got).reshape(-1)
    want = np.asarray(want).reshape(-1)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want.view(np.uint32), err_msg=what)


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("impl", IMPLS)
def test_key_derivation(impl, seed, partitionable):
    """seed, fold_in and split; rbg's split and fold_in run threefry on
    each half, under the stream in force."""
    ctx = contextlib.nullcontext() if partitionable else legacy()
    with ctx:
        jk = jax.random.key(seed, impl=impl)
        pk = failures.make_run_key(Params.from_text(f"PRNG_IMPL: {impl}\n"),
                                   seed)
        assert pk == rbg.seed(seed, impl) == _key(jk, impl)
        assert pk.words == (0, seed, 0, seed)
        for data in (0, 1, 59, 0x517F, 2**31 + 3):
            assert threefry.fold_in(pk, data) == _key(
                jax.random.fold_in(jk, data), impl)
        for num in (1, 2, 3, 4, 8, 9):
            assert threefry.split(pk, num) == [
                _key(k, impl) for k in jax.random.split(jk, num)]


@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("impl", IMPLS)
def test_bits_and_uniform(impl, n):
    jk = jax.random.fold_in(jax.random.key(7, impl=impl), 11)
    pk = _key(jk, impl)
    want = np.asarray(jax.random.uniform(jk, (n,)))
    _eq(threefry.uniform(pk, (n,), "cpu").numpy(), want)
    got_bits = threefry.random_bits(pk, n, "cpu").numpy()
    np.testing.assert_array_equal(got_bits.astype(np.uint32),
                                  np.asarray(jax.random.bits(jk, (n,))))
    # A rank-2 draw is the flat draw, row-major.
    for shape in ((n, 3), (3, n)):
        _eq(threefry.uniform(pk, shape, "cpu").numpy(),
            np.asarray(jax.random.uniform(jk, shape)), str(shape))
    # Any start element: the stream is counter-based.
    for start in (0, 1, 2, 3, 6):
        _eq(rbg.uniform(pk, n, "cpu", start=start).numpy(),
            np.asarray(jax.random.uniform(jk, (start + n,)))[start:])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("lo,hi,shape", [
    (1, 2**20, (4095,)), (1, 256, (256, 3)), (0, 16, (3,)), (0, 7, (101,)),
    (5, 70001, (9, 11)), (0, 2**31 - 1, (50,))])
def test_randint(impl, lo, hi, shape):
    jk = jax.random.fold_in(jax.random.key(5, impl=impl), 2)
    want = np.asarray(jax.random.randint(jk, shape, lo, hi))
    got = threefry.randint(_key(jk, impl), shape, lo, hi, "cpu").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_counter_carry(impl):
    """w2 = w3 = 0xFFFFFFFF: block 1 on carries out of the counter's low
    64 bits into its high half."""
    words = jnp.array([5, 6, M32, M32], jnp.uint32)
    jk = jax.random.wrap_key_data(words, impl=impl)
    pk = rbg.RbgKey((5, 6, M32, M32), impl)
    for n in (1, 4, 9, 4096 + 3):
        _eq(threefry.uniform(pk, (n,), "cpu").numpy(),
            np.asarray(jax.random.uniform(jk, (n,))), str(n))
        np.testing.assert_array_equal(
            threefry.random_bits(pk, n, "cpu").numpy().astype(np.uint32),
            np.asarray(jax.random.bits(jk, (n,))))
    idx = torch.tensor([0, 3, 4, 5, 4096, 4098])
    _eq(rbg.uniform_at(pk, idx).numpy(),
        np.asarray(jax.random.uniform(jk, (4099,)))[idx.numpy()])


@pytest.mark.parametrize("impl", IMPLS)
def test_uniform_at_is_the_flat_draw(impl):
    jk = jax.random.key(12, impl=impl)
    pk = _key(jk, impl)
    n = 4099
    want = np.asarray(jax.random.uniform(jk, (n,)))
    idx = torch.from_numpy(np.random.RandomState(1).randint(0, n, (17, 5)))
    _eq(threefry.uniform_at(pk, idx, n).numpy(), want[idx.numpy()])
    p = 0.3
    np.testing.assert_array_equal(
        threefry.bernoulli_at(pk, p, idx, n).numpy(),
        np.asarray(jax.random.bernoulli(jk, p, (n,)))[idx.numpy()])


@pytest.mark.parametrize("n", [1, 7, 64 * 16, 1001])
@pytest.mark.parametrize("impl", IMPLS)
def test_vmapped_draws_take_the_first_key(impl, n):
    """``jax.vmap`` of a draw over keys is the first key's draw of the
    whole batch: uniform_keys, bits_keys, split_keys and randint_keys."""
    keys = jax.random.split(jax.random.key(4, impl=impl), 5)
    pks = [_key(k, impl) for k in keys]
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))
    _eq(threefry.uniform_keys(pks, n, "cpu").numpy(), want)
    bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (n,)))(keys))
    np.testing.assert_array_equal(
        threefry.bits_keys(pks, n, "cpu").numpy().astype(np.uint32),
        bits.reshape(-1))
    # uniform_each is each key's own draw (the shards of a shard_map).
    _eq(threefry.uniform_each(pks, n, "cpu").numpy(),
        np.concatenate([np.asarray(jax.random.uniform(k, (n,)))
                        for k in keys]))
    want_split = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    assert threefry.split_keys(pks, 3) == [
        [_key(k, impl) for k in row] for row in want_split]
    want_int = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (n,), 1, 300))(keys))
    got_int = threefry.randint_keys(pks, (n,), 1, 300, "cpu")
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got_int]),
                                  want_int)


@pytest.mark.parametrize("impl", IMPLS)
def test_tick_keys_are_plan_tensors(impl):
    """PlanTensors.tick_key(t) is row t of the JAX plan_tensors' vmapped
    fold_in (under unsafe_rbg: tick 0's seed's draw)."""
    conf = f"MAX_NNB: 16\nPRNG_IMPL: {impl}\nTOTAL_TIME: 40\n"
    jp, pp = JaxParams.from_text(conf), Params.from_text(conf)
    jplan = jax_failures.make_plan(jp, random.Random("app:3"))
    pplan = failures.make_plan(pp, random.Random("app:3"))
    keys = jax_failures.plan_tensors(jp, jplan, 3, 40)[1]
    plan_t = failures.plan_tensors(pp, pplan, 3, 40, "cpu")
    assert [plan_t.tick_key(t) for t in range(40)] == [
        _key(k, impl) for k in keys]
    if impl == "unsafe_rbg":   # not the per-tick fold_in
        assert plan_t.tick_key(5) != threefry.fold_in(plan_t.root, 5)


NATURAL = dict(n=256, s=128, g=32, k_max=3, p_cnt=16, seed_rows=8,
               need_ctrl=True, need_burst=True)
# seed_rows * S == N * S: the burst coins share the [N, S] group.
NATURAL_CAP = dict(n=64, s=16, g=4, k_max=3, p_cnt=2, seed_rows=64,
                   need_ctrl=True, need_burst=True)
FOLDED = dict(n=256, s=16, g=4, k_max=3, p_cnt=2, seed_rows=8,
              need_ctrl=False, need_burst=False)


def _same_plan(got, want, what):
    for name in ("shift_draw", "thin_u", "ctrl_u", "burst_u", "probe_u",
                 "ack_u"):
        _eq(getattr(got, name), getattr(want, name), f"{what} {name}")
    gossip = np.asarray(want.gossip_u)
    assert len(got.gossip_u) == (gossip.shape[0] if gossip.size else 0)
    for j, u in enumerate(got.gossip_u):
        _eq(u, gossip[j], f"{what} gossip{j}")


def _tick_keys(impl, k=4):
    root = jax.random.key(9, impl=impl)
    return jax.vmap(lambda t: jax.random.fold_in(root, t))(jnp.arange(k))


@pytest.mark.parametrize("use_drop", [False, True])
@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("geometry", ["natural", "natural_cap", "folded"])
@pytest.mark.parametrize("impl", IMPLS)
def test_ring_plan_matches_jax(impl, geometry, batched, use_drop):
    kw = {"natural": NATURAL, "natural_cap": NATURAL_CAP,
          "folded": FOLDED}[geometry]
    keys = _tick_keys(impl)
    for shift_set in (0, 16):
        want = jax_rng_plan.hash_ring_rng(keys[1], shift_set=shift_set,
                                          use_drop=use_drop,
                                          batched=batched, **kw)
        got = hash_ring_rng(_key(keys[1], impl), device="cpu",
                            shift_set=shift_set, use_drop=use_drop,
                            batched=batched, **kw)
        _same_plan(got, want, f"shift_set {shift_set}")


@pytest.mark.parametrize("use_drop", [False, True])
@pytest.mark.parametrize("geometry", ["natural", "natural_cap", "folded"])
@pytest.mark.parametrize("impl", IMPLS)
def test_hoisted_plans_match_jax_vmap(impl, geometry, use_drop,
                                      monkeypatch):
    """RNG_MODE hoisted: the JAX ``vmap(build)(keys)`` over a segment's
    tick keys, every draw site from the first tick's keys, in passes."""
    from distributed_membership_tpu_torch.ops import rng_plan
    kw = {"natural": NATURAL, "natural_cap": NATURAL_CAP,
          "folded": FOLDED}[geometry]
    keys = _tick_keys(impl, 5)
    want = jax.vmap(lambda k: jax_rng_plan.hash_ring_rng(
        k, shift_set=0, use_drop=use_drop, batched=True, **kw))(keys)
    # Passes of two rows: a group's rows cross pass bounds.
    monkeypatch.setattr(rng_plan, "HOIST_PASS_ELEMENTS",
                        2 * kw["n"] * kw["s"])
    got = hash_ring_rng_keys([_key(k, impl) for k in keys], device="cpu",
                             use_drop=use_drop, **kw)
    assert len(got) == 5
    for b, plan in enumerate(got):
        _same_plan(plan, jax.tree.map(lambda x: x[b], want), f"tick {b}")


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("impl", IMPLS)
def test_sharded_plan_matches_jax(impl, batched, cold):
    """shard_map is no vmap: shard ``me`` draws from its own keys, its
    same-size draws grouped within the shard."""
    skw = dict(n=256, n_local=32, s=128, g=32, k_max=3, p_cnt=16,
               seed_rows=8, use_drop=True, cold_join=cold)
    key = _tick_keys(impl)[2]
    got = sharded_ring_rng(_key(key, impl), range(8), device="cpu",
                           batched=batched, **skw)
    per = [jax_rng_plan.sharded_ring_rng(key, me, batched=batched, **skw)
           for me in range(8)]
    for name in ("thin_u", "probe_u", "ack_u"):
        _eq(getattr(got, name),
            np.concatenate([np.asarray(getattr(w, name)) for w in per]), name)
    for j in range(3):
        _eq(got.gossip_u[j], np.concatenate(
            [np.asarray(w.gossip_u)[j] for w in per]), f"gossip{j}")
    for name in ("shift_draw", "ctrl_u", "burst_u"):
        for w in per:
            _eq(getattr(got, name), getattr(w, name), name)
    # Shards 2..5 of the same tick: the same rows of the concatenation.
    part = sharded_ring_rng(_key(key, impl), range(2, 6), device="cpu",
                            batched=batched, **skw)
    _eq(part.thin_u, np.concatenate([np.asarray(w.thin_u)
                                     for w in per[2:6]]))


@pytest.mark.parametrize("impl", IMPLS)
def test_sharded_replicated_coins_in_a_shard_group_are_refused(impl):
    """Cold joins where the control coins' count equals a per-shard
    stream's that comes first: each JAX shard would draw other
    "replicated" coins, which the port refuses to guess."""
    key = rbg.seed(3, impl)
    with pytest.raises(NotImplementedError, match="ctrl coins"):
        sharded_ring_rng(key, range(8), n=256, n_local=32, s=16, g=4,
                         k_max=3, p_cnt=2, seed_rows=8, use_drop=True,
                         cold_join=True, device="cpu")
    # Scattered, every draw is its own: nothing to refuse.
    sharded_ring_rng(key, range(8), n=256, n_local=32, s=16, g=4, k_max=3,
                     p_cnt=2, seed_rows=8, use_drop=True, cold_join=True,
                     device="cpu", batched=False)


@pytest.mark.parametrize("impl", IMPLS)
def test_legacy_stream_plans(impl):
    """JAX_THREEFRY_PARTITIONABLE=0: rbg's split runs the legacy threefry
    split on its halves; the plans follow."""
    with legacy():
        keys = _tick_keys(impl)
        want = jax_rng_plan.hash_ring_rng(keys[3], shift_set=0,
                                          use_drop=True, **NATURAL)
        got = hash_ring_rng(_key(keys[3], impl), device="cpu",
                            use_drop=True, **NATURAL)
        _same_plan(got, want, "legacy")
