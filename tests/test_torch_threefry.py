"""The port's threefry2x32 (distributed_membership_tpu_torch/ops/threefry.py)
and per-tick RNG plan (ops/rng_plan.py) against ``jax.random``, bit for
bit.

Every random stream of the ring step is a ``jax.random`` stream in the
JAX package, so per-tick parity of the port rests on these equalities.
The port implements the partitionable stream
(``jax_threefry_partitionable=True``, the jax 0.9 default); the fixture
below refuses to compare against any other.
"""

import numpy as np
import pytest

import jax
import torch

from distributed_membership_tpu.ops import rng_plan as jax_rng_plan
from distributed_membership_tpu_torch.ops import threefry
from distributed_membership_tpu_torch.ops.rng_plan import hash_ring_rng

SEEDS = [0, 1, 42, 0x5EED, 7 ^ 0x5EED, 2**31 - 1, 2**32 - 1]


@pytest.fixture(autouse=True)
def _partitionable_stream():
    assert jax.config.jax_threefry_partitionable, (
        "the port reproduces the partitionable threefry stream only")


def _key(k):
    return tuple(int(x) for x in np.asarray(k, np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_derivation(seed):
    jk = jax.random.PRNGKey(seed)
    pk = threefry.prng_key(seed)
    assert pk == _key(jk)
    for data in (0, 1, 59, 0x517F, 2**31 + 3):
        assert threefry.fold_in(pk, data) == _key(
            jax.random.fold_in(jk, data))
    for num in (2, 3, 8):
        assert threefry.split(pk, num) == [
            _key(k) for k in jax.random.split(jk, num)]


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (256, 128),
                                   (2, 1000)])
def test_uniform(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = threefry.uniform(_key(jk), shape, "cpu").numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_flat_equals_shaped():
    """``uniform(k, (n, s))`` is ``uniform(k, (n*s,))`` reshaped, the
    property the port's flat plan draws rely on."""
    jk = jax.random.PRNGKey(3)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (64, 128))).reshape(-1),
        threefry.uniform(_key(jk), (64 * 128,), "cpu").numpy())


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("lo,hi,shape", [
    (1, 2**20, (4096,)),          # [1, 2^20): the 1M ring's shift range
    (1, 256, (256, 64)),          # [1, N): warm-join neighbour offsets
    (1, 4096, (3,)),
    (0, 7, (100,)),
    (1, 2, (10,)),                # span 1 (N = 2)
    (5, 70001, (999,)),           # span above 2^16: the u32 multiplier wraps
    (0, 2**31 - 1, (50,)),
])
def test_randint(seed, lo, hi, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    want = np.asarray(jax.random.randint(jk, shape, lo, hi))
    got = threefry.randint(_key(jk), shape, lo, hi, "cpu").numpy()
    assert got.dtype == np.int32 and got.shape == shape
    np.testing.assert_array_equal(got, want)


def test_randint_rejects_unsupported_range():
    with pytest.raises(ValueError):
        threefry.randint((0, 1), (4,), 3, 3, "cpu")
    with pytest.raises(ValueError):
        threefry.randint((0, 1), (4,), -1, 3, "cpu")


def _as_np(x):
    return (x.numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x)).reshape(-1)


@pytest.mark.parametrize("use_drop", [False, True])
@pytest.mark.parametrize("n,s,g,k_max,p_cnt", [(256, 128, 32, 3, 16),
                                               (64, 128, 128, 2, 0)])
def test_hash_ring_rng_matches_jax(use_drop, n, s, g, k_max, p_cnt):
    jk = jax.random.fold_in(jax.random.PRNGKey(9), 33)
    seed_rows = min(8, n)
    want = jax_rng_plan.hash_ring_rng(
        jk, n=n, s=s, g=g, k_max=k_max, p_cnt=p_cnt, seed_rows=seed_rows,
        shift_set=0, use_drop=use_drop, need_ctrl=True, need_burst=True)
    got = hash_ring_rng(_key(jk), n=n, s=s, g=g, k_max=k_max, p_cnt=p_cnt,
                        seed_rows=seed_rows, use_drop=use_drop,
                        need_ctrl=True, need_burst=True, device="cpu")
    np.testing.assert_array_equal(_as_np(got.shift_draw),
                                  _as_np(want.shift_draw))
    for name in ("thin_u", "ctrl_u", "burst_u", "probe_u", "ack_u"):
        np.testing.assert_array_equal(_as_np(getattr(got, name)),
                                      _as_np(getattr(want, name)),
                                      err_msg=name)
    assert len(got.gossip_u) == (k_max if use_drop else 0)
    for j, u in enumerate(got.gossip_u):
        np.testing.assert_array_equal(_as_np(u),
                                      np.asarray(want.gossip_u[j]),
                                      err_msg=f"gossip_u[{j}]")


@pytest.mark.parametrize("use_drop", [False, True])
def test_folded_ring_rng_matches_jax(use_drop):
    """The folded step's plan (S = 16, no control or burst coins): the
    streams it reads equal the JAX ones, and the two it skips are
    empty."""
    jk = jax.random.fold_in(jax.random.PRNGKey(4), 17)
    kw = dict(n=256, s=16, g=4, k_max=3, p_cnt=2, seed_rows=8,
              use_drop=use_drop, need_ctrl=False, need_burst=False)
    want = jax_rng_plan.hash_ring_rng(jk, shift_set=0, **kw)
    got = hash_ring_rng(_key(jk), device="cpu", **kw)
    for name in ("shift_draw", "thin_u", "probe_u", "ack_u"):
        np.testing.assert_array_equal(_as_np(getattr(got, name)),
                                      _as_np(getattr(want, name)),
                                      err_msg=name)
    assert got.ctrl_u.numel() == got.burst_u.numel() == 0
    assert len(got.gossip_u) == (3 if use_drop else 0)
    for j, u in enumerate(got.gossip_u):
        np.testing.assert_array_equal(_as_np(u),
                                      np.asarray(want.gossip_u[j]))


def test_random_bits_rejects_oversize_draw():
    with pytest.raises(ValueError):
        threefry.random_bits((0, 1), 1 << 32, "cpu")
