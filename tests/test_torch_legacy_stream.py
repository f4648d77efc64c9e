"""The legacy threefry stream of the port against the JAX package.

jax keeps two threefry streams behind its ``jax_threefry_partitionable``
flag; the banked SLO distribution of the reference's singlefailure
testcase came from the legacy one (``False``).  The port switches with
``threefry.partitionable(flag)`` (or ``JAX_THREEFRY_PARTITIONABLE``, which
jax reads too).  Here the stream's pieces are held against ``jax.random``
under ``jax.threefry_partitionable(False)`` at odd and even sizes, and
whole runs of both packages under the legacy stream against each other:
per tick on the natural and folded steps, and by their logs (every
tick's events and message counts) on the sharded, scatter, hoisted and
T-tick-block paths.  Each test switches both flags back on its way out,
so the other tests of a worker keep the partitionable stream.
"""

import contextlib
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

import jax
import torch

from distributed_membership_tpu.backends import get_backend as jax_backend
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.ops import rng_plan as jax_rng_plan
from distributed_membership_tpu_torch.backends import get_backend
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.observability.latency_dist import (
    REFERENCE_DISTRIBUTION, slo_verdict)
from distributed_membership_tpu_torch.ops import threefry
from distributed_membership_tpu_torch.ops.rng_plan import (
    hash_ring_rng, hash_ring_rng_keys, sharded_ring_rng)

from test_torch_ring_options import _conf, run_both

SEEDS = [0, 3, 0x5EED, 2**32 - 1]
SIZES = [1, 2, 7, 8, 255, 1001, 4096]


@contextlib.contextmanager
def legacy():
    """Both packages on the legacy stream; both flags restored after."""
    prev = jax.config.jax_threefry_partitionable
    try:
        with jax.threefry_partitionable(False), threefry.partitionable(
                False):
            yield
    finally:
        jax.config.update("jax_threefry_partitionable", prev)
    assert threefry.is_partitionable() == prev


def _key(k):
    return tuple(int(x) for x in np.asarray(k, np.uint32))


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_derivation(seed):
    with legacy():
        jk = jax.random.PRNGKey(seed)
        pk = threefry.prng_key(seed)
        assert pk == _key(jk)
        for data in (0, 1, 59, 0x517F, 2**31 + 3):
            assert threefry.fold_in(pk, data) == _key(
                jax.random.fold_in(jk, data))
        for num in (2, 3, 4, 8, 9):
            assert threefry.split(pk, num) == [
                _key(k) for k in jax.random.split(jk, num)]


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("n", SIZES)
def test_bits_and_uniform(seed, n):
    """``random_bits``/``uniform`` of an odd or even count, and the same
    elements taken at chosen positions (``uniform_at``)."""
    with legacy():
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
        want = np.asarray(jax.random.uniform(jk, (n,)))
        got = threefry.uniform(_key(jk), (n,), "cpu").numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
        bits = jax.random.bits(jk, (n,), np.uint32)
        np.testing.assert_array_equal(
            threefry.random_bits(_key(jk), n, "cpu").numpy().astype(
                np.uint32), np.asarray(bits))
        idx = torch.from_numpy(np.random.RandomState(n).randint(0, n, 64))
        at = threefry.uniform_at(_key(jk), idx, n).numpy()
        np.testing.assert_array_equal(_bits(at), _bits(want[idx.numpy()]))


@pytest.mark.parametrize("n", [1, 7, 64 * 128, 1001])
def test_uniform_keys_is_per_key(n):
    """The multi-key grid (hoisted and per-shard draws) is each key's own
    draw, as jax's vmapped draw is."""
    with legacy():
        keys = [jax.random.fold_in(jax.random.PRNGKey(4), i)
                for i in range(5)]
        want = np.concatenate([np.asarray(jax.random.uniform(k, (n,)))
                               for k in keys])
        got = threefry.uniform_keys([_key(k) for k in keys], n, "cpu")
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("lo,hi,shape", [
    (1, 2**20, (4095,)), (1, 256, (256, 64)), (0, 16, (3,)), (0, 7, (101,)),
    (5, 70001, (999,)), (0, 2**31 - 1, (50,))])
def test_randint(seed, lo, hi, shape):
    with legacy():
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
        want = np.asarray(jax.random.randint(jk, shape, lo, hi))
        got = threefry.randint(_key(jk), shape, lo, hi, "cpu").numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shift_set", [0, 16])
@pytest.mark.parametrize("use_drop", [False, True])
def test_ring_plans_match_jax(use_drop, shift_set):
    """The natural plan (with the SHIFT_SET draw), the hoisted plans of a
    segment and the per-shard plan, stream by stream."""
    kw = dict(n=256, s=128, g=32, k_max=3, p_cnt=16, seed_rows=8,
              use_drop=use_drop, need_ctrl=True, need_burst=True)
    with legacy():
        keys = [jax.random.fold_in(jax.random.PRNGKey(9), t)
                for t in range(3)]
        want = [jax_rng_plan.hash_ring_rng(k, shift_set=shift_set, **kw)
                for k in keys]
        got = [hash_ring_rng(_key(keys[0]), device="cpu",
                             shift_set=shift_set, **kw)]
        got += hash_ring_rng_keys([_key(k) for k in keys], device="cpu",
                                  shift_set=shift_set, **kw)
        for g, w in zip(got, [want[0]] + want):
            for name in ("shift_draw", "thin_u", "ctrl_u", "burst_u",
                         "probe_u", "ack_u"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(g, name)).reshape(-1),
                    np.asarray(getattr(w, name)).reshape(-1), err_msg=name)
            for j, u in enumerate(g.gossip_u):
                np.testing.assert_array_equal(np.asarray(u),
                                              np.asarray(w.gossip_u[j]))
        skw = dict(n=256, n_local=32, s=128, g=32, k_max=3, p_cnt=16,
                   seed_rows=8, use_drop=use_drop, cold_join=True)
        got = sharded_ring_rng(_key(keys[0]), range(8), device="cpu", **skw)
        per = [jax_rng_plan.sharded_ring_rng(keys[0], me, **skw)
               for me in range(8)]
        for name in ("thin_u", "probe_u", "ack_u"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got, name)),
                np.concatenate([np.asarray(getattr(w, name)) for w in per]),
                err_msg=name)
        np.testing.assert_array_equal(np.asarray(got.shift_draw),
                                      np.asarray(per[0].shift_draw))


def test_the_switch_follows_jax_env_parsing(monkeypatch):
    """``JAX_THREEFRY_PARTITIONABLE`` is read as jax reads a boolean flag,
    True when unset; a fresh interpreter picks it up for both packages."""
    code = ("import jax; from distributed_membership_tpu_torch.ops "
            "import threefry; print(threefry.is_partitionable(), "
            "jax.config.jax_threefry_partitionable)")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_THREEFRY_PARTITIONABLE="off")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.stdout.split()[-2:] == ["False", "False"], out.stdout
    for value, want in (("0", False), ("n", False), ("Yes", True),
                        ("1", True), ("ON", True), ("false", False)):
        monkeypatch.setenv("DM_TEST_FLAG", value)
        assert threefry._bool_env("DM_TEST_FLAG", not want) is want
    monkeypatch.delenv("DM_TEST_FLAG")
    assert threefry._bool_env("DM_TEST_FLAG", True) is True
    monkeypatch.setenv("DM_TEST_FLAG", "maybe")
    with pytest.raises(ValueError, match="invalid truth value"):
        threefry._bool_env("DM_TEST_FLAG", True)


@pytest.mark.parametrize("conf", [
    _conf(drop=0.05, total=50),
    _conf(single=0, total=50, extra="EVENT_MODE: agg\n"),
    _conf(s=16, g=4, p=2, total=50, drop=0.05,
          extra="EVENT_MODE: agg\nFOLDED: 1\n"),
], ids=["natural_drops", "natural_multi_agg", "folded"])
def test_steps_match_jax_every_tick(conf):
    with legacy():
        run_both(conf)


def _params(conf: str):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JaxParams.from_text(conf), Params.from_text(conf)


@pytest.mark.parametrize("conf", [
    # the sharded ring step on eight shards, full events
    _conf(drop=0.05, total=50).replace(
        "BACKEND: tpu_hash", "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8"),
    # the scatter exchange (staggered joins)
    _conf(n=64, s=64, g=16, p=8, total=60, join="staggered", drop=0.05)
    .replace("EXCHANGE: ring", "EXCHANGE: scatter"),
    # hoisted plans in T-tick blocks
    _conf(drop=0.05, total=48, extra="CHECKPOINT_EVERY: 16\n"
          "RNG_MODE: hoisted\nMEGA_TICKS: 4\n"),
], ids=["sharded8", "scatter", "hoisted_mega"])
def test_runs_match_jax(conf):
    """Every tick's events and message counts, through the logs."""
    jp, pp = _params(conf)
    with legacy():
        want = jax_backend(jp.BACKEND)(jp, seed=3)
        got = get_backend(pp.BACKEND)(pp, seed=3, device="cpu")
    assert got.log.dbg_text() == want.log.dbg_text()
    np.testing.assert_array_equal(got.sent, want.sent)
    np.testing.assert_array_equal(got.recv, want.recv)
    assert " removed " in got.log.dbg_text()


def test_singlefailure_slo_reproduces_the_banked_distribution(
        testcases_dir):
    """The reference's singlefailure testcase (N=10, staggered joins) on
    the ring, seed 3, EVENT_MODE agg, TELEMETRY hist: under the legacy
    stream the port's detection latencies are exactly the banked
    REFERENCE_DISTRIBUTION, at CDF deviation 0."""
    p = Params.from_file(str(testcases_dir / "singlefailure.conf"))
    for key, value in (("BACKEND", "tpu_hash"), ("EXCHANGE", "ring"),
                       ("EVENT_MODE", "agg"), ("TELEMETRY", "hist")):
        setattr(p, key, value)
    with legacy():
        r = get_backend("tpu_hash")(p, seed=3, device="cpu")
    v = slo_verdict(r.extra["timeline"])
    assert v["observed"] == REFERENCE_DISTRIBUTION == {21: 4, 22: 4, 23: 1}
    assert v["max_cdf_deviation"] == 0.0
    assert v["passed"] is True
