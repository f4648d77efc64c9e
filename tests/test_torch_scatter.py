"""The port's scatter exchange and its pieces against the JAX package.

Compared with tolerance 0, on inputs made from a numpy seed:

* the u32 hashing of the probe mailbox (``mix32``, ``hash_slot`` on both
  of its branches), target sampling (``sample_k_indices`` with ties and
  rows where nothing is eligible), ``_scatter_msgs`` and the start ticks
  of ``plan_tensors`` under every join mode;
* the scatter step at every tick and in every state leaf: the grader's
  three testcases (N=10, staggered joins) for all 700 ticks, and warm
  runs with probes and drops at N=256 and at N=2048, where the probe
  mailbox is narrower than N (hashed slots, two probe copies).

The JAX step runs with its fused kernels off (the scatter step has none);
the port's runs on CPU tensors.  A mismatch names the first divergent
tick, leaf and index.
"""

import random
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from distributed_membership_tpu.backends import tpu_hash as jax_hash
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.ops import sampling as jax_sampling
from distributed_membership_tpu.ops import view_merge as jax_vm
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch.backends import tpu_hash
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import state_to_numpy
from distributed_membership_tpu_torch.ops import sampling, view_merge
from distributed_membership_tpu_torch.runtime import failures

SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores, and torch's OpenMP workers would then wait on each
    other at every op of the tick loop."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _u32(rng, shape, occ=1.0):
    val = rng.integers(1, 2**32, size=shape, dtype=np.int64)
    return np.where(rng.random(shape) < occ, val, 0).astype(np.uint32)


# ---------------------------------------------------------------------------
# Units

@pytest.mark.parametrize("qsz,n_pad", [(10, 10), (1024, 1000), (512, 2048),
                                       (128, 1 << 20)],
                         ids=["injective_eq", "injective_gt", "mixed_2k",
                              "mixed_1m"])
def test_hash_slot_matches_jax(qsz, n_pad):
    rng = np.random.default_rng(11)
    ids = rng.integers(0, n_pad, size=4096).astype(np.int32)
    for salt in (0, 1, 699, 699 + 0x2545F49, 37 + 0x2545F49):
        want = np.asarray(jax_vm.hash_slot(jnp.asarray(ids), jnp.int32(salt),
                                           qsz, n_pad))
        got = view_merge.hash_slot(torch.from_numpy(ids).to(torch.int64),
                                   salt, qsz, n_pad)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64),
                                      err_msg=f"salt={salt}")
        assert ((got >= 0) & (got < qsz)).all()


def test_mix32_matches_jax():
    x = _u32(np.random.default_rng(12), (8192,))
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(jax_vm.mix32(jnp.asarray(x)))
    got = view_merge.mix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("m,k_max", [(10, 5), (32, 3), (128, 3)])
def test_sample_k_indices_matches_jax(m, k_max):
    """Scores on a coarse grid tie often; every ineligible slot ties at
    -2.0; some rows have nothing eligible; k ranges over 0..m."""
    rng = np.random.default_rng(m)
    n = 64
    scores = (rng.integers(0, 8, size=(n, m)) / 8.0).astype(np.float32)
    eligible = rng.random((n, m)) < 0.4
    eligible[:6] = False
    eligible[6:9] = True
    k = rng.integers(0, m + 1, size=n).astype(np.int32)
    w_idx, w_valid = jax_sampling.sample_k_indices(
        None, jnp.asarray(eligible), jnp.asarray(k), k_max,
        scores=jnp.asarray(scores))
    g_idx, g_valid = sampling.sample_k_indices(
        torch.from_numpy(scores), torch.from_numpy(eligible),
        torch.from_numpy(k), k_max)
    np.testing.assert_array_equal(g_idx.numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(g_valid.numpy(), np.asarray(w_valid))
    assert not g_valid[:6].any()


def _cfgs(conf: str, collect: bool = True):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = JaxParams.from_text(conf)
        pp = Params.from_text(conf)
    return (jp, pp, jax_hash.make_config(jp, collect),
            tpu_hash.make_config(pp, collect, device="cpu"))


def test_scatter_msgs_matches_jax():
    _, _, jcfg, pcfg = _cfgs(_WARM.format(n=300, s=32, g=8, p=4, tremove=40,
                                          total=10, fail=5, drop=0))
    rng = np.random.default_rng(13)
    n, s = 300, 32
    mail = _u32(rng, (n, s), occ=0.3)
    shape = (n, 4, 8)
    tgt = rng.integers(0, n, size=shape).astype(np.int32)
    ids = rng.integers(0, n, size=shape).astype(np.int32)
    hbs = rng.integers(0, 5000, size=shape).astype(np.int32)
    valid = rng.random(shape) < 0.7
    want = np.asarray(jax_hash._scatter_msgs(
        jcfg, jnp.asarray(mail), jnp.asarray(tgt), jnp.asarray(ids),
        jnp.asarray(hbs), jnp.asarray(valid)))
    got = tpu_hash._scatter_msgs(
        pcfg, torch.from_numpy(mail.view(np.int32)),
        torch.from_numpy(tgt), torch.from_numpy(ids),
        torch.from_numpy(hbs), torch.from_numpy(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("mode", ["staggered", "batch", "warm"])
def test_plan_start_ticks_match_jax(mode):
    conf = (_WARM.format(n=64, s=16, g=4, p=2, tremove=40, total=30, fail=5,
                         drop=0).replace("JOIN_MODE: warm",
                                         f"JOIN_MODE: {mode}"))
    jp, pp, _, _ = _cfgs(conf)
    jplan = jax_failures.make_plan(jp, random.Random("app:1"))
    pplan = failures.make_plan(pp, random.Random("app:1"))
    want = np.asarray(jax_failures.plan_tensors(jp, jplan, 1, 30)[2])
    got = failures.plan_tensors(pp, pplan, 1, 30, "cpu").start_ticks
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The scatter step at every tick

_WARM = ("MAX_NNB: {n}\nSINGLE_FAILURE: 1\nDROP_MSG: {drop}\n"
         "MSG_DROP_PROB: 0.05\nDROP_START: 5\nDROP_STOP: 100\n"
         "VIEW_SIZE: {s}\nGOSSIP_LEN: {g}\nPROBES: {p}\nFANOUT: 3\n"
         "TFAIL: 10\nTREMOVE: {tremove}\nTOTAL_TIME: {total}\n"
         "FAIL_TIME: {fail}\nJOIN_MODE: warm\nEXCHANGE: scatter\n"
         "EVENT_MODE: full\nBACKEND: tpu_hash\n")


def _testcase(name: str) -> str:
    from conftest import REPO
    return ((REPO / "testcases" / f"{name}.conf").read_text()
            + "\nBACKEND: tpu_hash\n")


def _jax_leaves(state) -> dict:
    out = {}
    for name, leaf in state._asdict().items():
        if name == "agg":
            for field, x in leaf._asdict().items():
                out[f"agg.{field}"] = np.asarray(x)
        else:
            out[name] = np.asarray(leaf)
    return out


def _first_mismatch(t, name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (
        f"tick {t}: {name} shape {got.shape} != {want.shape}")
    if got.dtype != want.dtype and got.dtype.itemsize == want.dtype.itemsize:
        got = got.view(want.dtype)
    bad = np.argwhere(got != want)
    if bad.size:
        i = tuple(bad[0])
        pytest.fail(f"tick {t}: first divergence in {name} at index {i}: "
                    f"port {got[i]} != jax {want[i]} "
                    f"({len(bad)} elements differ)")


def run_both(conf: str, ticks: int, warm: bool):
    """Step both implementations ``ticks`` times from one start state,
    comparing every leaf and event output after every tick; returns the
    count of removal events."""
    jp, pp, _, _ = _cfgs(conf)
    jplan = jax_failures.make_plan(jp, random.Random(f"app:{SEED}"))
    pplan = failures.make_plan(pp, random.Random(f"app:{SEED}"))
    fail_ids = jax_hash.plan_fail_ids(jplan)
    jcfg = jax_hash.make_config(jp, True, fail_ids=fail_ids)
    pcfg = tpu_hash.make_config(pp, True, fail_ids=fail_ids, device="cpu")
    assert (jcfg.exchange, jcfg.qp, jcfg.seed_cap) == (
        pcfg.exchange, pcfg.qp, pcfg.seed_cap)
    assert not (jcfg.fused_receive or jcfg.fused_gossip or jcfg.fused_probe)
    jstep = jax.jit(jax_hash.make_step(jcfg))
    inputs = jax_failures.plan_tensors(jp, jplan, SEED, ticks)
    wkey = SEED ^ 0x5EED
    if warm:
        jstate = jax_hash.init_state_warm(
            jcfg, jax_failures.make_run_key(jp, wkey))
        pstate = tpu_hash.init_state_warm(
            pcfg, failures.make_run_key(pp, wkey), "cpu")
    else:
        jstate = jax_hash.init_state(jcfg)
        pstate = tpu_hash.init_state_cold(
            pcfg, failures.make_run_key(pp, wkey), "cpu")
    want, got = _jax_leaves(jstate), state_to_numpy(pstate)
    assert set(got) == set(want)
    for name in want:
        _first_mismatch(-1, name, got[name], want[name])
    pplan_t = failures.plan_tensors(pp, pplan, SEED, ticks, "cpu")
    pstep = tpu_hash.make_step(pcfg)
    removals = 0
    for t in range(ticks):
        jstate, jout = jstep(jstate, (inputs[0][t], inputs[1][t])
                             + tuple(inputs[2:]))
        pstate, pout = pstep(pstate, t, pplan_t.tick_key(t), pplan_t)
        want, got = _jax_leaves(jstate), state_to_numpy(pstate)
        for name in sorted(want):
            _first_mismatch(t, name, got[name], want[name])
        for name in pout._fields:
            _first_mismatch(t, f"events.{name}", getattr(pout, name),
                            getattr(jout, name))
        removals += int((np.asarray(jout.rm_ids) >= 0).sum())
    return removals


@pytest.mark.parametrize("scenario", ["singlefailure", "multifailure",
                                      "msgdropsinglefailure"])
def test_scatter_step_testcases_every_tick(scenario):
    """The grader's testcases as they are: N=10, staggered joins, EXCHANGE
    auto (scatter), 700 ticks."""
    conf = _testcase(scenario)
    assert Params.from_text(conf).resolved_exchange() == "scatter"
    assert run_both(conf, 700, warm=False) >= 9


@pytest.mark.parametrize("n,s,g,p,tremove,ticks",
                         [(256, 32, 8, 8, 40, 90),
                          (2048, 128, 32, 16, 32, 30)],
                         ids=["n256", "n2048_hashed_pmail"])
def test_scatter_step_warm_probes_drops_every_tick(n, s, g, p, tremove,
                                                   ticks):
    """Warm joins with probes and 5% drops; at N=2048 the probe mailbox
    has Qp = 512 < N slots, so the mixed hash and both probe copies run
    (30 ticks, before the failed node's removal: the N=256 case holds
    the removals)."""
    conf = _WARM.format(n=n, s=s, g=g, p=p, tremove=tremove, total=ticks,
                        fail=2, drop=1)
    _, _, _, cfg = _cfgs(conf)
    assert (cfg.qp < n) == (n > 1024)
    assert (run_both(conf, ticks, warm=True) > 0) == (n == 256)
