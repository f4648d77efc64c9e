"""Cold joins (JOIN_MODE staggered and batch) on the port's ring steps
against the JAX package, at every tick and in every state leaf, with
tolerance 0:

* the single-device ring step on the grader's three testcases with
  ``EXCHANGE: ring`` (N=10, S=10, 700 ticks: the CPU only, as the natural
  CUDA kernels take S % 128 == 0), and under ``JOIN_MODE: batch`` (every
  node starts at tick 0 and the introducer seeds them all) at N=64, S=16
  and at N=256, S=128 with 5% drops;
* the sharded ring step on the same testcases with ``MESH_SHAPE: 5``,
  against the JAX step on a five-device mesh (the JAX package's own
  choice for N=10).

The JAX steps run with their fused kernels off; the port's wrappers run
their plain versions on CPU tensors.
"""

import random
import warnings

import numpy as np
import pytest

import jax
import torch

from distributed_membership_tpu.backends import tpu_hash as jax_hash
from distributed_membership_tpu.backends import tpu_hash_sharded as jax_sh
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch.backends import tpu_hash
from distributed_membership_tpu_torch.backends import tpu_hash_sharded as sh
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import state_to_numpy
from distributed_membership_tpu_torch.runtime import failures

SEED = 3
TESTCASES = ["singlefailure", "multifailure", "msgdropsinglefailure"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores, and torch's OpenMP workers would then wait on each
    other at every op of the tick loop."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _testcase(name: str, extra: str) -> str:
    from conftest import REPO
    return (REPO / "testcases" / f"{name}.conf").read_text() + "\n" + extra


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


def _compare(t, jstate, pstate, jout, pout, jout_row=None):
    want, got = _jax_leaves(jstate), state_to_numpy(pstate)
    assert set(got) == set(want)
    for name in sorted(want):
        _first_mismatch(t, name, got[name], want[name])
    for name in pout._fields:
        w = np.asarray(getattr(jout, name))
        _first_mismatch(t, f"events.{name}", getattr(pout, name),
                        w if jout_row is None else w[jout_row])


def _plans(conf: str):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = JaxParams.from_text(conf)
        pp = Params.from_text(conf)
    jplan = jax_failures.make_plan(jp, random.Random(f"app:{SEED}"))
    pplan = failures.make_plan(pp, random.Random(f"app:{SEED}"))
    assert (pplan.failed_indices, pplan.fail_time) == (
        jplan.failed_indices, jplan.fail_time)
    return jp, pp, jplan, pplan


def run_ring(conf: str, ticks: int):
    """The single-device ring step of both packages from the cold state;
    returns ``(removal events, join events)``."""
    jp, pp, jplan, pplan = _plans(conf)
    fail_ids = jax_hash.plan_fail_ids(jplan)
    jcfg = jax_hash.make_config(jp, True, fail_ids=fail_ids)
    pcfg = tpu_hash.make_config(pp, True, fail_ids=fail_ids, device="cpu")
    assert jcfg.exchange == pcfg.exchange == "ring" and pcfg.cold_join
    assert jcfg.seed_cap == pcfg.seed_cap
    assert not (jcfg.fused_receive or jcfg.fused_gossip or jcfg.fused_probe)
    jstep = jax.jit(jax_hash.make_step(jcfg))
    inputs = jax_failures.plan_tensors(jp, jplan, SEED, ticks)
    step, init = tpu_hash.step_and_init(pcfg)
    jstate = jax_hash.init_state(jcfg)
    pstate = init(pcfg, failures.make_run_key(pp, SEED ^ 0x5EED), "cpu")
    for name, want in _jax_leaves(jstate).items():
        _first_mismatch(-1, name, state_to_numpy(pstate)[name], want)
    pplan_t = failures.plan_tensors(pp, pplan, SEED, ticks, "cpu")
    removals = joins = 0
    for t in range(ticks):
        jstate, jout = jstep(jstate, (inputs[0][t], inputs[1][t])
                             + tuple(inputs[2:]))
        pstate, pout = step(pstate, t, pplan_t.tick_key(t), pplan_t)
        _compare(t, jstate, pstate, jout, pout)
        removals += int((np.asarray(jout.rm_ids) >= 0).sum())
        joins += int((np.asarray(jout.join_ids) >= 0).sum())
    return removals, joins


@pytest.mark.parametrize("scenario", TESTCASES)
def test_ring_cold_join_testcases_every_tick(scenario):
    removals, joins = run_ring(_testcase(scenario, "BACKEND: tpu_hash\n"
                                         "EXCHANGE: ring\n"), 700)
    assert removals >= 9 and joins >= 90


_BATCH = ("MAX_NNB: {n}\nSINGLE_FAILURE: 1\nDROP_MSG: {drop}\n"
          "MSG_DROP_PROB: 0.05\nDROP_START: 0\nDROP_STOP: 60\n"
          "VIEW_SIZE: {s}\nGOSSIP_LEN: {g}\nPROBES: {p}\nFANOUT: 3\n"
          "TFAIL: 8\nTREMOVE: {tremove}\nTOTAL_TIME: 60\nFAIL_TIME: 4\n"
          "JOIN_MODE: batch\nEXCHANGE: ring\nEVENT_MODE: full\n"
          "BACKEND: tpu_hash\n")


@pytest.mark.parametrize("n,s,g,p,tremove,drop", [(64, 16, 4, 2, 32, 0),
                                                  (256, 128, 32, 16, 40, 1)],
                         ids=["n64_s16", "n256_s128_drops"])
def test_ring_batch_join_every_tick(n, s, g, p, tremove, drop):
    """Every node starts at tick 0; the introducer answers all N-1
    JOINREQs in one burst (seed_cap = N).  At N=64, S=16 no removal
    happens in these 60 ticks (the batch overlay at N >> S holds on to
    the introducer's view); at S = N/2 the failed node is removed."""
    conf = _BATCH.format(n=n, s=s, g=g, p=p, tremove=tremove, drop=drop)
    _, pp, _, _ = _plans(conf)
    assert tpu_hash.make_config(pp, device="cpu").seed_cap == n
    removals, joins = run_ring(conf, 60)
    assert joins >= n and (removals > 0) == (s == 128)


@pytest.mark.parametrize("scenario", TESTCASES)
def test_sharded_cold_join_testcases_every_tick(scenario):
    """The sharded ring step with cold joins on five shards of two rows,
    against the JAX step on a five-device mesh, for all 700 ticks."""
    conf = _testcase(scenario, "BACKEND: tpu_hash_sharded\nEXCHANGE: ring\n"
                               "MESH_SHAPE: 5\n")
    ticks = 700
    jp, pp, jplan, pplan = _plans(conf)
    jmesh = jax_sh.resolve_mesh(jp)
    mesh = sh.resolve_mesh(pp, "cpu")
    assert mesh.size == jmesh.size == 5
    fail_ids = tuple(jplan.failed_indices)
    jcfg = jax_sh.sharded_config(jp, True, fail_ids, None, 2)
    pcfg = sh.sharded_config(pp, True, fail_ids, 2, device="cpu")
    assert pcfg.cold_join and jcfg.seed_cap == pcfg.seed_cap
    init = jax_sh._get_init_runner(jcfg, 2, jmesh, False)
    seg = jax_sh._get_segment_runner(jcfg, 2, jmesh, False)
    inputs = jax_failures.plan_tensors(jp, jplan, SEED, ticks)
    jstate = init(jax_failures.make_run_key(jp, SEED ^ 0x5EED))
    pstate = sh.init_local_state(pcfg, mesh)
    for name, want in _jax_leaves(jstate).items():
        _first_mismatch(-1, name, state_to_numpy(pstate)[name], want)
    pplan_t = failures.plan_tensors(pp, pplan, SEED, ticks, "cpu")
    pstep = sh.make_ring_sharded_step(pcfg, mesh)
    removals = 0
    for t in range(ticks):
        jstate, jev = seg(jstate, inputs[0][t:t + 1], inputs[1][t:t + 1],
                          *inputs[2:])
        pstate, pout = pstep(pstate, t, pplan_t.tick_key(t), pplan_t)
        _compare(t, jstate, pstate, jev, pout, jout_row=0)
        removals += int((np.asarray(jev.rm_ids) >= 0).sum())
    assert removals >= 9
