"""Per-tick parity of the port's ring step with the JAX package's.

Both implementations start from one warm state (the JAX state's leaves
carried into the port by ``convert.state_from_numpy``) and run the same
ticks with the same per-tick keys; after every tick each state leaf and
each event output must be equal.  The JAX side runs with the fused
kernels off (its own tests pin fused == unfused); the port runs its
wrappers on CPU tensors, i.e. the plain versions.  A mismatch names the
first divergent tick, leaf and index.
"""

import random
import warnings

import numpy as np
import pytest

import jax
import torch

from distributed_membership_tpu.backends import tpu_hash as jax_hash
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch.backends import tpu_hash
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import (
    state_from_numpy, state_to_numpy)
from distributed_membership_tpu_torch.runtime import failures

SEED = 3
TICKS = 60
_BASE = ("MAX_NNB: 256\nSINGLE_FAILURE: 1\nVIEW_SIZE: 128\nGOSSIP_LEN: 32\n"
         "PROBES: 16\nFANOUT: 3\nTFAIL: 16\nTREMOVE: {tremove}\n"
         "TOTAL_TIME: 60\nFAIL_TIME: {fail_time}\nJOIN_MODE: warm\n"
         "EXCHANGE: ring\nBACKEND: tpu_hash\nFUSED_RECEIVE: 0\n"
         "FUSED_GOSSIP: 0\nFUSED_PROBE: 0\n")
CASES = {
    # drop-free, full event mode
    "lossless": _BASE.format(tremove=40, fail_time=8)
    + "DROP_MSG: 0\nMSG_DROP_PROB: 0\n",
    # 5% drops from tick 10 to 50: every coin stream and the masks form
    "drops": _BASE.format(tremove=40, fail_time=8)
    + "DROP_MSG: 1\nMSG_DROP_PROB: 0.05\nDROP_START: 10\nDROP_STOP: 50\n",
    # the 1M path's branches at small N: on-device aggregates with the
    # failed id's detections inside the run, probe counters attributed to
    # the prober's row (PROBE_IO approx, the auto choice above 2^17 nodes)
    "agg_approx": _BASE.format(tremove=32, fail_time=8)
    + "DROP_MSG: 1\nMSG_DROP_PROB: 0.05\nDROP_START: 0\nDROP_STOP: 60\n"
    "EVENT_MODE: agg\nPROBE_IO: approx\n",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores, and torch's OpenMP workers would then wait on each
    other at every op of the tick loop."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    assert got.shape == want.shape, f"tick {t}: {name} shape"
    if got.dtype != want.dtype and got.dtype.itemsize == want.dtype.itemsize:
        got = got.view(want.dtype)
    bad = np.argwhere(got != want)
    if bad.size:
        i = tuple(bad[0])
        pytest.fail(f"tick {t}: first divergence in {name} at index {i}: "
                    f"port {got[i]} != jax {want[i]} "
                    f"({len(bad)} elements differ)")


def _setup(conf: str):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = JaxParams.from_text(conf)
        pp = Params.from_text(conf)
    collect = jp.resolved_event_mode() == "full"
    jplan = jax_failures.make_plan(jp, random.Random(f"app:{SEED}"))
    pplan = failures.make_plan(pp, random.Random(f"app:{SEED}"))
    assert (pplan.failed_indices, pplan.fail_time) == (
        jplan.failed_indices, jplan.fail_time)
    jcfg = jax_hash.make_config(jp, collect,
                                fail_ids=jax_hash.plan_fail_ids(jplan))
    pcfg = tpu_hash.make_config(pp, collect,
                                fail_ids=tpu_hash.plan_fail_ids(pplan),
                                device="cpu")
    assert pcfg.count_probe_io == jcfg.count_probe_io
    assert pcfg.fast_agg == jcfg.fast_agg
    return jp, pp, jplan, pplan, jcfg, pcfg


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax_every_tick(case):
    jp, pp, jplan, pplan, jcfg, pcfg = _setup(CASES[case])
    jstep = jax.jit(jax_hash.make_step(jcfg))
    inputs = jax_failures.plan_tensors(jp, jplan, SEED, TICKS)
    ticks, keys = inputs[0], inputs[1]
    jstate = jax_hash.init_state_warm(
        jcfg, jax_failures.make_run_key(jp, SEED ^ 0x5EED))
    # One start state for both, carried across by convert.py.
    pstate = state_from_numpy(_jax_leaves(jstate), device="cpu")
    pplan_t = failures.plan_tensors(pp, pplan, SEED, TICKS, "cpu")
    pstep = tpu_hash.make_step(pcfg)

    removals = 0
    for t in range(TICKS):
        jstate, jout = jstep(jstate, (ticks[t], keys[t]) + tuple(inputs[2:]))
        pstate, pout = pstep(pstate, t, pplan_t.tick_key(t), pplan_t)
        want = _jax_leaves(jstate)
        got = state_to_numpy(pstate)
        assert set(got) == set(want)
        for name in sorted(want):
            _first_mismatch(t, name, got[name], want[name])
        for name in pout._fields:
            _first_mismatch(t, f"events.{name}", getattr(pout, name),
                            getattr(jout, name))
        removals += int(np.asarray(jout.rm_ids >= 0).sum()
                        if np.ndim(jout.rm_ids) else jout.rm_ids)
    # The run exercised the failure path: someone removed someone.
    assert removals > 0
    if not pcfg.collect_events:
        assert int(pstate.agg.det_count.sum()) > 0


def test_warm_init_matches_jax():
    """The port's own warm start equals the JAX one (the neighbour
    scatter keeps unsigned max order and reserves the self slot)."""
    jp, pp, _, _, jcfg, pcfg = _setup(CASES["drops"])
    jstate = jax_hash.init_state_warm(
        jcfg, jax_failures.make_run_key(jp, SEED ^ 0x5EED))
    pstate = tpu_hash.init_state_warm(
        pcfg, failures.make_run_key(pp, SEED ^ 0x5EED), "cpu")
    want, got = _jax_leaves(jstate), state_to_numpy(pstate)
    assert set(got) == set(want)
    for name in want:
        _first_mismatch(-1, name, got[name], want[name])


def test_convert_round_trip():
    _, pp, _, _, _, pcfg = _setup(CASES["agg_approx"])
    st = tpu_hash.init_state_warm(
        pcfg, failures.make_run_key(pp, 11), "cpu")
    leaves = state_to_numpy(st)
    assert leaves["view"].dtype == np.uint32
    assert leaves["view"].max() > 0
    back = state_from_numpy(leaves, device="cpu")
    for name, leaf in back._asdict().items():
        if name == "agg":
            for a, b in zip(leaf, st.agg):
                assert torch.equal(a, b)
        else:
            assert torch.equal(leaf, getattr(st, name)), name
    # Copies, not views: the dict does not alias the state.
    leaves["view"][:] = 0
    assert back.view.any()
