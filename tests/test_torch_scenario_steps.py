"""Per-tick parity of the port's four ring steps with the JAX package's
under general scenarios (the scenario engine, scenario/compile.py).

Each case writes one schedule covering the event kinds (partition,
crash, restart, leave, link and one-way flakes, delay and drop windows),
starts both packages from one warm state (the JAX state's leaves carried
across by ``convert.state_from_numpy``) and steps them with the same
per-tick keys; after every tick each state leaf and each event output
must be equal (tolerance 0).  The JAX side runs jitted, with its fused
kernels off; the port runs its wrappers on CPU tensors (the plain
versions).  A mismatch names the first divergent tick, leaf and index
(``tests/test_torch_step.py``'s ``_first_mismatch``).
"""

import json
import random
import warnings

import numpy as np
import pytest

import jax
import torch

from distributed_membership_tpu.backends import tpu_hash as jax_hash
from distributed_membership_tpu.backends import tpu_hash_folded as jax_fold
from distributed_membership_tpu.backends import tpu_hash_sharded as jax_sh
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.observability.aggregates import merge_agg
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch.backends import tpu_hash
from distributed_membership_tpu_torch.backends import tpu_hash_sharded as sh
from distributed_membership_tpu_torch.backends.tpu_hash_folded import (
    make_folded_step, make_ring_sharded_folded_step)
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import (
    state_from_numpy, state_to_numpy)
from distributed_membership_tpu_torch.observability.aggregates import (
    init_fast_agg)
from distributed_membership_tpu_torch.runtime import failures

from test_torch_step import _first_mismatch, _jax_leaves

SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores (tests/test_torch_step.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mixed_events(n: int, cut: int):
    """Every event kind on N nodes: a partition at ``cut`` over (10, 30],
    a crash of 8 nodes at 5 (4 restart at 35), a leave at 12, an 11%
    link flake and a one-way blackhole, a 2% drop window over the flake
    (a pair whose combine differs between one fused multiply-add and two
    roundings: tests/test_torch_scenario.py) and a delay window."""
    h = n // 2
    return [
        {"kind": "partition", "start": 10, "stop": 30,
         "groups": [[0, cut], [cut, n]]},
        {"kind": "crash", "time": 5, "range": [20, 28]},
        {"kind": "restart", "time": 35, "range": [20, 24]},
        {"kind": "leave", "time": 12, "nodes": [n - 56]},
        {"kind": "link_flake", "start": 20, "stop": 50, "src": [0, h],
         "dst": [h, n], "drop_prob": 0.11},
        {"kind": "one_way_flake", "start": 40, "stop": 45, "src": [h, n],
         "dst": [0, n // 4]},
        {"kind": "drop_window", "start": 15, "stop": 40, "drop_prob": 0.02},
        {"kind": "delay_window", "start": 25, "stop": 33,
         "dst": [50, 90]}]


_RING = ("MAX_NNB: {n}\nSINGLE_FAILURE: 1\nVIEW_SIZE: {s}\nGOSSIP_LEN: {g}\n"
         "PROBES: {p}\nFANOUT: 3\nTFAIL: 16\nTREMOVE: 40\nTOTAL_TIME: 60\n"
         "JOIN_MODE: warm\nEXCHANGE: ring\nFUSED_RECEIVE: 0\n"
         "FUSED_GOSSIP: 0\nFUSED_PROBE: 0\n")
_NAT = _RING.format(n=256, s=128, g=32, p=16)
_FOLD = _RING.format(n=256, s=16, g=4, p=2) + "EVENT_MODE: agg\nFOLDED: 1\n"
_SHF = _RING.format(n=512, s=16, g=4, p=2) + "EVENT_MODE: agg\nFOLDED: 1\n"
_AGG = "EVENT_MODE: agg\nPROBE_IO: approx\n"
# case: (conf, step kind, partition cut)
CASES = {
    "natural_full": (_NAT + "BACKEND: tpu_hash\n", "natural", 100),
    "natural_agg": (_NAT + "BACKEND: tpu_hash\n" + _AGG
                    + "DROP_MSG: 1\nMSG_DROP_PROB: 0.05\nDROP_START: 30\n"
                    "DROP_STOP: 55\n", "natural", 100),
    "natural_cold": (_NAT.replace("JOIN_MODE: warm", "JOIN_MODE: staggered")
                     + "BACKEND: tpu_hash\n", "natural", 30),
    "sharded_d8_full": (_NAT + "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8\n",
                        "sharded", 100),
    "sharded_2x4_agg": (_NAT + "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 2x4\n"
                        + _AGG, "sharded", 100),
    "sharded_d1_agg": (_NAT + "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 1\n"
                       + _AGG,
                       "sharded", 100),
    "folded": (_FOLD + "BACKEND: tpu_hash\n", "folded", 100),
    "sharded_folded_d8": (_SHF + "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8\n",
                          "sharded_folded", 300),
}


def write_scenario(tmp_path, events, name="mixed") -> str:
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps({"name": name, "events": events}))
    return str(path)


def plans(conf: str):
    """Both packages' params and resolved plans (general path)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = JaxParams.from_text(conf)
        pp = Params.from_text(conf)
    jplan = jax_failures.resolve_plan(jp, random.Random(f"app:{SEED}"))
    pplan = failures.resolve_plan(pp, random.Random(f"app:{SEED}"))
    assert jplan.scenario is not None and pplan.scenario is not None
    assert (pplan.kind, pplan.failed_indices, pplan.fail_time) == (
        jplan.kind, jplan.failed_indices, jplan.fail_time)
    assert tuple(pplan.scenario.static) == tuple(jplan.scenario.static)
    return jp, pp, jplan, pplan


def _compare(t, pstate, jstate_leaves, pout, jout, port_leaves=None):
    got = port_leaves if port_leaves is not None else state_to_numpy(pstate)
    assert set(got) == set(jstate_leaves)
    for name in sorted(jstate_leaves):
        _first_mismatch(t, name, got[name], jstate_leaves[name])
    for name in pout._fields:
        _first_mismatch(t, f"events.{name}", getattr(pout, name), jout(name))


def run_single(jp, pp, jplan, pplan, folded: bool, ticks: int):
    collect = jp.resolved_event_mode() == "full"
    static = jplan.scenario.static
    jcfg = jax_hash.make_config(jp, collect,
                                fail_ids=jax_hash.plan_fail_ids(jplan),
                                scenario=static)
    pcfg = tpu_hash.make_config(pp, collect,
                                fail_ids=tpu_hash.plan_fail_ids(pplan),
                                device="cpu",
                                scenario=tpu_hash.plan_scenario(pplan))
    assert jcfg.folded == pcfg.folded == folded
    assert (pcfg.count_probe_io, pcfg.fast_agg) == (jcfg.count_probe_io,
                                                    jcfg.fast_agg)
    warm_key = jax_failures.make_run_key(jp, SEED ^ 0x5EED)
    if folded:
        jstep = jax.jit(jax_fold.make_folded_step(jcfg))
        jstate = jax_fold.init_state_warm_folded(jcfg, warm_key)
        pstep = make_folded_step(pcfg)
    else:
        jstep = jax.jit(jax_hash.make_step(jcfg))
        jstate = (jax_hash.init_state_warm(jcfg, warm_key)
                  if jp.JOIN_MODE == "warm" else jax_hash.init_state(jcfg))
        pstep = tpu_hash.make_step(pcfg)
    inputs = jax_failures.plan_tensors(jp, jplan, SEED, ticks)
    extra = (jplan.scenario.tensors(),)
    pstate = state_from_numpy(_jax_leaves(jstate), device="cpu")
    pplan_t = failures.plan_tensors(pp, pplan, SEED, ticks, "cpu")
    for t in range(ticks):
        jstate, jout = jstep(
            jstate, (inputs[0][t], inputs[1][t]) + tuple(inputs[2:]) + extra)
        pstate, pout = pstep(pstate, t, pplan_t.tick_key(t), pplan_t)
        _compare(t, pstate, _jax_leaves(jstate), pout,
                 lambda f: getattr(jout, f))
    return pstate


def run_sharded(jp, pp, jplan, pplan, folded: bool, ticks: int):
    collect = jp.resolved_event_mode() == "full"
    jmesh = jax_sh.resolve_mesh(jp)
    mesh = sh.resolve_mesh(pp, "cpu")
    assert mesh.size == jmesh.size
    n_local = pp.EN_GPSZ // mesh.size
    fail_ids = tuple(jplan.failed_indices)
    jcfg = jax_sh.sharded_config(jp, collect, fail_ids,
                                 jplan.scenario.static, n_local)
    pcfg = sh.sharded_config(pp, collect, fail_ids, n_local, device="cpu",
                             scenario=tpu_hash.plan_scenario(pplan))
    assert jcfg.folded == pcfg.folded == folded
    init = jax_sh._get_init_runner(jcfg, n_local, jmesh, True)
    seg = jax_sh._get_segment_runner(jcfg, n_local, jmesh, True)
    inputs = jax_failures.plan_tensors(jp, jplan, SEED, ticks)
    extra = (jplan.scenario.tensors(),)
    jstate = init(jax_failures.make_run_key(jp, SEED ^ 0x5EED))
    pstate = state_from_numpy(_jax_leaves(jstate), device="cpu")
    if pcfg.fast_agg:
        pstate = pstate._replace(agg=init_fast_agg(
            len(pcfg.fail_ids), pcfg.n, "cpu", shards=mesh.size))
    pplan_t = failures.plan_tensors(pp, pplan, SEED, ticks, "cpu")
    pstep = (make_ring_sharded_folded_step(pcfg, mesh) if folded
             else sh.make_ring_sharded_step(pcfg, mesh))
    acc = None                   # the JAX agg, summed over one-tick segments
    for t in range(ticks):
        jstate, jev = seg(jstate, inputs[0][t:t + 1], inputs[1][t:t + 1],
                          *inputs[2:], *extra)
        want = _jax_leaves(jstate)
        if not collect:
            tick_agg = jax.tree.map(np.asarray, jstate.agg)
            acc = tick_agg if acc is None else merge_agg(acc, tick_agg)
            want.update({f"agg.{f}": np.asarray(x)
                         for f, x in acc._asdict().items()})
        pstate, pout = pstep(pstate, t, pplan_t.tick_key(t), pplan_t)
        got = state_to_numpy(pstate._replace(
            agg=sh.reduce_fast_agg(pstate.agg, mesh)) if pcfg.fast_agg
            else pstate)
        _compare(t, pstate, want, pout,
                 lambda f: np.asarray(getattr(jev, f))[0], got)
    return pstate


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax_every_tick_under_scenario(tmp_path, case):
    conf, kind, cut = CASES[case]
    n = int(conf.split("MAX_NNB: ")[1].split("\n")[0])
    path = write_scenario(tmp_path, mixed_events(n, cut))
    jp, pp, jplan, pplan = plans(conf + f"SCENARIO: {path}\n")
    ticks = 60
    if kind in ("natural", "folded"):
        final = run_single(jp, pp, jplan, pplan, kind == "folded", ticks)
    else:
        final = run_sharded(jp, pp, jplan, pplan, kind == "sharded_folded",
                            ticks)
    # The schedule bit: the crash and leave stayed, the restart came back.
    failed = final.failed.numpy()
    assert failed[24:28].all() and failed[n - 56]
    assert not failed[20:24].any()
