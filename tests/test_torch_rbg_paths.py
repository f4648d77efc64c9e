"""The ring steps under ``PRNG_IMPL: rbg|unsafe_rbg``, per tick: the port
against the JAX package, tolerance 0.

One start state, the same keys, and every leaf and event output equal
after each tick: the natural ring step under ``RNG_MODE`` batched and
scattered (which draw other bits under rbg), the folded step, the
natural step on the legacy threefry stream, and the sharded folded step
on eight shards.  Whole runs, by their logs, are in
``test_torch_rbg_runs.py``.
"""

import random
import warnings

import numpy as np
import pytest

import jax
import torch

from distributed_membership_tpu.backends import tpu_hash_sharded as jax_sh
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.observability.aggregates import merge_agg
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch.backends import (
    tpu_hash_sharded as sh)
from distributed_membership_tpu_torch.backends.tpu_hash_folded import (
    make_ring_sharded_folded_step)
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import state_from_numpy
from distributed_membership_tpu_torch.observability.aggregates import (
    init_fast_agg)
from distributed_membership_tpu_torch.runtime import failures

from test_torch_legacy_stream import legacy
from test_torch_ring_options import _conf, run_both
from test_torch_sharded_folded import (
    _BASE as FOLDED_SHARDED, _DROPS, _first_mismatch, _jax_leaves,
    _port_leaves)

IMPLS = ["rbg", "unsafe_rbg"]
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _impl(conf: str, impl: str) -> str:
    return conf + f"PRNG_IMPL: {impl}\n"


def _params(conf: str):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JaxParams.from_text(conf), Params.from_text(conf)


STEP_CASES = {
    "natural_batched": _conf(drop=0.05, total=40),
    "natural_scattered": _conf(drop=0.05, total=40,
                               extra="RNG_MODE: scattered\n"),
    "folded": _conf(s=16, g=4, p=2, total=50, drop=0.05,
                    extra="EVENT_MODE: agg\nFOLDED: 1\n"),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("impl", IMPLS)
def test_steps_match_jax_every_tick(impl, case):
    pcfg, pstate = run_both(_impl(STEP_CASES[case], impl))
    if not pcfg.collect_events:
        assert int(pstate.agg.det_count.sum()) > 0


@pytest.mark.parametrize("impl", IMPLS)
def test_legacy_stream_step_matches_jax(impl):
    """JAX_THREEFRY_PARTITIONABLE=0: rbg's key splits follow the legacy
    threefry split; unsafe_rbg's do not use threefry at all."""
    with legacy():
        run_both(_impl(_conf(drop=0.05, total=30), impl))


@pytest.mark.parametrize("impl", IMPLS)
def test_sharded_folded_step_matches_jax_every_tick(impl):
    """Eight folded shards with drops: each shard's plan from its own
    keys (shard_map is no vmap), grouped within the shard."""
    conf = _impl(FOLDED_SHARDED.format(mesh=8) + _DROPS, impl)
    jp, pp = _params(conf + "FUSED_RECEIVE: 0\nFUSED_GOSSIP: 0\n"
                     "FUSED_PROBE: 0\n")[0], Params.from_text(conf)
    jplan = jax_failures.make_plan(jp, random.Random(f"app:{SEED}"))
    pplan = failures.make_plan(pp, random.Random(f"app:{SEED}"))
    jmesh, mesh = jax_sh.resolve_mesh(jp), sh.resolve_mesh(pp, "cpu")
    n_local, ticks = pp.EN_GPSZ // 8, 60
    fail_ids = tuple(jplan.failed_indices)
    jcfg = jax_sh.sharded_config(jp, False, fail_ids, None, n_local)
    pcfg = sh.sharded_config(pp, False, fail_ids, n_local, device="cpu")
    assert jcfg.folded and pcfg.folded
    init = jax_sh._get_init_runner(jcfg, n_local, jmesh, True)
    seg = jax_sh._get_segment_runner(jcfg, n_local, jmesh, True)
    inputs = jax_failures.plan_tensors(jp, jplan, SEED, ticks)
    jstate = init(jax_failures.make_run_key(jp, SEED ^ 0x5EED))
    pstate = state_from_numpy(_jax_leaves(jstate), device="cpu")
    pstate = pstate._replace(agg=init_fast_agg(
        len(pcfg.fail_ids), pcfg.n, "cpu", shards=mesh.size))
    plan_t = failures.plan_tensors(pp, pplan, SEED, ticks, "cpu")
    pstep = make_ring_sharded_folded_step(pcfg, mesh)
    acc = None
    for t in range(ticks):
        jstate, jev = seg(jstate, inputs[0][t:t + 1], inputs[1][t:t + 1],
                          *inputs[2:])
        tick_agg = jax.tree.map(np.asarray, jstate.agg)
        acc = tick_agg if acc is None else merge_agg(acc, tick_agg)
        want = _jax_leaves(jstate)
        want.update({f"agg.{f}": np.asarray(x)
                     for f, x in acc._asdict().items()})
        pstate, pout = pstep(pstate, t, plan_t.tick_key(t), plan_t)
        got = _port_leaves(pstate, mesh)
        for name in sorted(want):
            _first_mismatch(t, name, got[name], want[name])
        for name in pout._fields:
            _first_mismatch(t, f"events.{name}", getattr(pout, name),
                            np.asarray(getattr(jev, name))[0])
    assert int(acc.det_count.sum()) > 0
