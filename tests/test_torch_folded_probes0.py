"""The folded layout with ``PROBES: 0`` (the ``Params`` default) against
the JAX package's, at tolerance 0.

The folded step then runs no probe traversal (no K7, no ack gather), its
probe state keeps the JAX ``(1, 1)`` placeholders, and FastAgg sums the
removal plane.  Held against the JAX folded step per tick, single-chip
and on four shards, and by the detection summary on the conf where the
JAX package gives 9 detections and 11,005 false removals (N=512, S=16,
G=4, TREMOVE 32, seed 5).
"""

import random
import warnings

import jax
import numpy as np
import pytest
import torch

from distributed_membership_tpu.backends import tpu_hash as jax_hash
from distributed_membership_tpu.backends import tpu_hash_folded as jax_fold
from distributed_membership_tpu.backends import tpu_hash_sharded as jax_sh
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.observability.aggregates import merge_agg
from distributed_membership_tpu.runtime import application as jax_app
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch.backends import tpu_hash
from distributed_membership_tpu_torch.backends import tpu_hash_sharded as sh
from distributed_membership_tpu_torch.backends.tpu_hash_folded import (
    make_ring_sharded_folded_step)
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import (
    state_from_numpy, state_to_numpy)
from distributed_membership_tpu_torch.observability.aggregates import (
    init_fast_agg)
from distributed_membership_tpu_torch.runtime import application, failures

SEED = 5
TICKS = 80
CONF = ("MAX_NNB: 512\nSINGLE_FAILURE: 1\nDROP_MSG: 0\nMSG_DROP_PROB: 0\n"
        "VIEW_SIZE: 16\nGOSSIP_LEN: 4\nPROBES: 0\nFANOUT: 3\nTFAIL: 16\n"
        "TREMOVE: 32\nTOTAL_TIME: 80\nFAIL_TIME: 10\nJOIN_MODE: warm\n"
        "EXCHANGE: ring\nEVENT_MODE: agg\nFOLDED: 1\n")
SINGLE = CONF + "BACKEND: tpu_hash\n"
SHARDED = CONF + "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 4\n"
_UNFUSED = "FUSED_RECEIVE: 0\nFUSED_GOSSIP: 0\nFUSED_PROBE: 0\n"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(cls, text):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return cls.from_text(text)


def _jax_leaves(state) -> dict:
    out = {}
    for name, leaf in state._asdict().items():
        if name == "agg":
            out.update({f"agg.{f}": np.asarray(x)
                        for f, x in leaf._asdict().items()})
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


def test_folded_probes0_step_matches_jax_every_tick():
    jp = _params(JaxParams, SINGLE + _UNFUSED)
    pp = _params(Params, SINGLE)
    jplan = jax_failures.make_plan(jp, random.Random(f"app:{SEED}"))
    pplan = failures.make_plan(pp, random.Random(f"app:{SEED}"))
    jcfg = jax_hash.make_config(jp, False,
                                fail_ids=jax_hash.plan_fail_ids(jplan))
    pcfg = tpu_hash.make_config(pp, False,
                                fail_ids=tpu_hash.plan_fail_ids(pplan),
                                device="cpu")
    assert jcfg.folded and pcfg.folded and pcfg.probes == 0
    jstep = jax.jit(jax_fold.make_folded_step(jcfg))
    inputs = jax_failures.plan_tensors(jp, jplan, SEED, TICKS)
    jstate = jax_fold.init_state_warm_folded(
        jcfg, jax_failures.make_run_key(jp, SEED ^ 0x5EED))
    step, init = tpu_hash.step_and_init(pcfg)
    own = state_to_numpy(init(pcfg, failures.make_run_key(
        pp, SEED ^ 0x5EED), "cpu"))
    want = _jax_leaves(jstate)
    assert set(own) == set(want)
    for name in want:
        _first_mismatch(-1, name, own[name], want[name])
    assert own["probe_ids1"].shape == (1, 1)
    pstate = state_from_numpy(want, device="cpu")
    plan_t = failures.plan_tensors(pp, pplan, SEED, TICKS, "cpu")
    for t in range(TICKS):
        jstate, jout = jstep(jstate, (inputs[0][t], inputs[1][t])
                             + tuple(inputs[2:]))
        pstate, pout = step(pstate, t, plan_t.tick_key(t), plan_t)
        want = _jax_leaves(jstate)
        got = state_to_numpy(pstate)
        for name in sorted(want):
            _first_mismatch(t, name, got[name], want[name])
        for name in pout._fields:
            _first_mismatch(t, f"events.{name}", getattr(pout, name),
                            getattr(jout, name))
    assert int(pstate.agg.det_count.sum()) == 9


def test_sharded_folded_probes0_matches_jax_every_tick():
    jp = _params(JaxParams, SHARDED + _UNFUSED)
    pp = _params(Params, SHARDED)
    jplan = jax_failures.make_plan(jp, random.Random(f"app:{SEED}"))
    pplan = failures.make_plan(pp, random.Random(f"app:{SEED}"))
    jmesh = jax_sh.resolve_mesh(jp)
    mesh = sh.resolve_mesh(pp, "cpu")
    assert mesh.size == jmesh.size == 4
    n_local = pp.EN_GPSZ // mesh.size
    fail_ids = tuple(jplan.failed_indices)
    jcfg = jax_sh.sharded_config(jp, False, fail_ids, None, n_local)
    pcfg = sh.sharded_config(pp, False, fail_ids, n_local, device="cpu")
    assert jcfg.folded and pcfg.folded
    init = jax_sh._get_init_runner(jcfg, n_local, jmesh, True)
    seg = jax_sh._get_segment_runner(jcfg, n_local, jmesh, True)
    inputs = jax_failures.plan_tensors(jp, jplan, SEED, TICKS)
    jstate = init(jax_failures.make_run_key(jp, SEED ^ 0x5EED))
    pstate = state_from_numpy(_jax_leaves(jstate), device="cpu")
    assert pstate.probe_ids1.shape == (4, 1)
    pstate = pstate._replace(agg=init_fast_agg(
        len(pcfg.fail_ids), pcfg.n, "cpu", shards=mesh.size))
    plan_t = failures.plan_tensors(pp, pplan, SEED, TICKS, "cpu")
    pstep = make_ring_sharded_folded_step(pcfg, mesh)
    acc = None
    for t in range(TICKS):
        jstate, jev = seg(jstate, inputs[0][t:t + 1], inputs[1][t:t + 1],
                          *inputs[2:])
        tick_agg = jax.tree.map(np.asarray, jstate.agg)
        acc = tick_agg if acc is None else merge_agg(acc, tick_agg)
        want = _jax_leaves(jstate)
        want.update({f"agg.{f}": np.asarray(x)
                     for f, x in acc._asdict().items()})
        pstate, pout = pstep(pstate, t, plan_t.tick_key(t), plan_t)
        got = state_to_numpy(pstate._replace(
            agg=sh.reduce_fast_agg(pstate.agg, mesh)))
        assert set(got) == set(want)
        for name in sorted(want):
            _first_mismatch(t, name, got[name], want[name])
        for name in pout._fields:
            _first_mismatch(t, f"events.{name}", getattr(pout, name),
                            np.asarray(getattr(jev, name))[0])
    assert int(acc.det_count.sum()) > 0


@pytest.mark.parametrize("conf", ["single", "sharded"])
def test_folded_probes0_summary_matches_jax(tmp_path, conf):
    path = tmp_path / "p0.conf"
    path.write_text(SINGLE if conf == "single" else SHARDED)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_app.run_conf(str(path), seed=SEED,
                                out_dir=str(tmp_path / "jax"))
        got = application.run_conf(str(path), seed=SEED,
                                   out_dir=str(tmp_path / "port"),
                                   device="cpu")
    summary = got.extra["detection_summary"]
    assert summary == want.extra["detection_summary"]
    assert got.extra["final_state"].view.shape == (64, 128)
    if conf == "single":
        assert summary["detections_total"] == 9
        assert summary["false_removals"] == 11005


def test_folded_probes0_gates_match_jax():
    """``FOLDED: 1`` resolves with no probes; a pinned ``FUSED_PROBE: 1``
    with no probes raises the JAX package's ValueError; on CUDA auto
    ``FOLDED`` picks the folded layout, except under the service."""
    pcfg = tpu_hash.make_config(_params(Params, SINGLE), False,
                                fail_ids=(3,), device="cpu")
    assert pcfg.folded and pcfg.probes == 0
    for cls, kw in ((Params, {"device": "cpu"}), (JaxParams, {})):
        mod = tpu_hash if cls is Params else jax_hash
        with pytest.raises(ValueError, match="FUSED_PROBE requires the ring "
                           "exchange with PROBES > 0"):
            mod.make_config(_params(cls, SINGLE + "FUSED_PROBE: 1\n"),
                            False, fail_ids=(3,), **kw)
    auto = SINGLE.replace("FOLDED: 1", "FOLDED: -1")
    assert tpu_hash.make_config(_params(Params, auto), False, fail_ids=(3,),
                                device="cuda").folded
    unserved = _params(Params, auto + "CHECKPOINT_EVERY: 10\n")
    assert tpu_hash.make_config(unserved, False, fail_ids=(3,),
                                device="cuda").folded
    # Served, auto stays natural, whose kernels take 16-slot rows on CUDA.
    served = _params(Params, auto + "CHECKPOINT_EVERY: 10\nSERVICE_PORT: 0\n")
    cfg = tpu_hash.make_config(served, False, fail_ids=(3,), device="cuda")
    assert not cfg.folded and cfg.s == 16
