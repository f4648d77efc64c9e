"""The sharded backend's scatter exchange (backends/tpu_hash_sharded.py
``make_sharded_step``) against the JAX package's ``make_sharded_step``,
on the CPU.

The JAX side runs on the eight virtual CPU devices of tests/conftest.py;
the port holds the same mesh on one device (parallel/mesh.py LocalMesh).
Compared, with tolerance 0:

* ``LocalMesh.all_to_all`` against ``lax.all_to_all`` inside
  ``shard_map``, ``bucket_capacity`` and the scatter state's leaves;
* the scatter step at every tick and in every state leaf, from one start
  state: N=256 at S=16 and S=128, ``MESH_SHAPE`` 1, 2 and 8, warm and
  cold (staggered) joins, 10% drops, full events and agg (AggStats), with
  full buckets truncated on the cold runs;
* a scatter run killed in one package and resumed in the other, against
  the JAX package's uninterrupted run (the checkpoint's real ``amail``
  and ``pmail`` leaves);
* ``--grade-all --backend tpu_hash_sharded`` (Final grade 90) with the
  logs of the JAX package's runs under the same ``MESH_SHAPE``;
* the JAX ValueError of a 2-D mesh with the scatter exchange.
"""

import os
import random
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import lax
from jax.sharding import PartitionSpec as JP

from distributed_membership_tpu.backends import tpu_hash_sharded as jax_sh
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.observability.aggregates import merge_agg
from distributed_membership_tpu.parallel import shard_map
from distributed_membership_tpu.parallel.mesh import make_mesh
from distributed_membership_tpu.runtime import application as jax_app
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch import kernels
from distributed_membership_tpu_torch.backends import tpu_hash_sharded as sh
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import (
    state_from_numpy, state_to_numpy)
from distributed_membership_tpu_torch.observability.aggregates import (
    init_agg)
from distributed_membership_tpu_torch.parallel.mesh import LocalMesh
from distributed_membership_tpu_torch.runtime import application
from distributed_membership_tpu_torch.runtime import checkpoint as ck
from distributed_membership_tpu_torch.runtime import failures

from test_torch_sharded import _first_mismatch, _jax_leaves

SEED = 3
SCENARIOS = ("singlefailure", "multifailure", "msgdropsinglefailure")
LOGS = ("dbg.log", "stats.log", "msgcount.log")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores (tests/test_torch_sharded.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_crash_env(monkeypatch):
    monkeypatch.delenv(ck.CRASH_ENV, raising=False)


# ---------------------------------------------------------------------------
# The collective and the bucket size


@pytest.mark.parametrize("d", [1, 2, 8])
def test_all_to_all_matches_jax(d):
    """Shard s's bucket k becomes shard k's slice s, as the tiled
    ``lax.all_to_all(x, AX, 0, 0)`` of the JAX scatter step."""
    cap = 3
    x = np.arange(d * d * cap * 2, dtype=np.int32).reshape(d * d * cap, 2)
    jmesh = make_mesh(d)
    ax = jmesh.axis_names[0]
    run = jax.jit(shard_map(
        lambda v: lax.all_to_all(v.reshape(d, cap, 2), ax, 0, 0,
                                 tiled=True).reshape(d * cap, 2),
        mesh=jmesh, in_specs=(JP(ax),), out_specs=JP(ax), check_vma=False))
    want = np.asarray(run(jnp.asarray(x)))
    got = LocalMesh((d,), "cpu").all_to_all(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    if d == 1:
        assert np.array_equal(got.numpy(), x)


@pytest.mark.parametrize("conf", ["s16", "s128_cold"])
def test_bucket_capacity_and_state_match_jax(conf):
    text = CASES[{"s16": "s16_d8_warm_full",
                  "s128_cold": "s128_d8_cold_full"}[conf]]
    jp, pp = _params(text)
    for d in (1, 2, 8):
        n_local = pp.EN_GPSZ // d
        jcfg = jax_sh.sharded_config(jp, True, (3,), None, n_local)
        pcfg = sh.sharded_config(pp, True, (3,), n_local, device="cpu")
        assert pcfg.exchange == jcfg.exchange == "scatter"
        assert (sh.bucket_capacity(pcfg, n_local, d)
                == jax_sh.bucket_capacity(jcfg, n_local, d))
    # The scatter state: [N, S] ack and [N, Qp] probe mailboxes, the
    # ring's probe pipeline as one-per-shard placeholders.
    st = sh.init_local_state(pcfg, LocalMesh((8,), "cpu"))
    assert st.amail.shape == (256, pcfg.s)
    assert st.pmail.shape == (256, pcfg.qp)
    assert st.probe_ids1.shape == (8, 1) and st.act_prev.shape == (8,)


# ---------------------------------------------------------------------------
# The scatter step at every tick

_BASE = ("MAX_NNB: 256\nSINGLE_FAILURE: 1\nVIEW_SIZE: {s}\nGOSSIP_LEN: {g}\n"
         "PROBES: {p}\nFANOUT: 3\nTFAIL: 16\nTREMOVE: 32\n"
         "TOTAL_TIME: {t}\nFAIL_TIME: {f}\nJOIN_MODE: {join}\n"
         "EXCHANGE: scatter\nBACKEND: tpu_hash_sharded\nMESH_SHAPE: {d}\n"
         "DROP_MSG: 1\nMSG_DROP_PROB: 0.1\nDROP_START: 5\nDROP_STOP: 50\n")
CASES = {
    "s16_d8_warm_full": _BASE.format(s=16, g=8, p=2, t=50, f=8,
                                     join="warm", d=8),
    "s128_d8_cold_full": _BASE.format(s=128, g=32, p=16, t=70, f=20,
                                      join="staggered", d=8),
    "s16_d1_cold_agg": _BASE.format(s=16, g=8, p=2, t=90, f=40,
                                    join="staggered", d=1)
    + "EVENT_MODE: agg\n",
    "s128_d2_warm_full": _BASE.format(s=128, g=32, p=16, t=48, f=8,
                                      join="warm", d=2),
    "s128_d8_warm_agg": _BASE.format(s=128, g=32, p=16, t=48, f=8,
                                     join="warm", d=8) + "EVENT_MODE: agg\n",
}


def _params(text):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JaxParams.from_text(text), Params.from_text(text)


@pytest.mark.parametrize("case", list(CASES))
def test_scatter_step_matches_jax_every_tick(case):
    jp, pp = _params(CASES[case])
    collect = jp.resolved_event_mode() == "full"
    jplan = jax_failures.make_plan(jp, random.Random(f"app:{SEED}"))
    pplan = failures.make_plan(pp, random.Random(f"app:{SEED}"))
    jmesh = jax_sh.resolve_mesh(jp)
    mesh = sh.resolve_mesh(pp, "cpu")
    assert mesh.size == jmesh.size
    n_local = pp.EN_GPSZ // mesh.size
    fail_ids = tuple(jplan.failed_indices)
    jcfg = jax_sh.sharded_config(jp, collect, fail_ids, None, n_local)
    pcfg = sh.sharded_config(pp, collect, fail_ids, n_local, device="cpu")
    assert pcfg.exchange == jcfg.exchange == "scatter"
    assert not (pcfg.fast_agg or jcfg.fast_agg)
    warm = jp.JOIN_MODE == "warm"
    ticks = jp.TOTAL_TIME
    init = jax_sh._get_init_runner(jcfg, n_local, jmesh, warm)
    seg = jax_sh._get_segment_runner(jcfg, n_local, jmesh, warm)
    inputs = jax_failures.plan_tensors(jp, jplan, SEED, ticks)
    jstate = init(jax_failures.make_run_key(jp, SEED ^ 0x5EED))
    pstate = state_from_numpy(_jax_leaves(jstate), device="cpu")
    if warm:
        # The port's own warm start is the JAX one.
        own = state_to_numpy(sh.init_local_state_warm(
            pcfg, mesh, failures.make_run_key(pp, SEED ^ 0x5EED)))
        for name, want in _jax_leaves(jstate).items():
            if not name.startswith("agg."):
                _first_mismatch(-1, name, own[name], want)
    if not collect:
        pstate = pstate._replace(agg=init_agg(pcfg.n, "cpu"))
    plan_t = failures.plan_tensors(pp, pplan, SEED, ticks, "cpu")
    pstep = sh.make_sharded_step(pcfg, mesh)
    acc = None
    removals = 0
    kernels.reset_launches()
    for t in range(ticks):
        jstate, jev = seg(jstate, inputs[0][t:t + 1], inputs[1][t:t + 1],
                          *inputs[2:])
        want = _jax_leaves(jstate)
        if not collect:
            tick_agg = jax.tree.map(np.asarray, jstate.agg)
            acc = tick_agg if acc is None else merge_agg(acc, tick_agg)
            want.update({f"agg.{f}": np.asarray(x)
                         for f, x in acc._asdict().items()})
        pstate, pout = pstep(pstate, t, plan_t.tick_key(t), plan_t)
        got = state_to_numpy(pstate)
        assert set(got) == set(want)
        for name in sorted(want):
            _first_mismatch(t, name, got[name], want[name])
        for name in pout._fields:
            _first_mismatch(t, f"events.{name}", getattr(pout, name),
                            np.asarray(getattr(jev, name))[0])
        rm = np.asarray(jev.rm_ids)
        removals += int((rm >= 0).sum() if rm.ndim > 1 else rm.sum())
    assert not any(kernels.LAUNCHES.values())    # no kernel on scatter
    stats = pstep.stats
    assert stats["ticks"] == ticks and stats["sent"] > 0
    assert stats["messages"] <= 1 << 26          # the JAX packed sort
    assert stats["truncated_max"] <= stats["truncated"]
    if case == "s128_d8_cold_full":
        # The join storm overflows buckets: the truncated tails are the
        # JAX ones (the per-tick state above).
        assert stats["truncated_max"] > 0
    assert removals > 0
    if not collect:
        assert int(acc.join_count.sum()) > 0 and int(acc.rm_count.sum()) > 0
        if warm:
            assert int(acc.det_count.sum()) > 0


# ---------------------------------------------------------------------------
# Kill and resume across the packages

_KR = CASES["s128_d8_cold_full"]


def _run(pkg, conf, out, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if pkg == "jax":
            return jax_app.run_conf(str(conf), seed=SEED, out_dir=str(out),
                                    **kw)
        return application.run_conf(str(conf), seed=SEED, out_dir=str(out),
                                     device="cpu", **kw)


@pytest.mark.parametrize("killer,resumer", [("port", "jax"),
                                            ("jax", "port")])
def test_scatter_kill_resume_across_packages(killer, resumer, tmp_path):
    """A scatter run killed at tick 35 (boundary 40, CHECKPOINT_EVERY 20)
    in one package and resumed in the other writes the logs of the JAX
    package's uninterrupted run; the snapshot holds the real ``[N, S]``
    ack and ``[N, Qp]`` probe mailboxes."""
    conf = tmp_path / "kr.conf"
    conf.write_text(_KR)
    _run("jax", conf, tmp_path / "ref")
    ckdir = tmp_path / "ck"
    os.environ[ck.CRASH_ENV] = "35"
    try:
        with pytest.raises(RuntimeError, match="injected crash"):
            _run(killer, conf, tmp_path / "killed", checkpoint_every=20,
                 checkpoint_dir=str(ckdir))
    finally:
        del os.environ[ck.CRASH_ENV]
    assert ck.manifest_tick(str(ckdir)) == 40
    snap = np.load(ckdir / "ckpt_00000040.npz")
    shapes = {snap[k].shape for k in snap.files}
    assert (256, 128) in shapes and (256, 256) in shapes   # amail, pmail
    r = _run(resumer, conf, tmp_path / "resumed", checkpoint_every=20,
             checkpoint_dir=str(ckdir), resume=True)
    if resumer == "port":
        # The buckets' numbers of the resumed ticks, on the RunResult.
        assert r.extra["buckets"]["ticks"] == r.params.TOTAL_TIME - 40
    for f in LOGS:
        assert ((tmp_path / "resumed" / f).read_bytes()
                == (tmp_path / "ref" / f).read_bytes()), f
    assert b" removed " in (tmp_path / "ref" / "dbg.log").read_bytes()


# ---------------------------------------------------------------------------
# The grader regime on the sharded backend


@pytest.mark.parametrize("mesh_shape", [None, "5"])
def test_grade_all_sharded_matches_jax_logs(mesh_shape, tmp_path, capsys,
                                            testcases_dir):
    """``--grade-all --backend tpu_hash_sharded`` grades 90 on the CPU,
    EXCHANGE auto resolving the scatter step for the testcases' staggered
    joins; its logs are the JAX package's under the same MESH_SHAPE (one
    shard when the flag is unset: the JAX package would take five
    devices, the largest count dividing N=10)."""
    argv = ["--grade-all", "--backend", "tpu_hash_sharded", "--device",
            "cpu", "--seed", str(SEED), "--out-dir", str(tmp_path / "port")]
    if mesh_shape:
        argv += ["--mesh-shape", mesh_shape]
    kernels.reset_launches()
    rc = application.main(argv)
    out = capsys.readouterr().out
    assert rc == 0 and out.splitlines()[-1] == "Final grade 90"
    assert not any(kernels.LAUNCHES.values())
    for scenario in SCENARIOS:
        r = _run("jax", testcases_dir / f"{scenario}.conf",
                 tmp_path / "jax" / scenario, backend="tpu_hash_sharded",
                 mesh_shape=mesh_shape or "1")
        assert r.extra["mesh_size"] == int(mesh_shape or 1)
        for name in LOGS:
            want = (tmp_path / "jax" / scenario / name).read_bytes()
            got = (tmp_path / "port" / scenario / name).read_bytes()
            assert got == want, f"{scenario}/{name}"


def test_two_axis_mesh_refused_as_jax(tmp_path):
    """The bucketed all_to_all is 1-D: a 2-D MESH_SHAPE with the scatter
    exchange raises the JAX package's ValueError, word for word."""
    conf = tmp_path / "m.conf"
    conf.write_text(CASES["s16_d8_warm_full"].replace("MESH_SHAPE: 8",
                                                      "MESH_SHAPE: 2x4"))
    with pytest.raises(ValueError) as want:
        _run("jax", conf, tmp_path / "jax")
    with pytest.raises(ValueError) as got:
        _run("port", conf, tmp_path / "port")
    assert str(got.value) == str(want.value)
    assert "1-D only" in str(got.value)
