"""``EXCHANGE_MODE: batched`` (ops/exchange.py), ``PROBE_GATHER: split``
and the sharded folded AggStats route against the JAX package, on the
CPU.

The JAX side runs on the eight virtual CPU devices of tests/conftest.py,
the port on one device.  Compared, with tolerance 0:

* ``BatchedExchange``'s pieces (``zero``, ``add_shift`` with the sender's
  alignment into buckets that sit at their destinations, ``merge_mail``,
  ``merge_pending``, ``wipe``) against the JAX class's buckets shipped by
  its ``exchange`` inside ``shard_map``, on random planes, natural and
  folded, in both column regimes;
* whole runs, batched == legacy == JAX batched (detection summary,
  message counts, every final-state leaf, every timeline series): the
  natural and folded sharded steps with drops, TELEMETRY hist and
  ``CHECKPOINT_EVERY``; ``MEGA_TICKS`` on a 2x4 mesh; the folded step on
  2x2x2; a partition + crash + restart + link flake scenario;
* a batched run killed mid-flight and resumed under legacy, in the port
  and in the JAX package (the snapshot holds no xbuf), against the JAX
  package's uninterrupted legacy run (JAX
  ``test_exchange_kill_resume_bit_exact``);
* ``PROBE_GATHER: split`` == packed == JAX split on both sharded steps in
  the three ``PROBE_IO`` modes;
* the sharded folded step with AggStats (the card's route for more than
  8 failed ids; built on the CPU here) against the JAX natural sharded
  step per tick, and its gates.
"""

import dataclasses
import json
import os
import random
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as JP

from distributed_membership_tpu.backends import get_backend as jax_backend
from distributed_membership_tpu.backends import tpu_hash_sharded as jax_sh
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.observability.aggregates import merge_agg
from distributed_membership_tpu.ops.exchange import (
    BatchedExchange as JaxExchange)
from distributed_membership_tpu.parallel import shard_map
from distributed_membership_tpu.parallel.mesh import make_mesh
from distributed_membership_tpu.runtime import application as jax_app
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch import kernels
from distributed_membership_tpu_torch.backends import get_backend
from distributed_membership_tpu_torch.backends import tpu_hash_sharded as sh
from distributed_membership_tpu_torch.backends.tpu_hash_folded import (
    init_local_state_warm_folded, make_ring_sharded_folded_step)
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import state_to_numpy
from distributed_membership_tpu_torch.observability.aggregates import (
    AggStats)
from distributed_membership_tpu_torch.ops.exchange import BatchedExchange
from distributed_membership_tpu_torch.ops.view_merge import STRIDE
from distributed_membership_tpu_torch.parallel.mesh import LocalMesh
from distributed_membership_tpu_torch.runtime import application
from distributed_membership_tpu_torch.runtime import checkpoint as ck
from distributed_membership_tpu_torch.runtime import failures

from test_torch_sharded import _first_mismatch, _jax_leaves

SEED = 3


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
# BatchedExchange's pieces against the JAX class

# (N, S, folded): L = N/8 rows a shard; the natural L=32 and the folded
# L=8 take both column shifts, L=128 and L=64 one.
PIECE_CASES = [(256, 128, False), (1024, 128, False), (64, 16, True),
               (512, 16, True)]


@pytest.mark.parametrize("n,s,folded", PIECE_CASES)
def test_exchange_pieces_match_jax(n, s, folded):
    d, k = 8, 3
    n_local = n // d
    single = (n_local * STRIDE) % s == 0
    assert single == (n in (1024, 512))
    rng = np.random.default_rng(n + s)
    shape = (n * s // 128, 128) if folded else (n, s)
    vals = rng.integers(1, 2**32, size=(k,) + shape, dtype=np.int64)
    payloads = np.where(rng.random((k,) + shape) < 0.4, vals,
                        0).astype(np.uint32)
    cnts = rng.integers(0, 9, size=(k, n)).astype(np.int32)
    mail = np.where(rng.random(shape) < 0.5,
                    rng.integers(1, 2**32, size=shape, dtype=np.int64),
                    0).astype(np.uint32)
    up = rng.random(n) < 0.2
    u = rng.integers(1, n, size=k)
    bs, cs = (u // n_local).astype(np.int32), (u % n_local).astype(np.int32)
    assert len(set(bs.tolist())) > 1

    jmesh = make_mesh(d)
    ax = jmesh.axis_names[0]
    jx = JaxExchange(n_shards=d, axes=(ax,), n_local=n_local, s=s,
                     cstride=STRIDE % s, single_col_roll=single,
                     folded=folded)

    def body(pl, cn, ml, upv):
        from jax import lax
        me = lax.axis_index(ax)
        pay, cnt = jx.zero()
        for j in range(k):
            pay, cnt = jx.add_shift(pay, cnt, pl[j], cn[j],
                                    jnp.int32(bs[j]), jnp.int32(cs[j]), me)
        pr, cr = jx.exchange(pay, cnt)
        wp, wc = jx.wipe(pr, cr, upv)
        return (jx.merge_mail(ml, pr), jx.merge_pending(cr),
                jx.merge_mail(ml, wp), jx.merge_pending(wc))
    run = jax.jit(shard_map(
        body, mesh=jmesh,
        in_specs=(JP(None, ax), JP(None, ax), JP(ax), JP(ax)),
        out_specs=(JP(ax), JP(ax), JP(ax), JP(ax)), check_vma=False))
    want = [np.asarray(x) for x in run(jnp.asarray(payloads),
                                       jnp.asarray(cnts), jnp.asarray(mail),
                                       jnp.asarray(up))]

    def bits(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    bx = BatchedExchange(mesh=LocalMesh((d,), "cpu"), n_local=n_local, s=s,
                         cstride=STRIDE % s, single_col_roll=single,
                         folded=folded)
    pay, cnt = bx.zero("cpu")
    for j in range(k):
        bx.add_shift(pay, cnt, bits(payloads[j]).view(d, -1, shape[1]),
                     torch.from_numpy(cnts[j]).view(d, n_local),
                     torch.tensor(int(bs[j])), torch.tensor(int(cs[j])))
    wp, wc = bx.wipe(pay, cnt, torch.from_numpy(up))
    got = [bx.merge_mail(bits(mail), pay), bx.merge_pending(cnt),
           bx.merge_mail(bits(mail), wp), bx.merge_pending(wc)]
    for name, g, w in zip(("merge_mail", "merge_pending", "wipe.mail",
                           "wipe.pending"), got, want):
        g = g.numpy()
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert not np.array_equal(want[0], mail) and want[1].sum() > 0


# ---------------------------------------------------------------------------
# Whole runs: batched == legacy == JAX

_X = ("MAX_NNB: {n}\nSINGLE_FAILURE: 1\nDROP_MSG: 1\nMSG_DROP_PROB: 0.1\n"
      "DROP_START: 10\nDROP_STOP: 50\nGOSSIP_LEN: 8\nPROBES: 2\n"
      "FANOUT: 3\nTFAIL: 16\nTREMOVE: 32\nTOTAL_TIME: 64\nFAIL_TIME: 12\n"
      "VIEW_SIZE: 16\nJOIN_MODE: warm\nEVENT_MODE: agg\nEXCHANGE: ring\n"
      "TELEMETRY: hist\nCHECKPOINT_EVERY: 24\n"
      "BACKEND: tpu_hash_sharded\nMESH_SHAPE: {mesh}\n")


def _run(pkg, text, seed=SEED):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if pkg == "jax":
            p = JaxParams.from_text(text)
            return jax_backend("tpu_hash_sharded")(p, seed=seed)
        return get_backend("tpu_hash_sharded")(Params.from_text(text),
                                               seed=seed, device="cpu")


def _same_run(got, want, want_jax=False):
    assert (got.extra["detection_summary"]
            == want.extra["detection_summary"])
    np.testing.assert_array_equal(np.asarray(got.sent),
                                  np.asarray(want.sent))
    np.testing.assert_array_equal(np.asarray(got.recv),
                                  np.asarray(want.recv))
    a = state_to_numpy(got.extra["final_state"])
    b = (_jax_leaves if want_jax else state_to_numpy)(
        want.extra["final_state"])
    assert set(a) == set(b)
    for k in b:
        _first_mismatch("end", k, a[k].reshape(b[k].shape), b[k])
    tl, jtl = got.extra.get("timeline"), want.extra.get("timeline")
    assert (tl is None) == (jtl is None)
    for k in (jtl or {}):
        np.testing.assert_array_equal(np.asarray(tl[k]), np.asarray(jtl[k]),
                                      err_msg=k)
    if "scenario_report" in want.extra:
        assert got.extra["scenario_report"] == want.extra["scenario_report"]


def _batched_vs_legacy_vs_jax(text, expect_launch_free=True):
    kernels.reset_launches()
    batched = _run("port", text + "EXCHANGE_MODE: batched\n")
    legacy = _run("port", text + "EXCHANGE_MODE: legacy\n")
    want = _run("jax", text + "EXCHANGE_MODE: batched\n")
    _same_run(batched, legacy)
    _same_run(batched, want, want_jax=True)
    assert not any(kernels.LAUNCHES.values())   # the CPU runs no kernel
    return batched


@pytest.mark.parametrize("folded", [False, True], ids=["natural", "folded"])
def test_batched_droppy_hist_chunked(folded):
    """Drops, the hist tier and 24-tick segments (the xbuf flushed at every
    boundary) on eight shards, natural (N=256, L=32: two column shifts)
    and folded (N=512)."""
    text = _X.format(n=512 if folded else 256, mesh=8)
    if folded:
        text += "FOLDED: 1\n"
    r = _batched_vs_legacy_vs_jax(text)
    assert r.extra["detection_summary"]["detections_total"] > 0
    assert (r.extra["final_state"].view.shape[1] == 128) == folded


@pytest.mark.parametrize("mesh,folded,extra", [
    ("2x4", False, "MEGA_TICKS: 4\n"),
    ("2x2x2", True, ""),
], ids=["2x4_mega", "2x2x2_folded"])
def test_batched_torus_meshes(mesh, folded, extra):
    """The flat outer-major shard index of the N-D meshes; T-tick blocks
    carry the ``(state, xbuf)`` lane through the codec."""
    text = (_X.format(n=512, mesh=mesh) + extra
            + ("FOLDED: 1\n" if folded else ""))
    if extra:
        text = text.replace("CHECKPOINT_EVERY: 24", "CHECKPOINT_EVERY: 16")
    _batched_vs_legacy_vs_jax(text)


_CHAOS = ("MAX_NNB: 256\nSINGLE_FAILURE: 0\nDROP_MSG: 0\nMSG_DROP_PROB: 0\n"
          "GOSSIP_LEN: 8\nPROBES: 2\nFANOUT: 3\nTFAIL: 16\nTREMOVE: 40\n"
          "TOTAL_TIME: 120\nVIEW_SIZE: 16\nJOIN_MODE: warm\n"
          "EVENT_MODE: agg\nEXCHANGE: ring\nTELEMETRY: scalars\n"
          "CHECKPOINT_EVERY: 40\nBACKEND: tpu_hash_sharded\n"
          "MESH_SHAPE: 8\n")


def test_batched_chaos_scenario(tmp_path):
    """A partition, a crash, a restart and a link flake: the restart's
    wipe chases the deferred gossip into the xbuf."""
    events = [
        {"kind": "partition", "start": 10, "stop": 50,
         "groups": [[0, 128], [128, 256]]},
        {"kind": "crash", "time": 20, "range": [4, 8]},
        {"kind": "restart", "time": 70, "range": [4, 8]},
        {"kind": "link_flake", "start": 80, "stop": 110,
         "src": [0, 128], "dst": [128, 256], "drop_prob": 0.2},
    ]
    spath = tmp_path / "chaos.json"
    spath.write_text(json.dumps({"name": "chaos", "events": events}))
    r = _batched_vs_legacy_vs_jax(_CHAOS + f"SCENARIO: {spath}\n")
    rep = r.extra["scenario_report"]
    assert rep["partitions"][0]["removals_during"] > 0
    assert rep["restarts"][0]["rejoined"] is True


_KR = ("MAX_NNB: 64\nSINGLE_FAILURE: 1\nDROP_MSG: 1\nMSG_DROP_PROB: 0.1\n"
       "DROP_START: 30\nDROP_STOP: 120\nVIEW_SIZE: 16\nGOSSIP_LEN: 8\n"
       "PROBES: 2\nFANOUT: 3\nTFAIL: 16\nTREMOVE: 40\nTOTAL_TIME: 200\n"
       "FAIL_TIME: 100\nJOIN_MODE: warm\nEVENT_MODE: agg\nEXCHANGE: ring\n"
       "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8\n")


@pytest.mark.parametrize("resumer", ["port", "jax"])
def test_batched_kill_resume(resumer, tmp_path):
    """Killed at 50 (boundary 80) under batched, resumed under legacy:
    the snapshot is legacy-shaped, so either package resumes it to the
    JAX package's uninterrupted legacy run; EXCHANGE_MODE stays out of
    the manifest's identity."""
    want = _run("jax", _KR + "EXCHANGE_MODE: legacy\n")
    ckdir = tmp_path / "ck"
    conf = tmp_path / "kr.conf"
    conf.write_text(_KR + "EXCHANGE_MODE: batched\n")
    os.environ[ck.CRASH_ENV] = "50"
    try:
        with pytest.raises(RuntimeError, match="injected crash"):
            application.run_conf(str(conf), seed=SEED, device="cpu",
                                 out_dir=str(tmp_path / "killed"),
                                 checkpoint_every=40,
                                 checkpoint_dir=str(ckdir))
    finally:
        del os.environ[ck.CRASH_ENV]
    assert ck.manifest_tick(str(ckdir)) == 80
    conf.write_text(_KR + "EXCHANGE_MODE: legacy\n")
    kw = dict(seed=SEED, out_dir=str(tmp_path / "resumed"),
              checkpoint_every=40, checkpoint_dir=str(ckdir), resume=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = (application.run_conf(str(conf), device="cpu", **kw)
               if resumer == "port" else jax_app.run_conf(str(conf), **kw))
    assert (got.extra["detection_summary"]
            == want.extra["detection_summary"])
    assert got.extra["detection_summary"]["detections_total"] > 0
    np.testing.assert_array_equal(np.asarray(got.sent),
                                  np.asarray(want.sent))
    np.testing.assert_array_equal(np.asarray(got.recv),
                                  np.asarray(want.recv))
    ids = {ck.params_identity(Params.from_text(_KR + x))
           for x in ("", "EXCHANGE_MODE: legacy\n",
                     "EXCHANGE_MODE: batched\n")}
    assert len(ids) == 1


# ---------------------------------------------------------------------------
# PROBE_GATHER split

_SPLIT = {
    "natural": ("MAX_NNB: 256\nSINGLE_FAILURE: 1\nDROP_MSG: 1\n"
                "MSG_DROP_PROB: 0.05\nDROP_START: 10\nDROP_STOP: 40\n"
                "VIEW_SIZE: 128\nGOSSIP_LEN: 32\nPROBES: 16\nFANOUT: 3\n"
                "TFAIL: 16\nTREMOVE: 40\nTOTAL_TIME: 56\nFAIL_TIME: 8\n"
                "JOIN_MODE: warm\nEVENT_MODE: agg\nEXCHANGE: ring\n"
                "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8\n"),
    "folded": _X.format(n=512, mesh=8) + "FOLDED: 1\n",
}


@pytest.mark.parametrize("probe_io", ["exact", "approx", "none"])
@pytest.mark.parametrize("step", ["natural", "folded"])
def test_probe_gather_split(step, probe_io):
    """PROBE_GATHER split on both sharded steps: the JAX three-gather
    arm's gathers are the identity on the flat layout, so the port runs
    its one packed gather, and the run equals the port's packed run and
    the JAX split arm."""
    text = _SPLIT[step] + f"PROBE_IO: {probe_io}\n"
    split = _run("port", text + "PROBE_GATHER: split\n")
    _same_run(split, _run("port", text))
    _same_run(split, _run("jax", text + "PROBE_GATHER: split\n"),
              want_jax=True)
    assert split.extra["detection_summary"]["detections_total"] > 0


# ---------------------------------------------------------------------------
# The sharded folded AggStats route

_MULTI = ("MAX_NNB: 512\nSINGLE_FAILURE: 0\nDROP_MSG: 1\n"
          "MSG_DROP_PROB: 0.05\nDROP_START: 4\nDROP_STOP: 30\n"
          "VIEW_SIZE: 16\nGOSSIP_LEN: 4\nPROBES: 2\nFANOUT: 3\n"
          "TFAIL: 16\nTREMOVE: 32\nTOTAL_TIME: 60\nFAIL_TIME: 8\n"
          "JOIN_MODE: warm\nEVENT_MODE: agg\nEXCHANGE: ring\n"
          "TELEMETRY: scalars\nBACKEND: tpu_hash_sharded\nMESH_SHAPE: 8\n")


def _multi_params(extra=""):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (JaxParams.from_text(_MULTI + extra),
                Params.from_text(_MULTI + extra))


def test_sharded_folded_aggstats_matches_jax_every_tick():
    """More than 8 failed ids on eight shards: the folded step with
    AggStats on the planes' [N, S] view (the card's route), built here
    on the CPU, equals the JAX natural sharded step's reduced AggStats
    and state at every tick."""
    jp, pp = _multi_params()
    jplan = jax_failures.make_plan(jp, random.Random(f"app:{SEED}"))
    pplan = failures.make_plan(pp, random.Random(f"app:{SEED}"))
    fail_ids = tuple(jplan.failed_indices)
    assert len(fail_ids) > 8
    jmesh = jax_sh.resolve_mesh(jp)
    mesh = sh.resolve_mesh(pp, "cpu")
    n_local = 64
    jcfg = jax_sh.sharded_config(jp, False, fail_ids, None, n_local)
    cfg = sh.sharded_config(pp, False, fail_ids, n_local, device="cpu")
    assert not (jcfg.folded or jcfg.fast_agg or cfg.folded or cfg.fast_agg)
    cfg = dataclasses.replace(cfg, folded=True)
    init = jax_sh._get_init_runner(jcfg, n_local, jmesh, True)
    seg = jax_sh._get_segment_runner(jcfg, n_local, jmesh, True)
    ticks = jp.TOTAL_TIME
    inputs = jax_failures.plan_tensors(jp, jplan, SEED, ticks)
    jstate = init(jax_failures.make_run_key(jp, SEED ^ 0x5EED))
    pstate = init_local_state_warm_folded(
        cfg, mesh, failures.make_run_key(pp, SEED ^ 0x5EED))
    assert isinstance(pstate.agg, AggStats)
    assert pstate.view.shape == (512 * 16 // 128, 128)
    plan_t = failures.plan_tensors(pp, pplan, SEED, ticks, "cpu")
    pstep = make_ring_sharded_folded_step(cfg, mesh)
    acc = None
    for t in range(ticks):
        jstate, (jev, _) = seg(jstate, inputs[0][t:t + 1],
                               inputs[1][t:t + 1], *inputs[2:])
        tick_agg = jax.tree.map(np.asarray, jstate.agg)
        acc = tick_agg if acc is None else merge_agg(acc, tick_agg)
        want = _jax_leaves(jstate)
        want.update({f"agg.{f}": np.asarray(x)
                     for f, x in acc._asdict().items()})
        pstate, (pout, _) = pstep(pstate, t, plan_t.tick_key(t), plan_t)
        got = state_to_numpy(pstate)
        assert set(got) == set(want)
        for name in sorted(want):
            _first_mismatch(t, name, got[name].reshape(want[name].shape),
                            want[name])
        for name in pout._fields:
            _first_mismatch(t, f"events.{name}", getattr(pout, name),
                            np.asarray(getattr(jev, name))[0])
    assert int(acc.det_count.sum()) > 0 and int(acc.det_obs.sum()) > 0


def test_sharded_folded_aggstats_gates():
    """FOLDED -1 takes the route on CUDA where the shards' rows fold and
    keeps the natural layout on the CPU (as the JAX package); a pinned
    FOLDED 1 raises the JAX ValueError, word for word."""
    fail_ids = tuple(range(12))
    _, pp = _multi_params()
    assert sh.sharded_config(pp, False, fail_ids, 64, device="cuda").folded
    assert not sh.sharded_config(pp, False, fail_ids, 64,
                                 device="cpu").folded
    jp, pp = _multi_params("FOLDED: 1\n")
    with pytest.raises(ValueError) as want:
        jax_sh.sharded_config(jp, False, fail_ids, None, 64)
    for dev in ("cpu", "cuda"):
        with pytest.raises(ValueError) as got:
            sh.sharded_config(pp, False, fail_ids, 64, device=dev)
        assert str(got.value) == str(want.value)
    # Shards whose rows do not fold (L=32 at P=2 needs 64): the natural
    # layout, whose kernels take S < 128 on the card.
    small = Params.from_text(_MULTI.replace("MAX_NNB: 512", "MAX_NNB: 256"))
    cfg = sh.sharded_config(small, False, fail_ids, 32, device="cuda")
    assert not cfg.folded and cfg.s == 16


def test_served_batched_run_matches_union_twin(tmp_path, monkeypatch):
    """``--serve`` on eight shards under EXCHANGE_MODE batched: the daemon
    drives the same segment runner, whose boundary carry is the flushed,
    legacy-shaped state, and rebuilds it for a live injection; the run's
    logs and timeline equal the legacy twin's handed the injected crash
    as a scenario up front (tests/test_torch_service.py's eight-shard
    case)."""
    from distributed_membership_tpu_torch.service import daemon
    from test_torch_service import (
        EVENT, SHARDED_CONF, gate_boundaries, inject_when_ticking, served)

    with monkeypatch.context() as mp:
        gates = gate_boundaries(mp, daemon)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            p = Params.from_text(SHARDED_CONF + "EXCHANGE_MODE: batched\n")
        p.CHECKPOINT_DIR = str(tmp_path / "ck")
        p.TELEMETRY_DIR = str(tmp_path / "tl")
        p.SERVICE_PORT = 0
        p.validate()
        out = tmp_path / "served"
        out.mkdir()
        rc, reply = served(
            lambda: daemon.serve_run(p, seed=SEED, out_dir=str(out),
                                     device="cpu"),
            str(out), lambda port: inject_when_ticking(port, gates))
    assert rc == 0 and reply["journaled"] is True
    scn = tmp_path / "union.json"
    scn.write_text(json.dumps({"name": "union", "events": [EVENT]}))
    conf = tmp_path / "twin.conf"
    conf.write_text(SHARDED_CONF + "EXCHANGE_MODE: legacy\n")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        twin = application.run_conf(str(conf), seed=SEED, device="cpu",
                                    out_dir=str(tmp_path / "twin"),
                                    scenario=str(scn),
                                    telemetry_dir=str(tmp_path / "twin_tl"))
    assert (out / "dbg.log").read_bytes() == twin.log.dbg_text().encode()
    assert b" removed " in (out / "dbg.log").read_bytes()
    assert ((tmp_path / "tl" / "timeline.jsonl").read_bytes()
            == (tmp_path / "twin_tl" / "timeline.jsonl").read_bytes())
