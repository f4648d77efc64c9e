"""The port's scenario engine against the JAX package's (scenario/ and
K1's ``admit_mask`` form), on the CPU with tolerance 0.

* schema: the same schedules are refused with the same messages;
* compile: every ``scenarios/*.json`` (the banked repros too) and inline
  schedules compile to the JAX package's plan, static descriptor and
  numpy arrays, and the legacy lowering to ``make_plan``'s plan;
* the six in-step helpers against JAX's on numpy-seeded ids and ticks,
  and the float32 combine ``p + q - p*q`` on every percent pair as the
  JAX step computes it on the CPU (one fused multiply-add);
* whole runs: the legacy twins' logs, the oracle report on the telemetry
  and the dbg basis (``scenario.json`` byte for byte), the banked chaos
  repros, the refusals, and ``--scenario`` on the CLI;
* K1's ``admit_mask`` form against the JAX ``receive_core`` and the
  Pallas kernel in interpret mode.
"""

import functools
import json
import pathlib
import random
import subprocess
import sys
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from distributed_membership_tpu.backends import get_backend as jax_backend
from distributed_membership_tpu.chaos.campaign import base_conf
from distributed_membership_tpu.chaos.fuzz import CampaignSpec
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.ops import fused_receive as jax_receive
from distributed_membership_tpu.runtime import application as jax_app
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu.scenario import compile as jax_compile
from distributed_membership_tpu.scenario import schema as jax_schema
from distributed_membership_tpu.sweeps.fleet_submit import override_conf
from distributed_membership_tpu_torch import kernels
from distributed_membership_tpu_torch.backends import get_backend
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.ops.fused_receive import (
    receive_core, receive_fused)
from distributed_membership_tpu_torch.ops.view_merge import STRIDE
from distributed_membership_tpu_torch.runtime import application
from distributed_membership_tpu_torch.runtime import failures
from distributed_membership_tpu_torch.scenario import compile as comp
from distributed_membership_tpu_torch.scenario import schema

from test_torch_kernels import _bits, _eq, _receive_inputs
from test_torch_scenario_steps import mixed_events, write_scenario

REPO = pathlib.Path(__file__).resolve().parent.parent
TESTDIR = REPO / "testcases"
SCNDIR = REPO / "scenarios"
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(text: str):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JaxParams.from_text(text), Params.from_text(text)


# ---------------------------------------------------------------------------
# Schema

BAD_SCHEDULES = [
    [{"kind": "nope", "time": 1}],
    [{"kind": "crash", "time": 200, "nodes": [1]}],
    [{"kind": "crash", "time": 10}],
    [{"kind": "crash", "time": 10, "nodes": [99]}],
    [{"kind": "crash", "time": 10, "range": [4, 2]}],
    [{"kind": "crash", "time": 10, "draw": "most"}],
    [{"kind": "restart", "time": 10, "draw": "single"}],
    [{"kind": "partition", "start": 5, "stop": 20,
      "groups": [[0, 32], [40, 64]]}],
    [{"kind": "partition", "start": 5, "stop": 20, "groups": [[0, 64]]}],
    [{"kind": "partition", "start": 5, "stop": 20,
      "groups": [[0, 32], [32, 60]]}],
    [{"kind": "partition", "start": 5, "stop": 20,
      "groups": [[0, 32], [32, 64]]},
     {"kind": "partition", "start": 15, "stop": 30,
      "groups": [[0, 16], [16, 64]]}],
    [{"kind": "link_flake", "start": 5, "stop": 20, "src": [0, 32],
      "dst": [32, 64], "drop_prob": 2.0}],
    [{"kind": "one_way_flake", "start": 5, "stop": 20, "src": [0, 32],
      "dst": [32, 99]}],
    [{"kind": "delay_window", "start": 5, "stop": 20, "dst": [9, 3]}],
    [{"kind": "drop_window", "start": 20, "stop": 5, "drop_prob": 0.1}],
    [{"kind": "drop_window", "start": 2, "stop": 5}],
]


@pytest.mark.parametrize("events", BAD_SCHEDULES,
                         ids=[str(i) for i in range(len(BAD_SCHEDULES))])
def test_schema_refuses_as_jax(events):
    msgs = []
    for mod in (jax_schema, schema):
        with pytest.raises(ValueError) as e:
            mod.validate_scenario(mod.Scenario.from_dict(
                {"name": "x", "events": events}), n=64, total=100)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_schema_load_errors_as_jax(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"name": "e", "events": []}))
    for path in (bad, empty):
        msgs = []
        for mod in (jax_schema, schema):
            with pytest.raises(ValueError) as e:
                mod.load_scenario(str(path))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError) as a:
        jax_schema.Scenario.from_dict([])
    with pytest.raises(ValueError) as b:
        schema.Scenario.from_dict([])
    assert str(a.value) == str(b.value)
    assert schema.EVENT_KINDS == jax_schema.EVENT_KINDS


# ---------------------------------------------------------------------------
# Compile

_RING = ("MAX_NNB: {n}\nSINGLE_FAILURE: 1\nDROP_MSG: 0\nMSG_DROP_PROB: 0\n"
         "VIEW_SIZE: 16\nGOSSIP_LEN: 8\nPROBES: 4\nTFAIL: 8\nTREMOVE: 24\n"
         "TOTAL_TIME: 300\nJOIN_MODE: warm\nEXCHANGE: ring\n"
         "EVENT_MODE: agg\nBACKEND: tpu_hash\n")
INLINE = {
    "mixed": (_RING.format(n=256), mixed_events(256, 100)),
    "multi_time_crash": (_RING.format(n=64), [
        {"kind": "crash", "time": 20, "range": [0, 8]},
        {"kind": "crash", "time": 30, "nodes": [40, 9, 9]},
        {"kind": "restart", "time": 60, "range": [0, 4]},
        {"kind": "leave", "time": 90, "nodes": [10]},
        {"kind": "drop_window", "start": 30, "stop": 70,
         "drop_prob": 0.157}]),
    "draws": (_RING.format(n=64) + "RACK_SIZE: 8\nRACK_FAILURES: 2\n", [
        {"kind": "crash", "time": 20, "draw": "racks"},
        {"kind": "crash", "time": 25, "draw": "multi"},
        {"kind": "crash", "time": 30, "draw": "single"}]),
    "cuts_and_windows": (_RING.format(n=64) + "DROP_MSG: 1\n"
                         "MSG_DROP_PROB: 0.05\nDROP_START: 10\n"
                         "DROP_STOP: 90\n", [
        {"kind": "partition", "start": 10, "stop": 50,
         "groups": [[0, 16], [16, 48], [48, 64]]},
        {"kind": "partition", "start": 60, "stop": 70,
         "groups": [[0, 30], [30, 64]]},
        {"kind": "link_flake", "start": 20, "stop": 60, "src": [0, 32],
         "dst": [32, 64], "drop_prob": 0.2},
        {"kind": "one_way_flake", "start": 5, "stop": 9, "src": [0, 8],
         "dst": [8, 16]},
        {"kind": "drop_window", "start": 40, "stop": 80,
         "drop_prob": 0.1},
        {"kind": "delay_window", "start": 3, "stop": 6}]),
    "legacy_window": (_RING.format(n=64), [
        {"kind": "crash", "time": 20, "range": [4, 6]},
        {"kind": "drop_window", "start": 30, "stop": 70,
         "drop_prob": 0.33}]),
}


def _shipped():
    out = {}
    for p in sorted(SCNDIR.glob("*.json")):
        if p.stem in ("singlefailure", "multifailure",
                      "msgdropsinglefailure"):
            conf = (TESTDIR / f"{p.stem}.conf").read_text()
        else:
            conf = _RING.format(n=2048)
        out[p.stem] = (conf, str(p))
    for p in sorted((SCNDIR / "regressions").glob("*.json")):
        meta = json.loads(p.read_text())["meta"]
        out[p.stem] = (base_conf(CampaignSpec(), overrides=meta["overrides"]),
                       str(p))
    return out


SHIPPED = _shipped()


def _compile_both(conf: str, scn_path: str):
    jp, pp = _params(conf)
    jplan = jax_compile.compile_scenario(
        jax_schema.load_scenario(scn_path), jp, random.Random(f"app:{SEED}"))
    pplan = comp.compile_scenario(
        schema.load_scenario(scn_path), pp, random.Random(f"app:{SEED}"))
    return jp, pp, jplan, pplan


def _same_plan(jp, pp, jplan, pplan):
    for f in ("kind", "fail_time", "failed_indices", "drop_start",
              "drop_stop"):
        assert getattr(pplan, f) == getattr(jplan, f), f
    # The legacy lowering may carry the window in the params: same keys.
    for key in ("DROP_MSG", "MSG_DROP_PROB", "DROP_START", "DROP_STOP"):
        assert getattr(pp, key) == getattr(jp, key), key
    assert (pplan.scenario is None) == (jplan.scenario is None)
    if jplan.scenario is None:
        return
    jprog, pprog = jplan.scenario, pplan.scenario
    assert tuple(pprog.static) == tuple(jprog.static)
    for f in ("point_events", "partitions", "flakes", "drop_windows",
              "delays"):
        assert getattr(pprog, f) == getattr(jprog, f), f
    jt, pt = jprog.numpy_tensors(), pprog.numpy_tensors()
    assert pt._fields == jt._fields
    for f in jt._fields:
        a, b = getattr(pt, f), getattr(jt, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in jt._fields:
        np.testing.assert_array_equal(getattr(pprog.tensors(), f),
                                      np.asarray(getattr(jprog.tensors(), f)))


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_compile_shipped_matches_jax(name):
    conf, path = SHIPPED[name]
    _same_plan(*_compile_both(conf, path))
    assert comp.scenario_digest(path) == jax_compile.scenario_digest(path)


@pytest.mark.parametrize("name", sorted(INLINE))
def test_compile_inline_matches_jax(tmp_path, name):
    conf, events = INLINE[name]
    jp, pp, jplan, pplan = _compile_both(
        conf, write_scenario(tmp_path, events, name))
    _same_plan(jp, pp, jplan, pplan)
    if name == "legacy_window":
        # One crash time + one window: the legacy plan, the window moved
        # into the params.
        assert pplan.scenario is None and pp.DROP_MSG == 1
        assert pp.MSG_DROP_PROB == 0.33
    if pplan.scenario is not None:
        forced = comp.compile_scenario(
            schema.Scenario.from_dict({"events": events}), pp,
            random.Random(f"app:{SEED}"), force_general=True)
        assert forced.scenario is not None


@pytest.mark.parametrize("case", ["singlefailure", "multifailure",
                                  "msgdropsinglefailure"])
def test_legacy_lowering_is_make_plan(case):
    """A testcase's scenario twin lowers to the plan ``make_plan`` draws
    from the same seeded stream."""
    conf = (TESTDIR / f"{case}.conf").read_text()
    _, pp = _params(conf)
    want = failures.make_plan(pp, random.Random(f"app:{SEED}"))
    _, pp = _params(conf + f"SCENARIO: {SCNDIR / (case + '.json')}\n")
    got = failures.resolve_plan(pp, random.Random(f"app:{SEED}"))
    assert got == want


def test_general_path_refused_on_other_backends(tmp_path):
    path = write_scenario(tmp_path, [
        {"kind": "partition", "start": 5, "stop": 20,
         "groups": [[0, 5], [5, 10]]}])
    conf = ("MAX_NNB: 10\nSINGLE_FAILURE: 1\nDROP_MSG: 0\nMSG_DROP_PROB: 0\n"
            f"TOTAL_TIME: 60\nSCENARIO: {path}\nBACKEND: tpu_sparse\n")
    jp, pp = _params(conf)
    msgs = []
    for mod, p in ((jax_failures, jp), (failures, pp)):
        with pytest.raises(ValueError) as e:
            mod.resolve_plan(p, random.Random("app:0"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "general tensor-plan path" in msgs[0]


# ---------------------------------------------------------------------------
# In-step helpers

def _helper_program():
    conf, events = INLINE["cuts_and_windows"]
    events = events + [
        {"kind": "crash", "time": 12, "range": [3, 9]},
        {"kind": "restart", "time": 12, "range": [30, 34]},
        {"kind": "leave", "time": 44, "nodes": [60, 61]},
        {"kind": "link_flake", "start": 30, "stop": 45, "src": [16, 64],
         "dst": [0, 40], "drop_prob": 0.11},
        {"kind": "drop_window", "start": 25, "stop": 50,
         "drop_prob": 0.02},
        {"kind": "delay_window", "start": 40, "stop": 47,
         "dst": [10, 20]}]
    jp, pp = _params(conf)
    jplan = jax_compile.compile_scenario(
        jax_schema.Scenario.from_dict({"events": events}), jp,
        random.Random("app:0"))
    pplan = comp.compile_scenario(
        schema.Scenario.from_dict({"events": events}), pp,
        random.Random("app:0"))
    return jplan.scenario, pplan.scenario


def _np(x, shape=None):
    if x is None:
        return np.zeros(shape, bool)
    if isinstance(x, float):
        return np.full(shape, x, np.float32)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_helpers_match_jax():
    jprog, pprog = _helper_program()
    jt, pt, static = jprog.tensors(), pprog.tensors(), pprog.static
    n = 64
    rng = np.random.default_rng(11)
    src = rng.integers(0, n, size=(96, 1))
    dst = rng.integers(0, n, size=(1, 40))
    ids = np.arange(n)
    jsite = jax.jit(functools.partial(jax_compile.site_drop_prob, static))
    jcross = jax.jit(jax_compile.cross_group)
    seen_flake = seen_cut = 0
    for t in range(-1, 100):
        down, up = comp.updown_masks(pt, t, torch.from_numpy(ids))
        jdown, jup = jax_compile.updown_masks(jt, t, jnp.asarray(ids))
        np.testing.assert_array_equal(_np(down, (n,)), np.asarray(jdown))
        np.testing.assert_array_equal(_np(up, (n,)), np.asarray(jup))
        cuts = comp.cuts_at(pt, t, n)
        jcuts = np.asarray(jax_compile.cuts_at(jt, t, n))
        np.testing.assert_array_equal(cuts, jcuts)
        cross = comp.cross_group(cuts, torch.from_numpy(src),
                                 torch.from_numpy(dst))
        np.testing.assert_array_equal(
            cross.numpy(), np.asarray(jcross(jcuts, src, dst)))
        seen_cut += comp.cut_active(cuts, n)
        held = comp.delayed_mask(pt, t, torch.from_numpy(ids))
        np.testing.assert_array_equal(
            _np(held, (n,)),
            np.asarray(jax_compile.delayed_mask(jt, t, jnp.asarray(ids))))
        assert comp.base_drop_prob(pt, t) == float(
            jax_compile.base_drop_prob(jt, t))
        p = comp.site_drop_prob(static, pt, t, torch.from_numpy(src),
                                torch.from_numpy(dst))
        want = np.asarray(jsite(jt, t, src, dst))
        got = _np(p, want.shape)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        seen_flake += not isinstance(p, float)
    assert seen_flake and seen_cut


def test_combine_is_the_jax_steps_fused_multiply_add():
    """Inside the jitted JAX step XLA on the CPU contracts ``p + q - p*q``
    into one fused multiply-add: the port's combine reproduces it on every
    percent pair, and the pairs where it differs from two roundings
    (e.g. 0.02 and 0.11) are pinned; 0.07 and 0.13 round alike."""
    pct = [float(np.float32(k / 100)) for k in range(101)]
    p = np.asarray([[a] * 101 for a in pct], np.float32)
    q = np.ascontiguousarray(p.T)
    want = np.asarray(jax.jit(lambda a, b: a + b - a * b)(p, q))
    got = np.asarray([[comp.combine_prob(a, b) for b in pct] for a in pct],
                     np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    two = (p + q) - p * q
    assert (got != two).sum() > 1000
    f32 = np.float32
    assert comp.combine_prob(float(f32(0.02)), float(f32(0.11))) != float(
        (f32(0.02) + f32(0.11)) - f32(0.02) * f32(0.11))
    assert comp.combine_prob(float(f32(0.07)), float(f32(0.13))) == float(
        (f32(0.07) + f32(0.13)) - f32(0.07) * f32(0.13))
    assert comp.combine_prob(0.25, 0.0) == 0.25


def test_host_twin_matches_jax():
    jprog, pprog = _helper_program()
    jh, ph = jprog.host(), pprog.host()
    for t in range(0, 95, 3):
        assert ph.down_at(t) == jh.down_at(t)
        assert ph.up_at(t) == jh.up_at(t)
        for a, b in ((0, 20), (20, 50), (5, 10), (50, 63), (40, 3)):
            assert ph.blocked(t, a, b) == jh.blocked(t, a, b)
            assert ph.drop_pct(t, a, b) == jh.drop_pct(t, a, b)
            assert ph.delayed(t, b) == jh.delayed(t, b)


# ---------------------------------------------------------------------------
# Whole runs

def _run(tmp_path, conf_text, which, seed=SEED, **kw):
    conf = tmp_path / f"{which}.conf"
    conf.write_text(conf_text)
    out = str(tmp_path / which)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if which.startswith("jax"):
            return jax_app.run_conf(str(conf), seed=seed, out_dir=out, **kw)
        return application.run_conf(str(conf), seed=seed, out_dir=out,
                                    device="cpu", **kw)


def _same_logs(tmp_path, a, b):
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        assert ((tmp_path / a / name).read_bytes()
                == (tmp_path / b / name).read_bytes()), name


@pytest.mark.parametrize("case", ["singlefailure", "multifailure",
                                  "msgdropsinglefailure"])
def test_legacy_twin_logs_match_jax_and_the_conf(tmp_path, case):
    """The testcase with its scenario twin: logs byte-identical to the JAX
    package's twin run and to the port's plain ``.conf`` run."""
    conf = (TESTDIR / f"{case}.conf").read_text()
    scn = str(SCNDIR / f"{case}.json")
    _run(tmp_path, conf, "jax", backend="tpu_hash", scenario=scn)
    res = _run(tmp_path, conf, "port", backend="tpu_hash", scenario=scn)
    _run(tmp_path, conf, "port_conf", backend="tpu_hash")
    assert "scenario_report" not in res.extra
    _same_logs(tmp_path, "port", "jax")
    _same_logs(tmp_path, "port", "port_conf")


_ORACLE = ("MAX_NNB: {n}\nSINGLE_FAILURE: 1\nDROP_MSG: 0\nMSG_DROP_PROB: 0\n"
           "VIEW_SIZE: {s}\nGOSSIP_LEN: {g}\nPROBES: {p}\nFANOUT: 3\n"
           "TFAIL: 16\nTREMOVE: 40\nTOTAL_TIME: 120\nJOIN_MODE: warm\n"
           "EXCHANGE: ring\n")
ORACLE_TWINS = {
    "natural": _ORACLE.format(n=256, s=128, g=32, p=16)
    + "BACKEND: tpu_hash\nEVENT_MODE: agg\nTELEMETRY: scalars\n",
    "folded": _ORACLE.format(n=256, s=16, g=4, p=2)
    + "BACKEND: tpu_hash\nEVENT_MODE: agg\nFOLDED: 1\nTELEMETRY: hist\n",
    "sharded": _ORACLE.format(n=256, s=128, g=32, p=16)
    + "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8\nEVENT_MODE: agg\n"
    "TELEMETRY: hist\n",
    "sharded_folded": _ORACLE.format(n=512, s=16, g=4, p=2)
    + "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8\nEVENT_MODE: agg\n"
    "FOLDED: 1\nTELEMETRY: scalars\n",
}


def _oracle_events(n):
    return [{"kind": "partition", "start": 20, "stop": 60,
             "groups": [[0, n // 3], [n // 3, n]]},
            {"kind": "crash", "time": 10, "range": [40, 46]},
            {"kind": "restart", "time": 70, "range": [40, 43]},
            {"kind": "link_flake", "start": 65, "stop": 80,
             "src": [0, n // 2], "dst": [n // 2, n], "drop_prob": 0.2}]


@pytest.mark.parametrize("twin", list(ORACLE_TWINS))
def test_oracle_telemetry_basis_matches_jax(tmp_path, twin):
    """An agg run with TELEMETRY: the oracle report equals the JAX
    package's, and scenario.json, timeline.jsonl and summary.json are
    byte-identical."""
    conf = ORACLE_TWINS[twin]
    n = int(conf.split("MAX_NNB: ")[1].split("\n")[0])
    path = write_scenario(tmp_path, _oracle_events(n), "oracle")
    conf += f"SCENARIO: {path}\n"
    dirs = {w: tmp_path / f"rec_{w}" for w in ("jax", "port")}
    res = {w: _run(tmp_path, conf, w, telemetry_dir=str(dirs[w]))
           for w in dirs}
    want = res["jax"].extra["scenario_report"]
    got = res["port"].extra["scenario_report"]
    assert got == want
    assert got["basis"] == "telemetry" and got["partitions"]
    assert got["partitions"][0]["removals_during"] > 0
    assert [r["rejoined"] for r in got["restarts"]] == [True]
    for name in ("scenario.json", "timeline.jsonl", "summary.json"):
        assert ((dirs["port"] / name).read_bytes()
                == (dirs["jax"] / name).read_bytes()), name


def test_oracle_dbg_basis_matches_jax(tmp_path):
    """A full-event run without TELEMETRY grades from dbg.log: the report
    and the logs equal the JAX package's."""
    conf = _ORACLE.format(n=256, s=128, g=32, p=16) + "BACKEND: tpu_hash\n"
    path = write_scenario(tmp_path, _oracle_events(256), "oracle")
    conf += f"SCENARIO: {path}\n"
    want = _run(tmp_path, conf, "jax").extra["scenario_report"]
    got = _run(tmp_path, conf, "port").extra["scenario_report"]
    assert got == want and got["basis"] == "dbg"
    assert got["partitions"][0]["reconverge_basis"] == "churn"
    _same_logs(tmp_path, "port", "jax")


@pytest.mark.parametrize("repro", sorted(
    p.name for p in (SCNDIR / "regressions").glob("repro-*.json")))
def test_banked_repros_reproduce_their_violations(repro):
    """The chaos campaign's banked repros, on the conf ``base_conf`` builds
    from their recorded overrides and seed: the port's report equals the
    JAX package's and carries the banked violations."""
    path = SCNDIR / "regressions" / repro
    meta = json.loads(path.read_text())["meta"]
    conf = override_conf(base_conf(CampaignSpec(),
                                   overrides=meta["overrides"]),
                         "SCENARIO", str(path))
    jp, pp = _params(conf)
    want = jax_backend(jp.BACKEND)(jp, seed=meta["seed"]).extra[
        "scenario_report"]
    got = get_backend(pp.BACKEND)(pp, seed=meta["seed"], device="cpu").extra[
        "scenario_report"]
    assert got == want
    assert set(meta["violations"]) <= set(got["violations"])
    assert not got["ok"]


_GATE = ("MAX_NNB: 256\nSINGLE_FAILURE: 1\nDROP_MSG: 0\nMSG_DROP_PROB: 0\n"
         "VIEW_SIZE: 128\nGOSSIP_LEN: 32\nPROBES: 16\nFANOUT: 3\nTFAIL: 16\n"
         "TREMOVE: 40\nTOTAL_TIME: 40\n")
REFUSALS = {
    "scatter": "MAX_NNB: 10\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
    "MSG_DROP_PROB: 0\nTOTAL_TIME: 40\nBACKEND: tpu_hash\n",
    "enforce_buffsize": _GATE + "JOIN_MODE: warm\nEXCHANGE: ring\n"
    "BACKEND: tpu_hash\nENFORCE_BUFFSIZE: 1\n",
    "cold_sharded": _GATE + "JOIN_MODE: staggered\nEXCHANGE: ring\n"
    "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8\n",
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_jax(tmp_path, case):
    path = write_scenario(tmp_path, [
        {"kind": "partition", "start": 5, "stop": 20,
         "groups": [[0, 5], [5, 10]]},
        {"kind": "crash", "time": 3, "range": [6, 7]},
        {"kind": "restart", "time": 9, "range": [6, 7]}])
    conf = REFUSALS[case] + f"SCENARIO: {path}\n"
    jp, pp = _params(conf)
    with pytest.raises(ValueError) as want:
        jax_backend(jp.BACKEND)(jp, seed=0)
    with pytest.raises(ValueError) as got:
        get_backend(pp.BACKEND)(pp, seed=0, device="cpu")
    assert str(got.value) == str(want.value)


def test_checkpoint_with_scenario_names_its_item(tmp_path):
    """Queue 1 item 4 is ported: a scenario run with CHECKPOINT_EVERY
    (segments of 10 ticks) gives the unchunked run's logs and report."""
    path = write_scenario(tmp_path, _oracle_events(256))
    text = (_GATE.replace("TOTAL_TIME: 40", "TOTAL_TIME: 90")
            + "JOIN_MODE: warm\nEXCHANGE: ring\nBACKEND: tpu_hash\n"
            f"SCENARIO: {path}\n")
    runs = [get_backend("tpu_hash")(_params(text + extra)[1], seed=0,
                                    device="cpu")
            for extra in ("", "CHECKPOINT_EVERY: 10\n")]
    assert runs[1].log.dbg_text() == runs[0].log.dbg_text()
    assert runs[1].extra["scenario_report"] == runs[0].extra[
        "scenario_report"]


def test_cli_scenario_flag_wins_over_the_conf(tmp_path):
    """``--scenario FILE`` overrides the conf's SCENARIO, and ``--json``
    prints the oracle report under ``scenario``: the JAX package's report
    for the same override."""
    conf_text = (_ORACLE.format(n=64, s=16, g=4, p=2).replace(
        "TOTAL_TIME: 120", "TOTAL_TIME: 80")
        + "BACKEND: tpu_hash\nEVENT_MODE: agg\nTELEMETRY: scalars\n"
        f"SCENARIO: {SCNDIR / 'singlefailure.json'}\n")
    conf = tmp_path / "ring.conf"
    conf.write_text(conf_text)
    scn = write_scenario(tmp_path, _oracle_events(64), "flag")
    want = _run(tmp_path, conf_text, "jax", scenario=scn).extra
    out = subprocess.run(
        [sys.executable, "-m", "distributed_membership_tpu_torch", str(conf),
         "--json", "--scenario", scn, "--seed", str(SEED), "--device",
         "cpu", "--out-dir", str(tmp_path / "cli")],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["scenario"] == json.loads(json.dumps(
        want["scenario_report"]))
    assert got["scenario"]["scenario"] == "flag"
    assert got["detection"] == json.loads(json.dumps(
        want["detection_summary"]))


# ---------------------------------------------------------------------------
# K1's admit_mask form

@pytest.fixture
def no_launch():
    kernels.reset_launches()
    yield
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES


@pytest.mark.parametrize("n,t", [(64, 9), (64, 45), (256, 60)])
def test_receive_admit_matches_jax(n, t, no_launch):
    """The plain version and the wrapper (CPU tensors) with an admit plane
    equal the JAX ``receive_core`` and the Pallas kernel in interpret
    mode, and the mask bites (it changes the outcome on the same state)."""
    s = 128
    view, view_ts, mail, cand, recv, act, self_on, spack = \
        _receive_inputs(n, t, seed=7 * n + t)
    admit = np.random.default_rng(n + t).random((n, s)) < 0.5
    jargs = (jnp.asarray(t, jnp.int32), view, view_ts, mail, cand, recv,
             act, self_on, spack, jnp.arange(n, dtype=jnp.int32))
    ref = jax_receive.receive_core(n, s, 16, 40, STRIDE, *jargs,
                                   admit_mask=jnp.asarray(admit))
    pallas = jax_receive.receive_fused(n, s, 16, 40, STRIDE, True, *jargs,
                                       admit_mask=jnp.asarray(admit))
    args = (_bits(view), torch.from_numpy(view_ts), _bits(mail),
            _bits(cand), torch.from_numpy(recv), torch.from_numpy(act),
            torch.from_numpy(self_on), _bits(spack))
    plane = torch.from_numpy(admit.astype(np.int32))
    names = ("view", "view_ts", "mail", "join", "rm_ids", "numfailed",
             "size")
    for fn in (receive_core, receive_fused):
        got = fn(n, s, 16, 40, STRIDE, t, *(a.clone() for a in args),
                 admit_mask=plane)
        for name, g, w, p in zip(names, got, ref, pallas):
            _eq(g, w, f"{fn.__name__}: {name}")
            _eq(g, p, f"{fn.__name__} vs pallas: {name}")
    open_ = receive_core(n, s, 16, 40, STRIDE, t, *(a.clone() for a in args))
    assert not torch.equal(open_[0], got[0])
    assert (open_[3] & ~got[3]).any()        # joins the mask suppressed
    # The mailbox clears where the row receives, admitted or not.
    assert torch.equal(open_[2], got[2])


def test_receive_admit_wrapper_checks_the_plane():
    n, s = 64, 128
    view, view_ts, mail, cand, recv, act, self_on, spack = \
        _receive_inputs(n, 5, seed=2)
    args = (_bits(view), torch.from_numpy(view_ts), _bits(mail),
            _bits(cand), torch.from_numpy(recv), torch.from_numpy(act),
            torch.from_numpy(self_on), _bits(spack))
    for bad in (torch.ones((n, s), dtype=torch.bool),
                torch.ones((n, s - 1), dtype=torch.int32),
                torch.ones((s, n), dtype=torch.int32).t()):
        with pytest.raises(ValueError, match="receive"):
            receive_fused(n, s, 16, 40, STRIDE, 5, *args, admit_mask=bad)
