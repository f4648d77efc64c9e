"""The ring-step options of the port against the JAX package, per tick.

``EVENT_MODE: agg`` with more failed ids than the FastAgg path takes (the
scatter-based ``AggStats`` update, on the ring and scatter exchanges and
the sharded ring step), ``SHIFT_SET`` (natural and folded),
``ENFORCE_BUFFSIZE`` with a budget that binds (warm and staggered joins),
and ``PROBE_IO: none|approx_lag`` (with its run-total epilogue, chunked
and resumed).  Both packages start from one state and run the same ticks
with the same keys; every leaf and event output must be equal
(tolerance 0), and a mismatch names the first divergent tick, leaf and
index.  The JAX package's ValueErrors for these knobs are raised word for
word.  Sizes stay at N <= 512 so that each multi-tick test runs in
seconds.
"""

import random
import warnings

import numpy as np
import pytest

import jax
import torch

from distributed_membership_tpu.backends import get_backend as jax_backend
from distributed_membership_tpu.backends import tpu_hash as jax_hash
from distributed_membership_tpu.backends import (
    tpu_hash_folded as jax_folded)
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch.backends import get_backend, tpu_hash
from distributed_membership_tpu_torch.backends import tpu_hash_folded
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import (
    state_from_numpy, state_to_numpy)
from distributed_membership_tpu_torch.runtime import failures

SEED = 3
_BASE = ("MAX_NNB: {n}\nSINGLE_FAILURE: {single}\nVIEW_SIZE: {s}\n"
         "GOSSIP_LEN: {g}\nPROBES: {p}\nFANOUT: 3\nTFAIL: 16\nTREMOVE: 32\n"
         "TOTAL_TIME: {total}\nFAIL_TIME: 8\nJOIN_MODE: {join}\n"
         "EXCHANGE: ring\nBACKEND: tpu_hash\nFUSED_RECEIVE: 0\n"
         "FUSED_GOSSIP: 0\nFUSED_PROBE: 0\n")


def _conf(n=256, s=128, g=32, p=16, total=60, single=1, join="warm",
          drop=0.0, extra=""):
    text = _BASE.format(n=n, s=s, g=g, p=p, total=total, single=single,
                        join=join)
    text += (f"DROP_MSG: 1\nMSG_DROP_PROB: {drop}\nDROP_START: 0\n"
             f"DROP_STOP: {total}\n" if drop else
             "DROP_MSG: 0\nMSG_DROP_PROB: 0\n")
    return text + extra


CASES = {
    # half the nodes fail: AggStats, the multi-failure testcase's shape
    "multi_agg": _conf(single=0, extra="EVENT_MODE: agg\n"),
    "multi_agg_drops": _conf(single=0, drop=0.05,
                             extra="EVENT_MODE: agg\nPROBE_IO: approx\n"),
    "shift_set2": _conf(extra="SHIFT_SET: 2\n"),
    "shift_set8_drops": _conf(drop=0.05, extra="SHIFT_SET: 8\n"),
    "shift_set64": _conf(extra="SHIFT_SET: 64\nEVENT_MODE: agg\n"),
    # a budget that binds on every tick (gossip alone sends ~20k)
    "budget_warm": _conf(extra="ENFORCE_BUFFSIZE: 1\nEN_BUFFSIZE: 9000\n"),
    "budget_drops": _conf(drop=0.05, extra="ENFORCE_BUFFSIZE: 1\n"
                          "EN_BUFFSIZE: 9000\nEVENT_MODE: agg\n"),
    "budget_staggered": _conf(join="staggered", total=80, extra=(
        "ENFORCE_BUFFSIZE: 1\nEN_BUFFSIZE: 3000\n")),
    "probe_io_none": _conf(extra="PROBE_IO: none\n"),
    "approx_lag": _conf(drop=0.05, extra="PROBE_IO: approx_lag\n"),
    "approx_lag_agg": _conf(extra="PROBE_IO: approx_lag\nEVENT_MODE: agg\n"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(conf: str):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JaxParams.from_text(conf), Params.from_text(conf)


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
    jp, pp = _params(conf)
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
    for field in ("fast_agg", "count_probe_io", "probe_io_none",
                  "probe_io_lag", "send_budget", "shift_set", "folded"):
        assert getattr(pcfg, field) == getattr(jcfg, field), field
    return jp, pp, jplan, pplan, jcfg, pcfg


def run_both(conf: str):
    """Run both steps tick by tick from one start state, comparing every
    leaf and event output after each tick; returns the last port state."""
    jp, pp, jplan, pplan, jcfg, pcfg = _setup(conf)
    ticks_n = jp.TOTAL_TIME
    folded = jcfg.folded
    jstep = jax.jit(jax_folded.make_folded_step(jcfg) if folded
                    else jax_hash.make_step(jcfg))
    inputs = jax_failures.plan_tensors(jp, jplan, SEED, ticks_n)
    ticks, keys = inputs[0], inputs[1]
    warm_key = jax_failures.make_run_key(jp, SEED ^ 0x5EED)
    if folded:
        jstate = jax_folded.init_state_warm_folded(jcfg, warm_key)
    elif jp.JOIN_MODE == "warm":
        jstate = jax_hash.init_state_warm(jcfg, warm_key)
    else:
        jstate = jax_hash.init_state(jcfg)
    pstate = state_from_numpy(_jax_leaves(jstate), device="cpu")
    pplan_t = failures.plan_tensors(pp, pplan, SEED, ticks_n, "cpu")
    pstep = (tpu_hash_folded.make_folded_step(pcfg) if folded
             else tpu_hash.make_step(pcfg))
    for t in range(ticks_n):
        jstate, jout = jstep(jstate, (ticks[t], keys[t]) + tuple(inputs[2:]))
        pstate, pout = pstep(pstate, t, pplan_t.tick_key(t), pplan_t)
        want, got = _jax_leaves(jstate), state_to_numpy(pstate)
        assert set(got) == set(want)
        for name in sorted(want):
            _first_mismatch(t, name, got[name], want[name])
        for name in pout._fields:
            _first_mismatch(t, f"events.{name}", getattr(pout, name),
                            getattr(jout, name))
    return pcfg, pstate


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax_every_tick(case):
    pcfg, pstate = run_both(CASES[case])
    if not pcfg.collect_events:
        assert int(pstate.agg.det_count.sum()) > 0
    if pcfg.probe_io_lag:
        assert pstate.wf_prev.shape == (pcfg.n,)


def test_budget_binds():
    """The budget case drops messages: its sends per tick stay at the
    cap, where the unbudgeted run sends more."""
    conf = CASES["budget_warm"]
    _, pp = _params(conf)
    got = get_backend("tpu_hash")(pp, seed=SEED, device="cpu")
    _, free = _params(conf.replace("ENFORCE_BUFFSIZE: 1", ""))
    base = get_backend("tpu_hash")(free, seed=SEED, device="cpu")
    assert got.sent.sum(0).max() <= 9000 < base.sent.sum(0).max()


@pytest.mark.parametrize("shift_set", [2, 8, 64])
def test_shift_set_folded_matches_jax(shift_set):
    """SHIFT_SET on the folded layout (S=16): the table's shifts through
    K6's plain version equal the JAX folded step's static branches."""
    conf = _conf(s=16, g=4, p=2, total=40,
                 extra=f"SHIFT_SET: {shift_set}\nEVENT_MODE: agg\n"
                 "FOLDED: 1\n")
    pcfg, _ = run_both(conf)
    assert pcfg.folded and pcfg.shift_set == shift_set


def test_probe_io_none_folded_matches_jax():
    conf = _conf(s=16, g=4, p=2, total=40, drop=0.05,
                 extra="PROBE_IO: none\nEVENT_MODE: agg\nFOLDED: 1\n")
    pcfg, _ = run_both(conf)
    assert pcfg.folded and pcfg.probe_io_none


def _same_counts(got, want):
    np.testing.assert_array_equal(got.sent, want.sent)
    np.testing.assert_array_equal(got.recv, want.recv)


def _summaries(conf: str, device="cpu"):
    jp, pp = _params(conf)
    want = jax_backend(jp.BACKEND)(jp, seed=SEED)
    got = get_backend(pp.BACKEND)(pp, seed=SEED, device=device)
    return got, want


@pytest.mark.parametrize("conf", [
    # multi-failure, natural ring (AggStats)
    _conf(single=0, total=60, extra="EVENT_MODE: agg\n"),
    # a rack of 16 ids failing at once (more than 8: AggStats)
    _conf(total=60, extra="EVENT_MODE: agg\nRACK_SIZE: 16\n"
          "RACK_FAILURES: 1\n"),
    # the scatter exchange (the grader regime) in agg mode
    _conf(n=128, s=64, g=16, p=8, total=60, join="staggered", single=0,
          extra="EVENT_MODE: agg\n").replace("EXCHANGE: ring",
                                             "EXCHANGE: scatter"),
    # the sharded ring step on eight shards, unchunked and chunked
    _conf(single=0, total=60, extra="EVENT_MODE: agg\n").replace(
        "BACKEND: tpu_hash", "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8"),
    _conf(single=0, total=60, extra="EVENT_MODE: agg\nCHECKPOINT_EVERY: "
          "20\n").replace("BACKEND: tpu_hash",
                          "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8"),
], ids=["multi", "rack16", "scatter", "sharded8", "sharded8_chunked"])
def test_aggstats_summary_matches_jax(conf):
    got, want = _summaries(conf)
    assert got.extra["detection_summary"] == want.extra["detection_summary"]
    _same_counts(got, want)
    assert got.extra["detection_summary"]["failed_nodes"] > 8


@pytest.mark.parametrize("extra", [
    "EVENT_MODE: agg\n", "", "EVENT_MODE: agg\nCHECKPOINT_EVERY: 20\n",
    "CHECKPOINT_EVERY: 20\n"], ids=["agg", "full", "agg_chunked",
                                    "full_chunked"])
def test_approx_lag_runs_match_jax(extra):
    """approx_lag's run totals, with the epilogue on the unchunked run
    and after the last segment of a chunked one, equal the JAX
    package's, and the run totals equal exact mode's."""
    conf = _conf(drop=0.05, extra="PROBE_IO: approx_lag\n" + extra)
    got, want = _summaries(conf)
    _same_counts(got, want)
    assert got.log.dbg_text() == want.log.dbg_text()
    if "agg" in extra:
        assert (got.extra["detection_summary"]
                == want.extra["detection_summary"])
    exact, _ = _summaries(conf.replace("approx_lag", "exact"))
    assert (got.sent.sum(), got.recv.sum()) == (exact.sent.sum(),
                                                exact.recv.sum())


@pytest.mark.parametrize("tier", ["scalars", "hist"])
def test_approx_lag_timeline_matches_jax(tier):
    """The flight recorder's series under approx_lag equal the JAX
    package's: the lagged counters per tick, no epilogue in them."""
    got, want = _summaries(_conf(drop=0.05, extra=(
        f"PROBE_IO: approx_lag\nEVENT_MODE: agg\nTELEMETRY: {tier}\n")))
    a, b = got.extra["timeline"], want.extra["timeline"]
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_approx_lag_resume_finds_run_complete(tmp_path):
    """A resume that finds the run complete applies the epilogue once,
    in both packages: the same logs as the uninterrupted run."""
    ck = tmp_path / "ck"
    conf = _conf(drop=0.05, extra="PROBE_IO: approx_lag\nEVENT_MODE: agg\n"
                 f"CHECKPOINT_EVERY: 20\nCHECKPOINT_DIR: {ck}\n")
    first, _ = _summaries(conf)
    again, want = _summaries(conf + "RESUME: 1\n")
    for got in (first, again):
        assert (got.extra["detection_summary"]
                == want.extra["detection_summary"])
        _same_counts(got, want)


_GATES = {
    "shift_set_scatter": _conf(extra="SHIFT_SET: 4\n").replace(
        "EXCHANGE: ring", "EXCHANGE: scatter"),
    "shift_set_sharded": _conf(extra="SHIFT_SET: 4\n").replace(
        "BACKEND: tpu_hash", "BACKEND: tpu_hash_sharded"),
    "shift_set_fused": _conf(extra="SHIFT_SET: 4\n").replace(
        "FUSED_GOSSIP: 0", "FUSED_GOSSIP: 1"),
    "shift_set_ge_n": _conf(n=32, extra="SHIFT_SET: 32\n"),
    "budget_scatter": _conf(extra="ENFORCE_BUFFSIZE: 1\n").replace(
        "EXCHANGE: ring", "EXCHANGE: scatter"),
    "budget_sharded": _conf(extra="ENFORCE_BUFFSIZE: 1\n").replace(
        "BACKEND: tpu_hash", "BACKEND: tpu_hash_sharded"),
    "budget_folded": _conf(s=16, g=4, p=2, extra="ENFORCE_BUFFSIZE: 1\n"
                           "EVENT_MODE: agg\nFOLDED: 1\n"),
    "budget_fused": _conf(extra="ENFORCE_BUFFSIZE: 1\n").replace(
        "FUSED_GOSSIP: 0", "FUSED_GOSSIP: 1"),
    "lag_scatter": _conf(extra="PROBE_IO: approx_lag\n").replace(
        "EXCHANGE: ring", "EXCHANGE: scatter"),
    "lag_sharded": _conf(extra="PROBE_IO: approx_lag\n").replace(
        "BACKEND: tpu_hash", "BACKEND: tpu_hash_sharded"),
}


@pytest.mark.parametrize("case", list(_GATES))
def test_gates_raise_as_jax(case):
    """Each JAX ValueError of these knobs, word for word, from the
    config (the sharded backend's through its own config)."""
    from distributed_membership_tpu.backends import (
        tpu_hash_sharded as jax_sh)
    from distributed_membership_tpu_torch.backends import (
        tpu_hash_sharded as sh)
    jp, pp = _params(_GATES[case])
    if jp.BACKEND == "tpu_hash_sharded":
        with pytest.raises(ValueError) as want:
            jax_sh.sharded_config(jp, True, (3,), None, 32)
        with pytest.raises(ValueError) as got:
            sh.sharded_config(pp, True, (3,), 32, device="cpu")
    else:
        collect = "agg" not in _GATES[case]
        with pytest.raises(ValueError) as want:
            jax_hash.make_config(jp, collect, fail_ids=(3,))
        with pytest.raises(ValueError) as got:
            tpu_hash.make_config(pp, collect, fail_ids=(3,), device="cpu")
    assert str(got.value) == str(want.value)


def test_approx_lag_on_the_folded_layout_raises_as_jax():
    conf = _conf(s=16, g=4, p=2, extra="PROBE_IO: approx_lag\n"
                 "EVENT_MODE: agg\nFOLDED: 1\n")
    jp, pp = _params(conf)
    with pytest.raises(ValueError) as want:
        jax_backend("tpu_hash")(jp, seed=0)
    with pytest.raises(ValueError) as got:
        get_backend("tpu_hash")(pp, seed=0, device="cpu")
    assert str(got.value) == str(want.value)


_RESUMES = {
    # approx_lag's wf_prev leaf and its epilogue after the resume
    "approx_lag": _conf(drop=0.05, extra="PROBE_IO: approx_lag\n"
                        "EVENT_MODE: agg\n"),
    # the AggStats leaves on the natural ring and on eight shards
    "multi": _conf(single=0, extra="EVENT_MODE: agg\n"),
    "multi_sharded8": _conf(single=0, extra="EVENT_MODE: agg\n").replace(
        "BACKEND: tpu_hash", "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8"),
}


@pytest.mark.parametrize("name", list(_RESUMES))
@pytest.mark.parametrize("killer,resumer", [("jax", "port"),
                                            ("port", "jax")],
                         ids=["jax_to_port", "port_to_jax"])
def test_resume_across_packages(name, killer, resumer, tmp_path):
    """Killed at tick 30 in one package (20-tick segments) and resumed in
    the other: the AggStats and wf_prev leaves travel in the JAX flatten
    order, and the run ends as the JAX package's uninterrupted run."""
    import os

    from distributed_membership_tpu.runtime import application as jax_app
    from distributed_membership_tpu_torch.runtime import application
    from distributed_membership_tpu_torch.runtime import checkpoint as ck

    path = tmp_path / "run.conf"
    path.write_text(_RESUMES[name])

    def run(pkg, out, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if pkg == "jax":
                return jax_app.run_conf(str(path), seed=SEED,
                                        out_dir=str(out), **kw)
            return application.run_conf(str(path), seed=SEED,
                                        out_dir=str(out), device="cpu", **kw)

    want = run("jax", tmp_path / "ref")
    ckdir = str(tmp_path / "ck")
    os.environ[ck.CRASH_ENV] = "30"
    try:
        with pytest.raises(RuntimeError, match="injected crash"):
            run(killer, tmp_path / "killed", checkpoint_every=20,
                checkpoint_dir=ckdir)
    finally:
        del os.environ[ck.CRASH_ENV]
    got = run(resumer, tmp_path / "resumed", checkpoint_every=20,
              checkpoint_dir=ckdir, resume=True)
    assert (got.extra["detection_summary"]
            == want.extra["detection_summary"])
    _same_counts(got, want)
