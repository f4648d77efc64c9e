"""The folded layout's AggStats route against the JAX natural step.

On the card an S < 128 ring run in EVENT_MODE agg with more than
FAST_AGG_MAX_FAILED (8) failed ids takes the folded layout under
``FOLDED: -1`` and folds its events into AggStats on the planes' ``[N, S]``
view (backends/tpu_hash_folded.py).  The JAX package has no such route:
it runs that config on its natural layout.  Here the folded step is built
directly on the CPU (the CPU's auto resolves natural) and held against
the JAX natural step at N=512, S=16 under a scenario that leaves 12
permanently failed ids, with ``TELEMETRY: scalars``:

* per tick, from one warm state: every state leaf (the folded planes
  reshaped to ``[N, S]``, the AggStats leaves) and every event total;
* the whole run through the backend: the detection summary, the final
  state, every timeline series and the oracle report;
* the gates: a pinned ``FOLDED: 1`` raises the JAX ``ValueError``, word
  for word; ``FOLDED: -1`` resolves natural on the CPU and folded on CUDA.

Tolerance 0.
"""

import dataclasses
import json
import random
import warnings

import numpy as np
import pytest
import torch

import jax

from distributed_membership_tpu.backends import get_backend as jax_backend
from distributed_membership_tpu.backends import tpu_hash as jax_hash
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch.backends import get_backend, tpu_hash
from distributed_membership_tpu_torch.backends.tpu_hash_folded import (
    init_state_warm_folded, make_folded_step)
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import state_to_numpy
from distributed_membership_tpu_torch.observability.aggregates import (
    AggStats)
from distributed_membership_tpu_torch.runtime import failures

from test_torch_step import _first_mismatch, _jax_leaves

SEED = 3
N, TICKS = 512, 60
CONF = (f"MAX_NNB: {N}\nSINGLE_FAILURE: 0\nVIEW_SIZE: 16\nGOSSIP_LEN: 4\n"
        "PROBES: 4\nFANOUT: 3\nTFAIL: 8\nTREMOVE: 20\n"
        f"TOTAL_TIME: {TICKS}\nJOIN_MODE: warm\nEXCHANGE: ring\n"
        "EVENT_MODE: agg\nTELEMETRY: scalars\nBACKEND: tpu_hash\n")
# 12 permanent crashes (two ranges), a crash/restart pair, a partition, a
# link flake and a delay window.
EVENTS = [
    {"kind": "crash", "time": 6, "range": [40, 48]},
    {"kind": "crash", "time": 9, "range": [300, 304]},
    {"kind": "crash", "time": 4, "range": [100, 106]},
    {"kind": "restart", "time": 24, "range": [100, 106]},
    {"kind": "partition", "start": 14, "stop": 26,
     "groups": [[0, 200], [200, N]]},
    {"kind": "link_flake", "start": 10, "stop": 40, "src": [0, 256],
     "dst": [256, N], "drop_prob": 0.1},
    {"kind": "delay_window", "start": 30, "stop": 36, "dst": [60, 90]},
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores (tests/test_torch_step.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def conf(tmp_path):
    path = tmp_path / "churn.json"
    path.write_text(json.dumps({"name": "churn", "events": EVENTS}))
    return CONF + f"SCENARIO: {path}\n"


def _params(text):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JaxParams.from_text(text), Params.from_text(text)


def test_folded_aggstats_step_matches_jax_every_tick(conf):
    jp, pp = _params(conf)
    jplan = jax_failures.resolve_plan(jp, random.Random(f"app:{SEED}"))
    pplan = failures.resolve_plan(pp, random.Random(f"app:{SEED}"))
    assert pplan.failed_indices == jplan.failed_indices
    assert len(pplan.failed_indices) == 12
    static = jplan.scenario.static
    jcfg = jax_hash.make_config(jp, False,
                                fail_ids=jax_hash.plan_fail_ids(jplan),
                                scenario=static)
    cfg = tpu_hash.make_config(pp, False,
                               fail_ids=tpu_hash.plan_fail_ids(pplan),
                               device="cpu",
                               scenario=tpu_hash.plan_scenario(pplan))
    assert not (jcfg.folded or jcfg.fast_agg)
    assert not (cfg.folded or cfg.fast_agg) and cfg.telemetry
    cfg = dataclasses.replace(cfg, folded=True)
    jstep = jax.jit(jax_hash.make_step(jcfg))
    jstate = jax_hash.init_state_warm(
        jcfg, jax_failures.make_run_key(jp, SEED ^ 0x5EED))
    pstep = make_folded_step(cfg)
    pstate = init_state_warm_folded(
        cfg, failures.make_run_key(pp, SEED ^ 0x5EED), "cpu")
    assert isinstance(pstate.agg, AggStats)
    assert pstate.view.shape == (N * 16 // 128, 128)
    inputs = jax_failures.plan_tensors(jp, jplan, SEED, TICKS)
    extra = (jplan.scenario.tensors(),)
    plan_t = failures.plan_tensors(pp, pplan, SEED, TICKS, "cpu")
    for t in range(-1, TICKS):
        if t >= 0:
            jstate, (jout, _) = jstep(jstate, (inputs[0][t], inputs[1][t])
                                      + tuple(inputs[2:]) + extra)
            pstate, (pout, _) = pstep(pstate, t, plan_t.tick_key(t), plan_t)
            for name in pout._fields:
                _first_mismatch(t, f"events.{name}", getattr(pout, name),
                                getattr(jout, name))
        want, got = _jax_leaves(jstate), state_to_numpy(pstate)
        assert set(got) == set(want)
        for name in sorted(want):
            _first_mismatch(t, name, got[name].reshape(want[name].shape),
                            want[name])
    agg = pstate.agg
    assert int(agg.det_count.sum()) > 0 and int(agg.tracker_obs.sum()) > 0
    assert int(agg.det_obs.sum()) > 0


def _jax_run(text):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = JaxParams.from_text(text)
        return jax_backend(jp.BACKEND)(jp, seed=SEED)


def test_folded_aggstats_run_matches_jax(conf, monkeypatch):
    """The backend's whole run on the folded AggStats route (``make_config``
    resolving folded, as on the card) against the JAX natural run."""
    real = tpu_hash.make_config

    def folded(*a, **kw):
        cfg = real(*a, **kw)
        assert not cfg.fast_agg
        return dataclasses.replace(cfg, folded=True)
    monkeypatch.setattr(tpu_hash, "make_config", folded)
    want = _jax_run(conf)
    _, pp = _params(conf)
    got = get_backend("tpu_hash")(pp, seed=SEED, device="cpu")
    assert got.extra["final_state"].view.shape == (N * 16 // 128, 128)
    assert (got.extra["detection_summary"]
            == want.extra["detection_summary"])
    assert got.extra["scenario_report"] == want.extra["scenario_report"]
    assert got.extra["scenario_report"]["ok"]
    tl, jtl = got.extra["timeline"], want.extra["timeline"]
    assert set(tl) == set(jtl)
    for k in jtl:
        np.testing.assert_array_equal(np.asarray(tl[k]), np.asarray(jtl[k]),
                                      err_msg=k)
    assert np.asarray(tl["detections"]).sum() > 0
    a = state_to_numpy(got.extra["final_state"])
    b = _jax_leaves(want.extra["final_state"])
    for k in b:
        _first_mismatch(TICKS, k, a[k].reshape(b[k].shape), b[k])
    np.testing.assert_array_equal(got.sent, np.asarray(want.sent))


def test_gates(conf):
    """A pinned FOLDED: 1 keeps the JAX ValueError, word for word; auto
    resolves natural on the CPU and folded on CUDA (the refusal-free card
    route), and stays natural for the sharded backend's config."""
    jp, pp = _params(conf + "FOLDED: 1\n")
    fail_ids = tuple(range(12))
    with pytest.raises(ValueError) as want:
        jax_hash.make_config(jp, False, fail_ids=fail_ids)
    with pytest.raises(ValueError) as got:
        tpu_hash.make_config(pp, False, fail_ids=fail_ids, device="cpu")
    assert str(got.value) == str(want.value)
    assert "FastAgg" in str(got.value)
    with pytest.raises(ValueError) as got:
        tpu_hash.make_config(pp, False, fail_ids=fail_ids, device="cuda")
    assert str(got.value) == str(want.value)
    _, pp = _params(conf)
    cpu = tpu_hash.make_config(pp, False, fail_ids=fail_ids, device="cpu")
    card = tpu_hash.make_config(pp, False, fail_ids=fail_ids, device="cuda")
    assert not cpu.folded and card.folded
    assert not (cpu.fast_agg or card.fast_agg) and card.fail_ids == ()
    # Fewer than 8 plane rows: no folded kernel launch, so the card refuses.
    _, small = _params(conf.replace(f"MAX_NNB: {N}", "MAX_NNB: 32"))
    with pytest.raises(NotImplementedError, match="at least 8 plane rows"):
        tpu_hash.make_config(small, False, fail_ids=fail_ids, device="cuda")
