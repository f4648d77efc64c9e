"""The port's phase sweep (``distributed_membership_tpu_torch.sweeps.phase``)
and dynamic-knob steps against the JAX package's (tolerance 0).

* ``run_sweep`` on JAX ``test_quick_grid``'s spec (N=256, S=32, fanouts
  2 and 5, drops 0 and 0.2, seeds 0 and 1, 100 ticks): every record
  equals the JAX ``run_sweep``'s, field for field, on the ring and the
  scatter exchange, and on the folded layout's AggStats route (the
  card's route at S < 128, built here on the CPU).
* The dynamic-knob step at ``(cfg.fanout, cfg.drop_prob)`` equals the
  static step per tick (natural, folded, scatter), as JAX
  ``test_dynamic_knobs_match_static_config`` pins; at another cell it
  equals the JAX dynamic-knob step per tick.
* ``summarize`` and ``write_artifacts`` write the JAX package's files; the
  CLI writes under ``--out``; ``PROBE_IO approx_lag`` is refused with the
  JAX message.
"""

import dataclasses
import warnings

import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_membership_tpu.backends import tpu_hash as jax_hash
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.sweeps import phase as jax_phase
from distributed_membership_tpu_torch.backends import tpu_hash
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import state_to_numpy
from distributed_membership_tpu_torch.runtime.failures import (
    PlanTensors, make_run_key)
from distributed_membership_tpu_torch.sweeps import phase

from test_torch_step import _first_mismatch, _jax_leaves

QUICK = dict(n=256, fanouts=(2, 5), drop_rates=(0.0, 0.2), seeds=(0, 1),
             ticks=100, fail_time=50)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores (tests/test_torch_step.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_records():
    """The JAX ``run_sweep`` records of the quick grid on each exchange."""
    return {ex: jax_phase.run_sweep(jax_phase.SweepSpec(exchange=ex,
                                                        **QUICK))
            for ex in ("ring", "scatter")}


def _folded_config(monkeypatch):
    """``make_config`` of the sweep with the folded layout on, as the card
    resolves ``FOLDED: -1`` for S < 128 (the CPU's auto stays natural)."""
    real = tpu_hash.make_config

    def folded(*a, **kw):
        return dataclasses.replace(real(*a, **kw), folded=True)
    monkeypatch.setattr(phase, "make_config", folded)


@pytest.mark.parametrize("layout", ["ring", "scatter", "folded"])
def test_records_match_jax(layout, jax_records, monkeypatch):
    exchange = "scatter" if layout == "scatter" else "ring"
    if layout == "folded":
        _folded_config(monkeypatch)
    got = phase.run_sweep(phase.SweepSpec(exchange=exchange, **QUICK),
                          device="cpu")
    want = jax_records[exchange]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g == w
    by_cell = {(r["fanout"], r["drop_rate"]): r
               for r in phase.summarize(got)}
    for f in (2, 5):
        assert by_cell[(f, 0.0)]["observer_completeness_mean"] == 1.0
        assert by_cell[(f, 0.0)]["false_removals_mean"] == 0.0
    assert (by_cell[(5, 0.0)]["msgs_sent_mean"]
            > by_cell[(2, 0.0)]["msgs_sent_mean"])


def test_summarize_and_artifacts_match_jax(tmp_path, jax_records):
    records = jax_records["ring"]
    rows = phase.summarize(records)
    assert rows == jax_phase.summarize(records)
    phase.write_artifacts(records, rows, str(tmp_path / "port"), name="q")
    jax_phase.write_artifacts(records, rows, str(tmp_path / "jax"), name="q")
    for f in ("q_runs.json", "q_grid.csv"):
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "jax" / f).read_bytes()), f


def test_cli_writes_under_out(tmp_path, jax_records, monkeypatch, capsys):
    """``main`` writes NAME_runs.json and NAME_grid.csv under ``--out``
    (``run_sweep`` stubbed with the JAX records: the grid's runs are the
    other tests' business)."""
    seen = {}

    def fake(spec, device=None):
        seen.update(spec=spec, device=device)
        return jax_records["ring"]
    monkeypatch.setattr(phase, "run_sweep", fake)
    assert phase.main(["--quick", "--n", "256", "--exchange", "ring",
                       "--device", "cpu", "--out", str(tmp_path)]) == 0
    assert seen["device"] == "cpu" and seen["spec"].n == 256
    name = "phase_sweep_quick_n256_ring"
    assert seen["spec"].name == name
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"{name}_grid.csv", f"{name}_runs.json"]
    assert '"cells": 4' in capsys.readouterr().out


def test_approx_lag_refused_with_jax_message():
    class JaxLag(jax_phase.SweepSpec):
        def to_params(self):
            p = super().to_params()
            p.PROBE_IO = "approx_lag"
            return p

    class PortLag(phase.SweepSpec):
        def to_params(self):
            p = super().to_params()
            p.PROBE_IO = "approx_lag"
            return p
    with pytest.raises(ValueError) as want:
        jax_phase.run_sweep(JaxLag(n=256))
    with pytest.raises(ValueError) as got:
        phase.run_sweep(PortLag(n=256), device="cpu")
    assert str(got.value) == str(want.value)
    assert "approx_lag" in str(got.value)


def test_to_params_leaves_the_layout_on_auto():
    p = phase.SweepSpec.north_star().to_params()
    assert (p.FOLDED, p.FUSED_RECEIVE, p.FUSED_GOSSIP, p.FUSED_PROBE) == (
        -1, -1, -1, -1)
    assert (p.EN_GPSZ, p.VIEW_SIZE, p.PROBES, p.FANOUT) == (65536, 16, 2, 3)


# ---------------------------------------------------------------------------
# The dynamic-knob step

# JAX test_dynamic_knobs_match_static_config's conf, with PROBES 4 (the
# folded layout needs P dividing 128).
_DYN = ("MAX_NNB: 128\nSINGLE_FAILURE: 1\nDROP_MSG: 1\nMSG_DROP_PROB: 0.1\n"
        "VIEW_SIZE: 16\nGOSSIP_LEN: 8\nPROBES: 4\nFANOUT: 3\n"
        "TOTAL_TIME: 60\nFAIL_TIME: 30\nJOIN_MODE: warm\nBACKEND: tpu_hash\n"
        "DROP_START: 10\nDROP_STOP: 50\n")
TICKS = 60


def _dyn_setup(layout: str):
    text = _DYN + ("EXCHANGE: scatter\n" if layout == "scatter"
                   else "EXCHANGE: ring\n")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pp, jp = Params.from_text(text), JaxParams.from_text(text)
    cfg = tpu_hash.make_config(pp, collect_events=False, fail_ids=(5,),
                               device="cpu")
    if layout == "folded":
        cfg = dataclasses.replace(cfg, folded=True)
    fail_mask = torch.zeros((128,), dtype=torch.bool)
    fail_mask[5] = True
    plan = PlanTensors(root=make_run_key(pp, 0),
                       start_ticks=torch.full((128,), -1, dtype=torch.int32),
                       fail_mask=fail_mask, fail_time=30, drop_lo=10,
                       drop_hi=50)
    return pp, jp, cfg, plan


@pytest.mark.parametrize("layout", ["natural", "folded", "scatter"])
def test_dynamic_knobs_match_static(layout):
    pp, _, cfg, plan = _dyn_setup(layout)
    static, init = tpu_hash.step_and_init(cfg)
    dyn, _ = tpu_hash.step_and_init(cfg, dynamic_knobs=True)
    a = b = init(cfg, make_run_key(pp, 7), "cpu")
    for t in range(TICKS):
        a, out_a = static(a, t, plan.tick_key(t), plan)
        b, out_b = dyn(b, t, plan.tick_key(t), plan, fanout=cfg.fanout,
                       drop_prob=cfg.drop_prob)
        got, want = state_to_numpy(b), state_to_numpy(a)
        for name in sorted(want):
            _first_mismatch(t, name, got[name], want[name])
        for name in out_a._fields:
            _first_mismatch(t, f"events.{name}", getattr(out_b, name),
                            getattr(out_a, name))
    assert int(a.agg.det_count.sum()) > 0


@pytest.mark.parametrize("layout", ["natural", "folded", "scatter"])
def test_dynamic_knobs_match_jax_at_another_cell(layout):
    """At fanout 2 and drop 0.2 (not the conf's): the port's dynamic-knob
    step equals the JAX ``make_step(cfg, dynamic_knobs=True)`` per tick
    (the folded step against the JAX natural one: the layouts are one
    trajectory), AggStats leaves included."""
    pp, jp, cfg, plan = _dyn_setup(layout)
    cfg = dataclasses.replace(cfg, fast_agg=False, fail_ids=())
    jcfg = dataclasses.replace(jax_hash.make_config(jp, collect_events=False),
                               fast_agg=False, fail_ids=())
    jstep = jax.jit(jax_hash.make_step(jcfg, dynamic_knobs=True))
    jstate = jax_hash.init_state_warm(jcfg, jax.random.PRNGKey(7))
    step, init = tpu_hash.step_and_init(cfg, dynamic_knobs=True)
    pstate = init(cfg, make_run_key(pp, 7), "cpu")
    want0 = _jax_leaves(jstate)
    for name, leaf in state_to_numpy(pstate).items():
        _first_mismatch(-1, name, leaf.reshape(want0[name].shape),
                        want0[name])
    start = jnp.full((128,), -1, jnp.int32)
    fail_mask = jnp.zeros((128,), bool).at[5].set(True)
    args = (jnp.asarray(30), jnp.asarray(10), jnp.asarray(50))
    key = jax.random.PRNGKey(0)
    for t in range(TICKS):
        jstate, jout = jstep(jstate, (jnp.asarray(t), jax.random.fold_in(
            key, t), start, fail_mask, *args), jnp.asarray(2),
            jnp.asarray(0.2, jnp.float32))
        pstate, pout = step(pstate, t, plan.tick_key(t), plan, fanout=2,
                            drop_prob=0.2)
        want = _jax_leaves(jstate)
        for name, leaf in state_to_numpy(pstate).items():
            _first_mismatch(t, name, leaf.reshape(want[name].shape),
                            want[name])
        for name in pout._fields:
            _first_mismatch(t, f"events.{name}", getattr(pout, name),
                            getattr(jout, name))
    assert int(pstate.agg.det_count.sum()) > 0


def test_dynamic_knobs_refuse_a_scenario():
    text = _DYN + "EXCHANGE: ring\nEVENT_MODE: agg\n"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pp = Params.from_text(text)
    cfg = tpu_hash.make_config(pp, collect_events=False, device="cpu")
    cfg = dataclasses.replace(cfg, scenario=object())
    with pytest.raises(ValueError, match="no dynamic knobs"):
        tpu_hash.make_step(cfg, dynamic_knobs=True)
