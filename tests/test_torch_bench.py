"""The port's bench (``python -m distributed_membership_tpu_torch.bench``)
against the JAX package's root ``bench.py``, on the CPU, tolerance 0.

The hash leg's record equals JAX ``bench.leg_hash(n, ticks, "cpu",
view)`` in every field but timing (walls, rates, the modelled GB/s, the
side legs' walls, percentages and ms) and where it ran (``platform``,
``device``), at S=128, S=16, ``BENCH_FOLDED=off`` and
``BENCH_SHIFT_SET=16``; the two packages' ``_timed_runs`` end in equal
final states, leaf by leaf; the dense leg's record equals JAX
``leg_dense``.  Every side leg runs once through the port's leg, its
fields held against the JAX bench's (run where its fields are not all
timing: the checkpoint and reshard legs; the mega leg's carry bytes are
those of the final state compared above).  The orchestrator runs
as a subprocess twice: with ``--device cpu`` (one JSON line, exit 0, its
ledger under ``tmp_path``) and without a card (an error line, exit 1).
Each JAX record is made once per module and shared.
"""

import contextlib
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jax_bench
from distributed_membership_tpu.backends import tpu as jax_dense
from distributed_membership_tpu.backends import tpu_hash as jax_hash
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.ops.megakernel import (
    carry_bytes as jax_carry_bytes)
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch import bench
from distributed_membership_tpu_torch.backends import tpu as port_dense
from distributed_membership_tpu_torch.backends import tpu_hash
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import state_to_numpy
from distributed_membership_tpu_torch.observability import perfdb
from distributed_membership_tpu_torch.ops.megakernel import carry_bytes
from distributed_membership_tpu_torch.runtime import failures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, TICKS = 256, 40
MACHINE = {"wall_seconds", "node_ticks_per_sec", "ticks_per_sec",
           "est_hbm_gbps", "platform", "device"}
CASES = {
    "s128": ({}, 128),
    "s16": ({}, 16),
    "folded_off": ({"BENCH_FOLDED": "off"}, 16),
    "shift_set16": ({"BENCH_SHIFT_SET": "16"}, 128),
}
ONE_REP = {f"BENCH_{leg}_REPS": "1" for leg in (
    "TELEMETRY", "HIST", "MEGA", "SCENARIO", "CHAOS", "EXCHANGE",
    "SERVICE", "METRICS")}
# The side legs' fields in the JAX bench (bench.py), by leg.
JAX_FIELDS = {
    "telemetry": {"telemetry_wall_seconds", "telemetry_overhead_pct"},
    "hist": {"hist_wall_seconds", "hist_overhead_pct"},
    "mega": {"mega_ticks", "mega_off_wall_seconds", "mega_wall_seconds",
             "mega_speedup_pct", "mega_carry_bytes_full",
             "mega_carry_bytes_packed"},
    "scenario": {"scenario_partition_wall_seconds",
                 "scenario_partition_overhead_pct",
                 "scenario_flake_wall_seconds",
                 "scenario_droppy_baseline_wall_seconds",
                 "scenario_flake_overhead_pct"},
    "chaos": {"chaos_events", "chaos_wall_seconds", "chaos_overhead_pct",
              "chaos_droppy_baseline_wall_seconds",
              "chaos_overhead_vs_droppy_pct"},
    "exchange": {"exchange_devices", "exchange_legacy_wall_seconds",
                 "exchange_batched_wall_seconds", "exchange_speedup_pct"},
    "service": {"service_every", "service_clients",
                "service_base_wall_seconds", "service_wall_seconds",
                "service_overhead_pct", "service_queries_per_sec",
                "service_p50_ms", "service_p99_ms",
                "service_staleness_mean_ticks",
                "service_staleness_max_ticks", "service_derive_mode",
                "service_derive_ms"},
    "metrics": {"metrics_hz", "metrics_reps", "metrics_base_wall_seconds",
                "metrics_wall_seconds", "metrics_overhead_pct",
                "metrics_scrapes", "metrics_scrapes_per_sec",
                "metrics_payload_bytes", "metrics_scrape_p50_ms",
                "metrics_scrape_max_ms"},
    "fleet": {"leg", "platform", "fleet_runs", "fleet_clients", "n",
              "ticks", "view_size", "fleet_sweep_wall_seconds",
              "fleet_sweep_loaded_wall_seconds", "fleet_base_run_seconds",
              "fleet_loaded_run_seconds", "fleet_run_slowdown_pct",
              "fleet_run_ticks_per_sec", "fleet_queries_per_sec"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _env(**keys):
    """``keys`` set in the environment; the whole environment restored
    after (the JAX bench caches its platform there)."""
    saved = dict(os.environ)
    os.environ.update(keys)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def _timing(key: str) -> bool:
    return key in MACHINE or key.endswith(("_seconds", "_pct", "_ms",
                                           "_per_sec"))


def _same(got: dict, want: dict) -> None:
    assert {k: v for k, v in got.items() if not _timing(k)} == {
        k: v for k, v in want.items() if not _timing(k)}
    assert set(got) - set(want) == {"device"}
    assert got["device"] == {"name": "cpu", "power_limit": None}
    assert got["platform"] == "cpu"


@pytest.fixture(scope="module")
def jax_rows():
    """Case -> the JAX bench's leg_hash row, each made at first use."""
    cache = {}

    def get(case):
        if case not in cache:
            env, view = CASES[case]
            with _env(**env):
                cache[case] = jax_bench.leg_hash(N, TICKS, "cpu", view)
        return cache[case]
    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_leg_hash_equals_jax(case, jax_rows):
    env, view = CASES[case]
    with _env(**env):
        got = bench.leg_hash(N, TICKS, "cpu", view)
    want = jax_rows(case)
    _same(got, want)
    assert not got["folded"] and got["node_ticks_per_sec"] > 0
    assert got["mode"] == ("natural+sw16" if case == "shift_set16"
                           else "natural")


def _jax_leaves(state) -> dict:
    out = {}
    for name, leaf in state._asdict().items():
        if name == "agg":
            out.update({f"agg.{f}": np.asarray(x)
                        for f, x in leaf._asdict().items()})
        else:
            out[name] = np.asarray(leaf)
    return out


def _same_leaves(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name in sorted(want):
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape, name
        if g.dtype != w.dtype and g.dtype.itemsize == w.dtype.itemsize:
            g = g.view(w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("view", [128, 16])
def test_timed_runs_final_state_equals_jax(view, jax_rows):
    """The leg's conf through both packages' ``_timed_runs``: the timed
    run's final states are equal in every leaf."""
    jax_rows("s128" if view == 128 else "s16")   # the JAX runner compiled
    text = bench.hash_leg_conf(N, TICKS, view).text
    jp, pp = JaxParams.from_text(text), Params.from_text(text)
    jplan = jax_failures.make_plan(jp, random.Random("app:0"))
    pplan = failures.make_plan(pp, random.Random("app:0"))
    _, jstate = jax_bench._timed_runs(jax_hash.run_scan, jp, jplan, TICKS)
    wall, pstate = bench._timed_runs(tpu_hash.run_scan, pp, pplan, TICKS,
                                     torch.device("cpu"))
    assert wall > 0
    _same_leaves(state_to_numpy(pstate), _jax_leaves(jstate))
    # BENCH_MEGA's carry accounting is of this state.
    assert carry_bytes(pstate, pack16=True) == jax_carry_bytes(
        jstate, pack16=True)


def test_leg_dense_equals_jax():
    got = bench.leg_dense(64, 100, "cpu")
    with _env():
        want = jax_bench.leg_dense(64, 100, "cpu")
    _same(got, want)
    # The leg's conf and its final state are the JAX bench's too.
    text = bench.dense_conf(64, 100)
    jp, pp = JaxParams.from_text(text), Params.from_text(text)
    _, jstate = jax_bench._timed_runs(
        jax_dense.run_scan, jp,
        jax_failures.make_plan(jp, random.Random("app:0")), 100)
    _, pstate = bench._timed_runs(
        port_dense.run_scan, pp,
        failures.make_plan(pp, random.Random("app:0")), 100,
        torch.device("cpu"))
    want_leaves = {k: np.asarray(v) for k, v in jstate._asdict().items()}
    _same_leaves(state_to_numpy(pstate), want_leaves)


@pytest.mark.parametrize("leg", ["checkpoint", "reshard"])
def test_side_legs_equal_jax(leg):
    """BENCH_CHECKPOINT and BENCH_RESHARD: the snapshot bytes, and the
    reshard's tick, shapes and carry bytes, equal the JAX bench's (the
    reshard on eight shards, the JAX package's eight CPU devices)."""
    env = {"checkpoint": {"BENCH_CHECKPOINT": "8"},
           "reshard": {"BENCH_RESHARD": "1"}}[leg]
    with _env(**env):
        want = jax_bench.leg_hash(N, TICKS, "cpu", 16)
    with _env(**env):
        got = bench.leg_hash(N, TICKS, "cpu", 16)
    _same(got, want)
    if leg == "checkpoint":
        assert got["checkpoint_bytes_per_snapshot"] > 0
    else:
        assert (got["reshard_from_shape"], got["reshard_to_shape"],
                got["reshard_tick"]) == ("8", "4x2", TICKS // 2)


@pytest.mark.parametrize("legs", [("telemetry", "hist", "mega"),
                                  ("scenario", "chaos", "exchange")])
def test_side_legs_fields(legs):
    """The comparison legs whose fields are timings (and the mega leg,
    whose carry accounting test_timed_runs_final_state_equals_jax holds
    against the JAX package's): each runs through the port's leg, and
    its fields are the JAX bench's."""
    env = dict(ONE_REP, **{f"BENCH_{leg.upper()}": "4" if leg == "mega"
                           else "1" for leg in legs})
    with _env(**env):
        got = bench.leg_hash(N, TICKS, "cpu", 128 if "hist" in legs else 16)
    want = set().union(*(JAX_FIELDS[leg] for leg in legs))
    assert want <= set(got)
    for key in want:
        assert got[key] is not None and got[key] == got[key], key
    if "chaos" in legs:
        assert got["chaos_events"] == 3
        assert got["exchange_devices"] == bench.SHARDS
    else:
        assert got["mega_ticks"] == 4
        assert got["mega_carry_bytes_packed"] < got["mega_carry_bytes_full"]


def test_side_leg_rng_plan():
    """BENCH_RNG: the port's one RNG plan, timed (the JAX bench's
    scattered/batched pair has no counterpart: one lowering)."""
    with _env(BENCH_RNG="1"):
        got = bench.leg_hash(N, TICKS, "cpu", 128)
    assert got["rng_plan_ms"] > 0
    assert not {k for k in got if k.startswith("rng_")} - {"rng_plan_ms"}


def test_side_legs_service_and_metrics():
    """BENCH_SERVICE and BENCH_METRICS: served arms under the client
    subprocess, the metrics arm under the scraper subprocess; the
    fields are the JAX bench's and the clients were answered."""
    env = dict(ONE_REP, BENCH_SERVICE="1", BENCH_METRICS="1",
               BENCH_SERVICE_CLIENTS="2", OMP_NUM_THREADS="1")
    with _env(**env):
        got = bench.leg_hash(N, TICKS, "cpu", 16)
    assert JAX_FIELDS["service"] | JAX_FIELDS["metrics"] <= set(got)
    assert got["service_every"] == TICKS // 8
    assert got["service_queries_per_sec"] > 0
    assert got["metrics_scrapes"] > 0 and got["metrics_payload_bytes"] > 0


def test_side_leg_fleet(monkeypatch, tmp_path):
    """BENCH_FLEET: one controller with one N=10 worker on the CPU, the
    unloaded sweep and the loaded one (each once here: every sweep starts
    its processes anew), its record the JAX bench's fields plus the
    device, banked as two ledger rows keyed by it."""
    def once(run_scan, params, plan, ticks, device):
        run_scan(params, plan, seed=1, device=device)
        return 1.0, None
    monkeypatch.setattr(bench, "_timed_runs", once)
    with _env(BENCH_FLEET_RUNS="1", BENCH_FLEET_TICKS="40",
              BENCH_FLEET_EVERY="20", BENCH_FLEET_REPS="1",
              BENCH_SERVICE_CLIENTS="1", OMP_NUM_THREADS="1"):
        row = bench._bench_fleet(torch.device("cpu"))
    assert set(row) == JAX_FIELDS["fleet"] | {"device"}
    assert row["platform"] == "cpu" and row["fleet_runs"] == 1
    assert row["fleet_queries_per_sec"] > 0
    ledger = str(tmp_path / "ledger.jsonl")
    bench._ledger_bank_fleet(row, ledger)
    rows = perfdb.load_ledger(ledger)
    assert [r["rung"] for r in rows] == ["bench:live:fleet",
                                         "bench:live:fleet:tickloop"]
    assert {r["knobs"]["device"] for r in rows} == {"cpu"}


def test_refusals(monkeypatch):
    """BENCH_FPROBE, a pinned kernel on the CPU, the banked headlines;
    and the orchestrator stops on a child's refusal, whichever error
    the port raised."""
    with _env(BENCH_FPROBE="1"), pytest.raises(NotImplementedError,
                                               match="FUSED_PROBE"):
        bench.leg_hash(N, TICKS, "cpu", 16)
    with _env(BENCH_FUSED="recv"), pytest.raises(NotImplementedError,
                                                 match="on the CPU"):
        bench.leg_hash(N, 8, "cpu", 128)
    for fn in (bench._best_banked_tpu, bench._banked_displaces_live):
        with pytest.raises(NotImplementedError, match="banked"):
            fn()
    for err in ("NotImplementedError: FUSED_RECEIVE: 0 on CUDA: ...",
                "ValueError: FOLDED requires EXCHANGE ring ..."):
        done = subprocess.CompletedProcess([], 1, "", "Traceback\n" + err)
        monkeypatch.setattr(bench.subprocess, "run",
                            lambda *a, _d=done, **k: _d)
        with pytest.raises(SystemExit, match="rejected its config"):
            bench._run_leg("hash", N, TICKS, "cuda", 60, os.devnull)
    done = subprocess.CompletedProcess([], 1, "", "RuntimeError: lost")
    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **k: done)
    assert bench._run_leg("hash", N, TICKS, "cuda", 60, os.devnull) is None


def _orchestrator(args, **env):
    full = {k: v for k, v in os.environ.items() if not k.startswith(
        "BENCH_")}
    full.update(env, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "distributed_membership_tpu_torch.bench",
         *args], cwd=REPO, env=full, capture_output=True, text=True,
        timeout=300)


def test_orchestrator_on_the_cpu(tmp_path):
    ledger = tmp_path / "ledger.jsonl"
    r = _orchestrator(["--device", "cpu", "--ledger", str(ledger)],
                      BENCH_N="256", BENCH_TICKS="8", BENCH_DENSE_N="64")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["platform"] == "cpu" and out["source"] == "live"
    assert out["device"] == {"name": "cpu", "power_limit": None}
    assert out["value"] > 0 and "failed_legs" not in out
    assert {out["hash"]["view_size"], out["hash_alt"]["view_size"]} == {
        128, 16}
    assert out["hash"]["node_ticks_per_sec"] == out["value"]
    assert out["dense"]["n"] == 64 and out["dense"]["ticks"] == 100
    rows = perfdb.load_ledger(str(ledger))
    assert sorted(r["rung"] for r in rows) == [
        "bench:live:dense", "bench:live:hash", "bench:live:hash"]
    assert {r["knobs"]["device"] for r in rows} == {"cpu"}


def test_orchestrator_without_a_card():
    """No card (none visible to the process) and no --device cpu: one
    error line, exit 1, no leg run and no banked row."""
    r = _orchestrator(["--ledger", os.devnull], CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 1
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert "error" in out and out["value"] is None
    assert "leg" not in r.stderr and "banked" not in r.stdout
