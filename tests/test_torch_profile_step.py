"""The port's per-point profiler (``python -m
distributed_membership_tpu_torch.profile_step``) against the JAX
package's ``scripts/profile_step.py``, on the CPU, tolerance 0.

``time_point`` records equal the JAX script's in every field but timing,
the trace's and where it ran (``platform``, ``device``): ring at S=16 and
S=128, the scatter exchange, and ``--exchange-mode batched`` on eight
shards (the port pinned to MESH_SHAPE 8, the JAX package on its eight CPU
devices).  The port's kernel flags default to ``auto``, which on the CPU
resolves to the plain versions: the JAX script's ``off``.  Then the two
assertions of the JAX package's ``tests/test_trace_phases.py`` against
the port (every phase range in a ``--trace-dir`` trace; ``compile`` start
and done plus ``execute`` in the run log), the checkpointed mode, the
CLI, and the refusals.  Each JAX record is made once per module.
"""

import json
import os
import sys

import pytest
import torch

from distributed_membership_tpu_torch import profile_step
from distributed_membership_tpu_torch.observability.runlog import (
    RunLog, read_events)
from distributed_membership_tpu_torch.observability.timeline import (
    PHASE_NAMES, scan_trace_for_phases)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MACHINE = {"compile_plus_first_run_s", "wall_seconds", "ticks_per_sec",
           "node_ticks_per_sec", "ms_per_tick", "implied_hbm_gbps",
           "platform", "device"}
CASES = {
    "ring_s16": ((256, 16, 12, "ring"), {}, {}),
    "ring_s128": ((256, 128, 12, "ring"), {}, {}),
    "scatter": ((256, 16, 40, "scatter"), {}, {}),
    "batched8": ((256, 128, 12, "ring"), {"exchange_mode": "batched"},
                 {"mesh_shape": "8"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_records():
    """Case -> the JAX script's time_point record (fused off), each made
    at first use."""
    scripts = os.path.join(REPO, "scripts")
    sys.path.insert(0, scripts)
    try:
        import profile_step as jax_profile_step
    finally:
        sys.path.remove(scripts)
    cache = {}

    def get(case):
        if case not in cache:
            args, kw, _ = CASES[case]
            cache[case] = jax_profile_step.time_point(*args, False, **kw)
        return cache[case]
    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_time_point_equals_jax(case, jax_records):
    args, kw, port_kw = CASES[case]
    got = profile_step.time_point(*args, device="cpu", **kw, **port_kw)
    want = jax_records(case)
    assert {k: v for k, v in got.items() if k not in MACHINE} == {
        k: v for k, v in want.items() if k not in MACHINE}
    assert set(got) - set(want) == {"device"}
    assert got["platform"] == "cpu"
    assert got["device"] == {"name": "cpu", "power_limit": None}
    assert not (got["fused"] or got["fused_gossip"] or got["fused_probe"]
                or got["folded"])
    if case == "batched8":
        assert got["mesh_size"] == 8


def test_trace_dir_captures_phase_annotations(tmp_path):
    d = str(tmp_path / "trace")
    rec = profile_step.time_point(1024, 16, 12, "ring", device="cpu",
                                  trace_dir=d)
    assert rec["trace_files"] >= 1
    assert set(PHASE_NAMES) <= set(rec["trace_phases"]), rec
    assert rec["trace_phase_annotations_present"] is True
    assert set(PHASE_NAMES) <= set(scan_trace_for_phases(d))


def test_runlog_records_compile_and_execute(tmp_path):
    path = str(tmp_path / "runlog.jsonl")
    profile_step.time_point(512, 16, 8, "ring", device="cpu",
                            runlog=RunLog(path))
    kinds = [e["kind"] for e in read_events(path)]
    assert kinds.count("compile") == 2      # start + done
    assert "execute" in kinds
    done = [e for e in read_events(path, kinds={"compile"})
            if e.get("phase") == "done"]
    assert done and done[0]["compile_plus_first_run_s"] >= 0


def test_checkpointed_mode(tmp_path, monkeypatch):
    """DM_CHECKPOINT_EVERY chunks both runs; with DM_CHECKPOINT_DIR and
    DM_RESUME the first resumes from the last durable segment."""
    ck = str(tmp_path / "ck")
    monkeypatch.setenv("DM_CHECKPOINT_EVERY", "4")
    monkeypatch.setenv("DM_CHECKPOINT_DIR", ck)
    rec = profile_step.time_point(256, 16, 12, "ring", device="cpu")
    assert (rec["checkpoint_every"], rec["resumed_from_tick"]) == (4, None)
    monkeypatch.setenv("DM_RESUME", "1")
    rec = profile_step.time_point(256, 16, 12, "ring", device="cpu")
    assert rec["resumed_from_tick"] == 12
    monkeypatch.delenv("DM_CHECKPOINT_EVERY")
    rec = profile_step.time_point(256, 16, 12, "ring", device="cpu",
                                  mega_ticks=2)
    assert (rec["checkpoint_every"], rec["mega_ticks"]) == (8, 2)


def test_cli_prints_one_record_per_point(capsys):
    rc = profile_step.main(["--n", "256", "--view", "16", "--ticks", "6",
                            "--fused-gossip", "off", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    rec = json.loads(lines[0])
    assert (rec["n"], rec["s"], rec["ticks"], rec["fused"]) == (256, 16, 6,
                                                               False)


def test_refusals():
    """--cost (no cost_analysis in PyTorch) and a pinned kernel on the
    CPU each say why; PRNG_IMPL rbg (jax's Philox stream, ops/rbg.py)
    runs."""
    with pytest.raises(SystemExit) as e:
        profile_step.main(["--cost", "--device", "cpu"])
    assert e.value.code == 2
    with pytest.raises(NotImplementedError, match="cost_analysis"):
        profile_step.time_point(256, 16, 6, "ring", cost=True, device="cpu")
    rec = profile_step.time_point(256, 16, 6, "ring", prng="rbg",
                                  device="cpu")
    assert (rec["prng"], rec["ticks"]) == ("rbg", 6)
    with pytest.raises(NotImplementedError, match="on the CPU"):
        profile_step.time_point(256, 128, 6, "ring", fused=True,
                                device="cpu")
