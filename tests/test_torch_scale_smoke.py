"""The port's scale smoke (``python -m
distributed_membership_tpu_torch.scale_smoke``) against the JAX package's
``scripts/scale_smoke.py``, on the CPU, tolerance 0.

Each case runs the JAX script's ``main`` in-process and the port's
``main`` with ``--device cpu`` on the same flags at N=512: the records
must be equal in every field but the run's timing (``wall_seconds``,
``node_ticks_per_sec``, ``timestamp``) and where it ran (``platform``,
``device``).  The cases cover the default S=64 geometry, S=16 (G=4,
P=2), S=128 (G=32, P=16), the loss floor's TREMOVE under 5% drops, rack
failures past FastAgg's eight ids (AggStats), and eight shards of
``tpu_hash_sharded``.  Each JAX record is made once per module and shared.
"""

import json
import os
import sys

import pytest
import torch

from distributed_membership_tpu_torch import scale_smoke
from distributed_membership_tpu_torch.observability import perfdb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING = {"wall_seconds", "node_ticks_per_sec", "timestamp", "platform",
          "device"}
BASE = ["--n", "512", "--ticks", "120"]
CASES = {
    "s64": [],
    "s16": ["--view", "16", "--gossip", "4", "--probes", "2"],
    "s128": ["--view", "128", "--gossip", "32", "--probes", "16"],
    "drop": ["--drop", "0.05", "--ticks", "160"],
    "racks": ["--rack-size", "8", "--rack-failures", "4"],
    "sharded8": ["--backend", "tpu_hash_sharded", "--mesh", "8"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_record(flags, out):
    """The JAX script's ``main`` in this process -> (rc, its record)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    saved_argv, saved_env = sys.argv, dict(os.environ)
    try:
        import scale_smoke as jax_scale_smoke
        sys.argv = (["scale_smoke.py"] + BASE + flags
                    + ["--platform", "cpu", "--out", out])
        rc = jax_scale_smoke.main()
    finally:
        sys.argv = saved_argv
        os.environ.clear()
        os.environ.update(saved_env)
        sys.path.remove(os.path.join(REPO, "scripts"))
    with open(out) as fh:
        return rc, json.load(fh)[-1]


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    """Case -> the JAX script's (rc, record), each made at first use."""
    root = tmp_path_factory.mktemp("jax_scale")
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _jax_record(CASES[case],
                                      str(root / f"{case}.json"))
        return cache[case]
    return get


def _port_record(flags, out):
    rc = scale_smoke.main(BASE + flags + ["--device", "cpu", "--out", out])
    with open(out) as fh:
        return rc, json.load(fh)[-1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_record_equals_jax_script(case, jax_records, tmp_path):
    jax_rc, want = jax_records(case)
    rc, got = _port_record(CASES[case], str(tmp_path / "out.json"))
    assert rc == jax_rc
    assert {k: v for k, v in got.items() if k not in TIMING} == {
        k: v for k, v in want.items() if k not in TIMING}
    assert got["device"] == {"name": "cpu", "power_limit": None}
    assert got["platform"] == "cpu"
    # The port's record carries no card fields off the card.
    assert set(got) - set(want) == {"device"}
    assert not scale_smoke.MACHINE_FIELDS - TIMING & set(got)
    if case == "sharded8":
        assert got["mesh_size"] == 8
    if case == "racks":
        assert got["detection"]["failed_nodes"] == 32
    if case == "drop":
        assert got["tremove"] > 40          # the loss floor's TREMOVE


def test_geometry_sizing_matches_jax_script():
    """TFAIL, TREMOVE and FAIL_TIME as the JAX script sizes them, with
    and without probes and under the loss floor."""
    ap = scale_smoke.parser()
    for flags, want in (([], (16, 40, 24)),
                        (["--probes", "0"], (4, 10, 96)),
                        (["--drop", "0.05", "--ticks", "160"], None)):
        params, tfail, tremove = scale_smoke.scale_params(
            ap.parse_args(BASE + flags))
        if want is not None:
            assert (tfail, tremove, params.FAIL_TIME) == want
        assert params.EVENT_MODE == "agg" and params.JOIN_MODE == "warm"
    with pytest.raises(ValueError, match="raise --ticks"):
        scale_smoke.scale_params(ap.parse_args(["--ticks", "90"]))


def test_scale_conf_is_the_tools_run():
    """confs/scale_1m_s64_folded.conf (the cell chip_smoke.py profiles)
    is the tool's run at --n 1048576 --ticks 120, key for key."""
    from distributed_membership_tpu_torch.config import Params
    from distributed_membership_tpu_torch.runtime.checkpoint import (
        params_identity)

    params, _, _ = scale_smoke.scale_params(scale_smoke.parser().parse_args(
        ["--n", "1048576", "--ticks", "120"]))
    conf = Params.from_file(os.path.join(
        REPO, "distributed_membership_tpu_torch", "confs",
        "scale_1m_s64_folded.conf"))
    assert params_identity(conf) == params_identity(params)


def test_record_banks_and_ingests(jax_records, tmp_path):
    """A record appends to the out file, and the port's perf ledger
    ingests it with the device's name in the row's knobs."""
    out = tmp_path / "artifacts" / "SCALE_SMOKE_TORCH.json"
    for _ in range(2):
        _port_record(["--n", "256", "--telemetry-dir", str(tmp_path / "rec")],
                     str(out))
    records = json.loads(out.read_text())
    assert len(records) == 2
    assert records[0]["timeline"]["ticks"] == 120
    assert records[0]["timeline"]["detections_total"] == (
        records[0]["detection"]["detections_total"])
    assert (tmp_path / "rec" / "timeline.jsonl").exists()
    rows = perfdb.collect_all(str(tmp_path))
    assert [r["knobs"]["device"] for r in rows] == ["cpu", "cpu"]
    assert rows[0]["key"] == rows[1]["key"]
    # The JAX record's row has no device knob.
    _, want = jax_records("s64")
    jax_row = perfdb.rows_from_scale_smoke([want], "x")[0]
    assert "device" not in jax_row["knobs"]
