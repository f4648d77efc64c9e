"""The port's user-facing tools against the JAX package's scripts, on the
CPU, tolerance 0.

* ``observability/perfdb.py``: rows, digests and ``check`` equal the JAX
  module's on the banked ``BENCH_r*.json``, ``MULTICHIP_r*.json``,
  ``artifacts/TPU_PROFILE.json`` and ``artifacts/SCALE_SMOKE.json`` (read
  only; ledgers under ``tmp_path``); ``perf_ledger`` ingests the port's
  own records and keys their rows by card.
* ``run_report``: the markdown and JSON equal ``scripts/run_report.py``'s
  on the same port recorder directories: the report, ``--slo``,
  ``--compare``, and the fleet and campaign views.
* ``package_results`` (on ``emul``) and ``submit``: archive members,
  manifest scores and form payloads equal the JAX scripts'.
* Each device tool's default ``--device cuda`` raises on a machine with
  no card rather than running on the CPU.
"""

import argparse
import contextlib
import glob
import io
import json
import os
import shutil
import sys
import tarfile

import pytest
import torch

from distributed_membership_tpu.observability import perfdb as jax_perfdb
from distributed_membership_tpu_torch import (
    package_results, perf_ledger, run_report, scale_smoke, submit)
from distributed_membership_tpu_torch.observability import perfdb
from distributed_membership_tpu_torch.runtime.application import run_conf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
RING = ("MAX_NNB: 256\nSINGLE_FAILURE: 1\nDROP_MSG: 1\n"
        "MSG_DROP_PROB: 0.05\nVIEW_SIZE: 128\nGOSSIP_LEN: 32\nPROBES: 16\n"
        "FANOUT: 3\nTFAIL: 16\nTREMOVE: 40\nTOTAL_TIME: 100\n"
        "FAIL_TIME: 30\nJOIN_MODE: warm\nEXCHANGE: ring\nEVENT_MODE: agg\n"
        "TELEMETRY: hist\nCHECKPOINT_EVERY: 40\nBACKEND: tpu_hash\n")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _scripts_on_path():
    sys.path.insert(0, SCRIPTS)
    try:
        yield
    finally:
        sys.path.remove(SCRIPTS)


def _jax_script(name):
    with _scripts_on_path():
        return __import__(name)


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _unstamped(rows):
    return [{k: v for k, v in r.items() if k != "ingested_at"}
            for r in rows]


# ---------------------------------------------------------------------------
# perfdb and perf_ledger

def _banked_docs():
    """(parser name, doc, source) of every banked artifact of the repo."""
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "BENCH_r*.json"))):
        out.append(("rows_from_bench", json.load(open(path)),
                    os.path.basename(path)))
    for path in sorted(glob.glob(os.path.join(REPO, "MULTICHIP_r*.json"))):
        out.append(("rows_from_multichip", json.load(open(path)),
                    os.path.basename(path)))
    for name, fn in (("TPU_PROFILE.json", "rows_from_tpu_profile"),
                     ("SCALE_SMOKE.json", "rows_from_scale_smoke")):
        out.append((fn, json.load(open(os.path.join(REPO, "artifacts",
                                                    name))),
                    os.path.join("artifacts", name)))
    return out


def test_perfdb_rows_equal_jax_on_banked_artifacts(tmp_path):
    docs = _banked_docs()
    assert {d[0] for d in docs} == {"rows_from_bench", "rows_from_multichip",
                                    "rows_from_tpu_profile",
                                    "rows_from_scale_smoke"}
    port_rows, jax_rows = [], []
    for fn, doc, source in docs:
        got = getattr(perfdb, fn)(doc, source)
        want = getattr(jax_perfdb, fn)(doc, source)
        assert _unstamped(got) == _unstamped(want), source
        port_rows += got
        jax_rows += want
    assert len(port_rows) > 20
    assert [r["knobs_digest"] for r in port_rows] == [
        perfdb.knobs_digest(r["knobs"]) for r in jax_rows]
    # The same ledger files, check output and re-ingestion no-op.
    for mod, rows, name in ((perfdb, port_rows, "port"),
                            (jax_perfdb, jax_rows, "jax")):
        path = str(tmp_path / f"{name}.jsonl")
        assert mod.append_rows(rows, path) == len(
            {tuple(r.get(f) for f in perfdb._IDENTITY_FIELDS)
             for r in rows})
        assert mod.append_rows(rows, path) == 0
    got = perfdb.load_ledger(str(tmp_path / "port.jsonl"))
    want = jax_perfdb.load_ledger(str(tmp_path / "jax.jsonl"))
    assert _unstamped(got) == _unstamped(want)
    for band in (0.3, 0.05, 0.0):
        assert perfdb.check(got, band) == jax_perfdb.check(want, band)
    assert perfdb.check(got, 0.0)          # the band matters
    # The JAX ledger is never the port's.
    assert perfdb.LEDGER_PATH != jax_perfdb.LEDGER_PATH


@pytest.mark.parametrize("knobs", [
    {"mega_ticks": 8, "ticks": 400}, {"procs": 2}, {"service_workers": 2},
    {"reshard": True, "mesh": 8}, {"b": 2, "a": 1}, None])
def test_make_row_equals_jax(knobs):
    kw = dict(metric="node_ticks_per_sec", value=1234.5, n=65536, s=16,
              backend="tpu_hash", platform="gpu", knobs=knobs,
              source="s", timestamp="t")
    got = perfdb.make_row("bench:live", **kw)
    want = jax_perfdb.make_row("bench:live", **kw)
    assert _unstamped([got]) == _unstamped([want])


def _port_record(n, nts, name, ts):
    return {"backend": "tpu_hash", "platform": "gpu", "mesh_size": 1,
            "n": n, "ticks": 120, "view_size": 64, "probes": 8,
            "fanout": 3, "node_ticks_per_sec": nts, "timestamp": ts,
            "device": {"name": name, "power_limit": "700.00 W"}}


def test_perf_ledger_ingests_port_records_keyed_by_card(tmp_path):
    art = tmp_path / "artifacts"
    art.mkdir()
    recs = [_port_record(1 << 20, 5.0e6, "NVIDIA H100 80GB HBM3", "t1"),
            _port_record(1 << 20, 1.0e6, "NVIDIA A100-SXM4-80GB", "t2"),
            _port_record(1 << 20, 5.1e6, "NVIDIA H100 80GB HBM3", "t3")]
    (art / "SCALE_SMOKE_TORCH.json").write_text(json.dumps(recs))
    # The JAX package's banked records are not the port's.
    (art / "SCALE_SMOKE.json").write_text(json.dumps(
        [dict(recs[0], device=None)]))
    root = str(tmp_path)
    rc, out = _stdout(perf_ledger.main, ["--root", root, "--check"])
    assert rc == 0, out
    assert "3 rows (3 new), 2 keys" in out and "check OK" in out
    rows = perfdb.load_ledger(os.path.join(root, perfdb.LEDGER_PATH))
    assert [r["knobs"]["device"] for r in rows] == [
        "NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-80GB",
        "NVIDIA H100 80GB HBM3"]
    assert not (art / "perf_ledger.jsonl").exists()
    rc, out = _stdout(perf_ledger.main, ["--root", root, "--json"])
    assert rc == 0 and json.loads(out)["rows_added"] == 0
    # A slower H100 row past the band is a regression; the A100's row,
    # on another key, never was.
    recs.append(_port_record(1 << 20, 2.0e6, "NVIDIA H100 80GB HBM3", "t4"))
    (art / "SCALE_SMOKE_TORCH.json").write_text(json.dumps(recs))
    rc, out = _stdout(perf_ledger.main, ["--root", root, "--check"])
    assert rc == 1 and out.count("REGRESSION") == 1, out
    rc, out = _stdout(perf_ledger.main,
                      ["--root", root, "--check", "--no-ingest",
                       "--band", "0.9"])
    assert rc == 0, out


# ---------------------------------------------------------------------------
# run_report

@pytest.fixture(scope="module")
def recorder_dirs(tmp_path_factory):
    """Two port recorder directories (TELEMETRY hist, agg mode, 40-tick
    segments) of the same conf on two seeds."""
    root = tmp_path_factory.mktemp("recorder")
    conf = root / "ring.conf"
    conf.write_text(RING)
    dirs = []
    for seed in (0, 1):
        d = root / f"rec{seed}"
        run_conf(str(conf), seed=seed, out_dir=str(root / f"out{seed}"),
                 device="cpu", telemetry_dir=str(d))
        dirs.append(str(d))
    return dirs


@pytest.mark.parametrize("flags", [[], ["--json"], ["--slo"],
                                   ["--slo", "--json"]])
def test_run_report_equals_jax_script(recorder_dirs, flags):
    jax_report = _jax_script("run_report")
    d = recorder_dirs[0]
    runs = {}
    for name, mod in (("jax", jax_report), ("port", run_report)):
        rc, out = _stdout(mod.main, ["--dir", d] + flags)
        slo = None
        if "--slo" in flags:
            with open(os.path.join(d, "slo.json")) as fh:
                slo = fh.read()
            os.remove(os.path.join(d, "slo.json"))
        runs[name] = (rc, out, slo)
    assert runs["port"] == runs["jax"]
    rc, out, _ = runs["port"]
    assert rc == 0
    if "--json" in flags:
        rep = json.loads(out)
        assert rep["reconciliation"]["hist_latency_matches_detections"]
        assert rep["segments"]["segments"] == 3
        assert ("slo" in rep) == ("--slo" in flags)
    else:
        assert "## Timeline (per-tick telemetry)" in out


@pytest.mark.parametrize("flags", [[], ["--json"]])
def test_run_report_compare_equals_jax_script(recorder_dirs, flags,
                                              tmp_path):
    jax_report = _jax_script("run_report")
    a, b = recorder_dirs
    for pair, want_rc in (((a, b), 2), ((a, a), 0)):
        got = _stdout(run_report.main, ["--compare", *pair] + flags)
        assert got == _stdout(jax_report.main, ["--compare", *pair] + flags)
        assert got[0] == want_rc
    # --out writes the same file.
    outs = {}
    for name, mod in (("jax", jax_report), ("port", run_report)):
        path = str(tmp_path / f"{name}.md")
        mod.main(["--compare", a, b, "--out", path])
        outs[name] = open(path).read()
    assert outs["port"] == outs["jax"]


def test_run_report_fleet_and_campaign_views_equal_jax(tmp_path,
                                                       recorder_dirs):
    """A root holding a fleet journal and a campaign journal: the
    combined view and its JSON, replayed read-only."""
    root = tmp_path / "root"
    root.mkdir()
    rows = [
        {"kind": "submit", "run_id": "r1", "seq": 1,
         "conf": "MAX_NNB: 16\nTOTAL_TIME: 50\n"},
        {"kind": "submit", "run_id": "r2", "seq": 2,
         "conf": "MAX_NNB: 16\nTOTAL_TIME: 70\n"},
        {"kind": "state", "run_id": "r1", "state": "running", "tick": 20},
        {"kind": "state", "run_id": "r1", "state": "migrating", "tick": 20,
         "trigger": "death"},
        {"kind": "state", "run_id": "r1", "state": "requeued", "tick": 20,
         "from_tick": 20, "resume_tick": 10},
        {"kind": "state", "run_id": "r2", "state": "done", "tick": 70}]
    (root / "fleet_runs.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows) + '{"torn')
    camp = [{"kind": "campaign", "digest": "abc", "mode": "fleet",
             "spec": {"schedules": 3}},
            {"kind": "graded", "run_id": "c0", "ok": True},
            {"kind": "graded", "run_id": "c1", "ok": False},
            {"kind": "shrinking", "run_id": "c1"},
            {"kind": "shrunk", "run_id": "c1", "path": "reg/c1.json"},
            {"kind": "done", "ok": False}]
    (root / "campaign.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in camp))
    # r2's run dir holds a recorder's streams.
    shutil.copytree(recorder_dirs[0], root / "r2")
    jax_report = _jax_script("run_report")
    for flags in ([], ["--json"]):
        got = _stdout(run_report.main, ["--dir", str(root)] + flags)
        assert got == _stdout(jax_report.main, ["--dir", str(root)] + flags)
        assert got[0] == 0
        if not flags:
            assert "VIOLATION c1" in got[1] and "r2 " in got[1]
    # --watch, two frames.
    args = argparse.Namespace(dir=str(root), ladder=None, slo=False,
                              json=False, interval=0.0)
    frames = {}
    for name, mod in (("jax", jax_report), ("port", run_report)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert mod.watch(args, iterations=2) == 0
        frames[name] = buf.getvalue()
    assert frames["port"] == frames["jax"]
    assert "--- run_report watch #1 ---" in frames["port"]


# ---------------------------------------------------------------------------
# package_results and submit

def _members(path):
    with tarfile.open(path) as tar:
        return {m.name: tar.extractfile(m).read() for m in tar.getmembers()}


def test_package_results_equals_jax_script(tmp_path):
    jax_pkg = _jax_script("package_results")
    outs = {}
    for name, fn, extra in (
            ("jax", jax_pkg.main, ["--platform", "cpu"]),
            ("port", package_results.main, ["--device", "cpu"])):
        path = str(tmp_path / f"{name}.tar.gz")
        rc, _ = _stdout(fn, ["--backend", "emul", "--seed", "3",
                             "--out", path] + extra)
        assert rc == 0
        outs[name] = _members(path)
    got, want = outs["port"], outs["jax"]
    assert sorted(got) == sorted(want)
    assert len(got) == 10
    for name in want:
        if name != "manifest.json":
            assert got[name] == want[name], name
    gm, wm = (json.loads(m["manifest.json"]) for m in (got, want))
    skip = {"platform", "jax_version", "timestamp"}
    assert ({k: v for k, v in gm.items() if k not in skip}
            == {k: v for k, v in wm.items() if k not in skip})
    assert gm["platform"] == "cpu" and gm["jax_version"] is None
    assert gm["total_points"] == 90 and gm["passed"] is True


def test_submit_payloads_equal_jax_script(tmp_path):
    jax_submit = _jax_script("submit")
    for fn in ("challenge_response", "challenge_request_payload",
               "parse_challenge", "submission_payload"):
        assert getattr(submit, fn).__code__.co_code == getattr(
            jax_submit, fn).__code__.co_code, fn
    assert (submit.PART_IDS, submit.PART_NAMES, submit.SCENARIO_BY_PART) \
        == (jax_submit.PART_IDS, jax_submit.PART_NAMES,
            jax_submit.SCENARIO_BY_PART)
    docs = {}
    for name, fn, extra in (("jax", jax_submit.main, []),
                            ("port", submit.main, ["--device", "cpu"])):
        out = tmp_path / name
        rc, text = _stdout(fn, ["--part", "3", "--email", "a@b.c",
                                "--password", "pw", "--seed", "2",
                                "--out-dir", str(out)] + extra)
        assert rc == 0 and "offline submission payload written" in text
        docs[name] = json.loads(
            (out / "submission_mp1_part3.json").read_text())
        assert (out / "mp1_part3" / "dbg.log").exists()
    for key in ("challenge_request", "submit_request", "grade"):
        assert docs["port"][key] == docs["jax"][key], key
    assert docs["port"]["grade"] == {"points": 30, "max": 30}
    assert docs["port"]["submit_request"]["challenge_response"] == (
        "not-computed-offline")


# ---------------------------------------------------------------------------
# --device cuda without a card

@pytest.mark.parametrize("tool", ["scale_smoke", "package_results",
                                  "submit"])
def test_device_cuda_raises_without_a_card(tool, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    argv = {"scale_smoke": (scale_smoke.main,
                            ["--n", "256", "--out", str(out)]),
            "package_results": (package_results.main,
                                ["--out", str(out)]),
            "submit": (submit.main, ["--part", "1", "--email", "a@b.c",
                                     "--out-dir", str(out)])}[tool]
    with pytest.raises(RuntimeError, match="cuda"):
        argv[0](argv[1])
    assert not out.exists() or not any(out.iterdir())
