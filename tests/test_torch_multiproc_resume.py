"""The port's multi-process runs killed and resumed, resharded and
merged, through the launcher on the CPU (gloo): the resumed bytes equal
the uninterrupted run's, and the merged timeline the one-process run's.
Helpers and confs from tests/test_torch_multiproc.py.  Tolerance 0."""

from __future__ import annotations

import json

import numpy as np

from test_torch_multiproc import CONFS, _CASES, _launch, _read


# ---------------------------------------------------------------------------
# (c) Kill and resume; (e) the 2 -> 1 reshard


def test_kill_resume_bit_exact(tmp_path):
    """(c) Both processes crash at the tick-20 boundary with its
    snapshot durable; the same command with --resume finishes the run,
    byte-identical to an uninterrupted one, and both manifests say
    process_count 2."""
    conf = tmp_path / "mp.conf"
    conf.write_text(_CASES["legacy"][0])
    ck = ("--procs", "2", "--checkpoint-every", "20")
    ref = _launch(conf, tmp_path / "ref", *ck)
    assert ref.returncode == 0, (ref.stdout, ref.stderr)
    crashed = _launch(conf, tmp_path / "kr", *ck,
                      env_extra={"DM_CRASH_AT_TICK": "10"})
    assert crashed.returncode != 0
    resumed = _launch(conf, tmp_path / "kr", *ck, "--resume")
    assert resumed.returncode == 0, (resumed.stdout, resumed.stderr)
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        assert _read(tmp_path / "kr", 0, name) == _read(
            tmp_path / "ref", 0, name), name
        assert _read(tmp_path / "kr", 1, name) == _read(
            tmp_path / "ref", 0, name), name
    for i in range(2):
        m = json.loads(_read(tmp_path / "kr", i, "ckpt/MANIFEST.json"))
        assert m["process_count"] == 2 and m["tick"] == 40


def test_reshard_two_to_one_resumes(tmp_path, capsys):
    """(e) A two-process run of eight shards killed at its tick-20
    boundary resumes on ONE process through the launcher's
    maybe_reshard (elastic/reshard.py), as tests/test_elastic.py checks
    the JAX launcher's: the rewritten manifest says process_count 1 and
    the resumed logs equal the uninterrupted run's bytes."""
    from distributed_membership_tpu_torch import multiproc_launch as ml
    conf = tmp_path / "mp.conf"
    conf.write_text(_CASES["legacy"][0] + "MESH_SHAPE: 8\n")
    ck = ("--checkpoint-every", "20")
    ref = _launch(conf, tmp_path / "ref", "--procs", "2", *ck)
    assert ref.returncode == 0, (ref.stdout, ref.stderr)
    crashed = _launch(conf, tmp_path / "rs", "--procs", "2", *ck,
                      env_extra={"DM_CRASH_AT_TICK": "10"})
    assert crashed.returncode != 0
    args = ml.main.__globals__["argparse"].Namespace(
        conf=str(conf), resume=True, checkpoint_every=20,
        out_root=str(tmp_path / "rs"), procs=1, mesh_shape=None,
        devices_per_proc=1, device="cpu")
    assert ml.maybe_reshard(args) == 1
    assert "resharded tick 20" in capsys.readouterr().out
    m = json.loads(_read(tmp_path / "rs", 0, "ckpt/MANIFEST.json"))
    assert m["process_count"] == 1 and m["reshard"][-1]["from_procs"] == 2
    # Same geometry now: the launcher's own check is a plain resume.
    resumed = _launch(conf, tmp_path / "rs", "--procs", "1", *ck,
                      "--resume")
    assert resumed.returncode == 0, (resumed.stdout, resumed.stderr)
    for name in ("dbg.log", "stats.log"):
        assert _read(tmp_path / "rs", 0, name) == _read(
            tmp_path / "ref", 0, name), name
    # A shard count the processes cannot split is refused (exit 2).
    bad = _launch(conf, tmp_path / "rs", "--procs", "3", *ck, "--resume")
    assert bad.returncode == 2 and "reshard refused" in bad.stderr


def test_merge_equals_one_process_series(tmp_path):
    """(d) N=256 on eight shards over two processes with TELEMETRY hist:
    the launcher's --merge folds the two timeline shards into one whose
    series equals the one-process run's, field for field."""
    from distributed_membership_tpu_torch.observability.timeline import (
        read_timeline)
    from distributed_membership_tpu_torch.runtime import application
    conf = tmp_path / "n256.conf"
    conf.write_text((CONFS / "ring_256_s128_sharded8_drop.conf").read_text()
                    .replace("TOTAL_TIME: 120", "TOTAL_TIME: 60"))
    r = _launch(conf, tmp_path / "mp", "--procs", "2", "--merge", "--",
                "--telemetry", "hist", "--telemetry-dir", ".")
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "merged 2 shard(s) (60 ticks)" in r.stdout
    application.run_conf(str(conf), seed=0, out_dir=str(tmp_path / "sp"),
                         device="cpu", telemetry="hist",
                         telemetry_dir=str(tmp_path / "sp"))
    merged = read_timeline(str(tmp_path / "mp" / "timeline.jsonl"))
    one = read_timeline(str(tmp_path / "sp" / "timeline.jsonl"))
    assert sorted(merged) == sorted(one)
    for k in one:
        assert np.array_equal(np.asarray(merged[k]), np.asarray(one[k])), k
    assert _read(tmp_path / "mp", 0, "dbg.log") == (
        tmp_path / "sp" / "dbg.log").read_bytes()
