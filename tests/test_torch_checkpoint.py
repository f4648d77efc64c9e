"""The port's checkpoint and resume (runtime/checkpoint.py, the run log,
the conf keys) against the JAX package's, on the CPU with tolerance 0.

* config: the conf texts that either package refuses for the checkpoint,
  hoisting and block keys are refused by both with the same message, and
  ``params_identity`` is the same text for every conf of the repo;
* chunked runs of the port equal its unchunked runs on all four ring
  steps (logs, or summary and timeline);
* a run killed in the port (``DM_CRASH_AT_TICK``) before the crash tick,
  inside the drop window and on a boundary resumes to the same logs;
* a run killed in one package resumes in the other, both ways, on all
  four ring steps (eight shards), under a scenario and on the scatter
  exchange of the grader's testcase, to the
  JAX package's uninterrupted result, and both packages' checkpoints of
  the same tick hold the same members, bytes, state hash and manifest;
* manifest checks (seed, config, corruption, a missing checkpoint, an
  edited scenario, history depth), ``runlog.jsonl`` against the JAX
  package's, the run-state file, a graceful stop, and the command line.
"""

import json
import os
import pathlib
import shutil
import signal
import warnings

import numpy as np
import pytest

import torch

from distributed_membership_tpu.backends.tpu_hash import (
    make_config as jax_make_config)
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.observability import runlog as jax_runlog
from distributed_membership_tpu.runtime import application as jax_app
from distributed_membership_tpu.runtime import checkpoint as jax_ck
from distributed_membership_tpu_torch.backends import get_backend
from distributed_membership_tpu_torch.backends import tpu_hash
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.observability import runlog
from distributed_membership_tpu_torch.observability.timeline import (
    TimelineRecorder)
from distributed_membership_tpu_torch.runtime import application
from distributed_membership_tpu_torch.runtime import checkpoint as ck
from distributed_membership_tpu_torch.runtime.failures import resolve_plan

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFS = REPO / "distributed_membership_tpu_torch" / "confs"
SEED = 3
LOGS = ("dbg.log", "stats.log", "msgcount.log")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_crash_env(monkeypatch):
    monkeypatch.delenv(ck.CRASH_ENV, raising=False)


# ---------------------------------------------------------------------------
# Config: the same refusals, the same identity

_RING = ("MAX_NNB: 64\nSINGLE_FAILURE: 1\nDROP_MSG: 0\nMSG_DROP_PROB: 0\n"
         "VIEW_SIZE: 16\nGOSSIP_LEN: 8\nPROBES: 2\nFANOUT: 3\nTFAIL: 16\n"
         "TREMOVE: 40\nTOTAL_TIME: 100\nFAIL_TIME: 50\nJOIN_MODE: warm\n"
         "EVENT_MODE: agg\nEXCHANGE: ring\n")
_HASH = _RING + "BACKEND: tpu_hash\n"
_SHARDED = _RING + "BACKEND: tpu_hash_sharded\n"

CONFIG_CASES = {
    "resume_without_dir": _HASH + "CHECKPOINT_EVERY: 40\nRESUME: 1\n",
    "resume_without_every": _HASH + "CHECKPOINT_DIR: /x\nRESUME: 1\n",
    "resume_2": _HASH + "CHECKPOINT_EVERY: 40\nCHECKPOINT_DIR: /x\n"
                        "RESUME: 2\n",
    "compress_2": _HASH + "CHECKPOINT_EVERY: 40\nCHECKPOINT_COMPRESS: 2\n",
    "every_negative": _HASH + "CHECKPOINT_EVERY: -1\n",
    "every_on_emul": _RING + "BACKEND: emul\nCHECKPOINT_EVERY: 40\n",
    "pack_with_mega_0": _HASH + "CHECKPOINT_EVERY: 40\nMEGA_TICKS: 0\n"
                                "MEGA_PACK: 1\n",
    "pack_with_mega_1": _HASH + "CHECKPOINT_EVERY: 40\nMEGA_TICKS: 1\n"
                                "MEGA_PACK: 1\n",
    "pack_with_mega_auto": _HASH + "CHECKPOINT_EVERY: 40\nMEGA_PACK: 1\n",
    "pack_2": _HASH + "CHECKPOINT_EVERY: 40\nMEGA_TICKS: 8\nMEGA_PACK: 2\n",
    "pack_too_long": _HASH.replace("TOTAL_TIME: 100", "TOTAL_TIME: 40000")
    + "CHECKPOINT_EVERY: 40\nMEGA_TICKS: 8\nMEGA_PACK: 1\n",
    "mega_not_tiling": _HASH + "CHECKPOINT_EVERY: 50\nMEGA_TICKS: 8\n",
    "mega_without_every": _HASH + "MEGA_TICKS: 8\n",
    "mega_negative": _HASH + "CHECKPOINT_EVERY: 40\nMEGA_TICKS: -2\n",
    "mega_on_sparse": _RING + "BACKEND: tpu_sparse\nCHECKPOINT_EVERY: 40\n"
                              "MEGA_TICKS: 8\n",
    "mega_on_scatter": _HASH.replace("EXCHANGE: ring", "EXCHANGE: scatter")
    + "CHECKPOINT_EVERY: 40\nMEGA_TICKS: 8\n",
    "hoisted_without_every": _HASH + "RNG_MODE: hoisted\n",
    "hoisted_on_sharded": _SHARDED + "CHECKPOINT_EVERY: 40\n"
                                     "RNG_MODE: hoisted\n",
    "hoisted_on_scatter": _HASH.replace("EXCHANGE: ring", "EXCHANGE: scatter")
    + "CHECKPOINT_EVERY: 40\nRNG_MODE: hoisted\n",
    "service_without_every": _HASH + "SERVICE_PORT: 0\n",
    "fleet_migrate_bad": _HASH + "FLEET_MIGRATE_ON: death,never\n",
    "accepted": _HASH + "CHECKPOINT_EVERY: 40\nCHECKPOINT_DIR: /x\n"
                        "RESUME: 1\nCHECKPOINT_COMPRESS: 1\nMEGA_TICKS: 8\n"
                        "MEGA_PACK: 1\nRNG_MODE: hoisted\n",
    "accepted_sharded": _SHARDED + "CHECKPOINT_EVERY: 24\nMEGA_TICKS: 3\n"
                                   "MEGA_PACK: 0\n",
}


def _outcome(fn):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fn()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return "ok"


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_config_gates_match_jax(case):
    """Params.from_text, then (when it passes) make_config: both packages
    accept or refuse each conf, with the same message."""
    text = CONFIG_CASES[case]

    def jax_side():
        p = JaxParams.from_text(text)
        jax_make_config(p, p.resolved_event_mode() == "full")

    def port_side():
        p = Params.from_text(text)
        tpu_hash.make_config(p, p.resolved_event_mode() == "full")

    want = _outcome(jax_side)
    assert _outcome(port_side) == want
    assert (want == "ok") == case.startswith("accepted")


def _repo_confs():
    return sorted(list((REPO / "testcases").glob("*.conf"))
                  + list(CONFS.glob("*.conf")))


_CKPT_KEYS = ("CHECKPOINT_EVERY: 40\nCHECKPOINT_DIR: /tmp/ck\nRESUME: 1\n"
              "CHECKPOINT_COMPRESS: 1\nMEGA_TICKS: 8\nMEGA_PACK: 1\n"
              "TELEMETRY: scalars\nSERVICE_PORT: 0\n")


@pytest.mark.parametrize("extra", ["", _CKPT_KEYS],
                         ids=["plain", "with_ckpt_keys"])
def test_params_identity_equal_on_every_conf(extra):
    """The manifest's params_text of every conf of the repo (the
    testcases, the port's confs and its scenario confs), with and
    without the checkpoint and block keys, is the JAX package's text;
    the excluded keys leave it unchanged."""
    confs = _repo_confs()
    assert len(confs) >= 24
    for path in confs:
        text = path.read_text() + extra
        want = jax_ck.params_identity(JaxParams().parse(text,
                                                        validate=False))
        got = ck.params_identity(Params().parse(text, validate=False))
        assert got == want, path.name
        plain = ck.params_identity(Params().parse(path.read_text(),
                                                  validate=False))
        assert got == plain, path.name


# ---------------------------------------------------------------------------
# Whole runs: helpers

_FOLDED = ("MAX_NNB: 256\nSINGLE_FAILURE: 1\nDROP_MSG: 1\n"
           "MSG_DROP_PROB: 0.1\nDROP_START: 10\nDROP_STOP: 50\n"
           "VIEW_SIZE: 16\nGOSSIP_LEN: 8\nPROBES: 2\nFANOUT: 3\nTFAIL: 16\n"
           "TREMOVE: 64\nTOTAL_TIME: 90\nFAIL_TIME: 30\nJOIN_MODE: warm\n"
           "EVENT_MODE: agg\nEXCHANGE: ring\nFOLDED: 1\nTELEMETRY: hist\n"
           "BACKEND: tpu_hash\n")
_SHARDED_FOLDED = (_FOLDED.replace("MAX_NNB: 256", "MAX_NNB: 512")
                   .replace("BACKEND: tpu_hash\n",
                            "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8\n"))
_SCN_BASE = (
    "MAX_NNB: 32\nSINGLE_FAILURE: 0\nDROP_MSG: 0\nMSG_DROP_PROB: 0\n"
    "VIEW_SIZE: 16\nGOSSIP_LEN: 8\nPROBES: 4\nFANOUT: 3\n"
    "TFAIL: 8\nTREMOVE: 20\nTOTAL_TIME: 450\nJOIN_MODE: warm\n"
    "EVENT_MODE: agg\nEXCHANGE: ring\nTELEMETRY: scalars\n"
    "BACKEND: tpu_hash\n")
# The JAX package's kill/resume schedule (tests/test_scenario.py): a
# partition over several boundaries, a crash and restart, a delay window
# around the kill tick, a one-way flake.
_SCN_EVENTS = [
    {"kind": "partition", "start": 120, "stop": 380,
     "groups": [[0, 16], [16, 32]]},
    {"kind": "crash", "time": 60, "range": [4, 6]},
    {"kind": "restart", "time": 420, "range": [4, 6]},
    {"kind": "delay_window", "start": 130, "stop": 180, "dst": [20, 28]},
    {"kind": "one_way_flake", "start": 390, "stop": 405,
     "src": [16, 32], "dst": [0, 4]},
]

# name -> (conf text or conf file, segment length, kill tick)
RUNS = {
    "natural": (CONFS / "ring_256_s128_drop.conf", 20, 70),
    "folded": (_FOLDED, 24, 40),
    "sharded8": (CONFS / "ring_256_s128_sharded8_drop.conf", 40, 50),
    "sharded_folded": (_SHARDED_FOLDED, 16, 40),
    "scenario": (None, 50, 150),
    # The grader's testcase on tpu_hash: N=10, staggered joins, the
    # scatter exchange and its ack and probe mailboxes in the carry.
    "scatter": ((REPO / "testcases" / "msgdropsinglefailure.conf")
                .read_text() + "BACKEND: tpu_hash\n", 50, 150),
}


def _conf_file(name, d: pathlib.Path) -> pathlib.Path:
    """The run's conf as a file under ``d`` (the scenario conf names a
    schedule file beside it by its absolute path, the same string in
    both packages)."""
    src = RUNS[name][0]
    if isinstance(src, pathlib.Path):
        return src
    d.mkdir(parents=True, exist_ok=True)
    text = src
    if name == "scenario":
        spath = d / "resume.json"
        spath.write_text(json.dumps({"name": "resume",
                                     "events": _SCN_EVENTS}))
        text = _SCN_BASE + f"SCENARIO: {spath}\n"
    path = d / f"{name}.conf"
    path.write_text(text)
    return path


def _run(pkg, conf, out, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if pkg == "jax":
            return jax_app.run_conf(str(conf), seed=SEED, out_dir=str(out),
                                    **kw)
        return application.run_conf(str(conf), seed=SEED, out_dir=str(out),
                                     device="cpu", **kw)


def _result(r, out):
    """What two runs of one conf must share: the three logs of a
    full-event run; the detection summary, message counts, timeline and
    scenario report of an agg-mode run."""
    if not r.extra.get("aggregate"):
        return {f: (pathlib.Path(out) / f).read_bytes() for f in LOGS}
    tl = r.extra.get("timeline")
    return {"summary": r.extra["detection_summary"],
            "sent": np.asarray(r.sent).tolist(),
            "recv": np.asarray(r.recv).tolist(),
            "timeline": None if tl is None else {
                k: np.asarray(v).tolist() for k, v in tl.items()},
            "scenario": r.extra.get("scenario_report")}


def _killed(pkg, conf, d: pathlib.Path, every, kill, telemetry_dir=None):
    """Run ``conf`` in ``pkg`` with ``DM_CRASH_AT_TICK=kill``; returns the
    checkpoint directory under ``d`` that the crash left."""
    ckdir = d / f"ck_{pkg}"
    os.environ[ck.CRASH_ENV] = str(kill)
    try:
        with pytest.raises(RuntimeError, match="injected crash"):
            _run(pkg, conf, d / f"killed_{pkg}", checkpoint_every=every,
                 checkpoint_dir=str(ckdir), telemetry_dir=telemetry_dir)
    finally:
        del os.environ[ck.CRASH_ENV]
    assert ck.manifest_tick(str(ckdir)) == -(-kill // every) * every
    return ckdir


_REF: dict = {}


def _reference(name, tmp_path_factory):
    """The JAX package's uninterrupted, unchunked run of ``name`` (with a
    telemetry directory, so that the timeline is the file's)."""
    if name not in _REF:
        d = tmp_path_factory.mktemp(f"ref_{name}")
        conf = _conf_file(name, d)
        out = d / "out"
        r = _run("jax", conf, out, telemetry_dir=str(d / "tl"))
        _REF[name] = (d, _result(r, out))
    return _REF[name]


# ---------------------------------------------------------------------------
# Chunked runs and kills inside the port

@pytest.mark.parametrize("name,every", [
    ("natural", 40), ("natural", 33), ("folded", 24), ("sharded8", 40),
    ("sharded_folded", 16)])
def test_chunked_equals_unchunked_in_port(name, every, tmp_path,
                                          tmp_path_factory):
    """A chunked run of the port (a tail segment shorter than the others
    at 33) equals its unchunked run, and so the JAX package's."""
    d, want = _reference(name, tmp_path_factory)
    conf = _conf_file(name, d)
    r = _run("port", conf, tmp_path / "out", checkpoint_every=every,
             telemetry_dir=str(tmp_path / "tl"))
    assert _result(r, tmp_path / "out") == want
    assert r.extra["final_state"].view.device.type == "cpu"


@pytest.mark.parametrize("kill", [30, 70, 100],
                         ids=["before_fail", "in_drop_window",
                              "on_boundary"])
def test_kill_and_resume_in_port(kill, tmp_path, tmp_path_factory):
    """ring_256_s128_drop (FAIL_TIME 50, drops from tick 50) killed at
    30, 70 and 100 with 20-tick segments: the resumed run's logs are
    byte-identical to the uninterrupted run's."""
    d, want = _reference("natural", tmp_path_factory)
    ckdir = _killed("port", RUNS["natural"][0], tmp_path, 20, kill)
    r = _run("port", RUNS["natural"][0], tmp_path / "resumed",
             checkpoint_every=20, checkpoint_dir=str(ckdir), resume=True)
    assert _result(r, tmp_path / "resumed") == want
    man = ck.load_manifest(str(ckdir))
    assert man["tick"] == 120 and len(man["checkpoints"]) == 3


def test_kill_and_resume_timeline_files(tmp_path, tmp_path_factory):
    """A folded agg run with TELEMETRY hist killed and resumed with one
    TELEMETRY_DIR: its timeline.jsonl and summary.json are byte-identical
    to the uninterrupted run's, and its series the JAX package's."""
    d, want = _reference("folded", tmp_path_factory)
    ref_dir = tmp_path / "tl_ref"
    _run("port", _conf_file("folded", d), tmp_path / "ref",
         checkpoint_every=24, telemetry_dir=str(ref_dir))
    tl_dir = tmp_path / "tl"
    ckdir = _killed("port", _conf_file("folded", d), tmp_path, 24, 40,
                    telemetry_dir=str(tl_dir))
    r = _run("port", _conf_file("folded", d), tmp_path / "resumed",
             checkpoint_every=24, checkpoint_dir=str(ckdir), resume=True,
             telemetry_dir=str(tl_dir))
    assert _result(r, tmp_path / "resumed") == want
    for f in ("timeline.jsonl", "summary.json"):
        assert (tl_dir / f).read_bytes() == (ref_dir / f).read_bytes(), f


# ---------------------------------------------------------------------------
# Across the packages

_KILLED: dict = {}


def _killed_cached(pkg, name, tmp_path_factory):
    """A pristine checkpoint directory of ``name`` killed in ``pkg`` (the
    tests resume copies of it)."""
    key = (pkg, name)
    if key not in _KILLED:
        d, _ = _reference(name, tmp_path_factory)
        every, kill = RUNS[name][1:]
        kd = tmp_path_factory.mktemp(f"killed_{pkg}_{name}")
        tl = kd / "tl"
        _KILLED[key] = (_killed(pkg, _conf_file(name, d), kd, every, kill,
                                telemetry_dir=str(tl)), tl)
    return _KILLED[key]


CROSS = ["natural", "folded", "sharded8", "sharded_folded", "scenario",
         "scatter"]


@pytest.mark.parametrize("name", CROSS)
@pytest.mark.parametrize("killer,resumer", [("jax", "port"),
                                            ("port", "jax")],
                         ids=["jax_to_port", "port_to_jax"])
def test_resume_across_packages(name, killer, resumer, tmp_path,
                                tmp_path_factory):
    """A run killed in one package and resumed in the other ends as the
    JAX package's uninterrupted run: the same logs, or the same summary,
    message counts, timeline and scenario report."""
    d, want = _reference(name, tmp_path_factory)
    src, tl = _killed_cached(killer, name, tmp_path_factory)
    ckdir = tmp_path / "ck"
    shutil.copytree(src, ckdir)
    shutil.copytree(tl, tmp_path / "tl")
    every = RUNS[name][1]
    r = _run(resumer, _conf_file(name, d), tmp_path / "resumed",
             checkpoint_every=every, checkpoint_dir=str(ckdir), resume=True,
             telemetry_dir=str(tmp_path / "tl"))
    assert _result(r, tmp_path / "resumed") == want
    if name == "scenario":
        rep = r.extra["scenario_report"]
        assert rep["partitions"][0]["removals_during"] > 0
        assert rep["restarts"][0]["rejoined"] is True


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("name", CROSS)
def test_same_checkpoint_files(name, tmp_path_factory):
    """Both packages' checkpoints of the same tick: the same npz members,
    dtypes, shapes and bytes, the same state hash (recomputed by each
    package), and manifests equal but for ``wrote_at``."""
    (jdir, _), (pdir, _) = (_killed_cached(pkg, name, tmp_path_factory)
                            for pkg in ("jax", "port"))
    jman, pman = (json.loads((d / ck.MANIFEST_NAME).read_text())
                  for d in (jdir, pdir))
    jman.pop("wrote_at")
    pman.pop("wrote_at")
    assert pman == jman
    assert sorted(p.name for p in pdir.glob("ckpt_*.npz")) == sorted(
        p.name for p in jdir.glob("ckpt_*.npz"))
    for entry in pman["checkpoints"]:
        a, b = (_npz(d / entry["file"]) for d in (jdir, pdir))
        assert list(b) == list(a)
        for k in a:
            assert (b[k].dtype, b[k].shape) == (a[k].dtype, a[k].shape), k
            assert b[k].tobytes() == a[k].tobytes(), k
        leaves = [b[f"c{i}"] for i in range(sum(k.startswith("c")
                                                 for k in b))]
        assert ck.state_hash(leaves) == jax_ck.state_hash(leaves) \
            == entry["state_hash"]


# ---------------------------------------------------------------------------
# The manifest, the run log, the state file, a graceful stop

_SMALL = _HASH.replace("TOTAL_TIME: 100", "TOTAL_TIME: 120").replace(
    "EVENT_MODE: agg", "EVENT_MODE: full")


def _small_conf(tmp_path, text=_SMALL):
    path = tmp_path / "small.conf"
    path.write_text(text)
    return path


def test_manifest_checks_match_jax(tmp_path):
    """A wrong seed, a wrong config and a corrupted state hash raise the
    JAX package's message, word for word, in both packages; RESUME with
    no checkpoint, or a torn manifest, starts fresh; the history keeps
    three files and no temporary one."""
    conf = _small_conf(tmp_path)
    ref = _run("port", conf, tmp_path / "ref")
    ckdir = tmp_path / "ck"
    r = _run("port", conf, tmp_path / "a", checkpoint_every=20,
             checkpoint_dir=str(ckdir), resume=True)
    assert _result(r, tmp_path / "a") == _result(ref, tmp_path / "ref")
    files = sorted(p.name for p in ckdir.glob("ckpt_*.npz"))
    assert files == [f"ckpt_{t:08d}.npz" for t in (80, 100, 120)]
    man = ck.load_manifest(str(ckdir))
    assert [h["file"] for h in man["checkpoints"]] == files
    assert man["tick"] == 120 and not list(ckdir.glob("*.tmp"))

    def both(conf_path, seed):
        errs = []
        for pkg in ("jax", "port"):
            with pytest.raises(ValueError) as e:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    if pkg == "jax":
                        jax_app.run_conf(str(conf_path), seed=seed,
                                         out_dir=str(tmp_path / "o"),
                                         checkpoint_every=20,
                                         checkpoint_dir=str(ckdir),
                                         resume=True)
                    else:
                        application.run_conf(
                            str(conf_path), seed=seed,
                            out_dir=str(tmp_path / "o"), device="cpu",
                            checkpoint_every=20, checkpoint_dir=str(ckdir),
                            resume=True)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
        return errs[1]

    assert "manifest mismatch" in both(conf, SEED + 1)
    assert "'seed'" in both(conf, SEED + 1)
    conf2 = tmp_path / "c2.conf"
    conf2.write_text(_SMALL + "TFAIL: 17\n")
    assert "'params_text'" in both(conf2, SEED)
    man["state_hash"] = "0" * 64
    (ckdir / ck.MANIFEST_NAME).write_text(json.dumps(man))
    assert "state hash mismatch" in both(conf, SEED)
    (ckdir / ck.MANIFEST_NAME).write_text("{torn")
    assert ck.load_manifest(str(ckdir)) is None
    r = _run("port", conf, tmp_path / "b", checkpoint_every=20,
             checkpoint_dir=str(ckdir), resume=True)
    assert _result(r, tmp_path / "b") == _result(ref, tmp_path / "ref")


def test_resume_refuses_edited_scenario(tmp_path):
    """The manifest holds the scenario file's digest: an edited schedule
    does not resume."""
    conf = _conf_file("scenario", tmp_path)
    ckdir = _killed("port", conf, tmp_path, 50, 150)
    spath = tmp_path / "resume.json"
    doc = json.loads(spath.read_text())
    doc["events"].append({"kind": "drop_window", "start": 10, "stop": 20,
                          "drop_prob": 0.5})
    spath.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="manifest mismatch.*scenario"):
        _run("port", conf, tmp_path / "r", checkpoint_every=50,
             checkpoint_dir=str(ckdir), resume=True)


def _runlog_shape(path):
    """The run log's records with the clock and the seconds taken out."""
    out = []
    for rec in jax_runlog.read_events(str(path)):
        rec = dict(rec)
        for k in ("ts", "t_mono", "device_sync_s", "flush_s",
                  "ckpt_wait_s", "checkpoint_dir"):
            if k in rec:
                rec[k] = type(rec[k]).__name__
        out.append(rec)
    return out


def test_runlog_matches_jax(tmp_path, monkeypatch):
    """runlog.jsonl of a killed and resumed run: the same event kinds and
    fields, in order, as the JAX package's, but for the clock and the
    seconds; and the port's reader parses the JAX package's file as the
    JAX reader does.  The run-state file ends at the last tick."""
    conf = _small_conf(tmp_path, _HASH)
    logs = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        ckdir, tl = d / "ck", d / "tl"
        state_file = d / "state.json"
        monkeypatch.setenv(ck.STATE_FILE_ENV, str(state_file))
        monkeypatch.setenv(ck.CRASH_ENV, "50")
        with pytest.raises(RuntimeError, match="injected crash"):
            _run(pkg, conf, d / "a", checkpoint_every=30,
                 checkpoint_dir=str(ckdir), telemetry_dir=str(tl))
        monkeypatch.delenv(ck.CRASH_ENV)
        _run(pkg, conf, d / "b", checkpoint_every=30,
             checkpoint_dir=str(ckdir), resume=True, telemetry_dir=str(tl))
        logs[pkg] = tl / "runlog.jsonl"
        state = json.loads(state_file.read_text())
        assert (state["tick"], state["total"]) == (100, 100)
        assert set(state) == {"tick", "total", "ts", "v", "time"}
    assert _runlog_shape(logs["port"]) == _runlog_shape(logs["jax"])
    kinds = [r["kind"] for r in runlog.read_events(str(logs["port"]))]
    assert kinds == ["segments_start", "segment", "segment",
                     "segments_start", "segment", "segment", "segments_done"]
    assert (runlog.read_events(str(logs["jax"]))
            == jax_runlog.read_events(str(logs["jax"])))


class _StopAt(TimelineRecorder):
    """A recorder that sends this process SIGTERM while flushing the
    segment that starts at ``t0``."""

    def __init__(self, directory, t0):
        super().__init__(directory)
        self.stop_t0 = t0

    def flush(self, telem, t0):
        super().flush(telem, t0)
        if t0 == self.stop_t0:
            os.kill(os.getpid(), signal.SIGTERM)


def test_graceful_stop_then_resume(tmp_path):
    """SIGTERM during the segment [30, 60) stops the run at 60 with
    RunInterrupted, the snapshot of 60 durable and the handlers restored;
    RESUME finishes it equal to the uninterrupted run."""
    text = _HASH + "TELEMETRY: scalars\nCHECKPOINT_EVERY: 30\n"
    ref = get_backend("tpu_hash")(Params.from_text(text), seed=SEED,
                                  device="cpu")
    ckdir = tmp_path / "ck"
    params = Params.from_text(text + f"CHECKPOINT_DIR: {ckdir}\n")
    plan = resolve_plan(params, __import__("random").Random(f"app:{SEED}"))
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(ck.RunInterrupted) as e:
        tpu_hash.run_scan(params, plan, SEED, "cpu", collect_events=False,
                          telemetry=_StopAt(None, 30))
    assert e.value.tick == 60 and ck.manifest_tick(str(ckdir)) == 60
    assert signal.getsignal(signal.SIGTERM) == before
    r = get_backend("tpu_hash")(Params.from_text(
        text + f"CHECKPOINT_DIR: {ckdir}\nRESUME: 1\n"), seed=SEED,
        device="cpu")
    assert r.extra["detection_summary"] == ref.extra["detection_summary"]
    assert np.array_equal(r.sent, ref.sent)


def test_cli_checkpoint_flags(tmp_path, monkeypatch, capsys):
    """--checkpoint-every, --checkpoint-dir and --resume on the port's
    command line win over the conf and resume a killed run."""
    conf = _small_conf(tmp_path)
    ckdir = tmp_path / "ck"
    args = [str(conf), "--device", "cpu", "--seed", str(SEED),
            "--checkpoint-every", "20", "--checkpoint-dir", str(ckdir)]
    application.main(args + ["--out-dir", str(tmp_path / "ref"), "--json"])
    monkeypatch.setenv(ck.CRASH_ENV, "30")
    with pytest.raises(RuntimeError, match="injected crash at tick 40"):
        application.main(args + ["--out-dir", str(tmp_path / "a")])
    assert ck.manifest_tick(str(ckdir)) == 40
    monkeypatch.delenv(ck.CRASH_ENV)
    assert application.main(args + ["--resume", "--out-dir",
                                    str(tmp_path / "b"), "--json"]) == 0
    for f in LOGS:
        assert ((tmp_path / "b" / f).read_bytes()
                == (tmp_path / "ref" / f).read_bytes()), f
