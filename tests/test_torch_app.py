"""The port end to end against the JAX package, and its package rules.

* Full event mode: ``dbg.log``, ``stats.log`` and ``msgcount.log`` of the
  port on ``--device cpu`` are byte-identical to the JAX package's
  ``run_conf`` on the same conf and seed (N = 256, S = 128, 5% drops).
* Agg mode: the detection summaries are identical (N = 2048, drop-free).
* The port and ``chip_smoke.py`` import neither JAX nor the JAX package.
* The default device is CUDA: without a GPU a run raises instead of
  running on the CPU, and what the slice does not cover is refused.
"""

import ast
import os
import pathlib
import subprocess
import sys
import warnings

import pytest
import torch

from distributed_membership_tpu.runtime import application as jax_app
from distributed_membership_tpu_torch.backends.tpu_hash import make_config
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.runtime import application

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "distributed_membership_tpu_torch"

_RING = ("MAX_NNB: {n}\nSINGLE_FAILURE: 1\nDROP_MSG: {drop}\n"
         "MSG_DROP_PROB: {p}\nVIEW_SIZE: 128\nGOSSIP_LEN: 32\nPROBES: 16\n"
         "FANOUT: 3\nTFAIL: 16\nTREMOVE: 40\nTOTAL_TIME: {total}\n"
         "FAIL_TIME: {fail}\nJOIN_MODE: warm\nEXCHANGE: ring\n"
         "BACKEND: tpu_hash\n")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores, and torch's OpenMP workers would then wait on each
    other at every op of the tick loop."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _runs(tmp_path, conf_text, seed):
    conf = tmp_path / "ring.conf"
    conf.write_text(conf_text)
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out["jax"] = jax_app.run_conf(str(conf), seed=seed,
                                      out_dir=str(tmp_path / "jax"))
        out["port"] = application.run_conf(str(conf), seed=seed,
                                           out_dir=str(tmp_path / "port"),
                                           device="cpu")
    return out


def test_full_event_logs_byte_identical(tmp_path):
    conf = _RING.format(n=256, drop=1, p=0.05, total=120, fail=50)
    runs = _runs(tmp_path, conf, seed=7)
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        want = (tmp_path / "jax" / name).read_bytes()
        got = (tmp_path / "port" / name).read_bytes()
        assert got == want, name
    dbg = (tmp_path / "port" / "dbg.log").read_text()
    assert "removed" in dbg and "Node failed at time" in dbg
    assert runs["port"].failed_indices == runs["jax"].failed_indices


def test_agg_detection_summary_identical(tmp_path):
    conf = (_RING.format(n=2048, drop=0, p=0, total=110, fail=50)
            + "EVENT_MODE: agg\n")
    runs = _runs(tmp_path, conf, seed=0)
    want = runs["jax"].extra["detection_summary"]
    got = runs["port"].extra["detection_summary"]
    assert got == want
    assert got["detections_total"] > 0 and got["false_removals"] == 0


def test_cli_json_summary(tmp_path):
    conf = tmp_path / "ring.conf"
    conf.write_text(_RING.format(n=64, drop=0, p=0, total=30, fail=10))
    out = subprocess.run(
        [sys.executable, "-m", "distributed_membership_tpu_torch",
         str(conf), "--device", "cpu", "--json", "--seed", "2",
         "--out-dir", str(tmp_path / "o")],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert '"device": "cpu"' in out.stdout.splitlines()[-1]
    assert (tmp_path / "o" / "dbg.log").exists()


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py imports JAX or any module of
    the JAX package: statically (every import statement, including those
    inside functions) and at run time (a fresh interpreter)."""
    assert {PKG / "grader.py", PKG / "ops" / "sampling.py",
            PKG / "ops" / "megakernel.py", PKG / "runtime" / "checkpoint.py",
            PKG / "observability" / "runlog.py",
            PKG / "runtime" / "application.py",
            PKG / "scenario" / "schema.py", PKG / "scenario" / "compile.py",
            PKG / "scenario" / "oracle.py",
            PKG / "observability" / "latency_dist.py",
            PKG / "observability" / "metricsbus.py",
            PKG / "observability" / "beacon.py",
            PKG / "observability" / "spans.py",
            PKG / "observability" / "watchdog.py",
            PKG / "service" / "__init__.py", PKG / "service" / "api.py",
            PKG / "service" / "daemon.py", PKG / "service" / "events.py",
            PKG / "service" / "replica.py",
            PKG / "service" / "shm_ring.py",
            PKG / "service" / "snapshot.py",
            PKG / "elastic" / "__init__.py", PKG / "elastic" / "reshard.py",
            PKG / "elastic" / "migrate.py", PKG / "fleet" / "__init__.py",
            PKG / "fleet" / "placement.py", PKG / "fleet" / "registry.py",
            PKG / "fleet" / "scheduler.py", PKG / "fleet" / "daemon.py",
            PKG / "sweeps" / "__init__.py",
            PKG / "sweeps" / "fleet_submit.py", PKG / "sweeps" / "phase.py",
            PKG / "chaos" / "__init__.py", PKG / "chaos" / "__main__.py",
            PKG / "chaos" / "fuzz.py", PKG / "chaos" / "shrink.py",
            PKG / "chaos" / "campaign.py"} <= set(_port_sources())
    for path in _port_sources():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib",
                                   "distributed_membership_tpu"), (
                    f"{path.relative_to(REPO)} imports {name}")
    code = (
        "import importlib, pkgutil, sys\n"
        "import distributed_membership_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'distributed_membership_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('distributed_membership_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_kernel_sources_all_listed():
    """kernels.build() compiles SOURCES and names each build by a hash of
    SOURCES and HEADERS only, so every csrc/*.cu must be a source and
    every csrc/*.cuh a header, or editing it would not rebuild."""
    from distributed_membership_tpu_torch import kernels
    csrc = PKG / "csrc"
    assert sorted(p.name for p in csrc.glob("*.cu")) == sorted(
        kernels.SOURCES.values())
    assert sorted(p.name for p in csrc.glob("*.cuh")) == sorted(
        kernels.HEADERS)


def test_default_device_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = tmp_path / "ring.conf"
    conf.write_text(_RING.format(n=64, drop=0, p=0, total=10, fail=5))
    with pytest.raises(RuntimeError, match="cuda"):
        application.run_conf(str(conf), out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        application.main([str(conf), "--out-dir", str(tmp_path)])
    assert not (tmp_path / "dbg.log").exists()


@pytest.mark.parametrize("extra", [
    "SHIFT_SET: 4\n", "ENFORCE_BUFFSIZE: 1\n",
    "CHECKPOINT_EVERY: 10\nSERVICE_PORT: 0\n",
    "PROBE_IO: approx_lag\n", "PROBE_IO: none\n"])
def test_outside_the_slice_is_refused(extra):
    """The ring-step options and SERVICE_PORT (the service daemon, Queue 1
    item 10b, now ported) resolve into the config as the JAX package's
    do."""
    from distributed_membership_tpu.backends import tpu_hash as jax_hash
    from distributed_membership_tpu.config import Params as JaxParams
    conf = _RING.format(n=64, drop=0, p=0, total=10, fail=5) + extra
    p = Params.from_text(conf)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = jax_hash.make_config(JaxParams.from_text(conf))
    for device in ("cpu", "cuda"):
        cfg = make_config(p, device=device)
        for field in ("shift_set", "send_budget", "probe_io_none",
                      "probe_io_lag", "count_probe_io", "n", "s",
                      "collect_events", "folded"):
            assert getattr(cfg, field) == getattr(jcfg, field), field


@pytest.mark.parametrize("extra,want", [
    ("CHECKPOINT_EVERY: 10\n", ("batched", 0, False)),
    ("CHECKPOINT_EVERY: 10\nMEGA_TICKS: 5\n", ("batched", 5, True)),
    ("CHECKPOINT_EVERY: 10\nRNG_MODE: hoisted\n", ("hoisted", 0, False))])
def test_item4_keys_resolve(extra, want):
    """Queue 1 item 4 is ported: the checkpoint, block and hoisting keys
    resolve into the config (auto packs within the 16-bit bound)."""
    p = Params.from_text(_RING.format(n=64, drop=0, p=0, total=10, fail=5)
                         + extra)
    cfg = make_config(p, device="cpu")
    assert (cfg.rng_mode, cfg.mega_ticks, cfg.mega_pack) == want


@pytest.mark.parametrize("tier", ["scalars", "hist"])
@pytest.mark.parametrize("extra", ["EXCHANGE: scatter\n",
                                   "BACKEND: tpu_sparse\n"])
def test_telemetry_off_the_ring_raises_as_jax(tier, extra):
    """TELEMETRY needs a ring step: the JAX package's ValueError, word for
    word, at conf validation."""
    from distributed_membership_tpu.config import Params as JaxParams
    conf = (_RING.format(n=64, drop=0, p=0, total=10, fail=5)
            + f"TELEMETRY: {tier}\n" + extra)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError) as want:
            JaxParams.from_text(conf)
    with pytest.raises(ValueError, match="TELEMETRY") as got:
        Params.from_text(conf)
    assert str(got.value) == str(want.value)


_FOLDED = ("MAX_NNB: {n}\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
           "MSG_DROP_PROB: 0\nVIEW_SIZE: {s}\nGOSSIP_LEN: 4\nPROBES: {p}\n"
           "FANOUT: 3\nTFAIL: 16\nTREMOVE: 40\nTOTAL_TIME: 10\n"
           "FAIL_TIME: 5\nJOIN_MODE: warm\nEXCHANGE: ring\n"
           "BACKEND: tpu_hash\nFOLDED: 1\n")


@pytest.mark.parametrize("conf,collect,device,jax_extra", [
    # full event mode
    (_FOLDED.format(n=256, s=16, p=2), True, "cpu", ""),
    # the scatter exchange
    (_FOLDED.format(n=256, s=16, p=2) + "EXCHANGE: scatter\n", False,
     "cpu", ""),
    # S does not divide 128
    (_FOLDED.format(n=256, s=48, p=8), False, "cpu", ""),
    # PROBES >= S
    (_FOLDED.format(n=256, s=16, p=16), False, "cpu", ""),
    # fewer than 8 plane rows where the kernels run (the JAX package
    # gates its folded kernels so; the port's kernels are the CUDA path)
    (_FOLDED.format(n=32, s=16, p=2), False, "cuda",
     "FUSED_RECEIVE: 1\n"),
], ids=["full_events", "scatter", "s48", "probes_ge_s", "few_rows"])
def test_folded_gates(conf, collect, device, jax_extra):
    """FOLDED: 1 outside the folded layout's scope raises the JAX
    package's ValueError, word for word."""
    from distributed_membership_tpu.backends import tpu_hash as jax_hash
    from distributed_membership_tpu.config import Params as JaxParams
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = JaxParams.from_text(conf + jax_extra)
        pp = Params.from_text(conf)
    with pytest.raises(ValueError) as want:
        jax_hash.make_config(jp, collect, fail_ids=(3,))
    with pytest.raises(ValueError) as got:
        make_config(pp, collect, fail_ids=(3,), device=device)
    assert str(got.value) == str(want.value)
    assert "FOLDED" in str(got.value) or "PROBES" in str(got.value)


def test_folded_auto_resolution():
    """FOLDED: -1 takes the folded layout on CUDA where its gates pass
    and S < 128, the natural layout otherwise, and always the natural
    one on the CPU."""
    conf = _FOLDED.format(n=256, s=16, p=2).replace("FOLDED: 1", "FOLDED: -1")
    p = Params.from_text(conf)
    assert make_config(p, False, fail_ids=(3,), device="cuda").folded
    assert not make_config(p, False, fail_ids=(3,), device="cpu").folded
    assert make_config(Params.from_text(conf.replace("FOLDED: -1",
                                                     "FOLDED: 1")),
                       False, fail_ids=(3,), device="cpu").folded
    s128 = Params.from_text(_RING.format(n=256, drop=0, p=0, total=10,
                                         fail=5))
    assert not make_config(s128, False, fail_ids=(3,), device="cuda").folded
    # Full events at S < 128 on CUDA: natural, and the natural kernels
    # refuse the view size, naming why FOLDED does not apply.
    with pytest.raises(NotImplementedError, match="FOLDED requires agg"):
        make_config(p, True, device="cuda")


def test_wide_views_refused_on_cuda():
    """K2 and K4 take rows wider than one 16 KiB tile on the card (their
    wide form): a natural ring conf past 4096 slots resolves on CUDA as
    on the CPU, where the plain versions run."""
    base = _RING.format(n=64, drop=0, p=0, total=10, fail=5).replace(
        "PROBES: 16", "PROBES: 0")
    wide = Params.from_text(base.replace("VIEW_SIZE: 128", "VIEW_SIZE: 4224"))
    assert make_config(wide, device="cuda").s == 4224
    assert make_config(wide, device="cpu").s == 4224
    assert make_config(Params.from_text(base.replace(
        "VIEW_SIZE: 128", "VIEW_SIZE: 4096")), device="cuda").s == 4096


def test_refusals_on_the_card_and_off():
    base = _RING.format(n=64, drop=0, p=0, total=10, fail=5)
    # On CUDA the kernels are the path: no pinned-off kernel, S % 128.
    with pytest.raises(NotImplementedError, match="FUSED_GOSSIP"):
        make_config(Params.from_text(base + "FUSED_GOSSIP: 0\n"),
                    device="cuda")
    with pytest.raises(NotImplementedError, match="VIEW_SIZE % 128"):
        make_config(Params.from_text(base.replace("VIEW_SIZE: 128",
                                                  "VIEW_SIZE: 64")
                                     .replace("GOSSIP_LEN: 32",
                                              "GOSSIP_LEN: 16")
                                     .replace("PROBES: 16", "PROBES: 8")),
                    device="cuda")
    # On the CPU a pinned-on kernel cannot run.
    with pytest.raises(NotImplementedError, match="FUSED_RECEIVE"):
        make_config(Params.from_text(base + "FUSED_RECEIVE: 1\n"),
                    device="cpu")
    # Under agg mode more than FAST_AGG_MAX_FAILED failed ids take the
    # AggStats path.
    assert not make_config(Params.from_text(base), collect_events=False,
                           fail_ids=tuple(range(9)), device="cpu").fast_agg
    # Other PRNG implementations have no portable stream.
    from distributed_membership_tpu_torch.runtime.failures import (
        make_run_key)
    with pytest.raises(NotImplementedError,
                       match="rbg: it draws from XLA's hardware RNG"):
        make_run_key(Params.from_text(base + "PRNG_IMPL: rbg\n"), 0)
    # A scenario runs with the checkpoints of item 4 too.
    assert make_config(Params.from_text(base + "SCENARIO: x.json\n"
                                        "CHECKPOINT_EVERY: 5\n"),
                       device="cpu").exchange == "ring"
    from distributed_membership_tpu_torch.backends import get_backend
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_backend("tpu_sparse")
