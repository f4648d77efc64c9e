"""The port's host backends, ``emul`` and ``emul_native``, against the
JAX package.

Both run on the host in either package (numpy and Python ``random``;
the native engine built from the port's own copy of
``native/emul_engine.cpp``).  Compared byte for byte: the three logs of
the grader's testcases, with and without a ``SCENARIO:`` file (the
legacy twins of ``scenarios/`` and a general schedule at N=10 with every
event kind on ``emul``), the scenario oracle's report, ``--grade-all``
with no ``--backend`` (now ``emul``, as in the JAX package), and the
engine's loader, which builds into the port's ``_build/`` and never
reaches the JAX package's ``native/``.
"""

import ctypes
import json
import pathlib

import pytest

from distributed_membership_tpu.backends import emul_native as jax_native
from distributed_membership_tpu.runtime import application as jax_app
from distributed_membership_tpu_torch.backends import emul_native
from distributed_membership_tpu_torch.runtime import application

REPO = pathlib.Path(__file__).resolve().parent.parent
TESTCASES = ("singlefailure", "multifailure", "msgdropsinglefailure")
LOGS = ("dbg.log", "stats.log", "msgcount.log")

# Every event kind at N=10: a crash and a restart, a leave, a partition,
# a two-way and a one-way flake, a delay window and a drop window.
GENERAL = {
    "name": "every_kind_n10",
    "events": [
        {"kind": "crash", "time": 60, "nodes": [3]},
        {"kind": "restart", "time": 140, "nodes": [3]},
        {"kind": "leave", "time": 300, "range": [8, 10]},
        {"kind": "partition", "start": 180, "stop": 230,
         "groups": [[0, 5], [5, 10]]},
        {"kind": "link_flake", "start": 100, "stop": 160, "src": [0, 5],
         "dst": [5, 10], "drop_prob": 0.3},
        {"kind": "one_way_flake", "start": 250, "stop": 270, "src": [1, 2],
         "dst": [0, 10]},
        {"kind": "delay_window", "start": 400, "stop": 420, "dst": [2, 4]},
        {"kind": "drop_window", "start": 450, "stop": 500,
         "drop_prob": 0.2},
    ]}


def _logs(d: pathlib.Path) -> dict:
    return {f: (d / f).read_bytes() for f in LOGS}


def _both(conf, tmp_path, **kw):
    want = jax_app.run_conf(str(conf), out_dir=str(tmp_path / "j"), **kw)
    got = application.run_conf(str(conf), out_dir=str(tmp_path / "p"),
                               device="cpu", **kw)
    assert _logs(tmp_path / "p") == _logs(tmp_path / "j")
    return want, got


@pytest.mark.parametrize("backend", ["emul", "emul_native"])
@pytest.mark.parametrize("scenario", TESTCASES)
def test_testcase_logs_byte_identical(backend, scenario, testcases_dir,
                                      tmp_path):
    want, got = _both(testcases_dir / f"{scenario}.conf", tmp_path,
                      backend=backend)
    assert got.failed_indices == want.failed_indices
    assert got.params.BACKEND == backend


@pytest.mark.parametrize("backend", ["emul", "emul_native"])
@pytest.mark.parametrize("scenario", TESTCASES)
def test_legacy_scenario_files_byte_identical(backend, scenario,
                                              testcases_dir, tmp_path):
    """``scenarios/<testcase>.json``, the legacy twins, lower to the
    failure plan in both packages."""
    _both(testcases_dir / "singlefailure.conf", tmp_path, backend=backend,
          scenario=str(REPO / "scenarios" / f"{scenario}.json"))


@pytest.mark.parametrize("scenario", [
    "general", "regressions/repro-e4f4b5d207ed1b87.json"])
def test_general_scenarios_on_emul(scenario, testcases_dir, tmp_path):
    """General schedules run on ``emul`` through ``ScenarioHost``: the
    logs and the oracle's report equal the JAX package's."""
    if scenario == "general":
        path = tmp_path / "every_kind.json"
        path.write_text(json.dumps(GENERAL))
    else:
        path = REPO / "scenarios" / scenario
    want, got = _both(testcases_dir / "msgdropsinglefailure.conf", tmp_path,
                      backend="emul", scenario=str(path))
    assert got.extra["scenario_report"] == want.extra["scenario_report"]
    assert got.extra["final_lists"] == want.extra["final_lists"]


def test_general_scenario_refused_on_emul_native(testcases_dir, tmp_path):
    path = tmp_path / "every_kind.json"
    path.write_text(json.dumps(GENERAL))
    conf = str(testcases_dir / "singlefailure.conf")
    with pytest.raises(ValueError) as want:
        jax_app.run_conf(conf, backend="emul_native", scenario=str(path),
                         out_dir=str(tmp_path / "j"))
    with pytest.raises(ValueError) as got:
        application.run_conf(conf, backend="emul_native", device="cpu",
                             scenario=str(path), out_dir=str(tmp_path / "p"))
    assert str(got.value) == str(want.value)


def test_grade_all_defaults_to_emul(tmp_path, capsys):
    """``--grade-all`` with no ``--backend`` grades the testcases on
    ``emul``; the logs are the JAX package's ``--grade-all``'s."""
    assert application.GRADE_BACKEND == "emul"
    rc = application.main(["--grade-all", "--device", "cpu", "--seed", "3",
                           "--out-dir", str(tmp_path / "p")])
    assert rc == 0
    assert "Final grade 90" in capsys.readouterr().out
    for scenario in TESTCASES:
        _, g = jax_app.run_scenario_graded(
            scenario, str(REPO / "testcases"), None, 3,
            str(tmp_path / "j" / scenario))
        assert g.passed
        assert (_logs(tmp_path / "p" / scenario)
                == _logs(tmp_path / "j" / scenario))


def test_native_engine_is_the_ports_own():
    """The loader builds the port's copy of the engine into the port's
    ``_build/``, named by the source's hash, with the JAX loader's ctypes
    layout; the copy is the JAX package's engine, byte for byte."""
    pkg = REPO / "distributed_membership_tpu_torch"
    assert pathlib.Path(emul_native.SRC) == pkg / "native" / "emul_engine.cpp"
    assert (pathlib.Path(emul_native.SRC).read_bytes()
            == (REPO / "distributed_membership_tpu" / "native"
                / "emul_engine.cpp").read_bytes())
    so = pathlib.Path(emul_native.build())
    assert so.parent == pkg / "_build" and so.exists()
    assert so.name.startswith("emul_engine_") and so.suffix == ".so"
    assert "distributed_membership_tpu/" not in str(
        pathlib.Path(emul_native._lib()._name).resolve().relative_to(REPO))
    assert ([(f, ctypes.sizeof(t)) for f, t in emul_native.DmConfig._fields_]
            == [(f, ctypes.sizeof(t))
                for f, t in jax_native.DmConfig._fields_])
    assert ctypes.sizeof(emul_native.DmConfig) == ctypes.sizeof(
        jax_native.DmConfig)


def test_testcase_without_backend_runs_emul(testcases_dir, tmp_path):
    """The CLI's conf run: no ``BACKEND`` key means ``emul``, on the host
    under ``--device cpu``."""
    rc = application.main([str(testcases_dir / "singlefailure.conf"),
                           "--device", "cpu", "--out-dir",
                           str(tmp_path / "p"), "--grade", "singlefailure"])
    assert rc == 0
    jax_app.run_conf(str(testcases_dir / "singlefailure.conf"),
                     out_dir=str(tmp_path / "j"))
    assert _logs(tmp_path / "p") == _logs(tmp_path / "j")
