"""The grader regime through the port: ``--grade-all`` and ``--grade``
against the JAX package, and the scatter exchange's configuration gates.

* ``application.main(["--grade-all", "--device", "cpu", "--seed", "3",
  "--backend", "tpu_hash"])`` prints ``Final grade 90``, and the three scenarios' ``dbg.log``,
  ``stats.log`` and ``msgcount.log`` are byte-identical to the JAX
  package's ``--grade-all --backend tpu_hash`` runs at the same seed
  (its ``run_scenario_graded``, which ``grade_all`` drives);
* the scatter exchange takes no kernel: ``FUSED_*: 1`` raises the JAX
  package's ValueError word for word, ``-1`` resolves off and a pinned 0
  is accepted on both devices; ``EVENT_MODE: agg`` on scatter stays
  refused, naming its queue item.
"""

import json
import warnings

import pytest
import torch

from distributed_membership_tpu.backends import tpu_hash as jax_hash
from distributed_membership_tpu.backends import (
    tpu_hash_sharded as jax_sharded)
from distributed_membership_tpu import grader as jax_grader
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.runtime import application as jax_app
from distributed_membership_tpu_torch.backends.tpu_hash import make_config
from distributed_membership_tpu_torch.backends.tpu_hash_sharded import (
    sharded_config)
from distributed_membership_tpu_torch import grader
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.runtime import application

SCENARIOS = ("singlefailure", "multifailure", "msgdropsinglefailure")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores, and torch's OpenMP workers would then wait on each
    other at every op of the tick loop."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_grade_all_on_cpu_matches_jax_logs(tmp_path, capsys,
                                           testcases_dir):
    rc = application.main(["--grade-all", "--device", "cpu", "--seed", "3",
                           "--backend", "tpu_hash",
                           "--out-dir", str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.splitlines()[-1] == "Final grade 90"
    assert out.count("Checking Join") == 3
    assert out.count("Checking Completeness") == 3
    assert out.count("Checking Accuracy") == 2   # msgdrop accuracy is off
    for scenario in SCENARIOS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, g = jax_app.run_scenario_graded(
                scenario, str(testcases_dir), "tpu_hash", 3,
                str(tmp_path / "jax" / scenario))
        assert g.passed
        for name in ("dbg.log", "stats.log", "msgcount.log"):
            want = (tmp_path / "jax" / scenario / name).read_bytes()
            got = (tmp_path / "port" / scenario / name).read_bytes()
            assert got == want, f"{scenario}/{name}"


def _dbg(n_fail_lines: int, removed: dict, joins: int = 10) -> str:
    """A dbg.log of N=10 with ``joins`` loggers seeing everyone, failure
    lines for the first ``n_fail_lines`` ids and ``removed[logger]`` the
    ids each logger removed."""
    lines = ["131"]
    for i in range(1, joins + 1):
        lines += [f" {i}.0.0.0:0 [5] Node {j}.0.0.0:0 joined at time 5"
                  for j in range(1, 11)]
    lines += [f" {i}.0.0.0:0 [100] Node failed at time = 100"
              for i in range(1, n_fail_lines + 1)]
    for logger, ids in removed.items():
        lines += [f" {logger}.0.0.0:0 [121] Node {j}.0.0.0:0 removed at "
                  "time 121" for j in ids]
    return "\n".join(lines)


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("case", ["pass", "late_join", "incomplete",
                                  "false_removal"])
def test_grader_copy_matches_jax(scenario, case):
    """The port's copy of the oracle scores every case as the JAX one."""
    removed = {i: [1] for i in range(2, 11)}
    n_fail, joins = (1, 10) if scenario != "multifailure" else (5, 10)
    if scenario == "multifailure":
        removed = {i: [1, 2, 3, 4, 5] for i in range(6, 11)}
    if case == "late_join":
        joins = 9
    elif case == "incomplete":
        removed = {k: v[1:] for k, v in list(removed.items())[:-1]}
    elif case == "false_removal":
        removed[10] = removed[10] + [9]
    text = _dbg(n_fail, removed, joins)
    want = jax_grader.SCENARIO_GRADERS[scenario](text, 10)
    got = grader.SCENARIO_GRADERS[scenario](text, 10)
    assert (got.points, got.max_points, got.join_ok, got.completeness_pts,
            got.accuracy_pts, got.details) == (
                want.points, want.max_points, want.join_ok,
                want.completeness_pts, want.accuracy_pts, want.details)
    # The msg-drop scenario does not grade accuracy (Grader_verbose.sh).
    assert got.passed == (case == "pass" or (
        case == "false_removal" and scenario == "msgdropsinglefailure"))


def test_grade_one_scenario_json(tmp_path, capsys, testcases_dir):
    conf = testcases_dir / "singlefailure.conf"
    rc = application.main([str(conf), "--backend", "tpu_hash", "--grade",
                           "singlefailure", "--device", "cpu", "--seed", "5",
                           "--json", "--out-dir", str(tmp_path)])
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0
    assert summary["grade"] == {"points": 30, "max": 30, "join": True,
                                "completeness": 10, "accuracy": 10}
    assert summary["backend"] == "tpu_hash"
    assert (tmp_path / "dbg.log").read_text().count("joined") >= 90


def test_grade_all_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        application.main(["--grade-all"])


def test_testcases_backend_emul_is_refused(testcases_dir, tmp_path):
    """Without --backend a testcase runs the reference's ``emul`` backend,
    which the port now has (the name is the one this test had while the
    port refused it): ``run_conf`` writes the JAX package's three logs,
    byte for byte."""
    conf = str(testcases_dir / "singlefailure.conf")
    result = application.run_conf(conf, out_dir=str(tmp_path / "p"),
                                  device="cpu")
    assert result.params.BACKEND == "emul"
    jax_app.run_conf(conf, out_dir=str(tmp_path / "j"))
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        assert ((tmp_path / "p" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name


def _testcase_params(testcases_dir, extra: str = "", jax: bool = False):
    text = ((testcases_dir / "singlefailure.conf").read_text()
            + "\nBACKEND: tpu_hash\n" + extra)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (JaxParams if jax else Params).from_text(text)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("knob", ["FUSED_RECEIVE", "FUSED_GOSSIP",
                                  "FUSED_PROBE"])
def test_scatter_fused_pinned_on_raises_jax_words(testcases_dir, knob,
                                                  device):
    extra = f"{knob}: 1\n"
    with pytest.raises(ValueError) as want:
        jax_hash.make_config(_testcase_params(testcases_dir, extra,
                                              jax=True))
    with pytest.raises(ValueError) as got:
        make_config(_testcase_params(testcases_dir, extra), device=device)
    assert str(got.value) == str(want.value)
    assert "requires the ring exchange" in str(got.value)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("value", [-1, 0])
def test_scatter_fused_off_on_both_devices(testcases_dir, value, device):
    """-1 resolves off (no kernel on the scatter step, in either package),
    and a pinned 0 is no CUDA refusal there; S=10 is no refusal either."""
    extra = "".join(f"{k}: {value}\n" for k in (
        "FUSED_RECEIVE", "FUSED_GOSSIP", "FUSED_PROBE"))
    cfg = make_config(_testcase_params(testcases_dir, extra), device=device)
    jcfg = jax_hash.make_config(_testcase_params(testcases_dir, extra,
                                                 jax=True))
    assert cfg.exchange == jcfg.exchange == "scatter"
    assert (cfg.s, cfg.qp, cfg.seed_cap, cfg.cold_join) == (
        jcfg.s, jcfg.qp, jcfg.seed_cap, True)
    assert not (jcfg.fused_receive or jcfg.fused_gossip or jcfg.fused_probe)
    assert not cfg.folded


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_scatter_agg_mode_still_refused(testcases_dir, device):
    """EVENT_MODE agg on the scatter exchange resolves to the AggStats
    path on both devices, as the JAX package's config does."""
    p = _testcase_params(testcases_dir, "EVENT_MODE: agg\n")
    cfg = make_config(p, collect_events=False, fail_ids=(3,), device=device)
    jcfg = jax_hash.make_config(
        _testcase_params(testcases_dir, "EVENT_MODE: agg\n", jax=True),
        collect_events=False, fail_ids=(3,))
    assert (cfg.exchange, cfg.fast_agg, cfg.collect_events) == (
        jcfg.exchange, jcfg.fast_agg, jcfg.collect_events) == (
        "scatter", False, False)


def test_sharded_scatter_still_refused(testcases_dir):
    """Cold joins on tpu_hash_sharded with EXCHANGE auto resolve to the
    scatter exchange, the JAX make_sharded_step, now ported (item 6c, on
    one card): the config is the JAX package's on both devices, with no
    kernel and no batched exchange."""
    text = ((testcases_dir / "singlefailure.conf").read_text()
            + "\nBACKEND: tpu_hash_sharded\nMESH_SHAPE: 5\n")
    p = Params.from_text(text)
    assert p.resolved_exchange() == "scatter"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_sharded.sharded_config(JaxParams.from_text(text), True,
                                          (3,), None, 2)
    for device in ("cpu", "cuda"):
        got = sharded_config(p, True, (3,), 2, device=device)
        assert (got.exchange, got.cold_join, got.batched_exchange,
                got.folded) == ("scatter", True, False, False)
        assert (got.s, got.qp, got.seed_cap, got.g, got.probes) == (
            want.s, want.qp, want.seed_cap, want.g, want.probes)
        assert not (want.fused_receive or want.fused_gossip
                    or want.fused_probe or want.batched_exchange)
