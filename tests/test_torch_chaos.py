"""The port's chaos campaigns (``distributed_membership_tpu_torch.chaos``)
against the JAX package's, byte for byte (tolerance 0).

* The fuzzer: schedule bytes, schedule and campaign digests and the
  per-kind apportionment equal the JAX fuzzer's for the specs of JAX
  ``test_fuzz_deterministic_valid_one_static`` and
  ``test_fuzz_migrate_event_optin``.
* A 16-schedule campaign at N=10 on the CPU: ``campaign.jsonl`` and every
  ``scenarios/*.json`` equal the JAX campaign's.
* The broken-config campaign of JAX
  ``test_broken_config_shrinks_reproducibly``: the same violations, the
  same shrunk repros, banked with the same bytes.
* ``test_campaign_migrate_inproc``'s spec (kill, same-shape reshard,
  resume) grades green and leaves its reshard chain; at N=64 on the
  folded layout (the card's) it journals as on the natural one.
* The journal skips a torn line; mode validation gives the JAX messages;
  on CUDA the default N=10 (VIEW_SIZE 10) raises the port's refusal.

Both packages write under the same relative names in their own
directories, so journals are compared with the directory replaced.
"""

import dataclasses
import json
import os
import warnings

import pytest
import torch

from distributed_membership_tpu import chaos as jax_chaos
from distributed_membership_tpu.chaos import campaign as jax_campaign
from distributed_membership_tpu_torch import chaos
from distributed_membership_tpu_torch.chaos import campaign
from distributed_membership_tpu_torch.chaos.__main__ import main as cli_main
from distributed_membership_tpu_torch.runtime.checkpoint import (
    load_manifest)

# JAX test_fuzz_deterministic_valid_one_static's specs and
# test_fuzz_migrate_event_optin's, as keyword arguments.
FUZZ_SPECS = {
    "default": {},
    "wide": dict(seed=11, n=32, events=8, total=200, name="wide"),
    "migrate": dict(seed=5, n=16, events=4, total=160,
                    mix={"crash": 1.0, "migrate": 1.0}),
}
BROKEN = (dict(seed=4, schedules=2, events=4,
               mix={"link_flake": 1.0, "drop_window": 1.0}, name="broken"),
          {"DROP_MSG": 1, "MSG_DROP_PROB": 0.6})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores (tests/test_torch_step.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_campaign(root, name, spec_kw, **kw):
    out = root / name
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        summary = jax_chaos.run_campaign(jax_chaos.CampaignSpec(**spec_kw),
                                         str(out), **kw)
    return out, summary


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's campaigns the tests compare with, run once."""
    root = tmp_path_factory.mktemp("jax_chaos")
    return {
        "c16": _jax_campaign(root, "c16", dict(seed=3, schedules=16,
                                               name="c16")),
        "broken": _jax_campaign(root, "broken", BROKEN[0],
                                overrides=BROKEN[1]),
    }


def _port_campaign(root, name, spec_kw, **kw):
    out = root / name
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        summary = chaos.run_campaign(chaos.CampaignSpec(**spec_kw), str(out),
                                     device="cpu", **kw)
    return out, summary


def _journal(out):
    return (out / "campaign.jsonl").read_text().replace(str(out), "OUT")


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("case", list(FUZZ_SPECS))
def test_fuzz_matches_jax(case):
    spec = chaos.CampaignSpec(**FUZZ_SPECS[case])
    jspec = jax_chaos.CampaignSpec(**FUZZ_SPECS[case])
    assert chaos.campaign_digest(spec) == jax_chaos.campaign_digest(jspec)
    assert dict(chaos.kind_counts(spec)) == dict(jax_chaos.kind_counts(jspec))
    for i in range(12):
        got, want = chaos.fuzz_schedule(spec, i), jax_chaos.fuzz_schedule(
            jspec, i)
        assert chaos.dump_schedule(got) == jax_chaos.dump_schedule(want)
        assert chaos.schedule_digest(got) == jax_chaos.schedule_digest(want)
    if case == "migrate":
        assert any(e["kind"] == "migrate"
                   for e in chaos.fuzz_schedule(spec, 0)["events"])


def test_campaign_matches_jax(tmp_path, jax_runs):
    """16 schedules at N=10 on the CPU: the journal and every schedule
    file are the JAX campaign's bytes."""
    want_out, want = jax_runs["c16"]
    out, summary = _port_campaign(tmp_path, "c16",
                                  dict(seed=3, schedules=16, name="c16"))
    assert summary == want
    assert summary["ok"] and summary["runs"] == 16
    assert _journal(out) == _journal(want_out)
    assert _files(out / "scenarios") == _files(want_out / "scenarios")
    assert len(_files(out / "scenarios")) == 16


def test_broken_config_banks_jax_repros(tmp_path, jax_runs):
    """The deliberately broken config (60% global loss, no maskable
    event): the same violations, shrunk to the same minimal repros,
    banked with the JAX package's bytes."""
    want_out, want = jax_runs["broken"]
    out, summary = _port_campaign(tmp_path, "broken", BROKEN[0],
                                  overrides=BROKEN[1])
    assert not summary["ok"] and summary["repros"]
    assert summary["violations"] == want["violations"]
    assert ([os.path.basename(p) for p in summary["repros"]]
            == [os.path.basename(p) for p in want["repros"]])
    assert _journal(out) == _journal(want_out)
    assert _files(out / "regressions") == _files(want_out / "regressions")


def test_campaign_migrate_inproc(tmp_path):
    """JAX ``test_campaign_migrate_inproc``'s spec: real kill + reshard +
    resume cycles on the CPU, graded green, with a same-shape reshard
    chain on the side checkpoint."""
    out, summary = _port_campaign(
        tmp_path, "mig", dict(seed=9, n=10, events=3, total=160,
                              schedules=1,
                              mix={"crash": 1.0, "one_way_flake": 1.0,
                                   "migrate": 1.0}),
        shrink=False)
    assert summary["ok"], summary
    chains = []
    scen = out / "scenarios"
    for name in os.listdir(scen):
        if name.endswith(".ckpt"):
            m = load_manifest(str(scen / name))
            if m:
                chains.extend(m.get("reshard", ()))
    assert chains, "migrate cycle never resharded a durable boundary"
    assert all(c["from_shape"] == c["to_shape"] for c in chains)


def test_folded_migrating_campaign_matches_natural(tmp_path, monkeypatch):
    """The card's layout on the CPU: the migrate spec at N=64 (S=16, P=4)
    with ``make_config`` resolving the folded layout, as the card does,
    grades and journals as the natural layout's campaign, through the
    folded step's chunked kill, reshard and resume."""
    from distributed_membership_tpu_torch.backends import tpu_hash

    spec = dict(seed=9, n=64, events=3, total=160, schedules=1,
                mix={"crash": 1.0, "one_way_flake": 1.0, "migrate": 1.0})
    nat, summary = _port_campaign(tmp_path, "nat", spec, shrink=False)
    real = tpu_hash.make_config
    seen = []

    def folded(*a, **kw):
        cfg = real(*a, **kw)
        seen.append(cfg)
        return dataclasses.replace(cfg, folded=True)
    monkeypatch.setattr(tpu_hash, "make_config", folded)
    fold, fsummary = _port_campaign(tmp_path, "fold", spec, shrink=False)
    assert seen and summary["ok"] and fsummary == summary
    assert _journal(fold) == _journal(nat)
    ck = [n for n in os.listdir(fold / "scenarios") if n.endswith(".ckpt")]
    assert ck and load_manifest(str(fold / "scenarios" / ck[0]))["reshard"]


def test_journal_torn_line_tolerated(tmp_path):
    path = str(tmp_path / "campaign.jsonl")
    j = campaign.Journal(path)
    j.append({"kind": "campaign", "digest": "d"})
    j.append({"kind": "graded", "run_id": "r0", "ok": True})
    j.close()
    with open(path, "a") as fh:            # crash mid-write: torn tail
        fh.write('{"kind": "graded", "run_id": "r1", "o')
    rows = chaos.read_journal(path)
    assert [r["kind"] for r in rows] == ["campaign", "graded"]
    assert rows == jax_chaos.read_journal(path)
    assert chaos.read_journal(str(tmp_path / "missing.jsonl")) == []


@pytest.mark.parametrize("kw", [dict(mode="warp"), dict(mode="fleet")])
def test_campaign_mode_validation(tmp_path, kw):
    with pytest.raises(ValueError) as want:
        jax_chaos.run_campaign(jax_chaos.CampaignSpec(), str(tmp_path / "j"),
                               **kw)
    with pytest.raises(ValueError) as got:
        chaos.run_campaign(chaos.CampaignSpec(), str(tmp_path / "p"),
                           device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_base_conf_matches_jax():
    for kw in ({}, dict(n=256), dict(n=65536, tfail=8, tremove=20)):
        for ov in ({}, BROKEN[1]):
            assert (campaign.base_conf(chaos.CampaignSpec(**kw), ov)
                    == jax_campaign.base_conf(jax_chaos.CampaignSpec(**kw),
                                              ov))


def test_cuda_refuses_the_default_geometry(tmp_path, capsys):
    """On CUDA the default N=10 campaign (VIEW_SIZE 10, which the folded
    layout does not take) resolves to the natural layout, whose kernels
    take any view size; a config the card still refuses (a pinned
    FUSED_GOSSIP: 0: the kernels are the path there) fails the campaign
    on its first run with the port's refusal -- raised before any tensor
    reaches a device, so it shows here too; the CLI exits 2."""
    from distributed_membership_tpu_torch.backends.tpu_hash import (
        make_config)
    from distributed_membership_tpu_torch.config import Params
    spec = chaos.CampaignSpec(schedules=1)
    params = Params.from_text(campaign.base_conf(spec))
    for collect in (True, False):
        cfg = make_config(params, collect, fail_ids=(3,), device="cuda")
        assert (cfg.n, cfg.s, cfg.folded) == (10, 10, False)
    with pytest.raises(NotImplementedError,
                       match="FUSED_GOSSIP: 0 on CUDA"):
        chaos.run_campaign(spec, str(tmp_path / "c"), device="cuda",
                           overrides={"FUSED_GOSSIP": "0"})
    rc = cli_main(["--out", str(tmp_path / "cli"), "--schedules", "1",
                   "--device", "cuda", "--set", "FUSED_GOSSIP=0"])
    assert rc == 2
    assert "FUSED_GOSSIP: 0 on CUDA" in capsys.readouterr().err
    rows = chaos.read_journal(str(tmp_path / "cli" / "campaign.jsonl"))
    assert [r["kind"] for r in rows] == ["campaign"]
    assert json.loads(json.dumps(rows[0]["spec"]))["n"] == 10
