"""The port's flight recorder (observability/timeline.py, ``TELEMETRY:
scalars|hist``) against the JAX package's, on the CPU.

Compared, with tolerance 0:

* the histogram builders (``hist_bucket_counts``, ``scalar_one_hot``,
  ``drops_hist``, ``build_tick_hist``) against the JAX ones;
* ``TimelineRecorder``, ``read_timeline`` and ``timeline_summary``
  against the JAX ones, torn lines and the empty summary included;
* the per-tick ``extra["timeline"]`` series of whole runs on all four
  ring twins (natural, folded, sharded, sharded folded), drops on, both
  tiers, full event mode on the natural ring;
* telemetry-on runs against telemetry-off runs of the port (state and
  logs);
* ``timeline.jsonl`` and ``summary.json`` in ``TELEMETRY_DIR`` byte for
  byte, rendered by the repo's ``scripts/run_report.py``;
* ``--telemetry``/``--telemetry-dir`` through the port's command line.
"""

import json
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from distributed_membership_tpu.observability import timeline as jax_tl
from distributed_membership_tpu.runtime import application as jax_app
from distributed_membership_tpu_torch.convert import state_to_numpy
from distributed_membership_tpu_torch.observability import timeline as tl
from distributed_membership_tpu_torch.runtime import application

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


# ---------------------------------------------------------------------------
# The histogram builders

@pytest.mark.parametrize("shape", [(64, 16), (256, 128), (33, 7), (4096,)])
@pytest.mark.parametrize("nbins,width", [(8, 8), (16, 1), (64, 1)])
def test_hist_bucket_counts_match_jax(shape, nbins, width):
    """Small and non-multiple-of-8 tensors take the JAX unrolled form,
    large ones its nibble-packed form; both count as the port does."""
    rng = np.random.default_rng(sum(shape) + nbins + width)
    vals = rng.integers(-5, nbins * width + 20, size=shape).astype(np.int32)
    mask = rng.random(shape) < 0.6
    want = jax_tl.hist_bucket_counts(jnp.asarray(vals), jnp.asarray(mask),
                                     nbins, width)
    got = tl.hist_bucket_counts(torch.from_numpy(vals),
                                torch.from_numpy(mask), nbins, width)
    assert got.dtype == torch.int32
    _eq(got, want)


@pytest.mark.parametrize("idx", [-3, 0, 5, 63, 64, 200])
def test_scalar_one_hot_matches_jax(idx):
    want = jax_tl.scalar_one_hot(jnp.int32(idx), 64, jnp.int32(7))
    got = tl.scalar_one_hot(idx, 64, torch.tensor(7, dtype=torch.int32))
    _eq(got, want)


@pytest.mark.parametrize("dropped", [0, 1, 2, 3, 4, 1000, 2**14, 2**15,
                                     2**20])
def test_drops_hist_matches_jax(dropped):
    want = jax_tl.drops_hist(jnp.int32(dropped))
    got = tl.drops_hist(torch.tensor(dropped, dtype=torch.int32))
    _eq(got, want)


@pytest.mark.parametrize("partials", [False, True])
def test_build_tick_hist_matches_jax(partials):
    rng = np.random.default_rng(11)
    n, s, t, tfail = 128, 16, 90, 16
    difft = rng.integers(0, 80, size=(n, s)).astype(np.int32)
    present = rng.random((n, s)) < 0.7
    size = rng.integers(0, 20, size=n).astype(np.int32)
    act = rng.random(n) < 0.9
    stale = susp = None
    if partials:
        stale = rng.integers(0, 100, size=8).astype(np.int32)
        susp = rng.integers(0, 100, size=8).astype(np.int32)
    want = jax_tl.build_tick_hist(
        difft=jnp.asarray(difft), present=jnp.asarray(present),
        size=jnp.asarray(size), act=jnp.asarray(act), t=jnp.int32(t),
        fail_time=jnp.int32(40), tfail=tfail, det_tick=jnp.int32(5),
        dropped=jnp.int32(37),
        stale=None if stale is None else jnp.asarray(stale),
        susp=None if susp is None else jnp.asarray(susp))
    T = torch.from_numpy
    got = tl.build_tick_hist(
        difft=T(difft), present=T(present), size=T(size), act=T(act), t=t,
        fail_time=40, tfail=tfail,
        det_tick=torch.tensor(5, dtype=torch.int32),
        dropped=torch.tensor(37, dtype=torch.int32),
        stale=None if stale is None else T(stale),
        susp=None if susp is None else T(susp))
    assert got._fields == want._fields
    for f in want._fields:
        _eq(getattr(got, f), getattr(want, f), f)
    # pack_tick / unpack_series round-trip one tick.
    telem = tl.TickTelemetry(*(torch.tensor(i, dtype=torch.int32)
                               for i in range(10)))
    row = tl.pack_tick(telem, got).numpy()[None]
    back_t, back_h = tl.unpack_series(row, True)
    assert [int(v[0]) for v in back_t] == list(range(10))
    for f in want._fields:
        _eq(getattr(back_h, f)[0], getattr(want, f), f)


# ---------------------------------------------------------------------------
# The recorder and its readers

def _chunk(mod, val, k=10, hist=False):
    telem = mod.TickTelemetry(*(np.full((k,), val + i, np.int64)
                                for i in range(len(mod.TELEMETRY_FIELDS))))
    if not hist:
        return telem
    return telem, mod.TickHist(*(np.full((k, b), val, np.int64)
                                 for b in mod.HIST_BUCKETS.values()))


@pytest.mark.parametrize("hist", [False, True])
def test_recorder_matches_jax(tmp_path, hist):
    """Same flushes, same file bytes; the torn trailing line is skipped
    and the last record per t0 wins, in both readers."""
    for mod, d in ((jax_tl, tmp_path / "jax"), (tl, tmp_path / "port")):
        rec = mod.TimelineRecorder(str(d))
        rec.flush(_chunk(mod, 1, hist=hist), 0)
        rec.flush(_chunk(mod, 2, hist=hist), 10)
        rec.flush(_chunk(mod, 3, hist=hist), 10)   # a re-run segment
        with open(rec.path, "a") as fh:
            fh.write('{"t0": 20, "tic')             # torn trailing write
    name = tl.TIMELINE_NAME
    assert name == jax_tl.TIMELINE_NAME
    assert ((tmp_path / "port" / name).read_bytes()
            == (tmp_path / "jax" / name).read_bytes())
    want = jax_tl.read_timeline(str(tmp_path / "jax" / name))
    got = tl.read_timeline(str(tmp_path / "jax" / name))
    assert set(got) == set(want) and got["ticks"] == 20
    for k in want:
        _eq(got[k], want[k], k)
    assert list(got["live"][10:]) == [3] * 10
    assert tl.timeline_summary(got) == jax_tl.timeline_summary(want)
    mem = tl.TimelineRecorder(None)
    mem.flush(_chunk(tl, 4, hist=hist), 0)
    assert mem.path is None and mem.series()["ticks"] == 10


def test_timeline_summary_empty():
    assert (tl.timeline_summary(tl.TimelineRecorder(None).series())
            == jax_tl.timeline_summary(jax_tl.TimelineRecorder(None).series())
            == {"ticks": 0})


def test_schema_constants_match_jax():
    assert tl.TELEMETRY_FIELDS == jax_tl.TELEMETRY_FIELDS
    assert tl.HIST_FIELDS == jax_tl.HIST_FIELDS
    assert tl.HIST_BUCKETS == jax_tl.HIST_BUCKETS
    assert tl.STALENESS_BUCKET_TICKS == jax_tl.STALENESS_BUCKET_TICKS
    assert tl.PHASE_NAMES == jax_tl.PHASE_NAMES
    assert {v for k, v in vars(tl).items() if k.startswith("PHASE_")
            and isinstance(v, str)} == {
        v for k, v in vars(jax_tl).items() if k.startswith("PHASE_")
        and isinstance(v, str)}


# ---------------------------------------------------------------------------
# Whole runs: the four ring twins

_RUN = ("MAX_NNB: {n}\nSINGLE_FAILURE: 1\nDROP_MSG: 1\nMSG_DROP_PROB: 0.05\n"
        "DROP_START: 10\nDROP_STOP: 70\nVIEW_SIZE: {s}\nGOSSIP_LEN: {g}\n"
        "PROBES: {p}\nFANOUT: 3\nTFAIL: 16\nTREMOVE: 40\nTOTAL_TIME: 80\n"
        "FAIL_TIME: 20\nJOIN_MODE: warm\nEXCHANGE: ring\n")
_NAT = _RUN.format(n=256, s=128, g=32, p=16)
_FOLD = _RUN.format(n=256, s=16, g=4, p=2) + "EVENT_MODE: agg\nFOLDED: 1\n"
_SHF = _RUN.format(n=512, s=16, g=4, p=2) + "EVENT_MODE: agg\nFOLDED: 1\n"
TWINS = {
    "natural_full": _NAT + "BACKEND: tpu_hash\n",
    "natural_agg": _NAT + "BACKEND: tpu_hash\nEVENT_MODE: agg\n",
    "folded": _FOLD + "BACKEND: tpu_hash\n",
    "sharded_full": _NAT + "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8\n",
    "sharded_agg": (_NAT + "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8\n"
                    "EVENT_MODE: agg\n"),
    "sharded_folded": _SHF + "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8\n",
}


def _run(tmp_path, text, which, seed=3, **kw):
    conf = tmp_path / f"{which}.conf"
    conf.write_text(text)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if which == "jax":
            return jax_app.run_conf(str(conf), seed=seed,
                                    out_dir=str(tmp_path / which), **kw)
        return application.run_conf(str(conf), seed=seed,
                                    out_dir=str(tmp_path / which),
                                    device="cpu", **kw)


@pytest.mark.parametrize("tier", ["scalars", "hist"])
@pytest.mark.parametrize("twin", list(TWINS))
def test_twin_timelines_match_jax(tmp_path, twin, tier):
    text = TWINS[twin] + f"TELEMETRY: {tier}\n"
    want = _run(tmp_path, text, "jax").extra["timeline"]
    got = _run(tmp_path, text, "port").extra["timeline"]
    assert set(got) == set(want)
    assert ("h_latency" in got) == (tier == "hist")
    for k in want:
        _eq(got[k], want[k], k)
    assert got["ticks"] == 80
    assert got["dropped"].sum() > 0 and got["removals"].sum() > 0
    if "agg" in twin or "folded" in twin:
        assert got["detections"].sum() > 0


@pytest.mark.parametrize("twin", ["natural_full", "folded", "sharded_full",
                                  "sharded_folded"])
def test_telemetry_leaves_the_trajectory_alone(tmp_path, twin):
    """A hist run's final state and logs (or detection summary) equal
    those of the same conf with TELEMETRY off."""
    on = _run(tmp_path, TWINS[twin] + "TELEMETRY: hist\n", "on")
    off = _run(tmp_path, TWINS[twin], "off")
    assert "timeline" in on.extra and "timeline" not in off.extra
    a = state_to_numpy(on.extra["final_state"])
    b = state_to_numpy(off.extra["final_state"])
    assert set(a) == set(b)
    for k in a:
        _eq(a[k], b[k], k)
    if on.extra.get("aggregate"):
        assert on.extra["detection_summary"] == off.extra["detection_summary"]
    else:
        for name in ("dbg.log", "stats.log", "msgcount.log"):
            assert ((tmp_path / "on" / name).read_bytes()
                    == (tmp_path / "off" / name).read_bytes()), name


@pytest.mark.parametrize("twin", ["natural_agg", "sharded_folded"])
def test_telemetry_dir_byte_identical_and_renders(tmp_path, twin):
    """``timeline.jsonl`` and ``summary.json`` are the JAX package's, byte
    for byte, and the repo's run_report renders the port's directory with
    the series reconciled against the summary."""
    sys.path.insert(0, str(REPO / "scripts"))
    import run_report

    dirs = {w: tmp_path / f"rec_{w}" for w in ("jax", "port")}
    res = {w: _run(tmp_path, TWINS[twin], w, telemetry="hist",
                   telemetry_dir=str(dirs[w])) for w in dirs}
    for name in ("timeline.jsonl", "summary.json"):
        assert ((dirs["port"] / name).read_bytes()
                == (dirs["jax"] / name).read_bytes()), name
    assert res["port"].extra["timeline_path"] == str(
        dirs["port"] / "timeline.jsonl")
    report = run_report.build_report(str(dirs["port"]))
    assert report["reconciliation"] == {
        "joins_match": True, "removals_match": True,
        "hist_latency_matches_detections": True}
    assert "joins_total" in run_report.render_markdown(report)
    series = tl.read_timeline(str(dirs["port"] / "timeline.jsonl"))
    summary = json.loads((dirs["port"] / "summary.json").read_text())
    assert int(series["detections"].sum()) == summary["detections_total"]
    assert int(series["msgs_sent"].sum()) == summary["msgs_sent"]
    assert int(series["msgs_recv"].sum()) == summary["msgs_recv"]
    assert int(series["h_latency"].sum()) == summary["detections_total"]


def test_cli_telemetry_flags(tmp_path):
    """``--telemetry``/``--telemetry-dir`` override the conf, and the JSON
    summary names the timeline."""
    conf = tmp_path / "ring.conf"
    conf.write_text(TWINS["natural_agg"].replace("TOTAL_TIME: 80",
                                                 "TOTAL_TIME: 30"))
    rec = tmp_path / "rec"
    out = subprocess.run(
        [sys.executable, "-m", "distributed_membership_tpu_torch",
         str(conf), "--device", "cpu", "--json", "--telemetry", "scalars",
         "--telemetry-dir", str(rec), "--out-dir", str(tmp_path / "o")],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.splitlines()[-1])
    assert summary["timeline_path"] == str(rec / "timeline.jsonl")
    series = tl.read_timeline(summary["timeline_path"])
    assert series["ticks"] == 30 and "h_latency" not in series
    assert (rec / "summary.json").exists()
