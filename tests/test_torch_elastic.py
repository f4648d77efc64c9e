"""The port's elastic mesh (elastic/reshard.py, elastic/migrate.py,
fleet/placement.py) against the JAX package's, on the CPU with
tolerance 0.

Mirrors the host-side units of ``tests/test_elastic.py`` on the port's
modules, each result also held against the JAX module's on the same
input:

* reshard round trips across geometry pairs on synthetic checkpoints:
  the same npz members and manifest as the JAX ``reshard`` (apart from
  the ``ts`` and ``wrote_at`` stamps), chained provenance, every refusal
  with the JAX message, the CLI's exit code 2 and ``mesh_size``'s
  grammar;
* real eight-shard checkpoints: one written by the JAX package and
  resharded by the port, one written by the port and resharded by the
  JAX package, each equal to the other package's reshard;
* the headline pin: a port run killed at ``MESH_SHAPE: 8``, resharded to
  4x2 and resumed with ``mesh_shape="4x2"``, gives the dbg.log and
  stats.log of a 4x2 twin run from tick 0, and of the JAX package's
  resharded resume of the same conf (plain, and in ``MEGA_TICKS`` blocks
  with the flight recorder, whose timeline must match too);
* the placement capacity model, the migration policy, the journaled
  ``migrating`` -> ``requeued`` transition and the reap classifier, each
  with the JAX module's answer.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

import torch

from distributed_membership_tpu.elastic import migrate as jax_migrate
from distributed_membership_tpu.elastic import reshard as jax_reshard
from distributed_membership_tpu.fleet import placement as jax_placement
from distributed_membership_tpu.runtime import application as jax_app
from distributed_membership_tpu.runtime import checkpoint as jax_ck
from distributed_membership_tpu_torch.elastic.migrate import (
    DEFAULT_ALERT_RULES, MigratePolicy, alert_count, migrate_record)
from distributed_membership_tpu_torch.elastic.reshard import (
    ReshardError, mesh_size, reshard, validate_geometry)
from distributed_membership_tpu_torch.elastic.reshard import (
    main as reshard_main)
from distributed_membership_tpu_torch.fleet.daemon import FleetState
from distributed_membership_tpu_torch.fleet.placement import (
    DeviceSlice, HostCapacity, PlacementError)
from distributed_membership_tpu_torch.fleet.registry import (
    JOURNAL_NAME as FLEET_JOURNAL)
from distributed_membership_tpu_torch.fleet.registry import (
    FleetJournal, Registry)
from distributed_membership_tpu_torch.fleet.scheduler import Scheduler
from distributed_membership_tpu_torch.runtime import application
from distributed_membership_tpu_torch.runtime.checkpoint import (
    CKPT_VERSION, CRASH_ENV, MANIFEST_NAME, load_manifest, state_hash)


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
    monkeypatch.delenv(CRASH_ENV, raising=False)


_HASH_CONF = ("MAX_NNB: 16\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
              "MSG_DROP_PROB: 0.0\nVIEW_SIZE: 8\nFAIL_TIME: 1000\n"
              "JOIN_MODE: warm\nBACKEND: tpu_hash\nEVENT_MODE: full\n"
              "CHECKPOINT_EVERY: 30\nTELEMETRY: scalars\n")
_EMUL_CONF = ("MAX_NNB: 16\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
              "MSG_DROP_PROB: 0.0\nVIEW_SIZE: 8\nFAIL_TIME: 50\n"
              "BACKEND: emul\nTOTAL_TIME: 150\n")


def _hash_conf(total=120):
    return _HASH_CONF + f"TOTAL_TIME: {total}\n"


# ---------------------------------------------------------------------------
# Synthetic checkpoints: the on-disk format, built by hand


def _write_ckpt(d, *, n=32, s=4, shape="8", procs=1, total=200,
                tick=40, folded=0, seed=0):
    rng = np.random.default_rng(7)
    leaves = [
        rng.random((n, s)) < 0.5,                          # bool plane
        rng.integers(0, 100, (n, s)).astype(np.int32),     # fits16 lanes
        rng.integers(0, 100, n).astype(np.int32),          # row vector
        np.int32(tick),                                    # scalar leaf
        rng.random((n,)).astype(np.float32),
    ]
    payload = {"e_hist": rng.random(5)}
    params = {"EN_GPSZ": n, "VIEW_SIZE": s, "MESH_SHAPE": shape,
              "FOLDED": folded, "BACKEND": "tpu_hash_sharded"}
    fname = f"ckpt_{tick:08d}.npz"
    manifest = {
        "version": CKPT_VERSION, "tick": tick,
        "state_hash": state_hash(leaves),
        "params_text": json.dumps(params, sort_keys=True),
        "seed": seed, "backend": "tpu_hash_sharded",
        "total_time": total, "process_count": procs, "file": fname,
        "checkpoints": [{"tick": tick, "file": fname}],
    }
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, fname),
             **{f"c{i}": leaf for i, leaf in enumerate(leaves)},
             **payload)
    with open(os.path.join(d, MANIFEST_NAME), "w") as fh:
        json.dump(manifest, fh)
    return leaves, manifest


def _read_arrays(d):
    m = load_manifest(d)
    with np.load(os.path.join(d, m["file"])) as npz:
        return {k: npz[k] for k in npz.files}, m


_STAMPS = ("ts", "wrote_at")


def _unstamped(m):
    """A manifest without its wall-clock stamps (its own and every
    provenance record's)."""
    out = {k: v for k, v in m.items() if k not in _STAMPS}
    out["reshard"] = [{k: v for k, v in r.items() if k not in _STAMPS}
                      for r in m.get("reshard", ())]
    return out


def _same_checkpoint(a, b):
    """Two checkpoint dirs hold the same npz members (names, dtypes,
    bytes), the same files and the same manifest but for the stamps."""
    (xa, ma), (xb, mb) = _read_arrays(a), _read_arrays(b)
    assert sorted(xa) == sorted(xb)
    for k in xa:
        assert xa[k].dtype == xb[k].dtype and xa[k].shape == xb[k].shape, k
        assert xa[k].tobytes() == xb[k].tobytes(), k
    assert _unstamped(ma) == _unstamped(mb)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))


# ---------------------------------------------------------------------------
# Reshard on synthetic checkpoints


@pytest.mark.parametrize("src_geo,dst_geo,pack16", [
    (("8", 1), ("4x2", 1), False),     # shape change, one process
    (("8", 1), ("8", 2), False),       # process count change
    (("2x4", 2), ("4x2", 1), False),   # both change, 2 source procs
    (("4", 1), ("2x2", 1), True),      # pack16 codec arm
])
def test_reshard_roundtrip_geometries(tmp_path, src_geo, dst_geo, pack16):
    """Carry bit-identical, manifest retargeted (MESH_SHAPE and
    process_count), provenance stamped; the files and the stats (but
    for the seconds) equal the JAX reshard's of the same source."""
    (from_shape, from_procs), (to_shape, to_procs) = src_geo, dst_geo
    srcs = [str(tmp_path / f"s{i}") for i in range(from_procs)]
    for d in srcs:
        leaves, _ = _write_ckpt(d, shape=from_shape, procs=from_procs)
    got = {}
    for tag, fn in (("port", lambda s, d, **k: reshard(s, d, device="cpu",
                                                        **k)),
                    ("jax", jax_reshard.reshard)):
        dsts = [str(tmp_path / f"{tag}{i}") for i in range(to_procs)]
        got[tag] = (fn(srcs, dsts, to_mesh_shape=to_shape, pack16=pack16),
                    dsts)
    stats, dsts = got["port"]
    assert stats["from_shape"] == from_shape
    assert stats["to_shape"] == to_shape
    assert stats["from_procs"] == from_procs
    assert stats["to_procs"] == to_procs
    assert stats["tick"] == 40
    assert stats["carry_bytes_packed"] < stats["carry_bytes_full"]
    assert stats["codec_seconds"] >= 0
    for d in dsts:
        arrays, m = _read_arrays(d)
        assert int(m["process_count"]) == to_procs
        assert json.loads(m["params_text"])["MESH_SHAPE"] == to_shape
        for i, leaf in enumerate(leaves):
            out = arrays[f"c{i}"]
            assert out.dtype == np.asarray(leaf).dtype
            assert np.array_equal(out, leaf)
        assert "e_hist" in arrays
        chain = m["reshard"]
        assert len(chain) == 1 and chain[0]["from_shape"] == from_shape
        assert chain[0]["carry_digest"] == m["state_hash"]
    jstats, jdsts = got["jax"]
    timed = ("codec_seconds", "redistribute_seconds", "wall_seconds")
    assert ({k: v for k, v in stats.items() if k not in timed}
            == {k: v for k, v in jstats.items() if k not in timed})
    for d, jd in zip(dsts, jdsts):
        _same_checkpoint(d, jd)


def test_reshard_provenance_survives_chained_migrations(tmp_path):
    d0, d1 = str(tmp_path / "a"), str(tmp_path / "b")
    _write_ckpt(d0, shape="8")
    reshard([d0], [d1], to_mesh_shape="4x2", device="cpu")
    reshard([d1], [d1], to_mesh_shape="2x2x2", device="cpu")
    chain = load_manifest(d1)["reshard"]
    assert [(r["from_shape"], r["to_shape"]) for r in chain] == [
        ("8", "4x2"), ("4x2", "2x2x2")]
    # Stale snapshots from the old topology were dropped on fan-out.
    npzs = [f for f in os.listdir(d1) if f.endswith(".npz")]
    assert npzs == [load_manifest(d1)["file"]]
    # The JAX package's chain over the same two steps: the same files.
    j0, j1 = str(tmp_path / "ja"), str(tmp_path / "jb")
    _write_ckpt(j0, shape="8")
    jax_reshard.reshard([j0], [j1], to_mesh_shape="4x2")
    jax_reshard.reshard([j1], [j1], to_mesh_shape="2x2x2")
    _same_checkpoint(d1, j1)


def _refusal(fn, *args, **kw):
    with pytest.raises(ValueError) as ei:
        fn(*args, **kw)
    return type(ei.value).__name__, str(ei.value)


def _refusal_cases(tmp_path):
    """``(label, args, kwargs, match)`` refusals on synthetic sources."""
    src = str(tmp_path / "src")
    _write_ckpt(src, n=32, shape="8", total=200)
    big = str(tmp_path / "big")
    _write_ckpt(big, total=200_000)
    two = str(tmp_path / "two")
    othr = str(tmp_path / "othr")
    _write_ckpt(two, procs=2)
    _write_ckpt(othr, procs=2, tick=60)
    bad = str(tmp_path / "bad")
    leaves, m = _write_ckpt(bad)
    leaves[1][0, 0] += 1
    np.savez(os.path.join(bad, m["file"]),
             **{f"c{i}": leaf for i, leaf in enumerate(leaves)})
    x = str(tmp_path / "x")
    return [
        ("indivisible", ([src], [x]), {"to_mesh_shape": "7"},
         "does not divide N=32"),
        ("procs", ([src], [str(tmp_path / f"x{i}") for i in range(3)]),
         {"to_mesh_shape": "8"}, "does not divide across 3"),
        ("grammar", ([src], [x]), {"to_mesh_shape": "4xx2"},
         "must be 'D', 'OxI'"),
        ("missing", ([str(tmp_path / "nope")], [x]), {},
         "nothing durable"),
        ("pack16", ([big], [x]), {"pack16": True}, "PACK_SAFE_TICKS"),
        ("every_source", ([two], [x]), {}, "every source"),
        ("disagree", ([two, othr], [x]), {}, "disagree"),
        ("corrupt", ([bad], [x]), {}, "corrupt"),
        ("no_dirs", ([], [x]), {}, "at least one --src"),
    ]


def test_reshard_refusals_name_the_violated_bound(tmp_path):
    """Every refusal of tests/test_elastic.py, raised by the port with
    the JAX package's exception name and message, before any write."""
    for label, args, kw, match in _refusal_cases(tmp_path):
        got = _refusal(reshard, *args, device="cpu", **kw)
        want = _refusal(jax_reshard.reshard, *args, **kw)
        assert got == want, label
        assert match in got[1], label
        assert got[0] == "ReshardError", label
    assert not os.path.exists(tmp_path / "x")
    for args in ((32, 100, "8", "32", 1, 1), (32, 100, "x8", "8", 1, 1),
                 (32, 100, "8", "8", 1, 0)):
        got = _refusal(validate_geometry, *args, folded=True)
        assert got == _refusal(jax_reshard.validate_geometry, *args,
                               folded=True)
    assert "even per-device row count" in _refusal(
        validate_geometry, 32, 100, "8", "32", 1, 1, folded=True)[1]


def test_reshard_cli_roundtrip_and_refusal_rc2(tmp_path, capsys):
    src, dst = str(tmp_path / "s"), str(tmp_path / "d")
    _write_ckpt(src, shape="8")
    assert reshard_main(["--src", src, "--dst", dst,
                         "--mesh-shape", "4x2", "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["to_shape"] == "4x2"
    assert reshard_main(["--src", dst, "--dst", dst,
                         "--mesh-shape", "7", "--device", "cpu"]) == 2
    got = capsys.readouterr().out
    assert "does not divide N=32" in got
    assert jax_reshard.main(["--src", dst, "--dst", dst,
                             "--mesh-shape", "7"]) == 2
    assert capsys.readouterr().out == got


def test_mesh_size_and_grammar():
    assert mesh_size("") == 1 and mesh_size("", default=4) == 4
    assert mesh_size("8") == 8 and mesh_size("2x4") == 8
    assert mesh_size("2x2x2") == 8
    for shape, default in (("", 1), ("", 4), ("8", 1), ("2x4", 3),
                           ("2x2x2", 1), ("16X1", 1)):
        assert mesh_size(shape, default) == jax_reshard.mesh_size(
            shape, default)
    with pytest.raises(ReshardError, match="source MESH_SHAPE"):
        validate_geometry(32, 100, "x8", "8", 1, 1)
    with pytest.raises(ReshardError, match=">= 1"):
        validate_geometry(32, 100, "8", "8", 1, 0)


def test_reshard_codec_counts_like_jax(tmp_path):
    """The packed byte count of the bit and u16 lanes on leaves whose
    sizes do not fill a word (odd last dimension, 33 bools), with values
    at the lanes' edges: the JAX codec's count, the carry unchanged."""
    from distributed_membership_tpu_torch.elastic import reshard as rs
    rng = np.random.default_rng(1)
    leaves = [rng.random((3, 11)) < 0.5, np.array(True),
              np.array([[-1, 65534, 0]], np.int32),
              np.array([[-2, 5, 6]], np.int32),
              np.arange(5, dtype=np.uint32)]
    for pack16 in (False, True):
        got = rs._codec_roundtrip(leaves, pack16, 100, torch.device("cpu"))
        want = jax_reshard._codec_roundtrip(leaves, pack16, 100)
        for k in ("carry_bytes_full", "carry_bytes_packed"):
            assert got[k] == want[k], (pack16, k)


# ---------------------------------------------------------------------------
# Real eight-shard checkpoints, across the two packages

_SHARD_CONF = ("MAX_NNB: 16\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
               "MSG_DROP_PROB: 0.0\nVIEW_SIZE: 8\nFAIL_TIME: 30\n"
               "JOIN_MODE: warm\nBACKEND: tpu_hash_sharded\n"
               "EVENT_MODE: full\nEN_GPSZ: 32\nTOTAL_TIME: 60\n")
_MEGA = "MEGA_TICKS: 10\nTELEMETRY: scalars\n"
SEED = 3


def _run(pkg, conf, out, crash_at=None, monkeypatch=None, **kw):
    """One run of ``pkg``'s run_conf (the port's on the CPU); with
    ``crash_at`` it must stop with the injected crash."""
    if crash_at is not None:
        monkeypatch.setenv(CRASH_ENV, str(crash_at))
    try:
        if pkg == "port":
            application.run_conf(str(conf), seed=SEED, out_dir=str(out),
                                 device="cpu", **kw)
        else:
            jax_app.run_conf(str(conf), seed=SEED, out_dir=str(out), **kw)
    except RuntimeError as e:
        assert crash_at is not None and "injected crash" in str(e), e
    else:
        assert crash_at is None, "the injected crash did not happen"
    finally:
        monkeypatch.delenv(CRASH_ENV, raising=False)


def _killed(pkg, tmp_path, monkeypatch, extra=""):
    """``pkg``'s run of the eight-shard conf killed at tick 30 with
    20-tick checkpoints: the manifest names tick 40."""
    conf = tmp_path / f"{pkg}.conf"
    conf.write_text(_SHARD_CONF + extra + "MESH_SHAPE: 8\n")
    out = tmp_path / f"{pkg}_mig"
    ck = out / "ck"
    kw = dict(checkpoint_every=20, checkpoint_dir=str(ck), resume=True)
    if extra:
        kw["telemetry_dir"] = str(out)
    _run(pkg, conf, out, crash_at=30, monkeypatch=monkeypatch, **kw)
    assert load_manifest(str(ck))["tick"] == 40
    return conf, out, ck, kw


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reshard_of_the_other_packages_checkpoint(tmp_path, monkeypatch,
                                                  writer):
    """A real eight-shard checkpoint written by one package, resharded
    to 4x2 by each: the same npz members and manifest."""
    _, _, ck, _ = _killed(writer, tmp_path, monkeypatch)
    dst = {tag: str(tmp_path / f"to_{tag}") for tag in ("port", "jax")}
    reshard([str(ck)], [dst["port"]], to_mesh_shape="4x2", device="cpu")
    jax_reshard.reshard([str(ck)], [dst["jax"]], to_mesh_shape="4x2")
    _same_checkpoint(dst["port"], dst["jax"])
    m = load_manifest(dst["port"])
    assert m["reshard"][0]["from_shape"] == "8"
    assert json.loads(m["params_text"])["MESH_SHAPE"] == "4x2"


@pytest.mark.parametrize("extra", ["", _MEGA], ids=["plain", "mega"])
def test_reshard_resume_byte_identical(tmp_path, monkeypatch, extra):
    """Killed at MESH_SHAPE 8, resharded to 4x2, resumed with
    ``mesh_shape="4x2"``: dbg.log and stats.log byte-identical to the 4x2
    twin run chunked from tick 0 (mesh shapes differ in their per-shard
    RNG plan, so the twin is the target shape's run), and to the JAX
    package's killed, resharded and resumed run of the same conf.  With
    the flight recorder the timelines match too."""
    outs = {}
    for pkg in ("port", "jax"):
        conf, out, ck, kw = _killed(pkg, tmp_path, monkeypatch, extra)
        if pkg == "port":
            stats = reshard([str(ck)], [str(ck)], to_mesh_shape="4x2",
                            device="cpu")
        else:
            stats = jax_reshard.reshard([str(ck)], [str(ck)],
                                        to_mesh_shape="4x2")
        assert stats["from_shape"] == "8" and stats["to_shape"] == "4x2"
        _run(pkg, conf, out, monkeypatch=monkeypatch, mesh_shape="4x2",
             **kw)
        outs[pkg] = out
    twin = tmp_path / "twin"
    tw = dict(checkpoint_every=20, checkpoint_dir=str(twin / "ck"))
    if extra:
        tw["telemetry_dir"] = str(twin)
    _run("port", tmp_path / "port.conf", twin, monkeypatch=monkeypatch,
         mesh_shape="4x2", **tw)
    names = ("dbg.log", "stats.log") + (("timeline.jsonl",) if extra
                                         else ())
    for name in names:
        want = (twin / name).read_bytes()
        assert (outs["port"] / name).read_bytes() == want, name
        assert (outs["jax"] / name).read_bytes() == want, name
    assert b" removed " in (twin / "dbg.log").read_bytes()


def test_resume_without_reshard_is_refused_like_jax(tmp_path, monkeypatch):
    """MESH_SHAPE stays in the resume identity: resuming the eight-shard
    checkpoint at 4x2 without a reshard is refused, with the JAX
    package's message (but for the package's own name)."""
    conf, out, ck, kw = _killed("port", tmp_path, monkeypatch)
    msgs = []
    for run in (application.run_conf, jax_app.run_conf):
        extra = {"device": "cpu"} if run is application.run_conf else {}
        with pytest.raises(ValueError, match="RESUME manifest mismatch") \
                as ei:
            run(str(conf), seed=SEED, out_dir=str(out), mesh_shape="4x2",
                **kw, **extra)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert "params_text" in msgs[0]


# ---------------------------------------------------------------------------
# Placement capacity model


def _placement_trace(mod):
    """The best-fit / disjoint / refusal sequence of tests/test_elastic.py
    on module ``mod``'s model -> the list of its answers."""
    out = []
    cap = mod.HostCapacity(cores=8, slices=(
        mod.DeviceSlice("big", 8, mesh_shape="4x2"),
        mod.DeviceSlice("small", 4, mesh_shape="2x2")))
    p = cap.place("a", sharded=True, devices=2)
    out.append((p.slice_name, p.mesh_shape,
                cap.place("a", sharded=True, devices=2) is p))
    out.append(cap.place("b", sharded=True, devices=8).slice_name)
    try:
        cap.place("c", sharded=True, devices=1)
    except mod.PlacementError as e:
        out.append(str(e))
    cap.release("a")
    out.append(cap.place("c", sharded=True, devices=1).slice_name)
    out.append(cap.summary())
    cap = mod.HostCapacity(cores=4)
    cap.place("a", cores=2)
    cap.place("b", cores=2)
    for run_id, kw in (("c", {"cores": 1}),
                       ("d", {"sharded": True, "devices": 1})):
        try:
            cap.place(run_id, **kw)
        except mod.PlacementError as e:
            out.append(str(e))
    cap.release("a")
    out.append((cap.place("c", cores=2).cores, cap.cores_used()))
    local = mod.HostCapacity.local(devices=8, slice_devices=4)
    out.append([(s.name, s.devices, s.mesh_shape) for s in local.slices])
    return out


def test_placement_slices_disjoint_and_best_fit():
    cap = HostCapacity(cores=8, slices=(
        DeviceSlice("big", 8, mesh_shape="4x2"),
        DeviceSlice("small", 4, mesh_shape="2x2")))
    p = cap.place("a", sharded=True, devices=2)
    assert p.slice_name == "small"      # best fit: smallest that fits
    assert p.mesh_shape == "2x2"
    assert cap.place("a", sharded=True, devices=2) is p   # idempotent
    q = cap.place("b", sharded=True, devices=8)
    assert q.slice_name == "big"
    with pytest.raises(PlacementError) as ei:
        cap.place("c", sharded=True, devices=1)
    assert "disjoint slices" in str(ei.value)
    cap.release("a")
    assert cap.place("c", sharded=True, devices=1).slice_name == "small"
    assert cap.summary()["slices"][0]["held_by"] == "b"
    import distributed_membership_tpu_torch.fleet.placement as port_pl
    assert _placement_trace(port_pl) == _placement_trace(jax_placement)


def test_placement_core_packing_never_oversubscribes():
    cap = HostCapacity(cores=4)
    cap.place("a", cores=2)
    cap.place("b", cores=2)
    with pytest.raises(PlacementError, match="capacity exhausted"):
        cap.place("c", cores=1)
    cap.release("a")
    assert cap.place("c", cores=2).cores == 2
    assert cap.cores_used() == 4
    with pytest.raises(PlacementError, match="no free device slice"):
        cap.place("d", sharded=True, devices=1)
    local = HostCapacity.local(devices=8, slice_devices=4)
    assert [s.devices for s in local.slices] == [4, 4]
    assert HostCapacity.local().cores == jax_placement.HostCapacity.local(
    ).cores


# ---------------------------------------------------------------------------
# Migration policy + journaled transitions


def test_migrate_policy_parse_and_triggers(tmp_path):
    pol = MigratePolicy.from_conf("death, alerts", 3)
    assert pol.on_death and pol.max_migrations == 3
    assert pol == MigratePolicy(**vars(jax_migrate.MigratePolicy.from_conf(
        "death, alerts", 3)))
    assert not MigratePolicy.from_conf("").triggers
    for args in (("death,teleport",), ("death", -1)):
        assert _refusal(MigratePolicy.from_conf, *args) == _refusal(
            jax_migrate.MigratePolicy.from_conf, *args)
    with pytest.raises(ValueError, match="unknown trigger.*'teleport'"):
        MigratePolicy.from_conf("death,teleport")
    with pytest.raises(ValueError, match="FLEET_MIGRATE_MAX"):
        MigratePolicy.from_conf("death", -1)

    run_dir = str(tmp_path)
    now = time.time()
    with open(os.path.join(run_dir, "runlog.jsonl"), "w") as fh:
        fh.write(json.dumps({"kind": "alert", "rule": "tick_rate_collapse",
                             "ts": now - 100}) + "\n")
        fh.write('{"torn line\n')
        fh.write(json.dumps({"kind": "alert", "rule": "qps_dip",
                             "ts": now}) + "\n")
    assert alert_count(run_dir, DEFAULT_ALERT_RULES, since=0.0) == 1
    for since in (0.0, now - 50, now + 1):
        assert alert_count(run_dir, since=since) == jax_migrate.alert_count(
            run_dir, since=since)
    pol = MigratePolicy.from_conf("alerts")
    assert pol.sick_trigger(run_dir=run_dir, beacon=None, total=100,
                            started_wall=now - 50) is None
    assert pol.sick_trigger(run_dir=run_dir, beacon=None, total=100,
                            started_wall=now - 200) == "alerts"

    pol = MigratePolicy.from_conf("stale-beacon")
    stale = {"tick": 10, "ts": now - 100}
    assert pol.sick_trigger(run_dir=run_dir, beacon=stale, total=100,
                            started_wall=0.0) == "stale-beacon"
    fresh = {"tick": 10, "ts": now}
    assert pol.sick_trigger(run_dir=run_dir, beacon=fresh, total=100,
                            started_wall=0.0) is None
    finished = {"tick": 100, "ts": now - 100}     # done, just not reaped
    assert pol.sick_trigger(run_dir=run_dir, beacon=finished, total=100,
                            started_wall=0.0) is None


def test_migrate_record_journals_fsync_before_ack(tmp_path):
    root = str(tmp_path)
    reg = Registry(root)
    rec = reg.submit(_hash_conf(), run_id="mig")
    rec.tick = 40                        # durable manifest tick
    detail = migrate_record(reg, rec, "death", from_tick=55)
    assert detail == {"trigger": "death", "from_tick": 55,
                      "resume_tick": 40, "downtime_ticks": 15}
    assert rec.state == "requeued" and rec.migrations == 1
    assert rec.last_trigger == "death"
    rows = FleetJournal(os.path.join(root, FLEET_JOURNAL)).read()
    kinds = [(r["kind"], r.get("state")) for r in rows]
    assert kinds == [("submit", None), ("state", "migrating"),
                     ("state", "requeued")]
    assert rows[1]["trigger"] == "death" and rows[1]["from_tick"] == 55
    assert rows[2]["resume_tick"] == 40
    migrate_record(reg, rec, "manual")
    assert rec.migrations == 1 and rec.last_trigger == "manual"
    reg2 = Registry(root)
    reg2.recover()
    rec2 = reg2.runs["mig"]
    assert rec2.migrations == 1
    assert rec2.run_id in [r.run_id for r in reg2.queued()]
    assert not rec2.migrate_requested
    # The JAX registry replays the port's journal to the same record.
    from distributed_membership_tpu.fleet.registry import (
        Registry as JaxRegistry)
    reg3 = JaxRegistry(root)
    reg3.recover()
    assert [(r["run_id"], r["state"], r.get("migrations"))
            for r in reg3.listing()] == [("mig", "queued", 1)]


def test_classify_adopts_death_during_checkpoint_write(tmp_path):
    """A worker that died mid-checkpoint-write still left a complete
    durable boundary (the manifest only names atomically renamed
    snapshots): the reaper classifies it ``checkpointed``, not
    ``failed``."""
    root = str(tmp_path)
    reg = Registry(root)
    rec = reg.submit(_hash_conf(), run_id="w")
    sched = Scheduler(reg, 1, threading.Lock())     # never started
    assert sched._classify(rec, rc=1) == "failed"
    ck = rec.ckpt_dir(root)
    os.makedirs(ck)
    with open(os.path.join(ck, MANIFEST_NAME), "w") as fh:
        json.dump({"tick": 60}, fh)
    assert sched._classify(rec, rc=1) == "checkpointed"
    assert rec.tick == 60               # refreshed from the manifest
    rec.killing = True
    assert sched._classify(rec, rc=1) == "killed"


def test_migrate_now_enforces_cap_except_manual(tmp_path):
    root = str(tmp_path)
    reg = Registry(root)
    rec = reg.submit(_hash_conf(), run_id="capped")
    pol = MigratePolicy.from_conf("death", 1)
    sched = Scheduler(reg, 1, threading.Lock(), policy=pol)
    rec.state = "failed"
    rec.migrations = 1                  # cap already spent
    sched._migrate_now(rec, "death", 50)
    assert rec.state == "failed"        # terminal state stands
    sched._migrate_now(rec, "manual", 50)
    assert rec.state == "requeued"      # operators are never capped


def test_manual_migrate_verb(tmp_path):
    root = str(tmp_path)
    reg = Registry(root)
    lock = threading.Lock()
    sched = Scheduler(reg, 1, lock)     # never started
    state = FleetState(reg, sched, lock)

    parked = reg.submit(_hash_conf(), run_id="parked")
    reg.set_state(parked, "checkpointed", tick=60)
    code, body = state.verb("parked", "migrate")
    assert code == 202 and body["state"] == "requeued"
    assert body["trigger"] == "manual"
    assert parked.migrations == 0       # manual: cap untouched

    queued = reg.submit(_hash_conf(), run_id="queued")
    code, body = state.verb("queued", "migrate")
    assert code == 409 and "queued" in body["error"]

    headless = reg.submit(_EMUL_CONF, run_id="headless")
    reg.set_state(headless, "running")
    code, body = state.verb("headless", "migrate")
    assert code == 409 and "no chunked driver" in body["error"]

    ghost = reg.submit(_hash_conf(), run_id="ghost")
    reg.set_state(ghost, "running")     # journaled, but no worker
    code, body = state.verb("ghost", "migrate")
    assert code == 409 and "not signallable" in body["error"]


def test_place_retargets_a_sharded_run_through_reshard(tmp_path,
                                                       monkeypatch):
    """The scheduler's placement leg: a sharded run granted a slice of
    another mesh shape has its durable checkpoint resharded in place (on
    the fleet's device) and its conf rewritten, journaled; the resumed
    run is the 4x2 twin's."""
    root = str(tmp_path / "fleet")
    reg = Registry(root)
    rec = reg.submit(_SHARD_CONF + "MESH_SHAPE: 8\nCHECKPOINT_EVERY: 20\n",
                     run_id="sh", seed=SEED)
    ck = rec.ckpt_dir(root)
    conf = tmp_path / "sh.conf"
    conf.write_text(rec.conf_text)
    _run("port", conf, tmp_path / "mig", crash_at=30,
         monkeypatch=monkeypatch, checkpoint_dir=ck, resume=True)
    cap = HostCapacity(cores=4, slices=(
        DeviceSlice("s0", 8, mesh_shape="4x2"),))
    sched = Scheduler(reg, 1, threading.Lock(), placement=cap,
                      device="cpu")
    assert sched._place(rec)
    m = load_manifest(ck)
    assert m["reshard"][-1]["to_shape"] == "4x2"
    assert "MESH_SHAPE: 4x2" in rec.conf_text
    assert "MESH_SHAPE: 8" not in rec.conf_text
    rows = reg.journal.read()
    assert rows[-1]["kind"] == "conf_update"
    conf.write_text(rec.conf_text)
    _run("port", conf, tmp_path / "mig", monkeypatch=monkeypatch,
         checkpoint_dir=ck, resume=True)
    _run("port", conf, tmp_path / "twin", monkeypatch=monkeypatch,
         checkpoint_dir=str(tmp_path / "twin_ck"))
    for name in ("dbg.log", "stats.log"):
        assert ((tmp_path / "mig" / name).read_bytes()
                == (tmp_path / "twin" / name).read_bytes()), name
    # No slice left: the run stays queued with the refusal as its error.
    rec2 = reg.submit(rec.conf_text, run_id="sh2")
    assert not sched._place(rec2)
    assert "no free device slice" in rec2.error


def test_resume_across_shard_counts_adopts_placeholders(tmp_path,
                                                        monkeypatch):
    """One shard to eight: the sharded step's never-written per-device
    leaves (the [D, 1] scatter mailboxes and probe placeholders, the
    full-event mode's per-shard AggStats placeholder) keep the writer's
    D in the npz, so the JAX package refuses the resume.  The port
    resumes it, taking its own placeholders, and continues as the JAX
    package continues from the same checkpoint with those leaves made at
    D=8 -- the same dbg.log and stats.log.  (A different D is a
    different run from tick 0: the per-shard RNG plan depends on D.)"""
    conf = tmp_path / "d1.conf"
    conf.write_text(_SHARD_CONF + "MESH_SHAPE: 1\n")
    ck = tmp_path / "ck"
    kw = dict(checkpoint_every=20, checkpoint_dir=str(ck), resume=True)
    _run("port", conf, tmp_path / "port", crash_at=30,
         monkeypatch=monkeypatch, **kw)
    reshard([str(ck)], [str(ck)], to_mesh_shape="8", device="cpu")
    jck = tmp_path / "jck"
    import shutil
    shutil.copytree(ck, jck)
    jkw = dict(kw, checkpoint_dir=str(jck))
    with pytest.raises(ValueError, match="shape/dtype mismatch"):
        jax_app.run_conf(str(conf), seed=SEED, out_dir=str(tmp_path / "j"),
                         mesh_shape="8", **jkw)
    _run("port", conf, tmp_path / "port", monkeypatch=monkeypatch,
         mesh_shape="8", **kw)
    # The D=8 placeholders, from a JAX eight-shard run's checkpoint.
    ref = tmp_path / "ref"
    _run("jax", conf, tmp_path / "ref_out", crash_at=10,
         monkeypatch=monkeypatch, mesh_shape="8", checkpoint_every=20,
         checkpoint_dir=str(ref))
    arrays, m = _read_arrays(str(jck))
    want, _ = _read_arrays(str(ref))
    swapped = []
    for k in sorted(arrays):
        if k.startswith("c") and arrays[k].shape != want[k].shape:
            a, b = arrays[k], want[k]
            assert (a == a.flat[0]).all() and (b == a.flat[0]).all(), k
            arrays[k] = b
            swapped.append(k)
    assert swapped
    leaves = [arrays[f"c{i}"] for i in range(len(
        [k for k in arrays if k.startswith("c")]))]
    np.savez(jck / m["file"], **arrays)
    m["state_hash"] = jax_ck.state_hash(leaves)
    m["checkpoints"] = [{"tick": m["tick"], "file": m["file"],
                         "state_hash": m["state_hash"]}]
    (jck / MANIFEST_NAME).write_text(json.dumps(m))
    jax_app.run_conf(str(conf), seed=SEED, out_dir=str(tmp_path / "port_j"),
                     mesh_shape="8", **jkw)
    for name in ("dbg.log", "stats.log"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "port_j" / name).read_bytes()), name


def test_cli_reshard_then_resume_with_mesh_shape(tmp_path, monkeypatch,
                                                 capsys):
    """The command lines: the reshard CLI in place, then ``python -m
    distributed_membership_tpu_torch ... --resume --mesh-shape 4x2
    --device cpu``; the logs are the JAX package's for the same command
    lines (its CLIs), and the usage line's flags are the JAX parser's."""
    outs = {}
    for pkg in ("port", "jax"):
        conf, out, ck, _ = _killed(pkg, tmp_path, monkeypatch)
        args = ["--src", str(ck), "--dst", str(ck), "--mesh-shape", "4x2"]
        main = reshard_main if pkg == "port" else jax_reshard.main
        assert main(args + (["--device", "cpu"] if pkg == "port"
                            else [])) == 0
        assert json.loads(capsys.readouterr().out)["to_shape"] == "4x2"
        argv = [str(conf), "--seed", str(SEED), "--out-dir", str(out),
                "--checkpoint-every", "20", "--checkpoint-dir", str(ck),
                "--resume", "--mesh-shape", "4x2"]
        if pkg == "port":
            assert application.main(argv + ["--device", "cpu"]) == 0
        else:
            assert jax_app.main(argv) == 0
        capsys.readouterr()
        outs[pkg] = out
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        assert ((outs["port"] / name).read_bytes()
                == (outs["jax"] / name).read_bytes()), name
    ns = application.parser().parse_args(["c.conf", "--mesh-shape", "2x4"])
    assert ns.mesh_shape == "2x4"
