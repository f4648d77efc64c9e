"""The port's multi-process runtime on the CPU (gloo): the process mesh's
collectives against LocalMesh's, and K-process ``tpu_hash_sharded`` runs
through the launcher (``python -m
distributed_membership_tpu_torch.multiproc_launch``) against the JAX
package's in-process run with the same shard count, which JAX's own tests
pin to its multi-process run (tests/test_exchange.py).  Tolerance 0
throughout: logs, manifests and series are compared byte for byte."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
CONFS = REPO / "distributed_membership_tpu_torch" / "confs"

# The JAX test's _MP_CONF (tests/test_exchange.py): N=64, S=16, batched.
_MP_CONF = (
    "MAX_NNB: 64\nSINGLE_FAILURE: 1\nDROP_MSG: 0\nMSG_DROP_PROB: 0\n"
    "VIEW_SIZE: 16\nGOSSIP_LEN: 8\nPROBES: 2\nFANOUT: 3\nTFAIL: 16\n"
    "TREMOVE: 40\nTOTAL_TIME: 40\nFAIL_TIME: 20\nJOIN_MODE: warm\n"
    "EVENT_MODE: agg\nEXCHANGE: ring\nEXCHANGE_MODE: batched\n"
    "BACKEND: tpu_hash_sharded\n")

# name -> (conf text, shard count of the JAX twin): the legacy exchange
# in full event mode with drops, the folded layout (L = 64 folds at S=16,
# P=2), the scatter exchange (AggStats), PROBE_GATHER split's three
# gathers (approximate probe attribution), staggered cold joins with
# drops on the ring and on the scatter exchange, a scenario with every
# event kind (N=256), and a 4x2 torus on 2 processes.
_CASES = {
    "batched": (_MP_CONF, "2"),
    "legacy": (_MP_CONF.replace("EXCHANGE_MODE: batched", "EXCHANGE_MODE: "
                                "legacy").replace("EVENT_MODE: agg",
                                                  "EVENT_MODE: full")
               .replace("DROP_MSG: 0\nMSG_DROP_PROB: 0",
                        "DROP_MSG: 1\nMSG_DROP_PROB: 0.05"), "2"),
    "folded": (_MP_CONF.replace("MAX_NNB: 64", "MAX_NNB: 128")
               + "FOLDED: 1\n", "2"),
    "scatter": (_MP_CONF.replace("EXCHANGE: ring\nEXCHANGE_MODE: batched",
                                 "EXCHANGE: scatter"), "2"),
    "split": (_MP_CONF.replace("EXCHANGE_MODE: batched",
                               "EXCHANGE_MODE: legacy")
              + "PROBE_GATHER: split\nPROBE_IO: approx\n", "2"),
    "cold": (_MP_CONF.replace(
        "EXCHANGE_MODE: batched", "EXCHANGE_MODE: legacy").replace(
        "JOIN_MODE: warm", "JOIN_MODE: staggered").replace(
        "EVENT_MODE: agg", "EVENT_MODE: full").replace(
        "TOTAL_TIME: 40\nFAIL_TIME: 20", "TOTAL_TIME: 60\nFAIL_TIME: 30")
        .replace("DROP_MSG: 0\nMSG_DROP_PROB: 0",
                 "DROP_MSG: 1\nMSG_DROP_PROB: 0.05"), "2"),
    "scatter_cold": (_MP_CONF.replace(
        "EXCHANGE: ring\nEXCHANGE_MODE: batched", "EXCHANGE: scatter")
        .replace("JOIN_MODE: warm", "JOIN_MODE: staggered")
        .replace("EVENT_MODE: agg", "EVENT_MODE: full")
        .replace("TOTAL_TIME: 40\nFAIL_TIME: 20",
                 "TOTAL_TIME: 60\nFAIL_TIME: 30")
        .replace("DROP_MSG: 0\nMSG_DROP_PROB: 0",
                 "DROP_MSG: 1\nMSG_DROP_PROB: 0.05"), "2"),
    "scenario": ((CONFS / "ring_256_s128_scenario.conf").read_text()
                 .replace("BACKEND: tpu_hash", "BACKEND: tpu_hash_sharded")
                 .replace("SCENARIO: ", f"SCENARIO: {REPO}/"), "2"),
    "torus_4x2": (_MP_CONF.replace("EXCHANGE_MODE: batched",
                                   "EXCHANGE_MODE: legacy")
                  + "MESH_SHAPE: 4x2\n", "4x2"),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(conf, out_root, *extra, env_extra=None, timeout=100):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DM_DIST_")}
    env["OMP_NUM_THREADS"] = "1"
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m",
         "distributed_membership_tpu_torch.multiproc_launch", str(conf),
         "--out-root", str(out_root), "--device", "cpu",
         "--timeout", str(timeout - 20), *extra],
        env=env, cwd=REPO, timeout=timeout, capture_output=True, text=True)


def _read(out_root, proc, name) -> bytes:
    return (Path(out_root) / f"p{proc}" / name).read_bytes()


def _jax_logs(conf, mesh_shape, out_dir) -> dict:
    """The JAX package's in-process run of ``conf`` on ``mesh_shape``'s
    devices (conftest's eight virtual CPU devices), seed 0."""
    from distributed_membership_tpu.runtime import application as jax_app
    jax_app.run_conf(str(conf), seed=0, out_dir=str(out_dir),
                     mesh_shape=mesh_shape)
    return {f: (Path(out_dir) / f).read_bytes()
            for f in ("dbg.log", "stats.log")}


# ---------------------------------------------------------------------------
# (a) The process mesh's collectives against LocalMesh's


def _mesh_worker(rank: int, procs: int, port: int,
                 device: str = "cpu") -> None:
    """One rank of the collectives check, on ``device`` (the card test
    runs it on CUDA tensors; tests/test_torch_cuda.py)."""
    os.environ.update(DM_DIST_PROCS=str(procs), DM_DIST_PROC_ID=str(rank),
                      DM_DIST_COORD=f"localhost:{port}")
    torch.set_num_threads(1)
    from distributed_membership_tpu_torch.ops.exchange import (
        BatchedExchange)
    from distributed_membership_tpu_torch.parallel.mesh import (
        LocalMesh, ProcessMesh)
    from distributed_membership_tpu_torch.runtime import distributed
    distributed.maybe_initialize(device)
    try:
        d, n, s = 8, 64, 16
        one, many = LocalMesh((d,), device), ProcessMesh((d,), device, rank,
                                                         procs)
        rng = np.random.default_rng(7)
        x = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (n, s),
                                          dtype=np.int64).astype(np.int32)
                             ).to(device)
        v = torch.from_numpy(rng.integers(0, 1000, (n,), dtype=np.int32)
                             ).to(device)
        mine = many.local_part

        def same(a, b, what):
            assert torch.equal(a, b), (what, rank)
        for b in range(-1, d + 2):
            same(many.block_send(mine(x), b), mine(one.block_send(x, b)),
                 f"block_send {b}")
            same(many.block_send(mine(v), b), mine(one.block_send(v, b)),
                 f"block_send counts {b}")
        for c in (0, 3, 7):
            same(many.local_roll(mine(x), c), mine(one.local_roll(x, c)),
                 f"local_roll {c}")
        same(many.all_gather(mine(x)), one.all_gather(x), "all_gather")
        same(many.shard_sums(mine(v)), mine(one.shard_sums(v)),
             "shard_sums")
        same(many.shard_of_rows(n), mine(one.shard_of_rows(n)),
             "shard_of_rows")
        parts = torch.from_numpy(rng.integers(0, 99, (d, n),
                                              dtype=np.int32)).to(device)
        same(many.psum(mine(parts)), one.psum(parts), "psum")
        same(many.psum_scatter(mine(parts)), mine(one.psum_scatter(parts)),
             "psum_scatter")
        same(many.psum(mine(parts.sum(1))), one.psum(parts.sum(1)),
             "psum scalar")
        m = 3       # all_to_all: [D_src * D_dst * m, 2] buckets
        wire = torch.from_numpy(rng.integers(0, 9, (d * d * m, 2),
                                             dtype=np.int32)).to(device)
        same(many.all_to_all(mine(wire)), mine(one.all_to_all(wire)),
             "all_to_all")
        for op, fn in (("min", torch.amin), ("max", torch.amax)):
            same(many.allreduce(mine(parts)[0], op),
                 fn(parts[::d // procs], 0), op)
        # The batched exchange's shipped buckets: every source shard's
        # shift folded in, then shipped, against LocalMesh's buckets.
        ll = n // d
        bx1 = BatchedExchange(mesh=one, n_local=ll, s=s, cstride=5,
                              single_col_roll=False)
        bxk = BatchedExchange(mesh=many, n_local=ll, s=s, cstride=5,
                              single_col_roll=False)
        p1, pk = bx1.buckets(device), bxk.buckets(device)
        for b, c in ((1, 2), (3, 0), (6, 7)):
            bb, cc = (torch.tensor(b, device=device),
                      torch.tensor(c, device=device))
            bx1.add_shift(*p1, x.view(d, ll, s), v.view(d, ll), bb, cc)
            bxk.add_shift(*pk, mine(x).view(-1, ll, s),
                          mine(v).view(-1, ll), bb, cc)
        got = bxk.ship(*pk)
        same(got[0], mine(p1[0]), "batched payload")
        same(got[1], mine(p1[1]), "batched counts")
        # A carry's round trip: device_put_global cuts each state leaf to
        # this rank's rows, to_host gathers them back (the aggregates'
        # id-indexed fields stay whole).
        from distributed_membership_tpu_torch.backends.tpu_hash_sharded \
            import ShardedHashState
        from distributed_membership_tpu_torch.observability.aggregates \
            import init_fast_agg
        agg = init_fast_agg(1, n, device)._replace(sent_total=v)
        carry = ShardedHashState(*([x] * 12 + [agg] + [x, x, v]))
        local = distributed.device_put_global(carry, many)
        same(local.view, mine(x), "device_put_global")
        same(local.agg.sent_total, mine(v), "device_put_global agg")
        back = distributed.to_host(local, many)
        for a, b in zip(back, carry):
            if isinstance(a, torch.Tensor):
                same(a, b.cpu(), "to_host")
        same(back.agg.sent_total, v.cpu(), "to_host agg")
        assert got[0].device == x.device
        assert distributed.transport() == "gloo"
    finally:
        distributed.shutdown()


def test_process_mesh_collectives_match_local_mesh():
    """(a) Four ranks of eight shards: every block shift, the local roll,
    all_gather, psum, psum_scatter, all_to_all and the batched
    exchange's shipped buckets equal LocalMesh's on the same global
    tensors, each rank's block of them."""
    torch.multiprocessing.spawn(_mesh_worker, args=(4, _free_port()),
                                nprocs=4)


# ---------------------------------------------------------------------------
# (b) The launcher round trip against the JAX twin


@pytest.mark.parametrize("case", sorted(_CASES))
def test_launcher_round_trip_equals_jax(tmp_path, case):
    """(b) Two processes write byte-identical dbg.log and stats.log, and
    those bytes equal the JAX package's in-process run with the same
    shard count."""
    text, shape = _CASES[case]
    conf = tmp_path / "mp.conf"
    conf.write_text(text)
    r = _launch(conf, tmp_path / "mp", "--procs", "2")
    assert r.returncode == 0, (r.stdout, r.stderr,
                               _read(tmp_path / "mp", 0, "launch.log"))
    want = _jax_logs(conf, shape, tmp_path / "jax")
    for name in ("dbg.log", "stats.log"):
        got = _read(tmp_path / "mp", 0, name)
        assert got == _read(tmp_path / "mp", 1, name), name
        assert got == want[name], name
    assert b"transport gloo" in _read(tmp_path / "mp", 0, "launch.log")


# ---------------------------------------------------------------------------
# (c) kill and resume, (d) --merge and (e) the 2 -> 1 reshard:
# tests/test_torch_multiproc_resume.py.  (f) the merge module


def _seg(fields, t0, ticks, base):
    rec = {f: [0] * ticks for f in fields}
    rec.update(t0=t0, ticks=ticks, live=[base] * ticks)
    return rec


def test_merge_module_equals_jax(tmp_path):
    """(f) The shards of tests/test_metrics_plane.py's merge test (two
    processes, one with a segment the other never flushed and a torn
    tail, then a third that diverges): the port's merge_run, merged
    series and MergeError equal the JAX module's."""
    from distributed_membership_tpu.observability import merge as jmerge
    from distributed_membership_tpu.observability.timeline import (
        read_timeline as jread)
    from distributed_membership_tpu_torch.observability import merge
    from distributed_membership_tpu_torch.observability.timeline import (
        TELEMETRY_FIELDS, TIMELINE_NAME, read_timeline)

    def shard(root, name, recs, torn=""):
        os.makedirs(os.path.join(root, name), exist_ok=True)
        with open(os.path.join(root, name, TIMELINE_NAME), "w") as fh:
            for rec in recs:
                fh.write(json.dumps(rec) + "\n")
            fh.write(torn)

    out = {}
    for who, mod in (("port", merge), ("jax", jmerge)):
        root = str(tmp_path / who)
        a = _seg(TELEMETRY_FIELDS, 0, 24, 16)
        b = _seg(TELEMETRY_FIELDS, 24, 24, 15)
        c = _seg(TELEMETRY_FIELDS, 48, 24, 15)
        shard(root, "p0", [a, b])
        shard(root, "p1", [a, b, c], torn='{"t0": 72, "tick')
        info = mod.merge_run(root)
        text = Path(root, TIMELINE_NAME).read_bytes()
        series = (read_timeline if who == "port" else jread)(
            os.path.join(root, TIMELINE_NAME))
        bad = _seg(TELEMETRY_FIELDS, 24, 24, 15)
        bad["removals"][3] = 1
        shard(root, "p2", [bad])
        with pytest.raises(ValueError) as ei:
            mod.merge_run(root, write=False)
        assert type(ei.value).__name__ == "MergeError"
        out[who] = (dict(info, path=None), text,
                    {k: np.asarray(v).tolist() for k, v in series.items()},
                    str(ei.value), mod.merge_run(str(tmp_path / "empty")))
    assert out["port"][0]["segments"] == 3 and out["port"][0]["ticks"] == 72
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# (g) The transport rule


def test_transport_rule():
    """(g) CPU -> gloo (or DM_DIST_CPU_COLL); processes sharing a card
    -> gloo over CUDA tensors; a card each -> nccl.  The rule reads every
    rank's host, so ranks on unlike hosts choose alike, and each rank's
    card is its place among its host's ranks."""
    from distributed_membership_tpu_torch.runtime.distributed import (
        local_rank, resolve_transport)

    def one_host(procs, cards):
        return [("h", cards)] * procs
    assert resolve_transport("cpu", one_host(2, 0)) == "gloo"
    assert resolve_transport("cpu", one_host(4, 8)) == "gloo"
    assert resolve_transport("cuda", one_host(2, 1)) == "gloo"
    assert resolve_transport("cuda", one_host(4, 2)) == "gloo"
    assert resolve_transport("cuda", one_host(2, 2)) == "nccl"
    assert resolve_transport("cuda", one_host(4, 8)) == "nccl"
    assert resolve_transport("cuda", one_host(1, 1)) == "nccl"
    # Two unlike hosts: a has two cards for its two ranks, b one card
    # for its two.  Every rank sees the same list, so all take gloo.
    unlike = [("a", 2), ("b", 1), ("a", 2), ("b", 1)]
    assert resolve_transport("cuda", unlike) == "gloo"
    assert resolve_transport("cuda", unlike[:3]) == "nccl"
    assert [local_rank(unlike, r) for r in range(4)] == [0, 0, 1, 1]
    assert [local_rank(unlike, r) % n for r, (_, n) in
            enumerate(unlike)] == [0, 0, 1, 0]


def _nccl_worker(rank: int, procs: int, port: int) -> None:
    os.environ.update(DM_DIST_PROCS=str(procs), DM_DIST_PROC_ID=str(rank),
                      DM_DIST_COORD=f"localhost:{port}")
    from distributed_membership_tpu_torch.runtime import distributed
    with pytest.raises((RuntimeError, ValueError)) as ei:
        distributed.maybe_initialize("cpu", transport="nccl")
    assert "nccl" in str(ei.value)
    assert distributed.process_count() == 1      # no quiet fallback
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def test_failed_nccl_raises():
    """(g) An nccl transport that cannot come up raises on every rank;
    the run never gives way to gloo.  A rank's environment must name its
    rank and the coordinator."""
    torch.multiprocessing.spawn(_nccl_worker, args=(2, _free_port()),
                                nprocs=2)
    from distributed_membership_tpu_torch.runtime import distributed
    env = {"DM_DIST_PROCS": "2", "DM_DIST_COORD": "localhost:1"}
    old = {k: os.environ.get(k) for k in list(env) + ["DM_DIST_PROC_ID"]}
    try:
        os.environ.update(env)
        os.environ.pop("DM_DIST_PROC_ID", None)
        with pytest.raises(ValueError, match="DM_DIST_PROC_ID"):
            distributed.maybe_initialize("cpu")
        os.environ["DM_DIST_PROC_ID"] = "0"
        os.environ.pop("DM_DIST_COORD")
        with pytest.raises(ValueError, match="DM_DIST_COORD"):
            distributed.maybe_initialize("cpu")
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert distributed.maybe_initialize("cpu") == (0, 1)


def test_refusals_across_processes(tmp_path):
    """What has no multi-process path in either package says so: the
    dense tpu_sharded run and --serve."""
    conf = tmp_path / "mp.conf"
    conf.write_text(_CASES["legacy"][0])
    r = _launch(CONFS / "dense_256_drop.conf", tmp_path / "dense",
                "--procs", "2", "--backend", "tpu_sharded")
    assert r.returncode != 0
    assert b"tpu_sharded runs in one process" in _read(
        tmp_path / "dense", 0, "launch.log")
    r = _launch(conf, tmp_path / "serve", "--procs", "2", "--",
                "--serve", "--checkpoint-every", "10")
    assert r.returncode != 0
    assert b"--serve runs one process" in _read(tmp_path / "serve", 0,
                                                 "launch.log")
