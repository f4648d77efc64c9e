"""The port's dense backends (``tpu``, ``tpu_sharded``), ``ops/merge.py``
and ``parallel/collectives.py`` against the JAX package.

Compared with tolerance 0, on inputs made from a numpy seed:

* ``fanout_deliver`` (with drops, over several sender chunks, so each
  chunk's key matters), ``fanout_deliver_indexed`` and
  ``broadcast_deliver``;
* the four collectives against the JAX ones inside ``shard_map`` on
  conftest's eight virtual CPU devices;
* the dense step and the sharded step (D = 1, 2, 8, the JAX step run
  per tick inside ``shard_map``) at every tick and in every state leaf,
  under drops, staggered and batch joins and both threefry streams;
  ``replicated_rng`` on eight shards against the dense step;
* ``run_conf``'s logs, ``--grade-all`` on both backends, and
  kill/resume of ``tpu`` across the two packages.
"""

import contextlib
import random
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as PS

from distributed_membership_tpu.backends import get_backend as jax_backend
from distributed_membership_tpu.backends import tpu as jax_tpu
from distributed_membership_tpu.backends import tpu_sharded as jax_sharded
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.ops import merge as jax_merge
from distributed_membership_tpu.parallel import collectives as jax_coll
from distributed_membership_tpu.parallel import shard_map
from distributed_membership_tpu.parallel.mesh import NODE_AXIS, make_mesh
from distributed_membership_tpu.runtime import application as jax_app
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch.backends import get_backend
from distributed_membership_tpu_torch.backends import tpu, tpu_sharded
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.ops import merge, threefry
from distributed_membership_tpu_torch.parallel import collectives
from distributed_membership_tpu_torch.parallel.mesh import LocalMesh
from distributed_membership_tpu_torch.runtime import application
from distributed_membership_tpu_torch.runtime import failures

SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def legacy():
    prev = jax.config.jax_threefry_partitionable
    try:
        with jax.threefry_partitionable(False), \
                threefry.partitionable(False):
            yield
    finally:
        jax.config.update("jax_threefry_partitionable", prev)


def _key(k):
    return tuple(int(x) for x in np.asarray(k, np.uint32))


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


# ---------------------------------------------------------------------------
# ops/merge.py

@pytest.mark.parametrize("s,r,e", [(256, 16, 24), (40, 24, 24), (7, 5, 9)])
def test_fanout_deliver_matches_jax(s, r, e):
    """At S = 256 a chunk holds 64 senders (the 2^22-element budget over
    S*S per sender), so four chunk keys each draw their own coins."""
    rng = np.random.default_rng(s)
    tm = rng.random((s, r)) < 0.2
    hb = np.where(rng.random((s, e)) < 0.7,
                  rng.integers(0, 50, (s, e)), -1).astype(np.int32)
    jk = jax.random.PRNGKey(SEED)
    for active, p in ((True, 0.3), (False, 0.3), (True, 0.0)):
        want = jax_merge.fanout_deliver(jk, jnp.asarray(tm), jnp.asarray(hb),
                                        jnp.asarray(active), p)
        got = merge.fanout_deliver(_key(jk), torch.from_numpy(tm),
                                   torch.from_numpy(hb), active, p)
        for w, g in zip(want, got):
            _eq(g, w, f"active={active} p={p}")
    assert merge._chunk_size(s) == jax_merge._chunk_size(s)
    assert merge._chunk_size(256) == 64


@pytest.mark.parametrize("s,k,e", [(64, 3, 64), (10, 5, 10)])
def test_fanout_deliver_indexed_and_broadcast_match_jax(s, k, e):
    rng = np.random.default_rng(k)
    targets = rng.integers(0, e, (s, k)).astype(np.int32)
    valid = rng.random((s, k)) < 0.8
    hb = np.where(rng.random((s, e)) < 0.7,
                  rng.integers(0, 50, (s, e)), -1).astype(np.int32)
    rec = rng.random(e) < 0.5
    jk = jax.random.PRNGKey(SEED)
    for active, p in ((True, 0.3), (False, 0.3), (True, 0.0)):
        want = jax_merge.fanout_deliver_indexed(
            jk, jnp.asarray(targets), jnp.asarray(valid), jnp.asarray(hb), e,
            jnp.asarray(active), p)
        got = merge.fanout_deliver_indexed(
            _key(jk), torch.from_numpy(targets), torch.from_numpy(valid),
            torch.from_numpy(hb), e, active, p)
        for w, g in zip(want, got):
            _eq(g, w, f"indexed active={active} p={p}")
        want = jax_merge.broadcast_deliver(jk, jnp.asarray(rec),
                                           jnp.asarray(hb[0]),
                                           jnp.asarray(active), p)
        got = merge.broadcast_deliver(_key(jk), torch.from_numpy(rec),
                                      torch.from_numpy(hb[0]), active, p)
        for w, g in zip(want, got):
            _eq(g, w, f"broadcast active={active} p={p}")


# ---------------------------------------------------------------------------
# parallel/collectives.py

@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return make_mesh(8)


def test_collectives_match_jax(mesh8):
    d, n, e = 8, 32, 12
    x = np.random.default_rng(0).integers(-5, 100, (d, n, e)).astype(
        np.int32)
    vec = np.random.default_rng(1).integers(0, 9, (n,)).astype(np.int32)
    ax = PS(NODE_AXIS, None, None)

    def body(part, v):
        part = part[0]
        return (jax_coll.ring_reduce_scatter_max(part, NODE_AXIS)[None],
                jax_coll.allreduce_max(part, NODE_AXIS)[None],
                jax_coll.reduce_scatter_sum(part, NODE_AXIS)[None],
                jax_coll.all_gather_vec(v, NODE_AXIS)[None])

    rs, ar, ss, ag = jax.jit(shard_map(
        body, mesh=mesh8, in_specs=(ax, PS(NODE_AXIS)),
        out_specs=(ax, ax, ax, PS(NODE_AXIS, None)),
        check_vma=False))(jnp.asarray(x), jnp.asarray(vec))
    parts = torch.from_numpy(x)
    _eq(collectives.ring_reduce_scatter_max(parts),
        np.asarray(rs).reshape(n, e))
    _eq(collectives.allreduce_max(parts), np.asarray(ar))
    _eq(collectives.reduce_scatter_sum(parts), np.asarray(ss).reshape(n, e))
    flat = torch.from_numpy(vec)
    for s in range(d):
        _eq(collectives.all_gather_vec(flat), np.asarray(ag)[s])


# ---------------------------------------------------------------------------
# The steps, per tick

DENSE = """MAX_NNB: {n}
SINGLE_FAILURE: {single}
DROP_MSG: {drop}
MSG_DROP_PROB: 0.1
BACKEND: {backend}
FANOUT: 3
TFAIL: 5
TREMOVE: 20
TOTAL_TIME: {total}
FAIL_TIME: 30
DROP_START: 5
DROP_STOP: 40
JOIN_MODE: {join}
"""


def _params(conf: str):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JaxParams.from_text(conf), Params.from_text(conf)


def _assert_same(want, got, t, what):
    for name, w, g in zip(want._fields, want, got):
        w, g = np.asarray(w), g.cpu().numpy()
        if not np.array_equal(w, g):
            at = tuple(np.argwhere(w != g)[0]) if w.shape else ()
            raise AssertionError(f"tick {t}: {what} {name} differs first "
                                 f"at {at}: jax {w[at]} port {g[at]}")


def _jax_sharded_tick(cfg, d: int, replicated_rng: bool):
    """The JAX sharded step for one tick inside ``shard_map`` on a
    ``d``-device mesh: the state in and out row-sharded, as its
    whole-run scan carries it."""
    step = jax_sharded.make_sharded_step(cfg, cfg.n // d, replicated_rng)
    ax = PS(NODE_AXIS)

    def one(state, t, k, st, fm, ft, lo, hi):
        return step(state, (t, k, st, fm, ft, lo, hi))

    return jax.jit(shard_map(
        one, mesh=make_mesh(d),
        in_specs=(jax_tpu.State(*(ax for _ in jax_tpu.State._fields)),
                  PS(), PS(), PS(), ax, PS(), PS(), PS()),
        out_specs=(jax_tpu.State(*(ax for _ in jax_tpu.State._fields)),
                   jax_tpu.TickEvents(ax, ax, ax, ax)), check_vma=False))


def run_dense_both(conf: str, d=None, replicated_rng=False, seed=SEED,
                   jax_dense=False):
    """The JAX step and the port's, tick by tick from one conf and seed:
    the dense steps when ``d`` is None, else the sharded steps on ``d``
    shards (the JAX one on ``d`` devices).  ``jax_dense`` holds the
    port's sharded step against the JAX dense step instead."""
    jp, pp = _params(conf)
    n, total = jp.EN_GPSZ, jp.TOTAL_TIME
    plan_j = jax_failures.resolve_plan(jp, random.Random(f"app:{seed}"))
    plan_p = failures.resolve_plan(pp, random.Random(f"app:{seed}"))
    jcfg = jax_tpu.StepConfig(n=n, tfail=jp.TFAIL, tremove=jp.TREMOVE,
                              fanout=jp.FANOUT,
                              drop_prob=jp.effective_drop_prob())
    pcfg = tpu.step_config(pp)
    ticks, keys, *sched = jax_failures.plan_tensors(jp, plan_j, seed, total)
    plan_t = failures.plan_tensors(pp, plan_p, seed, total, "cpu")
    js = jax_tpu.init_state(n)
    if d is None:
        ps, pstep = tpu.init_state(n, "cpu"), tpu.make_step(pcfg)
    else:
        mesh = LocalMesh((d,), "cpu")
        ps = tpu_sharded.init_local_state(n, mesh, "cpu")
        pstep = tpu_sharded.make_sharded_step(pcfg, mesh, replicated_rng)
    if d is None or jax_dense:
        jstep = jax.jit(jax_tpu.make_step(jcfg))

        def jtick(state, t):
            return jstep(state, (ticks[t], keys[t], *sched))
    else:
        jsh = _jax_sharded_tick(jcfg, d, replicated_rng)

        def jtick(state, t):
            return jsh(state, ticks[t], keys[t], *sched)
    for t in range(total):
        js, jo = jtick(js, t)
        ps, po = pstep(ps, t, plan_t.tick_key(t), plan_t)
        _assert_same(js, ps, t, "state")
        _assert_same(jo, po, t, "events")


@pytest.mark.parametrize("kw", [
    dict(n=10, single=1, drop=1, total=80, join="staggered"),
    dict(n=48, single=0, drop=1, total=60, join="batch"),
    dict(n=64, single=1, drop=0, total=50, join="staggered")],
    ids=["grader_n10_drops", "batch_multi_drops", "n64"])
def test_dense_step_per_tick_matches_jax(kw):
    run_dense_both(DENSE.format(backend="tpu", **kw))


def test_dense_step_legacy_stream_matches_jax():
    with legacy():
        run_dense_both(DENSE.format(backend="tpu", n=24, single=1, drop=1,
                                    total=50, join="batch"))


@pytest.mark.parametrize("d,kw", [
    (1, dict(n=32, single=1, drop=1, total=50, join="staggered")),
    (2, dict(n=10, single=1, drop=1, total=60, join="staggered")),
    (8, dict(n=48, single=0, drop=1, total=60, join="batch")),
    (8, dict(n=64, single=1, drop=1, total=45, join="staggered"))],
    ids=["d1", "d2_grader_n10", "d8_batch_multi", "d8_staggered"])
def test_sharded_step_per_tick_matches_jax(d, kw, mesh8):
    run_dense_both(DENSE.format(backend="tpu_sharded", **kw), d=d)


def test_sharded_step_legacy_stream_matches_jax(mesh8):
    with legacy():
        run_dense_both(DENSE.format(backend="tpu_sharded", n=24, single=1,
                                    drop=1, total=45, join="batch"), d=8)


def test_replicated_rng_equals_dense(mesh8):
    """Drop-free, ``replicated_rng`` on eight shards gives the dense
    step's state at every tick (the port's sharded step against the JAX
    dense step), and the JAX sharded step agrees."""
    conf = DENSE.format(backend="tpu_sharded", n=64, single=0, drop=0,
                        total=45, join="batch")
    run_dense_both(conf, d=8, replicated_rng=True, jax_dense=True)
    run_dense_both(conf, d=8, replicated_rng=True)


# ---------------------------------------------------------------------------
# Whole runs

def _files(d):
    return {f: (d / f).read_bytes() for f in ("dbg.log", "stats.log",
                                             "msgcount.log")}


@pytest.mark.parametrize("scenario", ["singlefailure", "multifailure",
                                      "msgdropsinglefailure"])
def test_tpu_testcases_logs_byte_identical(scenario, testcases_dir,
                                           tmp_path):
    conf = str(testcases_dir / f"{scenario}.conf")
    jax_app.run_conf(conf, backend="tpu", out_dir=str(tmp_path / "j"))
    application.run_conf(conf, backend="tpu", out_dir=str(tmp_path / "p"),
                         device="cpu")
    assert _files(tmp_path / "p") == _files(tmp_path / "j")


@pytest.mark.parametrize("d", [2, 5])
def test_sharded_testcase_logs_byte_identical(d, testcases_dir, tmp_path,
                                              mesh8):
    """``run_tpu_sharded`` with a pinned mesh on both sides (the JAX
    package picks five devices for N=10 when none is given)."""
    conf = str(testcases_dir / "msgdropsinglefailure.conf")
    jp, pp = _params(open(conf).read() + "BACKEND: tpu_sharded\n")
    want = jax_backend("tpu_sharded")(jp, seed=SEED, mesh=make_mesh(d))
    got = get_backend("tpu_sharded")(pp, seed=SEED, device="cpu",
                                     mesh=LocalMesh((d,), "cpu"))
    assert got.log.dbg_text() == want.log.dbg_text()
    assert got.extra["mesh_size"] == want.extra["mesh_size"] == d
    _eq(got.sent, want.sent)
    _eq(got.recv, want.recv)


@pytest.mark.parametrize("backend", ["tpu", "tpu_sharded"])
def test_grade_all(backend, tmp_path, capsys):
    rc = application.main(["--grade-all", "--device", "cpu", "--backend",
                           backend, "--out-dir", str(tmp_path)])
    assert rc == 0
    assert "Final grade 90" in capsys.readouterr().out


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_dense_kill_and_resume_across_packages(writer, reader, tmp_path,
                                               monkeypatch):
    conf = tmp_path / "c.conf"
    conf.write_text(DENSE.format(backend="tpu", n=24, single=1, drop=1,
                                 total=60, join="staggered"))

    def run(pkg, out, **kw):
        if pkg == "jax":
            return jax_app.run_conf(str(conf), out_dir=str(out), **kw)
        return application.run_conf(str(conf), out_dir=str(out),
                                    device="cpu", **kw)

    run("jax", tmp_path / "ref")
    ck = dict(checkpoint_every=10, checkpoint_dir=str(tmp_path / "ck"))
    monkeypatch.setenv("DM_CRASH_AT_TICK", "30")
    with pytest.raises(RuntimeError, match="injected crash at tick 30"):
        run(writer, tmp_path / "killed", **ck)
    monkeypatch.delenv("DM_CRASH_AT_TICK")
    run(reader, tmp_path / "out", resume=True, **ck)
    assert _files(tmp_path / "out") == _files(tmp_path / "ref")


def test_dense_chunked_agg_equals_unchunked():
    """``run_scan`` in aggregate mode (per-tick totals and ``[T, N]``
    counts), in segments and whole, and the JAX package's."""
    conf = DENSE.format(backend="tpu", n=24, single=1, drop=1, total=40,
                        join="staggered")
    jp, pp = _params(conf)
    plan = failures.resolve_plan(pp, random.Random(f"app:{SEED}"))
    _, whole = tpu.run_scan(pp, plan, SEED, "cpu", collect_events=False)
    pp.CHECKPOINT_EVERY = 15
    _, chunked = tpu.run_scan(pp, plan, SEED, "cpu", collect_events=False)
    _, want = jax_tpu.run_scan(
        jp, jax_failures.resolve_plan(jp, random.Random(f"app:{SEED}")),
        SEED, collect_events=False)
    for name, w, a, b in zip(want._fields, want, whole, chunked):
        _eq(a, w, name)
        _eq(b, w, name)
