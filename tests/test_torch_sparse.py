"""The port's ``tpu_sparse`` backend and its pieces against the JAX package.

Compared with tolerance 0, on inputs made from a numpy seed:

* ``threefry.bernoulli`` against ``jax.random.bernoulli`` under both
  threefry streams, ``randint`` at the warm views' range ``[1, max(N,
  2))`` and ``split(key, 6)``;
* ``merge_views`` on tie-heavy rows whose survivors overflow the view
  (the order of entries equal on ``(class, -hb)`` decides which ids keep
  a slot), ``scatter_mailbox`` on both slot maps and ``unpack_mailbox``;
* the step at every tick and in every state leaf: warm, staggered and
  batch joins, probes, drops, a hashed mailbox (N > 1024), agg mode,
  both streams;
* ``run_conf``'s logs and detection summary, and kill/resume across the
  two packages.

The JAX step runs jitted per tick; the port's on CPU tensors.
"""

import contextlib
import os
import random
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from distributed_membership_tpu.backends import tpu_sparse as jax_sparse
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.ops import view_merge as jax_vm
from distributed_membership_tpu.runtime import application as jax_app
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch.backends import tpu_sparse
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.ops import threefry, view_merge
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
def stream(partitionable: bool):
    """Both packages on one threefry stream; both flags restored after."""
    prev = jax.config.jax_threefry_partitionable
    try:
        with jax.threefry_partitionable(partitionable), \
                threefry.partitionable(partitionable):
            yield
    finally:
        jax.config.update("jax_threefry_partitionable", prev)


def _key(k):
    return tuple(int(x) for x in np.asarray(k, np.uint32))


# ---------------------------------------------------------------------------
# RNG pieces

@pytest.mark.parametrize("part", [True, False], ids=["partitionable",
                                                      "legacy"])
@pytest.mark.parametrize("shape,p", [((2, 10), 0.1), ((64, 3, 7), 0.05),
                                     ((1001,), 0.33), ((8, 128), 0.99)])
def test_bernoulli_matches_jax(part, shape, p):
    with stream(part):
        for seed in (0, SEED, 0x5EED):
            jk = jax.random.PRNGKey(seed)
            want = np.asarray(jax.random.bernoulli(jk, p, shape))
            got = threefry.bernoulli(_key(jk), p, shape, "cpu")
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("part", [True, False], ids=["partitionable",
                                                      "legacy"])
@pytest.mark.parametrize("n,m", [(10, 10), (512, 16), (65536, 64), (1, 4)])
def test_randint_and_split_match_jax(part, n, m):
    """The warm views' draw (``tpu_sparse.py:163``) and the tick key's
    six-way split."""
    with stream(part):
        jk = jax.random.PRNGKey(SEED ^ 0x5EED)
        want = np.asarray(jax.random.randint(jk, (n, m - 1), 1, max(n, 2),
                                             dtype=jnp.int32))
        got = threefry.randint(_key(jk), (n, m - 1), 1, max(n, 2), "cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        assert threefry.split(_key(jk), 6) == [
            _key(k) for k in jax.random.split(jk, 6)]


# ---------------------------------------------------------------------------
# View merge and mailboxes

def _merge_inputs(rng, n, m, q, n_ids, hb_hi):
    slot_id = rng.integers(0, n_ids, (n, m)).astype(np.int32)
    slot_id[rng.random((n, m)) < 0.2] = -1
    return dict(
        slot_id=slot_id,
        slot_hb=rng.integers(0, hb_hi, (n, m)).astype(np.int32),
        slot_ts=rng.integers(0, 9, (n, m)).astype(np.int32),
        in_id=rng.integers(0, n_ids, (n, q)).astype(np.int32),
        in_hb=rng.integers(0, hb_hi, (n, q)).astype(np.int32),
        in_valid=rng.random((n, q)) < 0.7,
        self_id=(np.arange(n) % n_ids).astype(np.int32),
        self_hb=rng.integers(0, hb_hi + 1, n).astype(np.int32),
        self_on=rng.random(n) < 0.8)


@pytest.mark.parametrize("m,q,n_ids,hb_hi", [
    (16, 40, 24, 4), (16, 40, 1000, 2), (8, 64, 100, 1), (32, 8, 40, 6),
    (64, 321, 65536, 3)])
def test_merge_views_matches_jax(m, q, n_ids, hb_hi):
    """Few distinct heartbeats and more incoming ids than slots: the
    survivors overflow the view, so the order of the ties on ``(class,
    -hb)`` decides the view, at every seed."""
    overflowed = 0
    for seed in range(6):
        rng = np.random.default_rng(seed)
        n = 64
        inp = _merge_inputs(rng, n, m, q, n_ids, hb_hi)
        apply_row = rng.random(n) < 0.9
        want = jax_vm.merge_views(
            *(jnp.asarray(v) for v in inp.values()), jnp.int32(9),
            jnp.asarray(apply_row))
        got = view_merge.merge_views(
            *(torch.from_numpy(v) for v in inp.values()), 9,
            torch.from_numpy(apply_row))
        for name, w, g in zip(want._fields, want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{name} seed={seed}")
        distinct = [len(set(inp["slot_id"][i][inp["slot_id"][i] >= 0])
                        | set(inp["in_id"][i][inp["in_valid"][i]]))
                    for i in range(n)]
        overflowed += sum(d > m for d in distinct)
    if q > m:
        assert overflowed > 0


@pytest.mark.parametrize("n,qsz", [(64, 64), (100, 128), (2048, 256)],
                         ids=["injective", "injective_gt", "hashed"])
def test_scatter_and_unpack_mailbox_match_jax(n, qsz):
    rng = np.random.default_rng(n)
    rows = 50
    mail = np.where(rng.random((rows, qsz)) < 0.3,
                    rng.integers(1, 40 * n, (rows, qsz)), 0).astype(np.uint32)
    k = 3000
    tgt = rng.integers(0, rows, k).astype(np.int32)
    msg_id = rng.integers(0, n, k).astype(np.int32)
    msg_hb = rng.integers(0, 40, k).astype(np.int32)
    valid = rng.random(k) < 0.8
    for salt in (0, 7, 699 + 0x2545F49):
        want = np.asarray(jax_vm.scatter_mailbox(
            jnp.asarray(mail), jnp.asarray(tgt), jnp.asarray(msg_id),
            jnp.asarray(msg_hb), jnp.asarray(valid), n, salt=salt))
        got = view_merge.scatter_mailbox(
            torch.from_numpy(mail.view(np.int32)), torch.from_numpy(tgt),
            torch.from_numpy(msg_id), torch.from_numpy(msg_hb),
            torch.from_numpy(valid), n, salt=salt)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        for w, g in zip(jax_vm.unpack_mailbox(jnp.asarray(want), n),
                        view_merge.unpack_mailbox(got, n)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# The step, per tick

SPARSE = """MAX_NNB: {n}
SINGLE_FAILURE: {single}
DROP_MSG: {drop}
MSG_DROP_PROB: 0.1
BACKEND: tpu_sparse
VIEW_SIZE: {m}
GOSSIP_LEN: {g}
PROBES: {p}
FANOUT: 3
TFAIL: 8
TREMOVE: 40
TOTAL_TIME: {total}
FAIL_TIME: 20
DROP_START: 5
DROP_STOP: 30
JOIN_MODE: {join}
EVENT_MODE: {ev}
"""


def _params(conf: str):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JaxParams.from_text(conf), Params.from_text(conf)


def _leaves(state, prefix=""):
    for name, x in state._asdict().items():
        if isinstance(x, tuple):
            yield from _leaves(x, f"{name}.")
        else:
            yield prefix + name, x


def assert_same_state(want, got, t):
    for (name, w), (_, g) in zip(_leaves(want), _leaves(got)):
        w = np.asarray(w)
        g = g.cpu().numpy()
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        if not np.array_equal(w, g):
            at = tuple(np.argwhere(w != g)[0]) if w.shape else ()
            raise AssertionError(f"tick {t}: leaf {name} differs first at "
                                 f"{at}: jax {w[at]} port {g[at]}")


def run_sparse_both(conf: str, seed: int = SEED):
    """Both steps tick by tick from the same conf and seed; the state and
    the tick's events are compared after every tick.  Returns the port's
    final state."""
    jp, pp = _params(conf)
    collect = jp.resolved_event_mode() == "full"
    plan_j = jax_failures.resolve_plan(jp, random.Random(f"app:{seed}"))
    plan_p = failures.resolve_plan(pp, random.Random(f"app:{seed}"))
    total = jp.TOTAL_TIME
    jcfg = jax_sparse.make_config(jp, collect)
    pcfg = tpu_sparse.make_config(pp, collect)
    assert dict(jcfg.__dict__) == dict(pcfg.__dict__)
    ticks, keys, *sched = jax_failures.plan_tensors(jp, plan_j, seed, total)
    plan_t = failures.plan_tensors(pp, plan_p, seed, total, "cpu")
    if jp.JOIN_MODE == "warm":
        js = jax_sparse.init_state_warm(
            jcfg, jax_failures.make_run_key(jp, seed ^ 0x5EED))
        ps = tpu_sparse.init_state_warm(
            pcfg, failures.make_run_key(pp, seed ^ 0x5EED), "cpu")
    else:
        js, ps = jax_sparse.init_state(jcfg), tpu_sparse.init_state(pcfg,
                                                                      "cpu")
    assert_same_state(js, ps, -1)
    jstep = jax.jit(jax_sparse.make_step(jcfg))
    pstep = tpu_sparse.make_step(pcfg)
    for t in range(total):
        js, jo = jstep(js, (ticks[t], keys[t], *sched))
        ps, po = pstep(ps, t, plan_t.tick_key(t), plan_t)
        assert_same_state(js, ps, t)
        assert_same_state(jo, po, t)
    return ps


@pytest.mark.parametrize("kw", [
    dict(n=64, m=16, g=4, p=2, drop=1, single=1, total=40, join="warm",
         ev="full"),
    dict(n=64, m=16, g=4, p=2, drop=1, single=1, total=40,
         join="staggered", ev="full"),
    dict(n=40, m=8, g=8, p=0, drop=1, single=0, total=40, join="batch",
         ev="agg"),
    dict(n=128, m=0, g=0, p=0, drop=0, single=1, total=30, join="batch",
         ev="full"),
    dict(n=1100, m=16, g=4, p=4, drop=1, single=0, total=25, join="warm",
         ev="agg"),
    dict(n=48, m=8, g=3, p=8, drop=1, single=1, total=30, join="warm",
         ev="full")],
    ids=["warm_probes_drops", "staggered", "batch_agg_overflow",
         "full_view", "hashed_mailbox_agg", "probes_cover_the_view"])
def test_step_per_tick_matches_jax(kw):
    run_sparse_both(SPARSE.format(**kw))


def test_step_legacy_stream_matches_jax():
    with stream(False):
        run_sparse_both(SPARSE.format(n=64, m=16, g=4, p=2, drop=1,
                                      single=1, total=30, join="warm",
                                      ev="full"))


def test_batch_join_overflows_the_view():
    """Batch join at N = 40 into M = 8 slots: the introducer's burst
    offers every joiner far more ids than it has slots, so the merge's
    tie order is exercised on the path, and the views stay full."""
    final = run_sparse_both(SPARSE.format(n=40, m=8, g=8, p=0, drop=0,
                                          single=1, total=12, join="batch",
                                          ev="full"))
    assert (final.slot_id != view_merge.EMPTY).sum(1).min() == 8


# ---------------------------------------------------------------------------
# Whole runs

def _files(d):
    return {f: (d / f).read_bytes() for f in ("dbg.log", "stats.log",
                                             "msgcount.log")
            if (d / f).exists()}


@pytest.mark.parametrize("kw", [
    dict(n=64, m=16, g=4, p=2, drop=1, single=1, total=60, join="warm",
         ev="full"),
    dict(n=48, m=12, g=4, p=2, drop=1, single=0, total=60,
         join="staggered", ev="full")], ids=["warm", "staggered"])
def test_run_conf_logs_byte_identical(kw, tmp_path):
    conf = tmp_path / "c.conf"
    conf.write_text(SPARSE.format(**kw))
    jax_app.run_conf(str(conf), out_dir=str(tmp_path / "j"))
    application.run_conf(str(conf), out_dir=str(tmp_path / "p"),
                         device="cpu")
    want = _files(tmp_path / "j")
    assert set(want) == {"dbg.log", "stats.log", "msgcount.log"}
    assert _files(tmp_path / "p") == want


def test_agg_detection_summary_identical(tmp_path):
    conf = tmp_path / "c.conf"
    conf.write_text(SPARSE.format(n=256, m=16, g=4, p=2, drop=1, single=1,
                                  total=70, join="warm", ev="agg"))
    want = jax_app.run_conf(str(conf), out_dir=str(tmp_path / "j"))
    got = application.run_conf(str(conf), out_dir=str(tmp_path / "p"),
                               device="cpu")
    assert got.extra["detection_summary"] == want.extra["detection_summary"]
    assert "approx_probe_attribution" not in got.extra["detection_summary"]
    np.testing.assert_array_equal(got.sent, want.sent)
    np.testing.assert_array_equal(got.recv, want.recv)


@pytest.mark.parametrize("ev", ["full", "agg"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_kill_and_resume_across_packages(ev, writer, reader, tmp_path,
                                         monkeypatch):
    """Killed at a segment boundary in one package, resumed in the
    other: the logs (full) or the detection summary (agg) equal the
    uninterrupted run's."""
    conf = tmp_path / "c.conf"
    conf.write_text(SPARSE.format(n=64, m=16, g=4, p=2, drop=1, single=1,
                                  total=60, join="warm", ev=ev))

    def run(pkg, out, **kw):
        if pkg == "jax":
            return jax_app.run_conf(str(conf), out_dir=str(out), **kw)
        return application.run_conf(str(conf), out_dir=str(out),
                                    device="cpu", **kw)

    ref = run("jax", tmp_path / "ref")
    ck = dict(checkpoint_every=10, checkpoint_dir=str(tmp_path / "ck"))
    monkeypatch.setenv("DM_CRASH_AT_TICK", "30")
    with pytest.raises(RuntimeError, match="injected crash at tick 30"):
        run(writer, tmp_path / "killed", **ck)
    monkeypatch.delenv("DM_CRASH_AT_TICK")
    got = run(reader, tmp_path / "out", resume=True, **ck)
    if ev == "full":
        assert _files(tmp_path / "out") == _files(tmp_path / "ref")
    else:
        assert (got.extra["detection_summary"]
                == ref.extra["detection_summary"])


def test_refusals_as_jax(tmp_path):
    """What the JAX package refuses for tpu_sparse the port refuses with
    the same message."""
    base = SPARSE.format(n=64, m=16, g=4, p=2, drop=0, single=1, total=20,
                         join="warm", ev="full")
    for extra in ("TELEMETRY: scalars\n", "RNG_MODE: hoisted\n"
                  "CHECKPOINT_EVERY: 10\n", "MESH_SHAPE: 2\n"):
        with pytest.raises(ValueError) as want:
            JaxParams.from_text(base + extra)
        with pytest.raises(ValueError) as got:
            Params.from_text(base + extra)
        assert str(got.value) == str(want.value)
    big = SPARSE.format(n=2**20, m=16, g=4, p=2, drop=0, single=1,
                        total=3000, join="warm", ev="agg")
    with pytest.raises(ValueError, match="overflows"):
        tpu_sparse.run_scan(Params.from_text(big), None, SEED, "cpu")
    assert os.environ.get("DM_CRASH_AT_TICK") is None
