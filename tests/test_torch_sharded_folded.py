"""The port's sharded folded ring step (``tpu_hash_sharded`` with
``FOLDED``, backends/tpu_hash_folded.py ``make_ring_sharded_folded_step``)
against the JAX package's, on the CPU.

The JAX side runs on the eight virtual CPU devices of tests/conftest.py;
the port holds the mesh on one device (parallel/mesh.py LocalMesh) and
runs the wrappers' plain versions.  Geometry: N=512, S=16, G=4, P=2, so a
shard of L=64 nodes at D=8 folds into 8 plane rows (FP=64).  Compared,
with tolerance 0:

* K6's D-shard form (``gossip_folded_plain`` / ``gossip_folded_stacked``
  with ``n_local``) against the JAX Pallas ``gossip_folded_stacked`` in
  interpret mode, called shard by shard with that shard's slot shifts;
* the warm init against the JAX ``init_local_state_warm_folded``;
* the step at every tick and in every state leaf for ``MESH_SHAPE`` 1, 8
  and 2x4, drops on and off, PROBE_IO exact and approx, and with the JAX
  Pallas K5-K7 (interpret) on the JAX side;
* the sharded folded run against the port's natural sharded run;
* the folded gates of the JAX ``sharded_config`` and their messages.
"""

import random
import warnings

import numpy as np
import pytest

import jax
import torch

from distributed_membership_tpu.backends import tpu_hash_sharded as jax_sh
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.observability.aggregates import merge_agg
from distributed_membership_tpu.ops import fused_folded as jax_ff
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch import kernels
from distributed_membership_tpu_torch.backends import tpu_hash_sharded as sh
from distributed_membership_tpu_torch.backends.tpu_hash_folded import (
    init_local_state_warm_folded, make_ring_sharded_folded_step)
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import (
    state_from_numpy, state_to_numpy)
from distributed_membership_tpu_torch.observability.aggregates import (
    init_fast_agg)
from distributed_membership_tpu_torch.ops.fused_folded import (
    gossip_folded_plain, gossip_folded_stacked)
from distributed_membership_tpu_torch.runtime import failures

SEED = 3
TICKS = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_launch():
    """A wrapper given CPU tensors runs the plain version and launches
    nothing."""
    kernels.reset_launches()
    yield
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES


def _packed(rng, n, occ, shape):
    ids = rng.integers(0, n, size=shape)
    hbs = rng.integers(0, 200, size=shape)
    return np.where(rng.random(shape) < occ, hbs * n + ids + 1,
                    0).astype(np.uint32)


def _bits(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _eq(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# K6 on D shards in one call == the JAX kernel called shard by shard

@pytest.mark.parametrize("s", [2, 16, 32])
@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("form", ["stacked", "masks"])
@pytest.mark.parametrize("single", [True, False])
def test_k6_shards_match_pallas(s, d, form, single, no_launch):
    k = 3
    lf = 8                                   # plane rows per shard
    n_local = lf * 128 // s
    rows = d * lf
    rng = np.random.default_rng(s * 100 + d * 10 + k + int(single))
    mail = _packed(rng, d * n_local, 0.5, (rows, 128))
    view = _packed(rng, d * n_local, 0.8, (rows, 128))
    thr = rng.integers(0, n_local, size=k).astype(np.int32)
    thr[0] = n_local - 1                     # a shard's last node wraps
    c1 = rng.integers(0, s, size=(d, k)).astype(np.int32)
    c2 = rng.integers(0, s, size=(d, k)).astype(np.int32)
    if form == "masks":
        payloads = view[None]
        masks = rng.random((k, rows, 128)) < 0.6
    else:
        payloads = np.where(rng.random((k, rows, 128)) < 0.4, view[None],
                            0).astype(np.uint32)
        masks = None
    want = np.concatenate([np.asarray(jax_ff.gossip_folded_stacked(
        lf, s, k, single, True, mail[sl], payloads[:, sl], thr, c1[i],
        c2[i], masks=None if masks is None else
        masks[:, sl].astype(np.int32)))
        for i, sl in ((i, slice(i * lf, (i + 1) * lf)) for i in range(d))])
    for fn in (gossip_folded_plain, gossip_folded_stacked):
        got = fn(rows, s, k, single, _bits(mail), _bits(payloads),
                 torch.from_numpy(thr), torch.from_numpy(c1),
                 torch.from_numpy(c2),
                 None if masks is None else torch.from_numpy(masks),
                 n_local=n_local)
        _eq(got, want, f"{fn.__name__} S={s} D={d} {form} {single}")
    assert (want != mail).any()


def test_k6_one_shard_takes_flat_shifts(no_launch):
    """``c1``/``c2`` of shape ``[k_max]`` (the single-chip call) equal
    ``[1, k_max]``; a D-shard call needs ``[D, k_max]`` and whole plane
    rows per shard."""
    rng = np.random.default_rng(4)
    rows, s, k = 16, 16, 2
    mail = _bits(_packed(rng, 128, 0.5, (rows, 128)))
    pay = _bits(_packed(rng, 128, 0.5, (k, rows, 128)))
    thr = torch.tensor([3, 100], dtype=torch.int32)
    c = torch.tensor([5, 9], dtype=torch.int32)
    flat = gossip_folded_stacked(rows, s, k, False, mail.clone(), pay, thr,
                                 c, c + 1)
    two = gossip_folded_stacked(rows, s, k, False, mail.clone(), pay, thr,
                                c[None], (c + 1)[None], n_local=128)
    assert torch.equal(flat, two)
    with pytest.raises(ValueError, match=r"c1/c2 must be .*\[2, 2\]"):
        gossip_folded_stacked(rows, s, k, False, mail, pay, thr, c, c,
                              n_local=64)
    with pytest.raises(ValueError, match="whole plane rows"):
        gossip_folded_stacked(rows, s, k, False, mail, pay, thr, c, c,
                              n_local=4)


# ---------------------------------------------------------------------------
# The step at every tick

_BASE = ("MAX_NNB: 512\nSINGLE_FAILURE: 1\nVIEW_SIZE: 16\nGOSSIP_LEN: 4\n"
         "PROBES: 2\nFANOUT: 3\nTFAIL: 16\nTREMOVE: 40\nTOTAL_TIME: 60\n"
         "FAIL_TIME: 8\nJOIN_MODE: warm\nEXCHANGE: ring\nEVENT_MODE: agg\n"
         "BACKEND: tpu_hash_sharded\nFOLDED: 1\nMESH_SHAPE: {mesh}\n")
_DROPS = "DROP_MSG: 1\nMSG_DROP_PROB: 0.05\nDROP_START: 0\nDROP_STOP: 60\n"
_NODROP = "DROP_MSG: 0\nMSG_DROP_PROB: 0\n"
_UNFUSED = "FUSED_RECEIVE: 0\nFUSED_GOSSIP: 0\nFUSED_PROBE: 0\n"
_PALLAS = "FUSED_RECEIVE: 1\nFUSED_GOSSIP: 1\nFUSED_PROBE: 1\n"
# name: (port conf, JAX-only keys)
STEP_CASES = {
    "d8_drops": (_BASE.format(mesh=8) + _DROPS, _UNFUSED),
    "d8_lossless": (_BASE.format(mesh=8) + _NODROP, _UNFUSED),
    "d8_approx": (_BASE.format(mesh=8) + _DROPS + "PROBE_IO: approx\n",
                  _UNFUSED),
    "d1_drops": (_BASE.format(mesh=1) + _DROPS, _UNFUSED),
    "d1_lossless": (_BASE.format(mesh=1) + _NODROP, _UNFUSED),
    "2x4_drops": (_BASE.format(mesh="2x4") + _DROPS, _UNFUSED),
    "2x4_lossless": (_BASE.format(mesh="2x4") + _NODROP, _UNFUSED),
    # the JAX Pallas K5-K7 (interpret mode), one call per shard
    "d8_jax_pallas": (_BASE.format(mesh=8) + _DROPS, _PALLAS),
}


def _jax_leaves(state) -> dict:
    out = {}
    for name, leaf in state._asdict().items():
        if name == "agg":
            for field, x in leaf._asdict().items():
                out[f"agg.{field}"] = np.asarray(x)
        else:
            out[name] = np.asarray(leaf)
    return out


def _first_mismatch(t, name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (
        f"tick {t}: {name} shape {got.shape} != {want.shape}")
    if got.dtype != want.dtype and got.dtype.itemsize == want.dtype.itemsize:
        got = got.view(want.dtype)
    bad = np.argwhere(got != want)
    if bad.size:
        i = tuple(bad[0])
        pytest.fail(f"tick {t}: first divergence in {name} at index {i}: "
                    f"port {got[i]} != jax {want[i]} "
                    f"({len(bad)} elements differ)")


def _port_leaves(state, mesh) -> dict:
    return state_to_numpy(state._replace(
        agg=sh.reduce_fast_agg(state.agg, mesh)))


def _setup(conf: str, jax_extra: str):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = JaxParams.from_text(conf + jax_extra)
        pp = Params.from_text(conf)
    jplan = jax_failures.make_plan(jp, random.Random(f"app:{SEED}"))
    pplan = failures.make_plan(pp, random.Random(f"app:{SEED}"))
    assert (pplan.failed_indices, pplan.fail_time) == (
        jplan.failed_indices, jplan.fail_time)
    jmesh = jax_sh.resolve_mesh(jp)
    mesh = sh.resolve_mesh(pp, "cpu")
    assert mesh.size == jmesh.size
    n_local = pp.EN_GPSZ // mesh.size
    fail_ids = tuple(jplan.failed_indices)
    jcfg = jax_sh.sharded_config(jp, False, fail_ids, None, n_local)
    pcfg = sh.sharded_config(pp, False, fail_ids, n_local, device="cpu")
    assert jcfg.folded and pcfg.folded
    assert jcfg.fused_gossip == (jax_extra == _PALLAS)
    assert pcfg.count_probe_io == jcfg.count_probe_io
    return jp, pp, jplan, pplan, jcfg, pcfg, jmesh, mesh, n_local


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sharded_folded_step_matches_jax_every_tick(case):
    jp, pp, jplan, pplan, jcfg, pcfg, jmesh, mesh, n_local = _setup(
        *STEP_CASES[case])
    init = jax_sh._get_init_runner(jcfg, n_local, jmesh, True)
    seg = jax_sh._get_segment_runner(jcfg, n_local, jmesh, True)
    inputs = jax_failures.plan_tensors(jp, jplan, SEED, TICKS)
    jstate = init(jax_failures.make_run_key(jp, SEED ^ 0x5EED))
    # One start state for both, carried across by convert.py (the agg
    # partials start from zero on either side).
    pstate = state_from_numpy(_jax_leaves(jstate), device="cpu")
    assert isinstance(pstate, sh.ShardedHashState)
    assert pstate.view.shape == (pp.EN_GPSZ * 16 // 128, 128)
    pstate = pstate._replace(agg=init_fast_agg(
        len(pcfg.fail_ids), pcfg.n, "cpu", shards=mesh.size))
    pplan_t = failures.plan_tensors(pp, pplan, SEED, TICKS, "cpu")
    pstep = make_ring_sharded_folded_step(pcfg, mesh)

    acc = None                   # the JAX agg, summed over one-tick segments
    for t in range(TICKS):
        jstate, jev = seg(jstate, inputs[0][t:t + 1], inputs[1][t:t + 1],
                          *inputs[2:])
        tick_agg = jax.tree.map(np.asarray, jstate.agg)
        acc = tick_agg if acc is None else merge_agg(acc, tick_agg)
        want = _jax_leaves(jstate)
        want.update({f"agg.{f}": np.asarray(x)
                     for f, x in acc._asdict().items()})
        pstate, pout = pstep(pstate, t, pplan_t.tick_key(t), pplan_t)
        got = _port_leaves(pstate, mesh)
        assert set(got) == set(want)
        for name in sorted(want):
            _first_mismatch(t, name, got[name], want[name])
        for name in pout._fields:
            _first_mismatch(t, f"events.{name}", getattr(pout, name),
                            np.asarray(getattr(jev, name))[0])
    # The run exercised the failure path: the crashed node was detected.
    assert int(acc.det_count.sum()) > 0


def test_warm_init_matches_jax():
    """The port's folded sharded warm start (per-shard offsets, folded
    planes, per-shard FastAgg partials) equals the JAX one."""
    jp, pp, _, _, jcfg, pcfg, jmesh, mesh, n_local = _setup(
        *STEP_CASES["d8_drops"])
    jstate = jax_sh._get_init_runner(jcfg, n_local, jmesh, True)(
        jax_failures.make_run_key(jp, SEED ^ 0x5EED))
    pstate = init_local_state_warm_folded(
        pcfg, mesh, failures.make_run_key(pp, SEED ^ 0x5EED))
    assert pstate.agg.det_count.shape == (8, 1)
    want, got = _jax_leaves(jstate), _port_leaves(pstate, mesh)
    assert set(got) == set(want)
    for name in want:
        _first_mismatch(-1, name, got[name], want[name])
    assert got["probe_ids1"].shape == (8, 128)
    # convert.py carries the folded sharded leaves both ways.
    back = state_to_numpy(state_from_numpy(got))
    assert set(back) == set(got)
    for name in got:
        _first_mismatch(-1, name, back[name], got[name])


@pytest.mark.parametrize("mesh_shape", ["8", "2x4"])
def test_sharded_folded_equals_natural_sharded(mesh_shape):
    """The fold is a layout: the port's sharded folded step gives the
    natural sharded step's state (reshaped), per-shard aggregates and
    events at every tick, on the same seed."""
    conf = _BASE.format(mesh=mesh_shape) + _DROPS
    pp = Params.from_text(conf)
    plan = failures.make_plan(pp, random.Random(f"app:{SEED}"))
    mesh = sh.resolve_mesh(pp, "cpu")
    fail_ids = tuple(plan.failed_indices)
    fcfg = sh.sharded_config(pp, False, fail_ids, 64, device="cpu")
    ncfg = sh.sharded_config(Params.from_text(conf.replace(
        "FOLDED: 1", "FOLDED: 0")), False, fail_ids, 64, device="cpu")
    assert fcfg.folded and not ncfg.folded
    key = failures.make_run_key(pp, SEED ^ 0x5EED)
    plan_t = failures.plan_tensors(pp, plan, SEED, TICKS, "cpu")
    fstep = make_ring_sharded_folded_step(fcfg, mesh)
    nstep = sh.make_ring_sharded_step(ncfg, mesh)
    fstate = init_local_state_warm_folded(fcfg, mesh, key)
    nstate = sh.init_local_state_warm(ncfg, mesh, key)
    for t in range(TICKS):
        fstate, fout = fstep(fstate, t, plan_t.tick_key(t), plan_t)
        nstate, nout = nstep(nstate, t, plan_t.tick_key(t), plan_t)
        want, got = state_to_numpy(nstate), state_to_numpy(fstate)
        for name in sorted(want):
            _first_mismatch(t, name, got[name].reshape(want[name].shape),
                            want[name])
        for name in nout._fields:
            _first_mismatch(t, f"events.{name}", getattr(fout, name),
                            getattr(nout, name))
    assert int(fstate.agg.det_count.sum()) > 0


# ---------------------------------------------------------------------------
# The folded gates of sharded_config


def _conf(n=512, p=2, extra=""):
    return (_BASE.format(mesh=8).replace("MAX_NNB: 512", f"MAX_NNB: {n}")
            .replace("PROBES: 2", f"PROBES: {p}") + _NODROP + extra)


def _both_raise(conf, n_local, device):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = JaxParams.from_text(conf)
    with pytest.raises(ValueError) as want:
        jax_sh.sharded_config(jp, False, (3,), None, n_local)
    with pytest.raises(ValueError) as got:
        sh.sharded_config(Params.from_text(conf), False, (3,), n_local,
                          device=device)
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_pinned_folded_raises_where_shards_do_not_fold(device):
    """N=256 on eight shards: L=32 is not a multiple of 128/P = 64."""
    msg = _both_raise(_conf(n=256), 32, device)
    assert msg.startswith("FOLDED on tpu_hash_sharded needs the per-shard")


def test_eight_plane_rows_gate():
    """P=4 folds L=32 into 4 plane rows: a pinned kernel raises the JAX
    message; on the CPU (plain versions) the layout runs, and on CUDA
    too, with auto kernels (K5-K7 take any number of plane rows)."""
    conf = _conf(n=256, p=4)
    msg = _both_raise(conf + "FUSED_GOSSIP: 1\n", 32, "cuda")
    assert "at least 8 local plane rows" in msg
    for device in ("cpu", "cuda"):
        assert sh.sharded_config(Params.from_text(conf), False, (3,), 32,
                                 device=device).folded


def test_auto_folded_downgrades_per_shard():
    """FOLDED: -1 takes the folded layout on CUDA where the shards fold;
    where they do not it falls back to the natural layout, whose kernels
    take S < 128 on CUDA; the CPU always runs the natural layout under
    auto, as the JAX package off its accelerator."""
    auto = _conf().replace("FOLDED: 1", "FOLDED: -1")
    assert sh.sharded_config(Params.from_text(auto), False, (3,), 64,
                             device="cuda").folded
    assert not sh.sharded_config(Params.from_text(auto), False, (3,), 64,
                                 device="cpu").folded
    small = _conf(n=256).replace("FOLDED: 1", "FOLDED: -1")
    cfg = sh.sharded_config(Params.from_text(small), False, (3,), 32,
                            device="cuda")
    assert not cfg.folded and cfg.s == 16
    assert not sh.sharded_config(Params.from_text(small), False, (3,), 32,
                                 device="cpu").folded


@pytest.mark.parametrize("extra,match", [
    ("EXCHANGE_MODE: batched\n", "Queue 1 item 6c"),
    ("PROBE_GATHER: split\n", "Queue 1 item 6c"),
])
def test_sharded_folded_refusals(extra, match):
    """EXCHANGE_MODE batched and PROBE_GATHER split, once refused (Queue 1
    item 6c), resolve on the sharded folded step as in the JAX package's
    sharded_config (the runs: tests/test_torch_exchange.py)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_sh.sharded_config(JaxParams.from_text(_conf(extra=extra)),
                                     False, (3,), None, 64)
    got = sh.sharded_config(Params.from_text(_conf(extra=extra)), False,
                            (3,), 64, device="cpu")
    assert got.folded and want.folded
    assert got.batched_exchange == want.batched_exchange
    assert got.batched_exchange == ("batched" in extra)
    assert want.probe_gather == ("split" if "split" in extra else "packed")


def test_sharded_folded_scenario_checkpoints_resolve():
    """A scenario with checkpoints and T-tick blocks (Queue 1 item 4) on
    the sharded folded step."""
    cfg = sh.sharded_config(Params.from_text(_conf(
        extra="SCENARIO: x.json\nCHECKPOINT_EVERY: 16\nMEGA_TICKS: 8\n")),
        False, (3,), 64, device="cpu")
    assert cfg.folded and (cfg.mega_ticks, cfg.mega_pack) == (8, True)


def test_cold_joins_refused_as_jax():
    """FOLDED needs warm joins: the JAX make_config message, word for
    word."""
    conf = _conf().replace("JOIN_MODE: warm", "JOIN_MODE: batch")
    msg = _both_raise(conf, 64, "cpu")
    assert msg == "FOLDED requires EXCHANGE ring and JOIN_MODE warm"
