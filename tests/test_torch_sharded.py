"""The port's sharded ring step (backends/tpu_hash_sharded.py) against the
JAX package's, on the CPU.

The JAX side runs on the eight virtual CPU devices of tests/conftest.py;
the port holds the same mesh on one device (parallel/mesh.py LocalMesh)
and runs the wrappers' plain versions.  Compared, with tolerance 0:

* K4: ``gossip_stacked_plain`` / ``gossip_fused_stacked`` against the JAX
  ``gossip_fused_stacked`` in interpret mode (both operand forms, both
  column regimes, and several shards in one call against per-shard JAX
  calls); K1 and K3 over all rows of a stacked mesh against per-shard JAX
  calls with their row offsets;
* ``sharded_ring_rng``, the warm init and ``LocalMesh.block_send`` against
  their JAX counterparts;
* the sharded step at every tick and in every state leaf, for
  ``MESH_SHAPE`` 8, 1 and 2x4, drops on and off, PROBE_IO exact and
  approx, and with the JAX Pallas K4 (interpret) on the JAX side;
* whole runs: byte-identical logs at N=256 on eight shards, an identical
  detection summary at N=2048;
* the refusals of what the port does not run yet.
"""

import pathlib
import random
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as JP

from distributed_membership_tpu.backends import tpu_hash_sharded as jax_sh
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.observability.aggregates import merge_agg
from distributed_membership_tpu.ops import fused_gossip as jax_gossip
from distributed_membership_tpu.ops import fused_probe as jax_probe
from distributed_membership_tpu.ops import fused_receive as jax_receive
from distributed_membership_tpu.ops import rng_plan as jax_rng_plan
from distributed_membership_tpu.parallel import shard_map
from distributed_membership_tpu.parallel.mesh import make_torus_mesh
from distributed_membership_tpu.runtime import application as jax_app
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch import kernels
from distributed_membership_tpu_torch.backends import tpu_hash_sharded as sh
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import (
    state_from_numpy, state_to_numpy)
from distributed_membership_tpu_torch.observability.aggregates import (
    init_fast_agg)
from distributed_membership_tpu_torch.ops.fused_gossip import (
    gossip_fused_stacked, gossip_stacked_plain)
from distributed_membership_tpu_torch.ops.fused_probe import (
    probe_window_fused)
from distributed_membership_tpu_torch.ops.fused_receive import receive_fused
from distributed_membership_tpu_torch.ops.rng_plan import sharded_ring_rng
from distributed_membership_tpu_torch.ops.view_merge import STRIDE
from distributed_membership_tpu_torch.parallel.mesh import LocalMesh
from distributed_membership_tpu_torch.runtime import application
from distributed_membership_tpu_torch.runtime import failures

CONFS = (pathlib.Path(__file__).resolve().parent.parent
         / "distributed_membership_tpu_torch" / "confs")
S = 128
TFAIL, TREMOVE = 16, 40
SEED = 3
TICKS = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores, and torch's OpenMP workers would then wait on each
    other at every op of the tick loop."""
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


def _u32(rng, shape, occ=1.0):
    """u32 values over the whole range (so unsigned order matters), 0
    where unoccupied."""
    val = rng.integers(1, 2**32, size=shape, dtype=np.int64)
    return np.where(rng.random(shape) < occ, val, 0).astype(np.uint32)


def _bits(a):
    """numpy u32 -> torch int32 holding the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _eq(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# K4 against the JAX gossip_fused_stacked (interpret mode)

# (rows, S, K, single_col, form): the JAX tests' cases.
K4_CASES = [(256, 128, 3, True, "stacked"), (64, 128, 4, False, "stacked"),
            (512, 256, 2, False, "stacked"), (256, 128, 3, True, "shared"),
            (64, 128, 4, False, "shared"), (256, 128, 2, True, "masks")]


def _k4_inputs(rows, s, k, form, seed, shards=1):
    rng = np.random.default_rng(seed)
    n_local = rows // shards
    mail = _u32(rng, (rows, s), 0.6)
    kp = 1 if form == "shared" else k
    payloads = _u32(rng, (kp, rows, s), 0.3 if form == "stacked" else 0.9)
    cs = rng.integers(0, n_local, size=k).astype(np.int32)
    s1 = rng.integers(0, s, size=(shards, k)).astype(np.int32)
    s2 = ((s1 + 7) % s).astype(np.int32)
    masks = (rng.random((k, rows, s)) < 0.7) if form != "stacked" else None
    return mail, payloads, cs, s1, s2, masks


@pytest.mark.parametrize("rows,s,k,single,form", K4_CASES)
def test_k4_matches_pallas(rows, s, k, single, form, no_launch):
    mail, payloads, cs, s1, s2, masks = _k4_inputs(rows, s, k, form,
                                                   seed=rows + k)
    want = jax_gossip.gossip_fused_stacked(
        rows, s, k, single, True, jnp.asarray(mail), jnp.asarray(payloads),
        jnp.asarray(cs), jnp.asarray(s1[0]), jnp.asarray(s2[0]),
        masks=None if masks is None else jnp.asarray(masks, jnp.int32))
    args = (_bits(payloads), _i32(cs), _i32(s1), _i32(s2),
            None if masks is None else torch.from_numpy(masks))
    for fn in (gossip_stacked_plain, gossip_fused_stacked):
        got = fn(rows, s, k, single, _bits(mail), *args)
        _eq(got, want, f"{fn.__name__} {rows},{s},{k},{single},{form}")
    assert not np.array_equal(np.asarray(want), mail)


@pytest.mark.parametrize("form", ["stacked", "shared"])
def test_k4_shards_in_one_call(form, no_launch):
    """One call over D=4 shards (per-shard s1/s2, L=64 so L*STRIDE % S !=
    0) equals the JAX kernel called shard by shard."""
    d, n_local, k = 4, 64, 3
    rows = d * n_local
    mail, payloads, cs, s1, s2, masks = _k4_inputs(rows, S, k, form,
                                                   seed=11, shards=d)
    assert (n_local * STRIDE) % S != 0
    want = np.concatenate([np.asarray(jax_gossip.gossip_fused_stacked(
        n_local, S, k, False, True, jnp.asarray(mail[sl]),
        jnp.asarray(payloads[:, sl]), jnp.asarray(cs), jnp.asarray(s1[i]),
        jnp.asarray(s2[i]),
        masks=None if masks is None else jnp.asarray(masks[:, sl],
                                                      jnp.int32)))
        for i, sl in ((i, slice(i * n_local, (i + 1) * n_local))
                      for i in range(d))])
    got = gossip_fused_stacked(
        n_local, S, k, False, _bits(mail), _bits(payloads), _i32(cs),
        _i32(s1), _i32(s2), None if masks is None else torch.from_numpy(masks))
    _eq(got, want, form)


def test_k4_wrapper_checks_arguments():
    mail, payloads, cs, s1, s2, _ = _k4_inputs(64, S, 3, "stacked", seed=2)
    good = dict(mail=_bits(mail), payloads=_bits(payloads), c=_i32(cs),
                s1=_i32(s1), s2=_i32(s2))

    def call(**kw):
        a = {**good, **kw}
        return gossip_fused_stacked(64, S, 3, False, a["mail"],
                                    a["payloads"], a["c"], a["s1"], a["s2"],
                                    a.get("masks"))

    with pytest.raises(ValueError, match="s1/s2"):
        call(s1=_i32(s1[0]))
    with pytest.raises(ValueError, match="payloads"):
        call(payloads=_bits(payloads[:2]))
    with pytest.raises(ValueError, match="c must"):
        call(c=_i32(cs).to(torch.int64))
    with pytest.raises(ValueError, match="masks"):
        call(masks=torch.ones((3, 64, S), dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of n_local"):
        gossip_fused_stacked(48, S, 3, False, good["mail"], good["payloads"],
                             good["c"], good["s1"], good["s2"])


# ---------------------------------------------------------------------------
# K1 and K3 on the stacked layout: one call over all rows == the JAX
# per-shard calls with their row offsets.


def test_receive_and_probe_over_all_shards(no_launch):
    d, n_local, t, p_cnt, fail_ids = 4, 32, 45, 16, (3, 70)
    n = d * n_local
    rng = np.random.default_rng(5)
    ids = rng.integers(0, n, size=(n, S))
    hbs = rng.integers(0, 2 * t, size=(n, S))
    view = np.where(rng.random((n, S)) < 0.7, hbs * n + ids + 1,
                    0).astype(np.uint32)
    mail = np.where(rng.random((n, S)) < 0.4, view + 2 * n, 0).astype(
        np.uint32)
    view_ts = rng.integers(0, t + 1, size=(n, S), dtype=np.int32)
    cand = np.where(rng.random((n, S)) < 0.2, view + n, 0).astype(np.uint32)
    recv, act = rng.random(n) < 0.9, rng.random(n) < 0.9
    own = (rng.integers(1, 2 * t, size=n) * n + np.arange(n) + 1)
    spack = np.where(act, own, 0).astype(np.uint32)
    got = receive_fused(n, S, TFAIL, TREMOVE, STRIDE, t, _bits(view),
                        torch.from_numpy(view_ts), _bits(mail), _bits(cand),
                        torch.from_numpy(recv), torch.from_numpy(act),
                        torch.from_numpy(act), _bits(spack))
    parts = []
    for me in range(d):
        sl = slice(me * n_local, (me + 1) * n_local)
        parts.append(jax_receive.receive_fused(
            n, S, TFAIL, TREMOVE, STRIDE, True, jnp.asarray(t, jnp.int32),
            view[sl], view_ts[sl], mail[sl], cand[sl], recv[sl], act[sl],
            act[sl], spack[sl],
            jnp.arange(me * n_local, (me + 1) * n_local, dtype=jnp.int32)))
    names = ("view", "view_ts", "mail", "join", "rm_ids", "numfailed",
             "size")
    for i, name in enumerate(names):
        _eq(got[i], np.concatenate([np.asarray(p[i]) for p in parts]), name)
    new_view, rm_ids = got[0], got[4]
    assert (rm_ids >= 0).any()

    pfo = probe_window_fused(n, S, p_cnt, TFAIL, fail_ids, False, True, t,
                             (t * p_cnt) % S, 0, new_view, None,
                             torch.from_numpy(act), rm_ids)
    jv, jrm = new_view.numpy().view(np.uint32), rm_ids.numpy()
    want = [jax_probe.probe_window_fused(
        n, S, p_cnt, TFAIL, fail_ids, False, True, True,
        jnp.asarray(t, jnp.int32), jnp.asarray((t * p_cnt) % S, jnp.int32),
        jnp.asarray(me * n_local, jnp.int32),
        jv[me * n_local:(me + 1) * n_local], None,
        act[me * n_local:(me + 1) * n_local],
        jrm[me * n_local:(me + 1) * n_local]) for me in range(d)]
    _eq(pfo["ids"], np.concatenate(
        [np.asarray(w["ids"])[:, :p_cnt] for w in want]).view(np.int32),
        "ids")
    _eq(pfo["rm_cnt"], np.concatenate(
        [np.asarray(w["rm_cnt"])[:, 0] for w in want]), "rm_cnt")
    _eq(pfo["det"], np.stack([np.concatenate(
        [np.asarray(w["det_cols"][f])[:, 0] for w in want])
        for f in range(len(fail_ids))]), "det")


# ---------------------------------------------------------------------------
# RNG plan, warm init, block_send


def _key(k):
    return tuple(int(x) for x in np.asarray(k, np.uint32))


@pytest.mark.parametrize("me", [0, 3, 7])
@pytest.mark.parametrize("use_drop,cold", [(True, False), (False, False),
                                           (True, True)])
def test_sharded_ring_rng_matches_jax(me, use_drop, cold):
    assert jax.config.jax_threefry_partitionable
    jk = jax.random.fold_in(jax.random.PRNGKey(9), 31)
    kw = dict(n=256, n_local=32, s=S, g=32, k_max=3, p_cnt=16, seed_rows=8,
              use_drop=use_drop, cold_join=cold)
    want = jax_rng_plan.sharded_ring_rng(jk, me, **kw)
    got = sharded_ring_rng(_key(jk), range(me, me + 1), device="cpu", **kw)
    _eq(got.shift_draw, want.shift_draw, "shift_draw")
    for name in ("thin_u", "ctrl_u", "burst_u", "probe_u", "ack_u"):
        w = np.asarray(getattr(want, name))
        _eq(getattr(got, name).numpy().view(np.uint32), w.view(np.uint32),
            name)
    assert len(got.gossip_u) == (3 if use_drop else 0)
    for j, g in enumerate(got.gossip_u):
        _eq(g.numpy().view(np.uint32),
            np.asarray(want.gossip_u[j]).view(np.uint32), f"gossip_u[{j}]")
    # Every shard of the mesh at once: the per-shard streams in shard
    # order, the replicated ones once.
    mesh_plan = sharded_ring_rng(_key(jk), range(8), device="cpu", **kw)
    ones = [sharded_ring_rng(_key(jk), range(d, d + 1), device="cpu", **kw)
            for d in range(8)]
    for name in ("thin_u", "probe_u", "ack_u"):
        assert torch.equal(getattr(mesh_plan, name),
                           torch.cat([getattr(o, name) for o in ones])), name
    for j, g in enumerate(mesh_plan.gossip_u):
        assert torch.equal(g, torch.cat([o.gossip_u[j] for o in ones]))
    for name in ("shift_draw", "ctrl_u", "burst_u"):
        assert torch.equal(getattr(mesh_plan, name), getattr(got, name))


@pytest.mark.parametrize("shape", [(8,), (2, 4)])
def test_block_send_matches_jax(shape):
    d = int(np.prod(shape))
    jmesh = make_torus_mesh(*shape)
    axes = tuple(jmesh.axis_names)
    send = jax_sh.make_block_send(d, axes, shape)
    n = 4 * d
    x = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    run = jax.jit(shard_map(
        lambda v, b: send((v,), b)[0], mesh=jmesh,
        in_specs=(JP(axes), JP()), out_specs=JP(axes), check_vma=False))
    mesh = LocalMesh(shape, "cpu")
    for b in range(d):
        want = np.asarray(run(jnp.asarray(x), jnp.asarray(b, jnp.int32)))
        for bb in (b, torch.tensor(b, dtype=torch.int32)):
            _eq(mesh.block_send(torch.from_numpy(x), bb), want, f"b={b}")


def test_local_mesh_collectives():
    mesh = LocalMesh((2, 2), "cpu")
    assert mesh.size == 4 and mesh.rows_per_shard(12) == 3
    with pytest.raises(ValueError, match="not divisible"):
        mesh.rows_per_shard(10)
    x = torch.arange(12, dtype=torch.int32)
    assert mesh.local_roll(x, 1).tolist() == [2, 0, 1, 5, 3, 4, 8, 6, 7,
                                              11, 9, 10]
    assert mesh.shard_sums(x).tolist() == [3, 12, 21, 30]
    parts = torch.arange(8, dtype=torch.int32).view(4, 2)
    assert mesh.psum(parts).tolist() == [12, 16]
    assert mesh.psum_scatter(parts).dtype == torch.int32
    assert mesh.all_gather(x) is x
    assert LocalMesh((1,), "cpu").block_send(x, 5) is x


# ---------------------------------------------------------------------------
# The sharded step at every tick

_BASE = ("MAX_NNB: {n}\nSINGLE_FAILURE: 1\nVIEW_SIZE: 128\nGOSSIP_LEN: 32\n"
         "PROBES: 16\nFANOUT: 3\nTFAIL: 16\nTREMOVE: {tremove}\n"
         "TOTAL_TIME: 60\nFAIL_TIME: 8\nJOIN_MODE: warm\nEXCHANGE: ring\n"
         "BACKEND: tpu_hash_sharded\nMESH_SHAPE: {mesh}\n")
_DROPS = "DROP_MSG: 1\nMSG_DROP_PROB: 0.05\nDROP_START: 10\nDROP_STOP: 50\n"
_NODROP = "DROP_MSG: 0\nMSG_DROP_PROB: 0\n"
_AGG = ("DROP_MSG: 1\nMSG_DROP_PROB: 0.05\nDROP_START: 0\nDROP_STOP: 60\n"
        "EVENT_MODE: agg\nPROBE_IO: approx\n")
# name: (port conf, extra JAX-only keys)
STEP_CASES = {
    # full event mode, exact probe attribution (N <= 2^17)
    "d8_lossless": (_BASE.format(n=256, tremove=40, mesh=8) + _NODROP, ""),
    "d8_drops": (_BASE.format(n=256, tremove=40, mesh=8) + _DROPS, ""),
    # the 1M path's branches: on-device aggregates with detections, probe
    # counters on the prober's row with the orphan re-credit
    "d8_agg_approx": (_BASE.format(n=256, tremove=32, mesh=8) + _AGG, ""),
    "d1_lossless": (_BASE.format(n=256, tremove=40, mesh=1) + _NODROP, ""),
    "d1_drops": (_BASE.format(n=256, tremove=40, mesh=1) + _DROPS, ""),
    "d1_agg_approx": (_BASE.format(n=256, tremove=32, mesh=1) + _AGG, ""),
    "2x4_lossless": (_BASE.format(n=256, tremove=40, mesh="2x4") + _NODROP,
                     ""),
    "2x4_drops": (_BASE.format(n=256, tremove=40, mesh="2x4") + _DROPS, ""),
    "2x4_agg_approx": (_BASE.format(n=256, tremove=32, mesh="2x4") + _AGG,
                       ""),
    # L = 128 (one column alignment) with the JAX Pallas K4 in interpret
    # mode on the JAX side
    "n1024_jax_k4": (_BASE.format(n=1024, tremove=40, mesh=8) + _DROPS,
                     "FUSED_GOSSIP: 1\n"),
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


def _port_leaves(state, mesh, cfg) -> dict:
    """The port state's leaves, its per-shard FastAgg partials reduced."""
    if cfg.fast_agg:
        state = state._replace(agg=sh.reduce_fast_agg(state.agg, mesh))
    return state_to_numpy(state)


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


def _setup(conf: str, jax_extra: str = ""):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = JaxParams.from_text(conf + jax_extra)
        pp = Params.from_text(conf)
    collect = jp.resolved_event_mode() == "full"
    jplan = jax_failures.make_plan(jp, random.Random(f"app:{SEED}"))
    pplan = failures.make_plan(pp, random.Random(f"app:{SEED}"))
    assert (pplan.failed_indices, pplan.fail_time) == (
        jplan.failed_indices, jplan.fail_time)
    jmesh = jax_sh.resolve_mesh(jp)
    mesh = sh.resolve_mesh(pp, "cpu")
    assert mesh.size == jmesh.size
    n_local = pp.EN_GPSZ // mesh.size
    fail_ids = tuple(jplan.failed_indices)
    jcfg = jax_sh.sharded_config(jp, collect, fail_ids, None, n_local)
    pcfg = sh.sharded_config(pp, collect, fail_ids, n_local, device="cpu")
    assert (pcfg.count_probe_io, pcfg.fast_agg) == (jcfg.count_probe_io,
                                                    jcfg.fast_agg)
    assert jcfg.fused_gossip == ("FUSED_GOSSIP: 1" in jax_extra)
    return jp, pp, jplan, pplan, jcfg, pcfg, jmesh, mesh, n_local


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sharded_step_matches_jax_every_tick(case):
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
    if pcfg.fast_agg:
        pstate = pstate._replace(agg=init_fast_agg(
            len(pcfg.fail_ids), pcfg.n, "cpu", shards=mesh.size))
    pplan_t = failures.plan_tensors(pp, pplan, SEED, TICKS, "cpu")
    pstep = sh.make_ring_sharded_step(pcfg, mesh)

    acc = None                   # the JAX agg, summed over one-tick segments
    removals = 0
    for t in range(TICKS):
        jstate, jev = seg(jstate, inputs[0][t:t + 1], inputs[1][t:t + 1],
                          *inputs[2:])
        want = _jax_leaves(jstate)
        if not jcfg.collect_events:
            tick_agg = jax.tree.map(np.asarray, jstate.agg)
            acc = tick_agg if acc is None else merge_agg(acc, tick_agg)
            want.update({f"agg.{f}": np.asarray(x)
                         for f, x in acc._asdict().items()})
        pstate, pout = pstep(pstate, t, pplan_t.tick_key(t), pplan_t)
        got = _port_leaves(pstate, mesh, pcfg)
        assert set(got) == set(want)
        for name in sorted(want):
            _first_mismatch(t, name, got[name], want[name])
        for name in pout._fields:
            _first_mismatch(t, f"events.{name}", getattr(pout, name),
                            np.asarray(getattr(jev, name))[0])
        rm = np.asarray(jev.rm_ids)
        removals += int((rm >= 0).sum() if rm.ndim > 1 else rm.sum())
    # The run exercised the failure path: someone removed someone.
    assert removals > 0
    if not pcfg.collect_events:
        assert int(acc.det_count.sum()) > 0


def test_warm_init_matches_jax():
    """The port's own warm start equals the JAX per-shard one (offsets
    from fold_in(key, shard), slots on global rows), on eight shards."""
    jp, pp, _, _, jcfg, pcfg, jmesh, mesh, n_local = _setup(
        *STEP_CASES["d8_drops"])
    jstate = jax_sh._get_init_runner(jcfg, n_local, jmesh, True)(
        jax_failures.make_run_key(jp, SEED ^ 0x5EED))
    pstate = sh.init_local_state_warm(
        pcfg, mesh, failures.make_run_key(pp, SEED ^ 0x5EED))
    want, got = _jax_leaves(jstate), _port_leaves(pstate, mesh, pcfg)
    assert set(got) == set(want)
    for name in want:
        _first_mismatch(-1, name, got[name], want[name])
    assert got["amail"].shape == (8, 1)
    # The per-shard offsets are not the single-chip ones.
    from distributed_membership_tpu_torch.backends import tpu_hash
    flat = tpu_hash.init_state_warm(pcfg, failures.make_run_key(
        pp, SEED ^ 0x5EED), "cpu")
    assert not torch.equal(flat.view, pstate.view)


# ---------------------------------------------------------------------------
# Whole runs through the entry points


def _runs(tmp_path, conf_path, seed):
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out["jax"] = jax_app.run_conf(str(conf_path), seed=seed,
                                      out_dir=str(tmp_path / "jax"))
        out["port"] = application.run_conf(str(conf_path), seed=seed,
                                           out_dir=str(tmp_path / "port"),
                                           device="cpu")
    return out


def test_logs_byte_identical_to_jax(tmp_path):
    conf = CONFS / "ring_256_s128_sharded8_drop.conf"
    runs = _runs(tmp_path, conf, seed=0)
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        want = (tmp_path / "jax" / name).read_bytes()
        got = (tmp_path / "port" / name).read_bytes()
        assert got == want, name
    assert b" removed " in (tmp_path / "port" / "dbg.log").read_bytes()
    assert runs["port"].extra["mesh_size"] == runs["jax"].extra[
        "mesh_size"] == 8


def test_agg_detection_summary_identical(tmp_path):
    conf = tmp_path / "agg.conf"
    conf.write_text(
        "MAX_NNB: 2048\nSINGLE_FAILURE: 1\nDROP_MSG: 0\nMSG_DROP_PROB: 0\n"
        "VIEW_SIZE: 128\nGOSSIP_LEN: 32\nPROBES: 16\nFANOUT: 3\nTFAIL: 16\n"
        "TREMOVE: 40\nTOTAL_TIME: 110\nFAIL_TIME: 50\nJOIN_MODE: warm\n"
        "EXCHANGE: ring\nEVENT_MODE: agg\nBACKEND: tpu_hash_sharded\n"
        "MESH_SHAPE: 8\n")
    runs = _runs(tmp_path, conf, seed=0)
    want = runs["jax"].extra["detection_summary"]
    got = runs["port"].extra["detection_summary"]
    assert got == want
    assert got["detections_total"] > 0 and got["false_removals"] == 0
    # The reduced final FastAgg, leaf by leaf.
    fs = {"port": state_to_numpy(runs["port"].extra["final_state"]),
          "jax": _jax_leaves(runs["jax"].extra["final_state"])}
    assert set(fs["port"]) == set(fs["jax"])
    for name in fs["jax"]:
        _first_mismatch("end", name, fs["port"][name], fs["jax"][name])


# ---------------------------------------------------------------------------
# Refusals

_REF = _BASE.format(n=64, tremove=40, mesh=8) + _NODROP


@pytest.mark.parametrize("extra,item", [
    ("EXCHANGE: scatter\n", "Queue 1 item 6c"),
    ("EXCHANGE_MODE: batched\n", "Queue 1 item 6c"),
    ("PROBE_GATHER: split\n", "Queue 1 item 6c"),
    ("CHECKPOINT_EVERY: 10\nSERVICE_PORT: 0\n", "Queue 1 item 10"),
])
def test_outside_the_slice_is_refused(extra, item):
    """What earlier slices refused now resolves into the JAX package's
    sharded config: the scatter exchange, EXCHANGE_MODE batched and
    PROBE_GATHER split (Queue 1 item 6c, on one card) and SERVICE_PORT
    (item 10, the service daemon); the step runs them (tests of
    test_torch_sharded_scatter.py and test_torch_exchange.py)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_sh.sharded_config(JaxParams.from_text(_REF + extra), True,
                                     (3,), None, 8)
    got = sh.sharded_config(Params.from_text(_REF + extra), True, (3,), 8,
                            device="cpu")
    for field in ("n", "s", "g", "probes", "collect_events", "folded",
                  "fast_agg", "count_probe_io", "exchange",
                  "batched_exchange"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.exchange, got.batched_exchange, want.probe_gather) == (
        "scatter" if "scatter" in extra else "ring", "batched" in extra,
        "split" if "split" in extra else "packed")


@pytest.mark.parametrize("extra", [
    "CHECKPOINT_EVERY: 10\n", "CHECKPOINT_EVERY: 8\nMEGA_TICKS: 4\n",
    "SCENARIO: x.json\nCHECKPOINT_EVERY: 10\n"])
def test_item4_keys_resolve(extra):
    """Queue 1 item 4 is ported on the sharded steps: the checkpoint and
    block keys resolve as in the JAX package's sharded_config."""
    p = Params.from_text(_REF + extra)
    cfg = sh.sharded_config(p, True, (3,), 8, device="cpu")
    assert (cfg.mega_ticks, cfg.mega_pack) == (
        (4, True) if "MEGA" in extra else (0, False))


def test_hoisted_is_refused_as_jax():
    """RNG_MODE hoisted is single-chip: the JAX package's ValueError."""
    conf = _REF + "CHECKPOINT_EVERY: 10\nRNG_MODE: hoisted\n"
    with pytest.raises(ValueError) as want:
        JaxParams.from_text(conf)
    with pytest.raises(ValueError, match="single-chip") as got:
        Params.from_text(conf)
    assert str(got.value) == str(want.value)


def test_more_failed_ids_than_fast_agg_is_refused():
    """More than 8 failed ids under EVENT_MODE agg resolve to the AggStats
    path, as in the JAX package's sharded_config."""
    p = Params.from_text(_REF + "EVENT_MODE: agg\n")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = JaxParams.from_text(_REF + "EVENT_MODE: agg\n")
    from distributed_membership_tpu.backends import tpu_hash_sharded as jsh
    want = jsh.sharded_config(jp, False, tuple(range(9)), None, 32)
    got = sh.sharded_config(p, False, tuple(range(9)), 8, device="cpu")
    assert got.fast_agg == want.fast_agg is False


def test_gates_and_messages_match_jax():
    """The JAX sharded_config gates of the natural layout, word for word,
    and the CUDA refusals of tpu_hash."""
    folded16 = (_REF.replace("VIEW_SIZE: 128", "VIEW_SIZE: 16")
                .replace("GOSSIP_LEN: 32", "GOSSIP_LEN: 4")
                .replace("PROBES: 16", "PROBES: 2") + "EVENT_MODE: agg\n")
    # FOLDED auto on CUDA at S < 128 picks the folded layout globally,
    # but L=8 rows do not fold at P=2 (128/P = 64): the natural layout,
    # whose kernels take S < 128 on CUDA.
    cfg = sh.sharded_config(Params.from_text(folded16), False, (3,), 8,
                            device="cuda")
    assert not cfg.folded and cfg.s == 16
    for extra, n_local in (("FUSED_GOSSIP: 1\n", 4),
                           ("FUSED_RECEIVE: 1\n", 4)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jp = JaxParams.from_text(_REF.replace("MAX_NNB: 64",
                                                  "MAX_NNB: 128") + extra)
        with pytest.raises(ValueError) as want:
            jax_sh.sharded_config(jp, True, (3,), None, n_local)
        with pytest.raises(ValueError) as got:
            sh.sharded_config(Params.from_text(
                _REF.replace("MAX_NNB: 64", "MAX_NNB: 128") + extra), True,
                (3,), n_local, device="cuda")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="approx_lag is single-chip"):
        sh.sharded_config(Params.from_text(_REF + "PROBE_IO: approx_lag\n"),
                          True, (3,), 8, device="cpu")
    with pytest.raises(NotImplementedError, match="FUSED_GOSSIP"):
        sh.sharded_config(Params.from_text(_REF + "FUSED_GOSSIP: 0\n"), True,
                          (3,), 8, device="cuda")
    with pytest.raises(NotImplementedError, match="FUSED_RECEIVE"):
        sh.sharded_config(Params.from_text(_REF + "FUSED_RECEIVE: 1\n"), True,
                          (3,), 8, device="cpu")


@pytest.mark.parametrize("text,match", [
    ("MESH_SHAPE: 2x", "MESH_SHAPE must be"),
    ("MESH_SHAPE: 0", "MESH_SHAPE must be"),
    ("EXCHANGE_MODE: fast", "EXCHANGE_MODE must be"),
    ("PROBE_GATHER: x", "PROBE_GATHER must be"),
])
def test_conf_keys_validated_as_jax(text, match):
    conf = _REF.replace("MESH_SHAPE: 8\n", "") + text + "\n"
    with pytest.raises(ValueError) as want:
        JaxParams.from_text(conf)
    with pytest.raises(ValueError, match=match) as got:
        Params.from_text(conf)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="only supported by BACKEND"):
        Params.from_text(_REF.replace("tpu_hash_sharded", "tpu_hash"))


def test_mesh_must_divide_nodes(tmp_path):
    conf = tmp_path / "bad.conf"
    conf.write_text(_REF.replace("MESH_SHAPE: 8", "MESH_SHAPE: 3"))
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        application.run_conf(str(conf), out_dir=str(tmp_path), device="cpu")
