"""The port's folded layout against the JAX package's, bit for bit.

* K5 ``receive_folded_fused``, K6 ``gossip_folded_stacked`` (stacked
  payloads, and one shared payload with keep masks; one and two column
  alignments) and K7 ``probe_folded_window_fused`` (agg and hist
  partials, alone and together; S = 2 to 64; wrapping windows; no failed
  id; a shard's row0) with ``folded_agg_partials``, K7's window ids and
  per-node ``det_any`` against the JAX kernel's planes reduced as the
  folded step reduced them: the port's wrappers on CPU tensors (their
  plain versions) against the Pallas kernels in interpret mode, as
  ``tests/test_fused_folded.py`` runs them, on numpy-seeded inputs with
  packed values above 2^31 and empty entries.  Integer outputs,
  tolerance 0.  The port's K5 and K7 read per-node vectors where the TPU
  kernels read pre-broadcast planes; both sides get the same values.
* ``roll_nodes`` / ``roll_slots`` against the JAX functions.
* The folded step per tick against the JAX folded step (FUSED_* off),
  from one warm state carried across by ``convert``: N=256, S=16, P=2
  drop-free with PROBE_IO approx and with 5% drops, and N=260, S=64,
  P=32, where (N * STRIDE) % S != 0 gives the two column alignments.
  A mismatch names the first divergent tick, leaf and index.
* The port's folded step against its own natural step at S=16.
* A folded run end to end on ``--device cpu`` against the JAX package's.
"""

import random
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from distributed_membership_tpu.backends import tpu_hash as jax_hash
from distributed_membership_tpu.backends import tpu_hash_folded as jax_fold
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.ops import fused_folded as jax_ff
from distributed_membership_tpu.ops import fused_probe as jax_probe
from distributed_membership_tpu.runtime import application as jax_app
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch import kernels
from distributed_membership_tpu_torch.backends import tpu_hash
from distributed_membership_tpu_torch.backends.tpu_hash_folded import (
    roll_nodes, roll_slots)
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import (
    state_from_numpy, state_to_numpy)
from distributed_membership_tpu_torch.ops.fused_folded import (
    folded_receive_core, gossip_folded_plain, gossip_folded_stacked,
    receive_folded_fused)
from distributed_membership_tpu_torch.ops.fused_probe import (
    folded_agg_partials, probe_folded_plain, probe_folded_window_fused)
from distributed_membership_tpu_torch.ops.view_merge import STRIDE
from distributed_membership_tpu_torch.runtime import application, failures

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


def _packed(rng, n, occ, shape):
    """Packed u32 ``hb * n + id + 1`` entries over the whole u32 range, 0
    where unoccupied."""
    ids = rng.integers(0, n, size=shape, dtype=np.int64)
    hbs = rng.integers(0, (2**32 - n) // n, size=shape, dtype=np.int64)
    return np.where(rng.random(shape) < occ, hbs * n + ids + 1,
                    0).astype(np.uint32)


def _bits(a):
    """numpy u32 -> torch int32 holding the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _eq(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype != got.dtype and want.dtype.itemsize == got.dtype.itemsize:
        got = got.view(want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _rep(v, s):
    """[nodes] -> [rows, 128] per-entry broadcast (the JAX ``rep``)."""
    return np.repeat(v, s).reshape(-1, 128)


# ---------------------------------------------------------------------------
# K5 receive


@pytest.mark.parametrize("n,s,t,row0", [(1024, 16, 45, 0), (256, 64, 60, 0),
                                        (512, 32, 3, 0), (2048, 16, 50, 1024)])
def test_receive_folded_matches_pallas(n, s, t, row0, no_launch):
    nodes = n - row0
    rows = nodes * s // 128
    rng = np.random.default_rng(n + s + t)
    view = _packed(rng, n, 0.7, (rows, 128))
    view_ts = rng.integers(0, t + 1, size=(rows, 128), dtype=np.int32)
    mail = _packed(rng, n, 0.4, (rows, 128))
    bump = np.where(view > 0, view.astype(np.int64) + n * rng.integers(
        -2, 3, size=view.shape), 0)
    bump = np.where((bump > 0) & (bump < 2**32), bump, 0).astype(np.uint32)
    cand = np.where(rng.random(view.shape) < 0.3, bump,
                    np.where(rng.random(view.shape) < 0.1,
                             _packed(rng, n, 1.0, view.shape), 0))
    recv = rng.random(nodes) < 0.9
    act = rng.random(nodes) < 0.9
    own_hb = rng.integers(1, 2 * t + 3, size=nodes)
    self_val = np.where(act, own_hb * n + row0 + np.arange(nodes) + 1,
                        0).astype(np.uint32)
    want = jax_ff.receive_folded_fused(
        n, s, TFAIL, TREMOVE, STRIDE, True, jnp.asarray(t, jnp.int32),
        jnp.asarray(row0, jnp.int32), view, view_ts, mail, cand,
        _rep(recv, s), _rep(act, s), _rep(self_val, s))
    args = (_bits(view), torch.from_numpy(view_ts), _bits(mail),
            _bits(cand), torch.from_numpy(recv), torch.from_numpy(act),
            _bits(self_val))
    names = ("view", "view_ts", "mail", "join", "rm_ids", "stale")
    for fn in (folded_receive_core, receive_folded_fused):
        got = fn(n, s, TFAIL, TREMOVE, STRIDE, t,
                 *(a.clone() for a in args), row0=row0)
        for name, g, w in zip(names, got, want):
            _eq(g, w, f"{fn.__name__}: {name}")
    _, _, _, join, rm_ids, stale = want
    assert np.asarray(join).any()
    assert (np.asarray(rm_ids) >= 0).any() == (t >= TREMOVE)
    assert np.asarray(stale).any() == (t >= TFAIL)


def test_receive_folded_wrapper_checks_arguments():
    rows, s = 8, 16
    plane = torch.zeros((rows, 128), dtype=torch.int32)
    vec = torch.zeros((rows * 8,), dtype=torch.bool)
    with pytest.raises(ValueError, match="divide"):
        receive_folded_fused(64, 24, TFAIL, TREMOVE, STRIDE, 5, plane,
                             plane, plane, plane, vec, vec,
                             vec.to(torch.int32))
    with pytest.raises(ValueError, match="recv/act"):
        receive_folded_fused(64, s, TFAIL, TREMOVE, STRIDE, 5, plane, plane,
                             plane, plane, vec[:-1], vec, vec.to(torch.int32))


# ---------------------------------------------------------------------------
# K6 gossip


@pytest.mark.parametrize("n,s,k_max,single,form,shifts", [
    (1024, 16, 3, True, "stacked", None),
    (1024, 16, 3, False, "stacked", [1, 1023, 517]),
    (1024, 16, 3, True, "masks", [1023, 1, 64]),
    (256, 32, 2, False, "masks", None),
    (512, 32, 4, True, "stacked", [1, 511, 256, 3]),
    (260, 64, 3, False, "stacked", [1, 259, 130]),
    (128, 64, 3, False, "masks", [1, 127, 64]),
    (512, 4, 3, False, "stacked", [1, 511, 37]),
    (512, 4, 3, True, "masks", [1, 511, 37]),
    (512, 8, 3, False, "masks", [1, 511, 130]),
    (512, 8, 3, True, "stacked", [1, 511, 130]),
])
def test_gossip_folded_matches_pallas(n, s, k_max, single, form, shifts,
                                      no_launch):
    rows = n * s // 128
    rng = np.random.default_rng(n + s + k_max)
    mail = _packed(rng, n, 0.5, (rows, 128))
    view = _packed(rng, n, 0.8, (rows, 128))
    if shifts is None:
        shifts = rng.integers(1, n, size=k_max)
    thr = np.asarray(shifts, np.int32)
    c1 = ((thr % s) * (STRIDE % s) % s).astype(np.int32)
    c2 = (((thr - n) % s) * (STRIDE % s) % s).astype(np.int32)
    if form == "masks":
        payloads = view[None]
        masks = rng.random((k_max, rows, 128)) < 0.6
    else:
        payloads = np.where(rng.random((k_max, rows, 128)) < 0.4, view[None],
                            0).astype(np.uint32)
        masks = None
    want = jax_ff.gossip_folded_stacked(
        rows, s, k_max, single, True, mail, payloads, thr, c1, c2,
        masks=None if masks is None else masks.astype(np.int32))
    for fn in (gossip_folded_plain, gossip_folded_stacked):
        got = fn(rows, s, k_max, single, _bits(mail), _bits(payloads),
                 torch.from_numpy(thr), torch.from_numpy(c1),
                 torch.from_numpy(c2),
                 None if masks is None else torch.from_numpy(masks))
        _eq(got, want, fn.__name__)
    assert (np.asarray(want) != mail).any()


def test_gossip_folded_wrapper_checks_arguments():
    rows, s, k = 8, 16, 2
    mail = torch.zeros((rows, 128), dtype=torch.int32)
    vec = torch.zeros((k,), dtype=torch.int32)
    with pytest.raises(ValueError, match="payloads"):
        gossip_folded_stacked(rows, s, k, True, mail,
                              torch.zeros((3, rows, 128), dtype=torch.int32),
                              vec, vec, vec)
    with pytest.raises(ValueError, match="masks"):
        gossip_folded_stacked(rows, s, k, True, mail, mail[None], vec, vec,
                              vec, masks=torch.zeros((k, rows, 128),
                                                     dtype=torch.int32))


# ---------------------------------------------------------------------------
# K7 probe window


def _probe_case(mode, n, s, p_cnt, t, ptr, row0=0):
    return pytest.param(mode, n, s, p_cnt, t, ptr, row0,
                        id=f"{mode}-{n}-{s}-{p_cnt}-{t}-{ptr}"
                        + (f"-row0_{row0}" if row0 else ""))


# Modes: the agg and hist partials alone and together, agg with no failed
# id, and folded_agg_partials (the PROBES: 0 route) against the JAX
# kernel's agg partials.
@pytest.mark.parametrize("mode,n,s,p_cnt,t,ptr,row0", [
    *(_probe_case(m, *g) for m in ("agg", "hist") for g in (
        (1024, 16, 2, 37, 15),     # the window wraps inside each segment
        (1024, 16, 2, 9, 6),
        (260, 64, 32, 100, 48),
        (512, 32, 4, 5, 0))),
    # Several nodes to a 16-byte load: S = 2, 4 and 8; P not dividing S
    # with a wrapping ptr.
    _probe_case("agg", 1024, 2, 1, 5, 1),
    _probe_case("hist", 1024, 2, 1, 6, 0),
    _probe_case("agg", 1024, 4, 3, 7, 2),
    _probe_case("hist_agg", 1024, 4, 3, 7, 3),
    _probe_case("agg", 1024, 8, 3, 11, 6),
    _probe_case("hist", 1024, 8, 3, 11, 7),
    _probe_case("agg", 1024, 8, 4, 2, 4),
    _probe_case("agg", 512, 16, 5, 3, 13),
    _probe_case("agg", 256, 64, 8, 9, 56),
    _probe_case("hist_agg", 1024, 16, 2, 37, 15),
    _probe_case("agg_nofail", 1024, 16, 2, 9, 6),
    _probe_case("agg_nofail", 1024, 2, 1, 4, 0),
    # A shard: the plane's nodes start at global id row0.
    _probe_case("agg", 2048, 16, 2, 37, 15, 1024),
    _probe_case("hist_agg", 2048, 4, 3, 8, 3, 512),
    _probe_case("partials", 1024, 16, 2, 37, 15),
    _probe_case("partials", 1024, 2, 1, 5, 1),
    _probe_case("partials", 260, 64, 32, 100, 48),
])
def test_probe_folded_matches_pallas(mode, n, s, p_cnt, t, ptr, row0,
                                     no_launch):
    nodes = n - row0
    rows = nodes * s // 128
    fail_ids = (3, 5, 7, row0 + 2)
    want_hist = mode in ("hist", "hist_agg")
    want_agg = mode != "hist"
    rng = np.random.default_rng(n + t + ptr + s)
    view = _packed(rng, n, 0.7, (rows, 128))
    # A sprinkle of self entries (never a probe target) and time stamps
    # after t (negative ages clamp into bucket 0).
    self_pack = _rep((np.arange(nodes) + row0 + 1).astype(np.uint32), s)
    view = np.where(rng.random(view.shape) < 0.05, self_pack, view)
    view_ts = rng.integers(0, t + 3, size=view.shape, dtype=np.int32)
    act = rng.random(nodes) < 0.9
    rm = np.where(rng.random(view.shape) < 0.1,
                  rng.choice(np.asarray(fail_ids + (0, 1, 2, 4, 6)),
                             size=view.shape), -1).astype(np.int32)
    fails = fail_ids if want_agg and mode != "agg_nofail" else ()
    want = jax_probe.probe_folded_window_fused(
        n, s, p_cnt, TFAIL, fails, want_hist, want_agg, True,
        jnp.asarray(t, jnp.int32), jnp.asarray(ptr, jnp.int32),
        jnp.asarray(row0, jnp.int32), view,
        view_ts if want_hist else None, _rep(act, s),
        rm if want_agg else None)
    # The JAX kernel's whole rolled plane and per-slot det_any, as the
    # folded step consumes them: each node's first P positions, and any
    # over each node's slots.
    want = dict(want, ids=np.asarray(want["ids"]).reshape(-1, s)[:, :p_cnt])
    if "det_any" in want:
        want["det_any"] = (np.asarray(want["det_any"]) != 0).reshape(
            -1, s).any(1)
    if mode == "partials":
        got = folded_agg_partials(torch.from_numpy(rm), fails, s)
        want.pop("ids")
        results = [("folded_agg_partials", got)]
    else:
        results = [(fn.__name__, fn(
            n, s, p_cnt, TFAIL, fails, want_hist, want_agg, t, ptr, row0,
            _bits(view), torch.from_numpy(view_ts) if want_hist else None,
            torch.from_numpy(act), torch.from_numpy(rm) if want_agg else None))
            for fn in (probe_folded_plain, probe_folded_window_fused)]
    for name, got in results:
        assert set(got) == set(want), name
        for key in ("ids", "stale_rows", "susp_rows", "rm_cnt", "det_any"):
            if key in want:
                _eq(got[key], want[key], f"{name}: {key}")
        if want_agg:
            assert len(got["det_cols"]) == len(fails)
            for g, w in zip(got["det_cols"], want["det_cols"]):
                _eq(g, w, f"{name}: det_cols")
    if mode != "partials":
        assert (want["ids"] > 0).any()
    if fails:
        assert want["det_any"].any() and not want["det_any"].all()


def test_probe_folded_wrapper_checks_arguments():
    rows, s = 8, 16
    view = torch.zeros((rows, 128), dtype=torch.int32)
    act = torch.zeros((rows * 8,), dtype=torch.bool)
    with pytest.raises(ValueError, match="ptr"):
        probe_folded_window_fused(64, s, 2, TFAIL, (), False, False, 5, s, 0,
                                  view, None, act, None)
    with pytest.raises(ValueError, match="act"):
        probe_folded_window_fused(64, s, 2, TFAIL, (), False, False, 5, 0, 0,
                                  view, None, act[:8], None)


# ---------------------------------------------------------------------------
# The folded rolls


@pytest.mark.parametrize("s", [16, 32, 64])
def test_rolls_match_jax(s):
    f = 128 // s
    n = 16 * f
    rng = np.random.default_rng(s)
    x = _packed(rng, n, 0.8, (n * s // 128, 128))
    for r in (0, 1, n - 1, int(rng.integers(1, n))):
        _eq(roll_nodes(_bits(x), r, f, s),
            jax_fold.roll_nodes(jnp.asarray(x), jnp.asarray(r, jnp.int32),
                                f, s), f"roll_nodes r={r}")
        _eq(roll_nodes(_bits(x), torch.tensor(r, dtype=torch.int32), f, s),
            jax_fold.roll_nodes(jnp.asarray(x), jnp.asarray(r, jnp.int32),
                                f, s), f"roll_nodes r={r} (device scalar)")
    for c in (0, 1, s - 1, int(rng.integers(1, s))):
        _eq(roll_slots(_bits(x), c, s),
            jax_fold.roll_slots(jnp.asarray(x), jnp.asarray(c, jnp.int32), s),
            f"roll_slots c={c}")


# ---------------------------------------------------------------------------
# The folded step


_FOLD = ("MAX_NNB: {n}\nSINGLE_FAILURE: 1\nVIEW_SIZE: {s}\nGOSSIP_LEN: {g}\n"
         "PROBES: {p}\nFANOUT: 3\nTFAIL: 16\nTREMOVE: 40\nTOTAL_TIME: 60\n"
         "FAIL_TIME: 8\nJOIN_MODE: warm\nEXCHANGE: ring\nEVENT_MODE: agg\n"
         "BACKEND: tpu_hash\nFOLDED: 1\n")
CASES = {
    # drop-free, probe counters attributed to the prober (PROBE_IO approx)
    "s16_approx": _FOLD.format(n=256, s=16, g=4, p=2)
    + "DROP_MSG: 0\nMSG_DROP_PROB: 0\nPROBE_IO: approx\n",
    # 5% drops over the run: every coin the folded step reads
    "s16_drops": _FOLD.format(n=256, s=16, g=4, p=2)
    + "DROP_MSG: 1\nMSG_DROP_PROB: 0.05\nDROP_START: 0\nDROP_STOP: 60\n",
    # F=2, FP=4 and (N * STRIDE) % S != 0: two column alignments
    "s64_two_alignments": _FOLD.format(n=260, s=64, g=16, p=32)
    + "DROP_MSG: 0\nMSG_DROP_PROB: 0\n",
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
    assert got.shape == want.shape, f"tick {t}: {name} shape"
    if got.dtype != want.dtype and got.dtype.itemsize == want.dtype.itemsize:
        got = got.view(want.dtype)
    bad = np.argwhere(got != want)
    if bad.size:
        i = tuple(bad[0])
        pytest.fail(f"tick {t}: first divergence in {name} at index {i}: "
                    f"port {got[i]} != jax {want[i]} "
                    f"({len(bad)} elements differ)")


def _port_setup(conf: str):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pp = Params.from_text(conf)
    plan = failures.make_plan(pp, random.Random(f"app:{SEED}"))
    cfg = tpu_hash.make_config(pp, False,
                               fail_ids=tpu_hash.plan_fail_ids(plan),
                               device="cpu")
    return pp, plan, cfg


@pytest.mark.parametrize("case", list(CASES))
def test_folded_step_matches_jax_every_tick(case):
    conf = CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = JaxParams.from_text(conf + "FUSED_RECEIVE: 0\nFUSED_GOSSIP: 0\n"
                                 "FUSED_PROBE: 0\n")
    jplan = jax_failures.make_plan(jp, random.Random(f"app:{SEED}"))
    jcfg = jax_hash.make_config(jp, False,
                                fail_ids=jax_hash.plan_fail_ids(jplan))
    pp, pplan, pcfg = _port_setup(conf)
    assert jcfg.folded and pcfg.folded
    assert (pplan.failed_indices, pplan.fail_time) == (
        jplan.failed_indices, jplan.fail_time)
    assert pcfg.count_probe_io == jcfg.count_probe_io
    jstep = jax.jit(jax_fold.make_folded_step(jcfg))
    inputs = jax_failures.plan_tensors(jp, jplan, SEED, TICKS)
    jstate = jax_fold.init_state_warm_folded(
        jcfg, jax_failures.make_run_key(jp, SEED ^ 0x5EED))
    # The port's own folded warm start equals the JAX one.
    step, init = tpu_hash.step_and_init(pcfg)
    own = state_to_numpy(init(pcfg, failures.make_run_key(
        pp, SEED ^ 0x5EED), "cpu"))
    want = _jax_leaves(jstate)
    assert set(own) == set(want)
    for name in want:
        _first_mismatch(-1, name, own[name], want[name])
    # One start state for both, carried across by convert.py.
    pstate = state_from_numpy(want, device="cpu")
    plan_t = failures.plan_tensors(pp, pplan, SEED, TICKS, "cpu")
    for t in range(TICKS):
        jstate, jout = jstep(jstate, (inputs[0][t], inputs[1][t])
                             + tuple(inputs[2:]))
        pstate, pout = step(pstate, t, plan_t.tick_key(t), plan_t)
        want = _jax_leaves(jstate)
        got = state_to_numpy(pstate)
        for name in sorted(want):
            _first_mismatch(t, name, got[name], want[name])
        for name in pout._fields:
            _first_mismatch(t, f"events.{name}", getattr(pout, name),
                            getattr(jout, name))
    # The run exercised the failure path: the crashed node was detected.
    assert int(pstate.agg.det_count.sum()) > 0


def test_folded_step_equals_natural_step():
    """The fold is a layout, not a protocol: the port's folded and natural
    steps give the same state (reshaped) and events every tick."""
    conf = CASES["s16_drops"]
    pp, plan, fcfg = _port_setup(conf)
    _, _, ncfg = _port_setup(conf.replace("FOLDED: 1", "FOLDED: 0"))
    assert fcfg.folded and not ncfg.folded
    key = failures.make_run_key(pp, SEED ^ 0x5EED)
    plan_t = failures.plan_tensors(pp, plan, SEED, TICKS, "cpu")
    fstep, finit = tpu_hash.step_and_init(fcfg)
    nstep, ninit = tpu_hash.step_and_init(ncfg)
    fstate, nstate = finit(fcfg, key, "cpu"), ninit(ncfg, key, "cpu")
    for t in range(TICKS):
        fstate, fout = fstep(fstate, t, plan_t.tick_key(t), plan_t)
        nstate, nout = nstep(nstate, t, plan_t.tick_key(t), plan_t)
        want = state_to_numpy(nstate)
        got = state_to_numpy(fstate)
        for name in sorted(want):
            _first_mismatch(t, name, got[name].reshape(want[name].shape),
                            want[name])
        for name in nout._fields:
            _first_mismatch(t, f"events.{name}", getattr(fout, name),
                            getattr(nout, name))
    assert int(fstate.agg.rm_total) > 0


def test_folded_run_on_cpu_matches_jax(tmp_path):
    """``run_conf`` on ``--device cpu`` runs a folded conf, with the JAX
    package's detection summary."""
    conf = tmp_path / "folded.conf"
    conf.write_text(_FOLD.format(n=1024, s=16, g=4, p=2).replace(
        "TOTAL_TIME: 60", "TOTAL_TIME: 100") + "DROP_MSG: 0\n")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_app.run_conf(str(conf), seed=1,
                                out_dir=str(tmp_path / "jax"))
        got = application.run_conf(str(conf), seed=1,
                                   out_dir=str(tmp_path / "port"),
                                   device="cpu")
    summary = got.extra["detection_summary"]
    assert summary == want.extra["detection_summary"]
    assert summary["detections_total"] > 0 and summary["false_removals"] == 0
    assert got.extra["final_state"].view.shape == (128, 128)
