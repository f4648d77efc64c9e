"""Ring geometries off the TPU's tiling: the port's natural ring steps and
the plain versions of K1, K2 and K4 at ragged shapes, against the JAX
package, bit for bit.

On the card K1-K4 take rows of any width (S % 128 != 0, S % 4 != 0,
VIEW_SIZE 0 at any N) and shards of any size (L * S % 4 != 0); there
the kernels are held against these plain versions (``chip_smoke.py``
phase ``ragged``, ``tests/test_torch_cuda.py``).  Here, on the CPU:

* the ``tpu_hash`` ring step per tick against the JAX step, every leaf
  and event output, at S = 10 and S = 50 with 5% drops and full events,
  and at VIEW_SIZE 0 with N = 130 (S = 130);
* the ``tpu_hash_sharded`` ring step per tick on eight shards of L = 33
  rows at S = 10 against the JAX sharded step on eight CPU devices;
* K1's plain version against the JAX ``receive_core`` (the jnp step's
  receive), K2's against the JAX step's ``deliver_shift`` loop and K4's
  against the JAX sharded step's per-shift tail, at ragged S.

Outputs are integers: tolerance 0.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from distributed_membership_tpu.backends import tpu_hash_sharded as jax_sh
from distributed_membership_tpu.observability.aggregates import merge_agg
from distributed_membership_tpu.ops import fused_receive as jax_receive
from distributed_membership_tpu.runtime import failures as jax_failures
from distributed_membership_tpu_torch.backends import tpu_hash_sharded as sh
from distributed_membership_tpu_torch.convert import state_from_numpy
from distributed_membership_tpu_torch.ops.fused_gossip import (
    gossip_fused, gossip_fused_stacked, gossip_plain, gossip_stacked_plain)
from distributed_membership_tpu_torch.ops.fused_receive import (
    receive_core, receive_fused)
from distributed_membership_tpu_torch.ops.view_merge import STRIDE
from distributed_membership_tpu_torch.runtime import failures
from test_torch_ring_options import _conf, run_both
from test_torch_sharded import (
    SEED, _BASE as SHARDED_BASE, _DROPS, _first_mismatch, _jax_leaves,
    _port_leaves, _setup as sharded_setup)
from test_torch_wide_rows import (
    K_MAX, _bits, _eq, _i32, _k2_reference, _k4_reference, _packed,
    no_launch)  # noqa: F401 (fixture)

TFAIL, TREMOVE = 16, 40

# name: conf.  S % 4 = 2 at S = 10, 50 and 130; at S = 10 and 50 N *
# STRIDE % S != 0, so the wrapped receivers take the second column
# alignment.
STEP_CASES = {
    "s10_drops": _conf(n=297, s=10, g=4, p=2, total=48, drop=0.05),
    "s50_drops": _conf(n=251, s=50, g=12, p=10, total=48, drop=0.05),
    "full_view_130": _conf(n=130, s=0, g=0, p=16, total=48),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_natural_step_matches_jax_every_tick(case):
    pcfg, pstate = run_both(STEP_CASES[case])
    assert not pcfg.folded and pcfg.s % 4 != 0
    assert ((pcfg.n * STRIDE) % pcfg.s != 0) == (pcfg.s != pcfg.n)
    assert pstate.view.shape == (pcfg.n, pcfg.s)


def test_sharded_step_on_ragged_shards_matches_jax_every_tick():
    """Eight shards of L = 33 rows at S = 10 (L * S % 4 = 2: every shard
    but the first starts off a 16-byte bound), 5% drops, full events."""
    conf = (SHARDED_BASE.format(n=264, tremove=TREMOVE, mesh=8)
            .replace("VIEW_SIZE: 128", "VIEW_SIZE: 10")
            .replace("GOSSIP_LEN: 32", "GOSSIP_LEN: 4")
            .replace("PROBES: 16", "PROBES: 2")
            .replace("TOTAL_TIME: 60", "TOTAL_TIME: 48") + _DROPS)
    ticks = 48
    jp, pp, jplan, pplan, jcfg, pcfg, jmesh, mesh, n_local = \
        sharded_setup(conf)
    assert (n_local, pcfg.s, pcfg.folded) == (33, 10, False)
    init = jax_sh._get_init_runner(jcfg, n_local, jmesh, True)
    seg = jax_sh._get_segment_runner(jcfg, n_local, jmesh, True)
    inputs = jax_failures.plan_tensors(jp, jplan, SEED, ticks)
    jstate = init(jax_failures.make_run_key(jp, SEED ^ 0x5EED))
    pstate = state_from_numpy(_jax_leaves(jstate), device="cpu")
    pplan_t = failures.plan_tensors(pp, pplan, SEED, ticks, "cpu")
    pstep = sh.make_ring_sharded_step(pcfg, mesh)
    acc, removals = None, 0
    for t in range(ticks):
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
        removals += int((np.asarray(jev.rm_ids) >= 0).sum())
    assert removals > 0


def _receive_inputs(rng, n, s, t):
    view = _packed(rng, n, 0.7, (n, s))
    view_ts = rng.integers(0, t + 1, size=(n, s), dtype=np.int32)
    mail = _packed(rng, n, 0.4, (n, s))
    bump = np.where(view > 0, view.astype(np.int64) + n * rng.integers(
        -2, 3, size=(n, s)), 0)
    bump = np.where((bump > 0) & (bump < 2**32), bump, 0).astype(np.uint32)
    cand = np.where(rng.random((n, s)) < 0.3, bump, 0).astype(np.uint32)
    recv = rng.random(n) < 0.9
    act = rng.random(n) < 0.9
    self_on = act & (rng.random(n) < 0.95)
    own_hb = rng.integers(1, 2 * t + 3, size=n)
    self_pack = np.where(self_on, own_hb * n + np.arange(n) + 1,
                         0).astype(np.uint32)
    return view, view_ts, mail, cand, recv, act, self_on, self_pack


@pytest.mark.parametrize("n,s", [(37, 1), (300, 10), (81, 50), (130, 130)])
def test_receive_plain_matches_jax_at_ragged_s(n, s, no_launch):
    """K1's plain version (and the wrapper on CPU tensors) against the
    JAX step's jnp receive, at row widths off every 4- and 128-slot
    bound; the self slot of every row is hit."""
    t = 50
    rng = np.random.default_rng(n * 1000 + s)
    ins = _receive_inputs(rng, n, s, t)
    want = jax_receive.receive_core(
        n, s, TFAIL, TREMOVE, STRIDE, jnp.asarray(t, jnp.int32), *ins,
        jnp.arange(n, dtype=jnp.int32))
    view, view_ts, mail, cand, recv, act, self_on, spack = ins
    args = (_bits(view), torch.from_numpy(view_ts), _bits(mail),
            _bits(cand), torch.from_numpy(recv), torch.from_numpy(act),
            torch.from_numpy(self_on), _bits(spack))
    names = ("view", "view_ts", "mail", "join", "rm_ids", "numfailed",
             "size")
    for fn in (receive_core, receive_fused):
        got = fn(n, s, TFAIL, TREMOVE, STRIDE, t, *(a.clone() for a in args))
        for name, g, w in zip(names, got, want):
            w = np.asarray(w)
            g = g.numpy()
            if w.dtype == np.uint32:
                g = g.view(np.uint32)
            np.testing.assert_array_equal(g, w, err_msg=f"{fn.__name__} "
                                          f"{name} at {n}x{s}")
    # Joins and removals happened (but at S = 1: the self slot alone).
    assert np.asarray(want[3]).any() == (s > 1)
    assert (np.asarray(want[4]) >= 0).any() == (s > 1)


@pytest.mark.parametrize("n,s", [(301, 10), (81, 50), (130, 130)])
@pytest.mark.parametrize("form", ["k_eff", "masks"])
def test_gossip_plain_matches_jax_at_ragged_s(form, n, s, no_launch):
    """K2's plain version against the JAX step's delivery at ragged S,
    both column alignments (N * STRIDE % S != 0) but on the full view
    (N = S)."""
    assert ((n * STRIDE) % s != 0) == (n != s)
    rng = np.random.default_rng(n * s + len(form))
    mail = _packed(rng, n, 0.5, (n, s))
    view = _packed(rng, n, 0.8, (n, s))
    k_eff = rng.integers(0, K_MAX + 1, size=n, dtype=np.int32)
    shifts = np.array([1, n - 1, n // 3 + 1], np.int32)
    if form == "masks":
        masks = rng.random((K_MAX, n, s)) < 0.7
        payload = view
    else:
        masks = None
        payload = np.where(rng.random((n, s)) < 0.3, view,
                           0).astype(np.uint32)
    want = _k2_reference(n, s, mail, payload, k_eff, shifts, masks)
    mt = None if masks is None else torch.from_numpy(masks)
    for fn in (gossip_plain, gossip_fused):
        got = fn(n, s, K_MAX, _bits(mail), _bits(payload),
                 torch.from_numpy(k_eff), torch.from_numpy(shifts), mt)
        _eq(got, want, f"{fn.__name__} {form} {n}x{s}")
    assert not np.array_equal(np.asarray(want), mail)


@pytest.mark.parametrize("d,n_local,s", [(8, 33, 10), (3, 21, 50)])
@pytest.mark.parametrize("form", ["stacked", "stacked_masks"])
def test_stacked_plain_matches_jax_on_ragged_shards(form, d, n_local, s,
                                                    no_launch):
    """K4's plain version against the JAX sharded step's per-shift tail
    on shards whose ends fall off 16-byte bounds (L * S % 4 != 0)."""
    assert (n_local * s) % 4 != 0
    rng = np.random.default_rng(d * n_local * s + len(form))
    rows = d * n_local
    mail = _packed(rng, rows, 0.5, (rows, s))
    c = np.array([n_local - 1, 0, n_local // 3], np.int32)
    s1 = rng.integers(0, s, size=(d, K_MAX)).astype(np.int32)
    s2 = rng.integers(0, s, size=(d, K_MAX)).astype(np.int32)
    if form == "stacked_masks":
        payloads = _packed(rng, rows, 0.8, (1, rows, s))
        masks = rng.random((K_MAX, rows, s)) < 0.7
    else:
        payloads = _packed(rng, rows, 0.3, (K_MAX, rows, s))
        masks = None
    want = _k4_reference(n_local, s, mail, payloads, c, s1, s2, masks)
    mt = None if masks is None else torch.from_numpy(masks)
    for fn in (gossip_stacked_plain, gossip_fused_stacked):
        got = fn(n_local, s, K_MAX, False, _bits(mail), _bits(payloads),
                 _i32(c), _i32(s1), _i32(s2), mt)
        _eq(got, want, f"{fn.__name__} {form} {d}x{n_local}x{s}")
    assert not np.array_equal(np.asarray(want), mail)
