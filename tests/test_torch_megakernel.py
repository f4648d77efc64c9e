"""The port's T-tick blocks and shrunk carry (ops/megakernel.py,
``MEGA_TICKS``/``MEGA_PACK``) and ``RNG_MODE: hoisted`` against the JAX
package's, on the CPU with tolerance 0.

* codec: the packed words equal the JAX ``make_codec``'s on the final
  states of all four ring steps and on edge-case planes (odd last
  dimensions, the -1 sentinel, the top of the 16-bit range); round trips
  are exact; ``pack_fits``, ``fits16`` and ``carry_bytes`` agree;
* the block loop equals the plain loop for T that tiles, does not tile,
  equals and exceeds the segment;
* ``MEGA_TICKS`` 3, 4, 7 and 8, packed and wide, equal the per-tick run
  on all four ring steps under drops with the hist recorder, and a
  blocked run killed inside a block resumes to the per-tick run;
* the static widening of the packed carry and its refusals;
* hoisting: a segment's RNG plans drawn at once equal the per-tick
  plans, and hoisted runs equal batched runs, natural and folded, with
  drops.
"""

import os
import random
import warnings
from typing import NamedTuple

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from distributed_membership_tpu.backends import get_backend as jax_backend
from distributed_membership_tpu.backends.tpu_hash import (
    make_config as jax_make_config, resolve_mega_pack as jax_resolve)
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.ops import megakernel as jax_mk
from distributed_membership_tpu_torch.backends import get_backend
from distributed_membership_tpu_torch.backends import tpu_hash
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.convert import carry_leaves
from distributed_membership_tpu_torch.ops import megakernel as mk
from distributed_membership_tpu_torch.runtime import checkpoint as ck
from distributed_membership_tpu_torch.runtime.failures import (
    plan_tensors, resolve_plan)

SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several test processes
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The four ring steps at a small size

_CONF = (
    "MAX_NNB: {n}\nSINGLE_FAILURE: 1\nDROP_MSG: 1\nMSG_DROP_PROB: 0.1\n"
    "DROP_START: 10\nDROP_STOP: 50\nGOSSIP_LEN: {g}\nPROBES: {p}\n"
    "FANOUT: 3\nTFAIL: 16\nTREMOVE: 64\nTOTAL_TIME: 60\nFAIL_TIME: 30\n"
    "VIEW_SIZE: {s}\nJOIN_MODE: warm\nEVENT_MODE: agg\nEXCHANGE: ring\n"
    "TELEMETRY: hist\n")
STEPS = {
    "natural": (256, "BACKEND: tpu_hash\n"),
    "folded": (256, "BACKEND: tpu_hash\nFOLDED: 1\n"),
    "sharded": (256, "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8\n"),
    "sharded_folded": (512, "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8\n"
                            "FOLDED: 1\n"),
}


def _conf(step: str, extra: str = "") -> str:
    n, tail = STEPS[step]
    folded = "FOLDED" in tail
    return _CONF.format(n=n, s=16 if folded else 128, g=8 if folded else 16,
                        p=2 if folded else 16) + tail + extra


def _backend(text):
    return Params.from_text(text).BACKEND


def _port(text):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return get_backend(_backend(text))(Params.from_text(text), seed=SEED,
                                           device="cpu")


_REF: dict = {}


def _per_tick(step):
    """The port's unchunked run of ``step`` (cached)."""
    if step not in _REF:
        _REF[step] = _port(_conf(step))
    return _REF[step]


def _same_run(r0, r1):
    assert (r1.extra["detection_summary"]
            == r0.extra["detection_summary"])
    np.testing.assert_array_equal(r1.sent, r0.sent)
    np.testing.assert_array_equal(r1.recv, r0.recv)
    for a, b in zip(carry_leaves(r0.extra["final_state"]),
                    carry_leaves(r1.extra["final_state"])):
        np.testing.assert_array_equal(b, a)
    tl0, tl1 = r0.extra["timeline"], r1.extra["timeline"]
    assert set(tl0) == set(tl1)
    for k in tl0:
        np.testing.assert_array_equal(np.asarray(tl1[k]),
                                      np.asarray(tl0[k]), err_msg=k)


# ---------------------------------------------------------------------------
# The codec

@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("pack16", [True, False], ids=["packed", "wide"])
def test_codec_words_match_jax(step, pack16):
    """The packed words of each ring step's final state equal the JAX
    codec's words of the JAX package's final state of the same run, and
    the round trip gives the state back; carry_bytes agrees."""
    r = _per_tick(step)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        text = _conf(step)
        jr = jax_backend(_backend(text))(JaxParams.from_text(text),
                                         seed=SEED)
    st, jst = r.extra["final_state"], jr.extra["final_state"]
    pack, unpack = mk.make_codec(st, pack16)
    jpack, _ = jax_mk.make_codec(jst, pack16)
    got, want = pack(st), jpack(jst)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, i
        assert g.numpy().tobytes() == w.tobytes(), i
    for a, b in zip(carry_leaves(st), carry_leaves(unpack(got))):
        np.testing.assert_array_equal(b, a)
    assert mk.carry_bytes(st, pack16) == jax_mk.carry_bytes(jst, pack16)


class _State(NamedTuple):
    """A state with the field names the codec keys on."""
    view: object
    view_ts: object
    started: object
    self_hb: object
    mail: object


@pytest.mark.parametrize("shape_ts,n", [((6, 16), 6), ((4, 128), 7),
                                        ((5, 7), 9), ((3,), 33)],
                         ids=["natural", "folded", "odd_pairs", "flat"])
def test_codec_edges_match_jax(shape_ts, n):
    """Timestamps from the -1 sentinel to the top of the 16-bit lanes,
    odd last dimensions and bool planes of any length: the words equal
    the JAX codec's, and the round trip is exact, packed and wide."""
    rng = np.random.default_rng(sum(shape_ts) + n)
    arrs = dict(
        view=rng.integers(0, 1 << 32, shape_ts, dtype=np.uint64)
        .astype(np.uint32),
        view_ts=rng.integers(-1, (1 << 16) - 1, shape_ts).astype(np.int32),
        started=rng.random(n) < 0.5,
        self_hb=rng.integers(-1, 2 * mk.PACK_SAFE_TICKS, n).astype(np.int32),
        mail=rng.integers(0, 1 << 32, shape_ts, dtype=np.uint64)
        .astype(np.uint32))
    arrs["view_ts"].reshape(-1)[:2] = [-1, (1 << 16) - 2]
    jst = _State(**{k: jnp.asarray(v) for k, v in arrs.items()})
    st = _State(**{k: torch.from_numpy(v.view(np.int32) if v.dtype
                                       == np.uint32 else v.copy())
                   for k, v in arrs.items()})
    for pack16 in (True, False):
        pack, unpack = mk.make_codec(st, pack16)
        jpack, _ = jax_mk.make_codec(jst, pack16)
        got = pack(st)
        for g, w in zip(got, jpack(jst)):
            w = np.asarray(w)
            g = g.numpy()
            assert g.shape == w.shape
            assert g.tobytes() == w.tobytes()
        back = unpack(got)
        for f in _State._fields:
            a, b = getattr(st, f), getattr(back, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f
        assert mk.carry_bytes(st, pack16) == jax_mk.carry_bytes(jst, pack16)


def test_pack_bounds_and_fits16_match_jax():
    for total in (-1, 0, 700, mk.PACK_SAFE_TICKS, mk.PACK_SAFE_TICKS + 1):
        assert mk.pack_fits(total) == jax_mk.pack_fits(total)
    assert mk.PACK_SAFE_TICKS == jax_mk.PACK_SAFE_TICKS
    for vals in ([-1, 0, (1 << 16) - 2], [(1 << 16) - 1], [-2], [5, 40000]):
        assert mk.fits16(vals) == jax_mk.fits16(vals)


# ---------------------------------------------------------------------------
# The block loop

@pytest.mark.parametrize("t", [1, 3, 4, 7, 20, 40])
@pytest.mark.parametrize("pack16", [False, True])
def test_mega_ticks_equals_plain_loop(t, pack16):
    """T tiles the 20 ticks (4), does not (3, 7), is 1, equals and
    exceeds them: the state and the per-tick outputs equal the plain
    loop's."""
    rng = np.random.default_rng(t)
    st0 = _State(
        view=torch.from_numpy(rng.integers(0, 1 << 30, (4, 6))
                              .astype(np.int32)),
        view_ts=torch.from_numpy(rng.integers(-1, 100, (4, 6))
                                 .astype(np.int32)),
        started=torch.from_numpy(rng.random(5) < 0.5),
        self_hb=torch.from_numpy(rng.integers(-1, 50, 5).astype(np.int32)),
        mail=torch.zeros((4, 6), dtype=torch.int32))
    bumps = rng.integers(0, 2, 20)

    def run(loop):
        outs = []

        def tick(s, ti):
            s = s._replace(
                view_ts=torch.where(s.view % 3 == 0, ti, s.view_ts),
                self_hb=s.self_hb + 2,
                started=s.started ^ bool(bumps[ti - 5]),
                mail=s.mail + int(bumps[ti - 5]))
            outs.append((int(s.self_hb.sum()), bool(s.started.any())))
            return s
        return loop(tick), outs

    ref, ref_out = run(lambda tick: _plain(tick, st0, 5, 25))
    got, got_out = run(lambda tick: mk.mega_ticks(tick, st0, 5, 25, t,
                                                  pack16))
    assert got_out == ref_out
    for f in _State._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def _plain(tick, st, a, b):
    for t in range(a, b):
        st = tick(st, t)
    return st


# ---------------------------------------------------------------------------
# Whole runs

@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("t", [3, 4, 7, 8])
def test_mega_run_equals_per_tick(step, t):
    """MEGA_TICKS T with segments of 3T over 60 ticks (a tail segment
    with a partial block), packed and wide: the trajectory, summary,
    counts and every series equal the per-tick run's."""
    ref = _per_tick(step)
    for pack in (1, 0):
        _same_run(ref, _port(_conf(step, f"CHECKPOINT_EVERY: {3 * t}\n"
                                         f"MEGA_TICKS: {t}\n"
                                         f"MEGA_PACK: {pack}\n")))


@pytest.mark.parametrize("kill", [50, 80], ids=["inside_block",
                                               "on_boundary"])
def test_mega_kill_resume(kill, tmp_path, monkeypatch):
    """A MEGA_TICKS 8 run of the natural step with 40-tick segments over
    120 ticks, killed inside a block (50) and on a boundary (80), resumes
    to the per-tick run (the series read back from one TELEMETRY_DIR),
    and its snapshot is the full-width carry."""
    base = _conf("natural").replace("TOTAL_TIME: 60", "TOTAL_TIME: 120")
    ref = _port(base)
    keys = (f"CHECKPOINT_EVERY: 40\nCHECKPOINT_DIR: {tmp_path}\n"
            f"TELEMETRY_DIR: {tmp_path / 'tl'}\nMEGA_TICKS: 8\n"
            "MEGA_PACK: 1\n")
    monkeypatch.setenv(ck.CRASH_ENV, str(kill))
    with pytest.raises(RuntimeError, match="injected crash"):
        _port(base + keys)
    assert ck.manifest_tick(str(tmp_path)) == 80
    monkeypatch.delenv(ck.CRASH_ENV)
    r = _port(base + keys + "RESUME: 1\n")
    _same_run(ref, r)
    with np.load(tmp_path / "ckpt_00000120.npz") as data:
        assert data["c1"].shape == (256, 128)       # view_ts, full width


def test_static_widening_matches_jax():
    """Auto packs within PACK_SAFE_TICKS and widens past it, at
    make_config and for a longer effective run; a pinned pack raises the
    JAX package's message."""
    ring = _conf("natural").replace("TOTAL_TIME: 60", "TOTAL_TIME: {total}")
    ring += "CHECKPOINT_EVERY: 40\nMEGA_TICKS: 8\n"

    def cfgs(text):
        p, jp = Params.from_text(text), JaxParams.from_text(text)
        return (p, tpu_hash.make_config(p, False),
                jp, jax_make_config(jp, False))

    p, cfg, jp, jcfg = cfgs(ring.format(total=100))
    assert (cfg.mega_ticks, cfg.mega_pack) == (8, True)
    assert (jcfg.mega_ticks, jcfg.mega_pack) == (8, True)
    _, cfg_long, _, jcfg_long = cfgs(ring.format(
        total=mk.PACK_SAFE_TICKS + 1))
    assert cfg_long.mega_pack is False and jcfg_long.mega_pack is False
    assert tpu_hash.resolve_mega_pack(cfg, p, 100) is cfg
    wide = tpu_hash.resolve_mega_pack(cfg, p, mk.PACK_SAFE_TICKS + 1)
    assert (wide.mega_pack, wide.mega_ticks) == (False, 8)
    pinned = ring.format(total=100) + "MEGA_PACK: 1\n"
    p, cfg, jp, jcfg = cfgs(pinned)
    errs = []
    for resolve, c, params in ((tpu_hash.resolve_mega_pack, cfg, p),
                               (jax_resolve, jcfg, jp)):
        with pytest.raises(ValueError, match="effective run length") as e:
            resolve(c, params, mk.PACK_SAFE_TICKS + 1)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# RNG_MODE hoisted

@pytest.mark.parametrize("folded", [False, True], ids=["natural", "folded"])
def test_hoisted_plans_equal_per_tick_plans(folded):
    """The K plans of a segment drawn at once (one pass per stream) equal
    K per-tick plans, every stream, drops on."""
    step = "folded" if folded else "natural"
    params = Params.from_text(_conf(step, "CHECKPOINT_EVERY: 6\n"
                                          "RNG_MODE: hoisted\n"))
    plan = resolve_plan(params, random.Random(f"app:{SEED}"))
    cfg = tpu_hash.make_config(params, False,
                               fail_ids=tpu_hash.plan_fail_ids(plan))
    assert cfg.rng_mode == "hoisted" and cfg.folded == folded
    plan_t = plan_tensors(params, plan, SEED, 60, "cpu")
    keys = [plan_t.tick_key(t) for t in range(17, 23)]
    many = tpu_hash.ring_rng_plans(cfg, keys, "cpu")
    assert len(many) == 6
    for key, got in zip(keys, many):
        want = tpu_hash.ring_rng_plans(cfg, [key], "cpu")[0]
        assert len(got.gossip_u) == len(want.gossip_u) == 3
        for f in want._fields:
            a, b = getattr(want, f), getattr(got, f)
            for x, y in (zip(a, b) if f == "gossip_u" else [(a, b)]):
                assert torch.equal(x, y), f
        assert got.probe_u.numel() == 256 * cfg.probes
        assert (got.ctrl_u.numel() > 0) == (not folded)


@pytest.mark.parametrize("step", ["natural", "folded"])
def test_hoisted_run_equals_batched(step):
    """RNG_MODE hoisted with 12-tick segments equals the batched per-tick
    run, drops on; with MEGA_TICKS 4 too."""
    ref = _per_tick(step)
    _same_run(ref, _port(_conf(step, "CHECKPOINT_EVERY: 12\n"
                                     "RNG_MODE: hoisted\n")))
    _same_run(ref, _port(_conf(step, "CHECKPOINT_EVERY: 12\n"
                                     "RNG_MODE: hoisted\nMEGA_TICKS: 4\n")))
    assert os.environ.get(ck.CRASH_ENV) is None
