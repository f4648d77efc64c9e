"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU and skips where
``torch.cuda.is_available()`` is false.  This file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX).  Outputs
are integers and must be equal, bit for bit.
"""

import pathlib

import numpy as np
import pytest
import torch

from distributed_membership_tpu_torch import kernels
from distributed_membership_tpu_torch.ops.fused_folded import (
    folded_receive_core, gossip_folded_plain, gossip_folded_stacked,
    receive_folded_fused)
from distributed_membership_tpu_torch.ops.fused_gossip import (
    gossip_fused, gossip_fused_stacked, gossip_plain, gossip_stacked_plain)
from distributed_membership_tpu_torch.ops.fused_probe import (
    probe_folded_plain, probe_folded_window_fused, probe_plain,
    probe_window_fused)
from distributed_membership_tpu_torch.ops.fused_receive import (
    receive_core, receive_fused)
from distributed_membership_tpu_torch.ops.view_merge import STRIDE

S = 128
TFAIL, TREMOVE = 16, 40


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _packed(rng, n, occ, shape):
    """Packed u32 entries over the whole u32 range as int32 bits."""
    ids = rng.integers(0, n, size=shape, dtype=np.int64)
    hbs = rng.integers(0, (2**32 - n) // n, size=shape, dtype=np.int64)
    val = np.where(rng.random(shape) < occ, hbs * n + ids + 1, 0)
    return torch.from_numpy(val.astype(np.uint32).view(np.int32))


def _flags(rng, n, p):
    return torch.from_numpy(rng.random(n) < p)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(4096, 45), (1000, 3)])
def test_receive_kernel(cuda, n, t):
    rng = np.random.default_rng(n + t)
    view = _packed(rng, n, 0.7, (n, S))
    view_ts = torch.from_numpy(
        rng.integers(0, t + 1, size=(n, S), dtype=np.int32))
    mail = _packed(rng, n, 0.4, (n, S))
    cand = torch.where(_flags(rng, n * S, 0.5).reshape(n, S), view,
                       _packed(rng, n, 0.1, (n, S)))
    act = _flags(rng, n, 0.9)
    self_on = act & _flags(rng, n, 0.95)
    spack = _packed(rng, n, 1.0, (n,)) * self_on
    args = [x.to(cuda) for x in (view, view_ts, mail, cand,
                                 _flags(rng, n, 0.9), act, self_on, spack)]
    want = receive_core(n, S, TFAIL, TREMOVE, STRIDE, t, *args)
    kernels.reset_launches()
    got = receive_fused(n, S, TFAIL, TREMOVE, STRIDE, t,
                        *(a.clone() for a in args))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["receive"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(4096, 45), (1000, 3)])
def test_receive_admit_kernel(cuda, n, t):
    """K1's admit_mask form (an int32 [N, S] plane, 0 = suppress the
    delivered mail) against its plain version, and the mask bites."""
    rng = np.random.default_rng(3 * n + t)
    view = _packed(rng, n, 0.7, (n, S))
    view_ts = torch.from_numpy(
        rng.integers(0, t + 1, size=(n, S), dtype=np.int32))
    mail = _packed(rng, n, 0.4, (n, S))
    cand = torch.where(_flags(rng, n * S, 0.5).reshape(n, S), view,
                       _packed(rng, n, 0.1, (n, S)))
    act = _flags(rng, n, 0.9)
    self_on = act & _flags(rng, n, 0.95)
    spack = _packed(rng, n, 1.0, (n,)) * self_on
    args = [x.to(cuda) for x in (view, view_ts, mail, cand,
                                 _flags(rng, n, 0.9), act, self_on, spack)]
    admit = _flags(rng, n * S, 0.5).reshape(n, S).to(torch.int32).to(cuda)
    want = receive_core(n, S, TFAIL, TREMOVE, STRIDE, t, *args,
                        admit_mask=admit)
    kernels.reset_launches()
    got = receive_fused(n, S, TFAIL, TREMOVE, STRIDE, t,
                        *(a.clone() for a in args), admit_mask=admit)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["receive_admit"] == 1
    assert kernels.LAUNCHES["receive"] == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    open_ = receive_fused(n, S, TFAIL, TREMOVE, STRIDE, t,
                          *(a.clone() for a in args))
    assert not torch.equal(open_[0], got[0])


# K2 cases (N, S, shifts; k_max = len(shifts)).  The tile holds 4096 / S
# rows (32 at S=128, 16 at S=256): N=96 takes the wrapped-row columns;
# N=1000 ends on a ragged tile, and shifts that are not multiples of the
# tile height split every tile's senders at the ring's wrap; k_max=8
# wraps the four-stage ring twice per tile; shifts 0 and >= N hold the
# kernel to the plain version outside the ring's [1, N).
GOSSIP_CASES = [
    (4096, 128, [1, 4095, 37]),
    (96, 128, [1, 95, 37]),
    (1000, 128, [1, 999, 37]),
    (1000, 256, [1, 999, 517]),
    (1000, 128, [613]),
    (1000, 128, [1, 999, 37, 0, 500, 31, 33, 1007]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["k_eff", "masks"])
@pytest.mark.parametrize("n,s,shift_list", GOSSIP_CASES)
def test_gossip_kernel(cuda, form, n, s, shift_list):
    k_max = len(shift_list)
    rng = np.random.default_rng(n + s + k_max)
    mail = _packed(rng, n, 0.5, (n, s)).to(cuda)
    view = _packed(rng, n, 0.8, (n, s)).to(cuda)
    k_eff_np = rng.integers(0, k_max + 1, size=n, dtype=np.int32)
    k_eff_np[:4] = [0, k_max, 0, k_max]      # both ends on one tile
    k_eff = torch.from_numpy(k_eff_np).to(cuda)
    masks = (_flags(rng, k_max * n * s, 0.7).reshape(k_max, n, s).to(cuda)
             if form == "masks" else None)
    payload = view if form == "masks" else torch.where(
        _flags(rng, n * s, 0.3).reshape(n, s).to(cuda), view, 0)
    shifts = torch.tensor(shift_list, dtype=torch.int32, device=cuda)
    want = gossip_plain(n, s, k_max, mail, payload, k_eff, shifts, masks)
    kernels.reset_launches()
    got = gossip_fused(n, s, k_max, mail.clone(), payload, k_eff, shifts,
                       masks=masks)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gossip" if form == "k_eff"
                            else "gossip_masks"] == 1
    assert torch.equal(got, want)


# K3 cases (N, S, P, ptr, row0, fail ids, removal plane).  The kernel
# takes 8 rows per warp (1000 and 4097 end on a partial group), reads
# 16-byte runs where S % 4 == 0 (not at S=130), and the window as runs
# where also P % 4 == 0, ptr % 4 == 0 and it does not wrap (ptr 32 and
# 240 do; 13, 120 at S=128 and 254 do not).  Planes: "mixed" (10%
# removals of ids 0-7), "dense" (no -1 at all) and "empty" (all -1,
# where the fail-id compares are skipped); the fail id -1 counts the -1
# entries, as the plain version does.
PROBE_CASES = [
    (4096, 128, 16, 32, 0, (3, 5), "mixed"),
    (4096, 128, 16, 120, 0, (3, 5), "mixed"),
    (1000, 128, 16, 13, 77, (1,), "mixed"),
    (4097, 256, 16, 240, 5000, tuple(range(8)), "dense"),
    (1000, 130, 16, 120, 0, (), "empty"),
    (4097, 128, 5, 32, 3, tuple(range(7, -1, -1)), "dense"),
    (1000, 256, 5, 254, 0, (3,), "empty"),
    (1000, 130, 5, 8, 1, (3, 5), "mixed"),
    (1000, 128, 16, 64, 9, (-1, 2), "mixed"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["agg", "hist", "ids", "both"])
@pytest.mark.parametrize("n,s,p_cnt,ptr,row0,fails,plane", PROBE_CASES)
def test_probe_kernel(cuda, mode, n, s, p_cnt, ptr, row0, fails, plane):
    t = 37
    ring = row0 + n + 3
    rng = np.random.default_rng(n + s + ptr)
    view = _packed(rng, ring, 0.7, (n, s))
    own = torch.arange(row0 + 1, row0 + n + 1, dtype=torch.int32)
    view = torch.where(_flags(rng, n * s, 0.05).reshape(n, s), own[:, None],
                       view).to(cuda)          # a node's own entries
    view_ts = torch.from_numpy(
        rng.integers(0, t + 3, size=(n, s), dtype=np.int32)).to(cuda)
    share = {"mixed": 0.1, "dense": 1.0, "empty": 0.0}[plane]
    rm = torch.from_numpy(np.where(
        rng.random((n, s)) < share, rng.integers(0, 8, size=(n, s)),
        -1).astype(np.int32)).to(cuda)
    act = _flags(rng, n, 0.9).to(cuda)
    hist, agg = mode in ("hist", "both"), mode in ("agg", "both")
    args = (p_cnt, TFAIL, fails if agg else (), hist, agg, t, ptr, row0,
            view, view_ts if hist else None, act, rm if agg else None)
    want = probe_plain(ring, s, *args)
    kernels.reset_launches()
    got = probe_window_fused(ring, s, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["probe_hist" if hist else "probe"] == 1
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_run_on_card_matches_cpu(cuda, tmp_path):
    """A small full-event run writes the same logs on the card (kernels)
    as on the CPU (plain versions), each kernel once per tick."""
    from distributed_membership_tpu_torch.runtime.application import (
        run_conf)

    conf = tmp_path / "ring.conf"
    conf.write_text(
        "MAX_NNB: 256\nSINGLE_FAILURE: 1\nDROP_MSG: 1\nMSG_DROP_PROB: 0.05\n"
        "DROP_START: 20\nDROP_STOP: 60\nVIEW_SIZE: 128\nGOSSIP_LEN: 32\n"
        "PROBES: 16\nFANOUT: 3\nTFAIL: 16\nTREMOVE: 40\nTOTAL_TIME: 80\n"
        "FAIL_TIME: 10\nJOIN_MODE: warm\nEXCHANGE: ring\n"
        "BACKEND: tpu_hash\n")
    kernels.reset_launches()
    run_conf(str(conf), out_dir=str(tmp_path / "cuda"), device="cuda")
    assert kernels.LAUNCHES == {
        "receive": 80, "receive_admit": 0, "gossip": 0, "gossip_masks": 80,
        "probe": 80, "probe_hist": 0, "receive_folded": 0, "gossip_folded": 0,
        "gossip_folded_masks": 0, "probe_folded": 0, "probe_folded_hist": 0,
        "gossip_stacked": 0, "gossip_stacked_masks": 0, "gossip_wide": 0,
        "gossip_wide_masks": 0, "gossip_stacked_wide": 0,
        "gossip_stacked_wide_masks": 0, "philox": 0, "philox_bits": 0,
        "philox_at": 0}
    run_conf(str(conf), out_dir=str(tmp_path / "cpu"), device="cpu")
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        assert ((tmp_path / "cuda" / name).read_bytes()
                == (tmp_path / "cpu" / name).read_bytes()), name


# ---------------------------------------------------------------------------
# The folded kernels K5-K7.  (N, S): 4096 at S=16 (512 plane rows), 4096
# at S=64 (2048 rows), and 260 at S=64, whose 130 rows fill neither a
# whole block of K5/K6 nor of K7; 260 also takes two column alignments.

# Under 8 plane rows too (1, 2 and 4 at S=16), which the JAX package's
# folded kernels do not take and the port's do.
FOLDED_SHAPES = [(4096, 16), (4096, 64), (260, 64), (8, 16), (16, 16),
                 (32, 16)]


def _rows(n, s):
    return n * s // 128


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", FOLDED_SHAPES)
def test_receive_folded_kernel(cuda, n, s):
    t = 45
    rows = _rows(n, s)
    rng = np.random.default_rng(n + s)
    view = _packed(rng, n, 0.7, (rows, 128))
    view_ts = torch.from_numpy(
        rng.integers(0, t + 1, size=(rows, 128), dtype=np.int32))
    mail = _packed(rng, n, 0.4, (rows, 128))
    cand = torch.where(_flags(rng, rows * 128, 0.5).reshape(rows, 128), view,
                       _packed(rng, n, 0.1, (rows, 128)))
    act = _flags(rng, n, 0.9)
    spack = _packed(rng, n, 1.0, (n,)) * act
    args = [x.to(cuda) for x in (view, view_ts, mail, cand,
                                 _flags(rng, n, 0.9), act, spack)]
    want = folded_receive_core(n, s, TFAIL, TREMOVE, STRIDE, t, *args)
    kernels.reset_launches()
    got = receive_folded_fused(n, s, TFAIL, TREMOVE, STRIDE, t,
                               *(a.clone() for a in args))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["receive_folded"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# K6 cases (N, S, node shifts; k_max = len(shifts)) on the tiled body: a
# tile holds 4096 / S nodes, so every N below but 4096 and 260 ends on a
# ragged tile (N = 3 tiles + 5 plane rows); S < 4 widens the payload
# runs and S < 16 the mask runs to 16-byte bounds; k_max 8 wraps the
# four-stage ring twice per tile; shifts 0, -3 and >= N hold the kernel
# to the plain version outside the ring's [1, N).
GOSSIP_FOLDED_CASES = [
    (4096, 16, [1, 4095, 37]),
    (4096, 64, [1, 4095, 37]),
    (260, 64, [1, 259, 37]),
    (12928, 1, [1, 12927, 4099]),
    (6464, 2, [0, 6463, 2048, 3]),
    (3232, 4, [0, 1, 3231, 3232, 3239, 517, 1024, -3]),
    (1616, 8, [1619]),
    (808, 16, [0, 1, 807]),
    (404, 32, [1, 403, 128, 3, 0, 405, 200, 7]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["stacked", "masks"])
@pytest.mark.parametrize("single", [True, False])
@pytest.mark.parametrize("n,s,shift_list", GOSSIP_FOLDED_CASES)
def test_gossip_folded_kernel(cuda, n, s, shift_list, single, form):
    k_max = len(shift_list)
    rows = _rows(n, s)
    rng = np.random.default_rng(n + s + k_max)
    mail = _packed(rng, n, 0.5, (rows, 128)).to(cuda)
    view = _packed(rng, n, 0.8, (rows, 128)).to(cuda)
    thr = torch.tensor(shift_list, dtype=torch.int32, device=cuda)
    c1 = ((thr % s) * (STRIDE % s) % s).to(torch.int32)
    c2 = (((thr - n) % s) * (STRIDE % s) % s).to(torch.int32)
    if form == "masks":
        payloads = view[None]
        masks = _flags(rng, k_max * rows * 128, 0.7).reshape(
            k_max, rows, 128).to(cuda)
    else:
        keep = _flags(rng, k_max * rows * 128, 0.3).reshape(
            k_max, rows, 128).to(cuda)
        payloads = torch.where(keep, view[None], 0)
        masks = None
    want = gossip_folded_plain(rows, s, k_max, single, mail, payloads, thr,
                               c1, c2, masks)
    kernels.reset_launches()
    got = gossip_folded_stacked(rows, s, k_max, single, mail.clone(),
                                payloads, thr, c1, c2, masks)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gossip_folded" if form == "stacked"
                            else "gossip_folded_masks"] == 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["agg", "hist", "hist_agg", "agg_nofail"])
@pytest.mark.parametrize("n,s", FOLDED_SHAPES + [(4096, 2), (4096, 4),
                                                 (4096, 8), (4096, 32)])
def test_probe_folded_kernel(cuda, n, s, mode):
    """K7 == its plain version on every output: windows of P = S/8, S - 1
    (not dividing S, wrapping) and 4 (16-byte runs where ptr % 4 == 0),
    at wrapping and inner ptrs, on a plane at node 0 and on a shard's."""
    t = 37
    rows = _rows(n, s)
    rng = np.random.default_rng(n + s)
    view = _packed(rng, 2 * n, 0.7, (rows, 128)).to(cuda)
    view_ts = torch.from_numpy(
        rng.integers(0, t + 3, size=(rows, 128), dtype=np.int32)).to(cuda)
    rm = torch.from_numpy(np.where(
        rng.random((rows, 128)) < 0.1, rng.integers(0, 8, size=(rows, 128)),
        -1).astype(np.int32)).to(cuda)
    act = _flags(rng, n, 0.9).to(cuda)
    hist, agg = "hist" in mode, mode != "hist"
    fails = (3, 5) if mode in ("agg", "hist_agg") else ()
    key = "probe_folded_hist" if hist else "probe_folded"
    for p_cnt in sorted({max(1, s // 8), s - 1, min(4, s - 1)}):
        for ptr in sorted({s - 1, 3 % s, 4 % s, 0}):
            for row0 in (0, n):
                args = (p_cnt, TFAIL, fails, hist, agg, t, ptr, row0, view,
                        view_ts if hist else None, act, rm if agg else None)
                want = probe_folded_plain(2 * n, s, *args)
                kernels.reset_launches()
                got = probe_folded_window_fused(2 * n, s, *args)
                torch.cuda.synchronize()
                assert kernels.LAUNCHES[key] == 1
                assert set(got) == set(want)
                assert got["ids"].shape == (rows * 128 // s, p_cnt)
                for k in want:
                    if k == "det_cols":
                        assert all(torch.equal(g, w)
                                   for g, w in zip(got[k], want[k]))
                    else:
                        assert torch.equal(got[k], want[k]), (k, p_cnt, ptr,
                                                              row0)


@pytest.mark.cuda
def test_folded_run_on_card_matches_cpu(cuda, tmp_path):
    """A small folded run ends in the same state and detection summary on
    the card (K5-K7) as on the CPU (plain versions), each folded kernel
    once per tick."""
    from distributed_membership_tpu_torch.convert import state_to_numpy
    from distributed_membership_tpu_torch.runtime.application import (
        run_conf)

    conf = tmp_path / "folded.conf"
    conf.write_text(
        "MAX_NNB: 4096\nSINGLE_FAILURE: 1\nDROP_MSG: 1\n"
        "MSG_DROP_PROB: 0.05\nDROP_START: 0\nDROP_STOP: 80\n"
        "VIEW_SIZE: 16\nGOSSIP_LEN: 4\nPROBES: 2\nFANOUT: 3\nTFAIL: 16\n"
        "TREMOVE: 40\nTOTAL_TIME: 80\nFAIL_TIME: 10\nJOIN_MODE: warm\n"
        "EXCHANGE: ring\nEVENT_MODE: agg\nBACKEND: tpu_hash\nFOLDED: 1\n")
    kernels.reset_launches()
    card = run_conf(str(conf), out_dir=str(tmp_path / "cuda"), device="cuda")
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "receive_folded": 80, "gossip_folded": 80, "probe_folded": 80}
    cpu = run_conf(str(conf), out_dir=str(tmp_path / "cpu"), device="cpu")
    assert (card.extra["detection_summary"]
            == cpu.extra["detection_summary"])
    want = state_to_numpy(cpu.extra["final_state"])
    got = state_to_numpy(card.extra["final_state"])
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ---------------------------------------------------------------------------
# K4, the sharded step's stacked gossip.  (D, L, S, k_max): one shard of
# 4096 rows (one column alignment), eight shards of 32 rows and three of
# 200 (two alignments, per-shard shifts; 200 rows end on a ragged tile),
# four shards of 8 rows (the gate's minimum, shorter than one tile), S=256
# (16-row tiles), and k_max 1 and 8 (the stage ring wraps twice per tile).
# The row shifts include 0 and L - 1.  Forms: pre-masked payloads (the
# path), one shared payload with masks, and pre-masked payloads with masks.

STACKED_SHAPES = [(1, 4096, 128, 3), (8, 32, 128, 3), (3, 200, 128, 3),
                  (4, 8, 128, 3), (3, 200, 256, 3), (8, 32, 128, 1),
                  (3, 200, 128, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["stacked", "masks", "stacked_masks"])
@pytest.mark.parametrize("d,n_local,s,k_max", STACKED_SHAPES)
def test_gossip_stacked_kernel(cuda, d, n_local, s, k_max, form):
    n = d * n_local
    single = (n_local * STRIDE) % s == 0
    rng = np.random.default_rng(d * n_local + s + k_max)
    mail = _packed(rng, n, 0.5, (n, s)).to(cuda)
    view = _packed(rng, n, 0.8, (n, s)).to(cuda)
    c = torch.tensor([v % n_local for v in
                      (n_local - 1, 0, n_local // 3, 1, n_local // 2, 5,
                       n_local - 2, 3)[:k_max]],
                     dtype=torch.int32, device=cuda)
    s1, s2 = (torch.from_numpy(rng.integers(0, s, size=(d, k_max),
                                            dtype=np.int32)).to(cuda)
              for _ in range(2))
    keep = _flags(rng, k_max * n * s, 0.3).reshape(k_max, n, s).to(cuda)
    payloads = view[None] if form == "masks" else torch.where(
        keep, view[None], 0)
    masks = (None if form == "stacked" else
             _flags(rng, k_max * n * s, 0.7).reshape(k_max, n, s).to(cuda))
    want = gossip_stacked_plain(n_local, s, k_max, single, mail, payloads,
                                c, s1, s2, masks)
    kernels.reset_launches()
    got = gossip_fused_stacked(n_local, s, k_max, single, mail.clone(),
                               payloads, c, s1, s2, masks)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gossip_stacked" if form == "stacked"
                            else "gossip_stacked_masks"] == 1
    assert torch.equal(got, want)


# Row widths off the TPU's 128-lane tiling, off 16-byte bounds (S % 4
# != 0) and under 8 slots, where a K2 tile holds the k_eff gate's most
# rows (512).
PARTIAL_ROWS = [1, 3, 10, 16, 50, 100, 200]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["k_eff", "masks", "stacked",
                                  "stacked_masks"])
@pytest.mark.parametrize("s", PARTIAL_ROWS)
def test_gossip_kernels_take_partial_rows(cuda, s, form):
    """K2 and K4 once refused rows that are not whole 128-slot groups;
    they take any S now: each kernel == its plain version at S off every
    4- and 128-slot bound, K2 on N = 1001 rows (a ragged last tile,
    both column alignments where N * STRIDE % S != 0), K4 on eight
    shards of 33 rows (shard ends off 16-byte bounds where 33 * S % 4 !=
    0), both with shifts that split a tile's senders at the wrap."""
    rng = np.random.default_rng(s * 10 + len(form))
    if form in ("k_eff", "masks"):
        n, shift_list = 1001, [1, 1000, 37, 517]
        k_max = len(shift_list)
        mail = _packed(rng, n, 0.5, (n, s)).to(cuda)
        view = _packed(rng, n, 0.8, (n, s)).to(cuda)
        k_eff = torch.from_numpy(rng.integers(0, k_max + 1, size=n,
                                              dtype=np.int32)).to(cuda)
        masks = (_flags(rng, k_max * n * s, 0.7).reshape(k_max, n, s)
                 .to(cuda) if form == "masks" else None)
        payload = view if form == "masks" else torch.where(
            _flags(rng, n * s, 0.3).reshape(n, s).to(cuda), view, 0)
        shifts = torch.tensor(shift_list, dtype=torch.int32, device=cuda)
        want = gossip_plain(n, s, k_max, mail, payload, k_eff, shifts, masks)
        kernels.reset_launches()
        got = gossip_fused(n, s, k_max, mail.clone(), payload, k_eff,
                           shifts, masks=masks)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["gossip" if form == "k_eff"
                                else "gossip_masks"] == 1
    else:
        d, n_local, k_max = 8, 33, 3
        n = d * n_local
        mail = _packed(rng, n, 0.5, (n, s)).to(cuda)
        view = _packed(rng, n, 0.8, (n, s)).to(cuda)
        c = torch.tensor([n_local - 1, 0, 11], dtype=torch.int32,
                         device=cuda)
        s1, s2 = (torch.from_numpy(rng.integers(0, s, size=(d, k_max),
                                                dtype=np.int32)).to(cuda)
                  for _ in range(2))
        keep = _flags(rng, k_max * n * s, 0.3).reshape(k_max, n, s).to(cuda)
        payloads = torch.where(keep, view[None], 0)
        masks = (None if form == "stacked" else
                 _flags(rng, k_max * n * s, 0.7).reshape(k_max, n, s)
                 .to(cuda))
        want = gossip_stacked_plain(n_local, s, k_max, False, mail, payloads,
                                    c, s1, s2, masks)
        kernels.reset_launches()
        got = gossip_fused_stacked(n_local, s, k_max, False, mail.clone(),
                                   payloads, c, s1, s2, masks)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["gossip_stacked" if form == "stacked"
                                else "gossip_stacked_masks"] == 1
    assert torch.equal(got, want)
    assert not torch.equal(got, mail)


def _sliced(x, off):
    """``x`` copied into a larger buffer ``off`` elements in: a contiguous
    slice whose base lies ``off * itemsize`` bytes past the buffer's."""
    buf = torch.zeros(x.numel() + off + 16, dtype=x.dtype, device=x.device)
    out = buf[off:off + x.numel()].view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() == buf.data_ptr() + (
        off * x.element_size())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["whole", "sliced"])
@pytest.mark.parametrize("admit", [False, True])
@pytest.mark.parametrize("s", PARTIAL_ROWS + [127, 129, 1030, 4095, 4097,
                                             4099, 10000])
def test_receive_kernel_partial_rows(cuda, s, admit, layout):
    """K1 at row widths off the 128-slot groups and off 16-byte bounds:
    the flattened planes' tiles end inside rows (1001 rows, or 40 past
    4096 slots: a ragged last tile), rows wider than a tile span several;
    ``sliced`` gives every plane its own offset of 4, 8 or 12 bytes off a
    16-byte bound (the row vectors odd byte offsets) and the rows a first
    node id row0 != 0, as a shard's.  == its plain version, row counts
    included."""
    _check_receive_rows(cuda, s, 1001 if s < 4096 else 40, admit, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["whole", "sliced"])
@pytest.mark.parametrize("admit", [False, True])
@pytest.mark.parametrize("s", [128, 129])
def test_receive_kernel_many_tiles(cuda, s, admit, layout):
    """K1 on a grid of many tiles (32768 rows: over 4000 tiles of 1024
    entries, more than thirty a streaming multiprocessor), whole rows to
    a tile at S=128 and rows cut by tile ends at S=129, here also with
    planes off 16-byte bounds, row0 != 0 and admit.  == its plain
    version, row counts included."""
    _check_receive_rows(cuda, s, 32768, admit, layout)


def _check_receive_rows(cuda, s, rows, admit, layout):
    t = 45
    row0 = 777 if layout == "sliced" else 0
    n = rows + row0 + 3
    rng = np.random.default_rng(7 * s + admit + 2 * len(layout))
    view = _packed(rng, n, 0.7, (rows, s))
    view_ts = torch.from_numpy(
        rng.integers(0, t + 1, size=(rows, s), dtype=np.int32))
    mail = _packed(rng, n, 0.4, (rows, s))
    cand = torch.where(_flags(rng, rows * s, 0.5).reshape(rows, s), view,
                       _packed(rng, n, 0.1, (rows, s)))
    act = _flags(rng, rows, 0.9)
    self_on = act & _flags(rng, rows, 0.95)
    spack = _packed(rng, n, 1.0, (rows,)) * self_on
    args = [x.to(cuda) for x in (view, view_ts, mail, cand,
                                 _flags(rng, rows, 0.9), act, self_on, spack)]
    mask = (_flags(rng, rows * s, 0.5).reshape(rows, s).to(torch.int32)
            .to(cuda) if admit else None)
    if layout == "sliced":
        # view, view_ts, mail, cand, recv, act, self_on, self_pack
        offs = (1, 2, 3, 2, 5, 11, 3, 1)
        args = [_sliced(a, o) for a, o in zip(args, offs)]
        mask = None if mask is None else _sliced(mask, 3)
        assert {a.data_ptr() % 16 for a in args[:4]} == {4, 8, 12}
    want = receive_core(n, s, TFAIL, TREMOVE, STRIDE, t, *args,
                        row0=row0, admit_mask=mask)
    kernels.reset_launches()
    got = receive_fused(n, s, TFAIL, TREMOVE, STRIDE, t,
                        *(a.clone() if layout == "whole" else
                          _sliced(a, 1 + i % 3)
                          for i, a in enumerate(args)),
                        row0=row0, admit_mask=mask)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["receive_admit" if admit else "receive"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[5].sum()) > 0 and int(want[6].sum()) > 0


@pytest.mark.cuda
def test_sharded_run_on_card_matches_cpu(cuda, tmp_path):
    """The N=256 eight-shard full-event conf writes the same logs on the
    card (K1, K4, K3) as on the CPU, each kernel once per tick."""
    import pathlib

    from distributed_membership_tpu_torch.runtime.application import (
        run_conf)

    conf = str(pathlib.Path(__file__).resolve().parent.parent
               / "distributed_membership_tpu_torch" / "confs"
               / "ring_256_s128_sharded8_drop.conf")
    kernels.reset_launches()
    run_conf(conf, out_dir=str(tmp_path / "cuda"), device="cuda")
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "receive": 120, "gossip_stacked": 120, "probe": 120}
    run_conf(conf, out_dir=str(tmp_path / "cpu"), device="cpu")
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        assert ((tmp_path / "cuda" / name).read_bytes()
                == (tmp_path / "cpu" / name).read_bytes()), name


# ---------------------------------------------------------------------------
# The grader regime on the card: the scatter exchange (no kernel) and cold
# joins on the ring (K1-K3).

@pytest.mark.cuda
def test_grade_all_on_card_matches_cpu(cuda, tmp_path, capsys):
    """--grade-all on the card grades 90 and writes the CPU run's logs;
    the scatter step launches no kernel."""
    from distributed_membership_tpu_torch.runtime import application

    kernels.reset_launches()
    assert application.main(["--grade-all", "--seed", "3", "--backend",
                             "tpu_hash", "--out-dir",
                             str(tmp_path / "cuda")]) == 0
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    assert application.main(["--grade-all", "--device", "cpu", "--seed",
                             "3", "--backend", "tpu_hash", "--out-dir",
                             str(tmp_path / "cpu")]) == 0
    assert capsys.readouterr().out.count("Final grade 90") == 2
    for scenario in ("singlefailure", "multifailure",
                     "msgdropsinglefailure"):
        for name in ("dbg.log", "stats.log", "msgcount.log"):
            assert ((tmp_path / "cuda" / scenario / name).read_bytes()
                    == (tmp_path / "cpu" / scenario / name).read_bytes()), (
                        scenario, name)


@pytest.mark.cuda
def test_cold_join_ring_on_card_matches_cpu(cuda, tmp_path):
    """Staggered joins on the N=256, S=128 ring with 5% drops: K1, K2's
    masks form and K3 once per tick, and the CPU run's logs."""
    import pathlib

    from distributed_membership_tpu_torch.runtime.application import (
        run_conf)

    conf = str(pathlib.Path(__file__).resolve().parent.parent
               / "distributed_membership_tpu_torch" / "confs"
               / "ring_256_s128_staggered_drop.conf")
    kernels.reset_launches()
    res = run_conf(conf, out_dir=str(tmp_path / "cuda"), device="cuda")
    ticks = res.params.TOTAL_TIME
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "receive": ticks, "gossip_masks": ticks, "probe": ticks}
    assert res.extra["final_state"].view.is_cuda
    run_conf(conf, out_dir=str(tmp_path / "cpu"), device="cpu")
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        assert ((tmp_path / "cuda" / name).read_bytes()
                == (tmp_path / "cpu" / name).read_bytes()), name


# ---------------------------------------------------------------------------
# K6 on D shards in one launch (the sharded folded step).  (D, L, S, k_max):
# eight shards of 8 plane rows at S=16; at S=2 and S=4 shards of one and
# of a few plane rows, where the runs widened to 16-byte bounds reach a
# shard's edge; three shards (L*STRIDE % S != 0: two alignments).  The
# node shifts include 0 and L - 1.

GOSSIP_FOLDED_SHARDS = [(8, 64, 16, 3), (8, 64, 2, 3), (8, 512, 2, 3),
                        (8, 32, 4, 3), (3, 96, 4, 3), (3, 40, 16, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["stacked", "masks", "stacked_masks"])
@pytest.mark.parametrize("d,n_local,s,k_max", GOSSIP_FOLDED_SHARDS)
def test_gossip_folded_shards_kernel(cuda, d, n_local, s, k_max, form):
    n = d * n_local
    rows = n * s // 128
    single = (n_local * STRIDE) % s == 0
    rng = np.random.default_rng(d * n_local + s + k_max)
    mail = _packed(rng, n, 0.5, (rows, 128)).to(cuda)
    view = _packed(rng, n, 0.8, (rows, 128)).to(cuda)
    thr = torch.tensor([v % n_local for v in (n_local - 1, 0, 5)[:k_max]],
                       dtype=torch.int32, device=cuda)
    c1, c2 = (torch.from_numpy(rng.integers(0, s, size=(d, k_max),
                                            dtype=np.int32)).to(cuda)
              for _ in range(2))
    keep = _flags(rng, k_max * rows * 128, 0.3).reshape(
        k_max, rows, 128).to(cuda)
    payloads = view[None] if form == "masks" else torch.where(
        keep, view[None], 0)
    masks = (None if form == "stacked" else _flags(
        rng, k_max * rows * 128, 0.7).reshape(k_max, rows, 128).to(cuda))
    want = gossip_folded_plain(rows, s, k_max, single, mail, payloads, thr,
                               c1, c2, masks, n_local=n_local)
    kernels.reset_launches()
    got = gossip_folded_stacked(rows, s, k_max, single, mail.clone(),
                                payloads, thr, c1, c2, masks,
                                n_local=n_local)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gossip_folded" if form == "stacked"
                            else "gossip_folded_masks"] == 1
    assert torch.equal(got, want)
    assert not torch.equal(got, mail)


def _timelines_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.cuda
def test_sharded_folded_run_on_card_matches_cpu(cuda, tmp_path):
    """A sharded folded run (eight shards of 512 nodes, S=16, 5% drops,
    TELEMETRY hist) ends in the CPU run's state, detection summary and
    timeline, with K5, K6 and K7's hist form once per tick."""
    from distributed_membership_tpu_torch.convert import state_to_numpy
    from distributed_membership_tpu_torch.runtime.application import (
        run_conf)

    conf = tmp_path / "shf.conf"
    conf.write_text(
        "MAX_NNB: 4096\nSINGLE_FAILURE: 1\nDROP_MSG: 1\n"
        "MSG_DROP_PROB: 0.05\nDROP_START: 0\nDROP_STOP: 80\n"
        "VIEW_SIZE: 16\nGOSSIP_LEN: 4\nPROBES: 2\nFANOUT: 3\nTFAIL: 16\n"
        "TREMOVE: 40\nTOTAL_TIME: 80\nFAIL_TIME: 10\nJOIN_MODE: warm\n"
        "EXCHANGE: ring\nEVENT_MODE: agg\nBACKEND: tpu_hash_sharded\n"
        "MESH_SHAPE: 8\nFOLDED: 1\nTELEMETRY: hist\n")
    kernels.reset_launches()
    card = run_conf(str(conf), out_dir=str(tmp_path / "cuda"), device="cuda")
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "receive_folded": 80, "gossip_folded": 80, "probe_folded_hist": 80}
    cpu = run_conf(str(conf), out_dir=str(tmp_path / "cpu"), device="cpu")
    assert (card.extra["detection_summary"]
            == cpu.extra["detection_summary"])
    assert card.extra["detection_summary"]["detections_total"] > 0
    want = state_to_numpy(cpu.extra["final_state"])
    got = state_to_numpy(card.extra["final_state"])
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    _timelines_equal(card.extra["timeline"], cpu.extra["timeline"])


@pytest.mark.cuda
def test_telemetry_run_on_card_matches_cpu(cuda, tmp_path):
    """TELEMETRY hist on the natural ring (full events, 5% drops): K3's
    hist form once per tick, the CPU run's logs and timeline."""
    from distributed_membership_tpu_torch.runtime.application import (
        run_conf)

    conf = tmp_path / "ring.conf"
    conf.write_text(
        "MAX_NNB: 256\nSINGLE_FAILURE: 1\nDROP_MSG: 1\nMSG_DROP_PROB: 0.05\n"
        "DROP_START: 20\nDROP_STOP: 60\nVIEW_SIZE: 128\nGOSSIP_LEN: 32\n"
        "PROBES: 16\nFANOUT: 3\nTFAIL: 16\nTREMOVE: 40\nTOTAL_TIME: 80\n"
        "FAIL_TIME: 10\nJOIN_MODE: warm\nEXCHANGE: ring\n"
        "BACKEND: tpu_hash\nTELEMETRY: hist\n")
    kernels.reset_launches()
    card = run_conf(str(conf), out_dir=str(tmp_path / "cuda"), device="cuda")
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "receive": 80, "gossip_masks": 80, "probe_hist": 80}
    cpu = run_conf(str(conf), out_dir=str(tmp_path / "cpu"), device="cpu")
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        assert ((tmp_path / "cuda" / name).read_bytes()
                == (tmp_path / "cpu" / name).read_bytes()), name
    _timelines_equal(card.extra["timeline"], cpu.extra["timeline"])
    assert card.extra["timeline"]["dropped"].sum() > 0


@pytest.mark.cuda
def test_scenario_run_on_card_matches_cpu(cuda, tmp_path):
    """An N=256 full-event run under a scenario with every event kind:
    the card's three logs and its oracle report equal the CPU's; K1, K2's
    masks form and K3 once per tick."""
    import json

    from distributed_membership_tpu_torch.runtime.application import (
        run_conf)

    scn = tmp_path / "mixed.json"
    scn.write_text(json.dumps({"name": "mixed", "events": [
        {"kind": "partition", "start": 10, "stop": 30,
         "groups": [[0, 100], [100, 256]]},
        {"kind": "crash", "time": 5, "range": [20, 28]},
        {"kind": "restart", "time": 35, "range": [20, 24]},
        {"kind": "leave", "time": 12, "nodes": [200]},
        {"kind": "link_flake", "start": 20, "stop": 50, "src": [0, 128],
         "dst": [128, 256], "drop_prob": 0.11},
        {"kind": "one_way_flake", "start": 40, "stop": 45,
         "src": [128, 256], "dst": [0, 64]},
        {"kind": "drop_window", "start": 15, "stop": 40, "drop_prob": 0.02},
        {"kind": "delay_window", "start": 25, "stop": 33,
         "dst": [50, 90]}]}))
    conf = tmp_path / "ring.conf"
    conf.write_text(
        "MAX_NNB: 256\nSINGLE_FAILURE: 1\nVIEW_SIZE: 128\nGOSSIP_LEN: 32\n"
        "PROBES: 16\nFANOUT: 3\nTFAIL: 16\nTREMOVE: 40\nTOTAL_TIME: 80\n"
        "JOIN_MODE: warm\nEXCHANGE: ring\nBACKEND: tpu_hash\n"
        f"SCENARIO: {scn}\n")
    kernels.reset_launches()
    card = run_conf(str(conf), out_dir=str(tmp_path / "cuda"),
                    device="cuda")
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "receive": 80, "gossip_masks": 80, "probe": 80}
    cpu = run_conf(str(conf), out_dir=str(tmp_path / "cpu"), device="cpu")
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        assert ((tmp_path / "cuda" / name).read_bytes()
                == (tmp_path / "cpu" / name).read_bytes()), name
    assert card.extra["scenario_report"] == cpu.extra["scenario_report"]
    assert card.extra["scenario_report"]["partitions"][0][
        "removals_during"] > 0


# ---------------------------------------------------------------------------
# Checkpoints across devices, T-tick blocks and hoisting on the card.

def _confs():
    import pathlib
    return (pathlib.Path(__file__).resolve().parent.parent
            / "distributed_membership_tpu_torch" / "confs")


@pytest.mark.cuda
@pytest.mark.parametrize("killer,resumer", [("cuda", "cpu"), ("cpu", "cuda")])
def test_checkpoint_resume_across_devices(cuda, tmp_path, monkeypatch,
                                          killer, resumer):
    """ring_256_s128_drop in 20-tick segments killed at 70 (the manifest
    at 80) on one device and resumed on the other: the three logs equal
    the CPU's uninterrupted run; the card drives each kernel once per
    tick it runs."""
    from distributed_membership_tpu_torch.runtime import checkpoint as ck
    from distributed_membership_tpu_torch.runtime.application import (
        run_conf)

    conf = str(_confs() / "ring_256_s128_drop.conf")
    run_conf(conf, out_dir=str(tmp_path / "ref"), device="cpu")
    kw = dict(checkpoint_every=20, checkpoint_dir=str(tmp_path / "ck"))
    monkeypatch.setenv(ck.CRASH_ENV, "70")
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="injected crash at tick 80"):
        run_conf(conf, out_dir=str(tmp_path / "a"), device=killer, **kw)
    monkeypatch.delenv(ck.CRASH_ENV)
    run_conf(conf, out_dir=str(tmp_path / "b"), device=resumer, resume=True,
             **kw)
    n = 80 if killer == "cuda" else 40
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "receive": n, "gossip_masks": n, "probe": n}
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        assert ((tmp_path / "b" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes()), name


def _agg_conf(tmp_path, extra):
    conf = tmp_path / "ring.conf"
    conf.write_text(
        "MAX_NNB: 4096\nSINGLE_FAILURE: 1\nDROP_MSG: 1\nMSG_DROP_PROB: 0.1\n"
        "DROP_START: 10\nDROP_STOP: 50\nGOSSIP_LEN: 4\nPROBES: 2\n"
        "FANOUT: 3\nTFAIL: 16\nTREMOVE: 64\nTOTAL_TIME: 60\nFAIL_TIME: 30\n"
        "VIEW_SIZE: 16\nJOIN_MODE: warm\nEVENT_MODE: agg\nEXCHANGE: ring\n"
        "FOLDED: 1\nTELEMETRY: hist\nBACKEND: tpu_hash\n" + extra)
    return str(conf)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    "CHECKPOINT_EVERY: 24\nMEGA_TICKS: 8\nMEGA_PACK: 1\n",
    "CHECKPOINT_EVERY: 12\nRNG_MODE: hoisted\nMEGA_TICKS: 4\n"],
    ids=["mega", "hoisted"])
def test_blocked_and_hoisted_runs_on_card_match_cpu(cuda, tmp_path, extra):
    """The folded step (N=4096, S=16, drops, TELEMETRY hist) in packed
    8-tick blocks, and hoisted in 4-tick blocks, on the card: the
    detection summary and every series equal the CPU's per-tick run; K5,
    K6 and K7 once per tick."""
    from distributed_membership_tpu_torch.runtime.application import (
        run_conf)

    cpu = run_conf(_agg_conf(tmp_path, ""), out_dir=str(tmp_path / "cpu"),
                   device="cpu")
    kernels.reset_launches()
    card = run_conf(_agg_conf(tmp_path, extra),
                    out_dir=str(tmp_path / "cuda"), device="cuda")
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "receive_folded": 60, "gossip_folded": 60, "probe_folded_hist": 60}
    assert (card.extra["detection_summary"]
            == cpu.extra["detection_summary"])
    _timelines_equal(card.extra["timeline"], cpu.extra["timeline"])


# Rows wider than one 16 KiB tile: K2's and K4's row-chunk tiles.  Ragged N
# (not a multiple of anything the kernel tiles by), and N * STRIDE % S != 0
# except at N = S, so the wrapped rows take the second column alignment;
# S = 4224 and 12416 end in a ragged chunk of 128 columns.  The column
# rotations are mostly not multiples of 4, so sender runs start off a
# 16-byte bound and wrap inside a chunk.
WIDE_CASES = [(301, 4224), (77, 8192), (40, 16384), (16384 // 64, 16384),
              (37, 12416)]


def _wide_gate(rng, cuda, form, fill, k_max, n, s):
    """K2's gate: k_eff over 0..k_max, all closed (0) or all open (k_max);
    or masks at 70%, all zero or all one."""
    if form == "k_eff":
        k_eff = {"random": torch.from_numpy(rng.integers(
                     0, k_max + 1, size=n, dtype=np.int32)),
                 "none": torch.zeros(n, dtype=torch.int32),
                 "all": torch.full((n,), k_max, dtype=torch.int32)}[fill]
        return k_eff.to(cuda), None
    masks = {"random": lambda: _flags(rng, k_max * n * s, 0.7),
             "none": lambda: torch.zeros(k_max * n * s, dtype=torch.bool),
             "all": lambda: torch.ones(k_max * n * s, dtype=torch.bool)}
    return (torch.zeros(n, dtype=torch.int32, device=cuda),
            masks[fill]().reshape(k_max, n, s).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["random", "none", "all"])
@pytest.mark.parametrize("form", ["k_eff", "masks"])
@pytest.mark.parametrize("n,s", WIDE_CASES)
def test_gossip_kernel_wide_rows(cuda, form, fill, n, s):
    k_max = 3
    rng = np.random.default_rng(n + s)
    mail = _packed(rng, n, 0.5, (n, s)).to(cuda)
    view = _packed(rng, n, 0.8, (n, s)).to(cuda)
    k_eff, masks = _wide_gate(rng, cuda, form, fill, k_max, n, s)
    payload = view if form == "masks" else torch.where(
        _flags(rng, n * s, 0.3).reshape(n, s).to(cuda), view, 0)
    shifts = torch.tensor([1, n - 1, n // 3], dtype=torch.int32,
                          device=cuda)
    want = gossip_plain(n, s, k_max, mail, payload, k_eff, shifts, masks)
    kernels.reset_launches()
    got = gossip_fused(n, s, k_max, mail.clone(), payload, k_eff, shifts,
                       masks=masks)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gossip_wide" if form == "k_eff"
                            else "gossip_wide_masks"] == 1
    assert torch.equal(got, want)
    assert torch.equal(got, mail) == (fill == "none")


@pytest.mark.cuda
@pytest.mark.parametrize("form,fill", [("stacked", "random"),
                                       ("masks", "random"), ("masks", "none"),
                                       ("masks", "all")])
@pytest.mark.parametrize("d,n_local,s", [(1, 301, 4224), (3, 77, 8192),
                                         (8, 5, 16384), (8, 64, 8192),
                                         (4, 1, 12416)])
def test_gossip_stacked_kernel_wide_rows(cuda, form, fill, d, n_local, s):
    """Also eight shards at S = 8192 and shards of one row; shard 0's
    first shift rotates by 4097 (unwrapped rows) and 3 (wrapped rows)."""
    k_max = 3
    n = d * n_local
    single = (n_local * STRIDE) % s == 0
    rng = np.random.default_rng(d * n_local + s)
    mail = _packed(rng, n, 0.5, (n, s)).to(cuda)
    view = _packed(rng, n, 0.8, (n, s)).to(cuda)
    c = torch.tensor([n_local - 1, 0, n_local // 3], dtype=torch.int32,
                     device=cuda)
    s1, s2 = (torch.from_numpy(rng.integers(0, s, size=(d, k_max),
                                            dtype=np.int32)).to(cuda)
              for _ in range(2))
    s1[0, 0], s2[0, 0] = 4097, 3
    payloads = view[None] if form == "masks" else torch.where(
        _flags(rng, k_max * n * s, 0.3).reshape(k_max, n, s).to(cuda),
        view[None], 0)
    masks = (None if form == "stacked" else
             {"random": lambda: _flags(rng, k_max * n * s, 0.7),
              "none": lambda: torch.zeros(k_max * n * s, dtype=torch.bool),
              "all": lambda: torch.ones(k_max * n * s, dtype=torch.bool)}
             [fill]().reshape(k_max, n, s).to(cuda))
    want = gossip_stacked_plain(n_local, s, k_max, single, mail, payloads,
                                c, s1, s2, masks)
    kernels.reset_launches()
    got = gossip_fused_stacked(n_local, s, k_max, single, mail.clone(),
                               payloads, c, s1, s2, masks)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gossip_stacked_wide" if form == "stacked"
                            else "gossip_stacked_wide_masks"] == 1
    assert torch.equal(got, want)
    assert torch.equal(got, mail) == (fill == "none")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 1 << 20, (1 << 20) + 1])
@pytest.mark.parametrize("partitionable", [True, False])
def test_threefry_bits_card_equal_cpu(cuda, n, partitionable):
    """Both threefry streams draw the same bits on the card as on the
    CPU (int64 arithmetic masked to u32 on either device)."""
    from distributed_membership_tpu_torch.ops import threefry
    key = threefry.fold_in(threefry.prng_key(2026), n)
    with threefry.partitionable(partitionable):
        got = threefry.random_bits(key, n, cuda).cpu()
        want = threefry.random_bits(key, n, "cpu")
        idx = torch.arange(0, n, max(n // 97, 1))
        at = threefry.uniform_at(key, idx.to(cuda), n).cpu()
        at_cpu = threefry.uniform_at(key, idx, n)
    assert torch.equal(got, want)
    assert torch.equal(at, at_cpu)


@pytest.mark.cuda
def test_update_agg_card_equal_cpu(cuda):
    """One AggStats tick (the census tick and a later one) on the card
    equals the CPU's: the int32 index_add counts are order-free."""
    from distributed_membership_tpu_torch.observability.aggregates import (
        init_agg, update_agg)
    n, m = 4096, 128
    rng = np.random.default_rng(7)
    fail_np = np.zeros(n, bool)
    fail_np[rng.choice(n, n // 2, replace=False)] = True

    def ids(p):
        x = rng.integers(0, n, size=(n, m), dtype=np.int64)
        return torch.from_numpy(np.where(rng.random((n, m)) < p, x,
                                         -1).astype(np.int32))
    tick = dict(join_ids=ids(0.05), rm_ids=ids(0.1), view_ids=ids(0.7),
                sent_tick=torch.from_numpy(rng.integers(
                    0, 100, n, dtype=np.int32)),
                recv_tick=torch.from_numpy(rng.integers(
                    0, 100, n, dtype=np.int32)))
    tick["view_present"] = tick["view_ids"] >= 0
    out = {}
    for dev in ("cpu", cuda):
        agg = init_agg(n, dev)
        kw = {k: v.to(dev) for k, v in tick.items()}
        fail = torch.from_numpy(fail_np).to(dev)
        for t in (8, 9):
            agg = update_agg(agg, t=t, fail_mask=fail, fail_time=8, **kw)
        out[str(dev)] = [x.cpu() for x in agg]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        assert torch.equal(got, want)
    assert int(out["cpu"][1].sum()) > 0     # true detections at t = 9


@pytest.mark.cuda
def test_send_budget_card_equal_cpu(cuda):
    """ENFORCE_BUFFSIZE's cumsum forms (1-D, row-count/clip, probes) on
    the card equal the CPU's."""
    from distributed_membership_tpu_torch.backends.tpu_hash import (
        SendBudget)
    rng = np.random.default_rng(11)
    masks = [torch.from_numpy(rng.random(4096) < 0.3),
             torch.from_numpy(rng.random((4096, 128)) < 0.4),
             torch.from_numpy(rng.random((4096, 128)) < 0.4)]
    probes = torch.from_numpy(rng.random((4096, 16)) < 0.8)
    out = {}
    for dev in ("cpu", cuda):
        b = SendBudget(250000, dev)
        kept = [b.take(m.to(dev)).cpu() for m in masks]
        kept.append(b.take_probes(probes.to(dev), 2).cpu())
        out[str(dev)] = kept + [b.used.cpu()]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        assert torch.equal(got, want)
    assert int(out["cpu"][-1]) == 250000      # the budget bound


@pytest.mark.cuda
def test_folded_probes0_run_on_card_matches_cpu(cuda, tmp_path):
    """The folded layout with PROBES 0: K5 and K6 once per tick and no K7;
    the CPU run's detection summary and final state."""
    from distributed_membership_tpu_torch.convert import state_to_numpy
    from distributed_membership_tpu_torch.runtime.application import (
        run_conf)

    conf = tmp_path / "p0.conf"
    conf.write_text(
        "MAX_NNB: 4096\nSINGLE_FAILURE: 1\nDROP_MSG: 1\n"
        "MSG_DROP_PROB: 0.05\nDROP_START: 0\nDROP_STOP: 80\n"
        "VIEW_SIZE: 16\nGOSSIP_LEN: 4\nPROBES: 0\nFANOUT: 3\nTFAIL: 16\n"
        "TREMOVE: 32\nTOTAL_TIME: 80\nFAIL_TIME: 10\nJOIN_MODE: warm\n"
        "EXCHANGE: ring\nEVENT_MODE: agg\nBACKEND: tpu_hash\nFOLDED: 1\n")
    kernels.reset_launches()
    card = run_conf(str(conf), out_dir=str(tmp_path / "cuda"), device="cuda")
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "receive_folded": 80, "gossip_folded": 80}
    cpu = run_conf(str(conf), out_dir=str(tmp_path / "cpu"), device="cpu")
    assert (card.extra["detection_summary"]
            == cpu.extra["detection_summary"])
    assert card.extra["detection_summary"]["detections_total"] > 0
    want = state_to_numpy(cpu.extra["final_state"])
    got = state_to_numpy(card.extra["final_state"])
    assert set(got) == set(want) and got["probe_ids1"].shape == (1, 1)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


_SERVED = ("MAX_NNB: 4096\nSINGLE_FAILURE: 1\nDROP_MSG: 0\nMSG_DROP_PROB: 0\n"
           "VIEW_SIZE: 128\nGOSSIP_LEN: 32\nPROBES: 16\nFANOUT: 3\n"
           "TFAIL: 8\nTREMOVE: 32\nTOTAL_TIME: 80\nFAIL_TIME: 10\n"
           "JOIN_MODE: warm\nEXCHANGE: ring\nEVENT_MODE: full\n"
           "BACKEND: tpu_hash\nCHECKPOINT_EVERY: 20\nSERVICE_PORT: 0\n")


def _serve(conf, out_dir, device):
    """``serve_run`` in this thread; a client thread waits for the run's
    end and asks for the shutdown.  Returns the exit code."""
    import json
    import threading
    import time
    import urllib.request

    from distributed_membership_tpu_torch.config import Params
    from distributed_membership_tpu_torch.service import daemon

    out_dir.mkdir()
    beacon = out_dir / daemon.SERVICE_JSON

    def client():
        while not beacon.exists():
            time.sleep(0.05)
        port = json.loads(beacon.read_text())["port"]
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            with urllib.request.urlopen(base + "/healthz") as r:
                if json.loads(r.read())["status"] == "complete":
                    break
            time.sleep(0.05)
        urllib.request.urlopen(urllib.request.Request(
            base + "/v1/admin/shutdown", data=b"{}", method="POST")).read()

    t = threading.Thread(target=client, daemon=True)
    t.start()
    rc = daemon.serve_run(Params.from_file(str(conf)), out_dir=str(out_dir),
                          device=device)
    t.join(timeout=60)
    assert not t.is_alive()
    return rc


@pytest.mark.cuda
def test_served_run_on_card_matches_cpu(cuda, tmp_path):
    """A served N=4096 run (full events, 20-tick segments) on the card
    writes the CPU's served logs, with K1-K3 once per tick."""
    conf = tmp_path / "served.conf"
    conf.write_text(_SERVED)
    kernels.reset_launches()
    assert _serve(conf, tmp_path / "cuda", "cuda") == 0
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "receive": 80, "gossip": 80, "probe": 80}
    assert _serve(conf, tmp_path / "cpu", "cpu") == 0
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        assert ((tmp_path / "cuda" / name).read_bytes()
                == (tmp_path / "cpu" / name).read_bytes()), name
    assert b" removed " in (tmp_path / "cuda" / "dbg.log").read_bytes()


@pytest.mark.cuda
def test_published_arrays_intact_after_two_boundaries(cuda, tmp_path,
                                                      monkeypatch):
    """The host arrays a CUDA carry's pinned staging sets are copied out
    to (view as uint32, view_ts as int32) are never written again: every
    boundary's arrays, read after the run's later boundaries (and the
    staging sets' reuse), equal what was pulled."""
    from distributed_membership_tpu_torch.service import daemon

    pulled = []
    orig = daemon.pull_snapshot

    def keep(carry):
        assert not carry.view.is_cuda and carry.view.is_pinned()
        host = orig(carry)
        pulled.append((host, {k: v.copy() for k, v in vars(host).items()}))
        return host
    monkeypatch.setattr(daemon, "pull_snapshot", keep)
    conf = tmp_path / "served.conf"
    conf.write_text(_SERVED)
    assert _serve(conf, tmp_path / "cuda", "cuda") == 0
    assert len(pulled) == 5         # ticks 0, 20, 40, 60, 80
    for host, copy in pulled:
        assert host.view.dtype == np.uint32
        assert host.view_ts.dtype == np.int32
        for k, v in copy.items():
            np.testing.assert_array_equal(getattr(host, k), v, err_msg=k)
    assert not np.array_equal(pulled[0][1]["view"], pulled[2][1]["view"])


# ---------------------------------------------------------------------------
# Elastic resharding (elastic/reshard.py) and the fleet on the card


def _carry_leaves(rng, n=300, s=12):
    """Carry-like host leaves: bool planes and vectors (sizes that do not
    fill a 32-bit word), int32 stamps inside and at the edge of the u16
    lanes, a uint32 plane, scalars."""
    return [rng.random((n, s)) < 0.5, rng.random(n + 5) < 0.3,
            np.array(True),
            rng.integers(-1, 65535, (n, s - 1)).astype(np.int32),
            np.array([[-1, 65534, 7]], np.int32),
            np.array([[-2, 5, 6]], np.int32),
            rng.integers(0, 2**32, (n, s), dtype=np.uint64).astype(np.uint32),
            np.int32(40), rng.random(n).astype(np.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("pack16", [False, True])
def test_reshard_codec_on_card_equals_cpu(cuda, pack16):
    """The boundary codec's round trip on the card: the packed words of
    every bit and u16 lane equal the CPU's, and the reshard's byte counts
    too."""
    from distributed_membership_tpu_torch.elastic import reshard as rs
    from distributed_membership_tpu_torch.ops import megakernel as mk
    leaves = _carry_leaves(np.random.default_rng(5))
    got = rs._codec_roundtrip(leaves, pack16, 200, cuda)
    want = rs._codec_roundtrip(leaves, pack16, 200, torch.device("cpu"))
    for k in ("carry_bytes_full", "carry_bytes_packed"):
        assert got[k] == want[k], k
    assert got["carry_bytes_packed"] < got["carry_bytes_full"]
    for leaf in leaves:
        x = torch.from_numpy(np.asarray(leaf))
        if x.dtype == torch.bool:
            pack, unpack = mk._pack_bits, mk._unpack_bits
        elif pack16 and x.dtype == torch.int32 and x.ndim >= 1 \
                and mk.fits16(leaf):
            pack, unpack = mk._pack_u16, mk._unpack_u16
        else:
            continue
        words = pack(x.to(cuda))
        assert torch.equal(words.cpu(), pack(x))
        assert torch.equal(unpack(words, x.shape).cpu(), x)


@pytest.mark.cuda
def test_reshard_on_card_writes_the_cpus_files(cuda, tmp_path):
    """A reshard with the codec on the card writes the files of the same
    reshard on the CPU (the npz members byte for byte, the manifest but
    for its stamps)."""
    import json

    from distributed_membership_tpu_torch.elastic.reshard import reshard
    from distributed_membership_tpu_torch.runtime.checkpoint import (
        CKPT_VERSION, MANIFEST_NAME, load_manifest, state_hash)
    leaves = _carry_leaves(np.random.default_rng(6))
    src = tmp_path / "src"
    src.mkdir()
    fname = "ckpt_00000040.npz"
    np.savez(src / fname, **{f"c{i}": a for i, a in enumerate(leaves)},
             e_hist=np.arange(5))
    params = {"EN_GPSZ": 300, "MESH_SHAPE": "4", "FOLDED": 0}
    (src / MANIFEST_NAME).write_text(json.dumps({
        "version": CKPT_VERSION, "tick": 40, "file": fname,
        "state_hash": state_hash(leaves), "seed": 1,
        "params_text": json.dumps(params, sort_keys=True),
        "backend": "tpu_hash_sharded", "total_time": 200,
        "process_count": 1, "checkpoints": []}))
    out = {}
    for dev in ("cuda", "cpu"):
        dst = tmp_path / dev
        stats = reshard([str(src)], [str(dst)], to_mesh_shape="2x3",
                        pack16=True, device=dev)
        m = load_manifest(str(dst))
        for k in ("wrote_at",):
            m.pop(k)
        for r in m["reshard"]:
            r.pop("ts")
        with np.load(dst / m["file"]) as npz:
            out[dev] = (m, {k: (npz[k].dtype, npz[k].tobytes())
                            for k in npz.files},
                        {k: v for k, v in stats.items()
                         if not k.endswith("seconds")})
    assert out["cuda"] == out["cpu"]


_SHARDED_RESHARD = """MAX_NNB: 256
SINGLE_FAILURE: 1
DROP_MSG: 1
MSG_DROP_PROB: 0.05
VIEW_SIZE: 128
GOSSIP_LEN: 32
PROBES: 16
FANOUT: 3
TFAIL: 8
TREMOVE: 32
TOTAL_TIME: 80
FAIL_TIME: 20
JOIN_MODE: warm
EXCHANGE: ring
EVENT_MODE: full
BACKEND: tpu_hash_sharded
MESH_SHAPE: 8
"""


@pytest.mark.cuda
def test_resharded_resume_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """Eight shards killed on the card at 30 (the manifest at 40),
    resharded on the card to 4x2 and resumed there with mesh_shape
    "4x2": K1, K4's masks-free form and K3 once per resumed tick, and the
    logs of the CPU's 4x2 run from tick 0."""
    from distributed_membership_tpu_torch.elastic.reshard import reshard
    from distributed_membership_tpu_torch.runtime import checkpoint as ck
    from distributed_membership_tpu_torch.runtime.application import (
        run_conf)
    conf = tmp_path / "sh.conf"
    conf.write_text(_SHARDED_RESHARD)
    ckdir = str(tmp_path / "ck")
    kw = dict(checkpoint_every=20, checkpoint_dir=ckdir, resume=True)
    monkeypatch.setenv(ck.CRASH_ENV, "30")
    with pytest.raises(RuntimeError, match="injected crash"):
        run_conf(str(conf), seed=4, out_dir=str(tmp_path / "mig"),
                 device="cuda", **kw)
    monkeypatch.delenv(ck.CRASH_ENV)
    assert ck.manifest_tick(ckdir) == 40
    stats = reshard([ckdir], [ckdir], to_mesh_shape="4x2", device="cuda")
    assert stats["to_shape"] == "4x2"
    kernels.reset_launches()
    run_conf(str(conf), seed=4, out_dir=str(tmp_path / "mig"),
             device="cuda", mesh_shape="4x2", **kw)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "receive": 40, "gossip_stacked": 40, "probe": 40}
    run_conf(str(conf), seed=4, out_dir=str(tmp_path / "twin"),
             device="cpu", mesh_shape="4x2", checkpoint_every=20)
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        assert ((tmp_path / "mig" / name).read_bytes()
                == (tmp_path / "twin" / name).read_bytes()), name
    assert b" removed " in (tmp_path / "mig" / "dbg.log").read_bytes()


@pytest.mark.cuda
def test_fleet_records_the_cards_refusal_as_failed(cuda, tmp_path):
    """A ring conf with VIEW_SIZE 16 is a served run for the fleet; it
    pins FUSED_GOSSIP: 0, which the card refuses at make_config (the
    kernels are the path there).  The fleet's worker (on the card, the
    default) fails with that refusal in its log, as ``--serve`` of the
    conf fails."""
    import json
    import os
    import subprocess
    import sys
    import time
    import urllib.request
    conf_text = ("MAX_NNB: 256\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
                 "MSG_DROP_PROB: 0.0\nVIEW_SIZE: 16\nFAIL_TIME: 1000\n"
                 "JOIN_MODE: warm\nBACKEND: tpu_hash\nEVENT_MODE: agg\n"
                 "CHECKPOINT_EVERY: 30\nTOTAL_TIME: 60\nFUSED_GOSSIP: 0\n")
    conf = tmp_path / "v16.conf"
    conf.write_text(conf_text)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    served = subprocess.run(
        [sys.executable, "-m", "distributed_membership_tpu_torch",
         str(conf), "--serve", "--port", "0", "--out-dir",
         str(tmp_path / "srv")], cwd=repo, capture_output=True, text=True,
        timeout=300)
    assert served.returncode != 0
    refusal = "FUSED_GOSSIP: 0 on CUDA"
    assert refusal in served.stderr
    root = tmp_path / "fleet"
    root.mkdir()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_membership_tpu_torch",
         "--fleet", "--port", "0", "--out-dir", str(root)], cwd=repo,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        port = None
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            try:
                doc = json.loads((root / "fleet.json").read_text())
                port = doc["port"] if doc.get("pid") == proc.pid else None
            except (OSError, ValueError, KeyError):
                time.sleep(0.1)
        base = f"http://127.0.0.1:{port}"
        req = urllib.request.Request(
            base + "/v1/runs", method="POST",
            data=json.dumps({"conf": conf_text, "run_id": "v16"}).encode(),
            headers={"Content-Type": "application/json"})
        ack = json.loads(urllib.request.urlopen(req, timeout=30).read())
        assert ack["mode"] == "serve"
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            runs = json.loads(urllib.request.urlopen(
                base + "/v1/runs", timeout=30).read())["runs"]
            if runs[0]["state"] in ("failed", "done"):
                break
            time.sleep(0.2)
        assert runs[0]["state"] == "failed", runs
        assert refusal in (root / "v16" / "worker.log").read_text()
    finally:
        proc.terminate()
        proc.wait(timeout=120)


@pytest.mark.cuda
def test_folded_aggstats_run_on_card_matches_cpu(cuda, tmp_path):
    """More than 8 failed ids at S=16 (N=2^12, half the nodes fail): auto
    takes the folded layout's AggStats route on the card (K5-K7 once per
    tick), the natural layout on the CPU; the detection summary and the
    final state (reshaped) are the same."""
    from distributed_membership_tpu_torch.convert import state_to_numpy
    from distributed_membership_tpu_torch.runtime.application import (
        run_conf)

    conf = tmp_path / "multi.conf"
    conf.write_text(
        "MAX_NNB: 4096\nSINGLE_FAILURE: 0\nDROP_MSG: 1\n"
        "MSG_DROP_PROB: 0.05\nDROP_START: 0\nDROP_STOP: 70\n"
        "VIEW_SIZE: 16\nGOSSIP_LEN: 4\nPROBES: 4\nFANOUT: 3\nTFAIL: 8\n"
        "TREMOVE: 20\nTOTAL_TIME: 70\nFAIL_TIME: 10\nJOIN_MODE: warm\n"
        "EXCHANGE: ring\nEVENT_MODE: agg\nTELEMETRY: scalars\n"
        "BACKEND: tpu_hash\n")
    kernels.reset_launches()
    card = run_conf(str(conf), out_dir=str(tmp_path / "cuda"), device="cuda")
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "receive_folded": 70, "gossip_folded": 70, "probe_folded": 70}
    cpu = run_conf(str(conf), out_dir=str(tmp_path / "cpu"), device="cpu")
    assert (card.extra["detection_summary"]
            == cpu.extra["detection_summary"])
    assert card.extra["detection_summary"]["detections_total"] > 0
    for k, v in cpu.extra["timeline"].items():
        np.testing.assert_array_equal(np.asarray(card.extra["timeline"][k]),
                                      np.asarray(v), err_msg=k)
    assert card.extra["final_state"].view.shape == (512, 128)
    want = state_to_numpy(cpu.extra["final_state"])
    got = state_to_numpy(card.extra["final_state"])
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].reshape(want[name].shape),
                                      want[name], err_msg=name)


@pytest.mark.cuda
def test_sweep_cell_on_card_matches_cpu(cuda):
    """One phase-sweep cell (N=1024, S=16, fanout 3, 10% drops) through
    the dynamic-knob folded step: K5-K7 once per tick, the CPU's
    record."""
    from distributed_membership_tpu_torch.sweeps.phase import (
        SweepSpec, run_sweep)

    spec = SweepSpec(n=1024, view_size=16, gossip_len=4, probes=2, tfail=16,
                     tremove=40, ticks=80, fail_time=20, fanouts=(3,),
                     drop_rates=(0.1,), seeds=(1,))
    kernels.reset_launches()
    got = run_sweep(spec, device="cuda")
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "receive_folded": 80, "gossip_folded": 80, "probe_folded": 80}
    assert got == run_sweep(spec, device="cpu")
    assert got[0]["detections"] > 0


@pytest.mark.cuda
def test_campaign_journal_on_card_matches_cpu(cuda, tmp_path):
    """A 2-schedule chaos campaign at N=256 (S=16: 32 plane rows, the
    folded kernels): ``campaign.jsonl`` and the schedules equal the CPU
    campaign's, byte for byte."""
    from distributed_membership_tpu_torch.chaos import (
        CampaignSpec, run_campaign)

    spec = CampaignSpec(seed=5, schedules=2, n=256, name="card")
    files = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / device
        kernels.reset_launches()
        summary = run_campaign(spec, str(out), device=device)
        assert summary["ok"], summary
        if device == "cuda":
            assert kernels.LAUNCHES["receive_folded"] == 2 * spec.total
        files[device] = (
            (out / "campaign.jsonl").read_text().replace(str(out), "OUT"),
            {p.name: p.read_bytes()
             for p in sorted((out / "scenarios").iterdir())})
    assert files["cuda"] == files["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8])
def test_all_to_all_card_equal_cpu(cuda, d):
    """LocalMesh.all_to_all (the scatter exchange's one collective) on the
    card equals the CPU's."""
    from distributed_membership_tpu_torch.parallel.mesh import LocalMesh

    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, size=(d * d * 37, 5),
                                      dtype=np.int64).astype(np.int32))
    want = LocalMesh((d,), "cpu").all_to_all(x)
    got = LocalMesh((d,), "cuda").all_to_all(x.to(cuda))
    assert torch.equal(got.cpu(), want)


def _final_equal(card, cpu):
    from distributed_membership_tpu_torch.convert import state_to_numpy
    want = state_to_numpy(cpu.extra["final_state"])
    got = state_to_numpy(card.extra["final_state"])
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].reshape(want[name].shape),
                                      want[name], err_msg=name)


@pytest.mark.cuda
def test_sharded_scatter_run_on_card_matches_cpu(cuda, tmp_path):
    """The sharded scatter step (N=256, eight shards, staggered joins, 10%
    drops, full events): no kernel, the CPU's logs and final state."""
    from distributed_membership_tpu_torch.runtime.application import (
        run_conf)

    conf = tmp_path / "scatter.conf"
    conf.write_text(
        "MAX_NNB: 256\nSINGLE_FAILURE: 1\nVIEW_SIZE: 128\nGOSSIP_LEN: 32\n"
        "PROBES: 16\nFANOUT: 3\nTFAIL: 16\nTREMOVE: 32\nTOTAL_TIME: 70\n"
        "FAIL_TIME: 20\nJOIN_MODE: staggered\nEXCHANGE: scatter\n"
        "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8\nDROP_MSG: 1\n"
        "MSG_DROP_PROB: 0.1\nDROP_START: 5\nDROP_STOP: 50\n")
    kernels.reset_launches()
    card = run_conf(str(conf), out_dir=str(tmp_path / "cuda"), device="cuda")
    assert not any(kernels.LAUNCHES.values())
    assert card.extra["final_state"].amail.is_cuda
    cpu = run_conf(str(conf), out_dir=str(tmp_path / "cpu"), device="cpu")
    for f in ("dbg.log", "stats.log", "msgcount.log"):
        assert ((tmp_path / "cuda" / f).read_bytes()
                == (tmp_path / "cpu" / f).read_bytes()), f
    assert b" removed " in (tmp_path / "cpu" / "dbg.log").read_bytes()
    _final_equal(card, cpu)


_BATCHED = ("MAX_NNB: {n}\nSINGLE_FAILURE: 1\nDROP_MSG: 1\n"
            "MSG_DROP_PROB: 0.05\nDROP_START: 0\nDROP_STOP: 60\n"
            "VIEW_SIZE: {s}\nGOSSIP_LEN: {g}\nPROBES: {p}\nFANOUT: 3\n"
            "TFAIL: 16\nTREMOVE: 40\nTOTAL_TIME: 60\nFAIL_TIME: 8\n"
            "JOIN_MODE: warm\nEXCHANGE: ring\nEVENT_MODE: agg\n"
            "CHECKPOINT_EVERY: 16\nBACKEND: tpu_hash_sharded\n"
            "MESH_SHAPE: 8\n")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["natural", "folded"])
def test_batched_equals_legacy_on_card(cuda, tmp_path, layout):
    """EXCHANGE_MODE batched on the card: the legacy run's detection
    summary and final state, the CPU's batched run's too; K1 and K3 (K5
    and K7) once per tick, K4 (K6) never: the senders align the shifts."""
    from distributed_membership_tpu_torch.runtime.application import (
        run_conf)

    text = (_BATCHED.format(n=2048, s=128, g=32, p=16) if layout == "natural"
            else _BATCHED.format(n=4096, s=16, g=4, p=2) + "FOLDED: 1\n")
    keys = (("receive", "gossip_stacked", "probe") if layout == "natural"
            else ("receive_folded", "gossip_folded", "probe_folded"))
    runs = {}
    for mode in ("legacy", "batched"):
        conf = tmp_path / f"{mode}.conf"
        conf.write_text(text + f"EXCHANGE_MODE: {mode}\n")
        kernels.reset_launches()
        runs[mode] = run_conf(str(conf), out_dir=str(tmp_path / mode),
                              device="cuda")
        got = {k: v for k, v in kernels.LAUNCHES.items() if v}
        want = {k: 60 for k in keys}
        if mode == "batched":
            del want[keys[1]]
        assert got == want, mode
    cpu = run_conf(str(tmp_path / "batched.conf"),
                   out_dir=str(tmp_path / "cpu"), device="cpu")
    for other in (runs["legacy"], cpu):
        assert (runs["batched"].extra["detection_summary"]
                == other.extra["detection_summary"])
        _final_equal(runs["batched"], other)
    assert runs["batched"].extra["detection_summary"]["detections_total"] > 0


# ---------------------------------------------------------------------------
# The other five backends (no kernel): the plain ops on the card give the
# CPU's bits.

CONFS = (pathlib.Path(__file__).resolve().parent.parent
         / "distributed_membership_tpu_torch" / "confs")


def _same_logs(a, b):
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.cuda
@pytest.mark.parametrize("hb_hi", [1, 3])
def test_view_merge_on_card_matches_cpu(cuda, hb_hi):
    """``merge_views`` on tie-heavy rows that overflow the view (the
    stable sorts' order decides the survivors), and the mailbox
    scatter."""
    from distributed_membership_tpu_torch.ops import view_merge as vm
    rng = np.random.default_rng(hb_hi)
    n, m, q = 4096, 16, 64
    slot_id = rng.integers(0, 200, (n, m)).astype(np.int32)
    slot_id[rng.random((n, m)) < 0.2] = -1
    args = [slot_id, rng.integers(0, hb_hi, (n, m)).astype(np.int32),
            rng.integers(0, 9, (n, m)).astype(np.int32),
            rng.integers(0, 200, (n, q)).astype(np.int32),
            rng.integers(0, hb_hi, (n, q)).astype(np.int32),
            rng.random((n, q)) < 0.7, np.arange(n, dtype=np.int32) % 200,
            rng.integers(0, hb_hi + 1, n).astype(np.int32),
            rng.random(n) < 0.8]
    ar = rng.random(n) < 0.9
    cpu = vm.merge_views(*map(torch.from_numpy, args), 9,
                         torch.from_numpy(ar))
    card = vm.merge_views(*(torch.from_numpy(a).to(cuda) for a in args), 9,
                          torch.from_numpy(ar).to(cuda))
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())
    mail = torch.zeros((n, 256), dtype=torch.int32)
    msg = [torch.from_numpy(rng.integers(0, k, 50000).astype(np.int32))
           for k in (n, 5000, 40)]
    valid = torch.from_numpy(rng.random(50000) < 0.8)
    for salt in (0, 7 + 0x2545F49):
        a = vm.scatter_mailbox(mail, *msg, valid, 5000, salt=salt)
        b = vm.scatter_mailbox(mail.to(cuda), *(x.to(cuda) for x in msg),
                               valid.to(cuda), 5000, salt=salt)
        assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_sparse_run_on_card_matches_cpu(cuda, tmp_path):
    from distributed_membership_tpu_torch.runtime.application import run_conf
    conf = str(CONFS / "sparse_512_drop.conf")
    kernels.reset_launches()
    card = run_conf(conf, out_dir=str(tmp_path / "cuda"), device="cuda")
    assert not any(kernels.LAUNCHES.values())
    assert card.extra["final_state"].slot_id.is_cuda
    cpu = run_conf(conf, out_dir=str(tmp_path / "cpu"), device="cpu")
    _same_logs(tmp_path / "cuda", tmp_path / "cpu")
    for a, b in zip(card.extra["final_state"].slot_id,
                    cpu.extra["final_state"].slot_id):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_dense_runs_on_card_match_cpu(cuda, tmp_path):
    """``tpu`` and ``tpu_sharded`` on eight shards, card == CPU under
    drops; drop-free, ``replicated_rng`` on eight shards == ``tpu``."""
    from distributed_membership_tpu_torch.backends import get_backend
    from distributed_membership_tpu_torch.config import Params
    from distributed_membership_tpu_torch.eventlog import EventLog
    from distributed_membership_tpu_torch.parallel.mesh import LocalMesh
    from distributed_membership_tpu_torch.runtime.application import run_conf
    conf = CONFS / "dense_256_drop.conf"
    for dev in ("cuda", "cpu"):
        run_conf(str(conf), out_dir=str(tmp_path / dev), device=dev)
    _same_logs(tmp_path / "cuda", tmp_path / "cpu")
    text = conf.read_text().replace("BACKEND: tpu", "BACKEND: tpu_sharded")
    dbg = {}
    for dev, rep, drop in (("cuda", False, 1), ("cpu", False, 1),
                           ("cuda", True, 0)):
        p = Params.from_text(text.replace("DROP_MSG: 1",
                                          f"DROP_MSG: {drop}"))
        r = get_backend("tpu_sharded")(p, EventLog(), device=dev,
                                       mesh=LocalMesh((8,), dev),
                                       replicated_rng=rep)
        dbg[dev, rep] = r.log.dbg_text()
    assert dbg["cuda", False] == dbg["cpu", False]
    clean = Params.from_text(conf.read_text().replace("DROP_MSG: 1",
                                                      "DROP_MSG: 0"))
    dense = get_backend("tpu")(clean, EventLog(), device="cuda")
    assert dense.log.dbg_text() == dbg["cuda", True]


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["emul", "emul_native"])
def test_host_backends_under_device_cuda(cuda, backend, tmp_path):
    """The host simulators run on the host whatever the device says."""
    from distributed_membership_tpu_torch.runtime.application import run_conf
    conf = str(CONFS.parent.parent / "testcases" / "singlefailure.conf")
    for dev in ("cuda", "cpu"):
        run_conf(conf, out_dir=str(tmp_path / dev), device=dev,
                 backend=backend)
    _same_logs(tmp_path / "cuda", tmp_path / "cpu")


@pytest.mark.cuda
def test_process_mesh_collectives_on_card(cuda):
    """Two ranks on the card (gloo over CUDA tensors, staged through the
    host: NCCL takes one rank per card): every collective of the
    process mesh equals LocalMesh's on the same global tensors
    (tests/test_torch_multiproc.py's check, on CUDA tensors)."""
    from test_torch_multiproc import _free_port, _mesh_worker
    torch.multiprocessing.spawn(_mesh_worker,
                                args=(2, _free_port(), "cuda"), nprocs=2)


@pytest.mark.cuda
def test_multiproc_run_on_card_matches_cpu(cuda, tmp_path):
    """N=256 on eight shards over two processes through the launcher:
    on the card (K1, K4, K3 per process) and on the CPU, both ranks
    write the same three logs, equal to the one-process card run's."""
    import subprocess
    import sys
    from distributed_membership_tpu_torch.runtime.application import (
        run_conf)
    repo = pathlib.Path(__file__).resolve().parents[1]
    conf = (repo / "distributed_membership_tpu_torch" / "confs"
            / "ring_256_s128_sharded8_drop.conf")
    run_conf(str(conf), out_dir=str(tmp_path / "one"), device="cuda")
    for device in ("cuda", "cpu"):
        r = subprocess.run(
            [sys.executable, "-m",
             "distributed_membership_tpu_torch.multiproc_launch", str(conf),
             "--procs", "2", "--device", device, "--out-root",
             str(tmp_path / device), "--timeout", "300"], cwd=repo,
            capture_output=True, text=True, timeout=360)
        assert r.returncode == 0, (r.stdout, r.stderr)
        for i in range(2):
            for name in ("dbg.log", "stats.log", "msgcount.log"):
                assert (tmp_path / device / f"p{i}" / name).read_bytes() \
                    == (tmp_path / "one" / name).read_bytes(), (device, i,
                                                                name)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [[], ["--rack-size", "8",
                                        "--rack-failures", "4"]])
def test_scale_smoke_s64_on_card_matches_cpu(cuda, tmp_path, flags):
    """The scale smoke's S=64 geometry at N=2^14 (G=16, P=8, 120 ticks),
    one crash or four racks of 8 (AggStats): on the card the folded
    layout with K5, K6 and K7 once per tick and no other kernel; the
    record equals the CPU's in every field but timing and the card's."""
    import json

    from distributed_membership_tpu_torch import scale_smoke

    argv = ["--n", "16384", "--ticks", "120"] + flags
    recs = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"{dev}.json"
        rc = scale_smoke.main(argv + ["--device", dev, "--out", str(out)])
        assert rc == 0
        recs[dev] = json.loads(out.read_text())[-1]
    card = recs["cuda"]
    assert card["layout"] == "folded" and card["platform"] == "gpu"
    assert card["launches"] == {"receive_folded": 120, "gossip_folded": 120,
                                "probe_folded": 120}
    assert card["device"]["name"] == torch.cuda.get_device_name(0)
    skip = scale_smoke.MACHINE_FIELDS
    assert ({k: v for k, v in card.items() if k not in skip}
            == {k: v for k, v in recs["cpu"].items() if k not in skip})
    assert card["verdict_ok"] and card["detection"]["detections_total"] > 0
