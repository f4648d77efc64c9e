"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU and skips where
``torch.cuda.is_available()`` is false.  This file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX).  Outputs
are integers and must be equal, bit for bit.
"""

import numpy as np
import pytest
import torch

from distributed_membership_tpu_torch import kernels
from distributed_membership_tpu_torch.ops.fused_gossip import (
    gossip_fused, gossip_plain)
from distributed_membership_tpu_torch.ops.fused_probe import (
    probe_plain, probe_window_fused)
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
@pytest.mark.parametrize("form", ["k_eff", "masks"])
@pytest.mark.parametrize("n", [4096, 96])      # 96: wrapped-row columns
def test_gossip_kernel(cuda, form, n):
    k_max = 3
    rng = np.random.default_rng(n)
    mail = _packed(rng, n, 0.5, (n, S)).to(cuda)
    view = _packed(rng, n, 0.8, (n, S)).to(cuda)
    k_eff = torch.from_numpy(
        rng.integers(0, k_max + 1, size=n, dtype=np.int32)).to(cuda)
    masks = (_flags(rng, k_max * n * S, 0.7).reshape(k_max, n, S).to(cuda)
             if form == "masks" else None)
    payload = view if form == "masks" else torch.where(
        _flags(rng, n * S, 0.3).reshape(n, S).to(cuda), view, 0)
    shifts = torch.tensor([1, n - 1, 37], dtype=torch.int32, device=cuda)
    want = gossip_plain(n, S, k_max, mail, payload, k_eff, shifts, masks)
    kernels.reset_launches()
    got = gossip_fused(n, S, k_max, mail.clone(), payload, k_eff, shifts,
                       masks=masks)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gossip" if form == "k_eff"
                            else "gossip_masks"] == 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["agg", "hist", "ids"])
@pytest.mark.parametrize("ptr", [120, 32])
def test_probe_kernel(cuda, mode, ptr):
    n, t = 4096, 37
    rng = np.random.default_rng(ptr)
    view = _packed(rng, n, 0.7, (n, S)).to(cuda)
    view_ts = torch.from_numpy(
        rng.integers(0, t + 3, size=(n, S), dtype=np.int32)).to(cuda)
    rm = torch.from_numpy(np.where(
        rng.random((n, S)) < 0.1, rng.integers(0, 8, size=(n, S)),
        -1).astype(np.int32)).to(cuda)
    act = _flags(rng, n, 0.9).to(cuda)
    hist, agg = mode == "hist", mode == "agg"
    args = (16, TFAIL, (3, 5) if agg else (), hist, agg, t, ptr, 0, view,
            view_ts if hist else None, act, rm if agg else None)
    want = probe_plain(n, S, *args)
    got = probe_window_fused(n, S, *args)
    torch.cuda.synchronize()
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
    assert kernels.LAUNCHES == {"receive": 80, "gossip": 0,
                                "gossip_masks": 80, "probe": 80}
    run_conf(str(conf), out_dir=str(tmp_path / "cpu"), device="cpu")
    for name in ("dbg.log", "stats.log", "msgcount.log"):
        assert ((tmp_path / "cuda" / name).read_bytes()
                == (tmp_path / "cpu" / name).read_bytes()), name
