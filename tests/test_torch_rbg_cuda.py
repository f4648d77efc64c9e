"""The Philox kernel (``csrc/philox.cu``) against its plain PyTorch version,
on a GPU.

Every test here needs an NVIDIA GPU and skips where
``torch.cuda.is_available()`` is false.  This file imports neither JAX
nor the JAX package (the plain version is held against jax in
``test_torch_rbg.py``), so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_rbg_cuda.py

Outputs are compared bit for bit (float32 as its int32 bits).
"""

import pytest
import torch

from distributed_membership_tpu_torch import kernels
from distributed_membership_tpu_torch.ops import rbg, threefry
from distributed_membership_tpu_torch.ops.rng_plan import hash_ring_rng

KEYS = {"seed": rbg.fold_in(rbg.seed(7, "rbg"), 11),
        "carry": rbg.RbgKey((5, 6, 0xFFFFFFFF, 0xFFFFFFFF), "rbg"),
        "unsafe": rbg.seed(3, "unsafe_rbg")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("key", list(KEYS))
@pytest.mark.parametrize("n", [1, 3, 4, 5, 1001, (1 << 20) + 3])
@pytest.mark.parametrize("start", [0, 1, 6])
def test_flat_forms(cuda, key, n, start):
    k = KEYS[key]
    kernels.reset_launches()
    _same(rbg.uniform(k, n, cuda, start), rbg.uniform_plain(k, n, "cpu",
                                                            start))
    _same(rbg.bits(k, n, cuda, start), rbg.bits_plain(k, n, "cpu", start))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["philox"] == kernels.LAUNCHES["philox_bits"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("key", list(KEYS))
@pytest.mark.parametrize("shape", [(1,), (5,), (37, 11)])
def test_indexed_form(cuda, key, shape):
    k = KEYS[key]
    gen = torch.Generator().manual_seed(sum(shape))
    idx = torch.randint(0, 1 << 34, shape, generator=gen)
    kernels.reset_launches()
    _same(rbg.uniform_at(k, idx.to(cuda)), rbg.uniform_at_plain(k, idx))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["philox_at"] == 1


@pytest.mark.cuda
def test_empty_draw_launches_nothing(cuda):
    kernels.reset_launches()
    assert rbg.uniform(KEYS["seed"], 0, cuda).numel() == 0
    assert rbg.uniform_at(KEYS["seed"], torch.zeros(
        (0,), dtype=torch.int64, device=cuda)).numel() == 0
    assert sum(kernels.LAUNCHES.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["rbg", "unsafe_rbg"])
@pytest.mark.parametrize("batched", [True, False])
def test_ring_plan_on_the_card(cuda, impl, batched):
    """A tick's whole ring plan on the card equals the CPU's, every draw
    a kernel launch (randint's two bit draws included)."""
    key = rbg.fold_in(rbg.seed(9, impl), 4)
    kw = dict(n=256, s=128, g=32, k_max=3, p_cnt=16, seed_rows=8,
              use_drop=True, need_ctrl=True, need_burst=True,
              batched=batched)
    kernels.reset_launches()
    got = hash_ring_rng(key, device=cuda, **kw)
    torch.cuda.synchronize()
    want = hash_ring_rng(key, device="cpu", **kw)
    for name in ("shift_draw", "thin_u", "ctrl_u", "burst_u", "probe_u",
                 "ack_u"):
        _same(getattr(got, name), getattr(want, name))
    for g, w in zip(got.gossip_u, want.gossip_u):
        _same(g, w)
    # Batched: thinning with the gossip coins, control, burst, probe with
    # ack; scattered: each of the eight on its own.
    assert kernels.LAUNCHES["philox"] == (4 if batched else 8)
    assert kernels.LAUNCHES["philox_bits"] == 2
    assert threefry.randint(key, (3,), 1, 256, cuda).is_cuda
