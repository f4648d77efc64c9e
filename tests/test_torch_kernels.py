"""The port's three ring-step kernels against the JAX package's Pallas
kernels, bit for bit.

* K1 ``receive_fused``, K2 ``gossip_fused`` (``k_eff`` and ``masks``
  forms) and K3 ``probe_window_fused`` (agg and hist partials): the port's
  wrappers on CPU tensors (which run the plain PyTorch versions) against
  the Pallas kernels run in interpret mode, as ``tests/test_fused_*.py``
  run them, on the same numpy-seeded inputs.  The outputs are integers,
  so the tolerance is 0.
* The inputs cover the u32 corners the port must get right: packed
  values above 2^31 (unsigned order), empty entries (``0 - 1`` wraps
  before the modulo), and shifts at 1 and N - 1.
* The CUDA kernels themselves are held against the plain versions on a
  GPU by ``tests/test_torch_cuda.py`` and, at N = 2^20, by
  ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from distributed_membership_tpu.ops import fused_gossip as jax_gossip
from distributed_membership_tpu.ops import fused_probe as jax_probe
from distributed_membership_tpu.ops import fused_receive as jax_receive
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


def _packed(rng, n, occ, shape):
    """Packed u32 ``hb * n + id + 1`` entries over the whole u32 range
    (heartbeats up to (2^32 - n) / n), 0 where unoccupied."""
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
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.fixture
def no_launch():
    """A wrapper given CPU tensors runs the plain version and launches
    nothing."""
    kernels.reset_launches()
    yield
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES


# ---------------------------------------------------------------------------
# K1 receive


def _receive_inputs(n, t, seed):
    rng = np.random.default_rng(seed)
    view = _packed(rng, n, 0.7, (n, S))
    view_ts = rng.integers(0, t + 1, size=(n, S), dtype=np.int32)
    mail = _packed(rng, n, 0.4, (n, S))
    # Candidates: some match the view's occupant with a higher heartbeat,
    # the rest are random entries or empty.
    bump = np.where(view > 0, view.astype(np.int64) + n * rng.integers(
        -2, 3, size=(n, S)), 0)
    bump = np.where((bump > 0) & (bump < 2**32), bump, 0).astype(np.uint32)
    cand = np.where(rng.random((n, S)) < 0.3, bump,
                    np.where(rng.random((n, S)) < 0.1,
                             _packed(rng, n, 1.0, (n, S)), 0))
    # Mail aimed at the self slot: own id (admitted) or a foreign id.
    recv = rng.random(n) < 0.9
    act = rng.random(n) < 0.9
    self_on = act & (rng.random(n) < 0.95)
    own_hb = rng.integers(1, 2 * t + 3, size=n)
    self_pack = np.where(self_on, own_hb * n + np.arange(n) + 1,
                         0).astype(np.uint32)
    return view, view_ts, mail, cand, recv, act, self_on, self_pack


@pytest.mark.parametrize("n,t", [(64, 45), (256, 60), (256, 3)])
def test_receive_matches_pallas(n, t, no_launch):
    view, view_ts, mail, cand, recv, act, self_on, spack = \
        _receive_inputs(n, t, seed=n + t)
    want = jax_receive.receive_fused(
        n, S, TFAIL, TREMOVE, STRIDE, True, jnp.asarray(t, jnp.int32),
        view, view_ts, mail, cand, recv, act, self_on, spack,
        jnp.arange(n, dtype=jnp.int32))
    args = (_bits(view), torch.from_numpy(view_ts), _bits(mail),
            _bits(cand), torch.from_numpy(recv), torch.from_numpy(act),
            torch.from_numpy(self_on), _bits(spack))
    names = ("view", "view_ts", "mail", "join", "rm_ids", "numfailed",
             "size")
    for fn in (receive_core, receive_fused):
        got = fn(n, S, TFAIL, TREMOVE, STRIDE, t,
                 *(a.clone() for a in args))
        for name, g, w in zip(names, got, want):
            _eq(g, w, f"{fn.__name__}: {name}")
    # Every branch of the pass was exercised (removals need t >= TREMOVE).
    _, _, _, join, rm_ids, numfailed, _ = want
    assert np.asarray(join).any()
    assert (np.asarray(rm_ids) >= 0).any() == (t >= TREMOVE)
    assert np.asarray(numfailed).any() == (t >= TFAIL)


def test_receive_self_slot_overflow_free():
    """The self slot is computed modularly: ``node * (1 + STRIDE)``
    overflows int32 above ~271k nodes, so a row offset there must still
    land on ``(node % S) * ((1 + STRIDE) % S) % S``."""
    n, rows, row0 = 1 << 20, 4, (1 << 20) - 4
    view = torch.zeros((rows, S), dtype=torch.int32)
    node = np.arange(row0, row0 + rows, dtype=np.int64)
    spack = _bits(((3 * n + node + 1) & 0xFFFFFFFF).astype(np.uint32))
    ones = torch.ones((rows,), dtype=torch.bool)
    out = receive_core(n, S, TFAIL, TREMOVE, STRIDE, 5, view,
                       torch.zeros((rows, S), dtype=torch.int32),
                       torch.zeros((rows, S), dtype=torch.int32),
                       torch.zeros((rows, S), dtype=torch.int32),
                       ones, ones, ones, spack, row0=row0)
    slots = (node % S) * ((1 + STRIDE) % S) % S
    for r in range(rows):
        assert torch.nonzero(out[0][r]).flatten().tolist() == [slots[r]]


def test_receive_wrapper_checks_arguments():
    n = 64
    view, view_ts, mail, cand, recv, act, self_on, spack = \
        _receive_inputs(n, 5, seed=1)
    args = [_bits(view), torch.from_numpy(view_ts), _bits(mail),
            _bits(cand), torch.from_numpy(recv), torch.from_numpy(act),
            torch.from_numpy(self_on), _bits(spack)]
    bad = list(args)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(ValueError, match="receive"):
        receive_fused(n, S, TFAIL, TREMOVE, STRIDE, 5, *bad)
    bad = list(args)
    bad[0] = bad[0].t().contiguous().t()
    with pytest.raises(ValueError, match="receive"):
        receive_fused(n, S, TFAIL, TREMOVE, STRIDE, 5, *bad)


# ---------------------------------------------------------------------------
# K2 gossip


def _gossip_inputs(n, k_max, seed):
    rng = np.random.default_rng(seed)
    mail = _packed(rng, n, 0.5, (n, S))
    view = _packed(rng, n, 0.8, (n, S))
    payload = np.where(rng.random((n, S)) < 0.3, view, 0).astype(np.uint32)
    k_eff = rng.integers(0, k_max + 1, size=n, dtype=np.int32)
    keep = rng.random((k_max, n, S)) < 0.7
    masks = keep & (np.arange(k_max)[:, None, None] < k_eff[None, :, None])
    return mail, view, payload, k_eff, masks


def _gossip_reference(n, k_max, mail, payload, k_eff, shifts, masks):
    """The JAX kernel where it takes the shape (``(N * STRIDE) % S ==
    0``), else the JAX step's own ``deliver_shift`` loop, whose wrapped
    receiver rows take the second column alignment (N = 64 at S = 128)."""
    if jax_gossip.gossip_fused_supported(n, S):
        return jax_gossip.gossip_fused(
            n, S, k_max, True, mail, payload, k_eff, shifts,
            masks=None if masks is None else masks.astype(np.int32))
    from distributed_membership_tpu.backends.tpu_hash import deliver_shift

    want = jnp.asarray(mail)
    idx = jnp.arange(n, dtype=jnp.int32)
    for j in range(k_max):
        keep = ((j < k_eff)[:, None] if masks is None else masks[j])
        send = jnp.where(keep, payload, np.uint32(0))
        want = jnp.maximum(want, deliver_shift(
            send, jnp.asarray(shifts[j]), n, S, STRIDE % S, idx))
    return want


@pytest.mark.parametrize("n,k_max,shifts", [
    (64, 3, None), (64, 2, [1, 63]), (256, 3, None), (256, 2, [1, 255]),
    (256, 3, [255, 1, 128]), (128, 1, [127])])
def test_gossip_keff_matches_jax(n, k_max, shifts, no_launch):
    mail, _, payload, k_eff, _ = _gossip_inputs(n, k_max, seed=n * k_max)
    if shifts is None:
        shifts = np.random.default_rng(n).integers(1, n, size=k_max)
    shifts = np.asarray(shifts, np.int32)
    want = _gossip_reference(n, k_max, mail, payload, k_eff, shifts, None)
    for fn in (gossip_plain, gossip_fused):
        got = fn(n, S, k_max, _bits(mail), _bits(payload),
                 torch.from_numpy(k_eff), torch.from_numpy(shifts))
        _eq(got, want, fn.__name__)


@pytest.mark.parametrize("n,k_max,shifts", [
    (64, 3, None), (256, 3, [1, 255, 77]), (256, 2, [128, 129])])
def test_gossip_masks_matches_jax(n, k_max, shifts, no_launch):
    mail, view, _, k_eff, masks = _gossip_inputs(n, k_max, seed=7 + n)
    if shifts is None:
        shifts = np.random.default_rng(n + 1).integers(1, n, size=k_max)
    shifts = np.asarray(shifts, np.int32)
    want = _gossip_reference(n, k_max, mail, view, k_eff, shifts, masks)
    for fn in (gossip_plain, gossip_fused):
        got = fn(n, S, k_max, _bits(mail), _bits(view), None,
                 torch.from_numpy(shifts), torch.from_numpy(masks))
        _eq(got, want, fn.__name__)


def test_gossip_wrapper_checks_arguments():
    n = 64
    mail, view, payload, k_eff, masks = _gossip_inputs(n, 2, seed=2)
    shifts = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="k_eff"):
        gossip_fused(n, S, 2, _bits(mail), _bits(payload),
                     torch.from_numpy(k_eff).to(torch.int64), shifts)
    with pytest.raises(ValueError, match="masks"):
        gossip_fused(n, S, 2, _bits(mail), _bits(view), None, shifts,
                     masks=torch.from_numpy(masks).to(torch.int32))


# ---------------------------------------------------------------------------
# K3 probe window


def _probe_inputs(n, t, seed, s=S):
    rng = np.random.default_rng(seed)
    view = _packed(rng, n, 0.7, (n, s))
    # A sprinkle of self entries (never a probe target) and of time
    # stamps after t (negative ages clamp into bucket 0).
    self_pack = (np.arange(n) + 1).astype(np.uint32)
    view = np.where(rng.random((n, s)) < 0.05, self_pack[:, None], view)
    view_ts = rng.integers(0, t + 3, size=(n, s), dtype=np.int32)
    act = rng.random(n) < 0.9
    rm = np.where(rng.random((n, s)) < 0.1,
                  rng.integers(0, 8, size=(n, s)), -1).astype(np.int32)
    return view, view_ts, act, rm


# (N, t, ptr, S, fail ids): the CUDA kernel's cases -- no fail id, all
# eight (its compile-time counts), and S=130, whose rows it reads one
# word at a time -- besides windows that wrap and that do not.
@pytest.mark.parametrize("n,t,ptr,s,fail_ids", [
    pytest.param(64, 37, 80, S, (3, 5, 7), id="64-37-80"),
    pytest.param(256, 9, 120, S, (3, 5, 7), id="256-9-120"),
    pytest.param(256, 100, 0, S, (3, 5, 7), id="256-100-0"),
    pytest.param(64, 5, 127, S, (3, 5, 7), id="64-5-127"),
    pytest.param(64, 37, 80, S, (), id="64-37-80-nofail"),
    pytest.param(64, 37, 80, S, tuple(range(7, -1, -1)), id="64-37-80-f8"),
    pytest.param(64, 9, 120, 130, (3, 5, 7), id="64-9-120-s130"),
])
@pytest.mark.parametrize("mode", ["agg", "hist"])
def test_probe_matches_pallas(n, t, ptr, s, fail_ids, mode, no_launch):
    p_cnt = 16
    want_hist, want_agg = mode == "hist", mode == "agg"
    view, view_ts, act, rm = _probe_inputs(n, t, seed=n + t + ptr, s=s)
    want = jax_probe.probe_window_fused(
        n, s, p_cnt, TFAIL, fail_ids if want_agg else (), want_hist,
        want_agg, True, jnp.asarray(t, jnp.int32),
        jnp.asarray(ptr, jnp.int32), jnp.zeros((), jnp.int32), view,
        view_ts if want_hist else None, act, rm if want_agg else None)
    for fn in (probe_plain, probe_window_fused):
        got = fn(n, s, p_cnt, TFAIL, fail_ids if want_agg else (),
                 want_hist, want_agg, t, ptr, 0, _bits(view),
                 torch.from_numpy(view_ts) if want_hist else None,
                 torch.from_numpy(act),
                 torch.from_numpy(rm) if want_agg else None)
        ids = np.asarray(want["ids"])[:, :p_cnt]
        _eq(got["ids"], ids.view(np.int32), f"{fn.__name__}: ids")
        assert (ids > 0).any()
        if want_hist:
            _eq(got["stale_rows"], want["stale_rows"], "stale_rows")
            _eq(got["susp_rows"], want["susp_rows"], "susp_rows")
        else:
            assert set(got) == {"ids", "rm_cnt", "det"}
            _eq(got["rm_cnt"], np.asarray(want["rm_cnt"])[:, 0], "rm_cnt")
            _eq(got["det"], np.asarray([np.asarray(d)[:, 0]
                                        for d in want["det_cols"]],
                                       np.int32).reshape(-1, n), "det")


def test_probe_wrapper_checks_arguments():
    n = 64
    view, view_ts, act, rm = _probe_inputs(n, 5, seed=4)
    with pytest.raises(ValueError, match="ptr"):
        probe_window_fused(n, S, 16, TFAIL, (), False, False, 5, S, 0,
                           _bits(view), None, torch.from_numpy(act), None)
    with pytest.raises(ValueError, match="rm_ids"):
        probe_window_fused(n, S, 16, TFAIL, (3,), False, True, 5, 0, 0,
                           _bits(view), None, torch.from_numpy(act), None)
    with pytest.raises(ValueError, match="fail ids"):
        probe_window_fused(n, S, 16, TFAIL, tuple(range(9)), False, True,
                           5, 0, 0, _bits(view), None,
                           torch.from_numpy(act), torch.from_numpy(rm))


# ---------------------------------------------------------------------------
# The kernel build (kernels.py), with a stand-in for nvcc: one process per
# source, outputs named by the sources' digest, failures reported.


def _fake_nvcc(tmp_path, rc):
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do\n"
        '  if [ "$1" = "-o" ]; then out="$2"; fi; shift\n'
        "done\n"
        'echo "ptxas info    : Used 10 registers"\n'
        f'[ {rc} -eq 0 ] && echo lib > "$out"\n'
        f"exit {rc}\n")
    script.chmod(0o755)
    return str(script)


def test_build_compiles_every_source(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    nvcc = _fake_nvcc(tmp_path, 0)
    monkeypatch.setattr(kernels, "_nvcc", lambda: nvcc)
    kernels.build(ptxas_report=True)
    tag = kernels._digest()
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert built == sorted(f"{name}_{tag}.so" for name in kernels.SOURCES)
    assert all("registers" in kernels.BUILD_LOG[name]
               for name in kernels.SOURCES)
    # Built libraries are not rebuilt.
    (tmp_path / "broken").mkdir()
    broken = _fake_nvcc(tmp_path / "broken", 1)
    monkeypatch.setattr(kernels, "_nvcc", lambda: broken)
    kernels.build()


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    nvcc = _fake_nvcc(tmp_path, 2)
    monkeypatch.setattr(kernels, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="nvcc exited 2"):
        kernels.build()
    assert not list((tmp_path / "build").glob("*.so"))
