"""K2's and K4's plain versions on rows wider than one 16 KiB tile
(S > 4096, the full membership list past 4096 nodes) against the JAX
package, bit for bit.

The CUDA kernels' wide-row tiles (row chunks of 4096 columns, the last
one ragged at S = 4224 and S = 12416) are held on a GPU against
``gossip_plain`` and ``gossip_stacked_plain`` (``tests/test_torch_cuda.py``,
``chip_smoke.py``), so these pin the plain forms at those widths to the
JAX step's own delivery:

* K2: the ring step's ``deliver_shift`` loop (``backends/tpu_hash.py``),
  gated by ``j < k_eff`` or by per-shift masks, as
  ``tests/test_torch_kernels.py`` does for the two-column case;
* K4: the sharded ring step's per-shift tail
  (``backends/tpu_hash_sharded.py``, the unfused branch) on each of D = 3
  shards: a roll of the shard's rows by ``c_j``, a column roll by that
  shard's ``s1``/``s2``, the wrapped rows ``l < c_j`` taking ``s2``.

The wrappers get CPU tensors, so they run the plain versions and launch
nothing.  Outputs are integers: tolerance 0.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from distributed_membership_tpu.backends.tpu_hash import deliver_shift
from distributed_membership_tpu_torch import kernels
from distributed_membership_tpu_torch.ops.fused_gossip import (
    gossip_fused, gossip_fused_stacked, gossip_plain, gossip_stacked_plain,
    wide_form)
from distributed_membership_tpu_torch.ops.view_merge import STRIDE

K_MAX = 3


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


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _eq(got, want, what):
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want), err_msg=what)


def _k2_reference(n, s, mail, payload, k_eff, shifts, masks):
    """The JAX ring step's delivery: per shift, the gated payload through
    ``deliver_shift``, maxed into the mailbox."""
    want = jnp.asarray(mail)
    idx = jnp.arange(n, dtype=jnp.int32)
    for j in range(K_MAX):
        keep = (j < k_eff)[:, None] if masks is None else masks[j]
        send = jnp.where(keep, payload, np.uint32(0))
        want = jnp.maximum(want, deliver_shift(
            send, jnp.asarray(shifts[j]), n, s, STRIDE % s, idx))
    return want


def _k4_reference(n_local, s, mail, payloads, c, s1, s2, masks):
    """The JAX sharded step's unfused per-shift tail on every shard."""
    d = mail.shape[0] // n_local
    l_idx = jnp.arange(n_local, dtype=jnp.int32)
    out = []
    for i in range(d):
        rows = slice(i * n_local, (i + 1) * n_local)
        m = jnp.asarray(mail[rows])
        for j in range(K_MAX):
            send = payloads[0 if payloads.shape[0] == 1 else j][rows]
            if masks is not None:
                send = np.where(masks[j][rows], send, np.uint32(0))
            rolled = jnp.roll(jnp.asarray(send), int(c[j]), axis=0)
            r1 = jnp.roll(rolled, int(s1[i, j]), axis=1)
            r2 = jnp.roll(rolled, int(s2[i, j]), axis=1)
            m = jnp.maximum(m, jnp.where((l_idx >= c[j])[:, None], r1, r2))
        out.append(np.asarray(m))
    return np.concatenate(out)


# (rows, S): a ragged last chunk of 128 columns (4224 = 4096 + 128), two
# whole chunks, and three chunks plus 128 (12416); the row counts are not
# multiples of anything, and rows * STRIDE % S != 0, so the wrapped rows
# take the second column alignment.
SIZES = [(33, 4224), (17, 8192), (9, 12416)]


@pytest.mark.parametrize("n,s", SIZES)
@pytest.mark.parametrize("form", ["k_eff", "masks", "stacked",
                                  "stacked_masks"])
def test_wide_rows_match_jax(form, n, s, no_launch):
    assert wide_form(s) and s % 128 == 0
    rng = np.random.default_rng(n * s + len(form))
    if form in ("k_eff", "masks"):
        assert (n * STRIDE) % s != 0
        mail = _packed(rng, n, 0.5, (n, s))
        view = _packed(rng, n, 0.8, (n, s))
        k_eff = rng.integers(0, K_MAX + 1, size=n, dtype=np.int32)
        # Shifts whose column rotations are not multiples of 4 (a sender
        # run off a 16-byte bound) and one past N (taken mod N).
        shifts = np.array([1, n - 1, n + 4], np.int32)
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
    else:
        d, n_local = 3, n
        rows = d * n_local
        assert (n_local * STRIDE) % s != 0
        mail = _packed(rng, rows, 0.5, (rows, s))
        c = np.array([n_local - 1, 0, n_local // 3], np.int32)
        s1 = rng.integers(0, s, size=(d, K_MAX)).astype(np.int32)
        s2 = rng.integers(0, s, size=(d, K_MAX)).astype(np.int32)
        s1[0, 0], s2[0, 0] = 4097, 3          # runs off a 16-byte bound
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
