"""Whole runs under ``PRNG_IMPL: rbg|unsafe_rbg``, by their logs: the port
against the JAX package, tolerance 0.

Every tick's events and message counts (what ``dbg.log``, ``stats.log``
and ``msgcount.log`` are written from) for the natural ring step with
drops, a hoisted chunked run (one vmapped draw a segment), the sharded
ring step on eight shards with warm and with staggered joins, the
scatter exchange, and the dense ``tpu`` and ``tpu_sharded`` and the
``tpu_sparse`` backends at N <= 256.  Per-tick state is in
``test_torch_rbg_paths.py``.
"""

import warnings

import numpy as np
import pytest

import torch

from distributed_membership_tpu.backends import get_backend as jax_backend
from distributed_membership_tpu.config import Params as JaxParams
from distributed_membership_tpu.parallel.mesh import make_mesh
from distributed_membership_tpu_torch.backends import get_backend
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.parallel.mesh import LocalMesh

from test_torch_ring_options import _conf

IMPLS = ["rbg", "unsafe_rbg"]
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DENSE = ("MAX_NNB: {n}\nSINGLE_FAILURE: 1\nDROP_MSG: 1\nMSG_DROP_PROB: 0.1\n"
         "BACKEND: {backend}\nFANOUT: 3\nTFAIL: 5\nTREMOVE: 20\n"
         "TOTAL_TIME: 45\nFAIL_TIME: 20\nDROP_START: 5\nDROP_STOP: 40\n"
         "JOIN_MODE: batch\n")
SPARSE = ("MAX_NNB: 128\nSINGLE_FAILURE: 1\nDROP_MSG: 1\nMSG_DROP_PROB: 0.1\n"
          "BACKEND: tpu_sparse\nVIEW_SIZE: 16\nGOSSIP_LEN: 4\nPROBES: 2\n"
          "FANOUT: 3\nTFAIL: 8\nTREMOVE: 32\nTOTAL_TIME: 48\nFAIL_TIME: 8\n"
          "DROP_START: 5\nDROP_STOP: 30\nJOIN_MODE: warm\n")
SHARDED8 = "BACKEND: tpu_hash_sharded\nMESH_SHAPE: 8"
RUN_CASES = {
    # the natural ring step, full events, 5% drops
    "tpu_hash": _conf(drop=0.05, total=50),
    # hoisted plans in 16-tick segments (one vmapped draw a segment)
    "hoisted": _conf(drop=0.05, total=48, extra="CHECKPOINT_EVERY: 16\n"
                     "RNG_MODE: hoisted\n"),
    # the sharded ring step on eight shards, warm and staggered joins
    "sharded8": _conf(drop=0.05, total=50).replace(
        "BACKEND: tpu_hash", SHARDED8),
    "sharded8_staggered": _conf(total=60, join="staggered", drop=0.05)
    .replace("BACKEND: tpu_hash", SHARDED8),
    # the scatter exchange (staggered joins)
    "scatter": _conf(n=64, s=64, g=16, p=8, total=60, join="staggered",
                     drop=0.05).replace("EXCHANGE: ring", "EXCHANGE: scatter"),
    "tpu": DENSE.format(n=128, backend="tpu"),
    "tpu_sharded": DENSE.format(n=128, backend="tpu_sharded"),
    "tpu_sparse": SPARSE,
}


@pytest.mark.parametrize("case", list(RUN_CASES))
@pytest.mark.parametrize("impl", IMPLS)
def test_runs_match_jax(impl, case):
    """Every tick's events and message counts, through the logs."""
    conf = RUN_CASES[case] + f"PRNG_IMPL: {impl}\n"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp, pp = JaxParams.from_text(conf), Params.from_text(conf)
    kw_j, kw_p = {}, {}
    if case == "tpu_sharded":
        kw_j, kw_p = {"mesh": make_mesh(8)}, {"mesh": LocalMesh((8,), "cpu")}
    want = jax_backend(jp.BACKEND)(jp, seed=SEED, **kw_j)
    got = get_backend(pp.BACKEND)(pp, seed=SEED, device="cpu", **kw_p)
    assert got.log.dbg_text() == want.log.dbg_text()
    np.testing.assert_array_equal(got.sent, want.sent)
    np.testing.assert_array_equal(got.recv, want.recv)
    assert " removed " in got.log.dbg_text()
