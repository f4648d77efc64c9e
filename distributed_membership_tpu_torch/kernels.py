"""Build, load and count the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, on first use, into ``_build/``
(named by a hash of the sources, so an edit rebuilds).  All sources are
compiled in parallel, one ``nvcc`` each.  The libraries are loaded with
``ctypes``: pointers and the stream travel as ``c_void_p``, and every C
entry point returns ``cudaGetLastError()`` after its launch, which
:func:`check` turns into an exception.

``LAUNCHES`` counts the kernel launches of each wrapper, per operand form
(the probe kernels' form with the TELEMETRY hist partials counts as
``probe_hist`` / ``probe_folded_hist``, K1's with an admit plane as
``receive_admit``, K2's and K4's wide-row body as ``gossip_wide`` and
``gossip_stacked_wide``; the Philox draws of ops/rbg.py as ``philox``,
``philox_bits`` and ``philox_at``); a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
SOURCES = {"receive": "receive.cu", "gossip": "gossip.cu",
           "probe": "probe.cu", "receive_folded": "receive_folded.cu",
           "gossip_folded": "gossip_folded.cu",
           "probe_folded": "probe_folded.cu",
           "gossip_stacked": "gossip_stacked.cu", "philox": "philox.cu"}
HEADERS = ("common.cuh", "receive_one.cuh", "probe_parts.cuh",
           "gossip_tile.cuh")

LAUNCHES: Dict[str, int] = {
    "receive": 0, "receive_admit": 0, "gossip": 0, "gossip_masks": 0, "probe": 0,
    "probe_hist": 0, "receive_folded": 0, "gossip_folded": 0,
    "gossip_folded_masks": 0, "probe_folded": 0, "probe_folded_hist": 0,
    "gossip_stacked": 0, "gossip_stacked_masks": 0, "gossip_wide": 0,
    "gossip_wide_masks": 0, "gossip_stacked_wide": 0,
    "gossip_stacked_wide_masks": 0, "philox": 0, "philox_bits": 0,
    "philox_at": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}   # ptxas report per source, last build


class FailIds(ctypes.Structure):
    """The probe kernel's by-value array of up to 8 failed ids."""
    _fields_ = [("ids", ctypes.c_int * 8)]


_P, _I, _LL, _U, _ULL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_uint, ctypes.c_ulonglong)
_SIGNATURES = {
    "dm_receive": [_I, _U, _I, _I, _I, _I, _LL, _I] + [_P] * 14,
    "dm_gossip": [_U, _I, _I, _I, _I] + [_P] * 6,
    "dm_probe": [_I, _I, _U, _I, _I, _I, _LL, _I, _P, _P, _P, _P, _I,
                 FailIds] + [_P] * 6,
    "dm_receive_folded": [_I, _U, _I, _I, _I, _I, _LL, _I] + [_P] * 11,
    "dm_gossip_folded": [_I] * 6 + [_P] * 7,
    "dm_probe_folded": [_I, _I, _U, _I, _I, _I, _LL, _I, _P, _P, _P, _P,
                        _I, FailIds] + [_P] * 7,
    "dm_gossip_stacked": [_LL] + [_I] * 5 + [_P] * 7,
    "dm_philox": [_I] + [_U] * 4 + [_ULL, _LL] + [_P] * 3,
}
_ENTRY = {name: f"dm_{name}" for name in SOURCES}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH); the "
                           "CUDA kernels are built from csrc/ at first use")
    return path


def _digest() -> str:
    h = hashlib.sha1()
    for name in sorted(SOURCES.values()) + sorted(HEADERS):
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + fh.read())
    return h.hexdigest()[:12]


def build(ptxas_report: bool = False) -> float:
    """Compile every source not yet built (all in parallel); returns the
    seconds spent.  With ``ptxas_report`` the register and spill report
    of each source lands in ``BUILD_LOG``."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = _digest()
    procs = {}
    for name, src in SOURCES.items():
        out = os.path.join(BUILD_DIR, f"{name}_{tag}.so")
        if os.path.exists(out) and not ptxas_report:
            continue
        # A per-process temporary name, renamed into place when done, so
        # processes building at once never load a half-written library.
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", tmp, os.path.join(CSRC, src)]
        if ptxas_report:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building all sources first if
    needed."""
    if name not in _LIBS:
        build()
        lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"{name}_{_digest()}.so"))
        fn = getattr(lib, _ENTRY[name])
        fn.argtypes = _SIGNATURES[_ENTRY[name]]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name!r} launch failed: "
                           f"cudaError {rc}")


def require(cond: bool, what: str) -> None:
    """Wrapper argument check (device, dtype, shape, contiguity)."""
    if not cond:
        raise ValueError(what)


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
