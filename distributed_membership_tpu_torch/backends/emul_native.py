"""`emul_native` backend: the host simulator core in C++ (the JAX
package's ``backends/emul_native.py``).

The whole tick loop -- network buffer, protocol, sweep, gossip -- runs in
the port's own copy of ``native/emul_engine.cpp``, compiled at first use
with the host C++ compiler (``g++``, else ``c++``) into ``_build/``
under a hash of the source, and loaded through ctypes.  Python keeps
config parsing, failure planning, the dbg.log format (eventlog.py) and
grading.  Like ``emul`` it runs on the host whatever ``--device`` says.

The engine streams the (joined/removed) protocol events back in one
buffer; :func:`_replay_log` interleaves them with the application's own
lines (APP, Starting up group/Trying to join, @@time beacons, failure
notices) so the log inventory matches the ``emul`` backend's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import random as _pyrandom
import shutil
import subprocess
import threading
import time as _time
from typing import Optional

import numpy as np

from distributed_membership_tpu_torch.addressing import INTRODUCER_INDEX
from distributed_membership_tpu_torch.backends import RunResult, register
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.eventlog import EventLog
from distributed_membership_tpu_torch.runtime.failures import (
    log_failures, resolve_plan)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "emul_engine.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_LOCK = threading.Lock()
_LIB = None
BUILD_SECONDS: list = []    # wall time of each build this process made


class DmConfig(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int32), ("total_time", ctypes.c_int32),
        ("tfail", ctypes.c_int32), ("tremove", ctypes.c_int32),
        ("fanout", ctypes.c_int32), ("fail_time", ctypes.c_int32),
        ("drop_start", ctypes.c_int32), ("drop_stop", ctypes.c_int32),
        ("drop_pct", ctypes.c_int32),
        ("en_buffsize", ctypes.c_int64), ("max_msg_size", ctypes.c_int64),
        ("join_mode", ctypes.c_int32),
        ("step_rate", ctypes.c_double), ("seed", ctypes.c_uint64),
    ]


def _compiler() -> str:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) on PATH; "
                           "emul_native builds native/emul_engine.cpp at "
                           "first use")
    return cxx


def library_path() -> str:
    """``_build/emul_engine_<hash>.so``: named by the source's content,
    so an edit rebuilds and a stale library is never loaded."""
    with open(SRC, "rb") as fh:
        tag = hashlib.sha1(fh.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"emul_engine_{tag}.so")


def build() -> str:
    """Compile the engine unless its library exists; returns its path.
    The compile writes a per-process temporary name, renamed into place,
    so processes building at once never load a half-written library."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = _time.perf_counter()
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([_compiler(), "-O2", "-std=c++17", "-shared",
                           "-fPIC", "-o", tmp, SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native engine build failed:\n{proc.stderr}")
    os.replace(tmp, so)
    BUILD_SECONDS.append(_time.perf_counter() - t0)
    return so


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.dm_run.restype = ctypes.c_int
            lib.dm_run.argtypes = [
                ctypes.POINTER(DmConfig),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
            ]
            _LIB = lib
    return _LIB


def _as_ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


@register("emul_native")
def run_emul_native(params: Params, log: Optional[EventLog] = None,
                    seed: Optional[int] = None, device=None) -> RunResult:
    """The run, in the engine; ``device`` is accepted and ignored."""
    t0 = _time.time()
    seed = params.SEED if seed is None else seed
    log = log if log is not None else EventLog()
    # The failure plan's stream of every backend: the same seed crashes
    # the same nodes.
    plan = resolve_plan(params, _pyrandom.Random(f"app:{seed}"))

    n = params.EN_GPSZ
    total = params.TOTAL_TIME
    cfg = DmConfig(
        n=n, total_time=total, tfail=params.TFAIL, tremove=params.TREMOVE,
        fanout=params.FANOUT,
        fail_time=plan.fail_time if plan.fail_time is not None else -1,
        drop_start=plan.drop_start if plan.drop_start is not None else -1,
        drop_stop=plan.drop_stop if plan.drop_stop is not None else -1,
        drop_pct=params.drop_pct(),
        en_buffsize=params.EN_BUFFSIZE, max_msg_size=params.MAX_MSG_SIZE,
        join_mode=1 if params.JOIN_MODE == "batch" else 0,
        step_rate=params.STEP_RATE, seed=seed & (2**64 - 1),
    )

    fail_mask = np.zeros((n,), dtype=np.uint8)
    if plan.fail_time is not None:
        fail_mask[plan.failed_indices] = 1
    sent = np.zeros((n, total), dtype=np.int32)
    recv = np.zeros((n, total), dtype=np.int32)
    # joins are bounded by n per logger view + churn; removes likewise.
    events_cap = 4 * n * n + 4096
    events = np.zeros((events_cap, 4), dtype=np.int32)
    n_events = ctypes.c_int64(0)

    rc = _lib().dm_run(
        ctypes.byref(cfg), _as_ptr(fail_mask, ctypes.c_uint8),
        _as_ptr(sent, ctypes.c_int32), _as_ptr(recv, ctypes.c_int32),
        _as_ptr(events, ctypes.c_int32), events_cap, ctypes.byref(n_events))
    if rc != 0:
        raise RuntimeError("native engine event buffer overflowed")

    _replay_log(params, plan, events[:n_events.value], log)

    return RunResult(
        params=params, log=log, sent=sent, recv=recv,
        failed_indices=plan.failed_indices if plan.fail_time is not None else [],
        fail_time=plan.fail_time,
        wall_seconds=_time.time() - t0,
        extra={"native": True},
    )


def _replay_log(params: Params, plan, events: np.ndarray,
                log: EventLog) -> None:
    """Interleave engine events with the application's own lines,
    matching the `emul` backend's inventory (Application.cpp:67,143-148,156-160,184,192)."""
    n = params.EN_GPSZ
    starts = [params.start_tick(i) for i in range(n)]
    for i in range(n):
        log.log(i + 1, 0, "APP")

    by_tick: dict = {}
    for kind, logger, subject, tick in events:
        by_tick.setdefault(int(tick), []).append(
            (int(kind), int(logger), int(subject)))

    intro_failed = (plan.fail_time is not None
                    and INTRODUCER_INDEX in plan.failed_indices)
    for t in range(params.TOTAL_TIME):
        for i in range(n - 1, -1, -1):
            if starts[i] == t:
                if i == INTRODUCER_INDEX:
                    log.log(i + 1, t, "Starting up group...")
                else:
                    log.log(i + 1, t, "Trying to join...")
        for kind, logger, subject, in by_tick.get(t, ()):
            if kind == 0:
                log.node_add(logger, subject, t)
            else:
                log.node_remove(logger, subject, t)
        if (t % 500 == 0 and t > starts[INTRODUCER_INDEX]
                and not (intro_failed and t > plan.fail_time)):
            log.log(INTRODUCER_INDEX + 1, t, f"@@time={t}")
        if plan.fail_time == t:
            log_failures(plan, log, t)
