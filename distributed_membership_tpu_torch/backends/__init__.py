"""Backend registry (the JAX package's ``backends/__init__.py``).

A backend turns ``Params`` into a completed run; the conf's ``BACKEND:``
key selects one of the JAX package's seven:

* ``emul``        -- the queue-level host simulator (executable spec);
* ``emul_native`` -- the same semantics, C++ core via ctypes;
* ``tpu``         -- the dense ``[N, N]`` step;
* ``tpu_sharded`` -- the dense step on a mesh of node shards;
* ``tpu_sparse``  -- exact bounded member views (sorted merge);
* ``tpu_hash``    -- hash-slotted bounded views: the scale path;
* ``tpu_hash_sharded`` -- ``tpu_hash`` on a mesh of node shards.

The two ``emul`` backends run on the host whatever the device; the
others run on the run's device (a card, or the CPU when asked).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, List, Optional

import numpy as np

from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.eventlog import EventLog


@dataclasses.dataclass
class RunResult:
    """Everything a completed run produces.  ``sent``/``recv`` are
    ``[N, T]`` counts (``[N, 1]`` totals in aggregate runs), mirroring the
    reference's msgcount matrices (EmulNet.h:83-84)."""

    params: Params
    log: EventLog
    sent: np.ndarray
    recv: np.ndarray
    failed_indices: List[int]
    fail_time: Optional[int]
    wall_seconds: float = 0.0
    extra: Dict[str, object] = dataclasses.field(default_factory=dict)


BackendFn = Callable[..., RunResult]

_REGISTRY: Dict[str, BackendFn] = {}
_MODULES = {
    name: f"distributed_membership_tpu_torch.backends.{name}"
    for name in ("emul", "emul_native", "tpu", "tpu_sharded", "tpu_sparse",
                 "tpu_hash", "tpu_hash_sharded")}


def register(name: str):
    def deco(fn: BackendFn) -> BackendFn:
        _REGISTRY[name] = fn
        return fn
    return deco


def get_backend(name: str) -> BackendFn:
    if name not in _REGISTRY:
        if name not in _MODULES:
            raise NotImplementedError(
                f"backend {name!r} is not available "
                f"(known: {sorted(_MODULES)})")
        importlib.import_module(_MODULES[name])
    return _REGISTRY[name]
