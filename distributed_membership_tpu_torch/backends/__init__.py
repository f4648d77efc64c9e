"""Backend registry (the JAX package's ``backends/__init__.py``).

A backend turns ``Params`` into a completed run.  The port implements
``tpu_hash`` and ``tpu_hash_sharded`` (ring exchange, warm join); the
conf's ``BACKEND:`` key names the same backends as the JAX package, and
the others are refused.
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
    "tpu_hash": "distributed_membership_tpu_torch.backends.tpu_hash",
    "tpu_hash_sharded":
        "distributed_membership_tpu_torch.backends.tpu_hash_sharded",
}


def register(name: str):
    def deco(fn: BackendFn) -> BackendFn:
        _REGISTRY[name] = fn
        return fn
    return deco


def get_backend(name: str) -> BackendFn:
    if name not in _MODULES:
        raise NotImplementedError(
            f"BACKEND {name!r} is not ported yet (the port runs tpu_hash "
            "and tpu_hash_sharded; ROADMAP.md Queue 1 item 11)")
    if name not in _REGISTRY:
        importlib.import_module(_MODULES[name])
    return _REGISTRY[name]
