"""Device-aware placement (counterpart of the JAX package's
``fleet/placement.py``): the capacity model behind scheduling choices.

One fleet drives a mixed host: sharded runs want a whole device slice
to themselves (a mesh collective sharing chips with another mesh
collective deadlocks or thrashes — pin DISJOINT slices), small CPU runs
want to pack many-per-host without oversubscribing cores.  This module
is the pure model: slices, cores, who holds what, and LOUD refusals
naming the exhausted resource.  The scheduler consults it at launch and
the migration policy consults it to choose a target — a migrated run
lands where capacity says it fits, not wherever the queue happened to
drain.

Deliberately free of psutil/topology probing: capacity is declared
(``HostCapacity(cores=..., slices=...)``) so tests and single-host
fleets state exactly what exists.  ``HostCapacity.local()`` builds the
obvious single-host default.

On the card a slice is a group of shard slots of one device: the port's
sharded backend holds all ``prod(MESH_SHAPE)`` shards of a run on the
one H100 (parallel/mesh.py ``LocalMesh``), so a slice of ``devices``
slots with ``mesh_shape`` says how many shards a run pinned to it keeps
on that card and in which shape it resumes.  The model itself never
probes a device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

__all__ = ["PlacementError", "DeviceSlice", "Placement", "HostCapacity"]


class PlacementError(ValueError):
    """No capacity for this run — the message names the exhausted
    resource and current holders, so an operator (or the migration
    policy) sees exactly why the run stays queued."""


@dataclasses.dataclass(frozen=True)
class DeviceSlice:
    """A schedulable group of devices (a group of LocalMesh shard slots
    on the card, or a block of them on a CPU host).  ``mesh_shape`` is the shape a sharded run
    pinned here should resume on ('' = let the backend auto-mesh)."""
    name: str
    devices: int
    mesh_shape: str = ""


@dataclasses.dataclass(frozen=True)
class Placement:
    """One run's granted claim: a whole slice (sharded) or N cores."""
    run_id: str
    kind: str                      # "slice" | "cores"
    slice_name: str = ""
    devices: int = 0
    cores: int = 0
    mesh_shape: str = ""


@dataclasses.dataclass
class HostCapacity:
    cores: int = 0
    slices: Tuple[DeviceSlice, ...] = ()
    held: Dict[str, Placement] = dataclasses.field(default_factory=dict)

    @classmethod
    def local(cls, devices: int = 0,
              slice_devices: int = 0) -> "HostCapacity":
        """Single-host default: every core schedulable, the local
        devices carved into equal slices of ``slice_devices`` (0 = one
        slice holding everything)."""
        cores = os.cpu_count() or 1
        slices = []
        if devices > 0:
            per = slice_devices or devices
            slices = [DeviceSlice(name=f"slice{i}", devices=per)
                      for i in range(max(devices // per, 1))]
        return cls(cores=cores, slices=tuple(slices))

    # -- bookkeeping ----------------------------------------------------
    def cores_used(self) -> int:
        return sum(p.cores for p in self.held.values()
                   if p.kind == "cores")

    def slice_holder(self, name: str) -> Optional[str]:
        for p in self.held.values():
            if p.kind == "slice" and p.slice_name == name:
                return p.run_id
        return None

    def free_slices(self) -> Tuple[DeviceSlice, ...]:
        return tuple(s for s in self.slices
                     if self.slice_holder(s.name) is None)

    # -- the model ------------------------------------------------------
    def place(self, run_id: str, *, sharded: bool = False,
              devices: int = 1, cores: int = 1) -> Placement:
        """Grant capacity or raise :class:`PlacementError`.  Sharded
        runs get a whole free slice (best fit: the smallest slice with
        enough devices — big slices stay free for big runs); CPU runs
        pack onto cores.  Idempotent per ``run_id``: re-placing an
        already-held run returns the existing claim."""
        if run_id in self.held:
            return self.held[run_id]
        if sharded:
            fits = sorted((s for s in self.free_slices()
                           if s.devices >= max(devices, 1)),
                          key=lambda s: s.devices)
            if not fits:
                holders = {s.name: self.slice_holder(s.name)
                           for s in self.slices}
                raise PlacementError(
                    f"no free device slice with >= {devices} device(s) "
                    f"for sharded run {run_id!r}: slices {holders} "
                    "(sharded runs pin disjoint slices; free one or "
                    "add capacity)")
            s = fits[0]
            p = Placement(run_id=run_id, kind="slice",
                          slice_name=s.name, devices=s.devices,
                          mesh_shape=s.mesh_shape)
        else:
            want = max(cores, 1)
            used = self.cores_used()
            if used + want > self.cores:
                raise PlacementError(
                    f"core capacity exhausted for run {run_id!r}: "
                    f"wants {want}, {used}/{self.cores} cores already "
                    "packed (small CPU runs share cores but never "
                    "oversubscribe)")
            p = Placement(run_id=run_id, kind="cores", cores=want)
        self.held[run_id] = p
        return p

    def release(self, run_id: str) -> None:
        self.held.pop(run_id, None)

    def summary(self) -> dict:
        return {
            "cores": self.cores, "cores_used": self.cores_used(),
            "slices": [{"name": s.name, "devices": s.devices,
                        "held_by": self.slice_holder(s.name)}
                       for s in self.slices],
        }
