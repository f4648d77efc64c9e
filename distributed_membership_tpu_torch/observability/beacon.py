"""One beacon format for every side-channel status file (counterpart of
the JAX package's ``observability/beacon.py``).

``replica_<i>.json`` (service/replica.py) and ``service.json``
(service/daemon.py) are small JSON dicts renamed atomically next to the
run so an uncoordinated reader can poll them; this module is their one
writer/reader pair.

Schema: every beacon is one JSON object with two reserved keys added
by the writer —

  ``v``     schema version (``BEACON_VERSION``); readers reject
            versions NEWER than they know (a newer writer may have
            changed field meaning) and accept anything older or
            missing (pre-unification files still parse during a
            mixed-version fleet recovery),
  ``time``  ``time.time()`` at write, the staleness clock.

Tolerance contract (the same posture as the timeline readers): a
missing file, a torn/garbage file, or a stale ``time`` all read as
``None`` — beacons are advisory, and a reader must never crash or
block on one.  Liveness is optional and explicit: pass
``require_pid="pid"`` and a beacon whose pid is dead reads as None
(the fleet scheduler's port-discovery contract).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

BEACON_VERSION = 1


def write_beacon(path: str, doc: dict) -> bool:
    """Atomically publish ``doc`` (plus ``v``/``time``) at ``path``.

    tmp + ``os.replace`` so a reader never sees a half-written file;
    the tmp name carries the pid so two writers (e.g. a stale worker
    and its replacement) cannot collide on it.  Best-effort: returns
    False instead of raising on OSError (a full disk must not kill a
    beacon thread, let alone the engine).
    """
    out = dict(doc)
    out.setdefault("v", BEACON_VERSION)
    out.setdefault("time", time.time())
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as fh:
            json.dump(out, fh)
        os.replace(tmp, path)
        return True
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def pid_alive(pid) -> bool:
    try:
        os.kill(int(pid), 0)
        return True
    except (OSError, TypeError, ValueError):
        return False


def read_beacon(path: str, max_age_s: Optional[float] = None,
                require_pid: Optional[str] = None) -> Optional[dict]:
    """→ the beacon dict, or None if missing/torn/stale/dead.

    ``max_age_s`` bounds ``time.time() - doc["time"]`` (a beacon
    without a time field fails any age bound — it cannot prove
    freshness).  ``require_pid`` names the field holding the writer's
    pid; a dead or absent pid reads as None.
    """
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError, ValueError):
        return None
    if not isinstance(doc, dict):
        return None
    v = doc.get("v", 0)
    if isinstance(v, (int, float)) and v > BEACON_VERSION:
        return None
    if max_age_s is not None:
        ts = doc.get("time")
        if not isinstance(ts, (int, float)):
            return None
        if time.time() - ts > max_age_s:
            return None
    if require_pid is not None and not pid_alive(doc.get(require_pid)):
        return None
    return doc
