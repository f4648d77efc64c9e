"""Fleet migration policy (counterpart of the JAX package's
``elastic/migrate.py``): which health signals move a run.

A migration is two journaled, fsync-before-ACK registry transitions —
``migrating`` (with the trigger rule and the tick the fleet last saw
the run alive at) then ``requeued`` (with the durable tick the resume
will start from) — after which the ordinary dispatch path relaunches
the run wherever the placement model says it fits.  Downtime in ticks
is ``from_tick - resume_tick``: the work between the last durable
boundary and the last observed beacon, recomputed bit-exactly on
resume.

Triggers (``FLEET_MIGRATE_ON``, comma list; '' = manual only):

* ``death``        the worker process died and left a durable
                   checkpoint (or a restartable chunked run).
* ``alerts``       watchdog alert rules (observability/watchdog.py)
                   fired in the run's runlog since this worker started
                   — the run is alive but degrading, so drain it
                   gracefully (SIGTERM -> boundary checkpoint).
* ``stale-beacon`` the progress beacon stopped advancing: the worker
                   is wedged, SIGKILL it and adopt the last durable
                   boundary.

``FLEET_MIGRATE_MAX`` caps AUTOMATIC migrations per run (a run that
keeps dying lands terminal instead of thrashing); manual operator
drains (``POST /v1/runs/<id>/migrate``) are always allowed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

TRIGGERS = ("death", "alerts", "stale-beacon")

# Watchdog rules that mean "this run should move", as opposed to rules
# that indicate a query-side wobble the run itself will survive.
DEFAULT_ALERT_RULES = ("tick_rate_collapse", "detection_slo")

__all__ = ["TRIGGERS", "MigratePolicy", "migrate_record", "alert_count"]


@dataclasses.dataclass(frozen=True)
class MigratePolicy:
    triggers: frozenset = frozenset()
    max_migrations: int = 2
    stale_beacon_s: float = 15.0
    alert_rules: tuple = DEFAULT_ALERT_RULES

    @classmethod
    def from_conf(cls, migrate_on: str,
                  max_migrations: int = 2,
                  stale_beacon_s: float = 15.0) -> "MigratePolicy":
        """Parse FLEET_MIGRATE_ON/_MAX; loud on unknown trigger names
        (config.validate repeats this check for conf-borne values)."""
        names = frozenset(p.strip() for p in migrate_on.split(",")
                          if p.strip())
        bad = sorted(names - frozenset(TRIGGERS))
        if bad:
            raise ValueError(
                f"FLEET_MIGRATE_ON: unknown trigger(s) {bad!r} — "
                f"choose from {', '.join(TRIGGERS)}")
        if max_migrations < 0:
            raise ValueError(
                f"FLEET_MIGRATE_MAX must be >= 0, got {max_migrations!r}")
        return cls(triggers=names, max_migrations=int(max_migrations),
                   stale_beacon_s=float(stale_beacon_s))

    @property
    def on_death(self) -> bool:
        return "death" in self.triggers

    def sick_trigger(self, *, run_dir: str, beacon: Optional[dict],
                     total: int,
                     started_wall: float) -> Optional[str]:
        """The live-worker trigger evaluation (scheduler poll loop):
        returns a trigger name or None.  Alert rows older than
        ``started_wall`` belong to a previous incarnation of this run
        dir and never re-trigger a fresh worker."""
        if "alerts" in self.triggers and alert_count(
                run_dir, self.alert_rules, since=started_wall) > 0:
            return "alerts"
        if ("stale-beacon" in self.triggers and beacon is not None
                and int(beacon.get("tick", 0)) < int(total)
                and time.time() - float(beacon.get("ts", 0.0))
                > self.stale_beacon_s):
            return "stale-beacon"
        return None


def alert_count(run_dir: str, rules=DEFAULT_ALERT_RULES,
                since: float = 0.0) -> int:
    """Watchdog alert records in ``<run_dir>/runlog.jsonl`` matching
    ``rules`` and newer than ``since`` (torn-line tolerant, same
    posture as every JSONL reader in the repo)."""
    path = os.path.join(run_dir, "runlog.jsonl")
    if not os.path.exists(path):
        return 0
    count = 0
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if (row.get("kind") == "alert"
                        and row.get("rule") in rules
                        and float(row.get("ts", 0.0) or 0.0) >= since):
                    count += 1
    except OSError:
        return 0
    return count


def migrate_record(registry, rec, trigger: str, *,
                   from_tick: Optional[int] = None) -> dict:
    """Journal one migration: ``migrating`` -> ``requeued`` (both
    fsynced before the registry returns — the same ACK discipline as
    every other transition).  ``from_tick`` is where the fleet last saw
    the run alive (beacon); ``rec.tick`` already holds the durable
    manifest tick the resume starts from.  Returns the detail row the
    reporter renders (trigger, from/resume ticks, downtime)."""
    seen = int(rec.tick if from_tick is None else from_tick)
    resume_tick = int(rec.tick)
    registry.set_state(rec, "migrating", trigger=trigger,
                       from_tick=seen, tick=resume_tick)
    registry.set_state(rec, "requeued", trigger=trigger,
                       from_tick=seen, resume_tick=resume_tick,
                       tick=resume_tick)
    rec.migrate_requested = False
    return {"trigger": trigger, "from_tick": seen,
            "resume_tick": resume_tick,
            "downtime_ticks": max(seen - resume_tick, 0)}
