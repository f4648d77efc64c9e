"""Run registry + durable submission journal (``fleet_runs.jsonl``;
counterpart of the JAX package's ``fleet/registry.py``).

The journal is the fleet's source of truth, with the same durability
discipline as service/events.py: a submission is appended + fsynced
BEFORE the 202 ACK leaves the controller, so a SIGKILL after the ACK
cannot lose an accepted run.  Two record kinds, one JSON object per
line:

  {"kind": "submit", "run_id", "conf", "seed", "priority",
   "scenario", "seq", "ts"}
  {"kind": "state", "run_id", "state", "ts", ...detail}

Replaying the journal rebuilds the registry; :meth:`Registry.recover`
then reconciles each run against its on-disk reality (checkpoint
manifest + artifacts), because journaled state goes stale the moment
the controller dies mid-sweep: a run journaled ``running`` may have
finished (re-adopt from its manifest) or stopped at a checkpoint
boundary (requeue with ``--resume`` — bit-exact, the worker is the
port's chunked driver).  Reads are torn-line tolerant, the same
posture as every JSONL reader in the repo.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Dict, List, Optional

from distributed_membership_tpu_torch.config import Params

JOURNAL_NAME = "fleet_runs.jsonl"
RUN_STATES = ("queued", "running", "checkpointed", "done", "failed",
              "killed", "migrating", "requeued")
_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

# Forced on chunkable workers whose conf leaves CHECKPOINT_EVERY at 0:
# without a boundary there is nothing to pause at, resume from, or
# serve between.  Trajectory-inert (pinned by tests/test_checkpoint.py).
DEFAULT_CHECKPOINT_EVERY = 25

_CHUNKABLE = ("tpu", "tpu_sparse", "tpu_hash", "tpu_hash_sharded")


@dataclasses.dataclass
class RunRecord:
    """One submitted run: journaled identity + live scheduler state."""

    run_id: str
    conf_text: str
    seed: int
    priority: int = 0          # lower runs first; FIFO (seq) within
    seq: int = 0
    scenario: Optional[object] = None   # inline scenario JSON payload
    state: str = "queued"
    submitted_at: float = 0.0
    # Derived from conf_text at construction (cheap reparse, never
    # journaled separately — the conf line is the durable copy).
    backend: str = ""
    total: int = 0
    mode: str = "headless"     # serve | headless-ck | headless
    # Live scheduler fields (refreshed by the running controller; after
    # a crash they are rebuilt from journal detail + disk probing).
    pid: Optional[int] = None
    port: Optional[int] = None
    tick: int = 0
    exit_code: Optional[int] = None
    error: str = ""
    pausing: bool = False
    killing: bool = False
    adopted: bool = False      # recovered from disk, not run by us
    # Elastic-mesh migration (elastic/migrate.py): automatic-migration
    # count (the FLEET_MIGRATE_MAX cap; manual drains don't count),
    # last trigger rule, and the operator/policy drain flag.
    migrations: int = 0
    last_trigger: str = ""
    migrate_requested: bool = False

    def run_dir(self, root: str) -> str:
        return os.path.join(root, self.run_id)

    def ckpt_dir(self, root: str) -> str:
        return os.path.join(self.run_dir(root), "ck")

    def public(self) -> dict:
        """The JSON face served by GET /v1/runs."""
        out = {
            "run_id": self.run_id,
            "state": self.state,
            "backend": self.backend,
            "mode": self.mode,
            "seed": self.seed,
            "priority": self.priority,
            "tick": self.tick,
            "total": self.total,
            "submitted_at": self.submitted_at,
        }
        if self.pid is not None:
            out["pid"] = self.pid
        if self.port is not None:
            out["port"] = self.port
        if self.exit_code is not None:
            out["exit_code"] = self.exit_code
        if self.error:
            out["error"] = self.error
        if self.pausing:
            out["pausing"] = True
        if self.killing:
            out["killing"] = True
        if self.adopted:
            out["adopted"] = True
        if self.migrations:
            out["migrations"] = self.migrations
        if self.last_trigger:
            out["last_trigger"] = self.last_trigger
        return out


def plan_mode(params: Params) -> str:
    """How a worker for this (validated) conf can run.

    ``serve``       ring-family + chunked: the whole service surface on an
                    ephemeral port, proxied under /v1/runs/<id>/.
    ``headless-ck`` chunked but not servable: pause/resume/crash
                    recovery work (checkpoints), no live queries.
    ``headless``    no chunked driver (emul & friends): the run is
                    atomic — kill loses it, pause is refused.

    Probed by validating a mutated COPY, so the answer is exactly what
    the worker's own ``validate()`` will say (no second rule set).
    """
    if params.BACKEND in _CHUNKABLE:
        cand = dataclasses.replace(params)
        cand.SERVICE_PORT = 0
        if cand.CHECKPOINT_EVERY <= 0:
            cand.CHECKPOINT_EVERY = DEFAULT_CHECKPOINT_EVERY
        if cand.TELEMETRY == "off":
            cand.TELEMETRY = "scalars"
        try:
            cand.validate()
            return "serve"
        except ValueError:
            return "headless-ck"
    return "headless"


class FleetJournal:
    """Append-only JSONL, fsynced per append, torn-tolerant reads."""

    def __init__(self, path: str):
        self.path = path

    def append(self, record: dict) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a+b") as fh:
            fh.seek(0, os.SEEK_END)
            lead = b""
            if fh.tell() > 0:
                # A SIGKILLed controller can leave a torn final line;
                # appending straight onto it would weld the torn
                # fragment and THIS record into one unparseable line,
                # losing both.  A newline first quarantines the tear.
                fh.seek(-1, os.SEEK_END)
                if fh.read(1) != b"\n":
                    lead = b"\n"
            fh.write(lead + json.dumps(record).encode() + b"\n")
            fh.flush()
            os.fsync(fh.fileno())

    def read(self) -> List[dict]:
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue        # torn trailing write
        return out


def _build_record(rec_json: dict) -> RunRecord:
    """Submit-record JSON → RunRecord with derived fields reparsed."""
    rec = RunRecord(
        run_id=rec_json["run_id"],
        conf_text=rec_json["conf"],
        seed=int(rec_json["seed"]),
        priority=int(rec_json.get("priority", 0)),
        seq=int(rec_json.get("seq", 0)),
        scenario=rec_json.get("scenario"),
        submitted_at=float(rec_json.get("ts", 0.0)),
    )
    params = Params().parse(rec.conf_text, validate=False)
    params.validate()
    rec.backend = params.BACKEND
    rec.total = params.TOTAL_TIME
    rec.mode = plan_mode(params)
    return rec


class Registry:
    """In-memory run table + its durable journal.

    NOT thread-safe by itself: the fleet daemon serializes access
    behind FleetState's lock (handler threads and the scheduler loop
    both mutate records).
    """

    def __init__(self, root: str):
        self.root = root
        self.journal = FleetJournal(os.path.join(root, JOURNAL_NAME))
        self.runs: Dict[str, RunRecord] = {}
        self._seq = 0

    # -- submission ----------------------------------------------------
    def validate_submission(self, conf_text: str,
                            run_id: Optional[str]) -> Params:
        """Raises ValueError on a conf/id the fleet must refuse."""
        if run_id is not None:
            if not _ID_RE.match(run_id):
                raise ValueError(
                    f"run_id {run_id!r} must match {_ID_RE.pattern}")
            if run_id in self.runs:
                raise ValueError(f"run_id {run_id!r} already exists")
        probe = Params()
        known = 0
        for line in conf_text.splitlines():
            m = re.match(r"([A-Za-z_][A-Za-z0-9_]*)\s*:", line.strip())
            if m and hasattr(probe, m.group(1)):
                known += 1
        if not known:
            # Params.parse ignores unknown lines by design, so pure
            # garbage would otherwise run the DEFAULT simulation.
            raise ValueError("conf text sets no recognized KEY: value "
                             "lines")
        params = Params().parse(conf_text, validate=False)
        params.validate()
        return params

    def submit(self, conf_text: str, seed: Optional[int] = None,
               priority: int = 0, scenario=None,
               run_id: Optional[str] = None) -> RunRecord:
        """Journal (fsync) + register a run; call BEFORE the 202 ACK."""
        params = self.validate_submission(conf_text, run_id)
        self._seq += 1
        rid = run_id or f"r{self._seq:04d}"
        while rid in self.runs:        # journal gaps after recovery
            self._seq += 1
            rid = f"r{self._seq:04d}"
        rec_json = {
            "kind": "submit", "run_id": rid, "conf": conf_text,
            "seed": int(params.SEED if seed is None else seed),
            "priority": int(priority), "scenario": scenario,
            "seq": self._seq, "ts": time.time(),
        }
        self.journal.append(rec_json)
        rec = _build_record(rec_json)
        self.runs[rid] = rec
        return rec

    # -- state transitions ---------------------------------------------
    def set_state(self, rec: RunRecord, state: str, **detail) -> None:
        """Mutate + journal a transition (crash-recovery breadcrumb)."""
        assert state in RUN_STATES, state
        rec.state = state
        for k, v in detail.items():
            setattr(rec, k, v)
        if state == "migrating":
            # Counted here (and in replay) so the FLEET_MIGRATE_MAX cap
            # survives a controller crash; manual drains are exempt.
            rec.last_trigger = str(detail.get("trigger", ""))
            if rec.last_trigger != "manual":
                rec.migrations += 1
        row = {"kind": "state", "run_id": rec.run_id, "state": state,
               "ts": time.time()}
        for k in ("pid", "port", "exit_code", "error", "tick",
                  "trigger", "from_tick", "resume_tick"):
            v = detail.get(k)
            if v not in (None, ""):
                row[k] = v
        self.journal.append(row)

    def update_conf(self, rec: RunRecord, conf_text: str) -> None:
        """Journal + apply a conf rewrite (elastic migration retarget:
        placement pinned the run to a slice with a different mesh
        shape).  Validated first; journaled fsync-before-apply so a
        recovered controller rebuilds the SAME conf the resharded
        checkpoint expects."""
        params = Params().parse(conf_text, validate=False)
        params.validate()
        self.journal.append({"kind": "conf_update", "run_id": rec.run_id,
                             "conf": conf_text, "ts": time.time()})
        rec.conf_text = conf_text
        rec.backend = params.BACKEND
        rec.total = params.TOTAL_TIME
        rec.mode = plan_mode(params)

    def queued(self, key=None) -> List[RunRecord]:
        """Queued runs in dispatch order: priority, then submit FIFO."""
        q = [r for r in self.runs.values()
             if r.state in ("queued", "requeued")]
        q.sort(key=key or (lambda r: (r.priority, r.seq)))
        return q

    def listing(self) -> List[dict]:
        return [self.runs[k].public()
                for k in sorted(self.runs,
                                key=lambda k: self.runs[k].seq)]

    # -- crash recovery ------------------------------------------------
    def _probe_disk(self, rec: RunRecord) -> str:
        """Ground truth for a run whose journaled state may be stale.

        The manifest is authoritative for PROGRESS (its tick is only
        advanced after a durable checkpoint); artifacts are
        authoritative for COMPLETION (the driver flushes dbg.log after
        the final tick).  manifest at total + artifacts -> done
        (re-adopt, nothing to recompute).  manifest at total but no
        artifacts (killed inside the artifact flush) -> queued: a
        ``--resume`` from tick==total runs zero segments and just
        re-emits the artifacts, bit-exactly.  Any earlier manifest ->
        queued for ``--resume``.  No manifest -> queued from scratch
        (nothing durable happened).
        """
        run_dir = rec.run_dir(self.root)
        from distributed_membership_tpu_torch.runtime.checkpoint import (
            manifest_tick)
        mt = manifest_tick(rec.ckpt_dir(self.root))
        rec.tick = int(mt) if mt is not None else 0
        done = (rec.tick >= rec.total
                and os.path.exists(os.path.join(run_dir, "dbg.log")))
        if rec.mode == "headless":
            # No chunked driver: artifacts are the only durable trace.
            done = os.path.exists(os.path.join(run_dir, "dbg.log"))
            if done:
                rec.tick = rec.total
        return "done" if done else "queued"

    def recover(self) -> dict:
        """Replay the journal, then reconcile every run with disk.

        Returns a summary dict (counts per outcome) for the startup
        banner.  Terminal journaled states (done/failed/killed and an
        operator-paused checkpointed) are kept; queued/running runs are
        re-dispatched — running ones via the disk probe above, so a
        finished-but-unjournaled run is adopted instead of re-run.
        """
        for row in self.journal.read():
            kind = row.get("kind")
            if kind == "submit":
                try:
                    rec = _build_record(row)
                except (KeyError, ValueError, TypeError):
                    continue        # journal from a newer/older schema
                self.runs[rec.run_id] = rec
                self._seq = max(self._seq, rec.seq)
            elif kind == "state":
                rec = self.runs.get(row.get("run_id"))
                if rec is None or row.get("state") not in RUN_STATES:
                    continue
                rec.state = row["state"]
                rec.tick = int(row.get("tick", rec.tick))
                rec.exit_code = row.get("exit_code", rec.exit_code)
                rec.error = row.get("error", rec.error)
                if row["state"] == "migrating":
                    rec.last_trigger = str(row.get("trigger", ""))
                    if rec.last_trigger != "manual":
                        rec.migrations += 1
            elif kind == "conf_update":
                rec = self.runs.get(row.get("run_id"))
                if rec is None or not row.get("conf"):
                    continue
                try:
                    params = Params().parse(row["conf"], validate=False)
                    params.validate()
                except ValueError:
                    continue
                rec.conf_text = row["conf"]
                rec.backend = params.BACKEND
                rec.total = params.TOTAL_TIME
                rec.mode = plan_mode(params)
        summary = {"adopted": 0, "requeued": 0, "kept": 0}
        for rec in self.runs.values():
            rec.pid = rec.port = None     # no worker survives us
            rec.pausing = rec.killing = False
            rec.migrate_requested = False
            if rec.state in ("running", "queued", "migrating",
                             "requeued"):
                probed = self._probe_disk(rec)
                if probed == "done":
                    rec.adopted = True
                    self.set_state(rec, "done", tick=rec.tick)
                    summary["adopted"] += 1
                else:
                    if rec.state != "queued":
                        self.set_state(rec, "queued", tick=rec.tick)
                    summary["requeued"] += 1
            else:
                summary["kept"] += 1
        return summary
