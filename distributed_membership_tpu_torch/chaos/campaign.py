"""Campaign runner: fan fuzzed schedules out, grade, journal, shrink
(counterpart of the JAX package's ``chaos/campaign.py``).

A campaign is ``spec.schedules`` runs of the SAME conf under different
fuzzed chaos schedules (chaos/fuzz.py), each graded by the scenario
oracle's hard invariant verdicts (scenario/oracle.py).  Two execution
modes share the grading and journaling tail:

  * **inproc** — every run executes in this process through the port's
    backend (``backends.get_backend``) on ``device``: the card unless
    the caller asks for the CPU.  On the card an S < 128 campaign runs
    the folded layout (K5-K7), with FastAgg up to 8 permanently failed
    ids and AggStats beyond; a geometry the kernels cannot take (the
    default N=10, so VIEW_SIZE 10) raises the port's refusal on the
    first run.  Each run draws its RNG plans a segment at a time
    (``RNG_MODE: hoisted`` in ``HOIST_EVERY``-tick segments, see
    :func:`_lowered`): the same trajectory, in a third of a tick's
    launches.
  * **fleet** — schedules ship inline to a ``--fleet`` controller
    (sweeps/fleet_submit.py: retrying submit, terminal-state wait) and
    verdicts are graded from each run dir's ``scenario.json`` oracle
    report (the worker's finish_run writes it — the controller's
    ring-family workers always run with ``--telemetry-dir``).

Every graded run appends one line to ``campaign.jsonl`` — write +
flush + fsync per line, so a reader (scripts/run_report.py --watch) or
a crashed campaign never sees more than one torn line, and
:func:`read_journal` skips it.  Violating schedules are delta-debugged
to a minimal repro (chaos/shrink.py) and banked with the campaign
digest + seed; the journal records the shrink start and the banked
path, so a watcher shows "currently shrinking" honestly.

``campaign.jsonl``, ``scenarios/*.json`` and banked repros are the JAX
package's bytes for the same spec and overrides: none carries a wall
time or a device.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional

from distributed_membership_tpu_torch.chaos.fuzz import (
    CampaignSpec, campaign_digest, dump_schedule, fuzz_schedule,
    schedule_digest)
from distributed_membership_tpu_torch.chaos.shrink import (
    bank_repro, shrink_schedule)

#: Conf the campaign grades against; spec fields fill the blanks.
#: tpu_hash + ring + warm join + agg events + scalar telemetry is the
#: cheapest config that exercises the full scenario vocabulary AND
#: records the series the oracle grades from.
_CONF_TEMPLATE = (
    "MAX_NNB: {n}\nSINGLE_FAILURE: 0\nDROP_MSG: 0\nMSG_DROP_PROB: 0\n"
    "VIEW_SIZE: {view}\nGOSSIP_LEN: {gossip}\nPROBES: {probes}\nFANOUT: 2\n"
    "TFAIL: {tfail}\nTREMOVE: {tremove}\nTOTAL_TIME: {total}\n"
    "JOIN_MODE: warm\nEVENT_MODE: agg\nEXCHANGE: ring\n"
    "TELEMETRY: scalars\nBACKEND: tpu_hash\n")


def base_conf(spec: CampaignSpec, overrides: Optional[dict] = None) -> str:
    """The campaign's conf text; ``overrides`` lets a caller grade a
    DELIBERATELY broken config (the acceptance exercise: TREMOVE <
    TFAIL must produce violations that shrink to banked repros)."""
    from distributed_membership_tpu_torch.sweeps.fleet_submit import (
        override_conf)
    view = max(4, min(16, spec.n // 2 * 2))
    # Probe rate scaled so a full view refresh fits >= 4 times inside
    # TREMOVE (config.py's probe-cycle floor) at any campaign N.
    probes = max(2, -(-view * 4 // max(1, spec.tremove)))
    conf = _CONF_TEMPLATE.format(n=spec.n, total=spec.total,
                                 tfail=spec.tfail, tremove=spec.tremove,
                                 view=view, gossip=max(2, view // 2),
                                 probes=probes)
    for k, v in sorted((overrides or {}).items()):
        conf = override_conf(conf, k, v)
    return conf


# Ticks per segment of a campaign run, whose RNG plans are drawn at once.
HOIST_EVERY = 32


def _lowered(conf_text: str):
    """``Params`` of ``conf_text`` with ``RNG_MODE: hoisted``, in
    ``HOIST_EVERY``-tick segments unless the conf sets ``CHECKPOINT_EVERY``
    (no snapshot is written without ``CHECKPOINT_DIR``).  The mode is a
    lowering (the trajectory, series and oracle report are the per-tick
    draw's), so the journal stays the JAX package's; its gate (single-chip
    ``tpu_hash`` on the ring exchange) leaves other confs as they are."""
    from distributed_membership_tpu_torch.config import Params
    from distributed_membership_tpu_torch.sweeps.fleet_submit import (
        override_conf)
    params = Params.from_text(conf_text)
    if (params.BACKEND != "tpu_hash" or params.RNG_MODE != "batched"
            or params.resolved_exchange() != "ring"):
        return params
    if params.CHECKPOINT_EVERY <= 0:
        conf_text = override_conf(conf_text, "CHECKPOINT_EVERY", HOIST_EVERY)
    return Params.from_text(override_conf(conf_text, "RNG_MODE", "hoisted"))


class Journal:
    """Torn-tolerant append-only JSONL (one fsynced line per event)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a")

    def append(self, obj: dict) -> None:
        self._fh.write(json.dumps(obj, sort_keys=True) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        self._fh.close()


def read_journal(path: str) -> List[dict]:
    """Replay a ``campaign.jsonl``; torn/corrupt lines are skipped (a
    campaign killed mid-write loses at most its last line)."""
    rows: List[dict] = []
    try:
        with open(path) as fh:
            for line in fh:
                try:
                    rows.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return rows


def _grade(report: Optional[dict]) -> dict:
    """Journal-row fields from an oracle report (None = run lost)."""
    if not report or "invariants" not in report:
        return {"ok": False, "violations": ["no_oracle_report"]}
    return {
        "ok": bool(report["ok"]),
        "violations": list(report["violations"]),
        "live": report.get("final", {}).get("live"),
        "false_removals": report.get("detection_summary",
                                     {}).get("false_removals"),
    }


def _run_inproc(conf_text: str, scn_path: str, seed: int,
                device="cuda") -> dict:
    """One run through the port's backend on ``device``; -> the oracle
    report.

    Schedules carrying harness-level ``migrate`` events (chaos/fuzz.py,
    opt-in mix) take the elastic path: checkpointed, killed at each
    migrate tick, resharded, resumed — the oracle then grades the same
    full trajectory a migration-free run produces, because chunked
    resume is byte-exact repo-wide."""
    from distributed_membership_tpu_torch.backends import get_backend
    from distributed_membership_tpu_torch.sweeps.fleet_submit import (
        override_conf)
    try:
        with open(scn_path) as fh:
            sch = json.load(fh)
    except (OSError, ValueError):
        sch = {}
    migrations = sorted({int(e["time"]) for e in sch.get("events", ())
                         if e.get("kind") == "migrate"})
    if migrations:
        return _run_inproc_migrating(conf_text, sch, scn_path, seed,
                                     migrations, device)
    params = _lowered(override_conf(conf_text, "SCENARIO", scn_path))
    r = get_backend(params.BACKEND)(params, seed=seed, device=device)
    return r.extra["scenario_report"]


def _run_inproc_migrating(conf_text: str, sch: dict, scn_path: str,
                          seed: int, migrations, device="cuda") -> dict:
    """Execute a schedule's migrate events for real: run chunked, inject
    the kill at each migrate tick (the same fault a worker death
    leaves), reshard the durable carry in place (same geometry — the
    provenance chain and codec round-trip are what this exercises), and
    resume, all on ``device``.  The engine never sees ``migrate``: it
    gets a stripped scenario side file."""
    from distributed_membership_tpu_torch.backends import get_backend
    from distributed_membership_tpu_torch.elastic.reshard import reshard
    from distributed_membership_tpu_torch.runtime.checkpoint import (
        CRASH_ENV, load_manifest)
    from distributed_membership_tpu_torch.sweeps.fleet_submit import (
        override_conf)
    engine_path = scn_path + ".engine.json"
    engine = dict(sch)
    engine["events"] = [e for e in sch.get("events", ())
                        if e.get("kind") != "migrate"]
    with open(engine_path, "w") as fh:
        fh.write(dump_schedule(engine))
    ck = scn_path + ".ckpt"
    conf = override_conf(conf_text, "SCENARIO", engine_path)
    conf = override_conf(conf, "CHECKPOINT_EVERY", 10)
    conf = override_conf(conf, "CHECKPOINT_DIR", ck)
    conf = override_conf(conf, "RESUME", 1)
    params = _lowered(conf)
    run = get_backend(params.BACKEND)
    prev = os.environ.get(CRASH_ENV)
    try:
        for t in migrations:
            os.environ[CRASH_ENV] = str(t)
            try:
                r = run(params, seed=seed, device=device)
                return r.extra["scenario_report"]   # tick past the end
            except RuntimeError as e:
                if "injected crash" not in str(e):
                    raise
            if load_manifest(ck) is not None:
                # Same-geometry reshard: codec round-trip + provenance
                # stamp without changing where the run resumes.
                reshard([ck], [ck], device=device)
        os.environ.pop(CRASH_ENV, None)
        r = run(params, seed=seed, device=device)
    finally:
        if prev is None:
            os.environ.pop(CRASH_ENV, None)
        else:
            os.environ[CRASH_ENV] = prev
    return r.extra["scenario_report"]


def oracle_predicate(conf_text: str, seed: int, probe_path: str,
                     target: set, device="cuda") -> Callable[[dict], bool]:
    """The shrinker's predicate: does this candidate still trip one of
    the ORIGINAL violations?  Schema-invalid candidates (ddmin dropping
    a crash whose restart stayed, say) count as non-violating."""
    def violating(cand: dict) -> bool:
        with open(probe_path, "w") as fh:
            fh.write(dump_schedule(cand))
        try:
            report = _run_inproc(conf_text, probe_path, seed, device)
        except ValueError:
            return False
        return bool(target.intersection(report["violations"]))
    return violating


def run_campaign(spec: CampaignSpec, out_dir: str, *,
                 overrides: Optional[dict] = None,
                 mode: str = "inproc",
                 port: Optional[int] = None,
                 fleet_root: Optional[str] = None,
                 shrink: bool = True,
                 bank_dir: Optional[str] = None,
                 progress: Optional[Callable[[str], None]] = None,
                 device=None) -> dict:
    """Run a full campaign; -> summary dict (also journaled).  Inproc
    runs and the shrinker's probes run on ``device`` (None: ``cuda``);
    fleet runs on the controller's workers.

    ``out_dir`` receives ``scenarios/`` (every fuzzed schedule, banked
    as runnable JSON), ``campaign.jsonl``, and — for violations —
    ``regressions/`` (unless ``bank_dir`` redirects the bank).
    """
    if mode not in ("inproc", "fleet"):
        raise ValueError(f"mode {mode!r}: expected inproc|fleet")
    if mode == "fleet" and (port is None or fleet_root is None):
        raise ValueError("fleet mode needs port= and fleet_root=")
    say = progress or (lambda s: None)
    device = "cuda" if device is None else device
    os.makedirs(out_dir, exist_ok=True)
    scen_dir = os.path.join(out_dir, "scenarios")
    os.makedirs(scen_dir, exist_ok=True)
    conf_text = base_conf(spec, overrides)
    digest = campaign_digest(spec)
    journal = Journal(os.path.join(out_dir, "campaign.jsonl"))
    journal.append({"kind": "campaign", "digest": digest, "mode": mode,
                    "spec": spec.to_dict(),
                    "overrides": dict(overrides or {})})

    schedules, paths, seeds = [], [], []
    for i in range(spec.schedules):
        sch = fuzz_schedule(spec, i)
        path = os.path.join(scen_dir, f"{sch['name']}.json")
        with open(path, "w") as fh:
            fh.write(dump_schedule(sch))
        schedules.append(sch)
        paths.append(path)
        seeds.append(spec.seed + i)

    reports: List[Optional[dict]] = []
    if mode == "inproc":
        for i, (sch, path, seed) in enumerate(
                zip(schedules, paths, seeds)):
            reports.append(_run_inproc(conf_text, path, seed, device))
            _journal_graded(journal, spec, i, sch, seed, reports[-1])
            say(f"{sch['name']}: "
                f"{'ok' if reports[-1]['ok'] else 'VIOLATION'}")
    else:
        reports = _run_fleet(journal, spec, schedules, seeds, conf_text,
                             port, fleet_root, say)

    violators = [(i, r) for i, r in enumerate(reports)
                 if not (r and r.get("ok"))]
    repros = []
    if shrink:
        bank = bank_dir or os.path.join(out_dir, "regressions")
        probe = os.path.join(out_dir, "shrink_probe.json")
        for i, report in violators:
            if not report or "violations" not in report:
                continue            # lost run: nothing to shrink
            target = set(report["violations"])
            journal.append({"kind": "shrinking",
                            "run_id": schedules[i]["name"],
                            "violations": sorted(target)})
            say(f"shrinking {schedules[i]['name']} ({sorted(target)})")
            minimal, stats = shrink_schedule(
                schedules[i],
                oracle_predicate(conf_text, seeds[i], probe, target,
                                 device))
            path = bank_repro(minimal, bank, {
                "seed": seeds[i], "campaign": digest,
                "violations": sorted(target),
                "shrunk_from": schedule_digest(schedules[i]),
                "probes": stats["probes"],
                # The repro only violates under the campaign's conf —
                # carry the deliberate breakage for self-containedness.
                "overrides": dict(overrides or {})})
            repros.append(path)
            journal.append({"kind": "shrunk",
                            "run_id": schedules[i]["name"],
                            "path": path, "probes": stats["probes"],
                            "events": stats["events_after"]})
            say(f"banked {path} ({stats['events_after']} events, "
                f"{stats['probes']} probes)")

    summary = {"kind": "done", "digest": digest,
               "runs": len(schedules),
               "violations": [schedules[i]["name"] for i, _ in violators],
               "repros": repros,
               "ok": not violators}
    journal.append(summary)
    journal.close()
    return summary


def _journal_graded(journal: Journal, spec: CampaignSpec, index: int,
                    sch: dict, seed: int, report: Optional[dict]) -> None:
    journal.append({"kind": "graded", "run_id": sch["name"],
                    "index": index, "seed": seed,
                    "digest": schedule_digest(sch), **_grade(report)})


def _run_fleet(journal: Journal, spec: CampaignSpec, schedules, seeds,
               conf_text: str, port: int, fleet_root: str,
               say) -> List[Optional[dict]]:
    """Fleet fan-out: inline scenario submissions, graded from each run
    dir's oracle report once the grid is terminal."""
    from distributed_membership_tpu_torch.sweeps.fleet_submit import (
        submit_grid, wait_grid)
    # Harness-level migrate events are inproc-only (the controller's
    # own FLEET_MIGRATE_* machinery owns migration in fleet mode);
    # strip them and say so in the journal rather than silently.
    stripped = 0
    subs = []
    for sch, seed in zip(schedules, seeds):
        events = [e for e in sch["events"] if e.get("kind") != "migrate"]
        stripped += len(sch["events"]) - len(events)
        subs.append({"conf": conf_text, "run_id": sch["name"],
                     "seed": seed,
                     "scenario": {"name": sch["name"], "events": events}})
    if stripped:
        journal.append({"kind": "note",
                        "note": f"fleet mode: stripped {stripped} "
                                "harness-level migrate event(s); use "
                                "inproc mode or FLEET_MIGRATE_ON to "
                                "exercise migration"})
        say(f"stripped {stripped} migrate event(s) (fleet mode)")
    submit_grid(port, subs)
    say(f"submitted {len(subs)} runs to fleet :{port}")
    rows = wait_grid(port, [s["run_id"] for s in subs])
    reports: List[Optional[dict]] = []
    for i, (sch, seed) in enumerate(zip(schedules, seeds)):
        report = None
        if rows.get(sch["name"], {}).get("state") == "done":
            try:
                with open(os.path.join(fleet_root, sch["name"],
                                       "scenario.json")) as fh:
                    report = json.load(fh)
            except (OSError, ValueError):
                report = None
        reports.append(report)
        _journal_graded(journal, spec, i, sch, seed, report)
    return reports
