"""Application entry point: conf in, dbg.log / stats.log / msgcount.log out
(the JAX package's ``runtime/application.py``, for the port's backend).

The run's device is explicit.  The default is ``cuda``: without a GPU
the run raises rather than quietly running on the CPU; ``--device cpu``
runs the plain versions of the kernels.  The ``emul`` and ``emul_native``
backends are host simulators and run on the host whatever the device,
as the JAX package's run off the TPU; the device is still checked.

``--serve`` (with ``--port``) runs the conf under the service daemon
(service/daemon.py): queries and live injection over HTTP between the
``CHECKPOINT_EVERY``-tick segments.  A ``RESUME`` with a
``CHECKPOINT_DIR`` replays the served run's journal of injected events,
served or not (``resume_journal_run``).  ``--fleet`` runs the fleet
controller (fleet/daemon.py ``fleet_conf``): runs submitted over HTTP
become worker subprocesses on ``--device``.  ``--mesh-shape`` overrides
``MESH_SHAPE``, the way a checkpoint resharded by elastic/reshard.py
resumes on its new shape.

Under ``DM_DIST_PROCS = K > 1`` (set by ``python -m
distributed_membership_tpu_torch.multiproc_launch``) the process first
joins the run's process group (runtime/distributed.py
``maybe_initialize``, before its first CUDA call), and a
``tpu_hash_sharded`` run spreads its shards over the K processes, each
writing the same complete logs.  The one-process backends run whole in
every process, as the JAX package's do; ``tpu_sharded`` and ``--serve``
refuse such a run, and ``--fleet`` never joins it.

``--grade-all`` runs the reference's three grading scenarios
(``testcases/``) and prints the /90 total, as Grader_verbose.sh does;
``--grade SCENARIO`` grades one run.  The testcases name no backend, so
they run the default ``emul``, as in the JAX package; ``--backend``
grades another.  ``--backend tpu_hash_sharded`` grades the sharded scatter step
(``EXCHANGE: auto`` resolves scatter for the testcases' staggered joins)
on one shard, or on ``--mesh-shape``'s shards; the JAX package takes the
largest device count that divides N when ``MESH_SHAPE`` is unset.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

from distributed_membership_tpu_torch.backends import RunResult, get_backend
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.eventlog import EventLog
from distributed_membership_tpu_torch.grader import SCENARIO_GRADERS
from distributed_membership_tpu_torch.observability.metrics import (
    write_msgcount)

SCENARIOS = ("singlefailure", "multifailure", "msgdropsinglefailure")
SCENARIO_TITLES = ("Single Failure Scenario", "Multi Failure Scenario",
                   "Message Drop Single Failure Scenario")
GRADE_BACKEND = "emul"


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "false; pass device='cpu' (--device cpu) to run the plain "
            "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


def apply_overrides(params: Params, backend: str | None = None,
                    checkpoint_every: int | None = None,
                    checkpoint_dir: str | None = None,
                    resume: bool | None = None,
                    telemetry: str | None = None,
                    telemetry_dir: str | None = None,
                    scenario: str | None = None,
                    mesh_shape: str | None = None) -> Params:
    """Each given override wins over its conf key (``BACKEND``,
    ``CHECKPOINT_EVERY``, ``CHECKPOINT_DIR``, ``RESUME``, ``TELEMETRY``,
    ``TELEMETRY_DIR``, ``SCENARIO``, ``MESH_SHAPE``), as the JAX
    package's ``apply_overrides``; the caller validates after them.
    ``MESH_SHAPE`` is part of the checkpoint identity, so a resume on a
    new shape needs an explicit reshard first (elastic/reshard.py)."""
    for key, value in (("BACKEND", backend),
                       ("CHECKPOINT_EVERY", checkpoint_every),
                       ("CHECKPOINT_DIR", checkpoint_dir),
                       ("RESUME", None if resume is None else int(resume)),
                       ("TELEMETRY", telemetry),
                       ("TELEMETRY_DIR", telemetry_dir),
                       ("SCENARIO", scenario),
                       ("MESH_SHAPE", mesh_shape)):
        if value is not None:
            setattr(params, key, value)
    return params


def run_conf(conf_path: str, seed: int | None = None, out_dir: str = ".",
             device="cuda", backend: str | None = None,
             checkpoint_every: int | None = None,
             checkpoint_dir: str | None = None,
             resume: bool | None = None,
             telemetry: str | None = None,
             telemetry_dir: str | None = None,
             scenario: str | None = None,
             mesh_shape: str | None = None) -> RunResult:
    """Run one conf and write its logs; the overrides
    (:func:`apply_overrides`) are applied, then the result validated, as
    the JAX package's ``run_conf`` does.  A ``RESUME`` with a
    ``CHECKPOINT_DIR`` first replays a served run's journal of injected
    events, if there is one (``service.daemon.resume_journal_run``)."""
    dev = resolve_device(device)
    params = Params.from_file(conf_path, validate=False)
    apply_overrides(params, backend=backend,
                    checkpoint_every=checkpoint_every,
                    checkpoint_dir=checkpoint_dir, resume=resume,
                    telemetry=telemetry, telemetry_dir=telemetry_dir,
                    scenario=scenario, mesh_shape=mesh_shape)
    params.validate()
    log = EventLog(out_dir)
    result = None
    if params.RESUME and params.CHECKPOINT_DIR:
        from distributed_membership_tpu_torch.service.daemon import (
            resume_journal_run)
        result = resume_journal_run(params, log, seed, dev)
    if result is None:
        result = get_backend(params.BACKEND)(params, log, seed=seed,
                                             device=dev)
    result.log.flush(out_dir)
    if not result.extra.get("aggregate"):
        write_msgcount(result, out_dir)
    return result


def default_testcases_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "testcases")


def run_scenario_graded(scenario: str, testdir: str, backend, seed,
                        out_dir: str, device="cuda",
                        mesh_shape: str | None = None):
    """Run one grading scenario and grade its dbg.log."""
    result = run_conf(os.path.join(testdir, f"{scenario}.conf"), seed=seed,
                      out_dir=out_dir, device=device, backend=backend,
                      mesh_shape=mesh_shape)
    grade = SCENARIO_GRADERS[scenario](result.log.dbg_text(),
                                       result.params.EN_GPSZ)
    return result, grade


def grade_all(args, results: list | None = None) -> int:
    """Run the three grading scenarios and print the /90 total
    (Grader_verbose.sh:27-196's build-run-score loop); 0 iff it is 90.
    ``results``, where given, receives each scenario's ``(RunResult,
    ScenarioResult)``."""
    testdir = args.testcases or default_testcases_dir()
    backend = args.backend or GRADE_BACKEND
    mesh = getattr(args, "mesh_shape", None)
    total = 0
    print("============================================")
    print("Grading Started")
    print("============================================")
    for scenario, title in zip(SCENARIOS, SCENARIO_TITLES):
        print(title)
        print("============================")
        if args.out_dir is None:
            with tempfile.TemporaryDirectory() as tmp:
                res, g = run_scenario_graded(scenario, testdir, backend,
                                             args.seed, tmp, args.device,
                                             mesh)
        else:
            res, g = run_scenario_graded(
                scenario, testdir, backend, args.seed,
                os.path.join(args.out_dir, scenario), args.device, mesh)
        if results is not None:
            results.append((res, g))
        print(f"Checking Join.................."
              f"{g.join_pts}/{g.join_max}")
        print(f"Checking Completeness.........."
              f"{g.completeness_pts}/{g.completeness_max}")
        if g.accuracy_max:
            print(f"Checking Accuracy.............."
                  f"{g.accuracy_pts}/{g.accuracy_max}")
        print("============================================")
        total += g.points
    print(f"Final grade {total}")
    return 0 if total == 90 else 1


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_membership_tpu_torch",
        description="Gossip membership simulator, PyTorch/CUDA port "
                    "(all seven backends of the JAX package)")
    ap.add_argument("conf", nargs="?", default=None,
                    help="testcase .conf file; omit with --grade-all")
    ap.add_argument("--backend", default=None,
                    help="override BACKEND from the conf: emul (the "
                         "default), emul_native, tpu, tpu_sharded, "
                         "tpu_sparse, tpu_hash or tpu_hash_sharded; emul "
                         "and emul_native run on the host whatever "
                         f"--device says; --grade-all defaults to "
                         f"{GRADE_BACKEND}, the testcases' backend")
    ap.add_argument("--grade-all", action="store_true",
                    help="run all three grading scenarios and print the /90 "
                         "total (Grader_verbose.sh's build-run-score loop); "
                         "exit code 0 iff the grade is 90")
    ap.add_argument("--grade", metavar="SCENARIO", default=None,
                    choices=sorted(SCENARIO_GRADERS),
                    help="grade the run with the grading oracle; exit code "
                         "0 iff it passes")
    ap.add_argument("--testcases", default=None,
                    help="directory holding the three scenario .conf files "
                         "(default: testcases/ at the repo root)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--out-dir", default=None,
                    help="directory for the logs (default: the current "
                         "directory; with --grade-all, one subdirectory "
                         "per scenario, and none kept when omitted)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the GPU with the CUDA kernels (default) "
                         "or on the CPU with their plain versions; the "
                         "emul backends run on the host either way")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    metavar="TICKS",
                    help="CHECKPOINT_EVERY conf key: run the tick loop in "
                         "TICKS-tick segments (runtime/checkpoint.py)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="CHECKPOINT_DIR conf key: directory for the "
                         "snapshots and MANIFEST.json, readable by either "
                         "package")
    ap.add_argument("--resume", action="store_true", default=None,
                    help="resume bit for bit from --checkpoint-dir's latest "
                         "checkpoint (checked against this config and "
                         "seed; a fresh start when there is none)")
    ap.add_argument("--telemetry", default=None,
                    choices=["off", "scalars", "hist"],
                    help="TELEMETRY conf key: 'scalars' arms the flight "
                         "recorder's per-tick series on the ring steps, "
                         "'hist' adds its histograms "
                         "(observability/timeline.py)")
    ap.add_argument("--telemetry-dir", default=None,
                    help="TELEMETRY_DIR conf key: directory for "
                         "timeline.jsonl, runlog.jsonl (chunked runs) and, "
                         "in EVENT_MODE agg, summary.json (render with "
                         "scripts/run_report.py)")
    ap.add_argument("--mesh-shape", default=None, metavar="SHAPE",
                    help="MESH_SHAPE conf key ('D', 'OxI' or 'SxOxI'; "
                         "tpu_hash_sharded only).  Resuming onto a "
                         "shape different from the checkpoint's "
                         "requires an explicit reshard first "
                         "(python -m distributed_membership_tpu_torch."
                         "elastic.reshard)")
    ap.add_argument("--scenario", default=None, metavar="FILE",
                    help="SCENARIO conf key: a declarative chaos-schedule "
                         "JSON file (crash/restart/leave/partition/"
                         "link_flake/one_way_flake/delay_window/"
                         "drop_window events -- scenario/ package; "
                         "examples in scenarios/ at the repo root)")
    ap.add_argument("--serve", action="store_true",
                    help="run as the membership control-plane daemon "
                         "(service/ package): serve liveness queries and "
                         "live fault injection over HTTP between the "
                         "segments; requires --checkpoint-every (or the "
                         "conf's CHECKPOINT_EVERY) and a ring-family "
                         "backend")
    ap.add_argument("--port", type=int, default=None, metavar="P",
                    help="SERVICE_PORT conf key: port for --serve "
                         "(0 = ephemeral, written to "
                         "<out-dir>/service.json; default ephemeral); "
                         "with --fleet it is the FLEET_PORT instead")
    ap.add_argument("--fleet", action="store_true",
                    help="run the fleet controller (fleet/ package): a "
                         "control plane scheduling many runs submitted "
                         "over HTTP (POST /v1/runs) into subprocess "
                         "workers on --device, proxying each run's "
                         "--serve surface under /v1/runs/<id>/.  conf is "
                         "optional and read for FLEET_* keys only")
    ap.add_argument("--json", action="store_true",
                    help="print a JSON summary line")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.grade_all:
        resolve_device(args.device)
        return grade_all(args)
    if args.serve and args.fleet:
        ap.error("--serve and --fleet are mutually exclusive (submit "
                 "the run to the fleet instead)")
    if args.conf is None and not args.fleet:
        ap.error("conf is required unless --grade-all or --fleet is "
                 "given")
    if args.port is not None and not (args.serve or args.fleet):
        ap.error("--port requires --serve or --fleet")
    if args.fleet:
        from distributed_membership_tpu_torch.fleet.daemon import (
            fleet_conf)
        return fleet_conf(args.conf, port=args.port,
                          out_dir=args.out_dir or ".", device=args.device)
    from distributed_membership_tpu_torch.runtime import distributed
    if args.serve and distributed.env_procs() > 1:
        ap.error(f"--serve runs one process: the daemon publishes its own "
                 f"carry's snapshots and takes its own injections "
                 f"(unset {distributed.PROCS_ENV})")
    # Join the run's process group before the first CUDA call (a no-op
    # unless DM_DIST_PROCS > 1).
    distributed.maybe_initialize(args.device)
    try:
        rc = _run_main(args)
    except BaseException:
        # The other processes may wait in a collective: leave without
        # the closing barrier.
        distributed.shutdown(barrier=False)
        raise
    distributed.shutdown()
    return rc


def _run_main(args) -> int:
    """``main`` past its argument checks and the process group's init."""
    if args.serve:
        from distributed_membership_tpu_torch.service.daemon import (
            serve_conf)
        return serve_conf(
            args.conf, port=args.port, out_dir=args.out_dir or ".",
            device=args.device, seed=args.seed, backend=args.backend,
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir, resume=args.resume,
            telemetry=args.telemetry, telemetry_dir=args.telemetry_dir,
            scenario=args.scenario)
    from distributed_membership_tpu_torch.runtime.checkpoint import (
        RunInterrupted)
    try:
        result = run_conf(args.conf, seed=args.seed,
                          out_dir=args.out_dir or ".", device=args.device,
                          backend=args.backend,
                          checkpoint_every=args.checkpoint_every,
                          checkpoint_dir=args.checkpoint_dir,
                          resume=args.resume, telemetry=args.telemetry,
                          telemetry_dir=args.telemetry_dir,
                          scenario=args.scenario,
                          mesh_shape=args.mesh_shape)
    except RunInterrupted as e:
        # A SIGTERM/SIGINT stopped the chunked driver at a durable
        # boundary (the fleet's pause and drain): say where to resume.
        print(f"interrupted: {e} — rerun with --resume to continue")
        return 0
    p = result.params
    summary = {
        "backend": p.BACKEND,
        "device": args.device,
        "n_nodes": p.EN_GPSZ,
        "ticks": p.TOTAL_TIME,
        "wall_seconds": round(result.wall_seconds, 4),
        "node_ticks_per_sec": round(
            p.EN_GPSZ * p.TOTAL_TIME / max(result.wall_seconds, 1e-9), 1),
        "msgs_sent": int(result.sent.sum()),
        "failed_indices": result.failed_indices,
    }
    if "detection_summary" in result.extra:
        summary["detection"] = result.extra["detection_summary"]
    if "scenario_report" in result.extra:
        summary["scenario"] = result.extra["scenario_report"]
    if result.extra.get("timeline_path"):
        summary["timeline_path"] = result.extra["timeline_path"]
    g = None
    if args.grade:
        g = SCENARIO_GRADERS[args.grade](result.log.dbg_text(),
                                         result.params.EN_GPSZ)
        summary["grade"] = {"points": g.points, "max": g.max_points,
                            "join": g.join_ok,
                            "completeness": g.completeness_pts,
                            "accuracy": g.accuracy_pts}
    if args.json:
        print(json.dumps(summary))
    else:
        for k, v in summary.items():
            print(f"{k}: {v}")
    return 1 if g is not None and not g.passed else 0


if __name__ == "__main__":
    sys.exit(main())
