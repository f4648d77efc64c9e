"""Launch a K-process run on one host (counterpart of the JAX package's
``scripts/multiproc_launch.py``).

Each process is a full ``python -m distributed_membership_tpu_torch``
CLI invocation with ``DM_DIST_*`` set (runtime/distributed.py): process
``i`` joins the shared coordinator, and a ``tpu_hash_sharded`` run
spreads its ``D`` shards over the K processes, ``D / K`` each, with the
cross-process legs of every collective on the transport the rule picks
(gloo on the CPU; nccl with a card per process; gloo over CUDA tensors
where processes share a card).

Every process holds the same global carry at every segment boundary,
so each writes its OWN complete artifact set: ``<out-root>/p{i}/dbg.log``
etc. are byte-identical across processes and to a one-process run with
the same ``MESH_SHAPE``.  Checkpoints are per-process directories;
kill/resume works by rerunning the same launcher command with
``--resume``, and a resume onto another ``--procs`` or ``--mesh-shape``
reshards the checkpoints first (:func:`maybe_reshard`).

Examples::

    python -m distributed_membership_tpu_torch.multiproc_launch \\
        conf --procs 2 --device cpu --out-root /tmp/mp
    python -m distributed_membership_tpu_torch.multiproc_launch \\
        conf --procs 2 --device cuda --checkpoint-every 24 --resume \\
        --out-root /tmp/mp --merge

``--devices-per-proc`` gives the shards per process: with no
``--mesh-shape`` the run's ``MESH_SHAPE`` becomes ``procs *
devices-per-proc`` (the JAX mesh over every global device), unless the
conf sets one.  DM_* environment variables in the launcher's own
environment (e.g. DM_CRASH_AT_TICK for fault injection) are inherited by
every child.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _conf_mesh_shape(conf: str) -> str:
    """The conf's own ``MESH_SHAPE`` (empty when unset)."""
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    from distributed_membership_tpu_torch.config import Params
    return Params.from_file(conf, validate=False).MESH_SHAPE or ""


def mesh_shape_of(args):
    """The ``--mesh-shape`` every process gets: the flag; else, where
    the conf sets none and a process holds more than one shard, ``procs
    * devices_per_proc`` shards; else None (the conf's ``MESH_SHAPE``,
    or one shard per process)."""
    if args.mesh_shape:
        return args.mesh_shape
    per_proc = getattr(args, "devices_per_proc", 1)
    if per_proc > 1 and not _conf_mesh_shape(args.conf):
        return str(args.procs * per_proc)
    return None


def build_commands(args, port: int):
    """One (cmd, env, cwd) per process."""
    conf = os.path.abspath(args.conf)
    out_root = os.path.abspath(args.out_root)
    shape = mesh_shape_of(args)
    jobs = []
    for i in range(args.procs):
        pdir = os.path.join(out_root, f"p{i}")
        os.makedirs(pdir, exist_ok=True)
        env = dict(os.environ)
        env["DM_DIST_PROCS"] = str(args.procs)
        env["DM_DIST_PROC_ID"] = str(i)
        env["DM_DIST_COORD"] = f"localhost:{port}"
        env["PYTHONPATH"] = (REPO_ROOT + os.pathsep
                             + env.get("PYTHONPATH", ""))
        cmd = [sys.executable, "-m", "distributed_membership_tpu_torch",
               conf, "--out-dir", pdir, "--device", args.device,
               "--seed", str(args.seed)]
        if shape:
            cmd += ["--mesh-shape", shape]
        if args.backend:
            cmd += ["--backend", args.backend]
        if args.checkpoint_every:
            cmd += ["--checkpoint-every", str(args.checkpoint_every),
                    "--checkpoint-dir", os.path.join(pdir, "ckpt")]
        if args.resume:
            cmd += ["--resume"]
        cmd += args.extra
        jobs.append((cmd, env, pdir))
    return jobs


def maybe_reshard(args) -> int:
    """Elastic resume (elastic/reshard.py): when ``--resume`` finds a
    checkpoint written by a DIFFERENT process count or mesh shape,
    redistribute it host-side before launching -- so the very same
    launcher command, edited only at ``--procs``/``--mesh-shape``,
    migrates a run across geometries.  Returns a process count whose
    checkpoints exist (the count to launch), or -1 on refusal."""
    if not (args.resume and args.checkpoint_every):
        return args.procs
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    from distributed_membership_tpu_torch.elastic.reshard import (
        ReshardError, reshard)
    from distributed_membership_tpu_torch.runtime.checkpoint import (
        load_manifest)
    out_root = os.path.abspath(args.out_root)
    head = load_manifest(os.path.join(out_root, "p0", "ckpt"))
    if head is None:
        return args.procs               # fresh start: nothing to move
    from_procs = int(head.get("process_count", 1))
    from_shape = json.loads(head["params_text"]).get("MESH_SHAPE", "")
    to_shape = mesh_shape_of(args) or from_shape
    if from_procs == args.procs and to_shape == from_shape:
        return args.procs               # same geometry: plain resume
    src = [os.path.join(out_root, f"p{i}", "ckpt")
           for i in range(from_procs)]
    dst = [os.path.join(out_root, f"p{i}", "ckpt")
           for i in range(args.procs)]
    try:
        stats = reshard(src, dst, to_mesh_shape=to_shape or None,
                        device=args.device)
    except ReshardError as e:
        print(f"[multiproc] reshard refused: {e}", file=sys.stderr)
        return -1
    print(f"[multiproc] resharded tick {stats['tick']}: "
          f"{stats['from_shape'] or '(auto)'}/{stats['from_procs']}p -> "
          f"{stats['to_shape'] or '(auto)'}/{stats['to_procs']}p "
          f"in {stats['wall_seconds']:.2f}s")
    return args.procs


def _wait_all(procs, timeout) -> int:
    """Wait for every process; the first that fails (or the timeout)
    kills the rest, which would otherwise wait in a collective."""
    deadline = None if timeout is None else time.monotonic() + timeout
    rc = 0
    live = list(procs)
    while live:
        for item in list(live):
            p, _, i = item
            code = p.poll()
            if code is None:
                continue
            live.remove(item)
            if code != 0:
                print(f"[multiproc] p{i} exited {code} "
                      f"(see p{i}/launch.log)", file=sys.stderr)
                rc = rc or code
        if rc or not live:
            break
        if deadline is not None and time.monotonic() > deadline:
            print("[multiproc] timeout -- killing processes",
                  file=sys.stderr)
            return 124
        time.sleep(0.05)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("conf", help="run conf (same file for every process)")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--out-root", required=True,
                    help="per-process artifacts land in <out-root>/p{i}/")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; process i on card i mod the "
                    "host's cards) or cpu (gloo collectives)")
    ap.add_argument("--devices-per-proc", type=int, default=1,
                    help="shards per process where neither --mesh-shape "
                    "nor the conf sets MESH_SHAPE (global mesh size = "
                    "procs x this)")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh-shape", default=None,
                    help="MESH_SHAPE for every process; with --resume, "
                    "a checkpoint from a different shape or --procs is "
                    "resharded host-side first (elastic/reshard.py)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-run wall clock limit in seconds")
    ap.add_argument("--merge", action="store_true",
                    help="after all processes exit 0, fold the per-"
                    "process p{i}/timeline.jsonl shards into "
                    "<out-root>/timeline.jsonl with the consistency "
                    "cross-check (observability/merge.py); shard "
                    "disagreement exits 3")
    ap.add_argument("extra", nargs="*",
                    help="extra args forwarded to every CLI invocation "
                    "(put dashed args after a standalone `--`, e.g. "
                    "`-- --telemetry hist`)")
    # argparse cannot route dashed tokens into a trailing nargs="*"
    # positional, so split at the first standalone "--" ourselves:
    # everything after it is forwarded verbatim.
    argv = list(sys.argv[1:] if argv is None else argv)
    forwarded = []
    if "--" in argv:
        cut = argv.index("--")
        argv, forwarded = argv[:cut], argv[cut + 1:]
    args = ap.parse_args(argv)
    args.extra = args.extra + forwarded

    if maybe_reshard(args) < 0:
        return 2
    port = _free_port()
    jobs = build_commands(args, port)
    procs = []
    try:
        for i, (cmd, env, pdir) in enumerate(jobs):
            logf = open(os.path.join(pdir, "launch.log"), "w")
            procs.append((subprocess.Popen(cmd, env=env, cwd=pdir,
                                           stdout=logf, stderr=logf),
                          logf, i))
            print(f"[multiproc] p{i} pid={procs[-1][0].pid} -> {pdir}",
                  flush=True)
        rc = _wait_all(procs, args.timeout)
    finally:
        for p, logf, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            logf.close()
    if args.merge and rc == 0:
        if REPO_ROOT not in sys.path:
            sys.path.insert(0, REPO_ROOT)
        from distributed_membership_tpu_torch.observability.merge import (
            MergeError, merge_run)
        try:
            info = merge_run(os.path.abspath(args.out_root))
        except MergeError as e:
            print(f"[multiproc] merge cross-check FAILED: {e}",
                  file=sys.stderr)
            return 3
        if info is None:
            print("[multiproc] merge: no timeline shards (run with "
                  "--telemetry scalars/hist)", file=sys.stderr)
        else:
            print(f"[multiproc] merged {len(info['shards'])} shard(s) "
                  f"({info['ticks']} ticks) -> {info['path']}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
