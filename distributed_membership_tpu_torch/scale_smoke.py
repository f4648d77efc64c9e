"""Scale smoke: bounded-view failure detection at large N, with evidence
(the JAX package's ``scripts/scale_smoke.py``, on the port).

Runs the scale path (``tpu_hash``, ``tpu_hash_sharded`` on ``--mesh``
shards of one card, or ``tpu_sparse``) at a configurable node count in
aggregate event mode, asserts the detection verdicts (full tracker
completeness, zero false removals, the trackers floor), and appends a
JSON record -- config, verdicts, latency distribution, throughput -- to
``artifacts/SCALE_SMOKE_TORCH.json``.  The geometry, TFAIL, TREMOVE and
FAIL_TIME are sized as the JAX script sizes them, and the record has its
keys, plus ``device``: the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them.  On the
card the record also holds the kernels' launches over the run, the
layout they ran (``folded`` for S < 128 in agg mode), ms per tick, the
peak device memory and the kernels' build seconds (built before the
clock starts).

Usage:
  python -m distributed_membership_tpu_torch.scale_smoke --n 65536
  python -m distributed_membership_tpu_torch.scale_smoke --n 1048576 --ticks 120
  python -m distributed_membership_tpu_torch.scale_smoke \\
      --backend tpu_hash_sharded --mesh 8
  python -m distributed_membership_tpu_torch.scale_smoke --n 512 --device cpu

``--device`` defaults to ``cuda``; without a card the run raises rather
than running on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from distributed_membership_tpu_torch.observability.perfdb import (
    SCALE_SMOKE_PATH)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, SCALE_SMOKE_PATH)
# The record's fields that depend on the machine and the clock rather
# than on the run: two runs of one configuration agree on all the others,
# on the card and on the CPU.
MACHINE_FIELDS = frozenset((
    "wall_seconds", "node_ticks_per_sec", "timestamp", "platform", "device",
    "layout", "launches", "ms_per_tick", "peak_mem_gib", "build_seconds"))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_membership_tpu_torch.scale_smoke",
        description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--backend", default="tpu_hash",
                    choices=["tpu_hash", "tpu_sparse", "tpu_hash_sharded"])
    ap.add_argument("--ticks", type=int, default=150)
    ap.add_argument("--view", type=int, default=64)
    ap.add_argument("--gossip", type=int, default=16)
    ap.add_argument("--probes", type=int, default=8)
    ap.add_argument("--fanout", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--drop", type=float, default=0.0,
                    help="message drop probability, applied over the whole "
                         "run (loss stress in the scale regime; TREMOVE "
                         "auto-sizes to the Params loss floor)")
    ap.add_argument("--tremove-cycles", type=int, default=0,
                    help="TREMOVE in probe cycles (0 = auto: 5, or the "
                         "loss floor + 1 when --drop > 0)")
    ap.add_argument("--rack-size", type=int, default=0,
                    help="correlated rack failures: rack size in nodes")
    ap.add_argument("--rack-failures", type=int, default=0,
                    help="number of whole racks crashed at FAIL_TIME")
    ap.add_argument("--trackers-floor", type=int, default=8,
                    help="fail the run if any crashed id had fewer than "
                         "this many live trackers at the crash")
    ap.add_argument("--shift-set", type=int, default=0,
                    help="SHIFT_SET: K static gossip-shift candidates "
                         "(0 = off)")
    ap.add_argument("--exchange", default="auto",
                    choices=["auto", "scatter", "ring"],
                    help="tpu_hash message-exchange lowering (auto picks "
                         "the ring for this warm scale config)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shards of tpu_hash_sharded on the one device "
                         "(MESH_SHAPE; 0 = unset, one shard)")
    ap.add_argument("--telemetry", default="off",
                    choices=["off", "scalars"],
                    help="TELEMETRY: scalars arms the flight recorder's "
                         "per-tick series (observability/timeline.py); "
                         "the run record gains timeline totals")
    ap.add_argument("--telemetry-dir", default="",
                    help="directory for timeline.jsonl / summary.json "
                         "(implies --telemetry scalars; render with "
                         "python -m distributed_membership_tpu_torch."
                         "run_report)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run goes (default: the card)")
    return ap


def scale_params(args):
    """The run's ``Params`` and its ``(tfail, tremove)``, sized from the
    flags as the JAX script sizes them."""
    from distributed_membership_tpu_torch.config import Params

    if args.probes > 0:
        cycle = -(-args.view // args.probes)
    else:
        # Probes off: entries refresh through gossip only, one of the
        # ``fanout`` senders' ~G-entry subsets every ~S / (fanout * G)
        # ticks; the same 2x/5x TFAIL/TREMOVE ladder as with probes.
        g = args.gossip if args.gossip > 0 else max(args.view // 4, 1)
        cycle = max(-(-args.view // max(args.fanout * g, 1)), 1)
    tfail = 2 * cycle
    k_cycles = args.tremove_cycles
    if k_cycles == 0:
        k_cycles = 5
        if args.drop > 0:
            # TREMOVE from the loss floor (expected false removals < 1
            # over the run's drop window), +1 cycle of margin.
            probe = Params.from_text(
                f"MAX_NNB: {args.n}\nSINGLE_FAILURE: 1\nDROP_MSG: 1\n"
                f"MSG_DROP_PROB: {args.drop}\nVIEW_SIZE: {args.view}\n"
                f"PROBES: {args.probes}\nTREMOVE: {1 << 20}\n"
                f"DROP_START: 0\nDROP_STOP: {args.ticks}\n"
                f"TOTAL_TIME: {args.ticks}\nJOIN_MODE: warm\n"
                f"BACKEND: {args.backend}\n")
            k_cycles = max(5, probe.min_tremove_cycles_under_loss() + 1)
    tremove = k_cycles * cycle
    # Tail margin: refresh chains stretch the last detections past
    # TREMOVE, loss further still.
    tail = (10 if args.drop > 0 else 7) * cycle
    fail_time = args.ticks - tremove - tail
    if fail_time <= 0:
        raise ValueError(f"ticks too short for the detection window (need "
                         f"> {tremove + tail}; raise --ticks)")

    drop_keys = (f"DROP_MSG: 1\nMSG_DROP_PROB: {args.drop}\n"
                 f"DROP_START: 0\nDROP_STOP: {args.ticks}\n"
                 if args.drop > 0 else "DROP_MSG: 0\nMSG_DROP_PROB: 0\n")
    rack_keys = (f"RACK_SIZE: {args.rack_size}\n"
                 f"RACK_FAILURES: {args.rack_failures}\n"
                 if args.rack_size > 0 and args.rack_failures > 0 else "")
    mesh_keys = (f"MESH_SHAPE: {args.mesh}\n"
                 if args.backend == "tpu_hash_sharded" and args.mesh > 0
                 else "")
    params = Params.from_text(
        f"MAX_NNB: {args.n}\nSINGLE_FAILURE: 1\n{drop_keys}{rack_keys}"
        f"VIEW_SIZE: {args.view}\n"
        f"GOSSIP_LEN: {args.gossip}\nPROBES: {args.probes}\n"
        f"FANOUT: {args.fanout}\nTFAIL: {tfail}\nTREMOVE: {tremove}\n"
        f"TOTAL_TIME: {args.ticks}\nFAIL_TIME: {fail_time}\n"
        f"JOIN_MODE: warm\nEVENT_MODE: agg\nEXCHANGE: {args.exchange}\n"
        f"SHIFT_SET: {args.shift_set}\nTELEMETRY: {args.telemetry}\n"
        f"TELEMETRY_DIR: {args.telemetry_dir}\n{mesh_keys}"
        f"BACKEND: {args.backend}\n")
    return params, tfail, tremove


def device_info(dev) -> dict:
    """The device's name and power limit; on a card as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    import torch
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        line = out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else ""
    except (OSError, subprocess.TimeoutExpired):
        line = ""
    name, _, limit = line.partition(",")
    return {"name": name.strip() or torch.cuda.get_device_name(index),
            "power_limit": limit.strip() or None}


def layout_of(launches: dict) -> str:
    """The layout the run's kernels ran: ``folded``, ``natural`` or
    ``none`` (no kernel: the scatter exchange, ``tpu_sparse``)."""
    if any(v for k, v in launches.items() if "folded" in k):
        return "folded"
    return "natural" if any(launches.values()) else "none"


def run(args) -> tuple:
    """One scale-smoke run -> ``(record, ok, why)``."""
    import torch

    from distributed_membership_tpu_torch import kernels
    from distributed_membership_tpu_torch.backends import get_backend
    from distributed_membership_tpu_torch.observability.timeline import (
        timeline_summary)
    from distributed_membership_tpu_torch.runtime.application import (
        resolve_device)

    dev = resolve_device(args.device)
    params, tfail, tremove = scale_params(args)
    on_card = dev.type == "cuda"
    build_s = None
    if on_card:
        t0 = time.time()
        kernels.build()
        build_s = time.time() - t0
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    before = dict(kernels.LAUNCHES)
    t0 = time.time()
    result = get_backend(args.backend)(params, seed=args.seed, device=dev)
    if on_card:
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    summary = result.extra["detection_summary"]

    floor_ok = (summary.get("trackers_per_failed_min", args.trackers_floor)
                >= args.trackers_floor)
    ok = (summary["false_removals"] == 0
          and summary["observer_completeness"] == 1.0
          and summary.get("detected_by_someone", 1.0) == 1.0
          and floor_ok)
    record = {
        "backend": args.backend,
        "platform": "gpu" if on_card else "cpu",
        "mesh_size": result.extra.get("mesh_size", 1),
        "n": args.n, "ticks": args.ticks,
        "view_size": args.view, "gossip_len": args.gossip,
        "probes": args.probes, "fanout": args.fanout,
        "tfail": tfail, "tremove": tremove, "seed": args.seed,
        "drop_prob": args.drop, "shift_set": args.shift_set,
        "rack_size": args.rack_size, "rack_failures": args.rack_failures,
        "trackers_floor": args.trackers_floor, "trackers_floor_ok": floor_ok,
        "timing": "cold_compile_included",
        "exchange": (params.resolved_exchange()
                     if args.backend != "tpu_sparse" else "sorted_mailbox"),
        "wall_seconds": round(wall, 2),
        "node_ticks_per_sec": round(args.n * args.ticks / wall, 1),
        "verdict_ok": ok,
        "detection": summary,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "device": device_info(dev),
    }
    if on_card:
        launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                    if v != before[k]}
        record.update({
            "layout": layout_of(launches),
            "launches": launches,
            "ms_per_tick": wall * 1e3 / args.ticks,
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "build_seconds": round(build_s, 2),
        })
    if "timeline" in result.extra:
        record["timeline"] = timeline_summary(result.extra["timeline"])
        record["timeline_path"] = result.extra.get("timeline_path")
    why = None
    if not ok:
        why = ("trackers_per_failed_min below --trackers-floor"
               if not floor_ok else "detection verdicts not clean")
    return record, ok, why


def bank(record: dict, out: str) -> None:
    """Append ``record`` to the JSON list in ``out``."""
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    existing = []
    if os.path.exists(out):
        with open(out) as fh:
            existing = json.load(fh)
    existing.append(record)
    with open(out, "w") as fh:
        json.dump(existing, fh, indent=1)


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.telemetry_dir and args.telemetry == "off":
        args.telemetry = "scalars"
    if args.telemetry == "scalars" and args.backend == "tpu_sparse":
        ap.error("--telemetry scalars requires a ring backend "
                 "(tpu_hash / tpu_hash_sharded)")
    record, ok, why = run(args)
    bank(record, args.out)
    print(json.dumps(record))
    if not ok:
        print(f"SCALE SMOKE FAILED: {why}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
