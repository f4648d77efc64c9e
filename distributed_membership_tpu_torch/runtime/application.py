"""Application entry point: conf in, dbg.log / stats.log / msgcount.log out
(the JAX package's ``runtime/application.py``, for the port's backend).

The run's device is explicit.  The default is ``cuda``: without a GPU
the run raises rather than quietly running on the CPU; ``--device cpu``
runs the plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from distributed_membership_tpu_torch.backends import RunResult, get_backend
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.eventlog import EventLog
from distributed_membership_tpu_torch.observability.metrics import (
    write_msgcount)


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


def run_conf(conf_path: str, seed: int | None = None, out_dir: str = ".",
             device="cuda") -> RunResult:
    dev = resolve_device(device)
    params = Params.from_file(conf_path)
    log = EventLog(out_dir)
    result = get_backend(params.BACKEND)(params, log, seed=seed, device=dev)
    result.log.flush(out_dir)
    if not result.extra.get("aggregate"):
        write_msgcount(result, out_dir)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_membership_tpu_torch",
        description="Gossip membership simulator, PyTorch/CUDA port "
                    "(tpu_hash ring exchange, warm join)")
    ap.add_argument("conf", help="testcase .conf file")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the GPU with the CUDA kernels (default) "
                         "or on the CPU with their plain versions")
    ap.add_argument("--json", action="store_true",
                    help="print a JSON summary line")
    args = ap.parse_args(argv)
    result = run_conf(args.conf, seed=args.seed, out_dir=args.out_dir,
                      device=args.device)
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
    if args.json:
        print(json.dumps(summary))
    else:
        for k, v in summary.items():
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
