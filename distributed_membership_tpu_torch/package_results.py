"""Package a graded run into a single self-contained results archive (the
JAX package's ``scripts/package_results.py``, on the port).

Runs all three grading scenarios on the chosen backend and ``--device``
(the same run-and-grade core as the application's ``--grade-all``), then
writes a ``.tar.gz`` containing:

  * ``manifest.json`` -- backend, seed, per-scenario scores, total, the
    device the run used (``platform``; ``jax_version`` is null: the port
    runs no jax), timestamp;
  * per scenario: ``dbg.log``, ``stats.log``, ``msgcount.log`` exactly as
    the reference's Application would leave them.

Usage:
  python -m distributed_membership_tpu_torch.package_results \\
      --backend tpu_hash --out results.tar.gz

``--device`` defaults to ``cuda``; without a card the run raises rather
than running on the CPU (the ``emul`` backends run on the host whatever
the device, which is still checked).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tarfile
import tempfile
import time

from distributed_membership_tpu_torch.runtime.application import (
    SCENARIOS, default_testcases_dir, resolve_device, run_scenario_graded)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_membership_tpu_torch.package_results")
    ap.add_argument("--backend", default="emul")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results.tar.gz")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--testcases", default=default_testcases_dir())
    args = ap.parse_args(argv)

    platform = resolve_device(args.device).type

    files: dict[str, bytes] = {}
    scores = {}
    total = max_total = 0
    for scenario in SCENARIOS:
        with tempfile.TemporaryDirectory() as tmp:
            _, g = run_scenario_graded(scenario, args.testcases,
                                       args.backend, args.seed, tmp,
                                       device=args.device)
            for log_name in ("dbg.log", "stats.log", "msgcount.log"):
                path = os.path.join(tmp, log_name)
                if os.path.exists(path):
                    with open(path, "rb") as fh:
                        files[f"{scenario}/{log_name}"] = fh.read()
        scores[scenario] = {"points": g.points, "max": g.max_points,
                            "details": g.details}
        total += g.points
        max_total += g.max_points

    manifest = {
        "backend": args.backend,
        "seed": args.seed,
        "platform": platform,
        "jax_version": None,
        "scores": scores,
        "total_points": total,
        "max_points": max_total,
        "passed": total == max_total,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    files["manifest.json"] = json.dumps(manifest, indent=1).encode()

    now = int(time.time())
    with tarfile.open(args.out, "w:gz") as tar:
        for name, data in sorted(files.items()):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mtime = now
            tar.addfile(info, io.BytesIO(data))

    print(json.dumps({"out": args.out, "total_points": total,
                      "passed": total == max_total}))
    return 0 if total == max_total else 1


if __name__ == "__main__":
    sys.exit(main())
