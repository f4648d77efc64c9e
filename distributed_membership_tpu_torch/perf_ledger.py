"""Perf ledger CLI: ingest the port's banked records, check regressions
(the JAX package's ``scripts/perf_ledger.py``).

    L="python -m distributed_membership_tpu_torch.perf_ledger"
    $L                          # ingest + summary
    $L --check                  # + regression gate (rc 1)
    $L --check --no-ingest      # gate only

Ingestion reads the port's banked scale-smoke records
(``artifacts/SCALE_SMOKE_TORCH.json``), normalizes them into keyed rows
(observability/perfdb.py) and appends anything new to
``artifacts/perf_ledger_torch.jsonl``.  Re-running is a no-op.
``--check`` walks the full ledger oldest-first and fails on any row that
dropped more than the noise band below the best earlier row with the
same key; a row's key holds the card it ran on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from distributed_membership_tpu_torch.observability import perfdb


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_membership_tpu_torch.perf_ledger",
        description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=".",
                    help="repo root holding the banked artifacts")
    ap.add_argument("--ledger", default=None,
                    help="ledger path (default "
                         "<root>/artifacts/perf_ledger_torch.jsonl)")
    ap.add_argument("--check", action="store_true",
                    help="fail (rc 1) on regressions beyond the noise band")
    ap.add_argument("--no-ingest", action="store_true",
                    help="skip artifact scanning; operate on the ledger as-is")
    ap.add_argument("--band", type=float, default=perfdb.DEFAULT_NOISE_BAND,
                    help="regression noise band as a fraction (default %(default)s)")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON")
    args = ap.parse_args(argv)

    ledger = args.ledger or os.path.join(args.root, perfdb.LEDGER_PATH)
    added = 0
    if not args.no_ingest:
        added = perfdb.append_rows(perfdb.collect_all(args.root), ledger)
    rows = perfdb.load_ledger(ledger)
    regressions = perfdb.check(rows, band=args.band) if args.check else []

    summary = {
        "ledger": ledger,
        "rows_total": len(rows),
        "rows_added": added,
        "keys": len({r["key"] for r in rows}),
        "checked": bool(args.check),
        "band": args.band,
        "regressions": regressions,
    }
    if args.json:
        print(json.dumps(summary, indent=2))
    else:
        print(f"perf_ledger: {len(rows)} rows ({added} new), "
              f"{summary['keys']} keys -> {ledger}")
        if args.check and not regressions:
            print(f"perf_ledger: check OK (band {args.band:.0%})")
        for r in regressions:
            print(f"perf_ledger: REGRESSION {r['rung']} {r['metric']}: "
                  f"{r['value']:.1f} vs best {r['best']:.1f} "
                  f"(-{r['drop_pct']}%, band {r['band_pct']}%) "
                  f"[{r['source']}]")
    return 1 if regressions else 0


if __name__ == "__main__":
    sys.exit(main())
