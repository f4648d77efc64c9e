"""Run a chaos campaign: fuzz schedules, run them, grade, shrink (the CLI
of the JAX package's ``scripts/chaos_campaign.py``, with ``--device``).

    # 8 seeded schedules at N=65536 on the card, auto-shrinking:
    python -m distributed_membership_tpu_torch.chaos --out /tmp/camp \\
        --n 65536 --schedules 8

    # 64 schedules at N=10 on the CPU (the card refuses VIEW_SIZE 10):
    python -m distributed_membership_tpu_torch.chaos --out /tmp/camp \\
        --device cpu

    # Against a deliberately broken config:
    python -m distributed_membership_tpu_torch.chaos --out /tmp/broken \\
        --n 256 --set DROP_MSG=1 --set MSG_DROP_PROB=0.6 \\
        --mix link_flake=1,drop_window=1 --bank /tmp/regressions

    # Fanned out to a --fleet controller:
    python -m distributed_membership_tpu_torch.chaos --out /tmp/camp \\
        --fleet-port 8800 --fleet-root /srv/fleet

Exit status 0 only if every run passed every oracle invariant; 2 when the
port refuses the campaign's geometry on the device.
"""

from __future__ import annotations

import argparse
import sys

from distributed_membership_tpu_torch.chaos import (
    CampaignSpec, run_campaign)


def _parse_mix(text):
    mix = {}
    for part in text.split(","):
        kind, _, w = part.partition("=")
        if not w:
            raise argparse.ArgumentTypeError(
                f"{part!r}: expected kind=weight")
        mix[kind.strip()] = float(w)
    return mix


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_membership_tpu_torch.chaos",
        description="seeded chaos campaign: fuzz, run, grade, shrink")
    ap.add_argument("--out", required=True,
                    help="campaign dir (scenarios/, campaign.jsonl, "
                         "regressions/)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--schedules", type=int, default=64)
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--total", type=int, default=160,
                    help="tick budget per run")
    ap.add_argument("--tfail", type=int, default=8)
    ap.add_argument("--tremove", type=int, default=20)
    ap.add_argument("--events", type=int, default=6,
                    help="events per schedule")
    ap.add_argument("--mix", type=_parse_mix, default=None,
                    metavar="KIND=W,KIND=W",
                    help="event-mix weights (default: fuzz.DEFAULT_MIX)")
    ap.add_argument("--name", default="chaos")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="conf override (repeatable) — e.g. a "
                         "deliberately broken TREMOVE=4")
    ap.add_argument("--fleet-port", type=int, default=None,
                    help="fan out to a --fleet controller instead of "
                         "running in-process")
    ap.add_argument("--fleet-root", default=None,
                    help="the controller's root dir (for grading run "
                         "artifacts)")
    ap.add_argument("--no-shrink", action="store_true",
                    help="journal violations but skip delta debugging")
    ap.add_argument("--bank", default=None,
                    help="where minimal repros land (default: "
                         "OUT/regressions)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where in-process runs and the shrinker's "
                         "probes run (default: the card)")
    args = ap.parse_args(argv)

    overrides = {}
    for spec_txt in args.set:
        key, _, val = spec_txt.partition("=")
        if not val:
            ap.error(f"--set {spec_txt!r}: expected KEY=VALUE")
        overrides[key.strip()] = val.strip()
    spec = CampaignSpec(seed=args.seed, schedules=args.schedules,
                        n=args.n, total=args.total, tfail=args.tfail,
                        tremove=args.tremove, events=args.events,
                        mix=args.mix, name=args.name)
    mode = "inproc" if args.fleet_port is None else "fleet"
    if mode == "fleet" and not args.fleet_root:
        ap.error("--fleet-port needs --fleet-root")
    try:
        summary = run_campaign(
            spec, args.out, overrides=overrides, mode=mode,
            port=args.fleet_port, fleet_root=args.fleet_root,
            shrink=not args.no_shrink, bank_dir=args.bank,
            progress=lambda s: print(f"chaos_campaign: {s}"),
            device=args.device)
    except NotImplementedError as e:
        print(f"chaos_campaign: refused on {args.device}: {e}",
              file=sys.stderr)
        return 2
    print(f"chaos_campaign: {summary['runs']} runs, "
          f"{len(summary['violations'])} violations"
          + (f", {len(summary['repros'])} repros banked"
             if summary["repros"] else ""))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
