"""Phase-diagram sweep: fanout x drop-rate grid (counterpart of the JAX
package's ``sweeps/phase.py``; BASELINE.json config #5).

Maps the detection phase boundary of the gossip/SWIM protocol: for each
(fanout, drop_rate) cell the sweep runs the ``tpu_hash`` scale protocol
from a warm bootstrap, crashes one node, and records detection
completeness, latency percentiles, false removals, and message volume.

The step is built once with dynamic knobs (``backends.tpu_hash``
``step_and_init(cfg, dynamic_knobs=True)``): each cell passes its fanout
and drop probability per call.  The JAX package vmaps one compiled step
over the grid; here the grid is a host loop over cells, since torch has
nothing to compile.  On the ring exchange each cell draws its ticks' RNG
plans ``HOIST_TICKS`` at a time, one pass per stream (``RNG_MODE:
hoisted``'s draw, ``tpu_hash.ring_rng_plans``): the same bits as the
per-tick draw, in a third of a tick's launches.

Every random stream is the JAX sweep's: the tick keys
``fold_in(make_run_key(params, seed), t)``, the warm init at ``seed ^
0x5EED`` and the failed node ``randint(make_run_key(params, seed ^
0xFA11), (), 0, N)``, so the records equal the JAX ``run_sweep``'s field
for field.  The failed node varies per cell, so the events fold into
AggStats (per-id accumulators), as in JAX; on the card an S < 128 grid
runs the folded layout's AggStats route (K5-K7).

Drops here apply to the WHOLE run (the phase variable is the channel's
loss rate), unlike the grading scenarios' [50, 300) window
(Application.cpp:177-179).

CLI: ``python -m distributed_membership_tpu_torch.sweeps.phase --out DIR
[--quick] [--regime default|s16] [--n N] [--exchange ring|scatter]
[--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from distributed_membership_tpu_torch.backends.tpu_hash import (
    make_config, ring_rng_plans, step_and_init)
from distributed_membership_tpu_torch.config import Params
from distributed_membership_tpu_torch.observability.aggregates import (
    LAT_BINS, latency_stats)
from distributed_membership_tpu_torch.ops.threefry import randint
from distributed_membership_tpu_torch.runtime.failures import (
    PlanTensors, make_run_key)

# Ticks whose RNG plans a ring cell draws in one pass (a block of N=65536,
# S=16 plans holds ~0.55 GB of coins).
HOIST_TICKS = 32


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    n: int = 4096
    view_size: int = 32
    gossip_len: int = 8
    probes: int = 8          # cycle = 4 ticks
    tfail: int = 8
    tremove: int = 24
    ticks: int = 120
    fail_time: int = 60
    exchange: str = "auto"   # both lowerings sweepable
    fanouts: Sequence[int] = tuple(range(1, 9))
    drop_rates: Sequence[float] = (0.0, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3)
    seeds: Sequence[int] = (0, 1, 2)
    name: str = "phase_sweep"   # artifact file stem

    def to_params(self) -> Params:
        """The sweep's conf; fanout here is only the static bound (cells
        pass theirs per call).  ``FUSED_*`` and ``FOLDED`` stay on auto:
        the JAX sweep pins them off because its fusegate could resolve
        the TPU kernels on under a banked record, which its dynamic-knob
        step refuses; the port has no fusegate, and on the card its
        kernels are the path (K5-K7 on the folded layout for S < 128, K1-K3
        otherwise).  The records do not depend on the layout."""
        return Params.from_text(
            f"MAX_NNB: {self.n}\nSINGLE_FAILURE: 1\nDROP_MSG: 0\n"
            f"MSG_DROP_PROB: 0\nVIEW_SIZE: {self.view_size}\n"
            f"GOSSIP_LEN: {self.gossip_len}\nPROBES: {self.probes}\n"
            f"FANOUT: {max(self.fanouts)}\nTFAIL: {self.tfail}\n"
            f"TREMOVE: {self.tremove}\nTOTAL_TIME: {self.ticks}\n"
            f"FAIL_TIME: {self.fail_time}\nJOIN_MODE: warm\n"
            f"EVENT_MODE: agg\nEXCHANGE: {self.exchange}\n"
            f"BACKEND: tpu_hash\n")

    @staticmethod
    def north_star() -> "SweepSpec":
        """The S=16 scale regime (N=65536, cycle 8) at the 5-cycle default
        TREMOVE: maps the loss knee Params.min_tremove_cycles_under_loss
        guards against, at the scale the claims are quoted for."""
        return SweepSpec(
            n=65536, view_size=16, gossip_len=4, probes=2, tfail=16,
            tremove=40, ticks=160, fail_time=80,
            fanouts=(3,), drop_rates=(0.0, 0.05, 0.1, 0.15, 0.25),
            seeds=(0, 1), name="phase_sweep_s16")


def run_sweep(spec: SweepSpec = SweepSpec(), device=None,
              progress: Optional[Callable[[dict, float], None]] = None
              ) -> list[dict]:
    """Execute the grid on ``device`` (None: ``cuda``); returns one record
    per (fanout, drop, seed), in the JAX ``run_sweep``'s order.
    ``progress(record, seconds)`` is called after each cell with its
    wall seconds."""
    from distributed_membership_tpu_torch.runtime.application import (
        resolve_device)
    dev = resolve_device("cuda" if device is None else device)
    params = spec.to_params()
    cfg = make_config(params, collect_events=False, device=dev)
    if cfg.probe_io_lag:
        # The JAX sweep's refusal: its scan has no lag tail, so totals
        # would lose the final tick's ack sends.
        raise ValueError("PROBE_IO approx_lag is not supported by the "
                         "sweep driver (no lag tail in its scan)")
    # The crashed node varies per cell: AggStats, not the static-id
    # FastAgg path.
    cfg = dataclasses.replace(cfg, fast_agg=False, fail_ids=())
    step, init = step_and_init(cfg, dynamic_knobs=True)
    n, total = spec.n, spec.ticks
    start_ticks = torch.full((n,), -1, dtype=torch.int32, device=dev)

    records = []
    for fanout in spec.fanouts:
        for drop in spec.drop_rates:
            for seed in spec.seeds:
                t0 = time.perf_counter()
                # The crashed node varies with the seed, as
                # Application::fail's rand() % N does.
                failed = int(randint(make_run_key(params, seed ^ 0xFA11),
                                     (), 0, n, "cpu"))
                fail_mask = torch.zeros((n,), dtype=torch.bool, device=dev)
                fail_mask[failed] = True
                plan = PlanTensors(
                    root=make_run_key(params, seed), start_ticks=start_ticks,
                    fail_mask=fail_mask, fail_time=spec.fail_time,
                    drop_lo=-1, drop_hi=total + 1)   # drops active all run
                state = init(cfg, make_run_key(params, seed ^ 0x5EED), dev)
                state = _run_cell(cfg, functools.partial(
                    step, fanout=fanout, drop_prob=drop), state, plan,
                    total, dev)
                records.append(_record(state.agg, failed, fanout, drop,
                                       seed))
                if progress is not None:
                    progress(records[-1], time.perf_counter() - t0)
    return records


def _run_cell(cfg, step, state, plan: PlanTensors, total: int, dev):
    """Ticks ``[0, total)`` of one cell; on the ring the RNG plans come
    in blocks of HOIST_TICKS, drop coins included (the dynamic-knob step
    draws them at every drop rate)."""
    ring = cfg.exchange == "ring"
    for a in range(0, total, HOIST_TICKS):
        ticks = range(a, min(a + HOIST_TICKS, total))
        plans = (ring_rng_plans(cfg, [plan.tick_key(t) for t in ticks], dev,
                                use_drop=True) if ring else None)
        for i, t in enumerate(ticks):
            kw = {} if plans is None else {"rng": plans[i]}
            state, _ = step(state, t, plan.tick_key(t), plan, **kw)
    return state


def _record(agg, failed: int, fanout: int, drop: float, seed: int) -> dict:
    hist = agg.lat_hist.cpu().numpy()
    lstats = latency_stats(hist)
    trackers = int(agg.tracker_obs.sum())
    detecting = int((agg.det_obs & agg.tracker_obs).sum())
    return {
        "fanout": int(fanout), "drop_rate": float(drop), "seed": int(seed),
        "false_removals": int(agg.rm_count.sum() - agg.det_count.sum()),
        "trackers": trackers,
        "observer_completeness": detecting / trackers if trackers else 1.0,
        "detections": int(agg.det_count[failed]),
        "latency_p50": lstats.get("latency_p50"),
        "latency_p99": lstats.get("latency_p99"),
        "latency_overflow": int(hist[LAT_BINS - 1]),
        "msgs_sent": int(agg.sent_total.sum()),
    }


def summarize(records: list[dict]) -> list[dict]:
    """Collapse seeds: one row per (fanout, drop_rate) cell with means."""
    cells: dict = {}
    for r in records:
        cells.setdefault((r["fanout"], r["drop_rate"]), []).append(r)
    rows = []
    for (fanout, drop), rs in sorted(cells.items()):
        rows.append({
            "fanout": fanout, "drop_rate": drop, "runs": len(rs),
            "observer_completeness_mean": float(np.mean(
                [r["observer_completeness"] for r in rs])),
            "false_removals_mean": float(np.mean(
                [r["false_removals"] for r in rs])),
            "latency_p50_mean": (float(np.mean(
                [r["latency_p50"] for r in rs
                 if r["latency_p50"] is not None]))
                if any(r["latency_p50"] is not None for r in rs) else None),
            "msgs_sent_mean": float(np.mean([r["msgs_sent"] for r in rs])),
        })
    return rows


def write_artifacts(records, rows, out_dir: str,
                    name: str = "phase_sweep") -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}_runs.json"), "w") as fh:
        json.dump(records, fh, indent=1)
    with open(os.path.join(out_dir, f"{name}_grid.csv"), "w") as fh:
        cols = list(rows[0].keys())
        fh.write(",".join(cols) + "\n")
        for r in rows:
            fh.write(",".join(str(r[c]) for c in cols) + "\n")


def main(argv=None) -> int:
    """The flags of the JAX package's ``scripts/phase_sweep.py``, with
    ``--device`` for ``--platform`` and ``--out`` for its fixed output
    directory."""
    ap = argparse.ArgumentParser(
        prog="python -m distributed_membership_tpu_torch.sweeps.phase",
        description="fanout x drop-rate phase-diagram sweep")
    ap.add_argument("--out", required=True,
                    help="directory for NAME_runs.json and NAME_grid.csv")
    ap.add_argument("--quick", action="store_true",
                    help="3x3x2 smoke grid at N=1024")
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--regime", default="default",
                    choices=["default", "s16"],
                    help="'s16' = the N=65536 S=16 north-star slice "
                         "(SweepSpec.north_star)")
    ap.add_argument("--exchange", default="auto",
                    choices=["auto", "ring", "scatter"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    spec = (SweepSpec.north_star() if args.regime == "s16" else SweepSpec())
    kwargs = {}
    if args.quick:
        kwargs = dict(fanouts=(1, 3, 6), drop_rates=(0.0, 0.1, 0.3),
                      seeds=(0, 1), n=1024, name=f"{spec.name}_quick")
    if args.n:
        kwargs["n"] = args.n
        kwargs["name"] = f"{kwargs.get('name', spec.name)}_n{args.n}"
    if args.exchange != "auto":
        kwargs["exchange"] = args.exchange
        kwargs["name"] = f"{kwargs.get('name', spec.name)}_{args.exchange}"
    spec = dataclasses.replace(spec, **kwargs)

    t0 = time.time()
    records = run_sweep(spec, device=args.device)
    wall = time.time() - t0
    rows = summarize(records)
    write_artifacts(records, rows, args.out, name=spec.name)
    print(json.dumps({
        "device": args.device, "cells": len(rows), "runs": len(records),
        "n": spec.n, "ticks_per_run": spec.ticks,
        "wall_seconds": round(wall, 1),
        "worst_completeness": min(r["observer_completeness_mean"]
                                  for r in rows),
    }))
    for r in rows:
        print(f"  fanout={r['fanout']} drop={r['drop_rate']:.2f} "
              f"completeness={r['observer_completeness_mean']:.3f} "
              f"false={r['false_removals_mean']:.1f} "
              f"p50={r['latency_p50_mean']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
