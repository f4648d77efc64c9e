#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. build   -- compile the CUDA kernels of csrc/ with nvcc for sm_90a;
  2. kernels -- hold each kernel against its plain PyTorch version on the
                card (bit-exact: integer outputs, tolerance 0), and time
                kernel, plain version and the device-memory bound: K1-K3
                at N=2^20, S=128, P=16, k_max=3; K5-K7 on the folded
                layout at N=2^20, S=16, P=2, k_max=3;
  3. main    -- run_conf on confs/ring_1m_s128.conf (the bench.py hash
                geometry at N=2^20, drop-free, EVENT_MODE agg; 72 ticks
                with the crash at 24, as DEPTH_CUTS cuts the natural 1M
                runs);
                every kernel of the path must launch once per tick, with no
                false removal and at least one detection;
  4. lossy   -- the same geometry with 5% message drops for 64 ticks
                (confs/ring_1m_s128_drop.conf), driving K2's masks form;
  5. parity  -- a small N=256 full-event conf on the card (kernels) and on
                the CPU (plain versions): dbg.log, stats.log and
                msgcount.log must be byte-identical;
  6. folded  -- run_conf on confs/ring_1m_s16_folded.conf (the bench.py
                S=16 geometry at N=2^20 on the folded layout, drop-free,
                160 ticks): K5-K7 once per tick and no natural kernel, no
                false removal, at least one detection;
  7. folded_lossy  -- the same with 5% drops for 64 ticks
                (confs/ring_1m_s16_folded_drop.conf);
  8. folded_parity -- confs/ring_16k_s16_folded_drop.conf (84 ticks) on
                the card and on the CPU: the detection summary and every
                leaf of the final state must be identical;
  9. sharded -- run_conf on confs/ring_1m_s128_sharded.conf (the main
                path's geometry on the sharded backend, one shard, 72
                ticks): K1, K4 and K3 once per tick and no other kernel, no
                false removal, at least one detection;
 10. sharded_lossy -- confs/ring_1m_s128_sharded8_drop.conf: eight shards
                on the card, 5% drops, 64 ticks, at least one detection;
 11. sharded_parity -- confs/ring_256_s128_sharded8_drop.conf (N=256, eight
                shards of 32 rows, full events) on the card and on the
                CPU: the three logs must be byte-identical.
 12. grade   -- the grader's three testcases (N=10, staggered joins, the
                scatter exchange) through `--grade-all` on the card and on
                the CPU: both must print "Final grade 90" and write
                byte-identical logs; the scatter step launches no kernel,
                and a run's final state lies on the card;
 13. scatter_parity -- confs/scatter_2k_s128_drop.conf (the scatter
                exchange at N=2048 with 5% drops, probes through the hashed
                probe mailbox; 130 of its 200 ticks) on the card and on the
                CPU: byte-identical logs, no kernel launched;
 14. cold_parity -- confs/ring_256_s128_staggered_drop.conf (staggered joins
                on the ring, 5% drops, 160 ticks) on tpu_hash (K1, K2's
                masks form and K3 once per tick) and its sharded twin on
                eight shards (K1, K4, K3 once per tick), each on the card
                and on the CPU: byte-identical logs.
 15. sharded_folded -- run_conf on confs/ring_1m_s16_folded_sharded.conf (the
                S=16 geometry at N=2^20 on tpu_hash_sharded, one shard,
                FOLDED: 1, drop-free, 160 ticks): K5-K7 once per tick, no
                false removal, at least one detection;
 16. sharded_folded_lossy -- confs/ring_1m_s16_folded_sharded8_drop.conf:
                eight shards, 5% drops, 64 ticks, TELEMETRY hist: K5, K6
                (one eight-shard launch) and K7's hist form once per tick,
                and the timeline reconciles with the detection summary;
 17. sharded_folded_parity -- confs/ring_16k_s16_folded_sharded8_drop.conf
                (N=2^14, eight shards, 5% drops, TELEMETRY hist, 84 ticks)
                on the card and on the CPU: the summary, every final-state
                leaf and every timeline series identical;
 18. telemetry -- confs/ring_1m_s128_hist.conf (the main path's geometry
                with TELEMETRY hist, 72 ticks, crash at tick 24): K3's hist
                form once per tick, the timeline reconciles with the
                summary; then confs/ring_256_s128_drop.conf with TELEMETRY
                hist on the card against the CPU: its logs equal the CPU's
                with TELEMETRY off, its timeline the CPU's with hist.
 19. scenario -- confs/ring_1m_s128_partition.conf (the main path's
                geometry, 128 ticks, TELEMETRY scalars, the halves
                partitioned over (40, 100], then healed): K1, K2's masks
                form and K3 once per tick, the timeline reconciles, and
                the oracle's partition entry and invariants are printed;
 20. scenario_folded -- confs/ring_1m_s16_folded_churn.conf (the folded
                S=16 geometry, 160 ticks: crash, restart, a 20% link flake
                between the halves, a delay window): K5-K7 once per tick,
                the restarted nodes rejoin, detections > 0;
 21. scenario_sharded -- confs/ring_1m_s128_sharded8_partition.conf (eight
                shards, 64 ticks, a cut inside a shard, a 10% one-way
                flake): K1, K4 and K3 once per tick;
 22. scenario_parity -- confs/ring_256_s128_scenario.conf (N=256, every
                event kind, full events) on the card and on the CPU: the
                three logs and the oracle report identical; then
                confs/ring_16k_s16_folded_sharded8_scenario.conf (N=2^14,
                eight shards, folded, TELEMETRY scalars): the summary,
                every final-state leaf, every series and the report
                identical.
 23. checkpoint -- confs/ring_1m_s128_ckpt.conf (the main path in 40-tick
                segments, TELEMETRY scalars, 72 ticks): with no
                directory, then with snapshots under --out-dir killed at
                tick 20 (DM_CRASH_AT_TICK; the manifest at 40) and resumed
                for the last segment, where the detections fall; each
                run's summary equals main's, every kernel once per tick
                driven; prints the free disk, the snapshot bytes, each
                segment's device_sync_s/flush_s/ckpt_wait_s (runlog.jsonl)
                and ticks/s against main;
 24. checkpoint_sharded_folded -- confs/ring_1m_s16_folded_sharded8_drop.conf
                in 16-tick segments, killed at 40 (the manifest at 48) and
                resumed: summary and timeline equal sharded_folded_lossy's;
 25. mega    -- confs/ring_1m_s16_folded_mega.conf (the folded path in
                8-tick blocks with the packed carry): summary equals
                folded's; prints ms/tick against folded and carry_bytes;
 26. hoisted -- confs/ring_1m_s128_hoisted.conf (RNG_MODE hoisted, 8-tick
                segments, 72 ticks): summary equals main's; prints
                ms/tick, launches per tick and the peak device memory;
 27. checkpoint_parity -- confs/ring_256_s128_drop.conf and
                confs/ring_256_s128_scenario.conf killed on the card and
                resumed on the CPU, and the reverse: the three logs and
                the oracle report byte-identical to the CPU's
                uninterrupted run.
 28. legacy  -- the legacy threefry stream (threefry.partitionable(False),
                as JAX_THREEFRY_PARTITIONABLE=0 sets it): the main path
                for 40 ticks; confs/ring_256_s128_drop.conf card vs CPU
                (byte-identical logs); 2^20 (and 2^20 + 1) legacy bits
                card == CPU;
 29. multi   -- confs/ring_1m_s128_multi.conf (524,288 failed ids, the
                AggStats path, 64 ticks): K1-K3 once per tick, detections
                and no false removal; confs/ring_16k_s128_sharded8_multi.conf
                (eight shards, 20-tick segments, merge_agg); N=2048 card vs
                CPU (summary and every final-state leaf);
 30. shift_set -- confs/ring_1m_s128_shiftset.conf (SHIFT_SET 16, 40 ticks,
                the table's shifts through K2) and its folded S=16 twin
                (K6); N=256 with SHIFT_SET 16 card vs CPU;
 31. buffsize -- ENFORCE_BUFFSIZE (EN_BUFFSIZE 30000) with cold joins card vs
                CPU at N=256 (staggered) and N=4096 (batch, 60 ticks, crash
                at 20), and 20 ticks at N=2^20 through K2's masks form;
 32. approx_lag -- the main path's geometry for 20 ticks with PROBE_IO
                approx_lag in 10-tick segments: its summary (run totals
                included) equals PROBE_IO exact's; PROBE_IO none for 20
                ticks; N=256 approx_lag card vs CPU;
 33. wide    -- confs/ring_16k_full.conf (VIEW_SIZE 0: S = N = 16384, 80
                ticks): K2's wide-row form once per tick, detections and no
                false removal; its eight-shard twin (K4's wide-row form, 40
                ticks); N=4352 full view card vs CPU (13 ticks, TFAIL 4,
                TREMOVE 8).  Phase 2 holds K2 and K4's wide forms (row
                chunks of 4096 columns) and K1 and K3 at N = S = 16384
                against their plain versions, K2's k_eff form also with
                every gate open.
 34. folded_probes0 -- confs/ring_1m_s16_folded_probes0.conf (the folded
                S=16 path with PROBES 0, the Params default; 120 ticks):
                K5 and K6 once per tick and K7 never, detections > 0; its
                N=2^14 lossy twin card vs CPU (summary and every leaf);
 35. serve   -- confs/ring_1m_s128_serve.conf (the main path's geometry,
                40 ticks in 10-tick segments) batch, then served by the
                service daemon (service/daemon.py, in this process) under
                four query threads reading /v1/census and /v1/member/<i>
                (one request every 20 ms each) and a /metrics scraper:
                K1-K3 once per tick, the summary equals the batch run's;
                prints ms/tick served against batch, the hook's host pull
                per publishing boundary, each derive's mode and ms, the
                boundaries the publisher skipped, the daemon's query
                p50/p99 and the peak device memory; then at N=4096 (20
                ticks) the engine idle, under four closed-loop threads
                with the query gate and, for up to 5 s, without it;
 36. serve_inject -- confs/ring_4k_s128_serve_inject.conf (N=4096, full
                events): a crash injected over POST /v1/events while the
                engine is parked at boundary 0, uninterrupted; the same
                run stopped over POST /v1/admin/shutdown at 30, resumed
                served with --resume and stopped at 60, then resumed
                headless through run_conf: the three logs and
                timeline.jsonl byte-identical to the uninterrupted run and
                to the CPU's served run with the same injection;
 37. serve_sharded -- confs/ring_16k_s128_sharded8_serve.conf (eight
                shards, N=2^14, full events) served with the crash
                injected at boundary 0: K1, K4 and K3 once per tick, logs
                and timeline byte-identical to the CPU's run of the union
                scenario (the same event as a SCENARIO file);
 38. serve_replicas -- confs/ring_16k_s128_serve_replicas.conf (N=2^14,
                two read-replica processes on a four-slot shm ring) under
                four closed-loop client processes on the replicas: each
                replica's /v1/census equals the daemon's at ticks 0 and
                60, the summary equals the batch run's, and no ring
                segment of this process is left in /dev/shm after the
                shutdown; prints ms/tick served against batch and the
                replicas' query rate.
 39. reshard -- elastic resharding (elastic/reshard.py) on the card, two
                arms.  Scale in, folded: the eight-shard checkpoint that
                checkpoint_sharded_folded's killed run left at tick 48,
                resharded in place to MESH_SHAPE 4x2 (the codec round trip
                on the card) and resumed with --mesh-shape 4x2: summary,
                detection summary and timeline series equal to a 4x2 twin
                chunked at 16 from tick 0; K5, K6 and K7 (hist) once per
                resumed tick.  Scale out, natural: ring_1m_s128_sharded
                (one shard) at 64 ticks with the crash at 24, killed at 40
                (manifest at 48), its 1.77 GB checkpoint resharded to
                MESH_SHAPE 8 and resumed: K1, K4 and K3 once per resumed
                tick, detections and no false removal (D shards draw from
                per-shard streams, so this is its own run, not an
                eight-shard run's twin); the same at N=2^14, resumed on
                the card and on the CPU from the same resharded
                checkpoint: detection summary and final state equal.
                Prints each arm's carry bytes (full and packed), codec
                and redistribution seconds, the reshard's wall, its peak
                device memory and the resumed ticks/s against the twin's
                (the killed one-shard run's for the natural arm);
 40. fleet   -- the fleet controller as a subprocess (python -m
                distributed_membership_tpu_torch fleet.conf --fleet,
                FLEET_MAX_CONCURRENCY 2, FLEET_MIGRATE_ON death; workers on
                the card): ring_1m_s128_serve.conf SIGKILLed after its
                first durable boundary (journaled migrating -> requeued,
                trigger death, relaunched, finished: its logs and summary
                equal the serve phase's batch run), and
                ring_16k_s128_sharded8_serve.conf with serve_sharded's
                crash as an inline scenario, its answers through the fleet
                equal to the worker's own while it runs, then drained with
                POST /v1/runs/s8/migrate (trigger manual): its logs equal
                serve_sharded's.  Each worker holds the card's device
                files while it runs.  Prints the seconds from the SIGKILL
                to the relaunch, downtime_ticks, resume_tick, the fleet's
                /metrics union scraped once and the phase's wall time.
 41. sweep   -- the phase sweep (sweeps/phase.py) SweepSpec.north_star():
                N=65536, S=16, G=4, P=2, TFAIL 16, TREMOVE 40, fanout 3,
                drops 0/0.05/0.1/0.15/0.25, seeds 0 and 1: ten cells of
                160 ticks through the dynamic-knob folded step on its
                AggStats route: K5, K6 and K7 once per tick (1600 each)
                and no other kernel; the drop-free cells complete (1.0)
                with no false removal; prints each cell's record and
                ms/tick; then the quick grid (N=1024, S=32, fanouts 2 and
                5, drops 0 and 0.2, seed 0; DEPTH_CUTS: 60 ticks, crash
                at 16) card == CPU, record for record;
 42. chaos   -- chaos campaigns (chaos/) on the card: 8 default-mix
                schedules at N=65536 (160 ticks, TFAIL 8, TREMOVE 20,
                S=16, P=4), all graded green, K5-K7 once per tick; 2
                schedules of 8 permanent crashes and 4 leaves each (12
                failed ids: the folded AggStats route, checked run by
                run); a migrating schedule (kill, same-shape reshard,
                resume) graded green; an N=256 4-schedule campaign whose
                campaign.jsonl equals the CPU's byte for byte; and JAX
                test_broken_config_shrinks_reproducibly's campaign at
                N=256 (DEPTH_CUTS: its first schedule), the violations
                shrunk and banked on the card and each banked repro
                replayed there to the same violations.
Phase 2 also holds K1's admit_mask form (an int32 [N, S] plane; no path
runs it) at N=2^20, S=128 against its plain version, and K4 (the sharded step's stacked gossip) in both operand
forms at N=2^20, S=128, k_max=3, and on eight shards whose row count is
not a multiple of 128 (two column alignments, per-shard shifts); K6 on
eight shards of 2^17 nodes in one launch, and on short shards at S=2 and
S=4 (one to eight plane rows each); and times K3 a second time on a
removal plane like a tick's (all -1 but 64 removals), and K3 and K7 in
the form the TELEMETRY hist paths run (hist and agg partials at once).
For the gossip kernels K2, K4 and K6 its log lines also give the bytes
the tiled design moves (the payload once per shift) and the rate
achieved on them.
Then it prints one JSON line of kernel numbers, the card's name and power
limit, and last {"ok": true, "device": {...}}.  `--only build,kernels`
runs a subset of the phases and prints no final line; `--only profile`
splits one tick of each 1M conf into its RNG draw, kernels and the rest,
prints a torch.profiler summary with the device's busy share and the
device span of each protocol phase (the dm_* record_function ranges),
profiles the full view (confs/ring_16k_full.conf, N = S = 16384) and
its eight-shard twin the same way, times the 1M natural tick with
TELEMETRY hist against off, and profiles the two 1M single-chip scenario
confs on ticks inside their windows.
The scenario confs name their SCENARIO file relative to the repository
root, so the script runs from there.  Run
outputs (logs, profiler tables) go to --out-dir (default smoke_out/).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N, S, P, K_MAX = 1 << 20, 128, 16, 3
FS, FP = 16, 2                  # the folded path's view size and probes
TFAIL, TREMOVE = 16, 40
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
PHASES = ("build", "kernels", "main", "lossy", "parity", "folded",
          "folded_lossy", "folded_parity", "sharded", "sharded_lossy",
          "sharded_parity", "grade", "scatter_parity", "cold_parity",
          "sharded_folded", "sharded_folded_lossy", "sharded_folded_parity",
          "telemetry", "scenario", "scenario_folded", "scenario_sharded",
          "scenario_parity", "checkpoint", "checkpoint_sharded_folded",
          "mega", "hoisted", "checkpoint_parity", "legacy", "multi",
          "shift_set", "buffsize", "approx_lag", "wide", "folded_probes0",
          "serve", "serve_inject", "serve_sharded", "serve_replicas",
          "reshard", "fleet", "sweep", "chaos")
LOGS = ("dbg.log", "stats.log", "msgcount.log")
OPT_IN = ("profile",)           # run only when named in --only
TPU_KERNEL = {
    "receive_fused": "distributed_membership_tpu/ops/fused_receive.py:176",
    "gossip_fused": "distributed_membership_tpu/ops/fused_gossip.py:195",
    "probe_window_fused": "distributed_membership_tpu/ops/fused_probe.py:137",
    "receive_folded_fused":
        "distributed_membership_tpu/ops/fused_folded.py:123",
    "gossip_folded_stacked":
        "distributed_membership_tpu/ops/fused_folded.py:196",
    "probe_folded_window_fused":
        "distributed_membership_tpu/ops/fused_probe.py:253",
    "gossip_fused_stacked":
        "distributed_membership_tpu/ops/fused_gossip.py:91",
}
CSRC = "distributed_membership_tpu_torch/csrc/"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi exited {out.returncode}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` launches (CUDA
    events, after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(pairs) -> int:
    """Largest |got - want| over output pairs, as integers (0 iff every
    pair is bit-identical)."""
    import torch
    err = 0
    for got, want in pairs:
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{tuple(got.shape)} {got.dtype} != "
                                 f"{tuple(want.shape)} {want.dtype}")
        if got.numel():
            d = (got.to(torch.int64) - want.to(torch.int64)).abs().max()
            err = max(err, int(d))
    return err


def packed(rng, n, occ, hb_hi, shape):
    """Random packed u32 entries (hb * n + id + 1) with occupancy `occ`,
    as int32 bits."""
    import numpy as np
    ids = rng.integers(0, n, size=shape, dtype=np.int64)
    hbs = rng.integers(0, hb_hi, size=shape, dtype=np.int64)
    val = np.where(rng.random(shape, dtype=np.float32) < occ,
                   (hbs * n + ids + 1) & 0xFFFFFFFF, 0)
    return val.astype(np.uint32).view(np.int32)


def nbytes(*ts) -> int:
    return sum(x.numel() * x.element_size() for x in ts)


def conf_variant(conf: str, out_dir: str, name: str, **keys) -> str:
    """A copy of ``conf`` in ``out_dir`` with the conf keys ``keys`` set
    (each replaces its line, or is appended); returns its path."""
    lines = [ln for ln in open(conf).read().splitlines()
             if ln.split(":")[0].strip() not in keys]
    lines += [f"{k}: {v}" for k, v in keys.items()]
    path = os.path.join(out_dir, name + ".conf")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def wide_sharded_conf(full: str, out_dir: str) -> str:
    """The eight-shard twin of confs/ring_16k_full.conf (K4's wide rows),
    40 ticks."""
    return conf_variant(full, out_dir, "wide_sharded8",
                        BACKEND="tpu_hash_sharded", MESH_SHAPE=8,
                        TOTAL_TIME=40)


# Depth cuts for the script's time limit (PERF.md section 4): conf keys
# over the confs' own, by conf name or, for a variant the script makes,
# by the variant's name.  Each run keeps its detections inside it: a
# drop-free crash is detected 34-41 ticks after it at N = 2^20 (so the
# natural runs crash at 24, as ring_1m_s128_hist does, and stay each
# other's twins), the partition reconverges ~9 ticks after its heal, the
# N = 2^14 folded crash at 40 is detected 27-41 ticks later, the N = 256
# staggered crash at 100 is removed at 141-150, the scatter crash at 60
# by every tracker ~40 ticks later, the N = 4096 budgeted crash at 20
# inside 40, and the N = 4352 full view's crash at 1 (TFAIL 4, TREMOVE
# 8) 9-11 ticks later.  approx_lag's 20 ticks are two segments, so its
# lagged counters cross a boundary; the served N = 4096 gate case needs
# only ticks to time.  The 1M lossy paths are not cut: under drops the
# crash is first detected ~57 ticks into the run, whenever it happens.
DEPTH_CUTS = {
    "ring_1m_s128": dict(TOTAL_TIME=72, FAIL_TIME=24),
    "ring_1m_s128_ckpt": dict(TOTAL_TIME=72, FAIL_TIME=24),
    "ring_1m_s128_hoisted": dict(TOTAL_TIME=72, FAIL_TIME=24),
    "ring_1m_s128_sharded": dict(TOTAL_TIME=72, FAIL_TIME=24),
    "ring_1m_s128_hist": dict(TOTAL_TIME=72),
    "ring_1m_s128_partition": dict(TOTAL_TIME=128),
    "ring_16k_s16_folded_drop": dict(TOTAL_TIME=84),
    "ring_16k_s16_folded_sharded8_drop": dict(TOTAL_TIME=84),
    "ring_256_s128_staggered_drop": dict(TOTAL_TIME=160),
    "ring_256_s128_staggered_sharded8_drop": dict(TOTAL_TIME=160),
    "scatter_2k_s128_drop": dict(TOTAL_TIME=130),
    "buffsize_4k": dict(TOTAL_TIME=60, FAIL_TIME=20),
    "approx_lag_1m": dict(TOTAL_TIME=20, FAIL_TIME=8),
    "serve_gil_4k": dict(TOTAL_TIME=20),
    "wide_4352": dict(TOTAL_TIME=13, FAIL_TIME=1),
    # Phases sweep and chaos: SweepSpec / CampaignSpec fields.  The quick
    # grid's crash at 16 is detected 24-43 ticks later; the broken
    # campaign's first schedule shrinks in 6 probes (both: 30).
    "sweep_quick": dict(ticks=60, fail_time=16),
    "chaos_broken": dict(schedules=1),
}


def smoke_conf(confs: str, out_dir: str, name: str) -> str:
    """confs/``name``.conf with its DEPTH_CUTS applied."""
    conf = os.path.join(confs, name + ".conf")
    if name not in DEPTH_CUTS:
        return conf
    return conf_variant(conf, out_dir, name + "_cut", **DEPTH_CUTS[name])


def conf_ticks(conf: str) -> int:
    from distributed_membership_tpu_torch.config import Params
    return Params.from_file(conf, validate=False).TOTAL_TIME


def record(rows: dict, name, form, err, k_ms, p_ms, moved,
           design=None) -> None:
    """Log one kernel form's numbers and keep them in ``rows``; raises if
    the kernel disagreed with its plain version.  ``moved`` is what the
    function must move (the bound's bytes); ``design``, where given, what
    the kernel's design moves, logged with its achieved rate."""
    bound = moved / HBM_BYTES_PER_S * 1e3
    traffic = ("" if design is None else
               f" design_bytes={design} design_tb_s={design / k_ms / 1e9}")
    log(f"kernel {name}[{form}]: max_abs_err={err} kernel_ms={k_ms} "
        f"plain_ms={p_ms} bound_ms={bound} ({moved} bytes){traffic} "
        "library_ms=null")
    if err != 0:
        raise AssertionError(f"{name}[{form}] differs from its plain "
                             "version (integer outputs, tolerance 0)")
    rows[form] = dict(name=name, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                      bound_ms=bound, bound_by="bytes", library_ms=None)


def keff_bytes(mail, payload, k_eff, shifts) -> int:
    """What K2's k_eff form must move on these inputs: the mailbox read
    and written, k_eff, the shifts, and the payload rows of the senders
    whose gate is open for some shift (k_eff >= 1; no receiver reads the
    others)."""
    open_rows = int((k_eff > 0).sum())
    return (2 * nbytes(mail) + nbytes(k_eff, shifts)
            + open_rows * nbytes(payload) // payload.shape[0])


def phase_kernels(torch, dev) -> dict:
    """Phase 2: K1-K3 against their plain versions at the main path's
    shapes; returns one record per kernel form."""
    import numpy as np
    from distributed_membership_tpu_torch.ops.fused_gossip import (
        gossip_fused, gossip_plain)
    from distributed_membership_tpu_torch.ops.fused_probe import (
        probe_plain, probe_window_fused)
    from distributed_membership_tpu_torch.ops.fused_receive import (
        receive_core, receive_fused)
    from distributed_membership_tpu_torch.ops.view_merge import STRIDE

    rng = np.random.default_rng(20260)
    t = 90
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    shape = (N, S)
    # The [N, S] planes are drawn on the card (2^27 entries each), the
    # row vectors on the host.
    gen = torch.Generator(device=dev)
    gen.manual_seed(20260)
    rand = lambda *sh: torch.rand(sh, generator=gen, device=dev)  # noqa
    view = packed_dev(torch, gen, N, 0.7, 2 * t + 2, shape)
    view_ts = torch.randint(0, t + 1, shape, generator=gen, device=dev,
                            dtype=torch.int32)
    mail = packed_dev(torch, gen, N, 0.4, 2 * t + 4, shape)
    cand = torch.where(rand(*shape) < 0.1,
                       packed_dev(torch, gen, N, 1.0, 2 * t + 4, shape), 0)
    recv = T(rng.random(N) < 0.95)
    act = T(rng.random(N) < 0.95)
    self_on = act & T(rng.random(N) < 0.98)
    own_hb = rng.integers(1, 2 * t + 3, size=N, dtype=np.int64)
    self_pack = T(((own_hb * N + np.arange(N) + 1) & 0xFFFFFFFF)
                  .astype(np.uint32).view(np.int32)) * self_on.to(torch.int32)
    rows = {}

    # ---- K1 receive (updates view/view_ts/mail in place) ----
    args = (cand, recv, act, self_on, self_pack)
    ref = receive_core(N, S, TFAIL, TREMOVE, STRIDE, t, view, view_ts, mail,
                       *args)
    got = receive_fused(N, S, TFAIL, TREMOVE, STRIDE, t, view.clone(),
                        view_ts.clone(), mail.clone(), *args)
    torch.cuda.synchronize()
    err = max_abs_err(zip(got, ref))
    del ref, got
    v2, ts2, m2 = view.clone(), view_ts.clone(), mail.clone()
    k_ms = cuda_ms(lambda: receive_fused(N, S, TFAIL, TREMOVE, STRIDE, t,
                                         v2, ts2, m2, *args), 20)
    p_ms = cuda_ms(lambda: receive_core(N, S, TFAIL, TREMOVE, STRIDE, t,
                                        view, view_ts, mail, *args), 3)
    del v2, ts2, m2
    # in: view, view_ts, mail, cand and the row vectors; out: view,
    # view_ts, mail, rm_ids (4 B) and join (1 B) per slot, two [N] counts
    k1_bytes = (nbytes(view, view_ts, mail, cand, recv, act, self_on,
                       self_pack) + nbytes(view, view_ts, mail) + N * S * 5
                + N * 8)
    record(rows, "receive_fused", "receive", err, k_ms, p_ms, k1_bytes)

    # K1's admit_mask form: a random half of the slots admit.
    admit = (rand(*shape) < 0.5).to(torch.int32)
    ref = receive_core(N, S, TFAIL, TREMOVE, STRIDE, t, view, view_ts, mail,
                       *args, admit_mask=admit)
    got = receive_fused(N, S, TFAIL, TREMOVE, STRIDE, t, view.clone(),
                        view_ts.clone(), mail.clone(), *args,
                        admit_mask=admit)
    torch.cuda.synchronize()
    err = max_abs_err(zip(got, ref))
    open_ = receive_core(N, S, TFAIL, TREMOVE, STRIDE, t, view, view_ts,
                         mail, *args)
    if torch.equal(open_[0], ref[0]):
        raise AssertionError("receive_admit: the admit plane changed nothing")
    del ref, got, open_
    v2, ts2, m2 = view.clone(), view_ts.clone(), mail.clone()
    k_ms = cuda_ms(lambda: receive_fused(N, S, TFAIL, TREMOVE, STRIDE, t,
                                         v2, ts2, m2, *args,
                                         admit_mask=admit), 20)
    p_ms = cuda_ms(lambda: receive_core(N, S, TFAIL, TREMOVE, STRIDE, t,
                                        view, view_ts, mail, *args,
                                        admit_mask=admit), 3)
    del v2, ts2, m2
    # K1's bytes and one int32 [N, S] plane read
    record(rows, "receive_fused", "receive_admit", err, k_ms, p_ms,
           k1_bytes + nbytes(admit))
    del admit

    # ---- K2 gossip, both operand forms ----
    payload = torch.where(rand(*shape) < 0.3, view, 0)
    k_eff = T(rng.integers(0, K_MAX + 1, size=N, dtype=np.int32))
    err = 0
    for shifts_np in ([1, N - 1, 12345], [777, 524288, 99991]):
        shifts = T(np.asarray(shifts_np, np.int32))
        ref = gossip_plain(N, S, K_MAX, mail, payload, k_eff, shifts)
        got = gossip_fused(N, S, K_MAX, mail.clone(), payload, k_eff, shifts)
        torch.cuda.synchronize()
        err = max(err, max_abs_err([(got, ref)]))
    del ref, got
    m2 = mail.clone()
    k_ms = cuda_ms(lambda: gossip_fused(N, S, K_MAX, m2, payload, k_eff,
                                        shifts), 20)
    p_ms = cuda_ms(lambda: gossip_plain(N, S, K_MAX, mail, payload, k_eff,
                                        shifts), 3)
    # design: the tiled kernel reads the payload and k_eff once per shift
    record(rows, "gossip_fused", "gossip", err, k_ms, p_ms,
           keff_bytes(mail, payload, k_eff, shifts),
           2 * nbytes(mail) + K_MAX * nbytes(payload, k_eff))

    masks = rand(K_MAX, *shape) < 0.3
    ref = gossip_plain(N, S, K_MAX, mail, view, None, shifts, masks)
    got = gossip_fused(N, S, K_MAX, mail.clone(), view, None, shifts,
                       masks=masks)
    torch.cuda.synchronize()
    err = max_abs_err([(got, ref)])
    del ref, got
    k_ms = cuda_ms(lambda: gossip_fused(N, S, K_MAX, m2, view, None, shifts,
                                        masks=masks), 20)
    p_ms = cuda_ms(lambda: gossip_plain(N, S, K_MAX, mail, view, None,
                                        shifts, masks), 3)
    record(rows, "gossip_fused", "gossip_masks", err, k_ms, p_ms,
           2 * nbytes(mail) + nbytes(view, masks, shifts),
           2 * nbytes(mail) + K_MAX * nbytes(view) + nbytes(masks))
    del masks, m2, payload

    # ---- K3 probe window: agg partials (main path) and hist ----
    fail_ids = (3, 777777, N - 1)
    ids = torch.tensor(fail_ids + (5, 6), dtype=torch.int32, device=dev)
    rm_ids = torch.where(rand(*shape) < 0.02, ids[torch.randint(
        0, len(ids), shape, generator=gen, device=dev)], -1)
    err = 0
    for ptr in (120, 32):                  # wrapping and inner window
        ref = probe_plain(N, S, P, TFAIL, fail_ids, False, True, t, ptr, 0,
                          view, None, act, rm_ids)
        got = probe_window_fused(N, S, P, TFAIL, fail_ids, False, True, t,
                                 ptr, 0, view, None, act, rm_ids)
        torch.cuda.synchronize()
        if set(got) != set(ref):
            raise AssertionError(f"probe outputs {sorted(got)}")
        err = max(err, max_abs_err((got[k], ref[k]) for k in ref))
    k_ms = cuda_ms(lambda: probe_window_fused(
        N, S, P, TFAIL, fail_ids, False, True, t, ptr, 0, view, None, act,
        rm_ids), 20)
    p_ms = cuda_ms(lambda: probe_plain(
        N, S, P, TFAIL, fail_ids, False, True, t, ptr, 0, view, None, act,
        rm_ids), 3)
    # in: the P window columns of view, act and the rm plane; out: P ids
    # and 1 + F counts per row
    moved = (N * P * 4 + nbytes(act, rm_ids) + N * P * 4
             + N * 4 * (1 + len(fail_ids)))
    record(rows, "probe_window_fused", "probe", err, k_ms, p_ms, moved)

    # The same on a plane like a tick's: all -1 but a few removals of
    # failed ids, where the kernel skips the fail-id compares.
    rm_ids.fill_(-1)
    hits = 64
    rm_ids.view(-1)[T(rng.integers(0, N * S, size=hits))] = T(
        rng.choice(np.asarray(fail_ids, np.int32), size=hits))
    a = (N, S, P, TFAIL, fail_ids, False, True, t, 32, 0, view, None, act,
         rm_ids)
    ref, got = probe_plain(*a), probe_window_fused(*a)
    torch.cuda.synchronize()
    err = max_abs_err((got[k], ref[k]) for k in ref)
    if int(ref["rm_cnt"].sum()) <= 0:
        raise AssertionError("probe: the sparse plane holds no removal")
    k_ms = cuda_ms(lambda: probe_window_fused(*a), 20)
    p_ms = cuda_ms(lambda: probe_plain(*a), 3)
    record(rows, "probe_window_fused", "probe_sparse", err, k_ms, p_ms,
           moved)

    # The form the TELEMETRY hist path runs: hist and agg partials in one
    # pass, on the tick-like removal plane.
    a = (N, S, P, TFAIL, fail_ids, True, True, t, 32, 0, view, view_ts, act,
         rm_ids)
    ref, got = probe_plain(*a), probe_window_fused(*a)
    torch.cuda.synchronize()
    if set(got) != set(ref):
        raise AssertionError(f"probe outputs {sorted(got)}")
    err = max_abs_err((got[k], ref[k]) for k in ref)
    k_ms = cuda_ms(lambda: probe_window_fused(*a), 20)
    p_ms = cuda_ms(lambda: probe_plain(*a), 3)
    # in: view and view_ts (every entry's staleness), act, the rm plane;
    # out: P ids, 2 x 8 bucket counts and 1 + F counts per row
    record(rows, "probe_window_fused", "probe_hist", err, k_ms, p_ms,
           nbytes(view, view_ts, act, rm_ids) + N * P * 4 + N * 2 * 8 * 4
           + N * 4 * (1 + len(fail_ids)))
    del rm_ids

    ref = probe_plain(N, S, P, TFAIL, (), True, False, t, 120, 0, view,
                      view_ts, act, None)
    got = probe_window_fused(N, S, P, TFAIL, (), True, False, t, 120, 0,
                             view, view_ts, act, None)
    torch.cuda.synchronize()
    if set(got) != set(ref):
        raise AssertionError(f"probe outputs {sorted(got)}")
    err = max_abs_err((got[k], ref[k]) for k in ref)
    k_ms = cuda_ms(lambda: probe_window_fused(
        N, S, P, TFAIL, (), True, False, t, 120, 0, view, view_ts, act,
        None), 20)
    p_ms = cuda_ms(lambda: probe_plain(
        N, S, P, TFAIL, (), True, False, t, 120, 0, view, view_ts, act,
        None), 3)
    record(rows, "probe_window_fused", "probe_hist_only", err, k_ms, p_ms,
           nbytes(view, view_ts, act) + N * P * 4 + N * 2 * 8 * 4)
    return rows


def phase_kernels_folded(torch, dev) -> dict:
    """Phase 2, folded layout: K5-K7 against their plain versions at the
    folded path's shapes (N=2^20, S=16, P=2, k_max=3); returns one record
    per kernel form."""
    import numpy as np
    from distributed_membership_tpu_torch.ops.fused_folded import (
        folded_receive_core, gossip_folded_plain, gossip_folded_stacked,
        receive_folded_fused)
    from distributed_membership_tpu_torch.ops.fused_probe import (
        probe_folded_plain, probe_folded_window_fused)
    from distributed_membership_tpu_torch.ops.view_merge import STRIDE

    rng = np.random.default_rng(20262)
    t = 90
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    r = N * FS // 128
    shape = (r, 128)
    view = T(packed(rng, N, 0.7, 2 * t + 2, shape))
    view_ts = T(rng.integers(0, t + 1, size=shape, dtype=np.int32))
    mail = T(packed(rng, N, 0.4, 2 * t + 4, shape))
    cand = T(np.where(rng.random(shape, dtype=np.float32) < 0.1,
                      packed(rng, N, 1.0, 2 * t + 4, shape), 0))
    recv = T(rng.random(N) < 0.95)
    act = T(rng.random(N) < 0.95)
    own_hb = rng.integers(1, 2 * t + 3, size=N, dtype=np.int64)
    self_val = T(((own_hb * N + np.arange(N) + 1) & 0xFFFFFFFF)
                 .astype(np.uint32).view(np.int32)) * act.to(torch.int32)
    rows = {}

    # ---- K5 receive (updates view/view_ts/mail in place) ----
    args = (cand, recv, act, self_val)
    ref = folded_receive_core(N, FS, TFAIL, TREMOVE, STRIDE, t, view,
                              view_ts, mail, *args)
    got = receive_folded_fused(N, FS, TFAIL, TREMOVE, STRIDE, t,
                               view.clone(), view_ts.clone(), mail.clone(),
                               *args)
    torch.cuda.synchronize()
    err = max_abs_err(zip(got, ref))
    del ref, got
    v2, ts2, m2 = view.clone(), view_ts.clone(), mail.clone()
    k_ms = cuda_ms(lambda: receive_folded_fused(
        N, FS, TFAIL, TREMOVE, STRIDE, t, v2, ts2, m2, *args), 20)
    p_ms = cuda_ms(lambda: folded_receive_core(
        N, FS, TFAIL, TREMOVE, STRIDE, t, view, view_ts, mail, *args), 3)
    del v2, ts2, m2
    # in: view, view_ts, mail, cand, the per-node vectors; out: view,
    # view_ts, mail, rm_ids (4 B) and join, stale (1 B) per entry
    record(rows, "receive_folded_fused", "receive_folded", err, k_ms, p_ms,
           nbytes(view, view_ts, mail, cand, recv, act, self_val)
           + nbytes(view, view_ts, mail) + r * 128 * 6)

    # ---- K6 gossip: stacked payloads (the path) and shared + masks ----
    shifts = T(np.asarray([1, N - 1, 12345], np.int32))
    cs = STRIDE % FS
    c1 = ((shifts % FS) * cs % FS).to(torch.int32)
    c2 = (((shifts - N) % FS) * cs % FS).to(torch.int32)
    payloads = torch.where(
        T(rng.random((K_MAX,) + shape, dtype=np.float32) < 0.3),
        view[None], 0)
    err = 0
    for single in (True, False):
        ref = gossip_folded_plain(r, FS, K_MAX, single, mail, payloads,
                                  shifts, c1, c2)
        got = gossip_folded_stacked(r, FS, K_MAX, single, mail.clone(),
                                    payloads, shifts, c1, c2)
        torch.cuda.synchronize()
        err = max(err, max_abs_err([(got, ref)]))
    del ref, got
    m2 = mail.clone()
    k_ms = cuda_ms(lambda: gossip_folded_stacked(
        r, FS, K_MAX, True, m2, payloads, shifts, c1, c2), 20)
    p_ms = cuda_ms(lambda: gossip_folded_plain(
        r, FS, K_MAX, True, mail, payloads, shifts, c1, c2), 3)
    # design: the tiled body reads each payload plane once
    record(rows, "gossip_folded_stacked", "gossip_folded", err, k_ms, p_ms,
           2 * nbytes(mail) + nbytes(payloads, shifts, c1),
           2 * nbytes(mail) + nbytes(payloads))
    del payloads

    masks = T(rng.random((K_MAX,) + shape, dtype=np.float32) < 0.3)
    ref = gossip_folded_plain(r, FS, K_MAX, True, mail, view[None], shifts,
                              c1, c2, masks)
    got = gossip_folded_stacked(r, FS, K_MAX, True, mail.clone(), view[None],
                                shifts, c1, c2, masks)
    torch.cuda.synchronize()
    err = max_abs_err([(got, ref)])
    del ref, got
    k_ms = cuda_ms(lambda: gossip_folded_stacked(
        r, FS, K_MAX, True, m2, view[None], shifts, c1, c2, masks), 20)
    p_ms = cuda_ms(lambda: gossip_folded_plain(
        r, FS, K_MAX, True, mail, view[None], shifts, c1, c2, masks), 3)
    # design: the shared payload once per shift
    record(rows, "gossip_folded_stacked", "gossip_folded_masks", err, k_ms,
           p_ms, 2 * nbytes(mail) + nbytes(view, masks, shifts, c1),
           2 * nbytes(mail) + K_MAX * nbytes(view) + nbytes(masks))
    del masks, m2

    # ---- K6 on eight shards in one launch (the sharded folded step):
    # node shifts within a shard, per-shard slot shifts ----
    d, n_local = 8, N // 8
    krng = np.random.default_rng(20264)
    thr = T(np.asarray([n_local - 1, 0, 54321], np.int32))
    s1 = T(krng.integers(0, FS, size=(d, K_MAX)).astype(np.int32))
    s2 = T(krng.integers(0, FS, size=(d, K_MAX)).astype(np.int32))
    payloads = torch.where(
        T(rng.random((K_MAX,) + shape, dtype=np.float32) < 0.3), view[None],
        0)
    err = 0
    for single in (True, False):
        ref = gossip_folded_plain(r, FS, K_MAX, single, mail, payloads, thr,
                                  s1, s2, n_local=n_local)
        got = gossip_folded_stacked(r, FS, K_MAX, single, mail.clone(),
                                    payloads, thr, s1, s2, n_local=n_local)
        torch.cuda.synchronize()
        err = max(err, max_abs_err([(got, ref)]))
    del ref, got
    m2 = mail.clone()
    k_ms = cuda_ms(lambda: gossip_folded_stacked(
        r, FS, K_MAX, True, m2, payloads, thr, s1, s2, n_local=n_local), 20)
    p_ms = cuda_ms(lambda: gossip_folded_plain(
        r, FS, K_MAX, True, mail, payloads, thr, s1, s2, n_local=n_local), 3)
    record(rows, "gossip_folded_stacked", "gossip_folded_shards", err, k_ms,
           p_ms, 2 * nbytes(mail) + nbytes(payloads, thr, s1, s2),
           2 * nbytes(mail) + nbytes(payloads))
    del payloads, m2
    # Short shards at S=2 and S=4 (one to eight plane rows each), where
    # the runs widened to 16-byte bounds reach a shard's edge.
    err = 0
    for fs, nl in ((2, 64), (2, 512), (4, 32), (4, 256)):
        rr = d * nl * fs // 128
        m = T(packed(krng, d * nl, 0.5, 200, (rr, 128)))
        pay = T(packed(krng, d * nl, 0.8, 200, (K_MAX, rr, 128)))
        th = T(np.asarray([nl - 1, 0, 5 % nl], np.int32))
        a1 = T(krng.integers(0, fs, size=(d, K_MAX)).astype(np.int32))
        a2 = T(krng.integers(0, fs, size=(d, K_MAX)).astype(np.int32))
        for single in (True, False):
            ref = gossip_folded_plain(rr, fs, K_MAX, single, m, pay, th, a1,
                                      a2, n_local=nl)
            got = gossip_folded_stacked(rr, fs, K_MAX, single, m.clone(),
                                        pay, th, a1, a2, n_local=nl)
            torch.cuda.synchronize()
            err = max(err, max_abs_err([(got, ref)]))
    log(f"kernel gossip_folded_stacked[short_shards]: D={d} S=2,4 "
        f"max_abs_err={err}")
    if err != 0:
        raise AssertionError("gossip_folded_stacked on short shards differs "
                             "from its plain version")
    rows["gossip_folded_shards"]["short_shards_max_abs_err"] = err

    # ---- K7 probe window: agg partials (the path) and hist ----
    fail_ids = (3, 777777, N - 1)
    rm = np.full(shape, -1, np.int32)
    hit = rng.random(shape, dtype=np.float32) < 0.02
    rm[hit] = rng.choice(np.asarray(fail_ids + (5, 6), np.int32),
                         size=int(hit.sum()))
    rm_ids = T(rm)
    del rm, hit

    def probe_err(want_hist, want_agg, ptr):
        fails = fail_ids if want_agg else ()
        a = (N, FS, FP, TFAIL, fails, want_hist, want_agg, t, ptr, 0, view,
             view_ts if want_hist else None, act,
             rm_ids if want_agg else None)
        ref, got = probe_folded_plain(*a), probe_folded_window_fused(*a)
        torch.cuda.synchronize()
        if set(got) != set(ref):
            raise AssertionError(f"probe_folded outputs {sorted(got)}")
        pairs = [(got[k], ref[k]) for k in ref if k != "det_cols"]
        pairs += list(zip(got.get("det_cols", ()), ref.get("det_cols", ())))
        return max_abs_err(pairs), a

    err = 0
    for ptr in (FS - 1, 6):               # wrapping and inner window
        e, a = probe_err(False, True, ptr)
        err = max(err, e)
    k_ms = cuda_ms(lambda: probe_folded_window_fused(*a), 20)
    p_ms = cuda_ms(lambda: probe_folded_plain(*a), 3)
    # in: view, act, rm_ids; out: the id plane, det_any (1 B per entry),
    # 1 + F counts per plane row
    record(rows, "probe_folded_window_fused", "probe_folded", err, k_ms,
           p_ms, nbytes(view, act, rm_ids, view) + r * 128
           + r * 4 * (1 + len(fail_ids)))
    err, a = probe_err(True, False, FS - 1)
    k_ms = cuda_ms(lambda: probe_folded_window_fused(*a), 20)
    p_ms = cuda_ms(lambda: probe_folded_plain(*a), 3)
    record(rows, "probe_folded_window_fused", "probe_folded_hist_only", err,
           k_ms, p_ms, nbytes(view, view_ts, act, view) + r * 2 * 8 * 4)
    # The form the TELEMETRY hist paths run: hist and agg partials at once.
    err, a = probe_err(True, True, FS - 1)
    k_ms = cuda_ms(lambda: probe_folded_window_fused(*a), 20)
    p_ms = cuda_ms(lambda: probe_folded_plain(*a), 3)
    record(rows, "probe_folded_window_fused", "probe_folded_hist", err,
           k_ms, p_ms, nbytes(view, view_ts, act, rm_ids, view) + r * 128
           + r * 2 * 8 * 4 + r * 4 * (1 + len(fail_ids)))
    return rows


def phase_kernels_stacked(torch, dev) -> dict:
    """Phase 2, the sharded step's K4 against its plain version: both
    operand forms at the sharded path's shapes (N=2^20, S=128, k_max=3, one
    shard), and the stacked form on eight shards of L=131000 rows, whose
    (L * STRIDE) % S != 0 takes the wrapped rows' column shifts; returns
    one record per form."""
    import numpy as np
    from distributed_membership_tpu_torch.ops.fused_gossip import (
        gossip_fused_stacked, gossip_stacked_plain)
    from distributed_membership_tpu_torch.ops.view_merge import STRIDE

    t = 90
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    rows = {}

    def shifts(d, n_local, seed):
        r = np.random.default_rng(seed)
        c = r.integers(0, n_local, size=K_MAX).astype(np.int32)
        s1 = r.integers(0, S, size=(d, K_MAX)).astype(np.int32)
        s2 = r.integers(0, S, size=(d, K_MAX)).astype(np.int32)
        return T(c), T(s1), T(s2)

    shape = (N, S)
    gen = torch.Generator(device=dev)       # the planes, on the card
    gen.manual_seed(20263)
    rand = lambda *sh: torch.rand(sh, generator=gen, device=dev)  # noqa
    mail = packed_dev(torch, gen, N, 0.4, 2 * t + 4, shape)
    view = packed_dev(torch, gen, N, 0.7, 2 * t + 2, shape)
    payloads = torch.where(rand(K_MAX, *shape) < 0.3, view[None], 0)
    err = 0
    for seed in (1, 2):
        c, s1, s2 = shifts(1, N, seed)
        for single in (True, False):
            ref = gossip_stacked_plain(N, S, K_MAX, single, mail, payloads,
                                       c, s1, s2)
            got = gossip_fused_stacked(N, S, K_MAX, single, mail.clone(),
                                       payloads, c, s1, s2)
            torch.cuda.synchronize()
            err = max(err, max_abs_err([(got, ref)]))
    del ref, got
    m2 = mail.clone()
    single = (N * STRIDE) % S == 0
    k_ms = cuda_ms(lambda: gossip_fused_stacked(
        N, S, K_MAX, single, m2, payloads, c, s1, s2), 20)
    p_ms = cuda_ms(lambda: gossip_stacked_plain(
        N, S, K_MAX, single, mail, payloads, c, s1, s2), 3)
    # in: mail, the K payloads, the shifts; out: mail
    record(rows, "gossip_fused_stacked", "gossip_stacked", err, k_ms, p_ms,
           2 * nbytes(mail) + nbytes(payloads, c, s1, s2),
           2 * nbytes(mail) + nbytes(payloads))

    # Eight shards, L = 131000: per-shard shifts, two column alignments.
    d, n_local = 8, N // 8 - 72
    n8 = d * n_local
    c8, s18, s28 = shifts(d, n_local, 3)
    ref = gossip_stacked_plain(n_local, S, K_MAX, False, mail[:n8],
                               payloads[:, :n8].contiguous(), c8, s18, s28)
    got = gossip_fused_stacked(n_local, S, K_MAX, False,
                               mail[:n8].clone(),
                               payloads[:, :n8].contiguous(), c8, s18, s28)
    torch.cuda.synchronize()
    err8 = max_abs_err([(got, ref)])
    del ref, got, payloads
    log(f"kernel gossip_fused_stacked[two_col]: D={d} L={n_local} "
        f"max_abs_err={err8}")
    if err8 != 0:
        raise AssertionError("gossip_fused_stacked on eight shards differs "
                             "from its plain version")
    rows["gossip_stacked"]["two_col_max_abs_err"] = err8

    masks = rand(K_MAX, *shape) < 0.3
    c, s1, s2 = shifts(1, N, 4)
    ref = gossip_stacked_plain(N, S, K_MAX, single, mail, view[None], c, s1,
                               s2, masks)
    got = gossip_fused_stacked(N, S, K_MAX, single, mail.clone(), view[None],
                               c, s1, s2, masks)
    torch.cuda.synchronize()
    err = max_abs_err([(got, ref)])
    del ref, got
    k_ms = cuda_ms(lambda: gossip_fused_stacked(
        N, S, K_MAX, single, m2, view[None], c, s1, s2, masks), 20)
    p_ms = cuda_ms(lambda: gossip_stacked_plain(
        N, S, K_MAX, single, mail, view[None], c, s1, s2, masks), 3)
    record(rows, "gossip_fused_stacked", "gossip_stacked_masks", err, k_ms,
           p_ms, 2 * nbytes(mail) + nbytes(view, masks, c, s1, s2),
           2 * nbytes(mail) + K_MAX * nbytes(view) + nbytes(masks))
    return rows


def packed_dev(torch, gen, n, occ, hb_hi, shape):
    """:func:`packed` drawn on the card (a 2^28-entry plane is too big to
    draw on the host quickly)."""
    dev = gen.device
    ids = torch.randint(0, n, shape, generator=gen, device=dev,
                        dtype=torch.int64)
    hbs = torch.randint(0, hb_hi, shape, generator=gen, device=dev,
                        dtype=torch.int64)
    keep = torch.rand(shape, generator=gen, device=dev) < occ
    val = torch.where(keep, (hbs * n + ids + 1) & 0xFFFFFFFF, 0)
    return torch.where(val >= 1 << 31, val - (1 << 32), val).to(torch.int32)


def phase_kernels_wide(torch, dev) -> dict:
    """Phase 2, rows wider than one 16 KiB tile: K2's and K4's wide-row
    forms (both operand forms each; K2 also at a ragged N whose wrapped
    rows take the second column alignment, K4 also on eight shards of
    1000 rows) and K1 and K3 at N = S = 16384, the wide path's full
    view, against their plain versions; returns one record per form."""
    from distributed_membership_tpu_torch.ops.fused_gossip import (
        MAX_TILE_S, gossip_fused, gossip_fused_stacked, gossip_plain,
        gossip_stacked_plain)
    from distributed_membership_tpu_torch.ops.fused_probe import (
        probe_plain, probe_window_fused)
    from distributed_membership_tpu_torch.ops.fused_receive import (
        receive_core, receive_fused)
    from distributed_membership_tpu_torch.ops.view_merge import STRIDE

    nw = sw = 1 << 14
    t = 90
    gen = torch.Generator(device=dev)
    gen.manual_seed(20264)
    shape = (nw, sw)
    rand = lambda *sh: torch.rand(sh, generator=gen, device=dev)  # noqa
    view = packed_dev(torch, gen, nw, 0.7, 2 * t + 2, shape)
    mail = packed_dev(torch, gen, nw, 0.4, 2 * t + 4, shape)
    rows = {}

    def k2(form, payload, k_eff, masks, shift_sets, n=nw, s=sw):
        err = 0
        m, v = mail[:n, :s].contiguous(), payload[:n, :s].contiguous()
        ke = None if k_eff is None else k_eff[:n].contiguous()
        mk = None if masks is None else masks[:, :n, :s].contiguous()
        for sh in shift_sets:
            shifts = torch.tensor(sh, dtype=torch.int32, device=dev)
            ref = gossip_plain(n, s, K_MAX, m, v, ke, shifts, mk)
            got = gossip_fused(n, s, K_MAX, m.clone(), v, ke, shifts,
                               masks=mk)
            torch.cuda.synchronize()
            err = max(err, max_abs_err([(got, ref)]))
            del ref, got
        return err, m, v, ke, mk, shifts

    payload = torch.where(rand(*shape) < 0.3, view, 0)
    k_eff = torch.randint(0, K_MAX + 1, (nw,), generator=gen, device=dev,
                          dtype=torch.int32)
    err, m, v, ke, _, shifts = k2("k_eff", payload, k_eff, None,
                                  ([1, nw - 1, 5000], [777, 8192, 12345]))
    # A ragged N: (N * STRIDE) % S != 0, the wrapped rows' alignment.
    err_r = k2("k_eff", payload, k_eff, None, ([3, 9000, 4999],),
               n=9001, s=8192)[0]
    m2 = m.clone()
    k_ms = cuda_ms(lambda: gossip_fused(nw, sw, K_MAX, m2, v, ke, shifts),
                   5)
    p_ms = cuda_ms(lambda: gossip_plain(nw, sw, K_MAX, m, v, ke, shifts), 2)
    # The design copies a sender chunk only where its row's gate is open,
    # and reads one k_eff value per chunk and shift.
    open_rows = int(sum((ke > j).sum() for j in range(K_MAX)))
    chunks = -(-sw // MAX_TILE_S)
    record(rows, "gossip_fused", "gossip_wide", max(err, err_r), k_ms, p_ms,
           keff_bytes(m, v, ke, shifts),
           2 * nbytes(m) + open_rows * sw * 4 + K_MAX * chunks * nbytes(ke))
    rows["gossip_wide"]["ragged_max_abs_err"] = err_r
    # Every gate open, as on the wide path, where k_eff = min(view,
    # FANOUT) - seeds is K_MAX on nearly every row of a full view.
    ke = torch.full_like(ke, K_MAX)
    ref = gossip_plain(nw, sw, K_MAX, m, v, ke, shifts)
    got = gossip_fused(nw, sw, K_MAX, m.clone(), v, ke, shifts)
    torch.cuda.synchronize()
    err = max_abs_err([(got, ref)])
    del ref, got
    k_ms = cuda_ms(lambda: gossip_fused(nw, sw, K_MAX, m2, v, ke, shifts),
                   5)
    p_ms = cuda_ms(lambda: gossip_plain(nw, sw, K_MAX, m, v, ke, shifts), 2)
    record(rows, "gossip_fused", "gossip_wide_open", err, k_ms, p_ms,
           keff_bytes(m, v, ke, shifts),
           2 * nbytes(m) + K_MAX * (nbytes(v) + chunks * nbytes(ke)))
    del payload, v, m2
    masks = rand(K_MAX, *shape) < 0.3
    err, m, v, _, mk, shifts = k2("masks", view, None, masks,
                                  ([1, nw - 1, 5000],))
    m2 = m.clone()
    k_ms = cuda_ms(lambda: gossip_fused(nw, sw, K_MAX, m2, v, None, shifts,
                                        masks=mk), 5)
    p_ms = cuda_ms(lambda: gossip_plain(nw, sw, K_MAX, m, v, None, shifts,
                                        mk), 2)
    record(rows, "gossip_fused", "gossip_wide_masks", err, k_ms, p_ms,
           2 * nbytes(m) + nbytes(v, mk, shifts),
           2 * nbytes(m) + K_MAX * nbytes(v) + nbytes(mk))
    del m2, mk

    # ---- K4 wide: one shard of N rows, and eight ragged shards ----
    def shifts4(d, n_local, seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        ri = lambda hi, sh: torch.randint(0, hi, sh, generator=g,  # noqa
                                          device=dev, dtype=torch.int32)
        return ri(n_local, (K_MAX,)), ri(sw, (d, K_MAX)), ri(sw, (d, K_MAX))

    payloads = torch.where(rand(K_MAX, *shape) < 0.3, view[None], 0)
    c, s1, s2 = shifts4(1, nw, 1)
    single = (nw * STRIDE) % sw == 0
    ref = gossip_stacked_plain(nw, sw, K_MAX, single, mail, payloads, c, s1,
                               s2)
    got = gossip_fused_stacked(nw, sw, K_MAX, single, mail.clone(), payloads,
                               c, s1, s2)
    torch.cuda.synchronize()
    err = max_abs_err([(got, ref)])
    del ref, got
    d8, l8 = 8, 1000
    c8, s18, s28 = shifts4(d8, l8, 2)
    sub = payloads[:, :d8 * l8].contiguous()
    ref = gossip_stacked_plain(l8, sw, K_MAX, False, mail[:d8 * l8], sub,
                               c8, s18, s28)
    got = gossip_fused_stacked(l8, sw, K_MAX, False,
                               mail[:d8 * l8].clone(), sub, c8, s18, s28)
    torch.cuda.synchronize()
    err8 = max_abs_err([(got, ref)])
    del ref, got, sub
    m2 = mail.clone()
    k_ms = cuda_ms(lambda: gossip_fused_stacked(
        nw, sw, K_MAX, single, m2, payloads, c, s1, s2), 5)
    p_ms = cuda_ms(lambda: gossip_stacked_plain(
        nw, sw, K_MAX, single, mail, payloads, c, s1, s2), 2)
    record(rows, "gossip_fused_stacked", "gossip_stacked_wide",
           max(err, err8), k_ms, p_ms,
           2 * nbytes(mail) + nbytes(payloads, c, s1, s2),
           2 * nbytes(mail) + nbytes(payloads))
    rows["gossip_stacked_wide"]["two_col_max_abs_err"] = err8
    del payloads
    ref = gossip_stacked_plain(nw, sw, K_MAX, single, mail, view[None], c,
                               s1, s2, masks)
    got = gossip_fused_stacked(nw, sw, K_MAX, single, mail.clone(),
                               view[None], c, s1, s2, masks)
    torch.cuda.synchronize()
    err = max_abs_err([(got, ref)])
    del ref, got
    k_ms = cuda_ms(lambda: gossip_fused_stacked(
        nw, sw, K_MAX, single, m2, view[None], c, s1, s2, masks), 5)
    p_ms = cuda_ms(lambda: gossip_stacked_plain(
        nw, sw, K_MAX, single, mail, view[None], c, s1, s2, masks), 2)
    record(rows, "gossip_fused_stacked", "gossip_stacked_wide_masks", err,
           k_ms, p_ms, 2 * nbytes(mail) + nbytes(view, masks, c, s1, s2),
           2 * nbytes(mail) + K_MAX * nbytes(view) + nbytes(masks))
    del masks, m2
    torch.cuda.empty_cache()

    # ---- K1 and K3 at S = 16384 ----
    view_ts = torch.randint(0, t + 1, shape, generator=gen, device=dev,
                            dtype=torch.int32)
    cand = torch.where(rand(*shape) < 0.1,
                       packed_dev(torch, gen, nw, 1.0, 2 * t + 4, shape), 0)
    recv, act = rand(nw) < 0.95, rand(nw) < 0.95
    self_on = act & (rand(nw) < 0.98)
    own_hb = torch.randint(1, 2 * t + 3, (nw,), generator=gen, device=dev)
    self_pack = ((own_hb * nw + torch.arange(nw, device=dev) + 1)
                 .to(torch.int32) * self_on.to(torch.int32))
    args = (cand, recv, act, self_on, self_pack)
    ref = receive_core(nw, sw, TFAIL, TREMOVE, STRIDE, t, view, view_ts,
                       mail, *args)
    got = receive_fused(nw, sw, TFAIL, TREMOVE, STRIDE, t, view.clone(),
                        view_ts.clone(), mail.clone(), *args)
    torch.cuda.synchronize()
    err = max_abs_err(zip(got, ref))
    rm_ids = ref[4]
    del got
    v2, ts2, m2 = view.clone(), view_ts.clone(), mail.clone()
    k_ms = cuda_ms(lambda: receive_fused(nw, sw, TFAIL, TREMOVE, STRIDE, t,
                                         v2, ts2, m2, *args), 5)
    p_ms = cuda_ms(lambda: receive_core(nw, sw, TFAIL, TREMOVE, STRIDE, t,
                                        view, view_ts, mail, *args), 2)
    del v2, ts2, m2
    record(rows, "receive_fused", "receive_wide", err, k_ms, p_ms,
           nbytes(view, view_ts, mail, cand, recv, act, self_on, self_pack)
           + nbytes(view, view_ts, mail) + nw * sw * 5 + nw * 8)
    del cand, ref
    fail_ids = (3, 7777, nw - 1)
    err = 0
    for ptr in (sw - 8, 32):               # wrapping and inner window
        ref = probe_plain(nw, sw, P, TFAIL, fail_ids, True, True, t, ptr, 0,
                          view, view_ts, act, rm_ids)
        got = probe_window_fused(nw, sw, P, TFAIL, fail_ids, True, True, t,
                                 ptr, 0, view, view_ts, act, rm_ids)
        torch.cuda.synchronize()
        err = max(err, max_abs_err((got[k], ref[k]) for k in ref))
    k_ms = cuda_ms(lambda: probe_window_fused(
        nw, sw, P, TFAIL, fail_ids, True, True, t, 32, 0, view, view_ts,
        act, rm_ids), 5)
    p_ms = cuda_ms(lambda: probe_plain(
        nw, sw, P, TFAIL, fail_ids, True, True, t, 32, 0, view, view_ts,
        act, rm_ids), 2)
    # in: view, view_ts and rm_ids, act; out: P ids and the row partials
    record(rows, "probe_window_fused", "probe_wide", err, k_ms, p_ms,
           nbytes(view, view_ts, rm_ids, act)
           + sum(nbytes(x) for x in got.values()))
    return rows


def launches_expected(**nonzero) -> dict:
    """The launch counts of a path: ``nonzero`` and 0 for every other
    kernel form."""
    from distributed_membership_tpu_torch import kernels
    return {k: nonzero.get(k, 0) for k in kernels.LAUNCHES}


SERIES = {}                     # path name -> its run's timeline series
PATH_INFO = {}                  # path name -> run_path's record of it


def run_path(torch, conf: str, name: str, expect: dict, out_dir: str,
             ticks: int | None = None, carry: bool = False,
             digest: bool = False, **kw) -> dict:
    """Drive run_conf once on the card, with every launch count set to 0
    just before and read just after; ``kw`` are run_conf's overrides and
    ``ticks`` the ticks the run drives (a resumed run's rest; default
    TOTAL_TIME).  A conf with TELEMETRY must give a timeline that
    reconciles with its detection summary.  With ``carry`` the final
    state's block-boundary bytes (ops/megakernel.py) are recorded, with
    ``digest`` its checkpoint state hash (runtime/checkpoint.py)."""
    from distributed_membership_tpu_torch import kernels
    from distributed_membership_tpu_torch.runtime.application import run_conf

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    result = run_conf(conf, out_dir=os.path.join(out_dir, name),
                      device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    p = result.params
    ticks = p.TOTAL_TIME if ticks is None else ticks
    det = result.extra["detection_summary"]
    info = {
        "ticks": ticks, "n": p.EN_GPSZ, "wall_s": wall,
        "ticks_per_s": ticks / wall,
        "node_ticks_per_s": p.EN_GPSZ * ticks / wall,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches,
        "detection": {k: v for k, v in det.items()
                      if k != "latency_hist_nonzero"},
    }
    if carry:
        from distributed_membership_tpu_torch.ops.megakernel import (
            carry_bytes)
        info["carry_bytes"] = carry_bytes(result.extra["final_state"])
    if digest:
        from distributed_membership_tpu_torch.convert import carry_leaves
        from distributed_membership_tpu_torch.runtime.checkpoint import (
            state_hash)
        info["state_hash"] = state_hash(carry_leaves(
            result.extra["final_state"]))
    if "timeline" in result.extra:
        info["timeline"] = reconcile(name, result)
        SERIES[name] = result.extra["timeline"]
    if "scenario_report" in result.extra:
        info["scenario"] = oracle_digest(result.extra["scenario_report"])
    log(f"main[{name}]: " + json.dumps(info))
    PATH_INFO[name] = info
    if launches != expect:
        raise AssertionError(f"{name}: launches {launches} != {expect}")
    return info


def run_killed(torch, conf: str, name: str, expect: dict, out_dir: str,
               crash_at: int, **kw) -> float:
    """run_conf on the card with ``DM_CRASH_AT_TICK=crash_at``: it must
    raise the injected crash, having launched ``expect``.  Returns the
    wall seconds."""
    from distributed_membership_tpu_torch import kernels
    from distributed_membership_tpu_torch.runtime import checkpoint as ck
    from distributed_membership_tpu_torch.runtime.application import run_conf

    torch.cuda.synchronize()
    kernels.reset_launches()
    os.environ[ck.CRASH_ENV] = str(crash_at)
    t0 = time.perf_counter()
    try:
        run_conf(conf, out_dir=os.path.join(out_dir, name), device="cuda",
                 **kw)
    except RuntimeError as e:
        if "injected crash" not in str(e):
            raise
        log(f"{name}: {e}")
    else:
        raise AssertionError(f"{name}: the injected crash did not happen")
    finally:
        del os.environ[ck.CRASH_ENV]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if launches != expect:
        raise AssertionError(f"{name}: launches {launches} != {expect}")
    return wall


def twin(torch, paths: dict, name: str, conf: str, expect: dict,
         out_dir: str) -> dict:
    """The uninterrupted per-tick path a new path is held to: the run of
    its earlier phase, or (on a partial run) one made now."""
    if name not in paths:
        paths[name] = run_path(torch, conf, name, expect, out_dir)
    return paths[name]


def same_detection(name: str, got: dict, want: dict, what: str) -> None:
    if got["detection"] != want["detection"]:
        raise AssertionError(f"{name}: detection summary {got['detection']}"
                             f" != {what}'s {want['detection']}")


def same_series(name: str, twin_name: str) -> None:
    import numpy as np
    a, b = SERIES[name], SERIES[twin_name]
    if a.keys() != b.keys() or any(not np.array_equal(a[k], b[k])
                                   for k in a):
        raise AssertionError(f"{name}: timeline differs from {twin_name}'s")


def runlog_segments(tl_dir: str) -> list:
    """``chunked_run``'s per-segment records in ``tl_dir``."""
    from distributed_membership_tpu_torch.observability.runlog import (
        read_events)
    return [{k: r[k] for k in ("t0", "t1", "device_sync_s", "flush_s",
                               "ckpt_wait_s")}
            for r in read_events(os.path.join(tl_dir, "runlog.jsonl"),
                                 kinds=("segment",))]


def phase_checkpoint(torch, confs: str, paths: dict, out_dir: str,
                     card: str) -> dict:
    """The main path's conf in 40-tick segments (TELEMETRY scalars): with
    no directory, then with snapshots, killed in the segment before the
    last (the manifest at its end) and resumed for the last, where the
    crash's detections fall; each equals the main path's detection
    summary, with every kernel once per tick."""
    import shutil

    from distributed_membership_tpu_torch.config import Params
    from distributed_membership_tpu_torch.runtime import checkpoint as ck
    main_conf = smoke_conf(confs, out_dir, "ring_1m_s128")
    t_main = conf_ticks(main_conf)
    main = twin(torch, paths, "main", main_conf,
                launches_expected(receive=t_main, gossip=t_main,
                                  probe=t_main), out_dir)
    conf = smoke_conf(confs, out_dir, "ring_1m_s128_ckpt")
    total = conf_ticks(conf)
    every = Params.from_file(conf, validate=False).CHECKPOINT_EVERY
    durable = (total - 1) // every * every          # the last boundary
    free = shutil.disk_usage(out_dir).free
    log(f"checkpoint: {free / 2**30:.1f} GiB free under {out_dir}")
    tl = {k: os.path.join(out_dir, f"checkpoint_{k}_tl")
          for k in ("nodir", "dir")}
    ckdir = os.path.join(out_dir, "checkpoint_ck")
    for d in list(tl.values()) + [ckdir]:
        shutil.rmtree(d, ignore_errors=True)

    def per_tick(n):
        return launches_expected(receive=n, gossip=n, probe=n)

    nodir = run_path(torch, conf, "checkpoint", per_tick(total), out_dir,
                     telemetry_dir=tl["nodir"])
    same_detection("checkpoint", nodir, main, "main")
    killed_s = run_killed(torch, conf, "checkpoint_killed", per_tick(durable),
                          out_dir, durable - every // 2,
                          checkpoint_dir=ckdir, telemetry_dir=tl["dir"])
    if ck.manifest_tick(ckdir) != durable:
        raise AssertionError(f"checkpoint: manifest at "
                             f"{ck.manifest_tick(ckdir)}, not {durable}")
    snaps = {f: os.path.getsize(os.path.join(ckdir, f))
             for f in sorted(os.listdir(ckdir)) if f.endswith(".npz")}
    resumed = run_path(torch, conf, "checkpoint_resumed",
                       per_tick(total - durable), out_dir,
                       ticks=total - durable, checkpoint_dir=ckdir,
                       resume=True,
                       telemetry_dir=tl["dir"])
    same_detection("checkpoint_resumed", resumed, main, "main")
    info = {"card": card, "free_disk_gib": free / 2**30,
            "launches": nodir["launches"], "snapshot_bytes": snaps,
            "ticks_per_s": {"main": main["ticks_per_s"],
                            "chunked_no_dir": nodir["ticks_per_s"],
                            "killed_with_snapshots": durable / killed_s,
                            "resumed_with_snapshot":
                                resumed["ticks_per_s"]},
            "segments_no_dir": runlog_segments(tl["nodir"]),
            "segments_with_dir": runlog_segments(tl["dir"])}
    info["pull_s"] = snapshot_pull(torch, conf)
    log("checkpoint: " + json.dumps(info))
    shutil.rmtree(ckdir, ignore_errors=True)
    return info


def snapshot_pull(torch, conf: str) -> dict:
    """Seconds to copy the conf's warm carry from the card to the host,
    in turns: into fresh pageable arrays (``convert.carry_leaves``) and
    into ``chunked_run``'s two pinned sets (the first use of each set
    allocates it)."""
    from distributed_membership_tpu_torch.backends import tpu_hash
    from distributed_membership_tpu_torch.config import Params
    from distributed_membership_tpu_torch.convert import carry_leaves
    from distributed_membership_tpu_torch.ops.megakernel import carry_bytes
    from distributed_membership_tpu_torch.runtime import checkpoint as ck
    from distributed_membership_tpu_torch.runtime.failures import (
        make_run_key)

    params = Params.from_file(conf)
    cfg = tpu_hash.make_config(params, False, fail_ids=(0,), device="cuda")
    carry = tpu_hash.init_state_warm(cfg, make_run_key(params, 1), "cuda")
    host = ck._HostCopies()
    out = {"pageable": [], "pinned_first": [], "pinned": []}
    for kind in ("pageable", "pinned_first", "pinned_first", "pinned",
                 "pinned", "pageable"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaves = (carry_leaves(carry) if kind == "pageable"
                  else host.pull(carry))
        out[kind].append(time.perf_counter() - t0)
        del leaves
    out["bytes"] = carry_bytes(carry)["full"]
    del carry, host
    return out


def phase_checkpoint_sharded_folded(torch, confs: str, paths: dict,
                                    out_dir: str, card: str) -> dict:
    """The eight-shard folded lossy path (TELEMETRY hist) in 16-tick
    segments, killed at 40 (the manifest at 48) and resumed: its summary
    and timeline equal the sharded_folded_lossy path's."""
    import shutil

    from distributed_membership_tpu_torch.runtime import checkpoint as ck
    conf = os.path.join(confs, "ring_1m_s16_folded_sharded8_drop.conf")

    def per_tick(n):
        return launches_expected(receive_folded=n, gossip_folded=n,
                                 probe_folded_hist=n)

    lossy = twin(torch, paths, "sharded_folded_lossy", conf, per_tick(64),
                 out_dir)
    tl = os.path.join(out_dir, "checkpoint_sharded_folded_tl")
    ckdir = os.path.join(out_dir, "checkpoint_sharded_folded_ck")
    for d in (tl, ckdir):
        shutil.rmtree(d, ignore_errors=True)
    killed_s = run_killed(torch, conf, "checkpoint_sharded_folded_killed",
                          per_tick(48), out_dir, 40, checkpoint_every=16,
                          checkpoint_dir=ckdir, telemetry_dir=tl)
    if ck.manifest_tick(ckdir) != 48:
        raise AssertionError("checkpoint_sharded_folded: manifest at "
                             f"{ck.manifest_tick(ckdir)}, not 48")
    # The reshard phase's scale-in source: this boundary, kept before the
    # resume below moves the manifest on (snapshots hard-linked: the
    # writer replaces and unlinks, never rewrites, a file).
    keep_boundary(ckdir, tl, os.path.join(out_dir, "reshard_folded"))
    resumed = run_path(torch, conf, "checkpoint_sharded_folded",
                       per_tick(16), out_dir, ticks=16, checkpoint_every=16,
                       checkpoint_dir=ckdir, resume=True, telemetry_dir=tl)
    same_detection("checkpoint_sharded_folded", resumed, lossy,
                   "sharded_folded_lossy")
    same_series("checkpoint_sharded_folded", "sharded_folded_lossy")
    info = {"card": card, "launches": per_tick(64), "ticks_per_s": {
        "sharded_folded_lossy": lossy["ticks_per_s"],
        "killed_with_snapshots": 48 / killed_s,
        "resumed": resumed["ticks_per_s"]},
        "snapshot_bytes": {f: os.path.getsize(os.path.join(ckdir, f))
                           for f in sorted(os.listdir(ckdir))
                           if f.endswith(".npz")},
        "segments": runlog_segments(tl)}
    log("checkpoint_sharded_folded: summary and timeline equal "
        "sharded_folded_lossy's; " + json.dumps(info))
    shutil.rmtree(ckdir, ignore_errors=True)
    return info


def keep_boundary(ckdir: str, tl: str, dest: str) -> None:
    """A copy of a killed run's durable boundary at ``dest``: ``ck/``
    (npz snapshots hard-linked, the manifest copied) and ``tl/`` (its
    telemetry files copied: the recorder appends to them in place)."""
    import shutil
    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(os.path.join(dest, "ck"))
    for f in os.listdir(ckdir):
        src, dst = os.path.join(ckdir, f), os.path.join(dest, "ck", f)
        if f.endswith(".npz"):
            os.link(src, dst)
        else:
            shutil.copy2(src, dst)
    shutil.copytree(tl, os.path.join(dest, "tl"))


def checkpoint_parity(torch, conf: str, name: str, every: int, kill: int,
                      expect_tick: dict, out_dir: str) -> dict:
    """A full-event conf killed on the card and resumed on the CPU, and
    killed on the CPU and resumed on the card: the three logs (and the
    scenario report) equal the CPU's uninterrupted run.  The card's runs
    launch each kernel of ``expect_tick`` once per tick they drive."""
    import shutil

    from distributed_membership_tpu_torch.runtime import checkpoint as ck
    from distributed_membership_tpu_torch.runtime.application import run_conf

    ref_dir = os.path.join(out_dir, f"{name}_ref")
    ref = run_conf(conf, out_dir=ref_dir, device="cpu")
    total = ref.params.TOTAL_TIME
    mark = -(-kill // every) * every

    def expect(n):
        return launches_expected(**{k: n for k in expect_tick})

    walls = {}
    for killer, resumer in (("cuda", "cpu"), ("cpu", "cuda")):
        tag = f"{name}_{killer}_to_{resumer}"
        ckdir = os.path.join(out_dir, f"{tag}_ck")
        shutil.rmtree(ckdir, ignore_errors=True)
        kw = dict(checkpoint_every=every, checkpoint_dir=ckdir)
        if killer == "cuda":
            walls[tag + "_killed"] = run_killed(
                torch, conf, f"{tag}_killed", expect(mark), out_dir, kill,
                **kw)
        else:
            os.environ[ck.CRASH_ENV] = str(kill)
            try:
                run_conf(conf, out_dir=os.path.join(out_dir, f"{tag}_killed"),
                         device="cpu", **kw)
                raise AssertionError(f"{tag}: no injected crash")
            except RuntimeError as e:
                if "injected crash" not in str(e):
                    raise
            finally:
                del os.environ[ck.CRASH_ENV]
        if ck.manifest_tick(ckdir) != mark:
            raise AssertionError(f"{tag}: manifest at "
                                 f"{ck.manifest_tick(ckdir)}, not {mark}")
        out = os.path.join(out_dir, f"{tag}_resumed")
        from distributed_membership_tpu_torch import kernels
        kernels.reset_launches()
        res = run_conf(conf, out_dir=out, device=resumer, resume=True, **kw)
        launches = dict(kernels.LAUNCHES)
        want = expect(total - mark) if resumer == "cuda" else expect(0)
        if launches != want:
            raise AssertionError(f"{tag}: launches {launches} != {want}")
        same_logs(ref_dir, out, tag)
        if res.extra.get("scenario_report") != ref.extra.get(
                "scenario_report"):
            raise AssertionError(f"{tag}: scenario report differs")
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"{name}: killed at {kill} (manifest {mark}) on the card and "
        "resumed on the CPU, and the reverse: logs"
        + (" and scenario report" if "scenario_report" in ref.extra else "")
        + " byte-identical to the CPU's uninterrupted run; "
        + json.dumps(walls))
    return walls


def oracle_digest(report: dict) -> dict:
    """The scenario oracle's verdicts (scenario/oracle.py): its basis, the
    partition, crash and restart entries, the final census and each
    invariant's pass/fail."""
    return {"basis": report["basis"], "partitions": report["partitions"],
            "crashes": report["crashes"], "restarts": report["restarts"],
            "final": report.get("final"),
            "invariants": {k: v["ok"]
                           for k, v in report["invariants"].items()},
            "violations": report["violations"]}


def same_report(res: dict, name: str) -> None:
    """Raise unless the card's and the CPU's scenario reports are equal."""
    reps = {d: r.extra.get("scenario_report") for d, r in res.items()}
    if reps["cuda"] is None or reps["cuda"] != reps["cpu"]:
        raise AssertionError(f"{name}: scenario reports differ between "
                             "cuda and cpu (or are missing)")


def reconcile(name: str, result) -> dict:
    """The per-tick series of a TELEMETRY run against its detection
    summary: joins, removals, detections and message totals must sum to
    the summary's, and the hist tier's latency mass to its detections.
    Returns the series' totals."""
    series = result.extra["timeline"]
    det = result.extra["detection_summary"]
    if series["ticks"] != result.params.TOTAL_TIME:
        raise AssertionError(f"{name}: timeline has {series['ticks']} ticks")
    n_det = det.get("detections_total", 0)
    want = {"joins": det["joins_total"],
            "removals": det["false_removals"] + n_det,
            "detections": n_det, "msgs_sent": det["msgs_sent"],
            "msgs_recv": det["msgs_recv"]}
    if "h_latency" in series:
        want["h_latency"] = n_det
    got = {k: int(series[k].sum()) for k in want}
    if got != want:
        raise AssertionError(f"{name}: timeline sums {got} != summary {want}")
    totals = {k: int(series[k].sum()) for k in
              ("joins", "removals", "detections", "dropped", "probe_acks",
               "gossip_rows")}
    totals["suspected_peak"] = int(series["suspected"].max())
    log(f"{name}: timeline reconciles with the detection summary: "
        + json.dumps(totals))
    return totals


def same_logs(a: str, b: str, what: str, need_removal: bool = True) -> None:
    """Raise unless the run directories ``a`` and ``b`` hold byte-identical
    logs (and, with ``need_removal``, a removal in dbg.log)."""
    for f in LOGS:
        x, y = (open(os.path.join(d, f), "rb").read() for d in (a, b))
        if x != y:
            raise AssertionError(f"{what}: {f} differs between {a} and {b}")
        if f == "dbg.log" and need_removal and b" removed " not in x:
            raise AssertionError(f"{what}: dbg.log holds no removal")


def card_vs_cpu(torch, conf: str, name: str, expect: dict, out_dir: str,
                card: str) -> dict:
    """run_conf of a full-event conf on the card (launch counts set to 0
    just before and read just after, and held to ``expect``) and on the
    CPU; the logs must be byte-identical."""
    from distributed_membership_tpu_torch import kernels
    from distributed_membership_tpu_torch.runtime.application import run_conf

    dirs = {d: os.path.join(out_dir, f"{name}_{d}") for d in ("cuda", "cpu")}
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_conf(conf, out_dir=dirs["cuda"], device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if launches != expect:
        raise AssertionError(f"{name}: launches {launches} != {expect}")
    if not res.extra["final_state"].view.is_cuda:
        raise AssertionError(f"{name}: the final state is not on the card")
    t1 = time.perf_counter()
    cpu = run_conf(conf, out_dir=dirs["cpu"], device="cpu")
    cpu_wall = time.perf_counter() - t1
    same_logs(dirs["cuda"], dirs["cpu"], name)
    if "scenario_report" in cpu.extra:
        same_report({"cuda": res, "cpu": cpu}, name)
    ticks = res.params.TOTAL_TIME
    info = {"n": res.params.EN_GPSZ, "ticks": ticks, "wall_s": wall,
            "ms_per_tick": wall * 1e3 / ticks, "cpu_wall_s": cpu_wall,
            "launches": {k: v for k, v in launches.items() if v},
            "card": card}
    log(f"{name}: logs byte-identical, cuda vs cpu; " + json.dumps(info))
    return info


def state_parity(torch, conf: str, name: str, out_dir: str,
                 card: str) -> None:
    """run_conf of an agg-mode conf on the card and on the CPU: the
    detection summaries, every leaf of the final states and, under
    TELEMETRY, every timeline series must be identical."""
    import numpy as np

    from distributed_membership_tpu_torch.convert import state_to_numpy
    from distributed_membership_tpu_torch.runtime.application import run_conf

    walls, res = {}, {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[d] = run_conf(conf, out_dir=os.path.join(out_dir, f"{name}_{d}"),
                          device=d)
        walls[d] = time.perf_counter() - t0
    summ = {d: r.extra["detection_summary"] for d, r in res.items()}
    if summ["cuda"] != summ["cpu"]:
        raise AssertionError(f"{name}: detection summaries differ: {summ}")
    leaves = {d: state_to_numpy(r.extra["final_state"])
              for d, r in res.items()}
    if leaves["cuda"].keys() != leaves["cpu"].keys():
        raise AssertionError(f"{name}: state leaves differ")
    for leaf, want in leaves["cpu"].items():
        got = leaves["cuda"][leaf]
        if got.shape != want.shape or (got != want).any():
            raise AssertionError(f"{name}: final state leaf {leaf} differs "
                                 "between cuda and cpu")
    if summ["cpu"].get("detections_total", 0) <= 0:
        raise AssertionError(f"{name}: no detection")
    what = f"{len(leaves['cpu'])} final-state leaves"
    if "scenario_report" in res["cpu"].extra:
        same_report(res, name)
        what += ", the scenario report"
    if "timeline" in res["cpu"].extra:
        series = {d: r.extra["timeline"] for d, r in res.items()}
        if series["cuda"].keys() != series["cpu"].keys() or any(
                not np.array_equal(series["cuda"][k], series["cpu"][k])
                for k in series["cpu"]):
            raise AssertionError(f"{name}: timelines differ between cuda "
                                 "and cpu")
        reconcile(name, res["cuda"])
        what += f", {len(series['cpu'])} timeline series"
    log(f"{name}: N={res['cpu'].params.EN_GPSZ} detection summary, {what} "
        f"identical, cuda vs cpu; " + json.dumps(
            {"wall_s": walls["cuda"], "cpu_wall_s": walls["cpu"],
             "ms_per_tick": walls["cuda"] * 1e3 / res["cpu"].params.TOTAL_TIME,
             "card": card}))


def telemetry_parity(torch, conf: str, out_dir: str, card: str) -> None:
    """A full-event conf with TELEMETRY hist on the card (K3's hist form
    once per tick) against the CPU: its three logs equal the CPU run's
    with TELEMETRY off (the recorder leaves the trajectory alone), and its
    timeline equals the CPU run's with TELEMETRY hist."""
    import numpy as np

    from distributed_membership_tpu_torch import kernels
    from distributed_membership_tpu_torch.runtime.application import run_conf

    dirs = {k: os.path.join(out_dir, f"telemetry_{k}")
            for k in ("cuda_hist", "cpu_off", "cpu_hist")}
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = {"cuda_hist": run_conf(conf, out_dir=dirs["cuda_hist"],
                                 device="cuda", telemetry="hist")}
    torch.cuda.synchronize()
    ticks = res["cuda_hist"].params.TOTAL_TIME
    expect = launches_expected(receive=ticks, gossip_masks=ticks,
                               probe_hist=ticks)
    if dict(kernels.LAUNCHES) != expect:
        raise AssertionError(f"telemetry: launches {dict(kernels.LAUNCHES)} "
                             f"!= {expect}")
    res["cpu_off"] = run_conf(conf, out_dir=dirs["cpu_off"], device="cpu",
                              telemetry="off")
    res["cpu_hist"] = run_conf(conf, out_dir=dirs["cpu_hist"], device="cpu",
                               telemetry="hist")
    same_logs(dirs["cuda_hist"], dirs["cpu_off"], "telemetry")
    a, b = (res[k].extra["timeline"] for k in ("cuda_hist", "cpu_hist"))
    if a.keys() != b.keys() or any(not np.array_equal(a[k], b[k])
                                   for k in a):
        raise AssertionError("telemetry: the card's timeline differs from "
                             "the CPU's")
    if "timeline" in res["cpu_off"].extra or int(a["dropped"].sum()) <= 0:
        raise AssertionError("telemetry: TELEMETRY off recorded a timeline, "
                             "or the hist run counted no drop")
    log(f"telemetry: N={res['cpu_off'].params.EN_GPSZ} full-event logs with "
        "TELEMETRY hist on the card == TELEMETRY off on the CPU; timelines "
        f"identical, cuda vs cpu ({len(a)} series); card: {card}")


def phase_legacy(torch, paths: dict, main_conf: str, drop256: str,
                 lossy256: dict, out_dir: str, card: str) -> None:
    """The legacy threefry stream: the main path for 40 ticks, the N=256
    lossy conf card vs CPU, and legacy bits of 2^20 and 2^20 + 1 elements
    card == CPU."""
    from distributed_membership_tpu_torch.ops import threefry

    with threefry.partitionable(False):
        paths["legacy"] = run_path(
            torch, conf_variant(main_conf, out_dir, "legacy_1m",
                                TOTAL_TIME=40, FAIL_TIME=8),
            "legacy", launches_expected(receive=40, gossip=40, probe=40),
            out_dir)
        torch.cuda.empty_cache()
        paths["legacy_parity"] = card_vs_cpu(torch, drop256, "legacy_parity",
                                             lossy256, out_dir, card)
        key = threefry.fold_in(threefry.prng_key(2026), 7)
        for n in (1 << 20, (1 << 20) + 1):
            got = threefry.random_bits(key, n, "cuda").cpu()
            if not torch.equal(got, threefry.random_bits(key, n, "cpu")):
                raise AssertionError(f"legacy bits of {n} elements differ "
                                     "between cuda and cpu")
        log("legacy: 2^20 and 2^20 + 1 legacy bits identical, cuda vs cpu")


def phase_grade(torch, out_dir: str, card: str, seed: int = 3) -> dict:
    """``--grade-all`` (``application.grade_all`` on the parsed flags, as
    ``main`` calls it) on the card and on the CPU: both grade 90, their
    logs agree, the card run launches no kernel (the scatter step has
    none) and its final states lie on the card."""
    import contextlib
    import io

    from distributed_membership_tpu_torch import kernels
    from distributed_membership_tpu_torch.runtime import application

    walls = {}
    launches = {}
    results = {"cuda": [], "cpu": []}
    for d in ("cuda", "cpu"):
        buf = io.StringIO()
        args = application.parser().parse_args([
            "--grade-all", "--device", d, "--seed", str(seed),
            "--out-dir", os.path.join(out_dir, f"grade_{d}")])
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = application.grade_all(args, results[d])
        torch.cuda.synchronize()
        walls[d] = time.perf_counter() - t0
        if d == "cuda":
            launches = dict(kernels.LAUNCHES)
        for line in buf.getvalue().splitlines():
            log(f"grade[{d}]: {line}")
        if rc != 0 or buf.getvalue().splitlines()[-1] != "Final grade 90":
            raise AssertionError(f"grade: --grade-all on {d} exited {rc}")
    if any(launches.values()):
        raise AssertionError(f"grade: kernels launched: {launches}")
    for scenario in application.SCENARIOS:
        same_logs(*(os.path.join(out_dir, f"grade_{d}", scenario)
                    for d in ("cuda", "cpu")), f"grade[{scenario}]")
    off = [k for res, _ in results["cuda"]
           for k, v in state_tensors(res.extra["final_state"])
           if not v.is_cuda]
    if off:
        raise AssertionError(f"grade: final state leaves off the card: {off}")
    ticks = sum(res.params.TOTAL_TIME for res, _ in results["cuda"])
    info = {"ticks": ticks, "wall_s": walls["cuda"],
            "ms_per_tick": walls["cuda"] * 1e3 / ticks,
            "cpu_wall_s": walls["cpu"], "card": card}
    log("grade: 90/90 on cuda and cpu, logs byte-identical, no kernel "
        "launched; " + json.dumps(info))
    return info


def state_tensors(state):
    """``(name, tensor)`` for every leaf of a state, its agg's too."""
    for name, leaf in state._asdict().items():
        if hasattr(leaf, "_asdict"):
            yield from ((f"{name}.{k}", v) for k, v in leaf._asdict().items())
        else:
            yield name, leaf


def phase_profile(torch, conf: str, name: str, out_dir: str,
                  warm: int = 3, ticks: int = 5, telemetry=None,
                  t0: int = 0) -> dict:
    """Where one tick of ``conf`` spends its time: the whole step, its RNG
    plan alone (CUDA events), and a torch.profiler window over ``ticks`` steps
    (device kernel time by name, device busy share of the wall, and the
    device span of each protocol-phase range ``dm_*``).  ``telemetry``
    overrides the conf's TELEMETRY; the warm state steps from tick ``t0``
    (inside a scenario's windows)."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_membership_tpu_torch.backends import (
        tpu_hash, tpu_hash_folded, tpu_hash_sharded)
    from distributed_membership_tpu_torch.config import Params
    from distributed_membership_tpu_torch.ops.rng_plan import (
        hash_ring_rng, sharded_ring_rng)
    from distributed_membership_tpu_torch.runtime import failures

    params = Params.from_file(conf)
    if telemetry is not None:
        params.TELEMETRY = telemetry
    plan = failures.resolve_plan(params, random.Random("app:0"))
    fail_ids = tpu_hash.plan_fail_ids(plan)
    scenario = tpu_hash.plan_scenario(plan)
    pt = failures.plan_tensors(params, plan, 0, params.TOTAL_TIME, "cuda")
    key0 = failures.make_run_key(params, 0 ^ 0x5EED)
    if params.BACKEND == "tpu_hash_sharded":
        mesh = tpu_hash_sharded.resolve_mesh(params, "cuda")
        n_local = mesh.rows_per_shard(params.EN_GPSZ)
        cfg = tpu_hash_sharded.sharded_config(params, False, fail_ids,
                                              n_local, device="cuda",
                                              scenario=scenario)
        if cfg.folded:
            step = tpu_hash_folded.make_ring_sharded_folded_step(cfg, mesh)
            state = tpu_hash_folded.init_local_state_warm_folded(cfg, mesh,
                                                                 key0)
        else:
            step = tpu_hash_sharded.make_ring_sharded_step(cfg, mesh)
            state = tpu_hash_sharded.init_local_state_warm(cfg, mesh, key0)

        def plan_rng(key):
            return sharded_ring_rng(
                key, range(mesh.size), n=cfg.n, n_local=n_local, s=cfg.s,
                g=cfg.g,
                k_max=min(cfg.fanout, cfg.s), p_cnt=cfg.probes,
                seed_rows=min(cfg.seed_cap, cfg.n),
                use_drop=tpu_hash.uses_drop(cfg), cold_join=False,
                device="cuda")
    else:
        cfg = tpu_hash.make_config(params, collect_events=False,
                                   fail_ids=fail_ids, device="cuda",
                                   scenario=scenario)
        step, init = tpu_hash.step_and_init(cfg)
        state = init(cfg, key0, "cuda")

        def plan_rng(key):
            return hash_ring_rng(
                key, n=cfg.n, s=cfg.s, g=cfg.g,
                k_max=min(cfg.fanout, cfg.s), p_cnt=cfg.probes,
                seed_rows=min(cfg.seed_cap, cfg.n),
                use_drop=tpu_hash.uses_drop(cfg), need_ctrl=not cfg.folded,
                need_burst=not cfg.folded, device="cuda")
    t = t0
    for t in range(t0, t0 + warm):
        state, _ = step(state, t, pt.tick_key(t), pt)

    def one_tick():
        nonlocal state, t
        t += 1
        state, _ = step(state, t, pt.tick_key(t), pt)

    step_ms = cuda_ms(one_tick, ticks)
    rng_ms = cuda_ms(lambda: plan_rng(pt.tick_key(t)), ticks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for _ in range(ticks):
            one_tick()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - w0) * 1e6
    per_kernel: dict = {}
    phase_span: dict = {}
    for e in prof.events():
        if e.name.startswith("dm_"):
            # A phase range, per tick, by its span on the card's timeline
            # from the first to the last kernel launched inside it (the
            # csrc kernels included; the host side's op-attributed device
            # time misses kernels launched through ctypes).  A range is
            # not a kernel, so it stays out of the kernel sums.
            if e.device_type == torch.autograd.DeviceType.CUDA:
                phase_span[e.name] = (phase_span.get(e.name, 0.0)
                                      + e.time_range.elapsed_us() / 1e3
                                      / ticks)
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, cnt = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                                  cnt + 1)
    dev_ms = sum(ms for ms, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    info = {"step_ms": step_ms, "rng_ms": rng_ms,
            "telemetry": params.TELEMETRY, "first_tick": t0,
            "profiled_ticks": ticks, "wall_ms": wall_us / 1e3,
            "device_ms": dev_ms,
            "device_busy_share": dev_ms * 1e3 / wall_us,
            "kernel_launches": sum(c for _, c in per_kernel.values()),
            "phase_span_ms_per_tick": dict(sorted(phase_span.items())),
            "top_device_ms": [[k[:70], ms, c] for k, (ms, c) in top]}
    log(f"profile[{name}]: " + json.dumps(info))
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as fh:
        fh.write(prof.key_averages().table(row_limit=40))
    return info


# ---------------------------------------------------------------------------
# The service daemon (phases serve*): the engine in this (main) thread,
# HTTP clients on threads or in processes

QUERY_PAUSE_S = 0.02            # a paced query thread's pause
CLIENT_CODE = """
import http.client, random, sys
port, n = int(sys.argv[1]), int(sys.argv[2])
rng, count = random.Random(port), 0
conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
try:
    while True:
        path = ("/v1/census" if count % 2 else
                f"/v1/member/{rng.randrange(n)}")
        conn.request("GET", path)
        conn.getresponse().read()
        count += 1
        if count % 1000 == 0:
            print(count, flush=True)
except (OSError, http.client.HTTPException):
    pass
"""


def http_get(port: int, path: str, method: str = "GET", body=None):
    """``(status, body bytes)`` of one request to 127.0.0.1:``port``."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def http_json(port: int, path: str, method: str = "GET", body=None):
    code, data = http_get(port, path, method, body)
    return code, json.loads(data)


def wait_health(port: int, pred, timeout: float = 600) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            code, h = http_json(port, "/healthz")
            if code == 200 and pred(h):
                return h
        except OSError:
            pass
        time.sleep(0.05)
    raise TimeoutError("the daemon's health never met the predicate")


def serve_in_process(torch, params, out_dir: str, script, device="cuda",
                     gates=None):
    """``service.daemon.serve_run(params)`` in this (main) thread, with
    ``script(port)`` on a client thread; the daemon always gets its
    shutdown.  ``gates`` ({tick: threading.Event}) park the engine after
    the boundary hook of those ticks until the script sets them.  Returns
    ``(rc, script's result, got)``: ``got`` holds the run's ControlState
    (``state``), its RunResult (``result``, a completed run only), the
    engine's wall seconds (``engine_s``, run_conf's backend tail with
    its boundary hooks), the last boundary's carry (``carry``), each
    published snapshot's ``derive_info`` (``derives``) and the
    ``(tick, start, end)`` clock spans of the hooks (``hooks``) and the
    derives (``publishes``)."""
    import threading

    from distributed_membership_tpu_torch.service import daemon
    from distributed_membership_tpu_torch.service.snapshot import Snapshot

    gates = gates or {}
    box, got = {}, {}
    orig_hook, orig_run = daemon._make_hook, daemon._run_backend

    def make_hook(state):
        got["state"] = state
        hook = orig_hook(state)

        def gated(carry, tick):
            t0 = time.perf_counter()
            upd = hook(carry, tick)
            got["hooks"].append((tick, t0, time.perf_counter()))
            got["carry"] = carry
            if tick in gates:
                gates[tick].wait(timeout=600)
            return upd
        return gated

    def run_backend(*a, **kw):
        t0 = time.perf_counter()
        try:
            got["result"] = orig_run(*a, **kw)
        finally:
            if device == "cuda":
                torch.cuda.synchronize()
            got["engine_end"] = time.perf_counter()
            got["engine_s"] = got["engine_end"] - t0
        return got["result"]

    got["derives"], got["hooks"], got["publishes"] = [], [], []
    orig_pre = Snapshot.precompute

    def precompute(snap, prev=None):
        t0 = time.perf_counter()
        orig_pre(snap, prev)
        got["derives"].append(snap.derive_info)
        got["publishes"].append((snap.tick, t0, time.perf_counter()))

    beacon = os.path.join(out_dir, daemon.SERVICE_JSON)
    os.makedirs(out_dir, exist_ok=True)
    if os.path.exists(beacon):
        os.unlink(beacon)

    def port():
        while True:
            try:
                return json.load(open(beacon))["port"]
            except (OSError, ValueError, KeyError):
                time.sleep(0.05)

    def client():
        try:
            box["result"] = script(port())
        except BaseException as e:      # re-raised on the main thread
            box["error"] = e
        finally:
            for g in gates.values():
                g.set()
            try:
                http_get(port(), "/v1/admin/shutdown", "POST", {})
            except OSError:
                pass

    daemon._make_hook, daemon._run_backend = make_hook, run_backend
    Snapshot.precompute = precompute
    t = threading.Thread(target=client, daemon=True, name="smoke-client")
    t.start()
    try:
        rc = daemon.serve_run(params, out_dir=out_dir, device=device)
    finally:
        daemon._make_hook, daemon._run_backend = orig_hook, orig_run
        Snapshot.precompute = orig_pre
    t.join(timeout=120)
    if "error" in box:
        raise box["error"]
    if t.is_alive():
        raise AssertionError("the service client thread is wedged")
    return rc, box.get("result"), got


def query_threads(port: int, n: int, stop, count: list, pause=0.0,
                  lat=None):
    """Four query threads in this process: /v1/census and
    /v1/member/<i> in turn, closed-loop (or one request every ``pause``
    seconds each), until ``stop``; 503 (no snapshot yet) is fine, any
    other failure code raises in the caller.  ``lat`` gets each
    request's ``(start, seconds, path)``."""
    import random
    import threading

    def one(k):
        rng = random.Random(k)
        i = 0
        while not stop.wait(pause):
            path = ("/v1/census" if i % 2 else
                    f"/v1/member/{rng.randrange(n)}")
            t0 = time.perf_counter()
            try:
                code, _ = http_get(port, path)
            except OSError:
                continue
            if lat is not None:
                lat.append((t0, time.perf_counter() - t0, path))
            if code not in (200, 503):
                count.append(("error", path, code))
            count.append(code)
            i += 1
    threads = [threading.Thread(target=one, args=(k,), daemon=True)
               for k in range(4)]
    for th in threads:
        th.start()
    return threads


def served_params(conf: str, **keys):
    """The conf's Params for a served run, validated, with ``keys``."""
    from distributed_membership_tpu_torch.config import Params
    params = Params.from_file(conf, validate=False)
    for k, v in keys.items():
        setattr(params, k, v)
    params.validate()
    return params


def phase_folded_probes0(torch, confs: str, paths: dict, out_dir: str,
                         card: str) -> None:
    """The folded path with PROBES 0: K5 and K6 once per tick, no K7;
    its N=2^14 lossy twin card vs CPU."""
    conf = os.path.join(confs, "ring_1m_s16_folded_probes0.conf")
    ticks = conf_ticks(conf)
    paths["folded_probes0"] = run_path(
        torch, conf, "folded_probes0", launches_expected(
            receive_folded=ticks, gossip_folded=ticks), out_dir)
    info = paths["folded_probes0"]
    if info["detection"].get("detections_total", 0) <= 0:
        raise AssertionError(f"folded_probes0: no detection {info}")
    log("folded_probes0: " + json.dumps(
        {"ms_per_tick": 1e3 / info["ticks_per_s"],
         "launches_per_tick": {k: v / ticks for k, v in
                               info["launches"].items() if v},
         "card": card}))
    torch.cuda.empty_cache()
    state_parity(torch, conf_variant(
        os.path.join(confs, "ring_16k_s16_folded_drop.conf"), out_dir,
        "folded_probes0_16k", PROBES=0), "folded_probes0_parity", out_dir,
        card)


def served_case(torch, params, out_dir: str, pause: float) -> tuple:
    """``params`` served on the card under four query threads (closed-
    loop, or paced by ``pause``) and a /metrics scraper every 0.5 s, with
    every launch count set to 0 just before; -> ``(launches, got, info)``
    where ``info`` holds what the case measured."""
    import threading

    from distributed_membership_tpu_torch import kernels
    from distributed_membership_tpu_torch.observability.metricsbus import (
        parse_text)
    from distributed_membership_tpu_torch.service import api

    lat = []

    def script(port):
        stop, codes, scrapes = threading.Event(), [], []
        threads = query_threads(port, params.EN_GPSZ, stop, codes, pause,
                                lat)

        def scrape():
            while not stop.wait(0.5):
                code, text = http_get(port, "/metrics")
                scrapes.append(code)
        scraper = threading.Thread(target=scrape, daemon=True)
        scraper.start()
        h = wait_health(port, lambda h: h["status"] == "complete")
        stop.set()
        for th in threads + [scraper]:
            th.join(timeout=60)
        bad = [c for c in codes if isinstance(c, tuple)]
        if bad or set(scrapes) - {200}:
            raise AssertionError(f"serve: failed queries {bad[:5]} "
                                 f"scrapes {sorted(set(scrapes))}")
        code, text = http_get(port, "/metrics")
        census = http_json(port, "/v1/census")[1]
        return h, parse_text(text.decode()), census, len(codes)

    # Where a slow query waited: gaps of a thread that only sleeps 1 ms
    # (every thread waited for the GIL then) and long idle holds of the
    # query gate, each as (start, ms).
    gaps, holds, done = [], [], threading.Event()

    def ticker():
        last = time.perf_counter()
        while not done.wait(0.001):
            now = time.perf_counter()
            if now - last > 0.02:
                gaps.append((last, (now - last) * 1e3))
            last = now

    class TimedGate(api.QueryGate):
        def leave(self, t0):
            start = time.perf_counter()
            super().leave(t0)
            hold = time.perf_counter() - start
            if hold > 0.02:
                holds.append((start + hold, hold * 1e3))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    tick_thread = threading.Thread(target=ticker, daemon=True)
    tick_thread.start()
    orig_gate, api.QueryGate = api.QueryGate, TimedGate
    t0 = time.perf_counter()
    try:
        rc, (h, metrics, census, queries), got = serve_in_process(
            torch, params, out_dir, script)
    finally:
        api.QueryGate = orig_gate
        done.set()
        tick_thread.join()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"serve: rc {rc}")
    got["gil_gaps"], got["gate_holds"] = gaps, holds
    state = got["state"]
    ticks = params.TOTAL_TIME
    info = {
        "load": ("closed-loop" if not pause else
                 f"paced, {pause} s between a thread's requests"),
        "served_ms_per_tick": got["engine_s"] * 1e3 / ticks,
        "host_pull_s_per_publish": state.pull_s / state.pulls,
        "host_pulls": state.pulls,
        "derives": [{"mode": d["mode"], "ms": d["ms"]}
                    for d in got["derives"]],
        "boundaries_published": state.publisher.publishes,
        "publisher_skipped": state.pulls - state.publisher.publishes,
        "queries": queries,
        "queries_per_s": queries / wall,
        "query_p50_ms": metrics.get(("dm_query_p50_ms", ())),
        "query_p99_ms": metrics.get(("dm_query_p99_ms", ())),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "census": census}
    info.update(latency_tail(lat, got))
    return launches, got, info


def latency_tail(lat: list, got: dict) -> dict:
    """The query threads' own p50/p99 (every request, from the client):
    of those that started while the engine ran (from its first boundary
    hook) and of those after it, while the publisher drains; and where
    the slowest tenth of a percent of them ran: the share that
    overlapped a boundary hook or a derive, and the ten slowest with
    their start against the run's first hook."""
    if not lat:
        return {}
    t_first = got["hooks"][0][1] if got["hooks"] else lat[0][0]

    def pct(rows):
        ms = sorted(x[1] * 1e3 for x in rows)
        return ms and {"requests": len(ms), "p50_ms": ms[len(ms) // 2],
                       "p99_ms": ms[min(len(ms) - 1, int(len(ms) * 0.99))],
                       "max_ms": ms[-1]}

    def during(t0, secs, spans):
        return any(a < t0 + secs and t0 < b for _, a, b in spans)
    slow = sorted(lat, key=lambda x: -x[1])[:max(len(lat) // 1000, 10)]
    return {
        "client_engine_running": pct([x for x in lat if t_first <= x[0]
                                      < got["engine_end"]]),
        "client_after_run": pct([x for x in lat
                                 if x[0] >= got["engine_end"]]),
        "slowest": len(slow),
        "slowest_in_hook": sum(during(t, d, got["hooks"]) for t, d, _ in slow),
        "slowest_in_derive": sum(during(t, d, got["publishes"])
                                 for t, d, _ in slow),
        "slowest_in_gil_gap": sum(during(t, d, [
            (0, a, a + ms / 1e3) for a, ms in got["gil_gaps"]])
            for t, d, _ in slow),
        "slowest_in_gate_hold": sum(during(t, d, [
            (0, b - ms / 1e3, b) for b, ms in got["gate_holds"]])
            for t, d, _ in slow),
        "gil_gaps_over_20ms": [(round(a - t_first, 3), round(ms, 1))
                               for a, ms in got["gil_gaps"]][:40],
        "gate_holds_over_20ms": [(round(b - t_first, 3), round(ms, 1))
                                 for b, ms in got["gate_holds"]][:40],
        "slowest10": [(round(t - t_first, 3), round(d * 1e3, 1), p[:10])
                      for t, d, p in slow[:10]],
        "hooks": [(k, round(a - t_first, 3), round(b - a, 3))
                  for k, a, b in got["hooks"]],
        "derive_spans": [(k, round(a - t_first, 3), round(b - a, 3))
                         for k, a, b in got["publishes"]]}


def gil_case(torch, conf: str, out_dir: str, mode: str,
             window_s: float = 5.0) -> dict:
    """The engine's ms/tick while four closed-loop query threads in its
    process read for up to ``window_s``, with the daemon's query gate
    (``mode`` "gated") or without it ("ungated"), or with no query
    thread ("idle"): the gate's reason, measured."""
    import threading

    from distributed_membership_tpu_torch.service import api

    class Ungated:
        def __init__(self, live):
            pass

        def enter(self):
            return 0.0

        def leave(self, t0):
            pass

    params = served_params(conf, CHECKPOINT_EVERY=2, TELEMETRY="off",
                           **DEPTH_CUTS["serve_gil_4k"])
    gates = {0: threading.Event()}

    def script(port):
        wait_health(port, lambda h: h["snapshot_tick"] == 0)
        stop, codes = threading.Event(), []
        threads = ([] if mode == "idle" else
                   query_threads(port, params.EN_GPSZ, stop, codes))
        t0 = time.perf_counter()
        gates[0].set()
        h = wait_health(port, lambda h: h["status"] == "complete"
                        or time.perf_counter() - t0 > window_s)
        secs = time.perf_counter() - t0
        stop.set()
        for th in threads:
            th.join(timeout=60)
        return h["tick"], secs, len(codes)

    orig = api.QueryGate
    if mode == "ungated":
        api.QueryGate = Ungated
    try:
        rc, (tick, secs, queries), _ = serve_in_process(
            torch, params, out_dir, script, "cuda", gates)
    finally:
        api.QueryGate = orig
    if rc != 0 or tick <= 0:
        raise AssertionError(f"serve[gil]: rc {rc}, tick {tick}")
    return {"mode": mode, "ticks": tick,
            "ms_per_tick": secs * 1e3 / tick, "queries": queries,
            "queries_per_s": queries / secs}


def pull_times(torch, carry) -> dict:
    """One boundary's six fields off the card: the pageable ``cpu()``
    pull against the pinned staging pull the hook makes and the copy-out
    the publisher makes, on the same carry, each timed twice."""
    from distributed_membership_tpu_torch.service import daemon

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    staging = daemon.SnapshotStaging()
    out = {"pageable_s": [], "pinned_s": [], "copy_out_s": []}
    for _ in range(2):
        out["pageable_s"].append(timed(lambda: daemon.pull_snapshot(carry))[1])
        pulled, secs = timed(lambda: staging.pull(carry))
        out["pinned_s"].append(secs)
        out["copy_out_s"].append(timed(pulled.arrays)[1])
    out["bytes"] = sum(getattr(carry, k).numel()
                       * getattr(carry, k).element_size()
                       for k in daemon.SNAPSHOT_FIELDS)
    return out


def phase_serve(torch, confs: str, out_dir: str, card: str) -> dict:
    """The 1M S=128 conf batch, then served under four closed-loop query
    threads and a scraper, then under four paced ones; the hook's pull
    against a pageable one; at N=4096 the engine under closed-loop
    threads with the query gate and without it."""
    conf = os.path.join(confs, "ring_1m_s128_serve.conf")
    ticks = conf_ticks(conf)
    expect = launches_expected(receive=ticks, gossip=ticks, probe=ticks)
    batch = run_path(torch, conf, "serve_batch", expect, out_dir)
    torch.cuda.empty_cache()
    params = served_params(conf)
    n = params.EN_GPSZ
    want = dict(batch["detection"])
    info = {"ticks": ticks, "n": n,
            "batch_ms_per_tick": 1e3 / batch["ticks_per_s"],
            "batch_peak_mem_gib": batch["peak_mem_gib"], "card": card}
    for case, pause in (("closed_loop", 0.0), ("paced", QUERY_PAUSE_S)):
        launches, got, info[case] = served_case(
            torch, params, os.path.join(out_dir, f"serve_{case}"), pause)
        if launches != expect:
            raise AssertionError(f"serve[{case}]: launches {launches}")
        det = got["result"].extra["detection_summary"]
        if {k: v for k, v in det.items()
                if k != "latency_hist_nonzero"} != want:
            raise AssertionError(f"serve[{case}]: summary {det} != "
                                 f"batch's {want}")
        census = info[case]["census"]
        if census["tick"] != ticks or census["n"] != n:
            raise AssertionError(f"serve[{case}]: final census {census}")
        if case == "paced":
            info["pull"] = pull_times(torch, got["carry"])
        del got
        torch.cuda.empty_cache()
    small = os.path.join(confs, "ring_4k_s128_serve_inject.conf")
    info["gil_4k"] = [gil_case(torch, small, os.path.join(
        out_dir, f"serve_gil_{m}"), m) for m in ("idle", "gated", "ungated")]
    log("serve: summary == batch's; " + json.dumps(info))
    torch.cuda.empty_cache()
    return info


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def phase_serve_inject(torch, confs: str, out_dir: str, card: str) -> dict:
    """An injected crash, uninterrupted; stopped over HTTP, resumed
    served, stopped again, resumed headless; the CPU's served run."""
    import threading

    from distributed_membership_tpu_torch import kernels
    from distributed_membership_tpu_torch.runtime import checkpoint as ck
    from distributed_membership_tpu_torch.runtime.application import run_conf

    conf = os.path.join(confs, "ring_4k_s128_serve_inject.conf")
    event = {"kind": "crash", "time": 40, "nodes": [3]}
    root = os.path.join(out_dir, "serve_inject")

    def dirs(tag):
        return dict(CHECKPOINT_DIR=os.path.join(root, f"{tag}_ck"),
                    TELEMETRY_DIR=os.path.join(root, f"{tag}_tl"))

    def inject(stop_too):
        def script(port):
            wait_health(port, lambda h: h["snapshot_tick"] is not None)
            code, reply = http_json(port, "/v1/events", "POST", event)
            if code != 202 or reply["apply_at_tick"] != 30:
                raise AssertionError(f"serve_inject: POST {code} {reply}")
            if stop_too:
                http_get(port, "/v1/admin/shutdown", "POST", {})
            gates[0].set()
            if not stop_too:
                return wait_health(port, lambda h: h["status"] == "complete")
        return script

    walls, counts = {}, {}
    runs = (("a", "cuda", False), ("a_cpu", "cpu", False),
            ("b", "cuda", True))
    for tag, device, stop_too in runs:
        gates = {0: threading.Event()}
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc, _, got = serve_in_process(
            torch, served_params(conf, **dirs(tag)),
            os.path.join(root, tag), inject(stop_too), device, gates)
        walls[tag] = time.perf_counter() - t0
        counts[tag] = dict(kernels.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"serve_inject[{tag}]: rc {rc}")
    if ck.manifest_tick(dirs("b")["CHECKPOINT_DIR"]) != 30:
        raise AssertionError("serve_inject: the stop did not land at 30")
    # Resume served; a stop asked at the resumed boundary 30 lands at 60.
    gates = {30: threading.Event()}

    def stop_at_60(port):
        wait_health(port, lambda h: h["snapshot_tick"] == 30)
        http_get(port, "/v1/admin/shutdown", "POST", {})
        gates[30].set()

    kernels.reset_launches()
    rc, _, _ = serve_in_process(
        torch, served_params(conf, RESUME=1, **dirs("b")),
        os.path.join(root, "b"), stop_at_60, "cuda", gates)
    counts["b2"] = dict(kernels.LAUNCHES)
    if rc != 0 or ck.manifest_tick(dirs("b")["CHECKPOINT_DIR"]) != 60:
        raise AssertionError("serve_inject: the resumed stop missed 60")
    kernels.reset_launches()
    run_conf(conf, out_dir=os.path.join(root, "b"), device="cuda",
             checkpoint_dir=dirs("b")["CHECKPOINT_DIR"], resume=True,
             telemetry_dir=dirs("b")["TELEMETRY_DIR"])
    counts["b3"] = dict(kernels.LAUNCHES)
    # A crash alone masks no shift: K2's k_eff form throughout.
    for tag, ticks in (("a", 120), ("a_cpu", 0), ("b", 30), ("b2", 30),
                       ("b3", 60)):
        if counts[tag] != launches_expected(receive=ticks, gossip=ticks,
                                            probe=ticks):
            raise AssertionError(f"serve_inject[{tag}]: launches "
                                 f"{counts[tag]}")
    files = [(f, f) for f in LOGS] + [(os.path.join("..", "{}_tl",
                                                    "timeline.jsonl"),
                                       "timeline.jsonl")]
    for rel, what in files:
        got = {tag: _read(os.path.join(root, tag, rel.format(tag)))
               for tag in ("a", "a_cpu", "b")}
        if not got["a"] == got["a_cpu"] == got["b"]:
            raise AssertionError(f"serve_inject: {what} differs")
    if b" removed " not in _read(os.path.join(root, "a", "dbg.log")):
        raise AssertionError("serve_inject: the injected crash was not "
                             "detected")
    info = {"walls_s": walls, "launch_counts": {
        t: {k: v for k, v in c.items() if v} for t, c in counts.items()},
        "card": card}
    log("serve_inject: logs and timeline.jsonl byte-identical: served "
        "uninterrupted (card), served on the CPU, and stopped/resumed "
        "served/resumed headless (card); " + json.dumps(info))
    return info


def phase_serve_sharded(torch, confs: str, out_dir: str, card: str) -> dict:
    """Eight shards served, a crash injected at boundary 0, against the
    CPU's run of the union scenario."""
    import threading

    from distributed_membership_tpu_torch import kernels
    from distributed_membership_tpu_torch.runtime.application import run_conf

    conf = os.path.join(confs, "ring_16k_s128_sharded8_serve.conf")
    ticks = conf_ticks(conf)
    event = {"kind": "crash", "time": 40, "nodes": [3]}
    root = os.path.join(out_dir, "serve_sharded")
    gates = {0: threading.Event()}

    def script(port):
        wait_health(port, lambda h: h["snapshot_tick"] is not None)
        code, reply = http_json(port, "/v1/events", "POST", event)
        if code != 202:
            raise AssertionError(f"serve_sharded: POST {code} {reply}")
        gates[0].set()
        return wait_health(port, lambda h: h["status"] == "complete")

    kernels.reset_launches()
    t0 = time.perf_counter()
    rc, h, got = serve_in_process(
        torch, served_params(conf,
                             TELEMETRY_DIR=os.path.join(root, "live_tl")),
        os.path.join(root, "live"), script, "cuda", gates)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    expect = launches_expected(receive=ticks, gossip_stacked=ticks,
                               probe=ticks)
    if rc != 0 or launches != expect or h["applied_events"] != 1:
        raise AssertionError(f"serve_sharded: rc {rc} launches {launches}")
    union = os.path.join(root, "union.json")
    with open(union, "w") as fh:
        json.dump({"name": "union", "events": [event]}, fh)
    t1 = time.perf_counter()
    run_conf(conf_variant(conf, out_dir, "serve_sharded_twin",
                          SERVICE_PORT=-1),
             out_dir=os.path.join(root, "twin"), device="cpu",
             scenario=union, telemetry_dir=os.path.join(root, "twin_tl"))
    cpu_wall = time.perf_counter() - t1
    same_logs(os.path.join(root, "live"), os.path.join(root, "twin"),
              "serve_sharded")
    if (_read(os.path.join(root, "live_tl", "timeline.jsonl"))
            != _read(os.path.join(root, "twin_tl", "timeline.jsonl"))):
        raise AssertionError("serve_sharded: timeline.jsonl differs")
    info = {"n": got["state"].params.EN_GPSZ, "shards": 8, "ticks": ticks,
            "wall_s": wall,
            "cpu_twin_wall_s": cpu_wall,
            "mesh_size": got["result"].extra["mesh_size"], "card": card}
    log("serve_sharded: the live injection == the CPU's union-scenario "
        "twin (logs, timeline.jsonl); " + json.dumps(info))
    return info


def phase_serve_replicas(torch, confs: str, out_dir: str,
                         card: str) -> dict:
    """Two read replicas under four closed-loop client processes."""
    import threading

    from distributed_membership_tpu_torch import kernels
    from distributed_membership_tpu_torch.service import shm_ring

    conf = os.path.join(confs, "ring_16k_s128_serve_replicas.conf")
    ticks = conf_ticks(conf)
    expect = launches_expected(receive=ticks, gossip=ticks, probe=ticks)
    batch = run_path(torch, conf, "serve_replicas_batch", expect, out_dir)
    params = served_params(conf)
    gates = {0: threading.Event()}
    box = {}

    def same_census(port, reps, tick):
        want = None
        for rp in reps:
            deadline = time.monotonic() + 120
            while True:
                code, h = http_json(rp, "/healthz")
                if code == 200 and h["snapshot_tick"] == tick:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"replica {rp} never reached "
                                         f"tick {tick}")
                time.sleep(0.05)
            got = http_get(rp, "/v1/census")
            want = want or http_get(port, "/v1/census")
            if got != want or json.loads(got[1])["tick"] != tick:
                raise AssertionError(f"replica {rp}: census {got} != the "
                                     f"daemon's {want}")

    def script(port):
        h = wait_health(port, lambda h: h.get("replicas")
                        and h.get("snapshot_tick") == 0)
        reps = [r["port"] for r in h["replicas"]]
        same_census(port, reps, 0)
        clients = [subprocess.Popen(
            [sys.executable, "-c", CLIENT_CODE, str(reps[k % len(reps)]),
             str(params.EN_GPSZ)], stdout=subprocess.PIPE, text=True)
            for k in range(4)]
        try:
            # From the release of the boundary-0 park to the run's end.
            t0 = time.perf_counter()
            gates[0].set()
            wait_health(port, lambda h: h["status"] == "complete")
            box["served_s"] = time.perf_counter() - t0
            same_census(port, reps, ticks)
            beacons = [json.load(open(os.path.join(
                out_dir, "serve_replicas", f"replica_{i}.json")))
                for i in range(len(reps))]
        finally:
            for c in clients:
                c.terminate()
            for c in clients:
                c.wait(timeout=30)
        return reps, beacons

    kernels.reset_launches()
    rc, (reps, beacons), got = serve_in_process(
        torch, params, os.path.join(out_dir, "serve_replicas"), script,
        "cuda", gates)
    launches = dict(kernels.LAUNCHES)
    if rc != 0 or launches != expect:
        raise AssertionError(f"serve_replicas: rc {rc} launches {launches}")
    det = got["result"].extra["detection_summary"]
    if {k: v for k, v in det.items()
            if k != "latency_hist_nonzero"} != batch["detection"]:
        raise AssertionError("serve_replicas: summary differs from batch")
    mine = f"dmring_{os.getpid():x}_"
    left = [s for s in shm_ring.stale_segments() if s.startswith(mine)]
    if left:
        raise AssertionError(f"serve_replicas: /dev/shm keeps {left}")
    info = {"n": params.EN_GPSZ, "ticks": ticks, "replicas": len(reps),
            "served_ms_per_tick": box["served_s"] * 1e3 / ticks,
            "batch_ms_per_tick": 1e3 / batch["ticks_per_s"],
            "replica_queries": [b.get("queries") for b in beacons],
            "replica_qps": [b.get("qps") for b in beacons],
            "replica_p50_ms": [b.get("p50_ms") for b in beacons],
            "replica_p99_ms": [b.get("p99_ms") for b in beacons],
            "card": card}
    log("serve_replicas: each replica's census == the daemon's at ticks 0 "
        f"and {ticks}; summary == batch's; no ring left in /dev/shm; "
        + json.dumps(info))
    return info


def reshard_arm(torch, src: str, to_shape: str) -> dict:
    """The port's ``reshard`` of the checkpoint in ``src`` to
    ``to_shape``, in place, with the codec round trip on the card; its
    stats with the peak device memory it took."""
    from distributed_membership_tpu_torch.elastic.reshard import reshard
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stats = reshard([src], [src], to_mesh_shape=to_shape, device="cuda")
    torch.cuda.synchronize()
    stats["peak_device_bytes"] = torch.cuda.max_memory_allocated() - base
    return stats


def phase_reshard(torch, confs: str, out_dir: str, card: str) -> dict:
    """Scale in, folded: the eight-shard lossy hist checkpoint at tick 48
    (kept by checkpoint_sharded_folded) resharded to 4x2 and resumed
    with --mesh-shape 4x2, against a 4x2 twin chunked from tick 0 (mesh
    shapes differ in their per-shard RNG plan, so the twin is the target
    shape's run).  Scale out, natural: the one-shard S=128 path killed at
    40 (manifest at 48) resharded to 8 and resumed; at 2^14 the card's
    resume equals the CPU's."""
    import shutil

    from distributed_membership_tpu_torch.runtime import checkpoint as ck
    info = {"card": card}

    def per_tick(n, **kinds):
        return launches_expected(**{k: n for k in kinds})

    # Scale in, folded (K5, K6's D-shard launch, K7 hist).
    conf = os.path.join(confs, "ring_1m_s16_folded_sharded8_drop.conf")
    folded = dict(receive_folded=1, gossip_folded=1, probe_folded_hist=1)
    root = os.path.join(out_dir, "reshard_folded")
    src, tl = os.path.join(root, "ck"), os.path.join(root, "tl")
    if ck.manifest_tick(src) != 48:       # a partial run: make it now
        shutil.rmtree(root, ignore_errors=True)
        run_killed(torch, conf, "reshard_folded_killed",
                   per_tick(48, **folded), out_dir, 40, checkpoint_every=16,
                   checkpoint_dir=src, telemetry_dir=tl)
    arm = {"from": "8", "to": "4x2", "reshard": reshard_arm(torch, src,
                                                           "4x2")}
    torch.cuda.empty_cache()
    resumed = run_path(torch, conf, "reshard_folded", per_tick(16, **folded),
                       out_dir, ticks=16, checkpoint_every=16,
                       checkpoint_dir=src, resume=True, telemetry_dir=tl,
                       mesh_shape="4x2")
    torch.cuda.empty_cache()
    twin_tl = os.path.join(root, "twin_tl")
    shutil.rmtree(twin_tl, ignore_errors=True)
    twin_info = run_path(torch, conf, "reshard_folded_twin",
                         per_tick(64, **folded), out_dir,
                         checkpoint_every=16, telemetry_dir=twin_tl,
                         mesh_shape="4x2")
    same_detection("reshard_folded", resumed, twin_info, "its 4x2 twin")
    same_series("reshard_folded", "reshard_folded_twin")
    if (_read(os.path.join(tl, "summary.json"))
            != _read(os.path.join(twin_tl, "summary.json"))):
        raise AssertionError("reshard_folded: summary.json differs from "
                             "the 4x2 twin's")
    arm.update(ticks_per_s=resumed["ticks_per_s"],
               twin_ticks_per_s=twin_info["ticks_per_s"],
               launches={k: v for k, v in resumed["launches"].items() if v},
               peak_mem_gib=resumed["peak_mem_gib"])
    info["scale_in_folded"] = arm
    torch.cuda.empty_cache()

    # Scale out, natural S=128 (K1, K4, K3).  A run on D shards draws
    # from per-shard streams, so one resumed at D=8 from a D=1 boundary
    # is its own run: at 2^20 it is held to its launches and detections
    # (its speed against the killed D=1 run's), and at 2^14 the card's
    # resume to the CPU's resume of the same resharded checkpoint.
    natural = dict(receive=1, gossip_stacked=1, probe=1)
    base = os.path.join(confs, "ring_1m_s128_sharded.conf")
    for tag, n in (("natural", None), ("natural_16k", 1 << 14)):
        keys = dict(TOTAL_TIME=64, FAIL_TIME=24)
        if n:
            keys["MAX_NNB"] = n
        conf = conf_variant(base, out_dir, f"reshard_{tag}", **keys)
        src = os.path.join(out_dir, f"reshard_{tag}_ck")
        shutil.rmtree(src, ignore_errors=True)
        killed_s = run_killed(torch, conf, f"reshard_{tag}_killed",
                              per_tick(48, **natural), out_dir, 40,
                              checkpoint_every=16, checkpoint_dir=src)
        if ck.manifest_tick(src) != 48:
            raise AssertionError(f"reshard_{tag}: manifest at "
                                 f"{ck.manifest_tick(src)}, not 48")
        torch.cuda.empty_cache()
        arm = {"from": "1", "to": "8", "killed_ticks_per_s": 48 / killed_s,
               "reshard": reshard_arm(torch, src, "8")}
        torch.cuda.empty_cache()
        if n:
            cpu_src = src + "_cpu"
            shutil.rmtree(cpu_src, ignore_errors=True)
            shutil.copytree(src, cpu_src)
        resumed = run_path(torch, conf, f"reshard_{tag}",
                           per_tick(16, **natural), out_dir, ticks=16,
                           digest=True, checkpoint_every=16,
                           checkpoint_dir=src, resume=True, mesh_shape="8")
        det = resumed["detection"]
        if det["false_removals"] != 0 or det.get("detections_total",
                                                  0) <= 0:
            raise AssertionError(f"reshard_{tag}: detection summary {det}")
        if ck.load_manifest(src)["state_hash"] != resumed["state_hash"]:
            raise AssertionError(f"reshard_{tag}: the tick-64 snapshot is "
                                 "not the final state")
        torch.cuda.empty_cache()
        arm.update(ticks_per_s=resumed["ticks_per_s"],
                   launches={k: v for k, v in resumed["launches"].items()
                             if v},
                   peak_mem_gib=resumed["peak_mem_gib"])
        if n:
            from distributed_membership_tpu_torch.convert import (
                carry_leaves)
            from distributed_membership_tpu_torch.runtime.application import (
                run_conf)
            t0 = time.perf_counter()
            cpu = run_conf(conf, out_dir=os.path.join(out_dir,
                                                      f"reshard_{tag}_cpu"),
                           device="cpu", checkpoint_every=16,
                           checkpoint_dir=cpu_src, resume=True,
                           mesh_shape="8")
            arm["cpu_resume_s"] = time.perf_counter() - t0
            cpu_det = {k: v for k, v in
                       cpu.extra["detection_summary"].items()
                       if k != "latency_hist_nonzero"}
            if (cpu_det != det or ck.state_hash(carry_leaves(
                    cpu.extra["final_state"])) != resumed["state_hash"]):
                raise AssertionError(f"reshard_{tag}: the card's resume "
                                     "differs from the CPU's")
            shutil.rmtree(cpu_src, ignore_errors=True)
        info[f"scale_out_{tag}"] = arm
        shutil.rmtree(src, ignore_errors=True)
    log("reshard: folded 8 -> 4x2 resumed == its 4x2 twin (summary, "
        "detection, series); natural 1 -> 8 resumed on the card == on the "
        "CPU at 2^14 (detection, final state); " + json.dumps(info))
    return info


FLEET_CONF = "FLEET_MAX_CONCURRENCY: 2\nFLEET_MIGRATE_ON: death\n"


def fleet_rows(root: str, run_id: str) -> list:
    from distributed_membership_tpu_torch.fleet.registry import (
        JOURNAL_NAME, FleetJournal)
    return [r for r in FleetJournal(os.path.join(root, JOURNAL_NAME)).read()
            if r.get("run_id") == run_id and r.get("kind") == "state"]


def holds_card(pid: int) -> bool:
    """Does process ``pid`` hold the card's device files open?"""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                return True
        except OSError:
            continue
    return False


def compute_apps() -> list:
    """``nvidia-smi --query-compute-apps=pid,used_memory`` rows."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def phase_fleet(torch, confs: str, out_dir: str, card: str) -> dict:
    """The fleet controller as a subprocess (``--fleet``, workers on the
    card, FLEET_MAX_CONCURRENCY 2, FLEET_MIGRATE_ON death): a 1M served
    run SIGKILLed after its first durable boundary (migrated, trigger
    death) and an eight-shard run at N=2^14 queried through the fleet's
    proxy and drained over POST .../migrate (trigger manual); each
    finishes with the logs of the in-process card run of its conf."""
    import shutil
    import signal

    from distributed_membership_tpu_torch.observability import metricsbus
    from distributed_membership_tpu_torch.runtime import checkpoint as ck
    from distributed_membership_tpu_torch.runtime.application import run_conf

    t_phase = time.perf_counter()
    root = os.path.join(out_dir, "fleet")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    conf_1m = os.path.join(confs, "ring_1m_s128_serve.conf")
    conf_s8 = os.path.join(confs, "ring_16k_s128_sharded8_serve.conf")
    event = {"kind": "crash", "time": 40, "nodes": [3]}
    # The in-process card runs the fleet's runs must equal: the serve
    # phase's batch run and serve_sharded's live run (a partial run makes
    # them now: the batch run, and the union-scenario run on the card).
    ref_1m = os.path.join(out_dir, "serve_batch")
    if "serve_batch" not in PATH_INFO:
        t = conf_ticks(conf_1m)
        run_path(torch, conf_1m, "serve_batch", launches_expected(
            receive=t, gossip=t, probe=t), out_dir)
    batch_det = json.loads(json.dumps(PATH_INFO["serve_batch"]["detection"]))
    ref_s8 = os.path.join(out_dir, "serve_sharded", "live")
    if not os.path.exists(os.path.join(ref_s8, "dbg.log")):
        union = os.path.join(out_dir, "fleet_union.json")
        with open(union, "w") as fh:
            json.dump({"name": "union", "events": [event]}, fh)
        ref_s8 = os.path.join(out_dir, "fleet_s8_twin")
        run_conf(conf_variant(conf_s8, out_dir, "fleet_s8_twin",
                              SERVICE_PORT=-1), out_dir=ref_s8,
                 device="cuda", scenario=union)
    torch.cuda.empty_cache()
    fconf = os.path.join(root, "fleet.conf")
    with open(fconf, "w") as fh:
        fh.write(FLEET_CONF)
    logf = open(os.path.join(root, "controller.log"), "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_membership_tpu_torch", fconf,
         "--fleet", "--out-dir", root], cwd=REPO, stdout=logf,
        stderr=subprocess.STDOUT)
    logf.close()
    info = {"card": card}
    on_card, apps, smi_at = {}, [], [0.0]

    def sample():
        """Which running workers hold the card's device files; every
        second, nvidia-smi's compute apps (kept when their count grows).
        nvidia-smi may name processes by another pid namespace's ids, so
        the check is the worker's own open /dev/nvidia* files."""
        for rid, row in runs().items():
            pid = row.get("pid")
            if pid and row["state"] == "running" and holds_card(pid):
                on_card.setdefault(rid, set()).add(pid)
        if time.monotonic() - smi_at[0] > 1.0:
            smi_at[0] = time.monotonic()
            rows = compute_apps()
            if len(rows) > len(apps[-1] if apps else []):
                apps.append(rows)

    def runs():
        code, doc = http_json(port, "/v1/runs")
        return {r["run_id"]: r for r in doc["runs"]}

    def wait(pred, what, timeout=600, every=0.1):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise AssertionError(f"fleet: the controller exited "
                                     f"{proc.returncode}")
            got = pred()
            if got:
                return got
            sample()
            time.sleep(every)
        raise TimeoutError(f"fleet: {what} never happened: {runs()}")

    try:
        port = None
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            try:
                doc = json.load(open(os.path.join(root, "fleet.json")))
                if doc.get("pid") == proc.pid:
                    port = int(doc["port"])
            except (OSError, ValueError, KeyError):
                time.sleep(0.05)
        if port is None:
            raise AssertionError("fleet: no fleet.json from the controller")
        apps.append(compute_apps())          # before any worker
        for rid, conf, extra in (
                ("r1m", conf_1m, {}),
                ("s8", conf_s8, {"scenario": {"name": "union",
                                              "events": [event]}})):
            code, ack = http_json(port, "/v1/runs", "POST", dict(
                conf=open(conf).read(), run_id=rid, **extra))
            if code != 202 or ack["mode"] != "serve":
                raise AssertionError(f"fleet: submit {rid}: {code} {ack}")
        # The eight-shard run: its answers through the fleet equal the
        # worker's own while it runs, then it is drained at a boundary.
        wport = wait(lambda: read_service_port(root, "s8", runs()),
                     "s8's service port", every=0.02)
        wait(lambda: all(http_get(wport, p)[0] == 200
                         for p in ("/v1/census", "/v1/timeline")),
             "s8's first snapshot and timeline rows", every=0.01)
        compared = {}
        for path in ("/v1/census", "/v1/member/3", "/v1/timeline",
                     "/v1/nonexistent"):
            for _ in range(200):
                d1 = http_get(wport, path)
                got = http_get(port, "/v1/runs/s8" + path)
                if d1 == http_get(wport, path):
                    if got != d1:
                        raise AssertionError(f"fleet: {path} through the "
                                             f"fleet {got} != direct {d1}")
                    compared[path] = d1[0]
                    break
        if compared != {"/v1/census": 200, "/v1/member/3": 200,
                        "/v1/timeline": 200, "/v1/nonexistent": 404}:
            raise AssertionError(f"fleet: proxy comparisons {compared}")
        ck_s8 = os.path.join(root, "s8", "ck")
        wait(lambda: (ck.manifest_tick(ck_s8) or 0) >= 30,
             "s8's boundary 30", every=0.001)
        code, reply = http_json(port, "/v1/runs/s8/migrate", "POST", {})
        if code != 202:
            raise AssertionError(f"fleet: migrate s8: {code} {reply}")
        # The 1M run: SIGKILL its worker after its first durable boundary.
        ck_1m = os.path.join(root, "r1m", "ck")
        wait(lambda: (ck.manifest_tick(ck_1m) or 0) >= 10,
             "r1m's boundary 10", every=0.01)
        pid = runs()["r1m"]["pid"]
        sample()
        os.kill(pid, signal.SIGKILL)
        t_kill = time.time()
        wait(lambda: runs()["r1m"].get("pid") not in (None, pid),
             "r1m's relaunch", every=0.05)
        t_relaunch = time.time()
        wait(lambda: runs()["r1m"].get("port"), "r1m's relaunched port")
        code, text = http_get(port, "/metrics")
        union = metricsbus.parse_text(text.decode())
        wait(lambda: all(r["state"] == "done" for r in runs().values()),
             "both runs done", timeout=900, every=0.5)
        listing = runs()
    finally:
        try:
            http_get(port, "/v1/admin/shutdown", "POST", {})
        except (OSError, TypeError):
            pass
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    rows = {rid: fleet_rows(root, rid) for rid in ("r1m", "s8")}
    trans = {rid: [(r["state"], r.get("trigger")) for r in rs]
             for rid, rs in rows.items()}
    for rid, trigger in (("r1m", "death"), ("s8", "manual")):
        for st in ("migrating", "requeued"):
            if (st, trigger) not in trans[rid]:
                raise AssertionError(f"fleet: {rid} journaled {trans[rid]}")
    req = next(r for r in rows["r1m"] if r["state"] == "requeued")
    relaunch = next(r for r in rows["r1m"] if r["state"] == "running"
                    and r["ts"] > req["ts"])
    if sorted(on_card) != ["r1m", "s8"]:
        raise AssertionError(f"fleet: workers seen on the card: {on_card}")
    for rid, ref in (("r1m", ref_1m), ("s8", ref_s8)):
        names = ("dbg.log", "stats.log") + (("msgcount.log",)
                                            if rid == "s8" else ())
        for name in names:
            if (_read(os.path.join(root, rid, name))
                    != _read(os.path.join(ref, name))):
                raise AssertionError(f"fleet: {rid}/{name} differs from "
                                     f"the card run in {ref}")
    det = json.load(open(os.path.join(root, "r1m", "summary.json")))
    det.pop("latency_hist_nonzero", None)
    if det != batch_det:
        raise AssertionError(f"fleet: r1m summary {det} != {batch_det}")
    info.update({
        "wall_s": time.perf_counter() - t_phase,
        "sigkill_to_relaunch_s": t_relaunch - t_kill,
        "journal_kill_to_relaunch_s": relaunch["ts"] - t_kill,
        "downtime_ticks": req["from_tick"] - req["resume_tick"],
        "from_tick": req["from_tick"], "resume_tick": req["resume_tick"],
        "s8_resume_tick": next(r for r in rows["s8"]
                               if r["state"] == "requeued")["resume_tick"],
        "proxy_compared": compared,
        "workers_on_card": {k: sorted(v) for k, v in on_card.items()},
        "compute_apps": apps,
        "metrics_union": {f"{n}{dict(lb)}": v for (n, lb), v in
                          sorted(union.items())
                          if n.startswith(("dm_fleet_", "dm_engine_tick",
                                           "dm_tick_rate"))},
        "metrics_samples": len(union),
        "runs": {rid: {k: r.get(k) for k in ("state", "tick", "migrations",
                                              "last_trigger")}
                 for rid, r in listing.items()}})
    log("fleet: r1m migrated (death) and s8 drained (manual), each equal "
        "to its card run; " + json.dumps(info))
    return info


def read_service_port(root: str, run_id: str, listing: dict):
    """The worker's own port, from its service.json (pid-checked), once
    it runs."""
    row = listing.get(run_id, {})
    if row.get("state") != "running" or not row.get("pid"):
        return None
    try:
        doc = json.load(open(os.path.join(root, run_id, "service.json")))
    except (OSError, ValueError):
        return None
    return int(doc["port"]) if doc.get("pid") == row["pid"] else None


# Phases sweep and chaos (items 10e-10f): geometries and cuts.
SWEEP_QUICK = dict(n=1024, fanouts=(2, 5), drop_rates=(0.0, 0.2),
                   seeds=(0,))
CHAOS_N = 65536
CHAOS_SPEC = dict(seed=0, schedules=8, n=CHAOS_N, total=160, tfail=8,
                  tremove=20)
# The default mix at 6 events pairs its one crash with a restart, and a
# permanent crash or leave is one id wide: this mix leaves 12 permanent
# ids (8 crashes, 4 leaves) per schedule, so its runs take AggStats.
CHAOS_AGG = dict(CHAOS_SPEC, schedules=2, events=16, name="agg",
                 mix={"crash": 2.0, "leave": 1.0, "delay_window": 1.0})
CHAOS_MIGRATE = dict(seed=9, n=CHAOS_N, events=3, total=160, schedules=1,
                     name="migrate", mix={"crash": 1.0, "one_way_flake": 1.0,
                                          "migrate": 1.0})
CHAOS_BROKEN = (dict(seed=4, schedules=2, events=4, n=256, name="broken",
                     mix={"link_flake": 1.0, "drop_window": 1.0}),
                {"DROP_MSG": 1, "MSG_DROP_PROB": 0.6})


def folded_launches(ticks: int) -> dict:
    """K5, K6 and K7 once per tick, no other kernel."""
    return launches_expected(receive_folded=ticks, gossip_folded=ticks,
                             probe_folded=ticks)


def phase_sweep(torch, out_dir: str, card: str) -> dict:
    """The north-star phase sweep (SweepSpec.north_star: N=65536, S=16,
    ten cells of 160 ticks) on the card, through the folded layout's
    AggStats route, then the quick grid's records card == CPU."""
    from distributed_membership_tpu_torch import kernels
    from distributed_membership_tpu_torch.sweeps.phase import (
        SweepSpec, run_sweep, summarize)

    spec = SweepSpec.north_star()

    def cell(rec, secs):
        log(f"sweep[cell]: {json.dumps(rec)} ms_per_tick="
            f"{secs / spec.ticks * 1e3}")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    records = run_sweep(spec, device="cuda", progress=cell)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    ticks = len(records) * spec.ticks
    if launches != folded_launches(ticks):
        raise AssertionError(f"sweep: launches {launches} != K5-K7 x "
                             f"{ticks}")
    for r in records:
        if r["drop_rate"] == 0.0 and (r["observer_completeness"] != 1.0
                                      or r["false_removals"] != 0):
            raise AssertionError(f"sweep: drop-free cell {r}")
    rows = summarize(records)
    info = {"cells": len(records), "ticks": ticks, "n": spec.n,
            "wall_s": wall, "ms_per_tick": wall / ticks * 1e3,
            "node_ticks_per_s": spec.n * ticks / wall, "launches": launches,
            "rows": rows, "card": card}
    log("sweep[north_star]: " + json.dumps(info))
    quick = SweepSpec(**SWEEP_QUICK, **DEPTH_CUTS["sweep_quick"])
    t0 = time.perf_counter()
    got = run_sweep(quick, device="cuda")
    t_card = time.perf_counter() - t0
    want = run_sweep(quick, device="cpu")
    if got != want:
        raise AssertionError(f"sweep quick grid: card {got} != cpu {want}")
    log(f"sweep[quick]: N={quick.n} S={quick.view_size}, {len(got)} "
        f"cells card == CPU; card {t_card:.2f}s, CPU "
        f"{time.perf_counter() - t0 - t_card:.2f}s")
    return info


def phase_chaos(torch, out_dir: str, card: str) -> dict:
    """Chaos campaigns on the card: the green N=65536 campaign (default
    mix), a permanent-crash campaign on the AggStats route, a migrating
    schedule, an N=256 campaign card == CPU, and the broken config's
    shrunk repro banked and replayed on the card."""
    import shutil

    from distributed_membership_tpu_torch import kernels
    from distributed_membership_tpu_torch.backends import tpu_hash
    from distributed_membership_tpu_torch.chaos import (
        CampaignSpec, read_journal, run_campaign)
    from distributed_membership_tpu_torch.chaos import campaign as cmp
    from distributed_membership_tpu_torch.config import Params
    from distributed_membership_tpu_torch.runtime.checkpoint import (
        load_manifest)
    from distributed_membership_tpu_torch.runtime.failures import (
        resolve_plan)
    from distributed_membership_tpu_torch.sweeps.fleet_submit import (
        override_conf)

    root = os.path.join(out_dir, "chaos")
    shutil.rmtree(root, ignore_errors=True)

    def campaign(name, spec_kw, expect_ok=True, device="cuda", **kw):
        spec = CampaignSpec(**spec_kw)
        out = os.path.join(root, f"{name}_{device}")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        summary = run_campaign(spec, out, device=device, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows = read_journal(os.path.join(out, "campaign.jsonl"))
        graded = [r for r in rows if r["kind"] == "graded"]
        info = {"runs": summary["runs"], "ok": summary["ok"],
                "graded": len(graded), "wall_s": wall,
                "ms_per_run_tick": wall / spec.schedules / spec.total * 1e3,
                "launches": dict(kernels.LAUNCHES),
                "violations": summary["violations"],
                "repros": [os.path.basename(p) for p in summary["repros"]]}
        log(f"chaos[{name}/{device}]: " + json.dumps(info))
        if summary["ok"] != expect_ok or len(graded) != spec.schedules:
            raise AssertionError(f"chaos {name}: {summary}")
        return spec, out, summary, info

    def route(spec, out, index):
        """The layout and event path make_config gives the card for
        schedule ``index``'s run."""
        sch = os.path.join(out, "scenarios",
                           f"{spec.name}-{spec.seed}-{index:04d}.json")
        params = Params.from_text(override_conf(cmp.base_conf(spec),
                                                "SCENARIO", sch))
        plan = resolve_plan(params, random.Random("route"))
        cfg = tpu_hash.make_config(
            params, False, fail_ids=tpu_hash.plan_fail_ids(plan),
            device="cuda", scenario=tpu_hash.plan_scenario(plan))
        return cfg, len(plan.failed_indices)

    # The green campaign: default mix, K5-K7 once per tick of every run.
    spec, out, _, green = campaign("green", CHAOS_SPEC)
    if green["launches"] != folded_launches(spec.schedules * spec.total):
        raise AssertionError(f"chaos green: launches {green['launches']}")
    # AggStats: more than 8 permanent ids on the folded layout.
    spec, out, _, agg = campaign("agg", CHAOS_AGG)
    if agg["launches"] != folded_launches(spec.schedules * spec.total):
        raise AssertionError(f"chaos agg: launches {agg['launches']}")
    for i in range(spec.schedules):
        cfg, n_perm = route(spec, out, i)
        if not (cfg.folded and not cfg.fast_agg and n_perm > 8):
            raise AssertionError(f"chaos agg run {i}: folded={cfg.folded} "
                                 f"fast_agg={cfg.fast_agg} ids={n_perm}")
        log(f"chaos[agg]: run {spec.name}-{spec.seed}-{i:04d} took the "
            f"folded AggStats route ({n_perm} permanent ids)")
    # A migrating schedule: kill, same-geometry reshard, resume.
    _, out, _, mig = campaign("migrate", CHAOS_MIGRATE, shrink=False)
    chains = []
    for name in os.listdir(os.path.join(out, "scenarios")):
        if name.endswith(".ckpt"):
            m = load_manifest(os.path.join(out, "scenarios", name))
            chains.extend((m or {}).get("reshard", ()))
    if not chains or any(c["from_shape"] != c["to_shape"] for c in chains):
        raise AssertionError(f"chaos migrate: reshard chain {chains}")
    log(f"chaos[migrate]: {len(chains)} same-shape reshard(s), graded ok")
    # N=256: the card's journal and schedules equal the CPU's.
    small = dict(seed=1, schedules=4, n=256, name="small")
    journals = {}
    for device in ("cuda", "cpu"):
        spec, out, _, info = campaign("small", small, device=device)
        ticks = spec.schedules * spec.total if device == "cuda" else 0
        if info["launches"] != folded_launches(ticks):
            raise AssertionError(f"chaos small/{device}: launches "
                                 f"{info['launches']}")
        journals[device] = open(os.path.join(
            out, "campaign.jsonl")).read().replace(out, "OUT")
    if journals["cuda"] != journals["cpu"]:
        raise AssertionError("chaos small: journals differ card vs CPU")
    log("chaos[small]: N=256 campaign.jsonl byte-identical card vs CPU")
    # The broken config: violations shrunk and banked on the card, and
    # the banked repro still violates when replayed there.
    spec, out, summary, _ = campaign(
        "broken", dict(CHAOS_BROKEN[0], **DEPTH_CUTS["chaos_broken"]),
        expect_ok=False, overrides=CHAOS_BROKEN[1])
    if not summary["repros"]:
        raise AssertionError("chaos broken: nothing banked")
    conf = cmp.base_conf(spec, CHAOS_BROKEN[1])
    for path in summary["repros"]:
        meta = json.load(open(path))["meta"]
        report = cmp._run_inproc(conf, path, meta["seed"], "cuda")
        if not set(meta["violations"]) <= set(report["violations"]):
            raise AssertionError(f"chaos broken: {path} replays "
                                 f"{report['violations']}")
        log(f"chaos[broken]: {os.path.basename(path)} replays "
            f"{report['violations']} on the card")
    green.update(card=card)
    return green


def check_no_jax() -> int:
    """Import the port's entry points, the elastic and fleet modules
    included, and check that nothing of JAX or the JAX package came with
    them; -> the count of the port's modules loaded."""
    import importlib
    for name in ("runtime.application", "elastic.reshard", "elastic.migrate",
                 "fleet.placement", "fleet.registry", "fleet.scheduler",
                 "fleet.daemon", "sweeps.fleet_submit", "service.daemon",
                 "sweeps.phase", "chaos.campaign"):
        importlib.import_module("distributed_membership_tpu_torch." + name)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "distributed_membership_tpu")]
    if bad:
        raise AssertionError(f"the port imported {bad}")
    return len([m for m in sys.modules
                if m.startswith("distributed_membership_tpu_torch")])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=os.path.join(REPO, "smoke_out"),
                    help="directory for run outputs (default smoke_out/)")
    ap.add_argument("--only", default="",
                    help="comma list of phases to run "
                         f"({','.join(PHASES + OPT_IN)}); default all but "
                         f"{','.join(OPT_IN)}")
    args = ap.parse_args(argv)
    phases = set(filter(None, args.only.split(","))) or set(PHASES)
    if not phases <= set(PHASES + OPT_IN):
        return fail(f"unknown phases "
                    f"{sorted(phases - set(PHASES + OPT_IN))}")

    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    sys.path.insert(0, REPO)
    try:
        from distributed_membership_tpu_torch import kernels
    except ImportError as e:
        return fail(f"the port's package is not importable here ({e})")
    dev = torch.device("cuda")
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    out_dir = os.path.abspath(args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    os.chdir(REPO)       # the scenario confs' SCENARIO paths start here
    t_start = time.perf_counter()

    log(f"imports: {check_no_jax()} modules of the port, elastic and "
        "fleet included; none of jax or the JAX package")
    secs = kernels.build(ptxas_report=True)
    log(f"build: {secs:.1f}s (nvcc, sm_90a, one process per source)")
    for name, text in kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas[{name}]: {line.strip()}")

    rows = {}
    if "kernels" in phases:
        t0 = time.perf_counter()
        rows = phase_kernels(torch, dev)
        torch.cuda.empty_cache()
        rows.update(phase_kernels_folded(torch, dev))
        torch.cuda.empty_cache()
        rows.update(phase_kernels_stacked(torch, dev))
        torch.cuda.empty_cache()
        rows.update(phase_kernels_wide(torch, dev))
        torch.cuda.empty_cache()
        log(f"phase kernels: {time.perf_counter() - t0:.1f}s")

    confs = os.path.join(REPO, "distributed_membership_tpu_torch", "confs")
    if "profile" in phases:
        for name in ("ring_1m_s128", "ring_1m_s128_drop",
                     "ring_1m_s16_folded", "ring_1m_s16_folded_drop",
                     "ring_1m_s128_sharded", "ring_1m_s128_sharded8_drop",
                     "ring_1m_s16_folded_sharded",
                     "ring_1m_s16_folded_sharded8_drop"):
            phase_profile(torch, os.path.join(confs, name + ".conf"), name,
                          out_dir)
            torch.cuda.empty_cache()
        # The full view at N = S = 16384: K2's and K4's wide rows.
        full = os.path.join(confs, "ring_16k_full.conf")
        for name, conf in (("ring_16k_full", full),
                           ("ring_16k_full_sharded8",
                            wide_sharded_conf(full, out_dir))):
            phase_profile(torch, conf, name, out_dir)
            torch.cuda.empty_cache()
        # The recorder's cost: the natural 1M tick with TELEMETRY hist
        # against off, back to back.
        hist = {}
        for tier in ("off", "hist", "off", "hist"):
            info = phase_profile(
                torch, os.path.join(confs, "ring_1m_s128_hist.conf"),
                f"ring_1m_s128_telemetry_{tier}", out_dir, telemetry=tier)
            hist.setdefault(tier, []).append(info["step_ms"])
            torch.cuda.empty_cache()
        # The scenario ticks inside their windows: the partition (K2's
        # masks form and the cut at every send site) against
        # ring_1m_s128, the link flakes' per-row probabilities against
        # ring_1m_s16_folded_drop.
        for name, first in (("ring_1m_s128_partition", 50),
                            ("ring_1m_s16_folded_churn", 110)):
            phase_profile(torch, os.path.join(confs, name + ".conf"), name,
                          out_dir, t0=first)
            torch.cuda.empty_cache()
        log("profile[telemetry_cost]: " + json.dumps(
            {"step_ms_off": hist["off"], "step_ms_hist": hist["hist"],
             "hist_minus_off_ms": (sum(hist["hist"]) - sum(hist["off"]))
             / 2, "card": card}))
    paths = {}

    def cut(name):
        """A 1M conf with its depth cut, and its ticks."""
        conf = smoke_conf(confs, out_dir, name)
        return conf, conf_ticks(conf)

    if "main" in phases:
        conf, t = cut("ring_1m_s128")
        paths["main"] = run_path(
            torch, conf, "main",
            launches_expected(receive=t, gossip=t, probe=t), out_dir)
        det = paths["main"]["detection"]
        if det["false_removals"] != 0 or det.get("detections_total", 0) <= 0:
            return fail(f"main path detection summary: {det}")
        torch.cuda.empty_cache()
    if "lossy" in phases:
        paths["lossy"] = run_path(
            torch, os.path.join(confs, "ring_1m_s128_drop.conf"), "lossy",
            launches_expected(receive=64, gossip_masks=64, probe=64),
            out_dir)
        if paths["lossy"]["detection"].get("detections_total", 0) <= 0:
            return fail("lossy path: no detection")
        torch.cuda.empty_cache()
    if "parity" in phases:
        from distributed_membership_tpu_torch.runtime.application import (
            run_conf)
        conf = os.path.join(confs, "ring_256_s128_drop.conf")
        for d in ("cuda", "cpu"):
            run_conf(conf, out_dir=os.path.join(out_dir, f"parity_{d}"),
                     device=d)
        for f in LOGS:
            a, b = (open(os.path.join(out_dir, f"parity_{d}", f),
                         "rb").read()
                    for d in ("cuda", "cpu"))
            if a != b:
                return fail(f"parity: {f} differs between cuda and cpu")
            if f == "dbg.log" and b" removed " not in a:
                return fail("parity: dbg.log holds no removal")
        log("parity: N=256 full-event logs byte-identical, cuda vs cpu")
    if "folded" in phases:
        paths["folded"] = run_path(
            torch, os.path.join(confs, "ring_1m_s16_folded.conf"), "folded",
            launches_expected(receive_folded=160, gossip_folded=160,
                              probe_folded=160), out_dir)
        det = paths["folded"]["detection"]
        if det["false_removals"] != 0 or det.get("detections_total", 0) <= 0:
            return fail(f"folded path detection summary: {det}")
        torch.cuda.empty_cache()
    if "folded_lossy" in phases:
        paths["folded_lossy"] = run_path(
            torch, os.path.join(confs, "ring_1m_s16_folded_drop.conf"),
            "folded_lossy", launches_expected(
                receive_folded=64, gossip_folded=64, probe_folded=64),
            out_dir)
        if paths["folded_lossy"]["detection"].get("detections_total", 0) <= 0:
            return fail("folded_lossy path: no detection")
        torch.cuda.empty_cache()
    if "folded_parity" in phases:
        state_parity(torch, smoke_conf(confs, out_dir,
                                       "ring_16k_s16_folded_drop"),
                     "folded_parity", out_dir, card)
    if "sharded" in phases:
        conf, t = cut("ring_1m_s128_sharded")
        paths["sharded"] = run_path(
            torch, conf, "sharded", launches_expected(
                receive=t, gossip_stacked=t, probe=t), out_dir)
        det = paths["sharded"]["detection"]
        if det["false_removals"] != 0 or det.get("detections_total", 0) <= 0:
            return fail(f"sharded path detection summary: {det}")
        torch.cuda.empty_cache()
    if "sharded_lossy" in phases:
        paths["sharded_lossy"] = run_path(
            torch, os.path.join(confs, "ring_1m_s128_sharded8_drop.conf"),
            "sharded_lossy", launches_expected(
                receive=64, gossip_stacked=64, probe=64), out_dir)
        if paths["sharded_lossy"]["detection"].get("detections_total",
                                                   0) <= 0:
            return fail("sharded_lossy path: no detection")
        torch.cuda.empty_cache()
    if "sharded_parity" in phases:
        from distributed_membership_tpu_torch.runtime.application import (
            run_conf)
        conf = os.path.join(confs, "ring_256_s128_sharded8_drop.conf")
        for d in ("cuda", "cpu"):
            run_conf(conf, out_dir=os.path.join(out_dir,
                                                f"sharded_parity_{d}"),
                     device=d)
        for f in ("dbg.log", "stats.log", "msgcount.log"):
            a, b = (open(os.path.join(out_dir, f"sharded_parity_{d}", f),
                         "rb").read()
                    for d in ("cuda", "cpu"))
            if a != b:
                return fail(f"sharded_parity: {f} differs between cuda and "
                            "cpu")
            if f == "dbg.log" and b" removed " not in a:
                return fail("sharded_parity: dbg.log holds no removal")
        log("sharded_parity: N=256 eight-shard full-event logs "
            "byte-identical, cuda vs cpu")
    if "grade" in phases:
        t0 = time.perf_counter()
        paths["grade"] = phase_grade(torch, out_dir, card)
        log(f"phase grade: {time.perf_counter() - t0:.1f}s; card: {card}")
    if "scatter_parity" in phases:
        t0 = time.perf_counter()
        paths["scatter_parity"] = card_vs_cpu(
            torch, smoke_conf(confs, out_dir, "scatter_2k_s128_drop"),
            "scatter_parity", launches_expected(), out_dir, card)
        log(f"phase scatter_parity: {time.perf_counter() - t0:.1f}s; "
            f"card: {card}")
    if "cold_parity" in phases:
        t0 = time.perf_counter()
        conf, t = cut("ring_256_s128_staggered_drop")
        paths["cold_parity"] = card_vs_cpu(
            torch, conf, "cold_parity", launches_expected(
                receive=t, gossip_masks=t, probe=t), out_dir, card)
        conf, t = cut("ring_256_s128_staggered_sharded8_drop")
        paths["cold_parity_sharded"] = card_vs_cpu(
            torch, conf, "cold_parity_sharded", launches_expected(
                receive=t, gossip_stacked=t, probe=t), out_dir, card)
        log(f"phase cold_parity: {time.perf_counter() - t0:.1f}s; "
            f"card: {card}")
    if "sharded_folded" in phases:
        paths["sharded_folded"] = run_path(
            torch, os.path.join(confs, "ring_1m_s16_folded_sharded.conf"),
            "sharded_folded", launches_expected(
                receive_folded=160, gossip_folded=160, probe_folded=160),
            out_dir)
        det = paths["sharded_folded"]["detection"]
        if det["false_removals"] != 0 or det.get("detections_total", 0) <= 0:
            return fail(f"sharded_folded path detection summary: {det}")
        torch.cuda.empty_cache()
    if "sharded_folded_lossy" in phases:
        paths["sharded_folded_lossy"] = run_path(
            torch, os.path.join(confs,
                                "ring_1m_s16_folded_sharded8_drop.conf"),
            "sharded_folded_lossy", launches_expected(
                receive_folded=64, gossip_folded=64, probe_folded_hist=64),
            out_dir)
        if paths["sharded_folded_lossy"]["detection"].get(
                "detections_total", 0) <= 0:
            return fail("sharded_folded_lossy path: no detection")
        torch.cuda.empty_cache()
    if "sharded_folded_parity" in phases:
        state_parity(torch, smoke_conf(
            confs, out_dir, "ring_16k_s16_folded_sharded8_drop"),
            "sharded_folded_parity", out_dir, card)
    if "telemetry" in phases:
        t0 = time.perf_counter()
        conf, t = cut("ring_1m_s128_hist")
        paths["telemetry"] = run_path(
            torch, conf, "telemetry",
            launches_expected(receive=t, gossip=t, probe_hist=t), out_dir)
        det = paths["telemetry"]["detection"]
        if det["false_removals"] != 0 or det.get("detections_total", 0) <= 0:
            return fail(f"telemetry path detection summary: {det}")
        torch.cuda.empty_cache()
        telemetry_parity(torch, os.path.join(confs, "ring_256_s128_drop.conf"),
                         out_dir, card)
        log(f"phase telemetry: {time.perf_counter() - t0:.1f}s; card: {card}")
    if "scenario" in phases:
        conf, t = cut("ring_1m_s128_partition")
        paths["scenario"] = run_path(
            torch, conf, "scenario", launches_expected(
                receive=t, gossip_masks=t, probe=t), out_dir)
        sc = paths["scenario"]["scenario"]
        part = sc["partitions"][0] if sc["partitions"] else {}
        if sc["basis"] != "telemetry" or part.get("removals_during", 0) <= 0:
            return fail(f"scenario: oracle report {sc}")
        log("scenario: partition " + json.dumps(
            {k: part.get(k) for k in ("removals_during", "refill_joins",
                                      "unhealed_removals",
                                      "reconverged_tick")})
            + " invariants " + json.dumps(sc["invariants"])
            + f"; card: {card}")
        torch.cuda.empty_cache()
    if "scenario_folded" in phases:
        paths["scenario_folded"] = run_path(
            torch, os.path.join(confs, "ring_1m_s16_folded_churn.conf"),
            "scenario_folded", launches_expected(
                receive_folded=160, gossip_folded=160, probe_folded=160),
            out_dir)
        info = paths["scenario_folded"]
        sc = info["scenario"]
        if (info["detection"].get("detections_total", 0) <= 0
                or [r.get("rejoined") for r in sc["restarts"]] != [True]):
            return fail(f"scenario_folded: {info['detection']} {sc}")
        log("scenario_folded: restarts " + json.dumps(sc["restarts"])
            + " crashes " + json.dumps(sc["crashes"]) + " invariants "
            + json.dumps(sc["invariants"]) + f"; card: {card}")
        torch.cuda.empty_cache()
    if "scenario_sharded" in phases:
        paths["scenario_sharded"] = run_path(
            torch, os.path.join(confs, "ring_1m_s128_sharded8_partition.conf"),
            "scenario_sharded", launches_expected(
                receive=64, gossip_stacked=64, probe=64), out_dir)
        sc = paths["scenario_sharded"]["scenario"]
        if not sc["partitions"] or sc["partitions"][0].get(
                "removals_during", 0) <= 0:
            return fail(f"scenario_sharded: oracle report {sc}")
        log("scenario_sharded: partition " + json.dumps(sc["partitions"])
            + " invariants " + json.dumps(sc["invariants"])
            + f"; card: {card}")
        torch.cuda.empty_cache()
    if "scenario_parity" in phases:
        t0 = time.perf_counter()
        paths["scenario_parity"] = card_vs_cpu(
            torch, os.path.join(confs, "ring_256_s128_scenario.conf"),
            "scenario_parity", launches_expected(
                receive=80, gossip_masks=80, probe=80), out_dir, card)
        state_parity(torch, os.path.join(
            confs, "ring_16k_s16_folded_sharded8_scenario.conf"),
            "scenario_parity_sharded_folded", out_dir, card)
        log(f"phase scenario_parity: {time.perf_counter() - t0:.1f}s; "
            f"card: {card}")
    if "checkpoint" in phases:
        t0 = time.perf_counter()
        paths["checkpoint"] = phase_checkpoint(torch, confs, paths, out_dir,
                                               card)
        torch.cuda.empty_cache()
        log(f"phase checkpoint: {time.perf_counter() - t0:.1f}s")
    if "checkpoint_sharded_folded" in phases:
        t0 = time.perf_counter()
        paths["checkpoint_sharded_folded"] = phase_checkpoint_sharded_folded(
            torch, confs, paths, out_dir, card)
        torch.cuda.empty_cache()
        log(f"phase checkpoint_sharded_folded: "
            f"{time.perf_counter() - t0:.1f}s")
    if "mega" in phases:
        per_tick = launches_expected(receive_folded=160, gossip_folded=160,
                                     probe_folded=160)
        folded = twin(torch, paths, "folded",
                      os.path.join(confs, "ring_1m_s16_folded.conf"),
                      per_tick, out_dir)
        paths["mega"] = run_path(
            torch, os.path.join(confs, "ring_1m_s16_folded_mega.conf"),
            "mega", per_tick, out_dir, carry=True)
        same_detection("mega", paths["mega"], folded, "folded")
        log("mega: MEGA_TICKS 8, MEGA_PACK 1 == folded; " + json.dumps(
            {"ms_per_tick": 1e3 / paths["mega"]["ticks_per_s"],
             "folded_ms_per_tick": 1e3 / folded["ticks_per_s"],
             "carry_bytes": paths["mega"]["carry_bytes"],
             "block_boundaries": 160 // 8, "card": card}))
        torch.cuda.empty_cache()
    if "hoisted" in phases:
        conf, t = cut("ring_1m_s128")
        per_tick = launches_expected(receive=t, gossip=t, probe=t)
        main_info = twin(torch, paths, "main", conf, per_tick, out_dir)
        conf, t = cut("ring_1m_s128_hoisted")
        paths["hoisted"] = run_path(torch, conf, "hoisted", per_tick,
                                    out_dir)
        same_detection("hoisted", paths["hoisted"], main_info, "main")
        log("hoisted: RNG_MODE hoisted (8-tick segments) == main; "
            + json.dumps({
                "ms_per_tick": 1e3 / paths["hoisted"]["ticks_per_s"],
                "main_ms_per_tick": 1e3 / main_info["ticks_per_s"],
                "launches_per_tick": {
                    k: v / t for k, v in
                    paths["hoisted"]["launches"].items() if v},
                "peak_mem_gib": paths["hoisted"]["peak_mem_gib"],
                "main_peak_mem_gib": main_info["peak_mem_gib"],
                "card": card}))
        torch.cuda.empty_cache()
    if "checkpoint_parity" in phases:
        t0 = time.perf_counter()
        paths["checkpoint_parity"] = checkpoint_parity(
            torch, os.path.join(confs, "ring_256_s128_drop.conf"),
            "checkpoint_parity", 20, 70, ("receive", "gossip_masks", "probe"),
            out_dir)
        paths["checkpoint_parity_scenario"] = checkpoint_parity(
            torch, os.path.join(confs, "ring_256_s128_scenario.conf"),
            "checkpoint_parity_scenario", 20, 50,
            ("receive", "gossip_masks", "probe"), out_dir)
        log(f"phase checkpoint_parity: {time.perf_counter() - t0:.1f}s; "
            f"card: {card}")
    main_conf = os.path.join(confs, "ring_1m_s128.conf")
    drop256 = os.path.join(confs, "ring_256_s128_drop.conf")
    t256 = conf_ticks(drop256)
    lossy256 = launches_expected(receive=t256, gossip_masks=t256,
                                 probe=t256)
    if "legacy" in phases:
        t0 = time.perf_counter()
        phase_legacy(torch, paths, main_conf, drop256, lossy256, out_dir,
                     card)
        log(f"phase legacy: {time.perf_counter() - t0:.1f}s; card: {card}")
    if "multi" in phases:
        t0 = time.perf_counter()
        paths["multi"] = run_path(
            torch, os.path.join(confs, "ring_1m_s128_multi.conf"), "multi",
            launches_expected(receive=64, gossip=64, probe=64), out_dir)
        det = paths["multi"]["detection"]
        if (det["false_removals"] != 0 or det.get("detections_total", 0) <= 0
                or det.get("failed_nodes") != N // 2):
            return fail(f"multi path detection summary: {det}")
        torch.cuda.empty_cache()
        paths["multi_sharded"] = run_path(
            torch, os.path.join(confs, "ring_16k_s128_sharded8_multi.conf"),
            "multi_sharded", launches_expected(
                receive=80, gossip_stacked=80, probe=80), out_dir)
        if paths["multi_sharded"]["detection"].get("detections_total",
                                                   0) <= 0:
            return fail("multi_sharded: no detection")
        state_parity(torch, conf_variant(
            os.path.join(confs, "ring_1m_s128_multi.conf"), out_dir,
            "multi_2k", MAX_NNB=2048), "multi_parity", out_dir, card)
        log(f"phase multi: {time.perf_counter() - t0:.1f}s; card: {card}")
    if "shift_set" in phases:
        t0 = time.perf_counter()
        paths["shift_set"] = run_path(
            torch, os.path.join(confs, "ring_1m_s128_shiftset.conf"),
            "shift_set", launches_expected(receive=40, gossip=40, probe=40),
            out_dir)
        torch.cuda.empty_cache()
        paths["shift_set_folded"] = run_path(
            torch, conf_variant(os.path.join(confs, "ring_1m_s16_folded.conf"),
                                out_dir, "shift_set_folded", SHIFT_SET=16,
                                TOTAL_TIME=40, FAIL_TIME=8),
            "shift_set_folded", launches_expected(
                receive_folded=40, gossip_folded=40, probe_folded=40),
            out_dir)
        torch.cuda.empty_cache()
        paths["shift_set_parity"] = card_vs_cpu(
            torch, conf_variant(drop256, out_dir, "shift_set_256",
                                SHIFT_SET=16),
            "shift_set_parity", lossy256, out_dir, card)
        log(f"phase shift_set: {time.perf_counter() - t0:.1f}s; card: {card}")
    if "buffsize" in phases:
        t0 = time.perf_counter()
        cold, tc = cut("ring_256_s128_staggered_drop")
        budget = dict(ENFORCE_BUFFSIZE=1, EN_BUFFSIZE=30000)
        paths["buffsize_parity"] = card_vs_cpu(
            torch, conf_variant(cold, out_dir, "buffsize_256", **budget),
            "buffsize_parity", launches_expected(
                receive=tc, gossip_masks=tc, probe=tc), out_dir, card)
        t4k = DEPTH_CUTS["buffsize_4k"]
        paths["buffsize_parity_4k"] = card_vs_cpu(
            torch, conf_variant(cold, out_dir, "buffsize_4k", MAX_NNB=4096,
                                JOIN_MODE="batch", **t4k, **budget),
            "buffsize_parity_4k", launches_expected(
                receive=t4k["TOTAL_TIME"], gossip_masks=t4k["TOTAL_TIME"],
                probe=t4k["TOTAL_TIME"]), out_dir, card)
        paths["buffsize"] = run_path(
            torch, conf_variant(main_conf, out_dir, "buffsize_1m",
                                TOTAL_TIME=20, FAIL_TIME=8, **budget),
            "buffsize", launches_expected(receive=20, gossip_masks=20,
                                          probe=20), out_dir)
        torch.cuda.empty_cache()
        log(f"phase buffsize: {time.perf_counter() - t0:.1f}s; card: {card}")
    if "approx_lag" in phases:
        t0 = time.perf_counter()
        lag = DEPTH_CUTS["approx_lag_1m"]
        tl = lag["TOTAL_TIME"]
        per_run = launches_expected(receive=tl, gossip=tl, probe=tl)
        paths["approx_lag"] = run_path(
            torch, conf_variant(main_conf, out_dir, "approx_lag_1m",
                                PROBE_IO="approx_lag",
                                CHECKPOINT_EVERY=tl // 2,
                                **lag), "approx_lag", per_run, out_dir)
        torch.cuda.empty_cache()
        paths["approx_lag_exact"] = run_path(
            torch, conf_variant(main_conf, out_dir, "exact_1m",
                                PROBE_IO="exact", **lag),
            "approx_lag_exact", per_run, out_dir)
        # Same trajectory, same run totals; only the attribution flag
        # differs.
        got, want = ({k: v for k, v in paths[x]["detection"].items()
                      if k != "approx_probe_attribution"}
                     for x in ("approx_lag", "approx_lag_exact"))
        if got != want:
            return fail(f"approx_lag: summary {got} != exact's {want}")
        log("approx_lag: run totals and summary equal PROBE_IO exact's; "
            + json.dumps({k: got[k] for k in ("msgs_sent", "msgs_recv")}))
        torch.cuda.empty_cache()
        paths["probe_io_none"] = run_path(
            torch, conf_variant(main_conf, out_dir, "probe_io_none_1m",
                                PROBE_IO="none", TOTAL_TIME=20),
            "probe_io_none", launches_expected(receive=20, gossip=20,
                                               probe=20), out_dir)
        torch.cuda.empty_cache()
        paths["approx_lag_parity"] = card_vs_cpu(
            torch, conf_variant(drop256, out_dir, "approx_lag_256",
                                PROBE_IO="approx_lag"),
            "approx_lag_parity", lossy256, out_dir, card)
        log(f"phase approx_lag: {time.perf_counter() - t0:.1f}s; "
            f"card: {card}")
    if "wide" in phases:
        t0 = time.perf_counter()
        full = os.path.join(confs, "ring_16k_full.conf")
        paths["wide"] = run_path(
            torch, full, "wide", launches_expected(
                receive=80, gossip_wide=80, probe=80), out_dir)
        det = paths["wide"]["detection"]
        if det["false_removals"] != 0 or det.get("detections_total", 0) <= 0:
            return fail(f"wide path detection summary: {det}")
        torch.cuda.empty_cache()
        paths["wide_sharded"] = run_path(
            torch, wide_sharded_conf(full, out_dir), "wide_sharded",
            launches_expected(receive=40, gossip_stacked_wide=40, probe=40),
            out_dir)
        torch.cuda.empty_cache()
        # Short timeouts, so that the CPU's few ticks of 4352^2 slots see
        # detections (~3 s a tick there).
        state_parity(torch, conf_variant(
            full, out_dir, "wide_4352", MAX_NNB=4352, TFAIL=4, TREMOVE=8,
            **DEPTH_CUTS["wide_4352"]), "wide_parity", out_dir, card)
        log(f"phase wide: {time.perf_counter() - t0:.1f}s; card: {card}")
    if "folded_probes0" in phases:
        t0 = time.perf_counter()
        phase_folded_probes0(torch, confs, paths, out_dir, card)
        log(f"phase folded_probes0: {time.perf_counter() - t0:.1f}s; "
            f"card: {card}")
    for name, phase in (
            ("serve", lambda: phase_serve(torch, confs, out_dir, card)),
            ("serve_inject", lambda: phase_serve_inject(torch, confs,
                                                        out_dir, card)),
            ("serve_sharded", lambda: phase_serve_sharded(torch, confs,
                                                          out_dir, card)),
            ("serve_replicas", lambda: phase_serve_replicas(
                torch, confs, out_dir, card)),
            ("reshard", lambda: phase_reshard(torch, confs, out_dir, card)),
            ("fleet", lambda: phase_fleet(torch, confs, out_dir, card)),
            ("sweep", lambda: phase_sweep(torch, out_dir, card)),
            ("chaos", lambda: phase_chaos(torch, out_dir, card))):
        if name in phases:
            t0 = time.perf_counter()
            paths[name + "_info"] = phase()
            torch.cuda.empty_cache()
            log(f"phase {name}: {time.perf_counter() - t0:.1f}s; "
                f"card: {card}")
    log(f"total: {time.perf_counter() - t_start:.1f}s after the card check")

    if phases != set(PHASES):
        log(f"partial run ({sorted(phases)}): no result line")
        return 0
    # One entry per kernel form on a path; `launches` from the path that
    # drives it, read under the form's launch key (K6's eight-shard form
    # runs on sharded_folded_lossy and counts as gossip_folded there).
    # Forms no path runs ride their kernel's entry: K6's masks form is
    # held in phase 2 only (the folded steps mask their payloads
    # themselves), as is K4's (the sharded step masks its payloads before
    # the block hop).  K1's admit form has an entry of its own, with the
    # main path's count of it: 0, as no step passes the plane.
    out = []
    for form, path, key, src, extras in (
            ("receive", "main", "receive", "receive.cu", ()),
            ("receive_admit", "main", "receive_admit", "receive.cu", ()),
            ("gossip", "main", "gossip", "gossip.cu", ()),
            ("gossip_masks", "lossy", "gossip_masks", "gossip.cu", ()),
            ("probe", "main", "probe", "probe.cu",
             (("probe_sparse", "sparse"),)),
            ("probe_hist", "telemetry", "probe_hist", "probe.cu",
             (("probe_hist_only", "hist_only"),)),
            ("receive_folded", "folded", "receive_folded",
             "receive_folded.cu", ()),
            ("gossip_folded", "folded", "gossip_folded", "gossip_folded.cu",
             (("gossip_folded_masks", "masks"),)),
            ("gossip_folded_shards", "sharded_folded_lossy", "gossip_folded",
             "gossip_folded.cu", ()),
            ("probe_folded", "folded", "probe_folded", "probe_folded.cu", ()),
            ("probe_folded_hist", "sharded_folded_lossy",
             "probe_folded_hist", "probe_folded.cu",
             (("probe_folded_hist_only", "hist_only"),)),
            ("gossip_stacked", "sharded", "gossip_stacked",
             "gossip_stacked.cu", (("gossip_stacked_masks", "masks"),)),
            ("gossip_wide", "wide", "gossip_wide", "gossip.cu",
             (("gossip_wide_open", "all_open"),
              ("gossip_wide_masks", "masks"))),
            ("gossip_stacked_wide", "wide_sharded", "gossip_stacked_wide",
             "gossip_stacked.cu", (("gossip_stacked_wide_masks", "masks"),)),
            ("receive_wide", "wide", "receive", "receive.cu", ()),
            ("probe_wide", "wide", "probe", "probe.cu", ())):
        r = dict(rows[form])
        name = r.pop("name")
        entry = {"name": f"{name}[{form}]", "route": "cuda",
                 "source": CSRC + src, "replaces": TPU_KERNEL[name],
                 "launches": paths[path]["launches"][key], **r,
                 "launches_by_path": {
                     p: info["launches"][key] for p, info in paths.items()
                     if isinstance(info, dict) and "launches" in info
                     and info["launches"].get(key)}}
        for x_form, tag in extras:
            x = rows[x_form]
            entry.update({f"{tag}_{k}": v for k, v in x.items()
                          if k in ("ms", "plain_ms", "bound_ms",
                                   "max_abs_err")})
        out.append(entry)
    log(json.dumps({"kernels": out}))
    log(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
