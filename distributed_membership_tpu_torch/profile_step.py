"""Per-tick cost profiler of the ring step on one device (the JAX
package's ``scripts/profile_step.py``, on the port).

Times the ``tpu_hash`` scan (second run, fresh seed, kernels built)
across a grid of (N, VIEW_SIZE, exchange, FUSED_RECEIVE) points and
prints one JSON line per point: wall seconds, ticks/s, node-ticks/s and
the HBM traffic the ring pass model implies (a model of the JAX
program's passes over the ``[N, S]`` planes, not a measured bandwidth).
The conf of a point is the JAX script's, key for key, and so is its
record, but for ``platform`` (``cuda`` or ``cpu``) and ``device`` (the
card's name and power limit).

On the card each timed window lies between two ``torch.cuda.synchronize``
calls; ``compile_plus_first_run_s`` is the first run, the kernels' build
included.  The kernel flags take ``auto`` (``-1``, their default): the
kernels on the card, their plain versions on the CPU.  ``off`` pins a
kernel's key to 0, which the port refuses on the card (its kernels are
the path there), and ``on`` to 1, which it refuses on the CPU.  The
record's ``fused``, ``fused_gossip``, ``fused_probe`` and ``folded``
are what the run resolved, and the pass model reads them, so an ``auto``
record on the CPU equals the JAX script's ``off`` record.

Refused by design: ``--cost`` (PyTorch has no counterpart of XLA's
``cost_analysis``).  ``--prng rbg|unsafe_rbg`` draws jax's Philox4x32-10
stream (ops/rbg.py; the kernel ``csrc/philox.cu`` on the card), so the
JAX ladder's rbg rungs (``1M_s16_rbg``, ``1M_s64_rbg``) run through
:func:`time_point` too.

Usage:
  python -m distributed_membership_tpu_torch.profile_step   # default grid
  python -m distributed_membership_tpu_torch.profile_step --n 1048576 \\
      --view 128 --ticks 30 --trace-dir /tmp/trace
  python -m distributed_membership_tpu_torch.profile_step --n 512 --device cpu

``--device`` defaults to ``cuda``; without a card the run raises rather
than running on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

AUTO = -1
KNOB_CHOICES = {"auto": AUTO, "off": 0, "on": 1}
COST_REFUSAL = (
    "--cost: PyTorch has no counterpart of XLA's cost_analysis (the bytes "
    "and flops the compiler scheduled); the port's kernels are timed "
    "against their bytes bound in chip_smoke.py's phase kernels")


def knob(value) -> int:
    """A kernel flag as its conf value: ``auto``/None -> -1, a bool or
    0/1/-1 as given."""
    if value is None or value == "auto":
        return AUTO
    return int(value)


def sync(device) -> None:
    """Wait for the device: the end of every timed window."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def resolved_config(params, plan, device, mesh=None):
    """The config the run resolves: ``tpu_hash.make_config``, or the
    sharded backend's on ``mesh``."""
    from distributed_membership_tpu_torch.backends.tpu_hash import (
        make_config, plan_fail_ids)
    if mesh is None:
        return make_config(params, collect_events=False,
                           fail_ids=plan_fail_ids(plan), device=device)
    from distributed_membership_tpu_torch.backends.tpu_hash_sharded import (
        sharded_config)
    return sharded_config(params, False, plan_fail_ids(plan),
                          mesh.rows_per_shard(params.EN_GPSZ),
                          device=mesh.device)


def resolved_kernels(cfg, device) -> dict:
    """Which kernels the run launches: on the card every kernel of the
    ring step (K3/K7 only with probes), on the CPU their plain versions
    (none); the scatter step has none anywhere."""
    on = device.type == "cuda" and cfg.exchange == "ring"
    return {"fused_receive": on, "fused_gossip": on,
            "fused_probe": on and cfg.probes > 0, "folded": bool(cfg.folded)}


def sharded_scan(mesh):
    """A ``tpu_hash.run_scan``-shaped callable of the sharded backend on
    ``mesh`` (it runs the params' TOTAL_TIME ticks)."""
    from distributed_membership_tpu_torch.backends.tpu_hash_sharded import (
        run_scan_sharded)

    def run(params, plan, seed, device=None, collect_events=True,
            total_time=None):
        return run_scan_sharded(params, plan, seed, mesh, collect_events)
    return run


def time_point(n: int, s: int, ticks: int, exchange: str, fused=AUTO,
               fanout: int = 3, cost: bool = False, fused_gossip=AUTO,
               folded=AUTO, prng: str = "threefry2x32", shift_set: int = 0,
               rng_mode: str = "batched", probe_gather: str = "packed",
               fused_probe=AUTO, drops: bool = False, mega_ticks: int = 0,
               exchange_mode: str = "-1", trace_dir: str = "", runlog=None,
               device="cuda", mesh_shape: str = "") -> dict:
    """Time one point; -> its record.  ``mesh_shape`` pins MESH_SHAPE on
    the sharded route (unset: one shard in the port, the largest device
    count dividing N in the JAX package)."""
    import random as _pyrandom

    import torch

    from distributed_membership_tpu_torch.config import Params
    from distributed_membership_tpu_torch.observability.timeline import (
        PHASE_NAMES, scan_trace_for_phases)
    from distributed_membership_tpu_torch.runtime.application import (
        resolve_device)
    from distributed_membership_tpu_torch.runtime.failures import make_plan
    from distributed_membership_tpu_torch.scale_smoke import device_info

    if cost:
        raise NotImplementedError(COST_REFUSAL)
    dev = resolve_device(device)
    g = max(s // 4, 1)
    probes = max(s // 8, 1)
    drop_keys = (
        f"DROP_MSG: 1\nMSG_DROP_PROB: 0.1\nDROP_START: {ticks // 6}\n"
        f"DROP_STOP: {ticks - ticks // 6}\n" if drops else
        "DROP_MSG: 0\nMSG_DROP_PROB: 0\n")
    # --exchange-mode pins EXCHANGE_MODE and moves the run onto the
    # sharded backend (the knob is tpu_hash_sharded only).
    sharded = exchange_mode != "-1"
    backend = "tpu_hash_sharded" if sharded else "tpu_hash"
    text = (
        f"MAX_NNB: {n}\nSINGLE_FAILURE: 1\n{drop_keys}"
        f"VIEW_SIZE: {s}\nGOSSIP_LEN: {g}\nPROBES: {probes}\n"
        f"FANOUT: {fanout}\nTFAIL: 16\nTREMOVE: 40\nTOTAL_TIME: {ticks}\n"
        f"FAIL_TIME: {ticks // 2}\nJOIN_MODE: warm\n"
        f"EXCHANGE: {exchange}\nFUSED_RECEIVE: {knob(fused)}\n"
        f"FUSED_GOSSIP: {knob(fused_gossip)}\nFOLDED: {knob(folded)}\n"
        f"FUSED_PROBE: {knob(fused_probe)}\n"
        f"PRNG_IMPL: {prng}\nSHIFT_SET: {shift_set}\n"
        f"RNG_MODE: {rng_mode}\nPROBE_GATHER: {probe_gather}\n"
        f"BACKEND: {backend}\nEXCHANGE_MODE: {exchange_mode}\n"
        + (f"MESH_SHAPE: {mesh_shape}\n" if sharded and mesh_shape else ""))
    params = Params.from_text(text)
    plan = make_plan(params, _pyrandom.Random("app:0"))
    mesh = None
    mesh_fields = {}
    if sharded:
        from distributed_membership_tpu_torch.backends.tpu_hash_sharded import (
            resolve_mesh)
        mesh = resolve_mesh(params, dev)
        mesh_fields = {"mesh_size": mesh.size}
        scan = sharded_scan(mesh)
    else:
        from distributed_membership_tpu_torch.backends.tpu_hash import (
            run_scan as scan)

    # Checkpointed mode: DM_CHECKPOINT_EVERY chunks both scans into
    # segments; the first run persists and resumes through
    # DM_CHECKPOINT_DIR + DM_RESUME, the timed run chunks without
    # persistence (no disk in the measured wall).
    ck_every = int(os.environ.get("DM_CHECKPOINT_EVERY", "0") or 0)
    ck_dir = os.environ.get("DM_CHECKPOINT_DIR", "")
    resume = os.environ.get("DM_RESUME", "") not in ("", "0")
    # --mega-ticks T: the T-tick blocks need segments that T tiles, so an
    # unset (or non-tiling) DM_CHECKPOINT_EVERY defaults to 4 blocks.
    if mega_ticks > 0 and (ck_every <= 0 or ck_every % mega_ticks != 0):
        ck_every = 4 * mega_ticks
    mega_text = f"MEGA_TICKS: {mega_ticks}\n" if mega_ticks > 0 else ""
    warm_params = timed_params = params
    ckpt_fields = {}
    if ck_every > 0:
        from distributed_membership_tpu_torch.runtime.checkpoint import (
            manifest_tick)
        do_resume = int(resume and bool(ck_dir))
        warm_params = Params.from_text(
            text + f"CHECKPOINT_EVERY: {ck_every}\n"
            f"CHECKPOINT_DIR: {ck_dir}\nRESUME: {do_resume}\n" + mega_text)
        timed_params = Params.from_text(
            text + f"CHECKPOINT_EVERY: {ck_every}\n" + mega_text)
        ckpt_fields = {"checkpoint_every": ck_every,
                       "resumed_from_tick": (manifest_tick(ck_dir)
                                             if do_resume else None)}
    if mega_ticks > 0:
        ckpt_fields["mega_ticks"] = mega_ticks

    point = {"n": n, "s": s, "ticks": ticks, "exchange": exchange}
    if runlog is not None:
        runlog.event("compile", phase="start", **point)
    sync(dev)
    t0 = time.perf_counter()
    scan(warm_params, plan, 0, dev, collect_events=False, total_time=ticks)
    sync(dev)
    compile_wall = time.perf_counter() - t0
    if runlog is not None:
        runlog.event("compile", phase="done",
                     compile_plus_first_run_s=round(compile_wall, 2),
                     **point)

    # A torch.profiler trace of the timed run only (CPU activity and, on
    # the card, CUDA): the dm_* record_function ranges split its time by
    # protocol phase.
    trace_fields = {}
    prof = contextlib.nullcontext()
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    with prof:
        t0 = time.perf_counter()
        scan(timed_params, plan, 1, dev, collect_events=False,
             total_time=ticks)
        sync(dev)
        wall = time.perf_counter() - t0
    if trace_dir:
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        phases = scan_trace_for_phases(trace_dir)
        trace_fields = {
            "trace_dir": trace_dir,
            "trace_files": sum(len(fs) for _, _, fs in os.walk(trace_dir)),
            "trace_phases": phases,
            "trace_phase_annotations_present":
                set(PHASE_NAMES) <= set(phases),
        }
        if runlog is not None:
            runlog.event("trace", **trace_fields)
    if runlog is not None:
        runlog.event("execute", wall_seconds=round(wall, 3),
                     ms_per_tick=round(1000 * wall / ticks, 2), **point)

    cfg = resolved_config(params, plan, dev, mesh)
    kern = resolved_kernels(cfg, dev)
    # Ring pass model (the JAX script's): receive ~12 plain / ~6 fused,
    # gossip ~3 per shift, probe/agg ~4 plain / ~2 fused.
    state_bytes = 3 * n * s * 4
    gossip_passes = ((2 * min(cfg.fanout, cfg.s) + 2) if kern["fused_gossip"]
                     else 3 * min(cfg.fanout, cfg.s))
    passes = ((6 if kern["fused_receive"] else 12) + gossip_passes
              + (2 if kern["fused_probe"] else 4))
    est_gb_per_tick = passes * (n * s * 4) / 1e9
    return {
        "n": n, "s": s, "ticks": ticks, "exchange": cfg.exchange,
        "fused": kern["fused_receive"], "fused_gossip": kern["fused_gossip"],
        "folded": kern["folded"], "fused_probe": kern["fused_probe"],
        "backend": backend, "exchange_mode": exchange_mode,
        **mesh_fields,
        "drop_prob": 0.1 if drops else 0,
        "prng": prng, "shift_set": shift_set,
        "rng_mode": rng_mode, "probe_gather": probe_gather,
        "fanout": cfg.fanout, "probes": cfg.probes,
        "platform": dev.type,
        "device": device_info(dev),
        # wall_seconds is the second run, kernels built; the build and the
        # first run are compile_plus_first_run_s.
        "timing": "warm_cache",
        "compile_plus_first_run_s": round(compile_wall, 2),
        "wall_seconds": round(wall, 3),
        "ticks_per_sec": round(ticks / wall, 2),
        "node_ticks_per_sec": round(n * ticks / wall, 1),
        "ms_per_tick": round(1000 * wall / ticks, 2),
        "resident_state_mb": round(state_bytes / 1e6, 1),
        "est_model_gb_per_tick": round(est_gb_per_tick, 3),
        "implied_hbm_gbps": round(est_gb_per_tick * ticks / wall, 1),
        **ckpt_fields,
        **trace_fields,
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_membership_tpu_torch.profile_step",
        description=__doc__.split("\n")[0])
    kernel = list(KNOB_CHOICES)
    ap.add_argument("--n", type=int, default=0,
                    help="single N (0 = default grid)")
    ap.add_argument("--view", type=int, default=128)
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--exchange", default="ring",
                    choices=["ring", "scatter"])
    ap.add_argument("--fanout", type=int, default=3)
    ap.add_argument("--fused", default="auto", choices=kernel + ["both"],
                    help="FUSED_RECEIVE (auto: the kernel on the card, the "
                         "plain version on the CPU; both: off then on)")
    ap.add_argument("--fused-gossip", default="auto", choices=kernel)
    ap.add_argument("--folded", default="auto", choices=kernel)
    ap.add_argument("--shift-set", type=int, default=0,
                    help="SHIFT_SET: K static gossip-shift candidates "
                         "(0 = off)")
    ap.add_argument("--prng", default="threefry2x32",
                    choices=["threefry2x32", "rbg", "unsafe_rbg"],
                    help="PRNG_IMPL (rbg, unsafe_rbg: jax's Philox4x32-10 "
                         "stream, bit for bit)")
    ap.add_argument("--rng-mode", default="batched",
                    choices=["batched", "scattered"])
    ap.add_argument("--probe-gather", default="packed",
                    choices=["packed", "split"])
    ap.add_argument("--fused-probe", default="auto", choices=kernel,
                    help="FUSED_PROBE: the probe-window kernel")
    ap.add_argument("--mega-ticks", type=int, default=0,
                    help="MEGA_TICKS: T-tick blocks (0 = off); defaults "
                         "CHECKPOINT_EVERY to 4*T when DM_CHECKPOINT_EVERY "
                         "is unset or T does not tile it")
    ap.add_argument("--exchange-mode", default="-1",
                    choices=["-1", "legacy", "batched"],
                    help="EXCHANGE_MODE on the sharded backend (any "
                         "explicit value moves the run onto "
                         "tpu_hash_sharded); -1 keeps tpu_hash")
    ap.add_argument("--mesh-shape", default="",
                    help="MESH_SHAPE of the sharded route (unset: one "
                         "shard)")
    ap.add_argument("--drops", default="off", choices=["off", "on"],
                    help="arm a mid-run 10%% drop window")
    ap.add_argument("--cost", action="store_true",
                    help="refused: " + COST_REFUSAL.replace("%", "%%"))
    ap.add_argument("--trace-dir", default="",
                    help="capture a torch.profiler trace of the timed run "
                         "into this directory; the record says which "
                         "protocol-phase ranges (observability/timeline."
                         "PHASE_NAMES) it holds")
    ap.add_argument("--runlog", default="",
                    help="append compile/execute/trace events to this "
                         "JSONL file (observability/runlog.RunLog)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run goes (default: the card)")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.cost:
        ap.error(COST_REFUSAL)
    runlog = None
    if args.runlog:
        from distributed_membership_tpu_torch.observability.runlog import (
            RunLog)
        runlog = RunLog(args.runlog)
    ns = [args.n] if args.n else [1 << 16, 1 << 18, 1 << 20]
    fused_opts = ([0, 1] if args.fused == "both"
                  else [KNOB_CHOICES[args.fused]])
    for n in ns:
        for fused in fused_opts:
            rec = time_point(n, args.view, args.ticks, args.exchange,
                             fused, args.fanout,
                             fused_gossip=KNOB_CHOICES[args.fused_gossip],
                             folded=KNOB_CHOICES[args.folded],
                             prng=args.prng, shift_set=args.shift_set,
                             rng_mode=args.rng_mode,
                             probe_gather=args.probe_gather,
                             fused_probe=KNOB_CHOICES[args.fused_probe],
                             drops=args.drops == "on",
                             mega_ticks=args.mega_ticks,
                             exchange_mode=args.exchange_mode,
                             trace_dir=args.trace_dir, runlog=runlog,
                             device=args.device, mesh_shape=args.mesh_shape)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
