"""Reshard-on-resume: rewrite a durable checkpoint for a new topology
(counterpart of the JAX package's ``elastic/reshard.py``).

A checkpoint holds the FULL GLOBAL carry: the port's sharded backend keeps
every shard of ``MESH_SHAPE`` on one device in the flat ``[N, ...]``
layout (parallel/mesh.py), and the JAX package gathers node-sharded
leaves to the host at each boundary, so an npz's leaf shapes depend on
(N, S, FOLDED) but never on ``MESH_SHAPE`` or the process count.  A
resume on another topology is therefore a host-side metadata operation
plus a redistribution proof, not a device shuffle:

1. load the checkpointed carry from the source per-process dirs and
   cross-check that they agree (tick, params identity, state hash);
2. validate the target geometry loudly (mesh-shape grammar, N
   divisibility, process divisibility, ``PACK_SAFE_TICKS``, the folded
   row bound), with the JAX package's messages;
3. round-trip the carry through the ops/megakernel.py boundary codec
   (bit-packed bools; u16 stamp lanes under ``pack16``) on the run's
   device, leaf by leaf, each leaf's copies freed before the next, and
   through the old -> new per-shard row split on the host, verifying
   bit-exactness -- the transport a migration pays, timed and counted;
4. stamp the manifest with a reshard provenance record (``from_shape``,
   ``to_shape``, ``from_procs``, ``to_procs``, carry digest) APPENDED to
   any existing chain (runtime/checkpoint.py carries the chain across
   later boundary writes);
5. write the rewritten checkpoint to the target per-process dirs
   (``ckpt_{tick:08d}.npz`` and ``MANIFEST.json``, each an atomic
   write-rename; older ``ckpt_*.npz`` removed).  Every leaf is read
   whole before the write, so a reshard in place (``--dst`` = ``--src``)
   is safe.

The files written equal the JAX ``reshard``'s for the same input, apart
from the ``ts`` and ``wrote_at`` stamps.  ``MESH_SHAPE`` stays in the
resume identity: a topology change is explicit (this module, then
``--resume --mesh-shape``), never a silent re-shard.

CLI: ``python -m distributed_membership_tpu_torch.elastic.reshard
--src RUN/ck --dst RUN/ck --mesh-shape 4x2 [--device cpu]`` (exit code 2
on a refusal).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np

__all__ = ["ReshardError", "mesh_size", "validate_geometry", "reshard"]


class ReshardError(ValueError):
    """A target geometry this checkpoint cannot legally resume onto."""


def mesh_size(shape: str, default: int = 1) -> int:
    """Device count of a MESH_SHAPE string ('' = ``default``)."""
    if not shape:
        return int(default)
    out = 1
    for p in shape.lower().split("x"):
        out *= int(p)
    return out


def _check_shape_grammar(shape: str, label: str) -> None:
    if not shape:
        return
    parts = shape.lower().split("x")
    if not (1 <= len(parts) <= 3
            and all(p.isdigit() and int(p) > 0 for p in parts)):
        raise ReshardError(
            f"{label} must be 'D', 'OxI' or 'SxOxI' (positive ints), "
            f"got {shape!r}")


def validate_geometry(n: int, total_time: int, from_shape: str,
                      to_shape: str, from_procs: int, to_procs: int,
                      *, pack16: bool = False,
                      folded: bool = False) -> None:
    """Refuse a reshard target loudly, each refusal naming the violated
    bound (the JAX package's gate and messages)."""
    from distributed_membership_tpu_torch.ops.megakernel import (
        PACK_SAFE_TICKS, pack_fits)

    _check_shape_grammar(from_shape, "source MESH_SHAPE")
    _check_shape_grammar(to_shape, "target MESH_SHAPE")
    if to_procs < 1:
        raise ReshardError(
            f"target process count must be >= 1, got {to_procs}")
    size = mesh_size(to_shape, default=to_procs)
    if n % size != 0:
        raise ReshardError(
            f"target MESH_SHAPE {to_shape!r} ({size} devices) does not "
            f"divide N={n}: the sharded backend splits member rows "
            f"evenly across the mesh (N % mesh_size == 0)")
    if size % to_procs != 0:
        raise ReshardError(
            f"target MESH_SHAPE {to_shape!r} ({size} devices) does not "
            f"divide across {to_procs} processes (mesh_size % procs "
            f"== 0: every process owns the same number of devices)")
    if folded and (n // size) % 2 != 0:
        raise ReshardError(
            f"FOLDED carry needs an even per-device row count, got "
            f"N={n} over {size} devices ({n // size} rows each) for "
            f"target MESH_SHAPE {to_shape!r}")
    if pack16 and not pack_fits(total_time):
        raise ReshardError(
            f"MEGA_PACK's 16-bit stamp lanes cover at most "
            f"PACK_SAFE_TICKS={PACK_SAFE_TICKS} ticks; this run has "
            f"TOTAL_TIME={total_time} — resume unpacked (MEGA_PACK: 0) "
            f"on the new geometry instead")


def _load_ckpt_arrays(ckpt_dir: str, manifest: dict):
    """-> (carry leaves, payload arrays), every one read whole, verified
    against the manifest's state hash (the resume's corruption gate)."""
    from distributed_membership_tpu_torch.runtime.checkpoint import (
        state_hash)

    path = os.path.join(ckpt_dir, manifest["file"])
    try:
        npz = np.load(path)
    except OSError as e:
        raise ReshardError(
            f"checkpoint file {path!r} named by the manifest is "
            f"unreadable ({e})") from e
    with npz as data:
        ckeys = sorted((k for k in data.files if k.startswith("c")
                        and k[1:].isdigit()), key=lambda k: int(k[1:]))
        leaves = [data[k] for k in ckeys]
        payload = {k: data[k] for k in data.files if k.startswith("e_")}
    got = state_hash(leaves)
    if got != manifest["state_hash"]:
        raise ReshardError(
            f"state hash mismatch for {path!r} (manifest "
            f"{manifest['state_hash'][:12]}…, file {got[:12]}…) — "
            "checkpoint is corrupt; refusing to reshard it")
    return leaves, payload


def _codec_roundtrip(leaves: list, pack16: bool, total_time: int,
                     device) -> dict:
    """Pack and unpack each carry leaf through the ops/megakernel.py
    boundary codec on ``device`` and verify bit-exactness.  Bool leaves
    travel as bit-packed words; under ``pack16`` (and the static tick
    bound) an int32 leaf whose values fit (``fits16``) travels as u16
    lanes; every other leaf as it is, and stays on the host.  One leaf's
    device copy, words and unpacked copy are freed before the next."""
    import torch

    from distributed_membership_tpu_torch.ops import megakernel as mk

    t0 = time.perf_counter()
    packed_bytes = 0
    for leaf in leaves:
        if leaf.dtype == np.bool_:
            kind, pack, unpack = "bits", mk._pack_bits, mk._unpack_bits
        elif (pack16 and mk.pack_fits(total_time) and leaf.ndim >= 1
              and leaf.dtype == np.int32 and mk.fits16(leaf)):
            kind, pack, unpack = "u16", mk._pack_u16, mk._unpack_u16
        else:
            packed_bytes += leaf.nbytes
            continue
        x = torch.from_numpy(np.asarray(leaf)).to(device)
        words = pack(x)
        back = unpack(words, leaf.shape)
        packed_bytes += words.numel() * 4          # u32 words
        same = back.dtype == x.dtype and torch.equal(back, x)
        del x, words, back
        if not same:
            raise ReshardError(
                "boundary codec round-trip diverged on a carry leaf "
                f"(kind={kind}, shape={leaf.shape}, dtype={leaf.dtype}) "
                "— refusing to ship a lossy carry")
    full_bytes = sum(leaf.nbytes for leaf in leaves)
    return {"carry_bytes_full": int(full_bytes),
            "carry_bytes_packed": int(packed_bytes),
            "codec_seconds": time.perf_counter() - t0}


def _redistribute(leaves: list, n: int, from_size: int,
                  to_size: int) -> float:
    """Gather -> re-split proof on the host: slice every node-sharded
    leaf into the old per-device row shards, reassemble, re-split per
    the new mesh, reassemble again, and verify bit-exactness.  Returns
    the wall seconds of the shuffle."""
    t0 = time.perf_counter()
    if n <= 0 or n % from_size or n % to_size:
        return 0.0          # unsharded source/target: nothing to move
    for leaf in leaves:
        if leaf.ndim < 1 or leaf.shape[0] != n:
            continue        # replicated / non-row leaf: no row shards
        gathered = np.concatenate(np.split(leaf, from_size, axis=0))
        shards = np.split(np.ascontiguousarray(gathered), to_size,
                          axis=0)
        back = np.concatenate(shards, axis=0)
        if not np.array_equal(back, leaf):
            raise ReshardError(
                f"host redistribution diverged on a [{n}, ...] leaf "
                f"({from_size} -> {to_size} row shards)")
    return time.perf_counter() - t0


def reshard(src_dirs: List[str], dst_dirs: List[str], *,
            to_mesh_shape: Optional[str] = None,
            pack16: bool = False, device="cuda") -> dict:
    """Rewrite the checkpoint in ``src_dirs`` (one per source process)
    for the topology of ``to_mesh_shape`` and ``len(dst_dirs)`` target
    processes; the codec round trip runs on ``device`` (``cuda`` unless
    the caller asks for the CPU).  Returns a stats dict (tick, shapes,
    carry bytes, codec and redistribution seconds, carry digest).
    Raises :class:`ReshardError` on any geometry the checkpoint cannot
    legally resume onto, and never touches ``dst_dirs`` before every
    check has passed."""
    from distributed_membership_tpu_torch.runtime.application import (
        resolve_device)
    from distributed_membership_tpu_torch.runtime.checkpoint import (
        CKPT_VERSION, MANIFEST_NAME, load_manifest)

    if not src_dirs or not dst_dirs:
        raise ReshardError("need at least one --src and one --dst "
                           "checkpoint directory")
    dev = resolve_device(device)
    t_start = time.perf_counter()
    manifests = []
    for d in src_dirs:
        m = load_manifest(d)
        if m is None:
            raise ReshardError(
                f"no readable {MANIFEST_NAME} in {d!r} — nothing durable "
                "to reshard")
        manifests.append(m)
    head = manifests[0]
    if int(head.get("version", 0)) != CKPT_VERSION:
        raise ReshardError(
            f"checkpoint version {head.get('version')!r} in "
            f"{src_dirs[0]!r} (this code writes {CKPT_VERSION})")
    for d, m in zip(src_dirs[1:], manifests[1:]):
        for k in ("tick", "state_hash", "params_text", "seed",
                  "backend", "total_time", "process_count"):
            if m.get(k) != head.get(k):
                raise ReshardError(
                    f"source checkpoints disagree: field {k!r} is "
                    f"{m.get(k)!r} in {d!r} vs {head.get(k)!r} in "
                    f"{src_dirs[0]!r} — not one run's boundary")
    from_procs = int(head.get("process_count", 1))
    if len(src_dirs) != from_procs:
        raise ReshardError(
            f"checkpoint was written by {from_procs} process(es) but "
            f"{len(src_dirs)} --src dir(s) given — every source "
            "process's directory must be presented (gather-to-host "
            "covers the whole mesh, not a slice of it)")

    params = json.loads(head["params_text"])
    n = int(params.get("EN_GPSZ", 0))
    from_shape = params.get("MESH_SHAPE", "") or ""
    folded = int(params.get("FOLDED", 0)) == 1
    total_time = int(head["total_time"])
    to_procs = len(dst_dirs)
    to_shape = from_shape if to_mesh_shape is None else to_mesh_shape
    validate_geometry(n, total_time, from_shape, to_shape, from_procs,
                      to_procs, pack16=pack16, folded=folded)

    leaves, payload = _load_ckpt_arrays(src_dirs[0], head)
    stats = _codec_roundtrip(leaves, pack16, total_time, dev)
    stats["redistribute_seconds"] = _redistribute(
        leaves, n, mesh_size(from_shape, default=from_procs),
        mesh_size(to_shape, default=to_procs))

    tick = int(head["tick"])
    digest = head["state_hash"]
    record = {"from_shape": from_shape, "to_shape": to_shape,
              "from_procs": from_procs, "to_procs": to_procs,
              "carry_digest": digest, "tick": tick,
              "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    chain = list(head.get("reshard", ())) + [record]

    new_params = dict(params)
    new_params["MESH_SHAPE"] = to_shape
    fname = f"ckpt_{tick:08d}.npz"
    arrays = {f"c{i}": leaf for i, leaf in enumerate(leaves)}
    arrays.update(payload)
    manifest = dict(head)
    manifest.update({
        "params_text": json.dumps(new_params, sort_keys=True),
        "process_count": to_procs,
        "file": fname,
        "checkpoints": [{"tick": tick, "file": fname,
                         "state_hash": digest}],
        "reshard": chain,
        "wrote_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    })
    for d in dst_dirs:
        os.makedirs(d, exist_ok=True)
        npz_path = os.path.join(d, fname)
        tmp = npz_path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, npz_path)
        tmp = os.path.join(d, MANIFEST_NAME) + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(manifest, fh, indent=1)
        os.replace(tmp, os.path.join(d, MANIFEST_NAME))
        # Snapshots of the old topology would out-version the resharded
        # one on a later history walk: drop them.
        for f in os.listdir(d):
            if (f.startswith("ckpt_") and f.endswith(".npz")
                    and f != fname):
                try:
                    os.unlink(os.path.join(d, f))
                except OSError:
                    pass

    stats.update({"tick": tick, "from_shape": from_shape,
                  "to_shape": to_shape, "from_procs": from_procs,
                  "to_procs": to_procs, "carry_digest": digest,
                  "wall_seconds": time.perf_counter() - t_start})
    return stats


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Rewrite a durable checkpoint for a new MESH_SHAPE "
                    "and/or process count (reshard-on-resume)")
    ap.add_argument("--src", action="append", required=True,
                    metavar="DIR", help="source per-process checkpoint "
                    "dir (repeat once per source process)")
    ap.add_argument("--dst", action="append", required=True,
                    metavar="DIR", help="target per-process checkpoint "
                    "dir (repeat once per target process; may overlap "
                    "--src for in-place reshards)")
    ap.add_argument("--mesh-shape", default=None,
                    help="target MESH_SHAPE (default: keep the source's)")
    ap.add_argument("--pack16", action="store_true",
                    help="round-trip the carry through the 16-bit stamp "
                    "lanes too (requires the static tick bound)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the codec round trip (default cuda)")
    args = ap.parse_args(argv)
    try:
        stats = reshard(args.src, args.dst,
                        to_mesh_shape=args.mesh_shape,
                        pack16=args.pack16, device=args.device)
    except ReshardError as e:
        print(f"reshard: {e}")
        return 2
    print(json.dumps(stats, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
