"""Params: the ``.conf`` format shared with the JAX package.

The format is the reference's four legacy keys (``MAX_NNB``,
``SINGLE_FAILURE``, ``DROP_MSG``, ``MSG_DROP_PROB``, Params.cpp:22-25)
plus ``KEY: value`` extension lines.  The port's ``Params`` has every
field of the JAX package's, with the same defaults, derivations and
``validate`` gates, so both packages accept and refuse the same confs
with the same messages.  Keys neither knows are ignored, as the
reference's fscanf ignores them; keys the port knows but does not
implement yet are refused by the backend (backends/tpu_hash.py).
"""

from __future__ import annotations

import dataclasses
import math
import re
import warnings

_KNOWN_BACKENDS = ("emul", "emul_native", "tpu", "tpu_sharded", "tpu_sparse",
                   "tpu_hash", "tpu_hash_sharded")


@dataclasses.dataclass
class Params:
    """Every field of the JAX package's ``Params``, with its defaults, so
    that a checkpoint's ``params_identity`` (runtime/checkpoint.py) is the
    same text in both packages.  The service keys configure the service
    daemon (service/daemon.py); the fleet keys configure the fleet
    controller (fleet/daemon.py ``fleet_conf``, which alone reads them),
    and a run conf that sets them runs as it does without them."""
    # --- legacy keys (Params.cpp:22-25) ---
    MAX_NNB: int = 10
    SINGLE_FAILURE: int = 1
    DROP_MSG: int = 0
    MSG_DROP_PROB: float = 0.0
    # --- derived (Params.cpp:29-34) ---
    EN_GPSZ: int = 10
    STEP_RATE: float = 0.25
    MAX_MSG_SIZE: int = 4000
    globaltime: int = 0
    dropmsg: int = 0
    # --- constants promoted from #defines ---
    PORTNUM: int = 8001
    TFAIL: int = 5
    TREMOVE: int = 20
    TOTAL_TIME: int = 700
    FANOUT: int = 5
    EN_BUFFSIZE: int = 30000
    # --- extensions ---
    BACKEND: str = "emul"
    SEED: int = 0
    JOIN_MODE: str = "staggered"
    FAIL_TIME: int = 100
    DROP_START: int = 50
    DROP_STOP: int = 300
    VIEW_SIZE: int = 0
    GOSSIP_LEN: int = 0
    MAILBOX_SIZE: int = 0
    PROBES: int = 0
    RACK_SIZE: int = 0
    RACK_FAILURES: int = 0
    EVENT_MODE: str = "auto"
    EXCHANGE: str = "auto"
    EXCHANGE_MODE: str = "-1"   # tpu_hash_sharded: -1 (legacy) | legacy
    FUSED_RECEIVE: int = -1
    FUSED_GOSSIP: int = -1
    FUSED_PROBE: int = -1
    FOLDED: int = -1
    MEGA_TICKS: int = -1        # T-tick blocks (ops/megakernel.py)
    MEGA_PACK: int = -1         # shrunk T-block carry
    MESH_SHAPE: str = ""        # tpu_hash_sharded: 'D', 'OxI' or 'SxOxI'
    PROBE_IO: str = "auto"
    ENFORCE_BUFFSIZE: int = 0
    PRNG_IMPL: str = "threefry2x32"
    RNG_MODE: str = "batched"   # scattered | batched | hoisted
    PROBE_GATHER: str = "packed"
    SHIFT_SET: int = 0
    CHECKPOINT_EVERY: int = 0   # segment length (runtime/checkpoint.py)
    CHECKPOINT_DIR: str = ""    # snapshots + MANIFEST.json; '' = none
    CHECKPOINT_COMPRESS: int = 0
    TELEMETRY: str = "off"      # off | scalars | hist (the flight recorder)
    TELEMETRY_DIR: str = ""     # timeline.jsonl, runlog.jsonl, summary.json
    SCENARIO: str = ""
    RESUME: int = 0
    SERVICE_PORT: int = -1
    SERVICE_SNAPSHOT_EVERY: int = 1
    SERVICE_WORKERS: int = 0
    SERVICE_SHM_BUFFERS: int = 4
    FLEET_PORT: int = -1
    FLEET_MAX_CONCURRENCY: int = 2
    FLEET_DIR: str = ""
    FLEET_LINGER: int = 0
    FLEET_MIGRATE_ON: str = ""
    FLEET_MIGRATE_MAX: int = 2
    WATCHDOG: int = 1

    def parse(self, text: str, validate: bool = True) -> "Params":
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            m = re.match(r"([A-Za-z_][A-Za-z0-9_]*)\s*:\s*(.*)", line)
            if m:
                self._set(m.group(1), m.group(2).strip())
        self.EN_GPSZ = self.MAX_NNB
        self.globaltime = 0
        self.dropmsg = 0
        if validate:
            self.validate()
        return self

    def _set(self, key: str, raw: str) -> None:
        if not hasattr(self, key):
            return
        cur = getattr(self, key)
        if isinstance(cur, int):
            setattr(self, key, int(raw))
        elif isinstance(cur, float):
            setattr(self, key, float(raw))
        else:
            setattr(self, key, raw)

    def _enum(self, key: str, allowed: tuple) -> None:
        if getattr(self, key) not in allowed:
            raise ValueError(f"{key} must be {'|'.join(allowed)}, got "
                             f"{getattr(self, key)!r}")

    def validate(self) -> None:
        """The JAX package's ``Params.validate``, check for check and in
        its order, with its messages."""
        if self.BACKEND not in _KNOWN_BACKENDS:
            raise ValueError(f"BACKEND must be one of {_KNOWN_BACKENDS}, "
                             f"got {self.BACKEND!r}")
        if self.EN_GPSZ < 1:
            raise ValueError("MAX_NNB must be >= 1")
        self._enum("EVENT_MODE", ("auto", "full", "agg"))
        self._enum("JOIN_MODE", ("staggered", "batch", "warm"))
        self._enum("EXCHANGE", ("auto", "scatter", "ring"))
        self._enum("EXCHANGE_MODE", ("-1", "legacy", "batched"))
        if self.EXCHANGE_MODE == "batched" and self.EXCHANGE == "scatter":
            raise ValueError(
                "EXCHANGE_MODE batched applies to the ring exchange's "
                "gossip shifts (EXCHANGE ring/auto); the scatter lowering "
                "has no per-shift collective round to batch")
        self._enum("PRNG_IMPL", ("threefry2x32", "rbg", "unsafe_rbg"))
        self._enum("PROBE_IO", ("auto", "exact", "approx", "approx_lag",
                                "none"))
        if self.SHIFT_SET and not 2 <= self.SHIFT_SET <= 64:
            raise ValueError(
                f"SHIFT_SET must be 0 (off) or 2..64 static shift "
                f"candidates (got {self.SHIFT_SET}); each candidate adds "
                f"a lax.switch branch to the compiled step")
        if self.CHECKPOINT_EVERY < 0:
            raise ValueError(
                f"CHECKPOINT_EVERY must be >= 0 (0 = off), got "
                f"{self.CHECKPOINT_EVERY}")
        if self.CHECKPOINT_EVERY and self.BACKEND in (
                "emul", "emul_native", "tpu_sharded"):
            raise ValueError(
                f"CHECKPOINT_EVERY is not supported by BACKEND "
                f"{self.BACKEND!r} (chunked drivers: tpu, tpu_sparse, "
                "tpu_hash, tpu_hash_sharded)")
        self._enum("RNG_MODE", ("scattered", "batched", "hoisted"))
        if self.RNG_MODE == "hoisted":
            # The pre-drawn streams are segment-scoped, and only the
            # single-chip step consumes a pre-drawn plan.
            if self.CHECKPOINT_EVERY <= 0:
                raise ValueError(
                    "RNG_MODE hoisted requires CHECKPOINT_EVERY > 0 "
                    "(the pre-drawn [K, ...] RNG tensors are segment-"
                    "scoped; a whole-run hoist would be O(T*fanout*N*S) "
                    "memory)")
            if self.BACKEND != "tpu_hash":
                raise ValueError(
                    "RNG_MODE hoisted is single-chip tpu_hash only "
                    f"(got BACKEND {self.BACKEND!r})")
            if self.resolved_exchange() != "ring":
                raise ValueError(
                    "RNG_MODE hoisted requires the ring exchange (the "
                    "scatter lowering keeps its site-local draws)")
        self._enum("TELEMETRY", ("off", "scalars", "hist"))
        if self.TELEMETRY in ("scalars", "hist"):
            # Only the ring steps emit the per-tick series.
            if self.BACKEND not in ("tpu_hash", "tpu_hash_sharded"):
                raise ValueError(
                    f"TELEMETRY {self.TELEMETRY} is implemented by the "
                    "ring backends only (tpu_hash, tpu_hash_sharded; "
                    f"got BACKEND {self.BACKEND!r})")
            if self.resolved_exchange() != "ring":
                raise ValueError(
                    f"TELEMETRY {self.TELEMETRY} requires the ring "
                    "exchange (the scatter lowering keeps the default "
                    "program)")
        self._enum("PROBE_GATHER", ("packed", "split"))
        if self.CHECKPOINT_COMPRESS not in (0, 1):
            raise ValueError(
                f"CHECKPOINT_COMPRESS must be 0 or 1, got "
                f"{self.CHECKPOINT_COMPRESS!r}")
        if self.RESUME not in (0, 1):
            raise ValueError(f"RESUME must be 0 or 1, got {self.RESUME!r}")
        if self.RESUME and not (self.CHECKPOINT_EVERY
                                and self.CHECKPOINT_DIR):
            raise ValueError(
                "RESUME: 1 requires CHECKPOINT_EVERY > 0 and a "
                "CHECKPOINT_DIR to resume from")
        self._validate_service_keys()
        for knob in ("FUSED_RECEIVE", "FUSED_GOSSIP", "FUSED_PROBE",
                     "FOLDED"):
            if getattr(self, knob) not in (-1, 0, 1):
                raise ValueError(f"{knob} must be 1 (on), 0 (off) or -1 "
                                 f"(auto), got {getattr(self, knob)!r}")
        if self.MEGA_TICKS < -1:
            raise ValueError(
                f"MEGA_TICKS must be -1 (auto), 0 (off) or a positive "
                f"ticks-per-block T, got {self.MEGA_TICKS!r}")
        if self.MEGA_TICKS > 0:
            # T-tick blocks tile the chunked segments of the ring steps.
            if self.BACKEND not in ("tpu_hash", "tpu_hash_sharded"):
                raise ValueError(
                    "MEGA_TICKS is implemented by the ring backends "
                    "only (tpu_hash, tpu_hash_sharded; got BACKEND "
                    f"{self.BACKEND!r})")
            if self.CHECKPOINT_EVERY <= 0:
                raise ValueError(
                    "MEGA_TICKS requires CHECKPOINT_EVERY > 0 (T-tick "
                    "blocks tile the chunked segments; the monolithic "
                    "scan has no block boundary to align to — "
                    "runtime/checkpoint.py)")
            if self.CHECKPOINT_EVERY % self.MEGA_TICKS != 0:
                raise ValueError(
                    f"MEGA_TICKS ({self.MEGA_TICKS}) must tile "
                    f"CHECKPOINT_EVERY ({self.CHECKPOINT_EVERY}): "
                    "K % T == 0, so block boundaries and segment "
                    "boundaries coincide (only the run's final tail "
                    "segment may be shorter than T)")
        if self.MEGA_PACK not in (-1, 0, 1):
            raise ValueError(
                f"MEGA_PACK must be 1 (on), 0 (off) or -1 (auto), got "
                f"{self.MEGA_PACK!r}")
        if self.MEGA_PACK == 1 and self.MEGA_TICKS == 0:
            raise ValueError(
                "MEGA_PACK: 1 requires MEGA_TICKS (the shrunk carry "
                "exists only at T-block boundaries)")
        if self.MESH_SHAPE:
            parts = self.MESH_SHAPE.lower().split("x")
            if not (1 <= len(parts) <= 3
                    and all(p.isdigit() and int(p) > 0 for p in parts)):
                raise ValueError(
                    f"MESH_SHAPE must be 'D', 'OxI' or 'SxOxI' (positive "
                    f"ints; 3-D = multi-slice torus, outermost axis over "
                    f"DCN), got {self.MESH_SHAPE!r}")
            if self.BACKEND != "tpu_hash_sharded":
                raise ValueError(
                    "MESH_SHAPE is only supported by BACKEND "
                    f"tpu_hash_sharded (got {self.BACKEND!r})")
        if self.JOIN_MODE == "warm" and self.BACKEND not in (
                "tpu_sparse", "tpu_hash", "tpu_hash_sharded"):
            raise ValueError(
                f"JOIN_MODE warm is not supported by BACKEND {self.BACKEND!r}")
        if 2 * self.TOTAL_TIME >= 2**31:
            raise ValueError("TOTAL_TIME too large for int32 heartbeats")
        if (self.PROBES > 0 and self.VIEW_SIZE > 0
                and self.BACKEND in ("tpu_sparse", "tpu_hash",
                                     "tpu_hash_sharded")):
            cycle = -(-self.VIEW_SIZE // self.PROBES)
            if self.TREMOVE < 4 * cycle:
                raise ValueError(
                    f"TREMOVE={self.TREMOVE} spans under 4 probe cycles "
                    f"(cycle = ceil(VIEW_SIZE/PROBES) = {cycle} ticks): "
                    "too few refresh chances per removal window; raise "
                    "TREMOVE or PROBES")
            k_min = self.min_tremove_cycles_under_loss()
            if k_min and self.TREMOVE < k_min * cycle:
                warnings.warn(
                    f"TREMOVE={self.TREMOVE} spans under {k_min} probe "
                    f"cycles (cycle={cycle}) at drop probability "
                    f"{self.effective_drop_prob()}: expected false removals "
                    "> 0 over this run", stacklevel=2)

    def _validate_service_keys(self) -> None:
        """The JAX gates of the service, fleet and watchdog keys."""
        if not -1 <= self.SERVICE_PORT <= 65535:
            raise ValueError(
                f"SERVICE_PORT must be -1 (off), 0 (ephemeral) or a "
                f"port in 1..65535, got {self.SERVICE_PORT}")
        if self.SERVICE_PORT >= 0:
            if self.CHECKPOINT_EVERY <= 0:
                raise ValueError(
                    "SERVICE_PORT requires CHECKPOINT_EVERY > 0 (the "
                    "control plane serves between scan segments — "
                    "runtime/checkpoint.py)")
            if self.BACKEND not in ("tpu_hash", "tpu_hash_sharded"):
                raise ValueError(
                    "SERVICE_PORT is implemented by the ring-family "
                    "backends only (tpu_hash, tpu_hash_sharded; got "
                    f"BACKEND {self.BACKEND!r})")
            if self.FOLDED == 1:
                raise ValueError(
                    "SERVICE_PORT and FOLDED are incompatible (the "
                    "folded plane carry is not decodable by the "
                    "service snapshot reader; leave FOLDED on auto, "
                    "which keeps it off under the service)")
        if self.SERVICE_SNAPSHOT_EVERY < 1:
            raise ValueError(
                f"SERVICE_SNAPSHOT_EVERY must be >= 1 segment "
                f"boundaries, got {self.SERVICE_SNAPSHOT_EVERY}")
        if self.SERVICE_WORKERS < 0:
            raise ValueError(
                f"SERVICE_WORKERS must be >= 0 replica processes, got "
                f"{self.SERVICE_WORKERS}")
        if self.SERVICE_WORKERS > 0 and self.SERVICE_PORT < 0:
            raise ValueError(
                "SERVICE_WORKERS requires the control plane "
                "(SERVICE_PORT >= 0): the serve daemon publishes the "
                "shm ring the replicas read")
        if self.SERVICE_SHM_BUFFERS < 2:
            raise ValueError(
                f"SERVICE_SHM_BUFFERS must be >= 2 ring slots (the "
                f"seqlock needs a stable slot while the writer fills "
                f"another), got {self.SERVICE_SHM_BUFFERS}")
        if not -1 <= self.FLEET_PORT <= 65535:
            raise ValueError(
                f"FLEET_PORT must be -1 (off), 0 (ephemeral) or a "
                f"port in 1..65535, got {self.FLEET_PORT}")
        if self.FLEET_MAX_CONCURRENCY < 1:
            raise ValueError(
                f"FLEET_MAX_CONCURRENCY must be >= 1 worker, got "
                f"{self.FLEET_MAX_CONCURRENCY}")
        if self.FLEET_LINGER not in (0, 1):
            raise ValueError(
                f"FLEET_LINGER must be 0 or 1, got {self.FLEET_LINGER!r}")
        if self.FLEET_MIGRATE_ON:
            bad = [t for t in
                   (p.strip() for p in self.FLEET_MIGRATE_ON.split(","))
                   if t not in ("death", "alerts", "stale-beacon")]
            if bad:
                raise ValueError(
                    f"FLEET_MIGRATE_ON must be a comma list drawn from "
                    f"'death', 'alerts', 'stale-beacon', got {bad!r} in "
                    f"{self.FLEET_MIGRATE_ON!r}")
        if self.FLEET_MIGRATE_MAX < 0:
            raise ValueError(
                f"FLEET_MIGRATE_MAX must be >= 0 automatic migrations "
                f"per run (0 = manual only), got {self.FLEET_MIGRATE_MAX!r}")
        if self.WATCHDOG not in (0, 1):
            raise ValueError(
                f"WATCHDOG must be 0 or 1, got {self.WATCHDOG!r}")

    def min_tremove_cycles_under_loss(self) -> int:
        """Smallest TREMOVE, in probe cycles, keeping the union bound on
        false removals under 0.01 (JAX ``config.py`` derivation)."""
        p = self.effective_drop_prob()
        if p <= 0 or self.PROBES <= 0 or self.VIEW_SIZE <= 0:
            return 0
        cycle = -(-self.VIEW_SIZE // self.PROBES)
        window = min(self.DROP_STOP, self.TOTAL_TIME) - max(
            self.DROP_START, 0)
        if window <= 0:
            return 0
        q = 1.0 - (1.0 - p) ** 2
        cap = window // cycle + 1
        if q >= 1.0:
            return max(4, cap)
        trials = self.EN_GPSZ * self.VIEW_SIZE * max(window // cycle, 1)
        k = max(4, math.ceil(math.log(trials / 0.01) / -math.log(q)))
        return min(k, cap)

    def drop_pct(self) -> int:
        """Integer drop percentage, quantized once (EmulNet.cpp:92)."""
        return int(self.MSG_DROP_PROB * 100) if self.DROP_MSG else 0

    def effective_drop_prob(self) -> float:
        return self.drop_pct() / 100.0

    def validate_sparse_packing(self, total_time: int | None = None) -> None:
        """Reject runs whose packed u32 ``hb * N + id + 1`` overflows
        (heartbeats reach ``2 * total + 2``)."""
        total = self.TOTAL_TIME if total_time is None else total_time
        if (2 * total + 2) * self.EN_GPSZ + self.EN_GPSZ >= 2**32:
            raise ValueError(
                f"MAX_NNB={self.EN_GPSZ} x total_time={total} overflows "
                "the uint32 (heartbeat, id) packing; reduce the run length "
                "or node count")

    def resolved_event_mode(self) -> str:
        if self.EVENT_MODE != "auto":
            return self.EVENT_MODE
        return "full" if self.EN_GPSZ <= 4096 else "agg"

    def resolved_exchange(self) -> str:
        if self.EXCHANGE != "auto":
            return self.EXCHANGE
        scale_run = (self.JOIN_MODE == "warm" and self.VIEW_SIZE > 0
                     and self.VIEW_SIZE < self.EN_GPSZ
                     and self.PROBES < max(self.VIEW_SIZE, 1))
        return "ring" if scale_run else "scatter"

    def start_tick(self, i: int) -> int:
        """Tick at which node index i is introduced (Application.cpp:143)."""
        if self.JOIN_MODE == "warm":
            return -1
        if self.JOIN_MODE == "batch":
            return 0
        return int(self.STEP_RATE * i)

    @classmethod
    def from_file(cls, path: str, validate: bool = True) -> "Params":
        with open(path) as fh:
            return cls().parse(fh.read(), validate=validate)

    @classmethod
    def from_text(cls, text: str) -> "Params":
        return cls().parse(text)
