"""Params: the ``.conf`` format shared with the JAX package, trimmed to
the keys the port reads.

The format is the reference's four legacy keys (``MAX_NNB``,
``SINGLE_FAILURE``, ``DROP_MSG``, ``MSG_DROP_PROB``, Params.cpp:22-25)
plus ``KEY: value`` extension lines.  Keys the port does not know are
ignored, as the reference's fscanf ignores them; keys it knows but does
not implement yet are refused by the backend (backends/tpu_hash.py).
Semantics and defaults match the JAX package's ``config.py``.
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
    # --- legacy keys (Params.cpp:22-25) ---
    MAX_NNB: int = 10
    SINGLE_FAILURE: int = 1
    DROP_MSG: int = 0
    MSG_DROP_PROB: float = 0.0
    # --- derived (Params.cpp:29-34) ---
    EN_GPSZ: int = 10
    STEP_RATE: float = 0.25
    # --- constants promoted from #defines ---
    TFAIL: int = 5
    TREMOVE: int = 20
    TOTAL_TIME: int = 700
    FANOUT: int = 5
    # --- extensions ---
    BACKEND: str = "emul"
    SEED: int = 0
    JOIN_MODE: str = "staggered"
    FAIL_TIME: int = 100
    DROP_START: int = 50
    DROP_STOP: int = 300
    VIEW_SIZE: int = 0
    GOSSIP_LEN: int = 0
    PROBES: int = 0
    RACK_SIZE: int = 0
    RACK_FAILURES: int = 0
    EVENT_MODE: str = "auto"
    EXCHANGE: str = "auto"
    FUSED_RECEIVE: int = -1
    FUSED_GOSSIP: int = -1
    FUSED_PROBE: int = -1
    PROBE_IO: str = "auto"
    PRNG_IMPL: str = "threefry2x32"
    RNG_MODE: str = "batched"
    MESH_SHAPE: str = ""        # tpu_hash_sharded: 'D', 'OxI' or 'SxOxI'
    EXCHANGE_MODE: str = "-1"   # tpu_hash_sharded: -1 (legacy) | legacy
    PROBE_GATHER: str = "packed"
    FOLDED: int = -1
    TELEMETRY: str = "off"      # off | scalars | hist (the flight recorder)
    TELEMETRY_DIR: str = ""     # where timeline.jsonl goes; '' = memory only
    # Keys of later slices: parsed only so the backend can refuse them.
    MEGA_TICKS: int = -1
    SHIFT_SET: int = 0
    ENFORCE_BUFFSIZE: int = 0
    CHECKPOINT_EVERY: int = 0
    SCENARIO: str = ""

    def parse(self, text: str, validate: bool = True) -> "Params":
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            m = re.match(r"([A-Za-z_][A-Za-z0-9_]*)\s*:\s*(.*)", line)
            if m:
                self._set(m.group(1), m.group(2).strip())
        self.EN_GPSZ = self.MAX_NNB
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

    def validate(self) -> None:
        """The JAX package's ``Params.validate`` checks for these keys."""
        if self.BACKEND not in _KNOWN_BACKENDS:
            raise ValueError(f"BACKEND must be one of {_KNOWN_BACKENDS}, "
                             f"got {self.BACKEND!r}")
        if self.EN_GPSZ < 1:
            raise ValueError("MAX_NNB must be >= 1")
        for key, allowed in (("EVENT_MODE", ("auto", "full", "agg")),
                             ("JOIN_MODE", ("staggered", "batch", "warm")),
                             ("EXCHANGE", ("auto", "scatter", "ring")),
                             ("EXCHANGE_MODE", ("-1", "legacy", "batched")),
                             ("PROBE_GATHER", ("packed", "split")),
                             ("PRNG_IMPL", ("threefry2x32", "rbg",
                                            "unsafe_rbg")),
                             ("PROBE_IO", ("auto", "exact", "approx",
                                           "approx_lag", "none")),
                             ("RNG_MODE", ("scattered", "batched",
                                           "hoisted")),
                             ("TELEMETRY", ("off", "scalars", "hist"))):
            if getattr(self, key) not in allowed:
                raise ValueError(f"{key} must be {'|'.join(allowed)}, got "
                                 f"{getattr(self, key)!r}")
        for knob in ("FUSED_RECEIVE", "FUSED_GOSSIP", "FUSED_PROBE",
                     "FOLDED"):
            if getattr(self, knob) not in (-1, 0, 1):
                raise ValueError(f"{knob} must be 1 (on), 0 (off) or -1 "
                                 f"(auto), got {getattr(self, knob)!r}")
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
        if self.EXCHANGE_MODE == "batched" and self.EXCHANGE == "scatter":
            raise ValueError(
                "EXCHANGE_MODE batched applies to the ring exchange's "
                "gossip shifts (EXCHANGE ring/auto); the scatter lowering "
                "has no per-shift collective round to batch")
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
