"""The structured run log (counterpart of the JAX package's
``observability/runlog.py``): one JSONL event stream, every record
``{"ts": <iso8601Z>, "t_mono": <s>, "kind": <event>, ...}``.

``chunked_run`` (runtime/checkpoint.py) is its producer in the port:
``segments_start``, one ``segment`` per boundary (device-sync, flush and
checkpoint-write-wait seconds), ``interrupted`` on a graceful stop and
``segments_done``, in ``<TELEMETRY_DIR>/runlog.jsonl``, with the JAX
package's field names, so ``scripts/run_report.py`` reads either
package's file.

The log rotates by size (``path`` -> ``path.1`` -> ... ``path.<keep>``),
and every append is one ``write`` of one line, so a crash tears at most
the last record, which :func:`read_events` skips.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional


class RunLog:
    """Append-only rotating JSONL event log."""

    def __init__(self, path: str, max_bytes: int = 4 << 20, keep: int = 2):
        self.path = path
        self.max_bytes = max_bytes
        self.keep = max(keep, 1)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def _rotate_if_needed(self) -> None:
        try:
            if os.path.getsize(self.path) < self.max_bytes:
                return
        except OSError:
            return
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")

    def _tail_unterminated(self) -> bool:
        """True when the file ends mid-line (an earlier writer died while
        appending): the next record then starts on a fresh line."""
        try:
            with open(self.path, "rb") as fh:
                fh.seek(-1, os.SEEK_END)
                return fh.read(1) != b"\n"
        except (OSError, ValueError):
            return False

    def event(self, kind: str, **fields) -> dict:
        """Append one event; returns the record (with its timestamps)."""
        rec = {"ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
               "t_mono": round(time.monotonic(), 3),
               "kind": kind}
        rec.update(fields)
        self._rotate_if_needed()
        lead = "\n" if self._tail_unterminated() else ""
        with open(self.path, "a") as fh:
            fh.write(lead + json.dumps(rec, default=str) + "\n")
        return rec


def read_events(path: str, kinds=None,
                include_rotated: bool = True) -> List[dict]:
    """Parse a RunLog file, oldest first and rotated generations
    included; torn or non-JSON lines are skipped.  ``kinds`` filters by
    event kind."""
    paths = []
    if include_rotated:
        gen = 1
        while os.path.exists(f"{path}.{gen}"):
            paths.append(f"{path}.{gen}")
            gen += 1
        paths.reverse()
    if os.path.exists(path):
        paths.append(path)
    out = []
    for p in paths:
        with open(p) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if kinds is None or rec.get("kind") in kinds:
                    out.append(rec)
    return out


def maybe_runlog(directory: Optional[str],
                 name: str = "runlog.jsonl") -> Optional[RunLog]:
    """A RunLog under ``directory`` when one is given, else None.
    ``DM_RUNLOG_MAX_BYTES`` overrides the 4 MiB rotation threshold (0 =
    never rotate; a negative or unparsable value keeps the default)."""
    if not directory:
        return None
    max_bytes = 4 << 20
    env = os.environ.get("DM_RUNLOG_MAX_BYTES", "")
    if env:
        try:
            v = int(env)
            max_bytes = (1 << 62) if v == 0 else v if v > 0 else max_bytes
        except ValueError:
            pass
    return RunLog(os.path.join(directory, name), max_bytes=max_bytes)
