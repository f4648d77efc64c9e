"""The dbg.log / stats.log contract (the JAX package's ``eventlog.py``).

Byte format of the reference's Log.cpp: the first line is the magic
number ``131`` (hex char sum of "CS425"); every entry is
``"\\n <addr> [<time>] <message>"`` with a leading space; messages
prefixed ``#STATSLOG#`` go to stats.log.  Graders grep these lines, so
the format is load-bearing.
"""

from __future__ import annotations

import os
from typing import List, Optional

from distributed_membership_tpu_torch.addressing import addr_str

MAGIC_SOURCE = "CS425"
DBG_LOG = "dbg.log"
STATS_LOG = "stats.log"
STATS_PREFIX = "#STATSLOG#"


def magic_line() -> str:
    return format(sum(ord(c) for c in MAGIC_SOURCE), "x")


class EventLog:
    """In-memory accumulator for the dbg.log / stats.log channels."""

    def __init__(self, directory: str = "."):
        self.directory = directory
        self._dbg: List[str] = []
        self._stats: List[str] = []

    def log(self, node_id: int, time: int, message: str, port: int = 0) -> None:
        if not self._dbg:
            self._dbg.append(magic_line() + "\n")
        entry = f"\n {addr_str(node_id, port)} [{time}] {message}"
        (self._stats if message.startswith(STATS_PREFIX)
         else self._dbg).append(entry)

    def node_add(self, logger_id: int, added_id: int, time: int) -> None:
        self.log(logger_id, time,
                 f"Node {addr_str(added_id)} joined at time {time}")

    def node_remove(self, logger_id: int, removed_id: int, time: int) -> None:
        self.log(logger_id, time,
                 f"Node {addr_str(removed_id)} removed at time {time}")

    def node_failed_single(self, failed_id: int, time: int) -> None:
        self.log(failed_id, time, f"Node failed at time={time}")

    def node_failed_multi(self, failed_id: int, time: int) -> None:
        self.log(failed_id, time, f"Node failed at time = {time}")

    def dbg_text(self) -> str:
        return "".join(self._dbg)

    def stats_text(self) -> str:
        return "".join(self._stats)

    def flush(self, directory: Optional[str] = None) -> str:
        """Write dbg.log and stats.log; returns the dbg.log path."""
        directory = directory or self.directory
        os.makedirs(directory, exist_ok=True)
        dbg_path = os.path.join(directory, DBG_LOG)
        with open(dbg_path, "w") as fh:
            fh.write(self.dbg_text())
        with open(os.path.join(directory, STATS_LOG), "w") as fh:
            fh.write(self.stats_text())
        return dbg_path
