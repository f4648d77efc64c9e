"""Address model (the JAX package's ``addressing.py``): node index ``i``
has id ``i + 1``; an id renders as the reference's dotted little-endian
bytes with port 0 (Member.h:29-55, Log.cpp:73)."""

from __future__ import annotations


def addr_str(node_id: int, port: int = 0) -> str:
    """Dotted form of a packed little-endian id, e.g. 1 -> '1.0.0.0:0'."""
    b0 = node_id & 0xFF
    b1 = (node_id >> 8) & 0xFF
    b2 = (node_id >> 16) & 0xFF
    b3 = (node_id >> 24) & 0xFF
    return f"{b0}.{b1}.{b2}.{b3}:{port}"


def index_to_id(i: int) -> int:
    """Node index (0-based) to EmulNet-assigned id (1-based)."""
    return i + 1


INTRODUCER_INDEX = 0
INTRODUCER_ID = 1   # the introducer's id (Application::getjoinaddr)
