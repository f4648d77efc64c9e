"""msgcount.log writer (the JAX package's ``observability/metrics.py``),
in the reference's EmulNet.cpp:189-218 format, including its special
case of node 67.  Above ``MSGCOUNT_FULL_MATRIX_MAX`` nodes only the
per-node totals are written."""

from __future__ import annotations

import os

MSGCOUNT_FULL_MATRIX_MAX = 4096


def write_msgcount(result, out_dir: str = ".",
                   totals_only: bool | None = None) -> str:
    sent, recv = result.sent, result.recv
    n, total = sent.shape
    if totals_only is None:
        totals_only = n > MSGCOUNT_FULL_MATRIX_MAX
    path = os.path.join(out_dir, "msgcount.log")
    chunks = []
    for i in range(n):
        node_id = i + 1
        sent_total = int(sent[i].sum())
        recv_total = int(recv[i].sum())
        if not totals_only:
            chunks.append(f"node {node_id:3d} ")
            if node_id != 67:
                for j in range(total):
                    chunks.append(
                        f" ({int(sent[i, j]):4d}, {int(recv[i, j]):4d})")
                    if j % 10 == 9:
                        chunks.append("\n         ")
            else:
                for j in range(total):
                    chunks.append(f"special {j:4d} {int(sent[i, j]):4d} "
                                  f"{int(recv[i, j]):4d}\n")
            chunks.append("\n")
        chunks.append(f"node {node_id:3d} sent_total {sent_total:6d}  "
                      f"recv_total {recv_total:6d}\n\n")
    with open(path, "w") as fh:
        fh.write("".join(chunks))
    return path
