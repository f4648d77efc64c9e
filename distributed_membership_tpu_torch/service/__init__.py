"""Membership control plane (counterpart of the JAX package's
``service/``): a live query/inject service driving the tick engine.

``python -m distributed_membership_tpu_torch run.conf --checkpoint-every
K --serve [--port P] [--device cpu]`` keeps the ``CHECKPOINT_EVERY``-tick
segment loop (runtime/checkpoint.py) ticking on the card while a
stdlib-only threaded HTTP API answers liveness queries and accepts live
fault injection.  Between segments the daemon

  * publishes a host :class:`~snapshot.Snapshot` (live/suspected/removed
    masks, heartbeat staleness, census, current tick) from six carry
    fields copied off the device -- queries are answered from the
    snapshot in O(1) per member and never touch device state;
  * drains a command queue of injected scenario events (validated by
    scenario/schema.py, journaled to ``service_events.jsonl`` so
    ``RESUME`` replays them, compiled with the base schedule into the
    NEXT segment's runner);
  * hands control back to the device for the next segment.

Kill the daemon, restart with ``--resume``, and the trajectory (dbg.log,
timeline.jsonl, grader verdicts, pending injected events) is bit-exact
against an uninterrupted run, and against the JAX package's served run.
"""

from distributed_membership_tpu_torch.service.snapshot import (  # noqa: F401
    Snapshot, SnapshotStore, decode_state)
from distributed_membership_tpu_torch.service.daemon import (  # noqa: F401
    serve_conf, serve_run)
