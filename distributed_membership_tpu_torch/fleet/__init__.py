"""Fleet controller (counterpart of the JAX package's ``fleet/``): one
control plane multiplexing many runs.

``python -m distributed_membership_tpu_torch --fleet [--device cuda|cpu]``
starts a stdlib-only daemon that owns a run registry (registry.py:
fsync-journaled to ``fleet_runs.jsonl`` before any submission is
acknowledged), a bounded-worker scheduler (scheduler.py: each run is the
port's chunked driver in a subprocess on the fleet's device, with its
own out, checkpoint and telemetry dirs) and an HTTP surface (daemon.py)
that proxies the whole single-run service API under ``/v1/runs/<id>/``
and adds the fleet's submit/list/pause/resume/kill/migrate/summary
endpoints.
"""
