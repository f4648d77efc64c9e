"""The port's fleet controller with real workers, on the CPU at N=16:
the concurrency cap, the byte-identical prefix proxy, and a worker that
finds no card.

Mirrors ``tests/test_fleet.py``'s ``test_scheduler_honors_max_concurrency``
and ``test_prefix_proxies_single_run_surface_byte_identically`` (with
ring confs: the port has no ``emul`` backend), and adds the port's own
rule that a worker never falls back to the CPU.  The helpers are
``tests/test_torch_fleet_e2e.py``'s (pytest puts ``tests/`` on the
path).
"""

import json
import os
import time

import pytest
import torch

from test_torch_fleet_e2e import (WAIT_S, bytes_of, hash_conf, jax_logs,
                                  jget, listing, req, start_fleet,
                                  stop_fleet, submit, wait_states,
                                  worker_pids)

from distributed_membership_tpu_torch.sweeps import fleet_submit


def test_scheduler_honors_max_concurrency(tmp_path):
    """Limit 2, 4 submitted through the sweep client: never more than 2
    workers alive, from the runs listing and from the process table,
    and the cap binds (a run queued while 2 run) before all are done;
    each run's dbg.log is the JAX package's for its cell."""
    root = str(tmp_path / "fleet")
    os.makedirs(root)
    proc, port = start_fleet(root, max_concurrency=2)
    try:
        subs = fleet_submit.grid(hash_conf(150), {"FAIL_TIME": [40, 50]},
                                 seeds=(1, 2), stem="c")
        assert len(subs) == 4
        acks = fleet_submit.submit_grid(port, subs)
        ids = [a["run_id"] for a in acks]
        assert all(a["mode"] == "serve" for a in acks)
        max_running = max_procs = 0
        cap_bound = False
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            runs = listing(port)
            states = [r["state"] for r in runs.values()]
            running = states.count("running")
            max_running = max(max_running, running)
            max_procs = max(max_procs, len(worker_pids(root)))
            if running == 2 and "queued" in states:
                cap_bound = True
            if all(s == "done" for s in states):
                break
            time.sleep(0.05)
        runs = listing(port)
        assert all(r["state"] == "done" for r in runs.values()), runs
        assert max_running <= 2, f"listing saw {max_running} running"
        assert max_procs <= 2, f"process table saw {max_procs} workers"
        assert cap_bound, "cap never bound (runs too fast to overlap?)"
        rows = fleet_submit.wait_grid(port, ids, timeout=30)
        assert all(r["state"] == "done" for r in rows.values())
        code, summary = jget(port, "/v1/fleet/summary")
        assert code == 200
        assert summary["aggregate"]["states"] == {"done": 4}
        assert all(r["live"] is not None for r in summary["runs"])
    finally:
        stop_fleet(proc, port)
    for sub in subs[:2]:
        want = jax_logs(tmp_path / sub["run_id"], sub["conf"], sub["seed"])
        assert bytes_of(os.path.join(root, sub["run_id"], "dbg.log")) \
            == want["dbg.log"], sub["run_id"]


def test_prefix_proxies_single_run_surface_byte_identically(tmp_path):
    """FLEET_LINGER keeps a finished worker serving its final snapshot:
    every endpoint answers byte-identically via the /v1/runs/<id>/ prefix
    and via the worker's own port."""
    root = str(tmp_path)
    proc, port = start_fleet(root, max_concurrency=1, linger=True)
    try:
        submit(port, hash_conf(120), "p0")
        runs = wait_states(port, {"p0": {"done"}})
        wport = runs["p0"].get("port")
        assert wport, "lingering worker published no port"
        for path in ("/v1/census", "/v1/member/3", "/v1/timeline",
                     "/v1/timeline?from=5", "/v1/nonexistent"):
            direct = req(wport, "GET", path)
            proxied = req(port, "GET", "/v1/runs/p0" + path)
            assert direct == proxied, path

        def strip(resp):
            code, raw = resp
            doc = json.loads(raw)
            doc.pop("queries_served", None)
            doc.pop("snapshot_age_s", None)
            return code, doc
        assert strip(req(wport, "GET", "/healthz")) == \
            strip(req(port, "GET", "/v1/runs/p0/healthz"))
        body = {"kind": "crash", "time": 70, "nodes": [3]}
        direct = req(wport, "POST", "/v1/events", body=body)
        proxied = req(port, "POST", "/v1/runs/p0/v1/events", body=body)
        assert direct == proxied and direct[0] == 409
        code, obj = req(port, "POST", "/v1/runs/p0/kill")
        assert code == 202 and json.loads(obj)["stopped_linger"]
        wait_states(port, {"p0": {"done"}})
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            code, _ = req(port, "GET", "/v1/runs/p0/healthz")
            if code == 409:
                break
            time.sleep(0.1)
        assert code == 409
        code, obj = jget(port, "/v1/runs/p0/v1/timeline")
        assert code == 200 and obj["rows"]
    finally:
        stop_fleet(proc, port)


def test_worker_without_a_card_fails(tmp_path):
    """A fleet started without ``--device`` runs its workers on the card;
    where there is none (this CPU), the worker fails at its device check
    and the fleet journals it ``failed`` with the error in its log tail
    -- it never runs the conf on the CPU.  A ``FLEET_PORT`` key in the
    run's conf changes nothing (only ``--fleet`` reads it)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the worker runs there "
                    "(chip_smoke.py's fleet phase drives that case)")
    root = str(tmp_path)
    proc, port = start_fleet(root, max_concurrency=1, device=None)
    try:
        info = json.load(open(os.path.join(root, "fleet.json")))
        assert info["device"] == "cuda"
        submit(port, hash_conf(60) + "FLEET_PORT: 0\n", "nocard")
        runs = wait_states(port, {"nocard": {"failed"}})
        assert runs["nocard"]["exit_code"] != 0
        assert "torch.cuda.is_available() is false" in \
            runs["nocard"]["error"]
        assert not os.path.exists(os.path.join(root, "nocard", "dbg.log"))
    finally:
        stop_fleet(proc, port)
