"""Submit a sweep grid to a running fleet controller (counterpart of
the JAX package's ``sweeps/fleet_submit.py``).

The phase sweep (the JAX package's sweeps/phase.py) runs a whole grid
through one batched step -- the right shape when every cell shares a step
function.  This is the other sweep shape: cells that are FULL runs (different confs,
scenarios, seeds), fanned out to ``--fleet``'s bounded scheduler over
plain HTTP and multiplexed behind one control plane instead of N loose
processes.  Stdlib only, like everything in the serving stack.

    python -m distributed_membership_tpu_torch.sweeps.fleet_submit \
        --port 8800 base.conf --set MSG_DROP_PROB=0.0,0.1,0.2 \
        --seeds 1,2 --wait

builds the cross product (3 drop rates x 2 seeds = 6 runs), submits
each as ``<stem>-<KEY>-<value>-s<seed>``, and with ``--wait`` polls
``GET /v1/runs`` until every submitted run reaches a terminal state
(exit 0 only if all are ``done``).

``--scenario-dir DIR`` crosses the grid with every ``*.json`` chaos
schedule in DIR, shipped inline in the submission body (the chaos
campaign fan-out builds on these helpers).
Transient 502s from the fleet proxy retry with exponential backoff.
"""

from __future__ import annotations

import argparse
import http.client
import itertools
import json
import os
import re
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

TERMINAL = ("done", "failed", "killed")


def override_conf(conf_text: str, key: str, value) -> str:
    """``conf_text`` with ``KEY: value`` replaced (or appended)."""
    pat = re.compile(rf"^\s*{re.escape(key)}\s*:.*$", re.MULTILINE)
    line = f"{key}: {value}"
    if pat.search(conf_text):
        return pat.sub(line, conf_text)
    if conf_text and not conf_text.endswith("\n"):
        conf_text += "\n"
    return conf_text + line + "\n"


def grid(conf_text: str, axes: Dict[str, Sequence],
         seeds: Sequence[int] = (None,),
         stem: str = "cell") -> List[dict]:
    """Cross product of conf overrides x seeds -> submission bodies.

    Each body is exactly what ``POST /v1/runs`` takes; run ids encode
    the cell coordinates (``stem-KEY-value-sN``) so a fleet listing
    reads as the sweep grid."""
    keys = sorted(axes)
    subs = []
    for combo in itertools.product(*(axes[k] for k in keys)):
        conf = conf_text
        rid = stem
        for k, v in zip(keys, combo):
            conf = override_conf(conf, k, v)
            rid += f"-{k}-{v}".replace(".", "p")
        for seed in seeds:
            body = {"conf": conf, "run_id": (rid if seed is None
                                             else f"{rid}-s{seed}")}
            if seed is not None:
                body["seed"] = int(seed)
            subs.append(body)
    return subs


def scenario_dir_subs(subs: List[dict], scenario_dir: str) -> List[dict]:
    """Cross ``subs`` with every ``*.json`` scenario in a directory.

    Each scenario payload rides the submission inline (the scheduler
    writes it to the run dir and hands the worker ``--scenario``), so a
    directory of fuzzer output fans out without any
    shared-filesystem assumption between submitter and workers."""
    paths = sorted(p for p in os.listdir(scenario_dir)
                   if p.endswith(".json"))
    if not paths:
        raise ValueError(f"no *.json scenarios in {scenario_dir!r}")
    out = []
    for body in subs:
        for p in paths:
            with open(os.path.join(scenario_dir, p)) as fh:
                payload = json.load(fh)
            stem = os.path.splitext(p)[0]
            out.append(dict(body, scenario=payload,
                            run_id=f"{body['run_id']}-{stem}"))
    return out


def _req(port: int, method: str, path: str,
         body: Optional[dict] = None,
         timeout: float = 30.0,
         retries: int = 0, backoff: float = 0.25) -> Tuple[int, dict]:
    """One HTTP round trip; a 502 from the fleet proxy (upstream worker
    briefly unreachable — restart, resume, overloaded accept queue) is
    TRANSIENT and retried with exponential backoff when ``retries`` > 0.
    Anything else — including connection errors, which mean the
    controller itself is gone — stays loud."""
    attempt = 0
    while True:
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=timeout)
        try:
            conn.request(
                method, path,
                body=None if body is None else json.dumps(body),
                headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            status, obj = resp.status, json.loads(resp.read() or b"{}")
        finally:
            conn.close()
        if status != 502 or attempt >= retries:
            return status, obj
        time.sleep(backoff * (2 ** attempt))
        attempt += 1


def submit_grid(port: int, subs: List[dict],
                priority: int = 0, retries: int = 5) -> List[dict]:
    """POST every cell; raises on the first refusal (a refused cell
    means the grid itself is malformed — better loud than partial).
    Transient 502s retry with backoff so a proxy hiccup mid-grid does
    not strand a half-submitted sweep."""
    acks = []
    for body in subs:
        body = dict(body, priority=priority)
        code, obj = _req(port, "POST", "/v1/runs", body=body,
                         retries=retries)
        if code != 202:
            raise RuntimeError(f"fleet refused {body.get('run_id')}: "
                               f"{obj.get('error', obj)}")
        acks.append(obj)
    return acks


def wait_grid(port: int, run_ids: Sequence[str],
              timeout: float = 3600.0,
              poll: float = 0.5) -> Dict[str, dict]:
    """Poll the listing until every run is terminal; -> {id: row}."""
    want = set(run_ids)
    deadline = time.monotonic() + timeout
    while True:
        code, obj = _req(port, "GET", "/v1/runs")
        rows = {r["run_id"]: r for r in obj.get("runs", [])
                if r["run_id"] in want}
        if (code == 200 and len(rows) == len(want)
                and all(r["state"] in TERMINAL
                        for r in rows.values())):
            return rows
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"grid not terminal after {timeout}s: "
                f"{ {k: v['state'] for k, v in rows.items()} }")
        time.sleep(poll)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fan a conf grid out to a --fleet controller")
    ap.add_argument("conf", help="base .conf file for every cell")
    ap.add_argument("--port", type=int, required=True,
                    help="fleet controller port (see its fleet.json)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=V1,V2,...",
                    help="sweep axis: comma-separated values for one "
                         "conf key (repeatable; axes cross-multiply)")
    ap.add_argument("--seeds", default=None,
                    help="comma-separated seeds (one run per seed per "
                         "cell)")
    ap.add_argument("--stem", default=None,
                    help="run-id prefix (default: conf file stem)")
    ap.add_argument("--scenario-dir", default=None,
                    help="submit every *.json scenario in this "
                         "directory inline (one run per grid cell per "
                         "scenario — chaos campaign fan-out)")
    ap.add_argument("--priority", type=int, default=0,
                    help="queue priority for the whole grid (lower "
                         "dispatches first)")
    ap.add_argument("--wait", action="store_true",
                    help="block until every run is terminal; exit 0 "
                         "only if all are done")
    args = ap.parse_args(argv)

    with open(args.conf) as fh:
        conf_text = fh.read()
    axes: Dict[str, list] = {}
    for spec in args.set:
        key, _, vals = spec.partition("=")
        if not vals:
            ap.error(f"--set {spec!r}: expected KEY=V1,V2,...")
        axes[key.strip()] = [v.strip() for v in vals.split(",") if
                             v.strip()]
    seeds: Sequence = (None,)
    if args.seeds:
        seeds = [int(s) for s in args.seeds.split(",")]
    stem = args.stem or os.path.splitext(
        os.path.basename(args.conf))[0]
    subs = grid(conf_text, axes, seeds=seeds, stem=stem)
    if args.scenario_dir:
        subs = scenario_dir_subs(subs, args.scenario_dir)
    acks = submit_grid(args.port, subs, priority=args.priority)
    for ack in acks:
        print(f"fleet_submit: {ack['run_id']} -> {ack['state']} "
              f"({ack['mode']})")
    if not args.wait:
        return 0
    rows = wait_grid(args.port, [a["run_id"] for a in acks])
    bad = 0
    for rid in sorted(rows):
        row = rows[rid]
        print(f"fleet_submit: {rid} {row['state']} "
              f"tick {row['tick']}/{row['total']}")
        bad += row["state"] != "done"
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
