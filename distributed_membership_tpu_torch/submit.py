"""Submission client: the reference ``submit.py`` protocol, python-3,
offline-first (the JAX package's ``scripts/submit.py``, on the port: the
same form payloads).

The reference ships a Python-2 Coursera uploader (reference submit.py:26-134):
prompt for login + one-time password, pick a part (mp1_part1..3 ↔ the three
grading scenarios, submit.py:155-157), fetch a challenge
(``email|…|ch|…|state|…|ch_aux`` pipe-delimited, submit.py:83-97), answer it
with ``sha1(challenge + password)`` (submit.py:99-106), then POST a form with
the base64-encoded ``dbg.log`` as ``submission``/``submission_aux``
(submit.py:116-134).  The endpoint is long dead, and this rebuild's runtime
environment has no egress — so the faithful part here is the PROTOCOL, not
the transport:

* default: run the chosen scenario on the chosen backend, build the
  submission form payload, and write it to ``submission_<part>.json``
  (plus the challenge-request payload).  The challenge/state/
  challenge_response fields are STAND-INS (a live submission redoes the
  challenge leg and recomputes the response against the server's fresh
  challenge); everything else is exactly what a grading server would
  receive;
* ``--endpoint http://…``: POST the same two requests (challenge, then
  submit) to a live self-hosted grader that speaks the Coursera form
  protocol.

Usage:
  python -m distributed_membership_tpu_torch.submit --part 1 \
      --backend tpu_hash --email you@example.org \
      --password <one-time-pw> --out-dir /tmp/sub

``--device`` defaults to ``cuda``; without a card the run raises rather
than running on the CPU.
"""

from __future__ import annotations

import argparse
import base64
import getpass
import hashlib
import json
import os
import sys
import time
from urllib.parse import urlencode
from urllib.request import Request, urlopen

# Part identifiers and friendly names, byte-identical to reference
# submit.py:155-157.
PART_IDS = ["mp1_part1", "mp1_part2", "mp1_part3"]
PART_NAMES = ["Single Failure", "Multiple Failure",
              "Message Drop Single Failure"]
SCENARIO_BY_PART = ["singlefailure", "multifailure", "msgdropsinglefailure"]


def challenge_response(password: str, challenge: str) -> str:
    """``sha1(challenge + password)`` hex digest — reference submit.py:99-106
    (the loop there rebuilds the hexdigest character by character; the
    result is just the digest)."""
    return hashlib.sha1((challenge + password).encode()).hexdigest()


def challenge_request_payload(email: str, part_sid: str) -> dict:
    """The challenge GET's form fields — reference submit.py:86."""
    return {"email_address": email, "assignment_part_sid": part_sid,
            "response_encoding": "delim"}


def parse_challenge(text: str):
    """Parse the pipe-delimited challenge reply into (email, ch, state,
    ch_aux) — reference submit.py:92-97 (9 fields, data at odd indices)."""
    splits = text.strip().split("|")
    if len(splits) != 9:
        raise ValueError(f"badly formatted challenge response: {text!r}")
    return splits[2], splits[4], splits[6], splits[8]


def submission_payload(email: str, part_sid: str, dbg_log: bytes,
                       ch_resp: str, state: str) -> dict:
    """The submit POST's form fields — reference submit.py:116-127: the
    graded artifact is dbg.log, base64-encoded, sent as both
    ``submission`` and ``submission_aux``."""
    b64 = base64.encodebytes(dbg_log).decode()
    return {"assignment_part_sid": part_sid,
            "email_address": email,
            "submission": b64,
            "submission_aux": b64,
            "challenge_response": ch_resp,
            "state": state}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_membership_tpu_torch.submit")
    ap.add_argument("--part", type=int, required=True,
                    help="1..3: " + ", ".join(PART_NAMES))
    ap.add_argument("--backend", default="emul")
    ap.add_argument("--email", required=True)
    ap.add_argument("--password", default=None,
                    help="one-time password (challenge-response secret); "
                         "prompted interactively when omitted so it stays "
                         "out of shell history / ps — the reference's "
                         "prompt behavior (submit.py:66-71)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--endpoint", default=None,
                    help="base URL of a live form-protocol grader; "
                         "default writes the payloads offline")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if not 1 <= args.part <= 3:
        ap.error("--part must be 1..3")
    if args.password is None and args.endpoint:
        # Only a live submission needs the credential; the offline
        # artifact never uses it (challenge_response is a stand-in).
        args.password = getpass.getpass("One-time Password: ")
    part_sid = PART_IDS[args.part - 1]
    scenario = SCENARIO_BY_PART[args.part - 1]

    from distributed_membership_tpu_torch.runtime.application import (
        default_testcases_dir, resolve_device, run_scenario_graded)

    testdir = default_testcases_dir()
    resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    run_dir = os.path.join(args.out_dir, part_sid)
    os.makedirs(run_dir, exist_ok=True)
    print(f"== Submitting: {PART_NAMES[args.part - 1]} "
          f"({part_sid}) on backend {args.backend}")
    _, grade = run_scenario_graded(scenario, testdir, args.backend,
                                   args.seed, run_dir, device=args.device)
    summary = {"points": grade.points, "max": grade.max_points}
    with open(os.path.join(run_dir, "dbg.log"), "rb") as fh:
        dbg_log = fh.read()

    def post(path: str, fields: dict) -> str:
        req = Request(f"{args.endpoint}{path}", urlencode(fields).encode())
        return urlopen(req).read().decode()

    ch_payload = challenge_request_payload(args.email, part_sid)
    if args.endpoint:
        _, ch, state, _aux = parse_challenge(
            post("/assignment/challenge", ch_payload))
    else:
        # Offline: stand-in challenge/state mark the payload as built
        # without a live handshake.  A later live submission must redo
        # the challenge leg (the response binds to the server's fresh
        # challenge) — the saved artifact documents WHAT would be sent,
        # it is not a replayable credential.
        ch, state = "offline-challenge", "offline-state"
    # Only bind the password digest to a LIVE server challenge: an
    # offline artifact carrying sha1(known-string + password) would be
    # offline-crackable password material despite not being replayable.
    ch_resp = (challenge_response(args.password, ch) if args.endpoint
               else "not-computed-offline")
    payload = submission_payload(
        args.email, part_sid, dbg_log, ch_resp, state)

    if args.endpoint:
        print("==", post("/assignment/submit", payload).strip())
    else:
        out = os.path.join(args.out_dir, f"submission_{part_sid}.json")
        with open(out, "w") as fh:
            json.dump({"challenge_request": ch_payload,
                       "submit_request": payload,
                       "grade": summary,
                       "timestamp": time.strftime(
                           "%Y-%m-%dT%H:%M:%SZ", time.gmtime())},
                      fh, indent=1)
        print(f"== offline submission payload written: {out} "
              f"(score {summary['points']}/{summary['max']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
