"""Chaos campaigns: seeded scenario fuzzing, oracle-gated sweeps,
auto-shrunk regression repros (counterpart of the JAX package's
``chaos/``).

  * :mod:`.fuzz` — the seeded fuzzer: a campaign spec (seed, schedule
    count, N, tick budget, event-mix weights) to random-but-valid
    scenario JSON, one ``ScenarioStatic`` per campaign; a copy of the JAX
    package's, byte for byte.
  * :mod:`.campaign` — the runner: schedules in this process on the card
    (or the CPU, ``device="cpu"``) or as fleet submissions
    (sweeps/fleet_submit.py), every run graded by the oracle's invariant
    verdicts and journaled into a torn-tolerant ``campaign.jsonl``.
  * :mod:`.shrink` — deterministic delta debugging of violating
    schedules down to a minimal repro, banked with its seed and campaign
    digest; a copy of the JAX package's.

CLI: ``python -m distributed_membership_tpu_torch.chaos --out DIR``.
"""

from distributed_membership_tpu_torch.chaos.fuzz import (      # noqa: F401
    CampaignSpec, campaign_digest, dump_schedule, fuzz_schedule,
    kind_counts, schedule_digest)
from distributed_membership_tpu_torch.chaos.campaign import (  # noqa: F401
    read_journal, run_campaign)
from distributed_membership_tpu_torch.chaos.shrink import (    # noqa: F401
    bank_repro, shrink_schedule)
