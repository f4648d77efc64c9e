"""The grading oracle of the reference's Grader_verbose.sh (the JAX
package's ``grader.py``, kept here as the port's own copy).

The reference grades a run by grepping dbg.log:

  * Join: 100 unique ``(logger, "Node <x> joined at")`` pairs
    (``cut -d" " -f2,4-7 | sort -u``), or the fallback: every one of the 10
    loggers has logged 9 *distinct other* nodes joined
    (Grader_verbose.sh:41-61);
  * Completeness (single failure): >= 9 unique ``removed`` lines naming the
    failed node (:62-69);
  * Accuracy (single failure): zero unique ``removed`` lines NOT naming the
    failed node (:70-77);
  * Multi failure: per failed node (first 5), >= 5 removal lines, 2 pts
    each; accuracy: exactly 20 unique removed lines not naming it, 2 pts
    each (:111-140);
  * Msg-drop scenario: join (15) + completeness (15); accuracy commented
    out (:153-181).

The checks keep the shell's string semantics (space-split fields,
substring matching, as its plain ``grep $addr``), so a log that passes
here passes the shell script and vice versa.  Scores sum to the
reference's 90-point scale.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List


def _unique(lines) -> List[str]:
    return sorted(set(lines))


def _fields(line: str) -> List[str]:
    # `cut -d" "` semantics: split on single spaces, 1-indexed, keep empties.
    return line.split(" ")


def _cut(line: str, idxs) -> str:
    f = _fields(line)
    return " ".join(f[i - 1] for i in idxs if i - 1 < len(f))


@dataclasses.dataclass
class ScenarioResult:
    scenario: str
    join_ok: bool
    completeness_pts: int
    completeness_max: int
    accuracy_pts: int
    accuracy_max: int
    join_pts: int
    join_max: int
    details: Dict[str, object]

    @property
    def points(self) -> int:
        return self.join_pts + self.completeness_pts + self.accuracy_pts

    @property
    def max_points(self) -> int:
        return self.join_max + self.completeness_max + self.accuracy_max

    @property
    def passed(self) -> bool:
        return self.points == self.max_points


def _check_join(lines: List[str], n_nodes: int) -> bool:
    joined = [l for l in lines if "joined" in l]
    pairs = _unique(_cut(l, [2, 4, 5, 6, 7]) for l in joined)
    if len(pairs) == n_nodes * n_nodes:
        return True
    # Fallback path (Grader_verbose.sh:46-55): each logger saw N-1 others.
    loggers = _unique(_cut(l, [2]) for l in joined)
    cnt = 0
    for logger in loggers:
        tos = _unique(
            _cut(l, [4, 5, 6, 7])
            for l in joined
            if l.startswith(" " + logger)
            and logger not in _cut(l, [4, 5, 6, 7])
        )
        if len(tos) == n_nodes - 1:
            cnt += 1
    return cnt == n_nodes


def _failed_addrs(lines: List[str]) -> List[str]:
    # `grep "Node failed at time" | sort -u | awk '{print $1}'`: sorted unique
    # full lines, then the first whitespace field (the logger == failed node).
    failed_lines = _unique(l for l in lines if "Node failed at time" in l)
    return [l.split()[0] for l in failed_lines]


def grade_single(dbg_text: str, n_nodes: int = 10, join_pts: int = 10,
                 fail_pts: int = 10, scenario: str = "singlefailure",
                 check_accuracy: bool = True) -> ScenarioResult:
    lines = dbg_text.splitlines()
    join_ok = _check_join(lines, n_nodes)
    failed = _failed_addrs(lines)
    removed = _unique(l for l in lines if "removed" in l)

    failcount = 0
    accuracycount = -1
    if failed:
        addr = failed[0]
        failcount = sum(1 for l in removed if addr in l)
        accuracycount = sum(1 for l in removed if addr not in l)

    comp_ok = failcount >= n_nodes - 1
    acc_ok = accuracycount == 0 and failcount > 0
    return ScenarioResult(
        scenario=scenario,
        join_ok=join_ok,
        join_pts=join_pts if join_ok else 0, join_max=join_pts,
        completeness_pts=fail_pts if comp_ok else 0, completeness_max=fail_pts,
        accuracy_pts=(fail_pts if acc_ok else 0) if check_accuracy else 0,
        accuracy_max=fail_pts if check_accuracy else 0,
        details={"failed": failed, "failcount": failcount,
                 "accuracycount": accuracycount,
                 "removed_lines": len(removed)},
    )


def grade_multi(dbg_text: str, n_nodes: int = 10) -> ScenarioResult:
    lines = dbg_text.splitlines()
    join_ok = _check_join(lines, n_nodes)
    failed = _failed_addrs(lines)
    removed = _unique(l for l in lines if "removed" in l)
    n_failed = max(len(failed), 1)
    n_survivors = n_nodes - n_failed

    # Completeness: 2 pts per failed node with >= n_survivors removal lines,
    # first 5 failed nodes only (Grader_verbose.sh:111-126).
    comp_pts = 0
    for addr in failed[:5]:
        if sum(1 for l in removed if addr in l) >= n_survivors:
            comp_pts += 2

    # Accuracy: 2 pts per failed node whose complement count is exactly
    # (total expected removals) - (its own removals) (=20 at N=10, :127-140).
    expected_complement = n_survivors * n_failed - n_survivors
    acc_pts = 0
    for addr in failed:
        if sum(1 for l in removed if addr not in l) == expected_complement:
            acc_pts += 2
        if acc_pts > 9:
            break
    acc_pts = min(acc_pts, 10)

    return ScenarioResult(
        scenario="multifailure",
        join_ok=join_ok,
        join_pts=10 if join_ok else 0, join_max=10,
        completeness_pts=comp_pts, completeness_max=10,
        accuracy_pts=acc_pts, accuracy_max=10,
        details={"failed": failed, "removed_lines": len(removed)},
    )


def grade_msgdrop(dbg_text: str, n_nodes: int = 10) -> ScenarioResult:
    # Join 15 + completeness 15, accuracy disabled (Grader_verbose.sh:153-189).
    r = grade_single(dbg_text, n_nodes, join_pts=15, fail_pts=15,
                     scenario="msgdropsinglefailure", check_accuracy=False)
    return r


SCENARIO_GRADERS = {
    "singlefailure": grade_single,
    "multifailure": grade_multi,
    "msgdropsinglefailure": grade_msgdrop,
}

