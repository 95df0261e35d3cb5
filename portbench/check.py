"""The comparison that decides ``correct``: the program's answers against the
reference's, on the same inputs, counted as mismatches.

Every number compared is a count of answers that differ, and every limit
is 0: the reference gives the one right answer for each status, each
session's events in order, each live session's result and, where the
traffic carries signatures, which frames' batches had to be blamed on the
host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LIMITS = {"status_mismatches": 0, "event_mismatches": 0, "result_mismatches": 0,
          "blame_mismatches": 0}


@dataclass
class Reading:
    """One side's answers over a run's calls."""

    votes: dict         # call -> one status a row (None: left open)
    proposals: dict     # call -> one status a proposal delivered
    events: list        # (proposal, result, timestamp), as taken off the bus
    finals: dict        # proposal -> its result at the end, live sessions
    blames: "dict | None" = None  # call -> host blames of its signature batch


def statuses(program: dict, reference: dict) -> int:
    """Rows, over every call, whose status differs (rows the reference
    leaves open, ``None``, are not compared)."""
    bad = 0
    for call, want in reference.items():
        got = program.get(call)
        want_arr = np.array([-1 if w is None else w for w in want], np.int64)
        if got is None or len(got) != len(want_arr):
            bad += len(want_arr)
            continue
        got_arr = np.array([-1 if g is None else g for g in got], np.int64)
        bad += int(((got_arr != want_arr) & (want_arr >= 0)).sum())
    return bad


def events(program: "list[tuple]", reference: "list[tuple]") -> int:
    """Sessions whose events, in the order each session got them, differ.
    An event is ``(proposal, result, timestamp)``, ``result`` None for a
    failure."""
    def by_session(items):
        if not items:
            return np.zeros((0, 3), np.int64)
        arr = np.array([(p, -1 if r is None else int(r), ts) for p, r, ts in items], np.int64)
        return arr[np.argsort(arr[:, 0], kind="stable")]

    got, want = by_session(program), by_session(reference)
    if got.shape == want.shape and (got == want).all():
        return 0
    sessions = set(got[:, 0].tolist()) | set(want[:, 0].tolist())

    def split(arr):
        out: "dict[int, list]" = {}
        for p, r, ts in arr.tolist():
            out.setdefault(p, []).append((r, ts))
        return out

    g, w = split(got), split(want)
    return sum(1 for p in sessions if g.get(p) != w.get(p))


def results(program: dict, reference: dict) -> int:
    """Live sessions whose result differs, or that only one side holds."""
    return sum(1 for p in set(program) | set(reference)
               if p not in program or p not in reference or program[p] != reference[p])


def compare(got: Reading, want: Reading, follow: np.ndarray, handed: range) -> "tuple[dict, int]":
    """The numbers compared, for the sessions of ``follow``, and the rows of
    the ``handed`` calls whose status differs."""
    counts = {
        "status_mismatches": statuses(got.votes, want.votes) + statuses(got.proposals, want.proposals),
        "event_mismatches": events([e for e in got.events if follow[e[0]]],
                                   [e for e in want.events if follow[e[0]]]),
        "result_mismatches": results({p: r for p, r in got.finals.items() if follow[p]},
                                     {p: r for p, r in want.finals.items() if follow[p]}),
    }
    if want.blames is not None:
        have = got.blames or {}
        counts["blame_mismatches"] = sum(1 for c, n in want.blames.items() if have.get(c) != n)
    failed = statuses({c: got.votes.get(c) for c in handed},
                      {c: want.votes[c] for c in handed if c in want.votes})
    return counts, failed


def verdict(counts: "dict[str, int]") -> bool:
    return all(value <= LIMITS[name] for name, value in counts.items())
