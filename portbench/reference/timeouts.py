"""The plain reference's timeouts: the caller's sweep of expired sessions.

Upstream leaves timers to the app (vacp2p/hashgraph-like-consensus v0.6.0,
``README.md:183-197``): at a session's expiry the app asks for the timeout
decision (``src/service.rs:323-373``), which decides an ACTIVE session by
the decision rule with ``is_timeout`` set, every silent member counted yes
or no by the proposal's ``liveness_criteria_yes``, and fails it where that
rule stays undecided. A decided or failed session is not swept again. Like
:mod:`.engine`, it imports nothing of the program.
"""

from __future__ import annotations

import heapq

from . import rules
from .engine import ACTIVE, FAILED, OK, ReferenceNode


class TimeoutNode(ReferenceNode):
    """A :class:`ReferenceNode` (each proposal with its own liveness, from
    the proposal table) whose :meth:`sweep` fires the timeouts."""

    def __init__(self, proposals, modes, threshold, max_sessions_per_scope, quorum_floor=False):
        super().__init__(proposals, modes, threshold, max_sessions_per_scope, quorum_floor)
        self._due: "list[tuple[int, int]]" = []  # (expiration, proposal), a heap

    def deliver(self, now: int, items: "list[int]") -> "list[int]":
        out = super().deliver(now, items)
        for p, status in zip(items, out):
            if status == OK:
                heapq.heappush(self._due, (self.proposals[p][3], p))
        return out

    def sweep(self, now: int) -> "list[tuple[int, bool | None]]":
        """Fire every live ACTIVE session whose expiry has passed: its
        result by the timeout rule, or ``None`` (failed). Each gets the
        event ``(p, result, now)``; returns ``(p, result)`` a session."""
        fired = []
        while self._due and self._due[0][0] <= now:
            _, p = heapq.heappop(self._due)
            if not self.is_live[p] or self.state[p] != ACTIVE:
                continue
            _, _, _, _, n, liveness = self.proposals[p]
            outcome = rules.decide(self.yes[p], len(self.accepted[p]), n, self.threshold, liveness,
                                   timeout=True, quorum_floor=self.quorum_floor)
            result = None if outcome == rules.UNDECIDED else outcome == rules.YES
            self.state[p] = FAILED if result is None else outcome
            self.events.append((p, result, now))
            fired.append((p, result))
        return fired
