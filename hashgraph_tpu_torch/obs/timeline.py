"""Per-proposal lifecycle timelines: created → first_vote → quorum →
decided / timed_out.

The engine stamps each live session's milestones as they happen (wall
clock for latency math, the caller-supplied logical ``now`` for
correlation with application time), feeding the decision-latency histogram
at the moment a session leaves ACTIVE. Finished timelines move to a
bounded ring so a recently-churned proposal is still explainable after its
slot was recycled.

All mutation happens under the engine lock (the store is engine-private
state, like ``_records``); no internal locking is needed or attempted.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

OUTCOME_YES = "yes"
OUTCOME_NO = "no"
OUTCOME_FAILED = "failed"


@dataclass(slots=True)
class ProposalTimeline:
    scope: object
    proposal_id: int
    created_at: int  # logical now
    created_wall: float  # time.monotonic()
    first_vote_at: int | None = None
    first_vote_wall: float | None = None
    # Quorum milestone: stamped when the session decides by votes (the
    # tally crossing its required-votes threshold IS the decision moment
    # in this engine); absent for timeout/round-cap outcomes, where no
    # quorum was ever reached.
    quorum_at: int | None = None
    decided_at: int | None = None
    decided_wall: float | None = None
    outcome: str | None = None  # yes / no / failed; None while active
    by_timeout: bool = False
    # True when the outcome arrived pre-decided (snapshot restore,
    # vote-carrying gossip): the wall stamps then measure load time, not a
    # decision this engine made, so no latency is derived or observed.
    pre_decided: bool = False
    # Hex trace id of the session's bound distributed-trace context
    # (stamped by the engine's _bind_trace when tracing is on): the
    # decision-latency observation carries it as an OpenMetrics exemplar,
    # and an SLO breach's incident dump filters trace_store to it.
    trace_hex: str | None = None

    def as_dict(self) -> dict:
        """Readout shape for embedders and the bridge: raw stamps plus the
        derived latencies dashboards actually plot."""
        out = {
            "scope": str(self.scope),
            "proposal_id": self.proposal_id,
            "created_at": self.created_at,
            "first_vote_at": self.first_vote_at,
            "quorum_at": self.quorum_at,
            "decided_at": self.decided_at,
            "outcome": self.outcome,
            "by_timeout": self.by_timeout,
            "pre_decided": self.pre_decided,
        }
        if self.first_vote_wall is not None:
            out["first_vote_latency_s"] = self.first_vote_wall - self.created_wall
        if self.decided_wall is not None and not self.pre_decided:
            out["decision_latency_s"] = self.decided_wall - self.created_wall
        return out


class TimelineStore:
    """Slot-keyed live timelines plus a bounded ring of finished ones.

    ``decision_histogram`` receives created→decided wall seconds once per
    session, exactly when the session leaves ACTIVE (vote quorum, round-cap
    failure, or timeout)."""

    def __init__(self, decision_histogram, completed_capacity: int = 1024):
        self._hist = decision_histogram
        # Optional SLO hook: called as slo_sink(timeline, latency_s) for
        # every latency this store observes (same gating as the histogram
        # — never for pre_decided/replay/unowned sessions). The engine
        # points this at the process SLO engine; keeping it a plain
        # callable keeps this module free of policy and lets the ~7
        # engine decided() call sites stay untouched.
        self.slo_sink = None
        self._live: dict[int, ProposalTimeline] = {}
        self._done: deque[ProposalTimeline] = deque()
        self._done_capacity = completed_capacity
        # (scope, proposal_id) -> most recent finished timeline: keeps
        # bridge/explain lookups O(1) under churn instead of scanning the
        # ring. Overwritten on pid reuse (most recent wins, matching the
        # old reverse scan); an entry dies when ITS timeline ages out of
        # the ring.
        self._done_index: dict[tuple, ProposalTimeline] = {}
        # WAL recovery replays pre-crash traffic through the live ingest
        # paths; with this flag set every decision is stamped pre_decided
        # (outcome recorded, no latency derived or observed) — replay
        # speed is not decision latency.
        self.replay_mode = False

    def _retire(self, tl: ProposalTimeline) -> None:
        """Move a finished timeline into the bounded ring + (scope, pid)
        index, evicting (and de-indexing) the oldest past capacity."""
        self._done.append(tl)
        self._done_index[(tl.scope, tl.proposal_id)] = tl
        while len(self._done) > self._done_capacity:
            old = self._done.popleft()
            key = (old.scope, old.proposal_id)
            if self._done_index.get(key) is old:
                del self._done_index[key]

    def created(self, slot: int, scope, proposal_id: int, now: int, wall: float) -> None:
        # A recycled slot whose previous tenant was never forgotten (should
        # not happen — delete/evict forget) still must not leak: retire it.
        prev = self._live.get(slot)
        if prev is not None:
            self._retire(prev)
        self._live[slot] = ProposalTimeline(scope, proposal_id, now, wall)

    def voted(self, slot: int, now: int, wall: float) -> None:
        tl = self._live.get(slot)
        if tl is not None and tl.first_vote_wall is None:
            tl.first_vote_at = now
            tl.first_vote_wall = wall

    def decided(
        self,
        slot: int,
        outcome: str,
        now: int,
        wall: float,
        by_timeout: bool = False,
        observe: bool = True,
        pre_decided: bool = False,
    ) -> None:
        """``pre_decided=True`` stamps the outcome without feeding the
        latency histogram and marks the timeline so the readout omits the
        derived latency too — for sessions that arrived already decided
        (snapshot restore, vote-carrying gossip), where the latency would
        be this engine's load time, not a decision time.
        ``observe=False`` suppresses only the histogram observation (used
        by multi-host engines for sessions another process owns, so a
        fleet-wide metrics sum counts each decision once)."""
        tl = self._live.get(slot)
        if tl is None or tl.outcome is not None:
            return  # untracked or already finalized (re-emits are idempotent)
        if self.replay_mode:
            pre_decided = True
        tl.decided_at = now
        tl.decided_wall = wall
        tl.outcome = outcome
        tl.by_timeout = by_timeout
        if not by_timeout and not pre_decided and outcome != OUTCOME_FAILED:
            tl.quorum_at = now  # vote quorum IS the decision moment
        if pre_decided:
            tl.pre_decided = True
        elif observe:
            latency = wall - tl.created_wall
            self._hist.observe(latency, exemplar=tl.trace_hex)
            if self.slo_sink is not None:
                self.slo_sink(tl, latency)

    def forget(self, slot: int) -> None:
        tl = self._live.pop(slot, None)
        if tl is not None:
            self._retire(tl)

    def get(self, slot: int) -> ProposalTimeline | None:
        return self._live.get(slot)

    def find(self, scope, proposal_id: int) -> ProposalTimeline | None:
        """Most recent finished timeline for (scope, proposal_id) — the
        fallback when the session's slot is already recycled. O(1) via the
        retire-time index (bridge-side lookups stay flat under churn)."""
        return self._done_index.get((scope, proposal_id))

    def live_count(self) -> int:
        return len(self._live)
