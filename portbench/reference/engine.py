"""The plain reference: one consensus node's answers, worked out row by row.

Upstream's semantics (vacp2p/hashgraph-like-consensus v0.6.0) for the calls
the benchmark makes, in plain Python: proposals from peers with the
per-scope session cap and its eviction by age (``src/service.rs:512-522``),
pre-validated votes, and signed wire votes with their checks in upstream's
order (``src/utils.rs:127-171``) and the chain rule for a first-time voter
(``src/utils.rs:175-215``: a vote's ``received_hash`` names the last vote
the node accepted for the session). It imports nothing of the program and
reads nothing it made: it is handed the same inputs, and its answers are
compared with the program's afterwards.

Sessions are independent of one another once the proposals' arrivals fix
which are live, so the reference may be handed only the votes of some
sessions: it answers each vote it is handed.
"""

from __future__ import annotations

import numpy as np

from . import rules

# Status codes of upstream's errors as the node returns them
# (``src/error.rs``; the batch API's dense numbering).
OK = 0
INVALID_VOTE_SIGNATURE = 5
DUPLICATE_VOTE = 7
VOTE_EXPIRED = 9
INVALID_VOTE_HASH = 11
PROPOSAL_EXPIRED = 13
RECEIVED_HASH_MISMATCH = 15
TIMESTAMP_OLDER_THAN_CREATION_TIME = 18
SESSION_NOT_ACTIVE = 19
SESSION_NOT_FOUND = 20
PROPOSAL_ALREADY_EXIST = 21
MAX_ROUNDS_EXCEEDED = 24
ALREADY_REACHED = 28

ACTIVE, FAILED = 0, 3  # besides rules.NO (1) and rules.YES (2)


class ReferenceNode:
    """A node's sessions. ``proposals`` lists every proposal of the run as
    ``(scope, proposal_id, timestamp, expiration, n, liveness_yes)``; a
    proposal is named by its index there. ``modes[scope]`` is
    ``"gossipsub"`` or ``"p2p"``."""

    def __init__(self, proposals, modes, threshold, max_sessions_per_scope,
                 quorum_floor=False):
        self.proposals = proposals
        self.modes = modes
        self.threshold = threshold
        self.max_sessions = max_sessions_per_scope
        self.quorum_floor = quorum_floor
        count = len(proposals)
        self.state = [ACTIVE] * count
        self.yes = [0] * count
        self.accepted: "list[set | None]" = [None] * count
        self.tail = [b""] * count
        self.cap: "list[int | None]" = [None] * count
        self.table: list = [None] * count
        self.live: "dict[tuple, int]" = {}  # (scope, pid) -> proposal index
        self.is_live = [False] * count
        self.scope_sessions: "dict[object, list]" = {}  # scope -> [(created, p)]
        self.events: "list[tuple[int, bool, int]]" = []  # (p, result, timestamp)
        self._tables: "dict[tuple, tuple]" = {}
        self._keys = None

    def lookup(self, scopes, pids):
        """Proposal indices of ``(scope, proposal_id)`` pairs (integer
        scopes), -1 where the table has none."""
        if self._keys is None:
            table = np.array([(s, pid) for s, pid, *_ in self.proposals], np.int64).reshape(-1, 2)
            keys = (table[:, 0] << 32) | table[:, 1]
            order = np.argsort(keys)
            self._keys = (keys[order], order)
        keys, order = self._keys
        want = (np.asarray(scopes, np.int64) << 32) | np.asarray(pids, np.int64)
        at = np.minimum(np.searchsorted(keys, want), max(len(keys) - 1, 0))
        hit = keys[at] == want if len(keys) else np.zeros(len(want), bool)
        return np.where(hit, order[at], -1)

    def _rules(self, p: int):
        scope, _, _, _, n, liveness = self.proposals[p]
        key = (self.modes[scope], n, liveness)
        got = self._tables.get(key)
        if got is None:
            cap = (rules.threshold_value(n, self.threshold, self.quorum_floor)
                   if key[0] == rules.P2P else None)
            got = (cap, rules.decision_table(n, self.threshold, liveness, self.quorum_floor))
            self._tables[key] = got
        return got

    # -- proposals ------------------------------------------------------

    def deliver(self, now: int, items: "list[int]") -> "list[int]":
        """Proposals arriving from peers, in order: one status each."""
        out = []
        for p in items:
            scope, pid, _, expiration, _, _ = self.proposals[p]
            if (scope, pid) in self.live:
                out.append(PROPOSAL_ALREADY_EXIST)
                continue
            if now >= expiration:
                out.append(PROPOSAL_EXPIRED)
                continue
            # Sessions of a scope in order of arrival; ``now`` never falls,
            # so that is also the order of age.
            sessions = self.scope_sessions.setdefault(scope, [])
            sessions.append((now, p))
            self.live[(scope, pid)] = p
            self.is_live[p] = True
            self.accepted[p] = set()
            self.cap[p], self.table[p] = self._rules(p)
            if len(sessions) > self.max_sessions:
                # The oldest goes; among equally old ones the one that
                # registered last (the newcomer counts as registered last).
                oldest = sessions[0][0]
                last = 0
                while last + 1 < len(sessions) and sessions[last + 1][0] == oldest:
                    last += 1
                _, gone = sessions.pop(last)
                del self.live[(scope, self.proposals[gone][1])]
                self.is_live[gone] = False
            out.append(OK)
        return out

    # -- the session's own checks --------------------------------------

    def _add(self, p: int, owner: bytes, value: bool, now: int) -> int:
        state = self.state[p]
        if state == rules.YES or state == rules.NO:
            self.events.append((p, state == rules.YES, now))
            return ALREADY_REACHED
        if state == FAILED:
            return SESSION_NOT_ACTIVE
        if now >= self.proposals[p][3]:
            return PROPOSAL_EXPIRED
        accepted = self.accepted[p]
        cap, table = self.cap[p], self.table[p]
        if cap is not None and len(accepted) + 1 > cap:
            self.state[p] = FAILED
            return MAX_ROUNDS_EXCEEDED
        if owner in accepted:
            return DUPLICATE_VOTE
        accepted.add(owner)
        if value:
            self.yes[p] += 1
        outcome = table[self.yes[p]][len(accepted)]
        if outcome != rules.UNDECIDED:
            self.state[p] = outcome
            self.events.append((p, outcome == rules.YES, now))
        return OK

    # -- pre-validated votes -------------------------------------------

    def columnar(self, now: int, scopes, pids, owners, values) -> list:
        """Votes the gossip layer already verified: one status a row. An
        owner is any hashable that names the voter."""
        out = []
        live = self.live
        for scope, pid, owner, value in zip(scopes, pids, owners, values):
            p = live.get((scope, pid))
            out.append(SESSION_NOT_FOUND if p is None else self._add(p, owner, value, now))
        return out

    def columnar_resolved(self, now: int, props, owners, values) -> list:
        """:meth:`columnar` for rows whose proposal the caller has already
        looked up by ``(scope, proposal_id)`` in the proposal table (-1 for
        none): the same rules, inlined, one session at a time (sessions do
        not interact within a call), for long runs."""
        props = np.asarray(props, np.int64)
        order = np.argsort(props, kind="stable")
        sorted_p = props[order]
        starts = np.flatnonzero(np.r_[True, sorted_p[1:] != sorted_p[:-1]]).tolist()
        ends = starts[1:] + [len(sorted_p)]
        owners = [owners[i] for i in order.tolist()]
        values = [values[i] for i in order.tolist()]
        res: list = []
        append = res.append
        events = self.events
        yes_code, no_code = rules.YES, rules.NO
        for lo, hi, p in zip(starts, ends, sorted_p[starts].tolist()):
            if p < 0 or not self.is_live[p]:
                res.extend([SESSION_NOT_FOUND] * (hi - lo))
                continue
            st, yes, acc, cap = self.state[p], self.yes[p], self.accepted[p], self.cap[p]
            table = self.table[p]
            expired = now >= self.proposals[p][3]
            for owner, value in zip(owners[lo:hi], values[lo:hi]):
                if st == yes_code or st == no_code:
                    events.append((p, st == yes_code, now))
                    append(ALREADY_REACHED)
                elif st == FAILED:
                    append(SESSION_NOT_ACTIVE)
                elif expired:
                    append(PROPOSAL_EXPIRED)
                elif cap is not None and len(acc) + 1 > cap:
                    st = FAILED
                    append(MAX_ROUNDS_EXCEEDED)
                elif owner in acc:
                    append(DUPLICATE_VOTE)
                else:
                    acc.add(owner)
                    if value:
                        yes += 1
                    outcome = table[yes][len(acc)]
                    if outcome != rules.UNDECIDED:
                        st = outcome
                        events.append((p, outcome == yes_code, now))
                    append(OK)
            self.state[p], self.yes[p] = st, yes
        out = np.empty(len(res), np.int64)
        out[order] = res
        return out.tolist()

    # -- signed wire votes ----------------------------------------------

    def wire(self, now: int, rows) -> list:
        """Signed votes of one frame, each a dict of its decoded fields plus
        ``scope``, ``hash_ok`` and ``sig_ok`` (the reference's own checks of
        the row's hash and signature): one status a row."""
        out = [None] * len(rows)
        frame: "dict[int, list]" = {}
        for i, row in enumerate(rows):
            p = self.live.get((row["scope"], row["proposal_id"]))
            if p is None:
                out[i] = SESSION_NOT_FOUND
                continue
            if not row["hash_ok"]:
                out[i] = INVALID_VOTE_HASH
                continue
            if not row["sig_ok"]:
                out[i] = INVALID_VOTE_SIGNATURE
                continue
            _, _, created, expiration, _, _ = self.proposals[p]
            if row["timestamp"] < created:
                out[i] = TIMESTAMP_OLDER_THAN_CREATION_TIME
                continue
            if row["timestamp"] > expiration or now > expiration:
                out[i] = VOTE_EXPIRED
                continue
            frame.setdefault(p, []).append(i)
        for p, idx in frame.items():
            # A first-time voter's received_hash must name the session's
            # last vote: the last one accepted before this frame, then each
            # earlier row of this frame that passed this check.
            tail = self.tail[p]
            seen = set(self.accepted[p])
            passed = []
            for i in idx:
                row = rows[i]
                owner = row["owner"]
                if owner not in seen:
                    if row["received"] and row["received"] != tail:
                        out[i] = RECEIVED_HASH_MISMATCH
                        continue
                    tail = row["hash"]
                    seen.add(owner)
                passed.append(i)
            for i in passed:
                row = rows[i]
                out[i] = self._add(p, row["owner"], row["value"], now)
                if out[i] == OK:
                    self.tail[p] = row["hash"]
        return out

    # -- the end of a run -------------------------------------------------

    def result(self, p: int):
        """A live session's result: True, False, ``None`` while undecided,
        ``"failed"`` once failed (upstream answers that with an error)."""
        state = self.state[p]
        if state == rules.YES:
            return True
        if state == rules.NO:
            return False
        return "failed" if state == FAILED else None
