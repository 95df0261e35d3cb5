"""Consensus health observatory: peer scorecards, misbehavior evidence,
liveness watchdog, and threshold alert rules.

The reference contract pushes liveness, timers, and peer-set management
onto the embedder (reference: src/lib.rs:15-34); at fleet scale the
operator's question is not "how many invalid votes" but *which peer* is
producing them. This module turns the engine's per-signer signals — vote
admissions, invalid signatures, expired gossip, fork/truncation
redeliveries, equivocations — into an accountable health layer:

- :class:`PeerScorecard` — bounded rolling stats per signer identity with
  a derived grade (``healthy | suspect | faulty``). Time is the logical
  monotonic tick the embedder already supplies to every engine call (the
  library's no-clock contract): ``last_seen`` and staleness are measured
  in that clock, never the wall.
- :class:`EvidenceRecord` — when two validly-signed conflicting votes
  from one peer are observed (same scope/proposal, different value or
  chain position), or a redelivered chain forks before the validated
  watermark at a position whose divergent vote's signer also has a
  different accepted vote (the double-sign bar — positional divergence
  alone is honestly producible and never attributed), the signed byte
  pairs are retained instead of dropped.
  Evidence is *self-authenticating*: both sides carry the offender's own
  signature over their content, so any third party can verify the
  conflict offline without trusting this process (the BFT-accountability
  property — see PAPERS.md).
- a **liveness watchdog** — suspicion is φ-accrual-derived
  (:mod:`hashgraph_tpu_torch.obs.accrual`): each peer's inter-arrival history
  on the logical clock yields a continuous ``phi`` level, and a peer
  crosses into ``suspect``/stale when ``phi >= phi_threshold``. The old
  binary bound stays as a back-compat floor: silence past
  ``max(stale_after, session timeout hint)`` still convicts even when
  the arrival history is too thin for phi to speak.
- :class:`AlertRule` — threshold rules over registry metrics and
  scorecards. Rising edges emit a structured ``health.alert`` event into
  the flight recorder and count on ``hashgraph_alerts_total`` plus a
  per-rule ``hashgraph_alerts_total{rule="..."}`` counter; firing
  critical rules flip the bridge's ``/healthz`` to 503 with
  machine-readable reasons.

One process-wide default monitor (``hashgraph_tpu_torch.obs.health_monitor``,
mirroring the metrics registry's role) is shared by every engine that is
not given its own, so a bridge server's co-hosted peers accumulate one
fleet view; all methods are thread-safe behind the monitor's own lock
(engines call in under their engine lock, scrape threads call in with no
lock at all).
"""

from __future__ import annotations

import hashlib
import threading
from collections import deque
from dataclasses import dataclass
from itertools import compress, repeat

import numpy as np

from .accrual import PhiAccrual
from .flight import flight_recorder
from .prometheus import _escape_label
from .registry import MetricsRegistry

# Well-known family names (re-exported by hashgraph_tpu_torch.obs; defined here
# so this module never imports the package __init__ — same layering as
# flight.py).
ALERTS_TOTAL = "hashgraph_alerts_total"
EQUIVOCATIONS_TOTAL = "hashgraph_equivocations_total"
FORK_REDELIVERIES_TOTAL = "hashgraph_fork_redeliveries_total"
TRUNCATION_REDELIVERIES_TOTAL = "hashgraph_truncation_redeliveries_total"
EXPIRED_GOSSIP_TOTAL = "hashgraph_expired_gossip_total"
EVIDENCE_RECORDS = "hashgraph_evidence_records"
TRACKED_PEERS = "hashgraph_tracked_peers"
STALE_PEERS = "hashgraph_stale_peers"
# φ-accrual liveness families (ISSUE 18): the bare PHI gauge reports the
# worst (max) suspicion across tracked peers; per-peer labelled
# ``hashgraph_phi{peer="..."}`` variants are installed as peers appear
# (bounded — see _MAX_PHI_LABELS).
PHI = "hashgraph_phi"
LIVENESS_SUSPECTS = "hashgraph_liveness_suspects"
LIVENESS_HEARTBEATS_TOTAL = "hashgraph_liveness_heartbeats_total"
LIVENESS_SUSPICION_EDGES_TOTAL = "hashgraph_liveness_suspicion_edges_total"

# Cap on per-peer labelled phi gauges: registry families are permanent,
# so an open-membership fleet must not mint one per transient identity.
_MAX_PHI_LABELS = 128

DEFAULT_PHI_THRESHOLD = 8.0

GRADE_HEALTHY = "healthy"
GRADE_SUSPECT = "suspect"
GRADE_FAULTY = "faulty"
_GRADE_RANK = {GRADE_HEALTHY: 0, GRADE_SUSPECT: 1, GRADE_FAULTY: 2}

SEVERITY_WARNING = "warning"
SEVERITY_CRITICAL = "critical"

KIND_EQUIVOCATION = "equivocation"
KIND_FORK = "fork"


@dataclass(slots=True)
class PeerScorecard:
    """Rolling per-signer accounting. All timestamps are the embedder's
    logical ``now`` ticks (no-clock contract); counters are cumulative
    for the monitor's lifetime (rates live on the metrics registry)."""

    identity: bytes
    first_seen: int = 0
    last_seen: int = 0
    votes_admitted: int = 0
    invalid_signatures: int = 0
    expired_gossip: int = 0
    fork_redeliveries: int = 0
    truncation_redeliveries: int = 0
    equivocations: int = 0
    # Chain lag: how far behind the accepted head this peer's most recent
    # non-extending redelivery was (accepted length - delivered length).
    chain_lag: int = 0
    max_chain_lag: int = 0
    # Largest consensus_timeout (seconds of logical time) among the
    # sessions this peer voted on — the watchdog's per-peer staleness
    # threshold, per "the scope's timeout config".
    timeout_hint: float = 0.0
    # φ-accrual inter-arrival history (lazily created on first
    # admission) and the last phi-suspicion state the alert evaluator
    # saw (rising-edge detection for the suspicion-edges counter).
    accrual: PhiAccrual | None = None
    phi_suspect: bool = False

    def phi(self, now: int | None) -> float:
        """Current φ-accrual suspicion level (0.0 with no clock or no
        usable arrival history — a thin history must never convict)."""
        if self.accrual is None or now is None:
            return 0.0
        return self.accrual.phi(now)

    def as_dict(
        self,
        now: int | None,
        stale_after: float,
        phi_threshold: float | None = None,
    ) -> dict:
        threshold = max(stale_after, self.timeout_hint)
        phi = self.phi(now)
        stale = now is not None and (
            (now - self.last_seen) > threshold
            or (phi_threshold is not None and phi >= phi_threshold)
        )
        return {
            "grade": self.grade(now, stale_after, phi_threshold),
            "votes_admitted": self.votes_admitted,
            "invalid_signatures": self.invalid_signatures,
            "expired_gossip": self.expired_gossip,
            "fork_redeliveries": self.fork_redeliveries,
            "truncation_redeliveries": self.truncation_redeliveries,
            "equivocations": self.equivocations,
            "chain_lag": self.chain_lag,
            "max_chain_lag": self.max_chain_lag,
            "first_seen": self.first_seen,
            "last_seen": self.last_seen,
            "stale": stale,
            "stale_after": threshold,
            "phi": round(phi, 3),
            "phi_threshold": phi_threshold,
        }

    def grade(
        self,
        now: int | None,
        stale_after: float,
        phi_threshold: float | None = None,
    ) -> str:
        """``faulty``: signed, self-authenticating misbehavior
        (equivocation). ``suspect``: circumstantial anomalies — invalid
        signatures, divergent (forked) redeliveries, φ-accrual suspicion
        past ``phi_threshold``, or silence past the binary timeout
        threshold (the back-compat floor) — which an honest-but-broken
        relay can also produce. ``healthy`` otherwise. Suspicion is
        computed at read time, so a phi- or silence-driven conviction
        clears itself the moment the peer's heartbeats resume."""
        if self.equivocations > 0:
            return GRADE_FAULTY
        threshold = max(stale_after, self.timeout_hint)
        if (
            self.invalid_signatures > 0
            or self.fork_redeliveries > 0
            or (now is not None and (now - self.last_seen) > threshold)
            or (phi_threshold is not None and self.phi(now) >= phi_threshold)
        ):
            return GRADE_SUSPECT
        return GRADE_HEALTHY


@dataclass(slots=True)
class EvidenceRecord:
    """One retained misbehavior proof. ``vote_a``/``vote_b`` are the
    verbatim wire (protobuf) bytes of the two conflicting votes — each
    carries the offender's signature over its own content, so the record
    authenticates itself to any verifier holding the scheme.
    ``verified`` says whether BOTH signatures were checked by this
    process at capture time (equivocations: yes — both votes passed
    admission validation; fork captures: no — the watermark path settles
    forks crypto-free by design, the bytes are retained for offline
    audit)."""

    kind: str  # KIND_EQUIVOCATION | KIND_FORK
    offender: bytes
    scope: str
    proposal_id: int
    detected_at: int
    vote_a: bytes  # accepted / first-seen signed vote bytes
    vote_b: bytes  # conflicting signed vote bytes
    verified: bool = True

    def as_dict(self) -> dict:
        return {
            "kind": self.kind,
            "offender": self.offender.hex(),
            "scope": self.scope,
            "proposal_id": self.proposal_id,
            "detected_at": self.detected_at,
            "vote_a": self.vote_a.hex(),
            "vote_b": self.vote_b.hex(),
            "verified": self.verified,
        }

    def dedup_key(self) -> bytes:
        h = hashlib.sha256()
        h.update(self.kind.encode())
        h.update(self.vote_a)
        h.update(b"|")
        h.update(self.vote_b)
        return h.digest()


class AlertRule:
    """One named threshold rule. ``check(view)`` returns a list of
    machine-readable detail dicts (empty = not firing); ``view`` is the
    evaluation context built by :meth:`HealthMonitor.evaluate_alerts`
    with keys ``peers`` (identity-hex -> scorecard dict), ``evidence``
    (list of dicts), ``stale`` (list of identity hexes), ``now``
    (logical tick or None), and ``registry``."""

    def __init__(
        self,
        name: str,
        check,
        severity: str = SEVERITY_WARNING,
        description: str = "",
    ):
        if severity not in (SEVERITY_WARNING, SEVERITY_CRITICAL):
            raise ValueError("severity must be 'warning' or 'critical'")
        self.name = name
        self.check = check
        self.severity = severity
        self.description = description

    # ── Factories ──────────────────────────────────────────────────────

    @classmethod
    def grade_at_least(
        cls, name: str, grade: str, severity: str = SEVERITY_CRITICAL
    ) -> "AlertRule":
        """Fires per peer whose derived grade is at or past ``grade``."""
        rank = _GRADE_RANK[grade]

        def check(view) -> list[dict]:
            return [
                {"peer": hexid, "grade": card["grade"]}
                for hexid, card in view["peers"].items()
                if _GRADE_RANK[card["grade"]] >= rank
            ]

        return cls(name, check, severity, f"any peer graded >= {grade}")

    @classmethod
    def stale_peers(
        cls, name: str = "peer-stale", severity: str = SEVERITY_WARNING
    ) -> "AlertRule":
        """Fires when the liveness watchdog flags any peer silent past
        its timeout threshold."""

        def check(view) -> list[dict]:
            return [{"peer": hexid} for hexid in view["stale"]]

        return cls(name, check, severity, "watchdog-flagged silent peers")

    @classmethod
    def phi_suspects(
        cls, name: str = "peer-suspect-phi", severity: str = SEVERITY_WARNING
    ) -> "AlertRule":
        """Fires per peer whose φ-accrual suspicion is at or past the
        monitor's phi threshold (the continuous-confidence analogue of
        ``peer-stale`` — see hashgraph_tpu_torch.obs.accrual)."""

        def check(view) -> list[dict]:
            return [
                {
                    "peer": hexid,
                    "phi": card["phi"],
                    "threshold": card["phi_threshold"],
                }
                for hexid, card in view["peers"].items()
                if card.get("phi_threshold") is not None
                and card.get("phi", 0.0) >= card["phi_threshold"]
            ]

        return cls(name, check, severity, "phi-accrual suspicion past threshold")

    @classmethod
    def counter_above(
        cls,
        name: str,
        family: str,
        threshold: float,
        severity: str = SEVERITY_WARNING,
    ) -> "AlertRule":
        """Fires while ``registry.counter(family).value > threshold``
        (use for cumulative anomaly counters, e.g. negative verify-cache
        hits or WAL decode errors)."""

        def check(view) -> list[dict]:
            value = view["registry"].counter(family).value
            if value > threshold:
                return [{"metric": family, "value": value, "threshold": threshold}]
            return []

        return cls(name, check, severity, f"{family} > {threshold}")

    @classmethod
    def gauge_above(
        cls,
        name: str,
        family: str,
        threshold: float,
        severity: str = SEVERITY_WARNING,
    ) -> "AlertRule":
        def check(view) -> list[dict]:
            value = view["registry"].gauge(family).value
            if value > threshold:
                return [{"metric": family, "value": value, "threshold": threshold}]
            return []

        return cls(name, check, severity, f"{family} > {threshold}")

    @classmethod
    def scorecard_field_above(
        cls,
        name: str,
        fieldname: str,
        threshold: float,
        severity: str = SEVERITY_WARNING,
    ) -> "AlertRule":
        """Fires per peer whose scorecard ``fieldname`` exceeds
        ``threshold`` (e.g. invalid_signatures > 3)."""

        def check(view) -> list[dict]:
            return [
                {
                    "peer": hexid,
                    "field": fieldname,
                    "value": card[fieldname],
                    "threshold": threshold,
                }
                for hexid, card in view["peers"].items()
                if card.get(fieldname, 0) > threshold
            ]

        return cls(name, check, severity, f"{fieldname} > {threshold} on any peer")


def default_rules() -> "list[AlertRule]":
    """The stock rule set: signed misbehavior is critical (flips
    ``/healthz`` to 503 — an equivocating co-hosted peer means this
    node's output can no longer be trusted blindly); circumstantial
    anomalies are warnings an operator reads off the health report."""
    return [
        AlertRule.grade_at_least("peer-faulty", GRADE_FAULTY, SEVERITY_CRITICAL),
        AlertRule.grade_at_least("peer-suspect", GRADE_SUSPECT, SEVERITY_WARNING),
        AlertRule.stale_peers("peer-stale", SEVERITY_WARNING),
        AlertRule.phi_suspects("peer-suspect-phi", SEVERITY_WARNING),
        AlertRule.scorecard_field_above(
            "invalid-signature-burst", "invalid_signatures", 3, SEVERITY_WARNING
        ),
    ]


@dataclass(slots=True)
class _AlertState:
    firing: bool = False
    events: int = 0


class HealthMonitor:
    """Bounded, thread-safe health store: scorecards + evidence +
    watchdog + alert rules. See the module docstring for the model.

    ``stale_after`` is the default staleness threshold in logical-time
    units; a peer's own threshold is ``max(stale_after, largest
    consensus_timeout among its sessions)``. ``registry`` receives the
    anomaly counters and (for the process-default monitor) the gauge
    providers; pass a fresh :class:`MetricsRegistry` in tests for
    isolation.
    """

    def __init__(
        self,
        max_peers: int = 4096,
        max_evidence: int = 256,
        stale_after: float = 60.0,
        rules: "list[AlertRule] | None" = None,
        registry: MetricsRegistry | None = None,
        phi_threshold: "float | None" = DEFAULT_PHI_THRESHOLD,
        phi_window: int = 64,
        phi_min_samples: int = 8,
    ):
        if max_peers <= 0 or max_evidence <= 0:
            raise ValueError("max_peers and max_evidence must be positive")
        self.stale_after = float(stale_after)
        # φ-accrual suspicion bar: ``None`` disables the accrual detector
        # entirely (pure binary-threshold watchdog — the A/B baseline and
        # the pre-ISSUE-18 behavior).
        self.phi_threshold = (
            float(phi_threshold) if phi_threshold is not None else None
        )
        self._phi_window = int(phi_window)
        self._phi_min_samples = int(phi_min_samples)
        self._max_peers = max_peers
        self._max_evidence = max_evidence
        self._lock = threading.Lock()
        # Plain dict, bounded by amortized least-recently-SEEN eviction
        # (``_evict_locked``). An LRU OrderedDict with per-touch
        # move_to_end would be strictly ordered but costs the admission
        # hot path a list-node splice per vote; last_seen already orders
        # the victims, so eviction sorts rarely instead.
        self._peers: "dict[bytes, PeerScorecard]" = {}
        self._evidence: "deque[EvidenceRecord]" = deque()
        self._evidence_keys: set[bytes] = set()
        self._rules: "list[AlertRule]" = (
            list(rules) if rules is not None else default_rules()
        )
        self._alert_state: dict[str, _AlertState] = {}
        # Highest logical tick ever observed — the watchdog's "current
        # time" when a caller (e.g. an HTTP scrape, which has no embedder
        # clock) cannot supply one.
        self.latest_now = 0
        # Registries whose gauges already sample this monitor (see
        # register_gauges — double registration would double-count).
        self._gauge_registries: set[int] = set()
        # Registries that receive per-peer labelled phi gauges (strong
        # refs — a monitor and its registries share a lifetime), plus the
        # identities already labelled (bounded by _MAX_PHI_LABELS).
        self._phi_registries: "list[MetricsRegistry]" = []
        self._phi_labelled: set[bytes] = set()
        self._registry = registry if registry is not None else MetricsRegistry()
        reg = self._registry
        self._m_alerts = reg.counter(ALERTS_TOTAL)
        self._m_equivocations = reg.counter(EQUIVOCATIONS_TOTAL)
        self._m_forks = reg.counter(FORK_REDELIVERIES_TOTAL)
        self._m_truncations = reg.counter(TRUNCATION_REDELIVERIES_TOTAL)
        self._m_expired = reg.counter(EXPIRED_GOSSIP_TOTAL)
        self._m_heartbeats = reg.counter(LIVENESS_HEARTBEATS_TOTAL)
        self._m_phi_edges = reg.counter(LIVENESS_SUSPICION_EDGES_TOTAL)

    # ── Recording (engine-facing; engines call under their own lock) ───

    def tick(self, now: int) -> None:
        """Advance the monitor's logical clock without attributing
        anything to a peer (timeout sweeps call this so the watchdog has
        a current tick even when vote traffic stops). Locked: two engines
        sharing one monitor must not interleave the check-then-act and
        regress the clock below an observed tick."""
        with self._lock:
            self._tick_locked(now)

    def _tick_locked(self, now: int) -> None:
        if now > self.latest_now:
            self.latest_now = now

    def _card(self, identity: bytes, now: int) -> PeerScorecard:
        """Fetch-or-create under the caller's lock hold; past the cap the
        least-recently-seen peers are evicted (amortized)."""
        card = self._peers.get(identity)
        if card is None:
            card = PeerScorecard(identity, first_seen=now, last_seen=now)
            self._peers[identity] = card
            if len(self._peers) > self._max_peers:
                self._evict_locked()
        return card

    def _evict_locked(self) -> None:
        """Drop the least-recently-seen ~eighth of the peer set (at
        least one): one O(n log n) sort every cap/8 insertions instead
        of ordered-dict maintenance on every admission."""
        victims = sorted(self._peers.values(), key=lambda c: c.last_seen)
        for card in victims[: max(1, self._max_peers // 8)]:
            del self._peers[card.identity]

    def note_admitted(
        self,
        counts: "dict[bytes, int]",
        now: int,
        timeout_hint: float = 0.0,
    ) -> None:
        """Batched admission accounting: ``counts`` maps signer identity
        to votes admitted this call (the engine aggregates per batch so
        the hot path pays one lock acquisition, not one per vote).
        ``timeout_hint`` is the sessions' consensus_timeout — it raises
        the peers' staleness thresholds to the scope's timeout config.
        This is THE hot recording path (every admitted vote lands here).
        While the call cannot overflow the free room it is the plain
        loop (:meth:`_admit_loop_locked`); past it, the same end state is
        worked out without a card for any identity the call itself evicts
        (:meth:`_admit_evicting_locked`). Returns how many new identities
        got no card for that reason."""
        if not counts:
            return 0
        skipped = 0
        with self._lock:
            if now > self.latest_now:
                self.latest_now = now
            peers = self._peers
            done = None
            if len(counts) > self._max_peers - len(peers):
                # The new identities may overflow the free room: the
                # replay is exact either way.
                done = self._admit_evicting_locked(counts, now, timeout_hint)
            if done is None:
                fresh = self._admit_loop_locked(counts, now, timeout_hint)
            else:
                fresh, skipped = done
        self._m_heartbeats.inc(len(counts))
        # Labelled phi gauges for first-seen peers are installed OUTSIDE
        # the monitor lock: register_gauge takes registry locks, and a
        # scrape-side provider takes this monitor's lock — never hold
        # both from the same side. Past the label cap every install is a
        # no-op, so the walk stops there.
        if fresh and self._phi_registries:
            for identity in fresh:
                if len(self._phi_labelled) >= _MAX_PHI_LABELS:
                    break
                self._install_phi_gauge(identity)
        return skipped

    def _admit_loop_locked(
        self, counts: "dict[bytes, int]", now: int, timeout_hint: float
    ) -> "list[bytes]":
        """The admission loop (lock held): each identity's card, a new one
        appended (past the cap, an eviction) where it has none, then
        :meth:`_admit_card`. Returns the new identities in call order."""
        max_peers = self._max_peers
        fresh: "list[bytes]" = []
        peers = self._peers
        for identity, n in counts.items():
            card = peers.get(identity)
            if card is None:
                card = PeerScorecard(identity, first_seen=now, last_seen=now)
                peers[identity] = card
                if len(peers) > max_peers:
                    self._evict_locked()
                fresh.append(identity)
            self._admit_card(card, n, now, timeout_hint)
        return fresh

    def _admit_card(
        self, card: PeerScorecard, n: int, now: int, timeout_hint: float
    ) -> None:
        """One identity's admissions of a call on its card."""
        # φ-accrual heartbeat: one arrival observation per batch tick
        # (the accrual coalesces same-tick arrivals itself).
        accrual = card.accrual
        if accrual is None:
            accrual = card.accrual = PhiAccrual(
                window=self._phi_window,
                min_samples=self._phi_min_samples,
            )
        accrual.heartbeat(now)
        card.votes_admitted += n
        if now > card.last_seen:
            card.last_seen = now
        if timeout_hint > card.timeout_hint:
            card.timeout_hint = timeout_hint

    def _admit_evicting_locked(
        self, counts: "dict[bytes, int]", now: int, timeout_hint: float
    ) -> "tuple[list[bytes], int] | None":
        """:meth:`_admit_loop_locked`'s end state when the call's new
        identities overflow the free room, with cards built or updated
        only for what the loop would still hold when it returns.

        The loop appends each new identity to the dict and, once past the
        cap, drops the ``max(1, cap // 8)`` cards first by (last_seen,
        dict position); an identity it admits first raises its card's
        last_seen to at least ``now``. Those raises are the only changes
        of that order, so the drops are replayed on (rank of last_seen,
        position) keys, one partition a drop, and an existing identity
        evicted before its turn comes back as a new one, as in the loop.
        Returns (the new identities in call order, how many of them the
        call evicts), or None where a time is not a machine integer (the
        caller then runs the loop)."""
        peers = self._peers
        keys = list(peers)
        cards = list(peers.values())
        times = np.array([card.last_seen for card in cards] + [now])
        if times.dtype.kind != "i":
            return None
        n0, cap = len(keys), self._max_peers
        idents = list(counts)
        m = len(idents)
        position = dict(zip(keys, range(n0)))
        home = np.array(list(map(position.get, idents, repeat(-1, m))), np.int64)
        # Universe of cards: the existing ones (0..n0-1), then entry t's
        # new card at n0 + t. Keys: rank of last_seen, then position.
        size = n0 + m
        _, rank = np.unique(times, return_inverse=True)
        rank = rank.reshape(-1).astype(np.int64)
        rank_now = rank[-1]
        seen_key = np.empty(size, np.int64)
        seen_key[:n0] = rank[:-1]
        pos_key = np.empty(size, np.int64)
        pos_key[:n0] = np.arange(n0)
        live = np.zeros(size, bool)
        live[:n0] = True
        touched = np.zeros(n0, bool)
        inserted = np.zeros(m, bool)
        drop = max(1, cap // 8)
        length, next_pos, t = n0, n0, 0
        while t < m:
            need = cap - length + 1  # insertions up to the next drop
            span = min(m - t, 2 * need + 64)
            while True:
                h = home[t:t + span]
                ins = h < 0
                old = np.nonzero(~ins)[0]
                ins[old] = ~live[h[old]]
                cum = np.cumsum(ins)
                if cum[-1] >= need or t + span == m:
                    break
                span = min(m - t, 2 * span)
            stop = t + span if cum[-1] < need else t + int(np.searchsorted(cum, need)) + 1
            ins = ins[: stop - t]
            hit = h[: stop - t][~ins]
            touched[hit] = True
            seen_key[hit] = np.maximum(seen_key[hit], rank_now)
            new_t = t + np.nonzero(ins)[0]
            u = n0 + new_t
            inserted[new_t] = True
            live[u] = True
            seen_key[u] = rank_now
            pos_key[u] = next_pos + np.arange(len(u))
            next_pos += len(u)
            length += len(u)
            if length > cap:
                cand = np.nonzero(live)[0]
                order_key = seen_key[cand] * (size + 1) + pos_key[cand]
                live[cand[np.argpartition(order_key, drop - 1)[:drop]]] = False
                length -= drop
            t = stop
        for j in np.nonzero(~live[:n0])[0].tolist():
            del peers[keys[j]]
        for j in np.nonzero(touched & live[:n0])[0].tolist():
            self._admit_card(cards[j], counts[keys[j]], now, timeout_hint)
        kept = inserted & live[n0:]
        window, min_samples = self._phi_window, self._phi_min_samples
        raise_hint = timeout_hint > 0.0  # a new card's hint
        admitted = list(counts.values())
        for t in np.nonzero(kept)[0].tolist():
            identity = idents[t]
            # _admit_card on a new card, inlined.
            accrual = PhiAccrual(window=window, min_samples=min_samples)
            accrual.heartbeat(now)
            card = PeerScorecard(identity, now, now, 0 + admitted[t])
            card.accrual = accrual
            if raise_hint:
                card.timeout_hint = timeout_hint
            peers[identity] = card
        fresh = list(compress(idents, inserted.tolist()))
        return fresh, int(inserted.sum() - kept.sum())

    def note_invalid_signature(self, identity: bytes, now: int) -> None:
        """A vote claiming ``identity`` failed signature admission. The
        identity is the *claimed* signer — a forger imitating an honest
        peer dirties that peer's scorecard (grade: suspect, never
        faulty), which is exactly the signal an operator wants: someone
        is sending bad bytes under this name."""
        with self._lock:
            self._tick_locked(now)
            self._card(identity, now).invalid_signatures += 1
        # No dedicated counter family: invalid signatures already count
        # on the verify-cache / engine status surfaces; the scorecard
        # carries the per-peer attribution.

    def note_expired(self, identity: bytes, now: int) -> None:
        """Expired gossip (stale proposal or vote) attributed to the
        chain's most recent signer — the closest accountable identity to
        the redelivery source the engine can see."""
        with self._lock:
            self._tick_locked(now)
            self._card(identity, now).expired_gossip += 1
        self._m_expired.inc()

    def note_truncation(self, identity: bytes, lag: int, now: int) -> None:
        """A redelivered chain shorter than the accepted watermark:
        ``lag`` = accepted length - delivered length (the peer's view is
        behind the head)."""
        with self._lock:
            self._tick_locked(now)
            card = self._card(identity, now)
            card.truncation_redeliveries += 1
            card.chain_lag = lag
            if lag > card.max_chain_lag:
                card.max_chain_lag = lag
        self._m_truncations.inc()

    def note_fork(
        self,
        scope,
        proposal_id: int,
        accepted_vote_bytes: bytes,
        conflicting_vote_bytes: bytes,
        offender: bytes,
        now: int,
    ) -> None:
        """A redelivered chain diverging from the accepted prefix before
        the validated watermark, where the divergent vote's owner ALSO
        has a different accepted vote in the session — the engine only
        reports forks that meet the double-sign bar, so
        ``accepted_vote_bytes``/``conflicting_vote_bytes`` are BOTH the
        offender's own signed votes (a positional divergence alone can be
        produced by honest loss/reorder and is never attributed). The
        conflicting vote's signature was NOT verified here (the watermark
        path settles forks crypto-free — PR 4's whole point); the
        retained byte pair is self-authenticating for offline audit, so
        the record is marked ``verified=False``."""
        record = EvidenceRecord(
            kind=KIND_FORK,
            offender=offender,
            scope=str(scope),
            proposal_id=proposal_id,
            detected_at=now,
            vote_a=accepted_vote_bytes,
            vote_b=conflicting_vote_bytes,
            verified=False,
        )
        with self._lock:
            self._tick_locked(now)
            self._card(offender, now).fork_redeliveries += 1
            added = self._retain(record)
        if added:
            self._m_forks.inc()
            flight_recorder.record(
                "health.fork",
                scope=record.scope,
                proposal_id=proposal_id,
                offender=offender.hex(),
            )

    def note_equivocation(
        self,
        scope,
        proposal_id: int,
        first_vote_bytes: bytes,
        second_vote_bytes: bytes,
        offender: bytes,
        now: int,
    ) -> None:
        """Two validly-signed conflicting votes from one peer on one
        (scope, proposal) — different value or chain position. Both sides
        passed signature admission in this process, so the evidence is
        recorded ``verified=True``."""
        record = EvidenceRecord(
            kind=KIND_EQUIVOCATION,
            offender=offender,
            scope=str(scope),
            proposal_id=proposal_id,
            detected_at=now,
            vote_a=first_vote_bytes,
            vote_b=second_vote_bytes,
            verified=True,
        )
        with self._lock:
            self._tick_locked(now)
            added = self._retain(record)
            if added:
                self._card(offender, now).equivocations += 1
        if added:
            self._m_equivocations.inc()
            flight_recorder.record(
                "health.equivocation",
                scope=record.scope,
                proposal_id=proposal_id,
                offender=offender.hex(),
            )

    def _retain(self, record: EvidenceRecord) -> bool:
        """Dedup + bound the evidence log (lock held). Gossip redelivers
        the same conflict over and over; one retained pair per distinct
        conflict is the accountable unit."""
        key = record.dedup_key()
        if key in self._evidence_keys:
            return False
        self._evidence.append(record)
        self._evidence_keys.add(key)
        while len(self._evidence) > self._max_evidence:
            old = self._evidence.popleft()
            self._evidence_keys.discard(old.dedup_key())
        return True

    # ── Readout ────────────────────────────────────────────────────────

    def scorecard(self, identity: bytes) -> dict | None:
        """One peer's scorecard dict (graded at the latest tick)."""
        with self._lock:
            card = self._peers.get(identity)
            if card is None:
                return None
            return card.as_dict(
                self.latest_now, self.stale_after, self.phi_threshold
            )

    def peer_count(self) -> int:
        with self._lock:
            return len(self._peers)

    def evidence_count(self) -> int:
        with self._lock:
            return len(self._evidence)

    def evidence(self) -> "list[dict]":
        with self._lock:
            return [record.as_dict() for record in self._evidence]

    def convicted_peers(
        self, now: int | None = None, min_grade: str = GRADE_SUSPECT
    ) -> "dict[str, dict]":
        """Peers this monitor currently grades at or past ``min_grade``
        (default: every non-healthy peer) — the accountability readout
        the chaos harness asserts against. Returns ``identity-hex ->
        {"grade", "evidence"}`` where ``evidence`` counts the retained
        records naming that peer as offender. A conviction is only as
        good as its evidence: ``faulty`` grades always carry verified
        self-authenticating records; ``suspect`` grades may rest on
        circumstantial counters (invalid signatures, forked or stale
        redeliveries) an operator weighs rather than slashing on."""
        rank = _GRADE_RANK[min_grade]
        with self._lock:
            tick = self.latest_now if now is None else now
            offenders: dict[bytes, int] = {}
            for record in self._evidence:
                offenders[record.offender] = offenders.get(record.offender, 0) + 1
            out: dict[str, dict] = {}
            for identity, card in self._peers.items():
                grade = card.grade(tick, self.stale_after, self.phi_threshold)
                if _GRADE_RANK[grade] >= rank:
                    out[identity.hex()] = {
                        "grade": grade,
                        "evidence": offenders.get(identity, 0),
                    }
            return out

    def watchdog(self, now: int | None = None) -> "list[str]":
        """Identity hexes of peers silent past their staleness threshold
        at tick ``now`` (default: the latest tick observed)."""
        with self._lock:
            return self._stale_locked(self.latest_now if now is None else now)

    def _stale_locked(self, now: int | None) -> "list[str]":
        if now is None:
            return []
        phi_threshold = self.phi_threshold
        out = []
        for identity, card in self._peers.items():
            if (now - card.last_seen) > max(
                self.stale_after, card.timeout_hint
            ) or (
                phi_threshold is not None
                and card.phi(now) >= phi_threshold
            ):
                out.append(identity.hex())
        return out

    def stale_count(self) -> int:
        with self._lock:
            return len(self._stale_locked(self.latest_now))

    # ── Alert rules ────────────────────────────────────────────────────

    def add_rule(self, rule: AlertRule) -> None:
        with self._lock:
            self._rules.append(rule)

    def rules(self) -> "list[AlertRule]":
        with self._lock:
            return list(self._rules)

    def evaluate_alerts(
        self, now: int | None = None, registry: MetricsRegistry | None = None
    ) -> "list[dict]":
        """Run every rule against the current state; returns the firing
        alerts as ``{"rule", "severity", "description", "details"}``
        dicts. Counting is edge-triggered per rule: the transition
        not-firing -> firing emits ONE ``health.alert`` flight event and
        one increment on ``hashgraph_alerts_total`` (+ the per-rule
        labelled counter) — a /healthz poll loop must not turn one
        standing condition into a counter ramp."""
        firing, _ = self._evaluate(now, registry)
        return firing

    def _evaluate(
        self, now: int | None, registry: MetricsRegistry | None
    ) -> "tuple[list[dict], dict]":
        """(firing alerts, rule-evaluation view). The view — serialized
        scorecards, evidence, stale set — is returned so snapshot() can
        reuse it instead of paying a second full serialization pass per
        readout."""
        reg = registry if registry is not None else self._registry
        phi_threshold = self.phi_threshold
        phi_edges = 0
        with self._lock:
            tick = self.latest_now if now is None else now
            if now is not None:
                self._tick_locked(now)
            peers_view: dict[str, dict] = {}
            for identity, card in self._peers.items():
                serialized = card.as_dict(
                    tick, self.stale_after, phi_threshold
                )
                peers_view[identity.hex()] = serialized
                # Rising-edge accounting for the suspicion-edges counter:
                # one increment per not-suspect -> suspect transition as
                # seen by the evaluator, never a ramp per poll.
                suspect_now = (
                    phi_threshold is not None
                    and serialized["phi"] >= phi_threshold
                )
                if suspect_now and not card.phi_suspect:
                    phi_edges += 1
                card.phi_suspect = suspect_now
            view = {
                "now": tick,
                "registry": reg,
                "peers": peers_view,
                "evidence": [record.as_dict() for record in self._evidence],
                "stale": self._stale_locked(tick),
            }
            rules = list(self._rules)
        if phi_edges:
            self._m_phi_edges.inc(phi_edges)
        firing: list[dict] = []
        edges: list[tuple[str, str, int]] = []
        for rule in rules:
            try:
                details = rule.check(view)
            except Exception:
                # A broken rule must not take the health surface down
                # with it (same contract as gauge providers).
                continue
            with self._lock:
                state = self._alert_state.setdefault(rule.name, _AlertState())
                if details:
                    if not state.firing:
                        state.firing = True
                        state.events += 1
                        edges.append((rule.name, rule.severity, len(details)))
                    firing.append(
                        {
                            "rule": rule.name,
                            "severity": rule.severity,
                            "description": rule.description,
                            "details": details,
                        }
                    )
                else:
                    state.firing = False
        for name, severity, count in edges:
            self._m_alerts.inc()
            # Label-escape the rule name (backslash, quote, newline):
            # add_rule accepts arbitrary names, and one unescaped quote
            # in a counter name would invalidate the ENTIRE /metrics
            # exposition, not just this sample.
            self._registry.counter(
                f'{ALERTS_TOTAL}{{rule="{_escape_label(name)}"}}'
            ).inc()
            flight_recorder.record(
                "health.alert", rule=name, severity=severity, details=count
            )
        return firing, view

    def snapshot(self, now: int | None = None) -> dict:
        """The full JSON-ready health report: scorecards (graded at
        ``now`` or the latest tick), evidence records, watchdog state,
        and the firing alerts. This is what ``OP_HEALTH`` serves and
        ``bench.py --health-out`` persists. The serialized state is the
        SAME view the rules just evaluated (one pass, one moment — the
        report can never show alerts disagreeing with the scorecards
        beside them)."""
        alerts, view = self._evaluate(now, None)
        with self._lock:
            rule_names = [rule.name for rule in self._rules]
            events_total = sum(s.events for s in self._alert_state.values())
        return {
            "now": view["now"],
            "peers": view["peers"],
            # Accountability digest: every peer graded past healthy in
            # THIS report (same view as the scorecards beside it). The
            # chaos harness's conviction asserts read this key; see
            # convicted_peers() for the evidence-weighted readout.
            "convicted": {
                hexid: card["grade"]
                for hexid, card in view["peers"].items()
                if card["grade"] != GRADE_HEALTHY
            },
            "evidence": view["evidence"],
            "watchdog": {
                "stale_peers": view["stale"],
                "stale_after_default": self.stale_after,
                "phi_threshold": self.phi_threshold,
            },
            "alerts": {
                "firing": alerts,
                "rules": rule_names,
                "events_total": events_total,
            },
        }

    def register_gauges(self, registry: MetricsRegistry) -> None:
        """Attach this monitor's point-in-time gauges (tracked peers,
        retained evidence, stale peers) to ``registry``, weakly bound so
        a dead monitor's contribution vanishes. Idempotent per registry:
        providers are additive across registrations, so registering the
        same monitor twice would otherwise double its contribution on
        every scrape."""
        with self._lock:
            if id(registry) in self._gauge_registries:
                return
            self._gauge_registries.add(id(registry))
            self._phi_registries.append(registry)
            known = list(self._peers)
        registry.register_gauge(TRACKED_PEERS, self.peer_count, owner=self)
        registry.register_gauge(EVIDENCE_RECORDS, self.evidence_count, owner=self)
        registry.register_gauge(STALE_PEERS, self.stale_count, owner=self)
        registry.register_gauge(PHI, self.max_phi, owner=self)
        registry.register_gauge(
            LIVENESS_SUSPECTS, self.phi_suspect_count, owner=self
        )
        # Peers seen before this registry attached still get their
        # labelled phi series (idempotent per identity via _phi_labelled).
        for identity in known:
            self._install_phi_gauge(identity)

    # ── φ-accrual readout (gauge providers + labelled installs) ────────

    def max_phi(self) -> float:
        """Worst (max) φ-accrual suspicion across tracked peers at the
        latest tick — the bare ``hashgraph_phi`` series."""
        with self._lock:
            tick = self.latest_now
            return max(
                (card.phi(tick) for card in self._peers.values()),
                default=0.0,
            )

    def phi_suspect_count(self) -> int:
        """Peers at or past the phi threshold right now (the
        ``hashgraph_liveness_suspects`` gauge)."""
        if self.phi_threshold is None:
            return 0
        with self._lock:
            tick = self.latest_now
            return sum(
                1
                for card in self._peers.values()
                if card.phi(tick) >= self.phi_threshold
            )

    def _phi_sample(self, identity: bytes) -> float:
        with self._lock:
            card = self._peers.get(identity)
            return card.phi(self.latest_now) if card is not None else 0.0

    def _install_phi_gauge(self, identity: bytes) -> None:
        """Mint ``hashgraph_phi{peer="<hex>"}`` on every attached
        registry for ``identity`` (bounded; families are permanent, so an
        evicted peer's series just reads 0.0). Never called with the
        monitor lock held — register_gauge takes registry locks."""
        with self._lock:
            if (
                identity in self._phi_labelled
                or len(self._phi_labelled) >= _MAX_PHI_LABELS
            ):
                return
            self._phi_labelled.add(identity)
            registries = list(self._phi_registries)
        name = f'{PHI}{{peer="{_escape_label(identity.hex())}"}}'
        for registry in registries:
            registry.register_gauge(
                name,
                lambda identity=identity: self._phi_sample(identity),
                owner=self,
            )

    def reset(self) -> None:
        """Drop every scorecard, evidence record, and alert edge (tests
        only — production monitors should live for the process)."""
        with self._lock:
            self._peers.clear()
            self._evidence.clear()
            self._evidence_keys.clear()
            self._alert_state.clear()
            self.latest_now = 0
            # Labelled phi installs stay (registry families are
            # permanent); the providers read 0.0 for unknown peers.
