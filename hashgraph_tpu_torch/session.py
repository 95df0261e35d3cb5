"""Copy of ``hashgraph_tpu/session.py`` for the PyTorch port, which imports
nothing of the JAX package.

Consensus session: per-proposal state machine and its configuration.

Mirrors the reference engine (reference: src/session.rs): a session tracks a
proposal from creation through vote collection to a terminal state, enforcing
round caps (Gossipsub fixed 2-round vs P2P dynamic ceil(2n/3)) and running the
decision kernel after every mutation. This scalar implementation is the oracle
for the dense TPU pool in hashgraph_tpu.models.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from .errors import (
    DuplicateVote,
    ConsensusNotReached,
    MaxRoundsExceeded,
    SessionNotActive,
)
from .protocol import (
    COMPUTE_CHAIN,
    calculate_max_rounds,
    decide,
    validate_proposal,
    validate_proposal_timestamp,
    validate_threshold,
    validate_timeout,
    validate_vote,
    validate_vote_chain,
)
from .scope_config import NetworkType, ScopeConfig
from .types import STILL_ACTIVE, SessionTransition
from .wire import Proposal, Vote

_U32_MAX = 0xFFFFFFFF


@dataclass(frozen=True)
class ConsensusConfig:
    """Per-session configuration (reference: src/session.rs:27-44).

    ``max_rounds == 0`` with ``use_gossipsub_rounds == False`` triggers the
    dynamic P2P cap ceil(2n/3).
    """

    consensus_threshold: float = 2.0 / 3.0
    consensus_timeout: float = 60.0
    max_rounds: int = 2
    use_gossipsub_rounds: bool = True
    liveness_criteria: bool = True

    @classmethod
    def from_scope_config(cls, config: ScopeConfig) -> "ConsensusConfig":
        """reference: src/session.rs:52-68"""
        if config.network_type == NetworkType.GOSSIPSUB:
            max_rounds = (
                config.max_rounds_override if config.max_rounds_override is not None else 2
            )
            use_gossipsub_rounds = True
        else:
            max_rounds = (
                config.max_rounds_override if config.max_rounds_override is not None else 0
            )
            use_gossipsub_rounds = False
        return cls(
            consensus_threshold=config.default_consensus_threshold,
            consensus_timeout=config.default_timeout,
            max_rounds=max_rounds,
            use_gossipsub_rounds=use_gossipsub_rounds,
            liveness_criteria=config.default_liveness_criteria_yes,
        )

    @classmethod
    def p2p(cls) -> "ConsensusConfig":
        """Dynamic ceil(2n/3) round cap (reference: src/session.rs:73-75)."""
        return cls.from_scope_config(ScopeConfig.from_network_type(NetworkType.P2P))

    @classmethod
    def gossipsub(cls) -> "ConsensusConfig":
        """Fixed 2-round flow (reference: src/session.rs:78-80)."""
        return cls.from_scope_config(ScopeConfig.from_network_type(NetworkType.GOSSIPSUB))

    def with_timeout(self, consensus_timeout: float) -> "ConsensusConfig":
        validate_timeout(consensus_timeout)
        return ConsensusConfig(
            consensus_threshold=self.consensus_threshold,
            consensus_timeout=consensus_timeout,
            max_rounds=self.max_rounds,
            use_gossipsub_rounds=self.use_gossipsub_rounds,
            liveness_criteria=self.liveness_criteria,
        )

    def with_threshold(self, consensus_threshold: float) -> "ConsensusConfig":
        validate_threshold(consensus_threshold)
        return ConsensusConfig(
            consensus_threshold=consensus_threshold,
            consensus_timeout=self.consensus_timeout,
            max_rounds=self.max_rounds,
            use_gossipsub_rounds=self.use_gossipsub_rounds,
            liveness_criteria=self.liveness_criteria,
        )

    def with_liveness_criteria(self, liveness_criteria: bool) -> "ConsensusConfig":
        return ConsensusConfig(
            consensus_threshold=self.consensus_threshold,
            consensus_timeout=self.consensus_timeout,
            max_rounds=self.max_rounds,
            use_gossipsub_rounds=self.use_gossipsub_rounds,
            liveness_criteria=liveness_criteria,
        )

    def max_round_limit(self, expected_voters_count: int) -> int:
        """reference: src/session.rs:120-128"""
        if self.use_gossipsub_rounds:
            return self.max_rounds
        if self.max_rounds == 0:
            return calculate_max_rounds(expected_voters_count, self.consensus_threshold)
        return self.max_rounds


class ConsensusStateKind(enum.Enum):
    ACTIVE = "active"
    CONSENSUS_REACHED = "consensus_reached"
    FAILED = "failed"


@dataclass(frozen=True)
class ConsensusState:
    """Session state (reference: src/session.rs:156-164)."""

    kind: ConsensusStateKind
    result: bool | None = None  # set iff kind == CONSENSUS_REACHED

    @classmethod
    def active(cls) -> "ConsensusState":
        return cls(ConsensusStateKind.ACTIVE)

    @classmethod
    def reached(cls, result: bool) -> "ConsensusState":
        return cls(ConsensusStateKind.CONSENSUS_REACHED, result)

    @classmethod
    def failed(cls) -> "ConsensusState":
        return cls(ConsensusStateKind.FAILED)

    @property
    def is_active(self) -> bool:
        return self.kind == ConsensusStateKind.ACTIVE

    @property
    def is_reached(self) -> bool:
        return self.kind == ConsensusStateKind.CONSENSUS_REACHED

    @property
    def is_failed(self) -> bool:
        return self.kind == ConsensusStateKind.FAILED


@dataclass
class ConsensusSession:
    """Per-proposal lifecycle tracker (reference: src/session.rs:166-178).

    ``tallies`` is TPU-framework-specific: owner -> yes/no records applied
    through the columnar path (:meth:`add_tally`), which deliberately
    carries no Vote objects. They count toward decisions and duplicate
    detection exactly like votes, but are absent from the proposal's
    embedded chain — the documented columnar trade-off (PARITY.md)."""

    proposal: Proposal
    state: ConsensusState
    votes: dict[bytes, Vote]  # vote_owner -> Vote, one vote per participant
    created_at: int
    config: ConsensusConfig
    tallies: dict[bytes, bool] = field(default_factory=dict)

    def clone(self) -> "ConsensusSession":
        return ConsensusSession(
            proposal=self.proposal.clone(),
            state=self.state,
            votes={k: v.clone() for k, v in self.votes.items()},
            created_at=self.created_at,
            config=self.config,
            tallies=dict(self.tallies),
        )

    @classmethod
    def _new(cls, proposal: Proposal, config: ConsensusConfig, now: int) -> "ConsensusSession":
        return cls(
            proposal=proposal,
            state=ConsensusState.active(),
            votes={},
            created_at=now,
            config=config,
        )

    @classmethod
    def from_proposal(
        cls,
        proposal: Proposal,
        scheme,
        config: ConsensusConfig,
        now: int,
        sig_verdicts=None,
        chain_error=COMPUTE_CHAIN,
        computed_hashes=None,
    ) -> tuple["ConsensusSession", SessionTransition]:
        """Validate a (possibly vote-carrying) proposal and build a session,
        replaying embedded votes from a clean round-1 state
        (reference: src/session.rs:198-221). ``sig_verdicts``/``chain_error``
        /``computed_hashes`` inject batched-path results (see
        protocol.validate_proposal)."""
        validate_proposal(
            proposal,
            scheme,
            now,
            sig_verdicts=sig_verdicts,
            chain_error=chain_error,
            computed_hashes=computed_hashes,
        )

        existing_votes = [v.clone() for v in proposal.votes]
        clean_proposal = proposal.clone()
        clean_proposal.votes = []
        clean_proposal.round = 1

        session = cls._new(clean_proposal, config, now)
        transition = session.initialize_with_votes(
            existing_votes,
            scheme,
            proposal.expiration_timestamp,
            proposal.timestamp,
            now,
            sig_verdicts=sig_verdicts,
            chain_error=chain_error,
            computed_hashes=computed_hashes,
        )
        return session, transition

    def add_vote(self, vote: Vote, now: int) -> SessionTransition:
        """Add a single (already-validated) vote
        (reference: src/session.rs:225-249). Check order is load-bearing:
        expiry -> round limit -> duplicate -> insert -> round update ->
        consensus."""
        if self.state.is_reached:
            return SessionTransition.consensus_reached(self.state.result)
        if not self.state.is_active:
            raise SessionNotActive()

        validate_proposal_timestamp(self.proposal.expiration_timestamp, now)
        self._check_round_limit(1)
        if vote.vote_owner in self.votes or vote.vote_owner in self.tallies:
            raise DuplicateVote()
        self.votes[vote.vote_owner] = vote.clone()
        self.proposal.votes.append(vote.clone())
        self._update_round(1)
        return self._check_consensus()

    def add_tally(self, owner: bytes, value: bool, now: int) -> SessionTransition:
        """Columnar analogue of :meth:`add_vote`: record one validated
        yes/no choice for an owner WITHOUT materializing a Vote object or
        touching the proposal's embedded chain. Same check order, round
        bookkeeping, and decision semantics as add_vote — this is what the
        device pool does per lane, expressed on the scalar substrate (used
        for host-spilled sessions on the columnar ingest path)."""
        if self.state.is_reached:
            return SessionTransition.consensus_reached(self.state.result)
        if not self.state.is_active:
            raise SessionNotActive()

        validate_proposal_timestamp(self.proposal.expiration_timestamp, now)
        self._check_round_limit(1)
        if owner in self.votes or owner in self.tallies:
            raise DuplicateVote()
        self.tallies[owner] = value
        self._update_round(1)
        return self._check_consensus()

    def initialize_with_votes(
        self,
        votes: list[Vote],
        scheme,
        expiration_timestamp: int,
        creation_time: int,
        now: int,
        sig_verdicts=None,
        chain_error=COMPUTE_CHAIN,
        computed_hashes=None,
    ) -> SessionTransition:
        """Batch-initialize: validate everything, then add atomically
        (reference: src/session.rs:253-298)."""
        if not self.state.is_active:
            raise SessionNotActive()

        validate_proposal_timestamp(expiration_timestamp, now)

        if not votes:
            return STILL_ACTIVE

        seen_owners: set[bytes] = set()
        for vote in votes:
            if vote.vote_owner in seen_owners:
                raise DuplicateVote()
            seen_owners.add(vote.vote_owner)

        # Distinct voters bound the batch size (reference: src/session.rs:277-282).
        if len(votes) > self.proposal.expected_voters_count:
            self.state = ConsensusState.failed()
            raise MaxRoundsExceeded()

        if chain_error is COMPUTE_CHAIN:
            validate_vote_chain(votes)
        elif chain_error is not None:
            raise chain_error
        for i, vote in enumerate(votes):
            validate_vote(
                vote,
                scheme,
                expiration_timestamp,
                creation_time,
                now,
                sig_verdict=sig_verdicts[i] if sig_verdicts is not None else None,
                computed_hash=(
                    computed_hashes[i] if computed_hashes is not None else None
                ),
            )

        self._check_round_limit(len(votes))
        self._update_round(len(votes))

        for vote in votes:
            self.votes[vote.vote_owner] = vote.clone()
            self.proposal.votes.append(vote)

        return self._check_consensus()

    def _check_round_limit(self, vote_count: int) -> None:
        """Round-cap projection (reference: src/session.rs:306-344).
        On violation the session transitions to Failed before raising."""
        if vote_count > self.proposal.expected_voters_count:
            self.state = ConsensusState.failed()
            raise MaxRoundsExceeded()

        if self.config.use_gossipsub_rounds:
            # Round 1 = proposal; ANY votes move (and keep) the session in round 2.
            if self.proposal.round == 2 or (self.proposal.round == 1 and vote_count > 0):
                projected_value = 2
            else:
                projected_value = self.proposal.round
        else:
            # P2P: current votes = round - 1; each new vote increments.
            current_votes = max(self.proposal.round - 1, 0)
            projected_value = min(current_votes + vote_count, _U32_MAX)

        if projected_value > self.config.max_round_limit(self.proposal.expected_voters_count):
            self.state = ConsensusState.failed()
            raise MaxRoundsExceeded()

    def _update_round(self, vote_count: int) -> None:
        """reference: src/session.rs:351-366"""
        if self.config.use_gossipsub_rounds:
            if self.proposal.round == 1 and vote_count > 0:
                self.proposal.round = 2
        else:
            self.proposal.round = min(self.proposal.round + vote_count, _U32_MAX)

    def tally_counts(self) -> tuple[int, int]:
        """(yes, total) over the combined participant set — votes plus
        columnar tallies, each owner in exactly one. The single source of
        the counts both :meth:`decide_now` and the engine's
        ``explain_decision`` report, so the provenance readout can never
        drift from the kernel input."""
        yes = sum(1 for v in self.votes.values() if v.vote) + sum(
            1 for t in self.tallies.values() if t
        )
        return yes, len(self.votes) + len(self.tallies)

    def decide_now(self, is_timeout: bool) -> bool | None:
        """Run the decision kernel over votes + columnar tallies (the
        combined participant set — each owner appears in exactly one)."""
        yes, total = self.tally_counts()
        return decide(
            yes,
            total,
            self.proposal.expected_voters_count,
            self.config.consensus_threshold,
            self.proposal.liveness_criteria_yes,
            is_timeout,
        )

    def _check_consensus(self) -> SessionTransition:
        """Run the decision kernel with is_timeout=False
        (reference: src/session.rs:372-387)."""
        result = self.decide_now(False)
        if result is not None:
            self.state = ConsensusState.reached(result)
            return SessionTransition.consensus_reached(result)
        self.state = ConsensusState.active()
        return STILL_ACTIVE

    def is_active(self) -> bool:
        return self.state.is_active

    def get_consensus_result(self) -> bool:
        """reference: src/session.rs:398-404"""
        if self.state.is_reached:
            return self.state.result
        raise ConsensusNotReached()
