"""Copy of ``hashgraph_tpu/service.py`` for the PyTorch port, which imports
nothing of the JAX package.

ConsensusService: the single entry point for consensus operations.

One service instance is one peer's view (reference: src/service.rs:21-29): it
holds the storage handle, event bus, and that peer's signer. Multi-peer setups
build one service per peer, optionally sharing storage and event bus. The
library performs no I/O: the application supplies transport (calling the
``process_incoming_*`` methods on receipt), timers (calling
``handle_consensus_timeout``), and the clock (every method takes ``now`` in
seconds since the Unix epoch).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Generic, Hashable, TypeVar

from .errors import (
    ProposalAlreadyExist,
    InsufficientVotesAtTimeout,
    ScopeNotFound,
    SessionNotFound,
    UserAlreadyVoted,
)
from .events import BroadcastEventBus, ConsensusEventBus
from .protocol import (
    build_vote,
    calculate_consensus_result,
    regenerate_until_unique,
    validate_proposal_timestamp,
    validate_vote,
)
from .scope_config import NetworkType, ScopeConfig, ScopeConfigBuilder
from .session import ConsensusConfig, ConsensusSession, ConsensusState
from .signing import ConsensusSignatureScheme, EthereumConsensusSigner
from .storage import ConsensusStorage, InMemoryConsensusStorage
from .types import (
    ConsensusEvent,
    ConsensusFailedEvent,
    ConsensusReached,
    CreateProposalRequest,
    SessionTransition,
)
from .wire import Proposal, Vote

Scope = TypeVar("Scope", bound=Hashable)

DEFAULT_MAX_SESSIONS_PER_SCOPE = 10  # reference: src/service.rs:89-90


@dataclass
class ConsensusStats:
    """Aggregate per-scope counters (reference: src/service_stats.rs:10-19)."""

    total_sessions: int = 0
    active_sessions: int = 0
    failed_sessions: int = 0
    consensus_reached: int = 0


class ConsensusService(Generic[Scope]):
    """The main consensus service (reference: src/service.rs:39-51).

    Generic over the scope key type; storage / event-bus / signer backends are
    injected. The signer instance signs this peer's outgoing votes; the
    signer's *class* verifies incoming ones.
    """

    def __init__(
        self,
        storage: ConsensusStorage[Scope],
        event_bus: ConsensusEventBus[Scope],
        signer: ConsensusSignatureScheme,
        max_sessions_per_scope: int = DEFAULT_MAX_SESSIONS_PER_SCOPE,
    ):
        self._storage = storage
        self._event_bus = event_bus
        self._signer = signer
        self._max_sessions_per_scope = max_sessions_per_scope

    @classmethod
    def new_with_components(
        cls,
        storage: ConsensusStorage[Scope],
        event_bus: ConsensusEventBus[Scope],
        signer: ConsensusSignatureScheme,
        max_sessions_per_scope: int = DEFAULT_MAX_SESSIONS_PER_SCOPE,
    ) -> "ConsensusService[Scope]":
        """Constructor matching the reference's generic ctor name
        (reference: src/service.rs:126-139)."""
        return cls(storage, event_bus, signer, max_sessions_per_scope)

    @classmethod
    def default_service(
        cls,
        signer: ConsensusSignatureScheme | None = None,
        max_sessions_per_scope: int = DEFAULT_MAX_SESSIONS_PER_SCOPE,
    ) -> "ConsensusService":
        """Ready-to-use service: in-memory storage, broadcast events,
        Ethereum signer (reference: src/service.rs:77-109,
        DefaultConsensusService)."""
        return cls(
            InMemoryConsensusStorage(),
            BroadcastEventBus(),
            signer if signer is not None else EthereumConsensusSigner.random(),
            max_sessions_per_scope,
        )

    @classmethod
    def new(cls, signer: ConsensusSignatureScheme) -> "ConsensusService":
        """Default-backends ctor under the reference's name
        (reference: src/service.rs:86-91)."""
        return cls.default_service(signer)

    @classmethod
    def new_with_max_sessions(
        cls, signer: ConsensusSignatureScheme, max_sessions_per_scope: int
    ) -> "ConsensusService":
        """reference: src/service.rs:99-109"""
        return cls.default_service(signer, max_sessions_per_scope)

    # ── Accessors (reference: src/service.rs:141-164) ──────────────────

    def storage(self) -> ConsensusStorage[Scope]:
        return self._storage

    def event_bus(self) -> ConsensusEventBus[Scope]:
        return self._event_bus

    def signer(self) -> ConsensusSignatureScheme:
        return self._signer

    @property
    def _scheme(self) -> type[ConsensusSignatureScheme]:
        return type(self._signer)

    # ── Consensus operations (reference: src/service.rs:166-373) ──────

    def create_proposal(
        self, scope: Scope, request: CreateProposalRequest, now: int
    ) -> Proposal:
        """Create a proposal and start its voting session
        (reference: src/service.rs:183-190). The application must schedule
        ``handle_consensus_timeout`` itself."""
        return self.create_proposal_with_config(scope, request, None, now)

    def create_proposal_with_config(
        self,
        scope: Scope,
        request: CreateProposalRequest,
        config: ConsensusConfig | None,
        now: int,
    ) -> Proposal:
        """reference: src/service.rs:195-209"""
        proposal = request.into_proposal(now)
        regenerate_until_unique(
            proposal,
            lambda pid: self._storage.get_session(scope, pid) is not None,
        )
        resolved = self._resolve_config(scope, config, proposal)
        session, _ = ConsensusSession.from_proposal(
            proposal.clone(), self._scheme, resolved, now
        )
        self._storage.save_session(scope, session)
        self._trim_scope_sessions(scope)
        return proposal

    def cast_vote(self, scope: Scope, proposal_id: int, choice: bool, now: int) -> Vote:
        """Sign and chain a vote by this peer (reference: src/service.rs:216-237).
        The returned vote is ready for network propagation."""
        session = self._get_session(scope, proposal_id)
        validate_proposal_timestamp(session.proposal.expiration_timestamp, now)

        if self._signer.identity() in session.votes:
            raise UserAlreadyVoted()

        vote = build_vote(session.proposal, choice, self._signer, now)
        transition = self._storage.update_session(
            scope, proposal_id, lambda s: s.add_vote(vote, now)
        )
        self._handle_transition(scope, proposal_id, transition, now)
        return vote

    def cast_vote_and_get_proposal(
        self, scope: Scope, proposal_id: int, choice: bool, now: int
    ) -> Proposal:
        """Cast and return the updated proposal for immediate gossip
        (reference: src/service.rs:243-253)."""
        self.cast_vote(scope, proposal_id, choice, now)
        return self._get_session(scope, proposal_id).proposal

    def process_incoming_proposal(self, scope: Scope, proposal: Proposal, now: int) -> None:
        """Validate and store a proposal delivered by the network layer
        (reference: src/service.rs:263-279)."""
        if self._storage.get_session(scope, proposal.proposal_id) is not None:
            raise ProposalAlreadyExist()
        config = self._resolve_config(scope, None, proposal)
        session, transition = ConsensusSession.from_proposal(
            proposal, self._scheme, config, now
        )
        # Event before save, as in the reference (src/service.rs:275-277).
        self._handle_transition(scope, session.proposal.proposal_id, transition, now)
        self._storage.save_session(scope, session)
        self._trim_scope_sessions(scope)

    def process_incoming_vote(self, scope: Scope, vote: Vote, now: int) -> None:
        """Validate and apply a network-delivered vote
        (reference: src/service.rs:286-305)."""
        session = self._get_session(scope, vote.proposal_id)
        validate_vote(
            vote,
            self._scheme,
            session.proposal.expiration_timestamp,
            session.proposal.timestamp,
            now,
        )
        proposal_id = vote.proposal_id
        transition = self._storage.update_session(
            scope, proposal_id, lambda s: s.add_vote(vote, now)
        )
        self._handle_transition(scope, proposal_id, transition, now)

    def handle_consensus_timeout(self, scope: Scope, proposal_id: int, now: int) -> bool:
        """Run the timeout decision: silent peers join the quorum under the
        liveness flag (reference: src/service.rs:323-373). Idempotent for
        already-decided sessions. Raises InsufficientVotesAtTimeout (after
        emitting ConsensusFailed) when no result is determinable."""

        def mutator(session: ConsensusSession) -> bool | None:
            if session.state.is_reached:
                return session.state.result
            result = calculate_consensus_result(
                session.votes,
                session.proposal.expected_voters_count,
                session.config.consensus_threshold,
                session.proposal.liveness_criteria_yes,
                True,
            )
            if result is not None:
                session.state = ConsensusState.reached(result)
                return result
            session.state = ConsensusState.failed()
            return None

        result = self._storage.update_session(scope, proposal_id, mutator)
        if result is not None:
            self._emit_event(
                scope, ConsensusReached(proposal_id=proposal_id, result=result, timestamp=now)
            )
            return result
        self._emit_event(scope, ConsensusFailedEvent(proposal_id=proposal_id, timestamp=now))
        raise InsufficientVotesAtTimeout()

    # ── Scope management (reference: src/service.rs:375-438) ───────────

    def scope(self, scope: Scope) -> "ScopeConfigBuilderWrapper[Scope]":
        """Fluent builder for scope configuration::

            service.scope("s").with_network_type(NetworkType.P2P) \\
                   .with_threshold(0.75).initialize()
        """
        existing = self._storage.get_scope_config(scope)
        builder = (
            ScopeConfigBuilder.from_existing(existing)
            if existing is not None
            else ScopeConfigBuilder()
        )
        return ScopeConfigBuilderWrapper(self, scope, builder)

    def _initialize_scope(self, scope: Scope, config: ScopeConfig) -> None:
        config.validate()
        self._storage.set_scope_config(scope, config)

    def _update_scope_config(self, scope: Scope, config: ScopeConfig) -> None:
        def updater(existing: ScopeConfig) -> None:
            existing.network_type = config.network_type
            existing.default_consensus_threshold = config.default_consensus_threshold
            existing.default_timeout = config.default_timeout
            existing.default_liveness_criteria_yes = config.default_liveness_criteria_yes
            existing.max_rounds_override = config.max_rounds_override
            existing.demote_after = config.demote_after
            existing.evict_decided_after = config.evict_decided_after
            existing.decide_p99_ms = config.decide_p99_ms
            existing.timeout_min = config.timeout_min
            existing.timeout_max = config.timeout_max

        self._storage.update_scope_config(scope, updater)

    # ── Config resolution (reference: src/service.rs:440-484) ──────────

    def _resolve_config(
        self,
        scope: Scope,
        proposal_override: ConsensusConfig | None,
        proposal: Proposal | None,
    ) -> ConsensusConfig:
        """Priority: explicit override > scope config > gossipsub default;
        then proposal-field overrides (timeout from expiration window unless
        explicitly overridden; liveness always from the proposal)."""
        has_explicit_override = proposal_override is not None
        if proposal_override is not None:
            base_config = proposal_override
        else:
            scope_config = self._storage.get_scope_config(scope)
            if scope_config is not None:
                base_config = ConsensusConfig.from_scope_config(scope_config)
            else:
                base_config = ConsensusConfig.gossipsub()

        if proposal is None:
            return base_config

        if has_explicit_override:
            timeout_seconds = base_config.consensus_timeout
        elif proposal.expiration_timestamp > proposal.timestamp:
            timeout_seconds = float(proposal.expiration_timestamp - proposal.timestamp)
        else:
            timeout_seconds = base_config.consensus_timeout

        return ConsensusConfig(
            consensus_threshold=base_config.consensus_threshold,
            consensus_timeout=timeout_seconds,
            max_rounds=base_config.max_rounds,
            use_gossipsub_rounds=base_config.use_gossipsub_rounds,
            liveness_criteria=proposal.liveness_criteria_yes,
        )

    # ── Internals (reference: src/service.rs:486-555) ──────────────────

    def _get_session(self, scope: Scope, proposal_id: int) -> ConsensusSession:
        session = self._storage.get_session(scope, proposal_id)
        if session is None:
            raise SessionNotFound()
        return session

    def _trim_scope_sessions(self, scope: Scope) -> None:
        """Silent LRU-by-created_at eviction beyond the per-scope cap
        (reference: src/service.rs:512-522)."""

        def mutator(sessions: list[ConsensusSession]) -> None:
            if len(sessions) <= self._max_sessions_per_scope:
                return
            sessions.sort(key=lambda s: s.created_at, reverse=True)
            del sessions[self._max_sessions_per_scope :]

        self._storage.update_scope_sessions(scope, mutator)

    def _list_scope_sessions(self, scope: Scope) -> list[ConsensusSession]:
        sessions = self._storage.list_scope_sessions(scope)
        if sessions is None:
            raise ScopeNotFound()
        return sessions

    def _handle_transition(
        self, scope: Scope, proposal_id: int, transition: SessionTransition, now: int
    ) -> None:
        if transition.is_reached:
            self._emit_event(
                scope,
                ConsensusReached(
                    proposal_id=proposal_id, result=transition.reached, timestamp=now
                ),
            )

    def _emit_event(self, scope: Scope, event: ConsensusEvent) -> None:
        self._event_bus.publish(scope, event)

    # ── Stats (reference: src/service_stats.rs:32-59) ──────────────────

    def get_scope_stats(self, scope: Scope) -> ConsensusStats:
        """Counters for monitoring; zeros for unknown scopes."""
        try:
            sessions = self._list_scope_sessions(scope)
        except ScopeNotFound:
            return ConsensusStats()
        return ConsensusStats(
            total_sessions=len(sessions),
            active_sessions=sum(1 for s in sessions if s.is_active()),
            failed_sessions=sum(1 for s in sessions if s.state.is_failed),
            consensus_reached=sum(1 for s in sessions if s.state.is_reached),
        )


class ScopeConfigBuilderWrapper(Generic[Scope]):
    """Builder bound to a service+scope with terminal ``initialize``/``update``
    (reference: src/service.rs:558-668)."""

    def __init__(
        self,
        service: ConsensusService[Scope],
        scope: Scope,
        builder: ScopeConfigBuilder,
    ):
        self._service = service
        self._scope = scope
        self._builder = builder

    def with_network_type(self, network_type: NetworkType) -> "ScopeConfigBuilderWrapper[Scope]":
        self._builder.with_network_type(network_type)
        return self

    def with_threshold(self, threshold: float) -> "ScopeConfigBuilderWrapper[Scope]":
        self._builder.with_threshold(threshold)
        return self

    def with_timeout(self, timeout_seconds: float) -> "ScopeConfigBuilderWrapper[Scope]":
        self._builder.with_timeout(timeout_seconds)
        return self

    def with_liveness_criteria(self, liveness_criteria_yes: bool) -> "ScopeConfigBuilderWrapper[Scope]":
        self._builder.with_liveness_criteria(liveness_criteria_yes)
        return self

    def with_max_rounds(self, max_rounds: int | None) -> "ScopeConfigBuilderWrapper[Scope]":
        self._builder.with_max_rounds(max_rounds)
        return self

    def with_demote_after(self, seconds: float | None) -> "ScopeConfigBuilderWrapper[Scope]":
        self._builder.with_demote_after(seconds)
        return self

    def with_evict_decided_after(self, seconds: float | None) -> "ScopeConfigBuilderWrapper[Scope]":
        self._builder.with_evict_decided_after(seconds)
        return self

    def with_decide_p99_ms(self, ms: float | None) -> "ScopeConfigBuilderWrapper[Scope]":
        self._builder.with_decide_p99_ms(ms)
        return self

    def with_timeout_bounds(
        self, timeout_min: float | None, timeout_max: float | None
    ) -> "ScopeConfigBuilderWrapper[Scope]":
        self._builder.with_timeout_bounds(timeout_min, timeout_max)
        return self

    def p2p_preset(self) -> "ScopeConfigBuilderWrapper[Scope]":
        self._builder.p2p_preset()
        return self

    def gossipsub_preset(self) -> "ScopeConfigBuilderWrapper[Scope]":
        self._builder.gossipsub_preset()
        return self

    def strict_consensus(self) -> "ScopeConfigBuilderWrapper[Scope]":
        self._builder.strict_consensus()
        return self

    def fast_consensus(self) -> "ScopeConfigBuilderWrapper[Scope]":
        self._builder.fast_consensus()
        return self

    def with_network_defaults(self, network_type: NetworkType) -> "ScopeConfigBuilderWrapper[Scope]":
        self._builder.with_network_defaults(network_type)
        return self

    def initialize(self) -> None:
        """Persist as the scope's configuration (validated)."""
        self._service._initialize_scope(self._scope, self._builder.build())

    def update(self) -> None:
        """Overwrite the existing scope configuration (validated)."""
        self._service._update_scope_config(self._scope, self._builder.build())

    def get_config(self) -> ScopeConfig:
        return self._builder.get_config()
