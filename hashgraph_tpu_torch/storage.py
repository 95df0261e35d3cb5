"""Copy of ``hashgraph_tpu/storage.py`` for the PyTorch port, which imports
nothing of the JAX package.

Storage abstraction and default in-memory implementation.

The storage trait is the persistence/checkpoint abstraction of the framework
(reference: src/storage.rs:23-181): implement it against a durable backend for
crash recovery; sessions are also reconstructible from wire proposals via
``ConsensusSession.from_proposal``. In the port,
:class:`hashgraph_tpu_torch.engine.TorchBackedStorage` implements the same
interface over the GPU pool's dense tensors, with host records remaining the
source of truth.

Value semantics mirror the reference: reads return cloned sessions; mutations
go through closure-based ``update_session`` under the write lock.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, Hashable, Iterator, TypeVar

from .errors import ConsensusFailed, ConsensusNotReached, SessionNotFound
from .scope_config import ScopeConfig
from .session import ConsensusConfig, ConsensusSession
from .wire import Proposal

Scope = TypeVar("Scope", bound=Hashable)


class ConsensusStorage(Generic[Scope]):
    """Interface for storing and retrieving consensus sessions.

    Subclass to persist to a database or other backend. The scope is the
    partition key for all data. Derived query helpers are implemented on top
    of the primitives — override only for backend-side acceleration
    (reference: src/storage.rs:99-181).
    """

    # ── Primitives (13) ────────────────────────────────────────────────

    def save_session(self, scope: Scope, session: ConsensusSession) -> None:
        """Insert or overwrite by proposal_id (reference: src/storage.rs:28)."""
        raise NotImplementedError

    def get_session(self, scope: Scope, proposal_id: int) -> ConsensusSession | None:
        raise NotImplementedError

    def remove_session(self, scope: Scope, proposal_id: int) -> ConsensusSession | None:
        raise NotImplementedError

    def list_scope_sessions(self, scope: Scope) -> list[ConsensusSession] | None:
        """All sessions in a scope, or None if the scope doesn't exist."""
        raise NotImplementedError

    def stream_scope_sessions(self, scope: Scope) -> Iterator[ConsensusSession]:
        """Iterate sessions one at a time (reference: src/storage.rs:51-54)."""
        raise NotImplementedError

    def replace_scope_sessions(self, scope: Scope, sessions: list[ConsensusSession]) -> None:
        raise NotImplementedError

    def list_scopes(self) -> list[Scope] | None:
        raise NotImplementedError

    def update_session(
        self,
        scope: Scope,
        proposal_id: int,
        mutator: Callable[[ConsensusSession], object],
    ) -> object:
        """Apply a mutation atomically; raises SessionNotFound if absent."""
        raise NotImplementedError

    def update_scope_sessions(
        self, scope: Scope, mutator: Callable[[list[ConsensusSession]], None]
    ) -> None:
        raise NotImplementedError

    def get_scope_config(self, scope: Scope) -> ScopeConfig | None:
        raise NotImplementedError

    def set_scope_config(self, scope: Scope, config: ScopeConfig) -> None:
        raise NotImplementedError

    def delete_scope(self, scope: Scope) -> None:
        """Remove all data for a scope — sessions, config, everything
        (reference: src/storage.rs:87-92)."""
        raise NotImplementedError

    def update_scope_config(
        self, scope: Scope, updater: Callable[[ScopeConfig], None]
    ) -> None:
        raise NotImplementedError

    # ── Derived query helpers (reference: src/storage.rs:104-181) ──────

    def get_consensus_result(self, scope: Scope, proposal_id: int) -> bool:
        session = self.get_session(scope, proposal_id)
        if session is None:
            raise SessionNotFound()
        if session.state.is_reached:
            return session.state.result
        if session.state.is_failed:
            raise ConsensusFailed()
        raise ConsensusNotReached()

    def get_proposal(self, scope: Scope, proposal_id: int) -> Proposal:
        session = self.get_session(scope, proposal_id)
        if session is None:
            raise SessionNotFound()
        return session.proposal

    def get_proposal_config(self, scope: Scope, proposal_id: int) -> ConsensusConfig:
        session = self.get_session(scope, proposal_id)
        if session is None:
            raise SessionNotFound()
        return session.config

    def get_active_proposals(self, scope: Scope) -> list[Proposal]:
        sessions = self.list_scope_sessions(scope) or []
        return [s.proposal for s in sessions if s.is_active()]

    def get_reached_proposals(self, scope: Scope) -> dict[int, bool]:
        sessions = self.list_scope_sessions(scope) or []
        return {
            s.proposal.proposal_id: s.state.result
            for s in sessions
            if s.state.is_reached
        }


class InMemoryConsensusStorage(ConsensusStorage[Scope]):
    """In-RAM storage keyed scope -> proposal_id -> session
    (reference: src/storage.rs:188-376). Thread-safe via an RLock; reads
    return clones so callers never alias stored state."""

    def __init__(self):
        self._lock = threading.RLock()
        self._sessions: dict[Scope, dict[int, ConsensusSession]] = {}
        self._scope_configs: dict[Scope, ScopeConfig] = {}

    def save_session(self, scope: Scope, session: ConsensusSession) -> None:
        with self._lock:
            self._sessions.setdefault(scope, {})[session.proposal.proposal_id] = (
                session.clone()
            )

    def get_session(self, scope: Scope, proposal_id: int) -> ConsensusSession | None:
        with self._lock:
            session = self._sessions.get(scope, {}).get(proposal_id)
            return session.clone() if session is not None else None

    def remove_session(self, scope: Scope, proposal_id: int) -> ConsensusSession | None:
        with self._lock:
            scope_sessions = self._sessions.get(scope)
            if scope_sessions is None:
                return None
            return scope_sessions.pop(proposal_id, None)

    def list_scope_sessions(self, scope: Scope) -> list[ConsensusSession] | None:
        with self._lock:
            scope_sessions = self._sessions.get(scope)
            if scope_sessions is None:
                return None
            return [s.clone() for s in scope_sessions.values()]

    def stream_scope_sessions(self, scope: Scope) -> Iterator[ConsensusSession]:
        # Snapshot under the lock, yield outside it (the reference's impl
        # equally materializes a Vec before iterating, src/storage.rs:266-276).
        with self._lock:
            snapshot = [s.clone() for s in self._sessions.get(scope, {}).values()]
        return iter(snapshot)

    def replace_scope_sessions(self, scope: Scope, sessions: list[ConsensusSession]) -> None:
        with self._lock:
            self._sessions[scope] = {
                s.proposal.proposal_id: s.clone() for s in sessions
            }

    def list_scopes(self) -> list[Scope] | None:
        with self._lock:
            scopes = list(self._sessions.keys())
        return scopes or None

    def update_session(
        self,
        scope: Scope,
        proposal_id: int,
        mutator: Callable[[ConsensusSession], object],
    ) -> object:
        with self._lock:
            session = self._sessions.get(scope, {}).get(proposal_id)
            if session is None:
                raise SessionNotFound()
            return mutator(session)

    def update_scope_sessions(
        self, scope: Scope, mutator: Callable[[list[ConsensusSession]], None]
    ) -> None:
        """Materialize -> mutate -> write back; dropping the last session
        removes the scope entry (reference: src/storage.rs:320-342)."""
        with self._lock:
            scope_sessions = self._sessions.setdefault(scope, {})
            sessions_list = list(scope_sessions.values())
            mutator(sessions_list)
            if not sessions_list:
                del self._sessions[scope]
                return
            self._sessions[scope] = {
                s.proposal.proposal_id: s for s in sessions_list
            }

    def get_scope_config(self, scope: Scope) -> ScopeConfig | None:
        with self._lock:
            config = self._scope_configs.get(scope)
            return config.clone() if config is not None else None

    def set_scope_config(self, scope: Scope, config: ScopeConfig) -> None:
        config.validate()
        with self._lock:
            self._scope_configs[scope] = config.clone()

    def delete_scope(self, scope: Scope) -> None:
        with self._lock:
            self._sessions.pop(scope, None)
            self._scope_configs.pop(scope, None)

    def update_scope_config(
        self, scope: Scope, updater: Callable[[ScopeConfig], None]
    ) -> None:
        """Create-default-then-mutate, validating after
        (reference: src/storage.rs:366-375)."""
        with self._lock:
            config = self._scope_configs.setdefault(scope, ScopeConfig())
            updater(config)
            config.validate()
