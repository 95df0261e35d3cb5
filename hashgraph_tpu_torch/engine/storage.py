"""TorchBackedStorage: the ConsensusStorage implementation over the GPU pool.

Port of ``hashgraph_tpu/engine/storage.py`` (``TpuBackedStorage``), the
BASELINE north-star integration shape: "an execution backend exposed as a new
ConsensusStorage implementation so the existing ConsensusService API is
unchanged." Drop it into a plain
:class:`~hashgraph_tpu_torch.service.ConsensusService` and every session's
tally/mask/lifecycle state lives in the pool's tensors on the GPU; nothing else about the service changes, and
behavior stays identical to the in-memory storage (the storage contract
tests and the service differential against the JAX package enforce it).

Division of truth:
- the scalar parts a device can't hold (vote bytes, signatures, proposals,
  configs) stay in host records, exactly like the engine's SessionRecord;
- dense per-session state (tallies, voter masks, lifecycle) lives in pool
  slots and is *reconciled on every write*: `save_session`/`update_session`
  load the session's dense row into a fresh slot, so the device state is
  always current and batch consumers can operate on it directly.

This storage is the compatibility path: per-call work is scalar, as the
trait's closure-based `update_session` demands, and each write is a release,
an allocation and a row load on the device. Throughput workloads use the
batch-first :class:`~hashgraph_tpu_torch.engine.TorchConsensusEngine`, which
shares the same pool machinery.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, Hashable, Iterator, TypeVar

from ..errors import SessionNotFound
from ..scope_config import ScopeConfig
from ..session import ConsensusSession
from ..storage import ConsensusStorage
from .pool import PoolFullError, ProposalPool
from .session_sync import allocate_slot, load_session_rows

Scope = TypeVar("Scope", bound=Hashable)


class TorchBackedStorage(ConsensusStorage[Scope], Generic[Scope]):
    """Device-pool-backed ConsensusStorage (north-star integration).

    Builds its own :class:`ProposalPool` of ``capacity`` slots ×
    ``voter_capacity`` lanes on ``device`` (``"cuda"`` by default, which
    raises without a GPU) unless a ``pool`` is given, whose device it then
    uses."""

    def __init__(
        self,
        capacity: int = 4096,
        voter_capacity: int = 64,
        pool: ProposalPool | None = None,
        device="cuda",
    ):
        self._pool = (
            pool
            if pool is not None
            else ProposalPool(capacity, voter_capacity, device=device)
        )
        self._lock = threading.RLock()
        self._sessions: dict[Scope, dict[int, ConsensusSession]] = {}
        self._slots: dict[tuple[Scope, int], int] = {}
        self._configs: dict[Scope, ScopeConfig] = {}

    def pool(self) -> ProposalPool:
        return self._pool

    # ── Device reconciliation ──────────────────────────────────────────

    def _sync_slot(self, scope: Scope, session: ConsensusSession) -> None:
        """Reconcile the session's dense row: drop any previous slot and
        load a fresh one. Mutators (and save_session overwrites) can change
        ANYTHING — config, voters, expiry — so slot reuse would leave stale
        device config/lanes; a fresh allocate+load is always correct. A
        session the pool cannot hold (voter lanes exhausted, pool full,
        n > lane capacity) degrades to host-only: the slot is released and
        ``device_state_of`` reports None rather than a stale row. Only
        those two conditions make a session host-only: any error of the
        device itself propagates."""
        key = (scope, session.proposal.proposal_id)
        self._drop_slot(*key)
        if session.proposal.expected_voters_count > self._pool.voter_capacity:
            return
        try:
            slot = allocate_slot(
                self._pool, key, session.proposal, session.config,
                session.created_at,
            )
        except PoolFullError:
            return
        if not load_session_rows(self._pool, slot, session):
            self._pool.release([slot])
            return
        self._slots[key] = slot

    def _drop_slot(self, scope: Scope, proposal_id: int) -> None:
        slot = self._slots.pop((scope, proposal_id), None)
        if slot is not None:
            self._pool.release([slot])

    # ── Primitives ─────────────────────────────────────────────────────

    def save_session(self, scope: Scope, session: ConsensusSession) -> None:
        with self._lock:
            self._sessions.setdefault(scope, {})[
                session.proposal.proposal_id
            ] = session.clone()
            self._sync_slot(scope, session)

    def get_session(self, scope: Scope, proposal_id: int) -> ConsensusSession | None:
        with self._lock:
            session = self._sessions.get(scope, {}).get(proposal_id)
            return session.clone() if session is not None else None

    def remove_session(self, scope: Scope, proposal_id: int) -> ConsensusSession | None:
        with self._lock:
            scope_map = self._sessions.get(scope)
            if scope_map is None:
                return None
            session = scope_map.pop(proposal_id, None)
            # The emptied scope entry is kept, matching the in-memory
            # backend (list_scope_sessions then returns [], not None).
            if session is not None:
                self._drop_slot(scope, proposal_id)
            return session

    def list_scope_sessions(self, scope: Scope) -> list[ConsensusSession] | None:
        with self._lock:
            scope_map = self._sessions.get(scope)
            if scope_map is None:
                return None
            return [s.clone() for s in scope_map.values()]

    def stream_scope_sessions(self, scope: Scope) -> Iterator[ConsensusSession]:
        sessions = self.list_scope_sessions(scope) or []
        return iter(sessions)

    def replace_scope_sessions(
        self, scope: Scope, sessions: list[ConsensusSession]
    ) -> None:
        with self._lock:
            for pid in list(self._sessions.get(scope, {})):
                self._drop_slot(scope, pid)
            # Empty replacements keep the (empty) scope entry, matching the
            # in-memory backend.
            self._sessions[scope] = {
                s.proposal.proposal_id: s.clone() for s in sessions
            }
            for s in self._sessions[scope].values():
                self._sync_slot(scope, s)

    def list_scopes(self) -> list[Scope] | None:
        with self._lock:
            return list(self._sessions.keys()) or None

    def update_session(
        self,
        scope: Scope,
        proposal_id: int,
        mutator: Callable[[ConsensusSession], object],
    ) -> object:
        with self._lock:
            scope_map = self._sessions.get(scope)
            if not scope_map or proposal_id not in scope_map:
                raise SessionNotFound()
            session = scope_map[proposal_id]
            try:
                # Exceptions propagate; partial mutations stay (reference
                # closure semantics) — so the device row re-syncs either way.
                return mutator(session)
            finally:
                self._sync_slot(scope, session)

    def update_scope_sessions(
        self, scope: Scope, mutator: Callable[[list[ConsensusSession]], None]
    ) -> None:
        """Materialize -> mutate -> write back; a missing scope starts from
        an empty list, and dropping the last session removes the scope entry
        (matching InMemoryConsensusStorage / reference src/storage.rs:320-342)."""
        with self._lock:
            scope_map = self._sessions.setdefault(scope, {})
            sessions = list(scope_map.values())
            mutator(sessions)
            for pid in list(scope_map):
                self._drop_slot(scope, pid)
            if not sessions:
                del self._sessions[scope]
                return
            self._sessions[scope] = {
                s.proposal.proposal_id: s for s in sessions
            }
            for s in sessions:
                self._sync_slot(scope, s)

    def get_scope_config(self, scope: Scope) -> ScopeConfig | None:
        with self._lock:
            config = self._configs.get(scope)
            return config.clone() if config is not None else None

    def set_scope_config(self, scope: Scope, config: ScopeConfig) -> None:
        config.validate()
        with self._lock:
            self._configs[scope] = config.clone()

    def delete_scope(self, scope: Scope) -> None:
        with self._lock:
            for pid in list(self._sessions.get(scope, {})):
                self._drop_slot(scope, pid)
            self._sessions.pop(scope, None)
            self._configs.pop(scope, None)

    def update_scope_config(
        self, scope: Scope, updater: Callable[[ScopeConfig], None]
    ) -> None:
        with self._lock:
            config = self._configs.get(scope)
            if config is None:
                config = ScopeConfig()
            updater(config)
            config.validate()
            self._configs[scope] = config

    # ── Device-side verification helper ────────────────────────────────

    def device_state_of(self, scope: Scope, proposal_id: int) -> int | None:
        """The pool slot's lifecycle code for a session (None if the session
        is host-only). Used by tests to prove the device replica tracks the
        scalar truth."""
        slot = self._slots.get((scope, proposal_id))
        return self._pool.state_of(slot) if slot is not None else None
