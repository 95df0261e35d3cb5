"""TorchConsensusEngine: the vote and proposal paths of the batch engine.

Port of the vote path and the proposal-ingest path of
``hashgraph_tpu/engine/engine.py`` (``TpuConsensusEngine``) to PyTorch, with
the same observable semantics: proposals claim pool slots, votes arrive
through the scalar (:meth:`cast_vote`, :meth:`process_incoming_vote`),
batch (:meth:`ingest_votes`, :meth:`ingest_votes_pipelined`) and columnar
(:meth:`ingest_columnar`) entry points, vote-carrying proposals from peers
through :meth:`process_incoming_proposal`, :meth:`ingest_proposals` and
:meth:`deliver_proposals` (create, or extend along the validated-chain
watermark), tallies and decisions run on the device, and transitions come
back as events. Signature checks go through the admission cache
(:mod:`.verify_cache`, ``verify_cache="default"`` as in the JAX engine;
``None`` restores the uncached flow with identical statuses), and a batch
of proposals' chains is checked in one dispatch on the engine's device
(:mod:`..ops.chain`).

Division of labor:
- device (:class:`ProposalPool`): tallies, vote masks, round-cap
  projection, the decision rule, timeout sweeps — everything
  order-sensitive replays arrival-ordered in the ingest scan;
- host (this class): vote validation (reference: src/utils.rs:55-171),
  scope configs and their resolution precedence (src/service.rs:440-484),
  per-scope session registries with LRU eviction (src/service.rs:512-522),
  and the event bus.

A session the pool cannot hold (more expected voters than
``voter_capacity``, or no free slot) is served on the host, as the JAX
engine serves it: a scalar :class:`ConsensusSession` under a negative
synthetic slot id, which every entry point routes to.

Not ported yet (the JAX engine has them): session tiering, WAL and
checkpoint, health/metrics/tracing/timelines (and so the proposal path's
health, tracer and trace-binding hooks), wire-columnar and multi-scope
columnar ingest, multi-host pools (and so ``deliver_proposals``'
SESSION_NOT_FOUND misroute branch) and adaptive timeouts.
"""

from __future__ import annotations

import functools
import hashlib
import os
import threading
from dataclasses import dataclass, field
from typing import Generic, Hashable, TypeVar

import numpy as np

from ..errors import (
    ConsensusError,
    ConsensusFailed,
    InsufficientVotesAtTimeout,
    ProposalAlreadyExist,
    SessionNotFound,
    StatusCode,
    UserAlreadyVoted,
    error_for_code,
)
from ..events import BroadcastEventBus, ConsensusEventBus
from ..ops.decide import (
    STATE_ACTIVE,
    STATE_FAILED,
    STATE_REACHED_NO,
    STATE_REACHED_YES,
    required_votes_np,
)
from ..protocol import (
    COMPUTE_CHAIN,
    build_vote,
    compute_vote_hash,
    regenerate_until_unique,
    validate_proposal_timestamp,
    validate_vote,
    validate_vote_chain,
)
from ..scope_config import ScopeConfig, ScopeConfigBuilder
from ..service import (
    DEFAULT_MAX_SESSIONS_PER_SCOPE,
    ConsensusStats,
    ScopeConfigBuilderWrapper,
)
from ..session import ConsensusConfig, ConsensusSession, ConsensusState
from ..signing import ConsensusSignatureScheme, PendingVerdicts
from ..types import (
    ConsensusEvent,
    ConsensusFailedEvent,
    ConsensusReached,
    CreateProposalRequest,
)
from ..wire import Proposal, Vote
from .pool import PoolFullError, ProposalPool
from .session_sync import allocate_slot, load_session_rows, state_code_of
from .verify_cache import MISS, VerifiedVoteCache

Scope = TypeVar("Scope", bound=Hashable)

_U32_MAX = 0xFFFFFFFF

__all__ = [
    "ConsensusStats",
    "DEFAULT_MAX_SESSIONS_PER_SCOPE",
    "PendingVoteVerdicts",
    "PoolFullError",
    "SessionRecord",
    "TorchConsensusEngine",
]

# Sentinel: "compute the signature prepass inside ingest_votes" (the
# non-pipelined default) as opposed to an explicit None / prepass handle
# handed in by ingest_votes_pipelined.
_PREPASS_INLINE = object()


def _scheme_tag(scheme: type) -> bytes:
    """First 8 bytes of SHA-256 over the scheme's module path: the
    admission-cache namespace of a signature scheme."""
    return hashlib.sha256(f"{scheme.__module__}.{scheme.__qualname__}".encode()).digest()[:8]


@dataclass(slots=True)
class SessionRecord(Generic[Scope]):
    """Host-side view of one session: the scalar bookkeeping the device
    does not need. Accepted votes are kept for chain linking and proposal
    export (reference: src/utils.rs:62-77).

    A pooled session has ``slot >= 0`` and its tallies on the device. A
    host-spilled one has a negative synthetic ``slot`` and its whole state
    in ``session``, whose ``votes`` dict and proposal the record shares."""

    scope: Scope
    slot: int
    proposal: Proposal  # votes list appended in acceptance order
    config: ConsensusConfig
    created_at: int
    votes: dict[bytes, Vote] = field(default_factory=dict)  # accepted only
    session: ConsensusSession | None = None  # set when host-spilled
    seq: int = 0  # per-scope registration order (LRU tie order)

    def bump_round(self, accepted: int) -> None:
        """Host mirror of the device round update
        (reference: src/session.rs:351-366)."""
        if accepted <= 0:
            return
        if self.config.use_gossipsub_rounds:
            if self.proposal.round == 1:
                self.proposal.round = 2
        else:
            self.proposal.round = min(self.proposal.round + accepted, _U32_MAX)


class PendingVoteVerdicts(PendingVerdicts):
    """Handle for an in-flight admission-verify prepass
    (:meth:`TorchConsensusEngine.verify_votes_async`): ``collect()`` blocks
    until the signature batch resolves and returns ``(verdicts,
    computed_hashes)`` aligned with the submitted votes. Idempotent — the
    first collect does the waiting. While uncollected, a device signer's
    batch is in flight on the GPU."""


class TorchConsensusEngine(Generic[Scope]):
    """Batch consensus engine with the ConsensusService API surface, its
    state on one device.

    Capacity is fixed at construction: ``capacity`` concurrent sessions
    across all scopes, ``voter_capacity`` voter lanes per proposal.
    ``device`` defaults to ``"cuda"`` and raises without a GPU; pass
    ``device="cpu"`` to run on the CPU, where the scan runs its plain
    PyTorch version. ``verify_cache`` is ``"default"`` (a cache of this
    engine's own), a :class:`VerifiedVoteCache` to share between engines,
    or ``None`` for the uncached admission flow.
    """

    def __init__(
        self,
        signer: ConsensusSignatureScheme,
        capacity: int,
        voter_capacity: int,
        event_bus: ConsensusEventBus[Scope] | None = None,
        max_sessions_per_scope: int = DEFAULT_MAX_SESSIONS_PER_SCOPE,
        device="cuda",
        verify_cache: "VerifiedVoteCache | None | str" = "default",
    ):
        self._signer = signer
        # Memoized vote-admission verdicts (each unique vote verified once).
        # Any string but "default" would be stored as the cache object and
        # fail at the first ingest: refuse it here instead.
        if isinstance(verify_cache, str) and verify_cache != "default":
            raise ValueError(
                'verify_cache must be "default", a VerifiedVoteCache, or None'
            )
        self._verify_cache: VerifiedVoteCache | None = (
            VerifiedVoteCache() if verify_cache == "default" else verify_cache
        )
        # A shared cache must never serve one scheme's verdict to another.
        self._verify_scheme_tag = _scheme_tag(type(signer))
        self._event_bus: ConsensusEventBus[Scope] = (
            event_bus if event_bus is not None else BroadcastEventBus()
        )
        self._pool = ProposalPool(capacity, voter_capacity, device=device)
        self._max_sessions_per_scope = max_sessions_per_scope
        # One engine-wide reentrant lock, as the JAX engine holds: scalar
        # entry points funnel into ingest_votes.
        self._lock = threading.RLock()
        self._records: dict[int, SessionRecord[Scope]] = {}  # slot -> record
        self._index: dict[tuple[Scope, int], int] = {}  # (scope, pid) -> slot
        self._scopes: dict[Scope, list[int]] = {}  # scope -> slots (insertion order)
        self._scope_configs: dict[Scope, ScopeConfig] = {}
        self._scope_seq: dict[Scope, int] = {}
        self._next_host_slot = -1  # synthetic ids for host-spilled sessions
        # Columnar-path cache: per-scope (pids, slots) arrays and their
        # pid -> slot hash; dropped on any membership change.
        self._pid_tables: dict[Scope, tuple[np.ndarray, np.ndarray]] = {}
        self._pid_hashes: dict[Scope, _PidLookup] = {}

    # ── Accessors ──────────────────────────────────────────────────────

    def signer(self) -> ConsensusSignatureScheme:
        return self._signer

    def event_bus(self) -> ConsensusEventBus[Scope]:
        return self._event_bus

    def pool(self) -> ProposalPool:
        return self._pool

    def verify_cache(self) -> VerifiedVoteCache | None:
        """The memoized-admission cache (None when disabled)."""
        return self._verify_cache

    @property
    def device(self):
        return self._pool.device

    @property
    def _scheme(self) -> type[ConsensusSignatureScheme]:
        return type(self._signer)

    # ── Proposal lifecycle ─────────────────────────────────────────────

    def create_proposal(
        self,
        scope: Scope,
        request: CreateProposalRequest,
        now: int,
        config: ConsensusConfig | None = None,
    ) -> Proposal:
        """Create a local proposal and claim a pool slot
        (reference: src/service.rs:183-209)."""
        proposal = request.into_proposal(now)
        regenerate_until_unique(
            proposal, lambda pid: (scope, pid) in self._index
        )
        validate_proposal_timestamp(proposal.expiration_timestamp, now)
        resolved = self._resolve_config(scope, config, proposal)
        self._register(scope, proposal, resolved, now)
        return proposal.clone()

    def _draw_unique_pids(self, existing: np.ndarray, count: int) -> np.ndarray:
        """Batch id draw: one urandom read, vectorized collision rejection
        against ``existing`` live pids and within the batch itself (0 is
        treated as a collision: proto3 drops zero fields from the wire)."""
        ids = np.frombuffer(os.urandom(4 * count), dtype=np.uint32).astype(np.int64)
        for _ in range(64):
            bad = np.isin(ids, existing) | (ids == 0)
            _, first_idx, inverse, counts = np.unique(
                ids, return_index=True, return_inverse=True, return_counts=True
            )
            is_first = np.zeros(count, bool)
            is_first[first_idx] = True
            bad |= (counts[inverse] > 1) & ~is_first
            n_bad = int(bad.sum())
            if n_bad == 0:
                return ids
            ids[bad] = np.frombuffer(
                os.urandom(4 * n_bad), dtype=np.uint32
            ).astype(np.int64)
        raise RuntimeError("could not draw unique proposal ids")  # pragma: no cover

    def create_proposals(
        self,
        scope: Scope,
        requests: list[CreateProposalRequest],
        now: int,
        config: ConsensusConfig | None = None,
    ) -> list[Proposal]:
        """Batch counterpart of create_proposal: one device dispatch claims
        and configures every slot. Success semantics match calling
        create_proposal in a loop; the error path is batch-atomic (any
        invalid request raises before anything registers). A scope that
        would exceed its session cap takes the per-proposal path, whose
        LRU eviction interleaves with insertion as the reference's does."""
        existing = len(self._scopes.get(scope, []))
        if existing + len(requests) > self._max_sessions_per_scope:
            return [self.create_proposal(scope, r, now, config) for r in requests]
        if not requests:
            return []
        pids = self._draw_unique_pids(self._pid_table(scope)[0], len(requests))
        proposals: list[Proposal] = []
        configs: list[ConsensusConfig] = []
        # Config resolution is identical for requests sharing (expiration,
        # liveness) when no per-proposal override exists — memoize.
        cfg_cache: dict = {}
        for request, pid in zip(requests, pids.tolist()):
            proposal = request.into_proposal(now, pid=pid)
            validate_proposal_timestamp(proposal.expiration_timestamp, now)
            key = (proposal.expiration_timestamp, proposal.liveness_criteria_yes)
            resolved = cfg_cache.get(key)
            if resolved is None:
                resolved = self._resolve_config(scope, config, proposal)
                cfg_cache[key] = resolved
            proposals.append(proposal)
            configs.append(resolved)

        n_arr = np.asarray([r.expected_voters_count for r in requests], np.int64)
        thr = np.asarray([c.consensus_threshold for c in configs], np.float64)
        gossip = np.asarray([c.use_gossipsub_rounds for c in configs], bool)
        maxr = np.asarray([c.max_rounds for c in configs], np.int64)
        req_arr = required_votes_np(n_arr, thr)
        # max_round_limit semantics (reference: src/session.rs:120-128):
        # gossipsub -> max_rounds; P2P -> explicit override, else the
        # dynamic ceil(n*t) cap, which equals the required votes.
        cap_arr = np.where(gossip, maxr, np.where(maxr == 0, req_arr, maxr))
        # First fit against the free slots, in request order: a proposal
        # wider than the lane grid, or past the last free slot, spills to
        # the host (the JAX engine's _allocate_and_register).
        fits = n_arr <= self._pool.voter_capacity
        fits &= np.cumsum(fits) <= self._pool.free_slots
        fit = np.nonzero(fits)[0]
        placed = [proposals[i] for i in fit.tolist()]
        slots = self._pool.allocate_batch(
            keys=[(scope, p.proposal_id) for p in placed],
            n=n_arr[fit],
            req=req_arr[fit],
            cap=cap_arr[fit],
            gossip=gossip[fit],
            liveness=np.asarray([p.liveness_criteria_yes for p in placed], bool),
            expiry=np.asarray([p.expiration_timestamp for p in placed], np.int64),
            created_at=np.full(len(placed), now, np.int64),
        )
        slot_of = dict(zip(fit.tolist(), slots))
        # Batch-registered records keep seq 0 and leave the per-scope
        # sequence alone, as the JAX engine's batch registration does, so
        # later LRU evictions rank sessions identically.
        for i, (proposal, cfg) in enumerate(zip(proposals, configs)):
            slot = slot_of.get(i)
            self._track(
                SessionRecord(scope, slot, proposal, cfg, now)
                if slot is not None
                else self._spilled(scope, proposal, cfg, now)
            )
        self._drop_pid_cache(scope)
        return [p.clone() for p in proposals]

    def _register(
        self,
        scope: Scope,
        proposal: Proposal,
        config: ConsensusConfig,
        now: int,
        session: ConsensusSession | None = None,
    ) -> SessionRecord[Scope] | None:
        """Claim a pool slot for the proposal after the per-scope LRU
        eviction — or, when the pool cannot hold it (more expected voters
        than lanes, or no free slot), serve it on the host. Registration
        never fails on capacity, as in the JAX engine (reference service:
        no capacity limits, src/service.rs:86-97). A replayed ``session``
        (a validated network proposal) is pooled only when its voters fit
        the lanes and it carries no columnar tallies; otherwise it stays a
        host session. Returns the record, or None when the incoming
        session itself lost the LRU ranking."""
        if self._evict_for(scope, now):
            # The incoming session itself loses the LRU ranking (created_at
            # tie): never tracked, nothing allocated — the same observable
            # result as insert-then-trim.
            return None
        fits = (
            proposal.expected_voters_count <= self._pool.voter_capacity
            and (
                session is None
                or (
                    len(session.votes) <= self._pool.voter_capacity
                    # Tally-carrying sessions stay host-backed: a dense row
                    # would hold tallies the exportable session drops.
                    and not session.tallies
                )
            )
            and self._pool.free_slots > 0
        )
        if fits:
            slot = allocate_slot(
                self._pool, (scope, proposal.proposal_id), proposal, config, now
            )
            record = SessionRecord(scope, slot, proposal, config, now)
        else:
            record = self._spilled(scope, proposal, config, now, session)
        seq = self._scope_seq.get(scope, 0)
        self._scope_seq[scope] = seq + 1
        record.seq = seq
        self._track(record)
        self._drop_pid_cache(scope)
        return record

    def _spilled(
        self,
        scope: Scope,
        proposal: Proposal,
        config: ConsensusConfig,
        now: int,
        session: ConsensusSession | None = None,
    ) -> SessionRecord[Scope]:
        """A host-spilled record under the next negative synthetic slot;
        its scalar session (``session``, or a fresh one) holds the tallies
        the device would."""
        if session is None:
            session = ConsensusSession._new(proposal, config, now)
        record = SessionRecord(scope, self._next_host_slot, session.proposal,
                               config, now, session=session)
        record.votes = session.votes  # one dict: the session's
        self._next_host_slot -= 1
        return record

    def _register_session(
        self, scope: Scope, session: ConsensusSession, created_at: int
    ) -> None:
        """Load a scalar session (possibly already decided) into a fresh
        slot: the path of validated network proposals. A session the pool
        cannot hold stays host-backed (see :meth:`_register`)."""
        record = self._register(
            scope, session.proposal, session.config, created_at, session=session
        )
        if record is None or record.session is not None:
            return  # evicted at once, or host-backed: the session IS the state
        record.votes = {k: v.clone() for k, v in session.votes.items()}
        if session.votes or not session.state.is_active:
            if not load_session_rows(self._pool, record.slot, session):
                raise RuntimeError("a session that fits the lanes did not load")

    def _track(self, record: SessionRecord[Scope]) -> None:
        scope = record.scope
        self._records[record.slot] = record
        self._index[(scope, record.proposal.proposal_id)] = record.slot
        self._scopes.setdefault(scope, []).append(record.slot)

    # ── Proposals from peers ───────────────────────────────────────────

    def process_incoming_proposal(
        self,
        scope: Scope,
        proposal: Proposal,
        now: int,
        config: ConsensusConfig | None = None,
    ) -> None:
        """Validate a network proposal (signatures, chain, expiry — the full
        scalar gauntlet, reference: src/session.rs:198-221) and load the
        replayed session into the pool as a dense row. ``config``
        optionally overrides the scope-config resolution with the same
        precedence create_proposal gives its explicit override."""
        if (scope, proposal.proposal_id) in self._index:
            raise ProposalAlreadyExist()
        config = self._resolve_config(scope, config, proposal)
        # Fail fast BEFORE the signature prepass: expired gossip buys no
        # signature work and does not churn the cache.
        validate_proposal_timestamp(proposal.expiration_timestamp, now)
        # Verdicts for the embedded chain through the admission cache
        # (None: from_proposal verifies each vote inline, the scalar flow).
        sv = ch = None
        if proposal.votes and self._verify_cache is not None:
            sv, ch = self._cached_verify(proposal.votes)
        session, transition = ConsensusSession.from_proposal(
            proposal.clone(),
            self._scheme,
            config,
            now,
            sig_verdicts=sv,
            computed_hashes=ch,
        )
        # Event before save, as in the reference (src/service.rs:275-277).
        if transition.is_reached:
            self._emit(
                scope,
                ConsensusReached(
                    proposal_id=proposal.proposal_id,
                    result=transition.reached,
                    timestamp=now,
                ),
            )
        self._register_session(scope, session, now)

    def ingest_proposals(
        self,
        items: list[tuple[Scope, Proposal]],
        now: int,
        configs: "list[ConsensusConfig | None] | None" = None,
    ) -> list[int]:
        """Batch counterpart of :meth:`process_incoming_proposal`: validate
        and load many (possibly vote-carrying) proposals in bulk.

        All embedded signatures go through one admission-verify submit (a
        device signer runs them as one GPU batch), and all chains of more
        than one vote through one chain-check dispatch on the engine's
        device while that batch is in flight; then each proposal replays
        the exact scalar check sequence with the precomputed verdicts,
        hashes and chain result injected, so error precedence is the scalar
        path's. Returns one StatusCode per item (OK = registered; events
        emitted exactly as the scalar path would). ``configs`` optionally
        supplies a per-item explicit config override.
        """
        from ..convert import chain_pack_from_numpy
        from ..ops.chain import (
            CHAIN_FIELDS,
            chain_kernel_batch,
            first_chain_error,
            pack_chains,
        )

        if configs is not None and len(configs) != len(items):
            raise ValueError("configs must supply one entry per item")
        statuses = [int(StatusCode.OK)] * len(items)

        # Items that cannot pass — registered or expired at entry — stay
        # out of the verify batch and the chain check: redelivered and
        # expired chains buy no signature work. The final loop's inline
        # gauntlet gives their statuses (PROPOSAL_ALREADY_EXIST, or
        # ProposalExpired before any signature work).
        skip = [
            (scope, proposal.proposal_id) in self._index
            or now >= proposal.expiration_timestamp
            for scope, proposal in items
        ]
        flat_votes: list[Vote] = []
        spans: list[tuple[int, int] | None] = []  # (start, count) per item
        for i, (_, proposal) in enumerate(items):
            if skip[i]:
                spans.append(None)
                continue
            spans.append((len(flat_votes), len(proposal.votes)))
            flat_votes.extend(proposal.votes)
        # The signature batch is submitted now, the chain check dispatches
        # while it runs, and the verdicts are collected when both are due.
        pending_verify = (
            self._cached_verify_begin(flat_votes) if flat_votes else None
        )

        chain_errors: dict[int, ConsensusError | None] = {}
        chain_idx = [
            i for i, (_, p) in enumerate(items) if not skip[i] and len(p.votes) > 1
        ]
        if chain_idx:
            packed = chain_pack_from_numpy(
                pack_chains([items[i][1].votes for i in chain_idx]), self.device
            )
            chain_statuses = chain_kernel_batch(
                *(packed[k] for k in CHAIN_FIELDS)
            ).cpu().numpy()
            for j, i in enumerate(chain_idx):
                code = first_chain_error(chain_statuses[j])
                exc_cls = error_for_code(code) if code else None
                chain_errors[i] = exc_cls() if exc_cls is not None else None

        verdicts: list = []
        vote_hashes: list = []
        if pending_verify is not None:
            verdicts, vote_hashes = pending_verify.collect()

        for i, (scope, proposal) in enumerate(items):
            # Re-checked: an earlier item may have registered this pid.
            if (scope, proposal.proposal_id) in self._index:
                statuses[i] = int(StatusCode.PROPOSAL_ALREADY_EXIST)
                continue
            if spans[i] is None:
                # Nothing precomputed: expired at entry, or registered at
                # entry and evicted by an earlier item's per-scope cap —
                # the full scalar gauntlet, as a sequential call would run.
                sv = ch = None
                chain_error = COMPUTE_CHAIN
            else:
                start, count = spans[i]
                sv = verdicts[start:start + count] if count else None
                ch = vote_hashes[start:start + count] if count else None
                chain_error = chain_errors.get(i)
            try:
                config = self._resolve_config(
                    scope, configs[i] if configs is not None else None, proposal
                )
                session, transition = ConsensusSession.from_proposal(
                    proposal.clone(),
                    self._scheme,
                    config,
                    now,
                    sig_verdicts=sv,
                    chain_error=chain_error,
                    computed_hashes=ch,
                )
                if transition.is_reached:
                    self._emit(
                        scope,
                        ConsensusReached(
                            proposal_id=proposal.proposal_id,
                            result=transition.reached,
                            timestamp=now,
                        ),
                    )
                self._register_session(scope, session, now)
            except ConsensusError as exc:
                statuses[i] = int(exc.code)
        return statuses

    def deliver_proposal(
        self,
        scope: Scope,
        proposal: Proposal,
        now: int,
        config: ConsensusConfig | None = None,
    ) -> int:
        """Scalar :meth:`deliver_proposals` (one StatusCode int)."""
        return self.deliver_proposals(
            [(scope, proposal)], now,
            configs=[config] if config is not None else None,
        )[0]

    def deliver_proposals(
        self,
        items: "list[tuple[Scope, Proposal]]",
        now: int,
        configs: "list[ConsensusConfig | None] | None" = None,
    ) -> "list[int]":
        """Gossip-facing delivery of (possibly vote-carrying) proposals:
        create unknown sessions, EXTEND known ones along the validated-chain
        watermark, and absorb pure redeliveries for free. Per item:

        - unknown ``(scope, proposal_id)``: the full :meth:`ingest_proposals`
          gauntlet; status as that path reports it;
        - known, and the incoming chain strictly extends the accepted one
          (every accepted vote's hash matches positionally): ONLY the
          suffix is hash/signature/chain-checked and applied through the
          batch vote path. OK when every suffix vote landed (duplicates and
          post-decision extras are absorbed), else the first hard per-vote
          error. Admission failures apply nothing; apply-stage rejections
          leave earlier suffix votes applied, as the per-vote gossip path
          would;
        - known otherwise — identical, shorter or forked chain:
          PROPOSAL_ALREADY_EXIST with zero crypto.

        Items run STRICTLY in order, each against the state the previous
        ones left, so a batch equals the same deliveries made one by one.
        Consecutive unknown items with distinct pids still go as one
        :meth:`ingest_proposals` call (one verify batch, one chain check),
        and the suffixes of the first item of every key known at entry go
        through one verify batch before any item applies, with the chains
        of the unknown ones too when the cache is on
        (:meth:`_suffix_prepass`).
        """
        if configs is not None and len(configs) != len(items):
            raise ValueError("configs must supply one entry per item")
        statuses: list[int] = [0] * len(items)
        run: list[int] = []  # consecutive unknown items, distinct pids
        run_keys: set = set()
        verified = self._suffix_prepass(items, now)

        def flush_run() -> None:
            if not run:
                return
            sub = self.ingest_proposals(
                [items[j] for j in run],
                now,
                configs=[configs[j] for j in run] if configs is not None else None,
            )
            for j, code in zip(run, sub):
                statuses[j] = int(code)
            run.clear()
            run_keys.clear()

        for k, (scope, proposal) in enumerate(items):
            key = (scope, proposal.proposal_id)
            # A known pid — or one this run is about to register — must see
            # the state all earlier items produced: flush first.
            if key in self._index or key in run_keys:
                flush_run()
            slot = self._index.get(key)
            if slot is None:
                run.append(k)
                run_keys.add(key)
                continue
            record = self._records[slot]
            if k in verified:
                suffix, verdicts = verified[k]
            else:
                suffix, verdicts = self._extension_suffix(record, proposal), None
            if suffix:
                statuses[k] = self._apply_chain_suffix(record, suffix, now, verdicts)
            else:
                statuses[k] = int(StatusCode.PROPOSAL_ALREADY_EXIST)
        flush_run()
        return statuses

    def _suffix_prepass(
        self, items: "list[tuple[Scope, Proposal]]", now: int
    ) -> dict:
        """Signature verdicts for the extension suffixes of a
        :meth:`deliver_proposals` call, as ONE admission-verify batch:
        ``{item index: (suffix, (verdicts, computed_hashes))}``.

        Only the first item of each key that is known and unexpired at entry
        takes part. Earlier items of a call never touch another key's
        accepted chain (an extension applies votes of its own proposal id
        only), so that item's suffix is the one it meets when its turn
        comes. If an earlier ``ingest_proposals`` run evicted the session,
        the key is unknown by then and the entry goes unused. A verdict
        depends only on the vote's bytes, so verifying the suffixes
        together gives every item the verdicts it would get in turn; later
        items of a repeated key verify when they apply.

        With the cache on, the same batch also takes the chains of the
        first, unexpired items of keys unknown at entry: their
        ``ingest_proposals`` runs then find every verdict in the cache and
        submit nothing."""
        plan = []  # (item index, suffix)
        warm: list[Vote] = []  # unknown items' chains, for the cache
        seen: set = set()
        for k, (scope, proposal) in enumerate(items):
            key = (scope, proposal.proposal_id)
            if key in seen:
                continue
            seen.add(key)
            slot = self._index.get(key)
            if slot is None:
                if self._verify_cache is not None and now < proposal.expiration_timestamp:
                    warm.extend(proposal.votes)
                continue
            record = self._records[slot]
            if now >= record.proposal.expiration_timestamp:
                continue  # expired: no signature work
            suffix = self._extension_suffix(record, proposal)
            if suffix:
                plan.append((k, suffix))
        if not plan and not warm:
            return {}
        verdicts, hashes = self._cached_verify([v for _, s in plan for v in s] + warm)
        out, start = {}, 0
        for k, suffix in plan:
            end = start + len(suffix)
            out[k] = (suffix, (verdicts[start:end], hashes[start:end]))
            start = end
        return out

    def _extension_suffix(
        self, record: SessionRecord[Scope], proposal: Proposal
    ) -> "list[Vote] | None":
        """Suffix of ``proposal.votes`` beyond the session's accepted chain,
        or None when the incoming chain is not a strict extension of it
        (shorter, equal-length, or forked before the watermark). The
        prefix compare is bytes equality over validated hashes — no
        crypto."""
        accepted = record.proposal.votes
        incoming = proposal.votes
        if len(incoming) <= len(accepted):
            return None
        for ours, theirs in zip(accepted, incoming):
            if ours.vote_hash != theirs.vote_hash:
                return None
        return [v.clone() for v in incoming[len(accepted):]]

    def _apply_chain_suffix(
        self,
        record: SessionRecord[Scope],
        suffix: "list[Vote]",
        now: int,
        verified: "tuple[list, list[bytes]] | None" = None,
    ) -> int:
        """Validate and apply a watermark extension: hash, signature
        (admission cache, or ``verified``: the suffix's verdicts and
        computed hashes from :meth:`_suffix_prepass`) and chain-link checks
        cover ONLY the suffix.
        Admission is all-or-nothing (the first bad suffix vote rejects the
        delivery before anything mutates); apply-stage rejections leave
        earlier suffix votes applied and return the first hard code. The
        expiry fail-fast uses the proposal-level ``now >= expiration``
        check of every proposal entry point (the per-vote path expires
        strictly after)."""
        proposal = record.proposal
        # Fail fast BEFORE the signature prepass: an expired session's
        # extensions buy no signature work and do not churn the cache.
        try:
            validate_proposal_timestamp(proposal.expiration_timestamp, now)
        except ConsensusError as exc:
            return int(exc.code)
        verdicts, hashes = verified if verified is not None else self._cached_verify(suffix)
        for i, vote in enumerate(suffix):
            if vote.proposal_id != proposal.proposal_id:
                return int(StatusCode.VOTE_PROPOSAL_ID_MISMATCH)
            try:
                validate_vote(
                    vote,
                    self._scheme,
                    proposal.expiration_timestamp,
                    proposal.timestamp,
                    now,
                    sig_verdict=verdicts[i],
                    computed_hash=hashes[i],
                )
            except ConsensusError as exc:
                return int(exc.code)
        # The chain rule from the watermark on (the prefix's links were
        # checked at acceptance).
        try:
            validate_vote_chain(proposal.votes + suffix, start=len(proposal.votes))
        except ConsensusError as exc:
            return int(exc.code)
        sub = self.ingest_votes(
            [(record.scope, vote) for vote in suffix], now, pre_validated=True
        )
        # Soft codes a live session legitimately gives chain votes that
        # raced concurrent gossip: the owner already voted, or the session
        # decided mid-suffix. Anything else is a hard error.
        soft = (
            int(StatusCode.OK),
            int(StatusCode.ALREADY_REACHED),
            int(StatusCode.DUPLICATE_VOTE),
            int(StatusCode.USER_ALREADY_VOTED),
        )
        for code in sub:
            if int(code) not in soft:
                return int(code)
        return int(StatusCode.OK)

    # ── Voting ─────────────────────────────────────────────────────────

    def cast_vote(self, scope: Scope, proposal_id: int, choice: bool, now: int) -> Vote:
        """Sign, chain, and apply this peer's vote
        (reference: src/service.rs:216-237)."""
        record = self._get_record(scope, proposal_id)
        validate_proposal_timestamp(record.proposal.expiration_timestamp, now)
        identity = self._signer.identity()
        if identity in record.votes or (
            record.session is not None and identity in record.session.tallies
        ):
            raise UserAlreadyVoted()
        vote = build_vote(record.proposal, choice, self._signer, now)
        statuses = self.ingest_votes([(scope, vote)], now, pre_validated=True)
        exc = error_for_code(int(statuses[0]))
        if exc is not None:
            raise exc()
        return vote

    def cast_vote_and_get_proposal(
        self, scope: Scope, proposal_id: int, choice: bool, now: int
    ) -> Proposal:
        """reference: src/service.rs:243-253"""
        self.cast_vote(scope, proposal_id, choice, now)
        return self._get_record(scope, proposal_id).proposal.clone()

    def process_incoming_vote(self, scope: Scope, vote: Vote, now: int) -> None:
        """Scalar network-vote entry point (reference: src/service.rs:286-305):
        full host validation, then the batched device path."""
        statuses = self.ingest_votes([(scope, vote)], now)
        exc = error_for_code(int(statuses[0]))
        if exc is not None:
            raise exc()

    def _cached_verify(
        self, votes: "list[Vote]"
    ) -> "tuple[list, list[bytes]]":
        """Synchronous admission-verify prepass:
        ``_cached_verify_begin(votes).collect()``."""
        return self._cached_verify_begin(votes).collect()

    def verify_votes_async(self, votes: "list[Vote]") -> PendingVoteVerdicts:
        """Public admission-verify prepass for pipelining embedders: starts
        the vote-hash recompute, structural prechecks, cache consult and
        the signature batch NOW and returns a handle whose ``collect()``
        yields ``(verdicts, computed_hashes)`` aligned with ``votes``.
        Before rows may be ingested as validated, every verdict must be
        True and each computed hash equal to the vote's ``vote_hash``."""
        return self._cached_verify_begin(votes)

    def _cached_verify_begin(self, votes: "list[Vote]") -> PendingVoteVerdicts:
        """Signature verdicts for ``votes`` through the admission cache, in
        two halves. This half: in-batch dedup (identical votes across many
        chains collapse to one verify item), the cache consult, and ONE
        ``verify_batch_submit`` over the surviving misses. The ``collect()``
        half: await the verdicts, fan them out, fill the cache, and return
        ``(verdicts, computed_hashes)`` aligned with ``votes``.

        With the cache disabled this is a plain batched verify of every
        vote. Rows whose embedded ``vote_hash`` differs from the recomputed
        one, or with an empty owner or signature, are neither verified nor
        cached: validate_vote rejects them before it reads the verdict."""
        hashes = [compute_vote_hash(v) for v in votes]
        if self._verify_cache is None:
            if not votes:
                return PendingVoteVerdicts(lambda: ([], hashes))
            pending = self._scheme.verify_batch_submit(
                [v.vote_owner for v in votes],
                [v.signing_payload() for v in votes],
                [v.signature for v in votes],
            )
            return PendingVoteVerdicts(lambda: (list(pending.collect()), hashes))
        cache = self._verify_cache
        verdicts: list = [False] * len(votes)
        rows: list[int] = []
        keys: list[bytes] = []
        payloads: list[bytes] = []
        for i, (vote, digest) in enumerate(zip(votes, hashes)):
            if not vote.vote_owner or not vote.signature or vote.vote_hash != digest:
                continue  # verdict unreachable in validate_vote's ordering
            payload = vote.signing_payload()
            rows.append(i)
            payloads.append(payload)
            keys.append(VerifiedVoteCache.key(payload, vote.signature, self._verify_scheme_tag))
        miss_rows: dict[bytes, list[int]] = {}
        miss_payloads: dict[bytes, bytes] = {}
        for i, key, payload, hit in zip(rows, keys, payloads, cache.get_many(keys)):
            if hit is not MISS:
                verdicts[i] = hit
            else:
                miss_rows.setdefault(key, []).append(i)
                miss_payloads.setdefault(key, payload)
        if not miss_rows:
            return PendingVoteVerdicts(lambda: (verdicts, hashes))
        rep = [r[0] for r in miss_rows.values()]
        pending = self._scheme.verify_batch_submit(
            [votes[i].vote_owner for i in rep],
            list(miss_payloads.values()),
            [votes[i].signature for i in rep],
        )

        def _finish():
            fresh = pending.collect()
            for miss, verdict in zip(miss_rows.values(), fresh):
                for i in miss:
                    verdicts[i] = verdict
            cache.put_many(list(zip(miss_rows, fresh)))
            return verdicts, hashes

        return PendingVoteVerdicts(_finish)

    def _vote_prepass_begin(
        self, items: "list[tuple[Scope, Vote]]", pre_validated: bool
    ) -> "tuple[list[int], PendingVoteVerdicts] | None":
        """Start the signature prepass of an ingest_votes batch: the rows
        that have a session, submitted through the admission cache. Returns
        (row indices, pending handle), or None when the batch takes no
        prepass (pre-validated, or a single vote without the cache, which
        verifies inline).

        Safe to call for batch k+1 BEFORE batch k applies — the
        double-buffered pipeline — because ingest_votes never registers or
        evicts sessions: every row the prepass resolved stays resolved."""
        batch = len(items)
        if pre_validated or not (
            batch > 1 or (batch == 1 and self._verify_cache is not None)
        ):
            return None
        idxs = [
            i for i, (scope, vote) in enumerate(items)
            if (scope, vote.proposal_id) in self._index
        ]
        if not idxs:
            return None
        return idxs, self._cached_verify_begin([items[i][1] for i in idxs])

    def ingest_votes_pipelined(
        self,
        batches: "list[list[tuple[Scope, Vote]]]",
        now: int,
        pre_validated: bool = False,
    ) -> "list[np.ndarray]":
        """Double-buffered :meth:`ingest_votes` over consecutive batches:
        batch k+1's signature prepass is submitted BEFORE batch k applies,
        so a device signer's batch overlaps the previous batch's dispatch
        and host bookkeeping. Result-identical to ``[ingest_votes(b, now,
        pre_validated) for b in batches]``."""
        results: "list[np.ndarray]" = []
        prev = None
        for items in batches:
            items = list(items)
            prepass = self._vote_prepass_begin(items, pre_validated)
            if prev is not None:
                results.append(
                    self.ingest_votes(prev[0], now, pre_validated, _prepass=prev[1])
                )
            prev = (items, prepass)
        if prev is not None:
            results.append(
                self.ingest_votes(prev[0], now, pre_validated, _prepass=prev[1])
            )
        return results

    def ingest_votes(
        self,
        items: list[tuple[Scope, Vote]],
        now: int,
        pre_validated: bool = False,
        _prepass=_PREPASS_INLINE,
    ) -> np.ndarray:
        """The batch path: apply many votes across many sessions and scopes
        in one device dispatch.

        Per vote: resolve the session, host-validate (hash, signature,
        replay/expiry — skipped when ``pre_validated``), map owner→lane,
        then run the arrival-ordered ingest scan. Emits ConsensusReached
        for every session the batch decides. Returns int32 status codes in
        batch order (StatusCode.OK / ALREADY_REACHED are successes).

        ``_prepass`` (private) lets :meth:`ingest_votes_pipelined` hand in
        the signature prepass it already started for this batch; the
        default starts it here.
        """
        batch = len(items)
        statuses = np.zeros(batch, np.int32)
        dev_rows: list[int] = []  # indices into items that reach the device
        slots = np.empty(batch, np.int64)
        lanes = np.empty(batch, np.int32)
        values = np.empty(batch, bool)
        # Host-spilled sessions apply at once; their events queue as (batch
        # index, scope, event) and interleave with the device path's, so
        # events follow per-vote arrival order across both substrates.
        events: list[tuple[int, Scope, ConsensusEvent]] = []
        # Same-batch chain tails per record: a chained run (v2 extends the
        # tail, v3 extends v2) must see v2 as the effective tail although
        # its host-side append happens after the dispatch.
        pending_tail: dict[int, bytes] = {}

        # Batched signature verification through the admission cache:
        # verdicts and recomputed hashes injected into the per-vote check
        # sequence (exact scalar error precedence). Without the cache a
        # single unvalidated vote verifies inline.
        sig_verdicts: dict[int, object] = {}
        vote_hashes: dict[int, bytes] = {}
        if _prepass is _PREPASS_INLINE:
            _prepass = self._vote_prepass_begin(items, pre_validated)
        if _prepass is not None:
            idxs, pending = _prepass
            verdicts, hashes = pending.collect()
            sig_verdicts = dict(zip(idxs, verdicts))
            vote_hashes = dict(zip(idxs, hashes))

        for i, (scope, vote) in enumerate(items):
            slot = self._index.get((scope, vote.proposal_id))
            if slot is None:
                statuses[i] = int(StatusCode.SESSION_NOT_FOUND)
                continue
            record = self._records[slot]
            if not pre_validated:
                try:
                    validate_vote(
                        vote,
                        self._scheme,
                        record.proposal.expiration_timestamp,
                        record.proposal.timestamp,
                        now,
                        sig_verdict=sig_verdicts.get(i),
                        computed_hash=vote_hashes.get(i),
                    )
                except ConsensusError as exc:
                    statuses[i] = int(exc.code)
                    continue
            # Dangling-vote guard: a FIRST-TIME voter whose received_hash
            # names a vote this session never accepted is rejected instead
            # of appended (an empty chain has no tail, so a first vote
            # claiming a link is dangling by definition).
            if vote.vote_owner not in record.votes and (
                record.session is None
                or vote.vote_owner not in record.session.tallies
            ):
                if vote.received_hash:
                    tail = pending_tail.get(
                        slot,
                        record.proposal.votes[-1].vote_hash
                        if record.proposal.votes
                        else b"",
                    )
                    if vote.received_hash != tail:
                        statuses[i] = int(StatusCode.RECEIVED_HASH_MISMATCH)
                        continue
                pending_tail[slot] = vote.vote_hash
            if record.session is not None:
                code, event = self._host_add_vote(record, vote, now)
                statuses[i] = code
                if event is not None:
                    events.append((i, scope, event))
                continue
            lane = self._pool.lane_for(slot, vote.vote_owner)
            if lane is None:
                statuses[i] = int(StatusCode.VOTER_CAPACITY_EXCEEDED)
                continue
            slots[len(dev_rows)] = slot
            lanes[len(dev_rows)] = lane
            values[len(dev_rows)] = vote.vote
            dev_rows.append(i)

        if not dev_rows:
            for _, ev_scope, event in events:
                self._emit(ev_scope, event)
            return statuses

        k = len(dev_rows)
        dev_statuses, transitions = self._pool.ingest(
            slots[:k], lanes[:k], values[:k], now
        )
        statuses[np.asarray(dev_rows)] = dev_statuses

        # Host bookkeeping for accepted votes, in arrival order; remember the
        # last accepted vote per slot — the vote that flipped a slot that
        # ended the batch decided (OK can never follow REACHED).
        last_ok: dict[int, int] = {}
        for j, i in enumerate(dev_rows):
            if dev_statuses[j] == int(StatusCode.OK):
                _, vote = items[i]
                record = self._records[int(slots[j])]
                stored = vote.clone()  # as the scalar add_vote does
                record.votes[stored.vote_owner] = stored
                record.proposal.votes.append(stored)
                record.bump_round(1)
                last_ok[int(slots[j])] = j

        # Events in per-vote arrival order, mirroring the scalar path: the
        # deciding vote emits ConsensusReached, and every later vote to the
        # decided session re-emits it (src/session.rs:246,
        # src/service.rs:303). A STATE_FAILED transition emits nothing
        # (src/session.rs:334-343).
        newly_reached = {
            slot: new_state
            for slot, new_state in transitions
            if new_state in (STATE_REACHED_YES, STATE_REACHED_NO)
        }
        for j, i in enumerate(dev_rows):
            slot = int(slots[j])
            code = int(dev_statuses[j])
            emit_reached = (
                code == int(StatusCode.OK)
                and slot in newly_reached
                and last_ok.get(slot) == j
            ) or code == int(StatusCode.ALREADY_REACHED)
            if emit_reached:
                record = self._records[slot]
                events.append((
                    i,
                    record.scope,
                    ConsensusReached(
                        proposal_id=record.proposal.proposal_id,
                        result=self._pool.state_of(slot) == STATE_REACHED_YES,
                        timestamp=now,
                    ),
                ))
        events.sort(key=lambda t: t[0])
        for _, ev_scope, event in events:
            self._emit(ev_scope, event)
        return statuses

    def voter_gid(self, owner: bytes) -> int:
        """Intern an owner identity for the columnar ingest path
        (generation-tagged: a gid freed by a session-releasing call is
        rejected with EMPTY_VOTE_OWNER from then on)."""
        return self._pool.voter_gid(owner)

    def ingest_columnar(
        self,
        scope: Scope,
        proposal_ids: np.ndarray,
        voter_gids: np.ndarray,
        values: np.ndarray,
        now: int,
        max_depth: int = 8,
    ) -> np.ndarray:
        """The throughput path: apply an arrival-ordered vote batch given as
        dense columns — proposal ids, interned voter ids (:meth:`voter_gid`),
        yes/no values — with no per-vote Python.

        Same observable semantics as :meth:`ingest_votes` with
        ``pre_validated=True``, except that no per-vote ``Vote`` objects are
        kept host-side and events are ordered per session, not across
        sessions. A batch of fresh slots with no repeated voter takes one
        closed-form dispatch; any other batch runs the arrival-ordered scan,
        in one dispatch while the padded [slots, depth] grid stays within
        the pool's cell budget and otherwise in segments of at most
        ``max_depth`` votes per slot. Returns int32 statuses in batch
        order.
        """
        proposal_ids = np.asarray(proposal_ids, np.int64)
        voter_gids = np.asarray(voter_gids, np.int64)
        values = np.asarray(values, bool)
        statuses = np.full(
            len(proposal_ids), int(StatusCode.SESSION_NOT_FOUND), np.int32
        )
        if len(proposal_ids) == 0:
            return statuses
        found, slots = self._pid_lookup(scope).lookup(proposal_ids)
        return self._columnar_apply(
            slots, found, voter_gids, values, now, max_depth, statuses
        )

    def _columnar_apply(
        self,
        slots: np.ndarray,
        found: np.ndarray,
        voter_gids: np.ndarray,
        values: np.ndarray,
        now: int,
        max_depth: int,
        statuses: np.ndarray,
    ) -> np.ndarray:
        """Slot-resolved columnar pipeline: gid filter, lane resolution,
        the dispatch plan (fresh or segmented scan), round bookkeeping and
        event emission."""
        # Gids must be LIVE current-generation identities: out-of-range,
        # freed and stale-generation ids get a typed per-row status.
        bad_gid = ~self._pool.gids_live(voter_gids)
        if bad_gid.any():
            statuses[found & bad_gid] = int(StatusCode.EMPTY_VOTE_OWNER)
            found = found & ~bad_gid
        # Host-spilled sessions (negative slots) take their rows tally-only,
        # in arrival order: no Vote object is made up for them.
        host_rows = found & (slots < 0)
        if host_rows.any():
            for i in np.nonzero(host_rows)[0].tolist():
                record = self._records[int(slots[i])]
                code, event = self._host_add_tally(
                    record, self._pool.owner_of_gid(int(voter_gids[i])),
                    bool(values[i]), now,
                )
                statuses[i] = code
                if event is not None:
                    self._emit(record.scope, event)
            found = found & ~host_rows
        dev_rows = np.nonzero(found)[0]
        if dev_rows.size == 0:
            return statuses

        def _group(s_sorted: np.ndarray):
            b = len(s_sorted)
            is_start = np.empty(b, bool)
            is_start[0] = True
            np.not_equal(s_sorted[1:], s_sorted[:-1], out=is_start[1:])
            starts_idx = np.nonzero(is_start)[0]
            grp = np.cumsum(is_start) - 1
            col = np.arange(b) - starts_idx[grp]
            counts = np.diff(np.append(starts_idx, b))
            return s_sorted[starts_idx], starts_idx, grp, col, counts

        # ONE stable slot-sort of the batch; grouping, lane assignment,
        # depth segmentation and round bookkeeping all derive from the
        # sorted domain.
        dslots = slots[dev_rows]
        dgids = voter_gids[dev_rows]
        # Grouped-stream fast path: a proposal-major batch (each slot's rows
        # contiguous, checked as "no slot starts two runs") is already a
        # valid sorted-domain order, and its slot groups keep their order
        # of appearance. Only probed when runs are few.
        ordered = len(dslots) == 1
        if len(dslots) > 1:
            run_starts = np.empty(len(dslots), bool)
            run_starts[0] = True
            np.not_equal(dslots[1:], dslots[:-1], out=run_starts[1:])
            n_runs = int(run_starts.sum())
            if n_runs * 4 <= len(dslots):
                ordered = len(np.unique(dslots[run_starts])) == n_runs
        if ordered:
            order = np.arange(len(dslots), dtype=np.int64)
        else:
            order = np.argsort(dslots, kind="stable")
        sel = dev_rows[order]  # statuses-row index per sorted item
        s_sorted = dslots[order]
        uniq, starts_idx, grp_sorted, col_sorted, counts = _group(s_sorted)
        lanes_sorted = self._pool.fresh_lanes_grouped(
            s_sorted, voter_gids[sel] & 0xFFFFFFFF, col_sorted, uniq, counts
        )
        fast_lanes = lanes_sorted is not None
        if lanes_sorted is None:
            # General path (pre-voted slots or an in-batch duplicate voter).
            lanes_sorted = self._pool.lanes_for_batch(
                dslots, dgids, assume_live=True
            )[order]
        no_lane = lanes_sorted < 0
        if no_lane.any():
            statuses[sel[no_lane]] = int(StatusCode.VOTER_CAPACITY_EXCEEDED)
            keep = ~no_lane
            order = order[keep]
            sel = sel[keep]
            s_sorted = s_sorted[keep]
            lanes_sorted = lanes_sorted[keep]
            if len(order) == 0:
                return statuses
            uniq, starts_idx, grp_sorted, col_sorted, counts = _group(s_sorted)
        vals_sorted = values[sel]

        # Dispatch plan. Preferred: ONE closed-form (scan-free) dispatch —
        # valid when the fast lane path ran (fresh slots, no duplicate
        # voters) and every touched slot is still ACTIVE, within the padded
        # cell budget. Next: ONE scan dispatch over the whole depth (the scan
        # walks each row in arrival order however deep it is) while the
        # padded [S, depth] grid stays within the same cell budget. Past it —
        # one hot row far deeper than the rest — bounded-depth scan segments
        # (segment k holds votes [k*D, (k+1)*D) of every slot, D=max_depth).
        segs: list[tuple] = []  # (uniq_k, rows_k, cols_k, depth_k, idx_k, fresh)
        depth = int(counts.max())
        everything = np.arange(len(order), dtype=np.int64)
        if fast_lanes and self._pool.fresh_ingest_viable(uniq, depth, len(order)):
            segs.append((uniq, grp_sorted, col_sorted, depth, everything, True))
        elif depth > max_depth and not self._pool.grid_within_budget(
            len(uniq), depth, len(order)
        ):
            d = max_depth
            for k in range(-(-depth // d)):
                seg_mask = counts > k * d
                g_starts = starts_idx[seg_mask] + k * d
                g_lens = np.minimum(counts[seg_mask] - k * d, d)
                m = int(g_lens.sum())
                off = np.zeros(len(g_lens) + 1, np.int64)
                np.cumsum(g_lens, out=off[1:])
                local = np.arange(m, dtype=np.int64) - np.repeat(off[:-1], g_lens)
                idx_k = np.repeat(g_starts, g_lens) + local
                rows_k = np.repeat(
                    np.arange(int(seg_mask.sum()), dtype=np.int64), g_lens
                )
                segs.append((uniq[seg_mask], rows_k, local, d, idx_k, False))
        else:
            segs.append((uniq, grp_sorted, col_sorted, depth, everything, False))

        pendings = []
        orig_of = []  # statuses rows per pending, in dispatch item order
        for uniq_k, rows_k, cols_k, depth_k, idx_k, fresh_k in segs:
            pendings.append(
                self._pool.ingest_async_grouped(
                    uniq_k,
                    rows_k,
                    cols_k,
                    depth_k,
                    lanes_sorted[idx_k],
                    vals_sorted[idx_k],
                    now,
                    fresh=fresh_k,
                )
            )
            orig_of.append(sel[idx_k])
        results = self._pool.complete_all(pendings)

        reached_transitions: list[tuple[int, int]] = []
        for orig_rows, (seg_statuses, transitions) in zip(orig_of, results):
            statuses[orig_rows] = seg_statuses
            reached_transitions.extend(
                (slot, st) for slot, st in transitions
                if st in (STATE_REACHED_YES, STATE_REACHED_NO)
            )

        # Round bookkeeping per touched slot, via bincount over the
        # sorted-domain group index (totals are order-independent).
        sorted_statuses = statuses[sel]
        ok_m = sorted_statuses == int(StatusCode.OK)
        if ok_m.any():
            cnt = np.bincount(grp_sorted[ok_m], minlength=len(uniq))
            for g in np.nonzero(cnt)[0].tolist():
                self._records[int(uniq[g])].bump_round(int(cnt[g]))

        if not segs[0][5] and len(segs) == 1 and depth > max_depth and (
            len(reached_transitions) > 1
        ):
            # One scan dispatch where segments of max_depth votes used to go:
            # emit the deciding transitions in the order the segments made
            # them (the JAX engine's order) — by the segment of each slot's
            # deciding vote, its last accepted one — then by slot group.
            ok_idx = np.nonzero(ok_m)[0]
            ok_grp = grp_sorted[ok_idx]
            last = np.append(ok_grp[1:] != ok_grp[:-1], True)
            seg_of = np.zeros(len(uniq), np.int64)
            seg_of[ok_grp[last]] = col_sorted[ok_idx[last]] // max_depth
            group_of = dict(zip(uniq.tolist(), range(len(uniq))))
            reached_transitions.sort(key=lambda t: seg_of[group_of[t[0]]])

        # Events: one ConsensusReached per deciding transition plus one per
        # late (ALREADY_REACHED) vote — the scalar path's per-session counts;
        # cross-session order is per-slot grouped.
        for slot, new_state in reached_transitions:
            record = self._records[slot]
            self._emit(
                record.scope,
                ConsensusReached(
                    proposal_id=record.proposal.proposal_id,
                    result=new_state == STATE_REACHED_YES,
                    timestamp=now,
                ),
            )
        ar_m = sorted_statuses == int(StatusCode.ALREADY_REACHED)
        if ar_m.any():
            cnt = np.bincount(grp_sorted[ar_m], minlength=len(uniq))
            for g in np.nonzero(cnt)[0].tolist():
                slot = int(uniq[g])
                record = self._records[slot]
                event = ConsensusReached(
                    proposal_id=record.proposal.proposal_id,
                    result=self._pool.state_of(slot) == STATE_REACHED_YES,
                    timestamp=now,
                )
                for _ in range(int(cnt[g])):
                    self._emit(record.scope, event)
        return statuses

    def _drop_pid_cache(self, scope: Scope) -> None:
        self._pid_tables.pop(scope, None)
        self._pid_hashes.pop(scope, None)

    def _pid_lookup(self, scope: Scope) -> "_PidLookup":
        """Vectorized pid -> slot hash for one scope (lazily rebuilt)."""
        lookup = self._pid_hashes.get(scope)
        if lookup is None:
            lookup = _PidLookup(*self._pid_table(scope))
            self._pid_hashes[scope] = lookup
        return lookup

    def _pid_table(self, scope: Scope) -> tuple[np.ndarray, np.ndarray]:
        """(proposal_ids, slots) membership arrays for one scope; rebuilt
        lazily after any membership change."""
        table = self._pid_tables.get(scope)
        if table is None:
            scope_slots = self._scopes.get(scope, [])
            pids = np.fromiter(
                (self._records[s].proposal.proposal_id for s in scope_slots),
                np.int64,
                len(scope_slots),
            )
            table = (pids, np.fromiter(scope_slots, np.int64, len(scope_slots)))
            self._pid_tables[scope] = table
        return table

    # ── Host-spilled sessions ──────────────────────────────────────────

    def _host_add_vote(
        self, record: SessionRecord[Scope], vote: Vote, now: int
    ) -> tuple[int, ConsensusEvent | None]:
        """Apply one validated vote to a host-spilled session; returns the
        device path's status code and the event to emit, if any."""
        return self._host_apply(record, lambda s: s.add_vote(vote, now), now)

    def _host_add_tally(
        self, record: SessionRecord[Scope], owner: bytes, value: bool, now: int
    ) -> tuple[int, ConsensusEvent | None]:
        """Columnar counterpart of :meth:`_host_add_vote`: one tally, no
        Vote object, so the session's exportable chain stays valid."""
        return self._host_apply(record, lambda s: s.add_tally(owner, value, now), now)

    def _host_apply(
        self, record: SessionRecord[Scope], mutate, now: int
    ) -> tuple[int, ConsensusEvent | None]:
        """Run a session mutation and map its outcome to the status code
        the device path gives, with the ConsensusReached event it implies
        (for a vote on a decided session too, as the device path emits)."""
        already = record.session.state.is_reached
        try:
            transition = mutate(record.session)
        except ConsensusError as exc:
            return int(exc.code), None
        event = None
        if transition.is_reached:
            event = ConsensusReached(
                proposal_id=record.proposal.proposal_id,
                result=transition.reached,
                timestamp=now,
            )
        return int(StatusCode.ALREADY_REACHED if already else StatusCode.OK), event

    def _host_timeout(self, record: SessionRecord[Scope]) -> int:
        """Timeout decision for a host-spilled session; returns the dense
        state code, as pool.timeout does for a slot. Idempotent for decided
        sessions; a failed one stays failed (src/service.rs:323-373)."""
        session = record.session
        if session.state.is_active:
            result = session.decide_now(True)
            session.state = (
                ConsensusState.reached(result)
                if result is not None
                else ConsensusState.failed()
            )
        return state_code_of(session.state)

    def _state_code(self, record: SessionRecord[Scope]) -> int:
        """Lifecycle state on either substrate: the pool's host mirror for a
        pooled record, the scalar session's state for a spilled one."""
        if record.session is not None:
            return state_code_of(record.session.state)
        return self._pool.state_of(record.slot)

    # ── Timeouts ───────────────────────────────────────────────────────

    def handle_consensus_timeout(self, scope: Scope, proposal_id: int, now: int) -> bool:
        """App-driven timeout for one session
        (reference: src/service.rs:323-373). Idempotent for decided sessions;
        raises InsufficientVotesAtTimeout (after emitting ConsensusFailed)
        when undecidable."""
        slot = self._index.get((scope, proposal_id))
        if slot is None:
            raise SessionNotFound()
        record = self._records[slot]
        if record.session is not None:
            new_state = self._host_timeout(record)
        else:
            [(_, new_state)] = self._pool.timeout([slot])
        if new_state in (STATE_REACHED_YES, STATE_REACHED_NO):
            result = new_state == STATE_REACHED_YES
            self._emit(
                scope,
                ConsensusReached(proposal_id=proposal_id, result=result, timestamp=now),
            )
            return result
        self._emit(scope, ConsensusFailedEvent(proposal_id=proposal_id, timestamp=now))
        raise InsufficientVotesAtTimeout()

    def sweep_timeouts(self, now: int) -> list[tuple[Scope, int, bool | None]]:
        """Fire the timeout decision for every still-ACTIVE session whose
        expiration has passed, in one device dispatch. Returns
        (scope, proposal_id, result-or-None) per swept session and emits the
        same events as per-session timeouts. A FAILED session is not swept
        again (its tallies are frozen, so it would re-fail forever)."""
        expired: list[int] = []
        host_expired: list[int] = []
        for slot, record in self._records.items():
            if record.session is not None:
                if (
                    record.session.state.is_active
                    and record.proposal.expiration_timestamp <= now
                ):
                    host_expired.append(slot)
            elif (
                self._pool.state_of(slot) == STATE_ACTIVE
                and self._pool.meta(slot).expiry <= now
            ):
                expired.append(slot)
        # Pooled sessions in one dispatch, then the host-spilled ones, in
        # the JAX engine's order.
        swept = self._pool.timeout(expired) + [
            (slot, self._host_timeout(self._records[slot])) for slot in host_expired
        ]
        out: list[tuple[Scope, int, bool | None]] = []
        for slot, new_state in swept:
            record = self._records[slot]
            pid = record.proposal.proposal_id
            if new_state in (STATE_REACHED_YES, STATE_REACHED_NO):
                result = new_state == STATE_REACHED_YES
                self._emit(
                    record.scope,
                    ConsensusReached(proposal_id=pid, result=result, timestamp=now),
                )
                out.append((record.scope, pid, result))
            else:
                self._emit(
                    record.scope, ConsensusFailedEvent(proposal_id=pid, timestamp=now)
                )
                out.append((record.scope, pid, None))
        return out

    # ── Queries (reference: src/storage.rs:112-180 derived helpers) ────

    def get_proposal(self, scope: Scope, proposal_id: int) -> Proposal:
        return self._get_record(scope, proposal_id).proposal.clone()

    def get_consensus_result(self, scope: Scope, proposal_id: int) -> bool | None:
        """None while active; raises ConsensusFailed for a failed session
        (reference: src/storage.rs:112-126)."""
        state = self._state_code(self._get_record(scope, proposal_id))
        if state == STATE_REACHED_YES:
            return True
        if state == STATE_REACHED_NO:
            return False
        if state == STATE_FAILED:
            raise ConsensusFailed()
        return None

    def get_active_proposals(self, scope: Scope) -> list[Proposal]:
        return [
            r.proposal.clone()
            for r in self._scope_records(scope)
            if self._state_code(r) == STATE_ACTIVE
        ]

    def get_reached_proposals(self, scope: Scope) -> list[tuple[Proposal, bool]]:
        out = []
        for r in self._scope_records(scope):
            state = self._state_code(r)
            if state in (STATE_REACHED_YES, STATE_REACHED_NO):
                out.append((r.proposal.clone(), state == STATE_REACHED_YES))
        return out

    def get_scope_stats(self, scope: Scope) -> ConsensusStats:
        """reference: src/service_stats.rs:32-59 (zeros for unknown scope)."""
        stats = ConsensusStats()
        for r in self._scope_records(scope):
            stats.total_sessions += 1
            state = self._state_code(r)
            if state == STATE_ACTIVE:
                stats.active_sessions += 1
            elif state == STATE_FAILED:
                stats.failed_sessions += 1
            else:
                stats.consensus_reached += 1
        return stats

    def occupancy(self) -> dict:
        """Capacity snapshot: live sessions, device slots claimed vs the
        pool's capacity, and host-spilled sessions (negative synthetic ids
        hold no pool row)."""
        with self._lock:
            slots = list(self._records)
        device_used = sum(1 for s in slots if s >= 0)
        return {
            "live_sessions": len(slots),
            "device_slots_used": device_used,
            "host_spilled": len(slots) - device_used,
            "capacity": self._pool.capacity,
            "voter_capacity": self._pool.voter_capacity,
        }

    # ── Scope config (reference: src/service.rs:375-484) ───────────────

    def scope(self, scope: Scope) -> "ScopeConfigBuilderWrapper[Scope]":
        """Fluent per-scope configuration builder, same surface as the
        scalar service (reference: src/service.rs:558-668)."""
        existing = self._scope_configs.get(scope)
        builder = (
            ScopeConfigBuilder.from_existing(existing)
            if existing is not None
            else ScopeConfigBuilder()
        )
        return ScopeConfigBuilderWrapper(self, scope, builder)

    def set_scope_config(self, scope: Scope, config: ScopeConfig) -> None:
        config.validate()
        self._scope_configs[scope] = config

    def get_scope_config(self, scope: Scope) -> ScopeConfig | None:
        return self._scope_configs.get(scope)

    # ScopeConfigBuilderWrapper terminal hooks.
    def _initialize_scope(self, scope: Scope, config: ScopeConfig) -> None:
        self.set_scope_config(scope, config)

    def _update_scope_config(self, scope: Scope, config: ScopeConfig) -> None:
        """Create-default-then-mutate-then-validate, matching
        InMemoryConsensusStorage.update_scope_config
        (reference: src/storage.rs:366-375)."""
        existing = self._scope_configs.get(scope, ScopeConfig())
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
        existing.validate()
        self._scope_configs[scope] = existing

    def _resolve_config(
        self,
        scope: Scope,
        proposal_override: ConsensusConfig | None,
        proposal: Proposal,
    ) -> ConsensusConfig:
        """Same precedence as the service: explicit override > scope config >
        gossipsub default; timeout from the proposal's expiration window
        unless overridden; liveness always from the proposal
        (reference: src/service.rs:440-484)."""
        if proposal_override is not None:
            base = proposal_override
            timeout_seconds = base.consensus_timeout
        else:
            scope_config = self._scope_configs.get(scope)
            base = (
                ConsensusConfig.from_scope_config(scope_config)
                if scope_config is not None
                else ConsensusConfig.gossipsub()
            )
            if proposal.expiration_timestamp > proposal.timestamp:
                timeout_seconds = float(
                    proposal.expiration_timestamp - proposal.timestamp
                )
            else:
                timeout_seconds = base.consensus_timeout
        return ConsensusConfig(
            consensus_threshold=base.consensus_threshold,
            consensus_timeout=timeout_seconds,
            max_rounds=base.max_rounds,
            use_gossipsub_rounds=base.use_gossipsub_rounds,
            liveness_criteria=proposal.liveness_criteria_yes,
        )

    # ── Internals ──────────────────────────────────────────────────────

    def _get_record(self, scope: Scope, proposal_id: int) -> SessionRecord[Scope]:
        slot = self._index.get((scope, proposal_id))
        if slot is None:
            raise SessionNotFound()
        return self._records[slot]

    def _scope_records(self, scope: Scope) -> list[SessionRecord[Scope]]:
        return [self._records[s] for s in self._scopes.get(scope, [])]

    def _evict_for(self, scope: Scope, now: int) -> bool:
        """LRU-by-created_at eviction beyond the per-scope cap
        (reference: src/service.rs:512-522), applied for an incoming session
        stamped ``created_at=now`` before it is allocated: keep the newest
        ``max`` of incumbents+newcomer (ties favor incumbents, matching the
        insert-then-trim stable sort). Evicts surplus incumbents; returns
        True when the newcomer itself loses the ranking."""
        slots = self._scopes.get(scope, [])
        if len(slots) + 1 <= self._max_sessions_per_scope:
            return False
        items = [(self._records[s].created_at, self._records[s].seq, s) for s in slots]
        newcomer = (now, float("inf"), None)
        items.append(newcomer)
        items.sort(key=lambda t: t[1])
        items.sort(key=lambda t: t[0], reverse=True)
        keep = items[: self._max_sessions_per_scope]
        evicted = [s for _, _, s in items[self._max_sessions_per_scope:] if s is not None]
        if evicted:
            gone = set(evicted)
            for slot in evicted:
                record = self._records.pop(slot)
                del self._index[(scope, record.proposal.proposal_id)]
            self._scopes[scope] = [s for s in slots if s not in gone]
            # A host-spilled record holds no pool slot to release.
            self._pool.release([s for s in evicted if s >= 0])
            self._drop_pid_cache(scope)
        return newcomer not in keep

    def _emit(self, scope: Scope, event: ConsensusEvent) -> None:
        self._event_bus.publish(scope, event)


class _PidLookup:
    """Open-addressing proposal-id -> slot hash with fully vectorized
    probing. Fibonacci hashing, power-of-two size, load factor <= 0.5."""

    _GOLDEN = np.uint64(0x9E3779B97F4A7C15)

    def __init__(self, pids: np.ndarray, slots: np.ndarray):
        n = max(len(pids), 1)
        size = 1
        while size < 2 * n:
            size <<= 1
        self._shift = np.uint64(64 - (size.bit_length() - 1))
        self._mask = np.int64(size - 1)
        self.keys = np.full(size, -1, np.int64)
        self.vals = np.zeros(size, np.int64)
        if len(pids) == 0:
            return
        rem_pids = np.asarray(pids, np.int64)
        rem_slots = np.asarray(slots, np.int64)
        if (rem_pids == -1).any():
            raise ValueError("proposal id -1 collides with the hash sentinel")
        h = self._bucket(rem_pids)
        while rem_pids.size:
            # A bucket contested by several pending keys: the first occupant
            # wins, the rest advance one step (linear probing).
            empty = self.keys[h] == -1
            _, first = np.unique(h, return_index=True)
            win = np.zeros(len(h), bool)
            win[first] = True
            place = empty & win
            self.keys[h[place]] = rem_pids[place]
            self.vals[h[place]] = rem_slots[place]
            rest = ~place
            h = (h[rest] + 1) & self._mask
            rem_pids = rem_pids[rest]
            rem_slots = rem_slots[rest]

    def _bucket(self, q: np.ndarray) -> np.ndarray:
        return ((q.astype(np.uint64) * self._GOLDEN) >> self._shift).astype(np.int64)

    def lookup(self, q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Returns (found bool[B], slot int64[B]; 0 where not found)."""
        q = np.asarray(q, np.int64)
        if len(q) >= 512:
            # Fused native probe (one C pass per query, GIL released); the
            # numpy loop below pays about 12 array passes a probe round.
            from .. import native

            res = native.pid_lookup(self.keys, self.vals, int(self._shift), q)
            if res is not None:
                return res
        found = np.zeros(len(q), bool)
        out = np.zeros(len(q), np.int64)
        # -1 is the empty-bucket sentinel and is never stored.
        active = np.nonzero(q != -1)[0]
        h = self._bucket(q[active])
        while active.size:
            k = self.keys[h]
            hit = (k == q[active]) & (k != -1)
            if hit.any():
                rows = active[hit]
                found[rows] = True
                out[rows] = self.vals[h[hit]]
            cont = ~hit & (k != -1)
            active = active[cont]
            h = (h[cont] + 1) & self._mask
        return found, out


def _synchronized(fn):
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper


# Public API surface runs under the engine lock (reentrant: scalar entry
# points funnel into ingest_votes).
for _name in (
    "create_proposal",
    "create_proposals",
    "process_incoming_proposal",
    "ingest_proposals",
    "deliver_proposal",
    "deliver_proposals",
    "ingest_columnar",
    "voter_gid",
    "cast_vote",
    "cast_vote_and_get_proposal",
    "process_incoming_vote",
    "verify_votes_async",
    "ingest_votes_pipelined",
    "ingest_votes",
    "handle_consensus_timeout",
    "sweep_timeouts",
    "get_proposal",
    "get_consensus_result",
    "get_active_proposals",
    "get_reached_proposals",
    "get_scope_stats",
    "set_scope_config",
    "get_scope_config",
    "_initialize_scope",
    "_update_scope_config",
):
    setattr(
        TorchConsensusEngine,
        _name,
        _synchronized(getattr(TorchConsensusEngine, _name)),
    )
