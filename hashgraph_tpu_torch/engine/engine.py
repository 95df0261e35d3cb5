"""TorchConsensusEngine: the vote, proposal and wire paths of the batch engine.

Port of ``hashgraph_tpu/engine/engine.py`` (``TpuConsensusEngine``) to
PyTorch, with the same observable semantics: proposals claim pool slots
(:meth:`create_proposal`, :meth:`create_proposals`,
:meth:`create_proposals_multi`), votes arrive through the scalar
(:meth:`cast_vote`, :meth:`process_incoming_vote`), batch
(:meth:`ingest_votes`, :meth:`ingest_votes_pipelined`), columnar
(:meth:`ingest_columnar`, :meth:`ingest_columnar_multi`, optionally
retaining the accepted rows' wire bytes) and validated wire-columnar
(:meth:`ingest_wire_columnar`, :meth:`wire_verify_begin`) entry points,
vote-carrying proposals from peers through :meth:`process_incoming_proposal`,
:meth:`ingest_proposals` and :meth:`deliver_proposals` (create, or extend
along the validated-chain watermark), tallies and decisions run on the
device, and transitions come back as events. Signature checks go through
the admission cache (:mod:`.verify_cache`, ``verify_cache="default"`` as in
the JAX engine; ``None`` restores the uncached flow with identical
statuses), and a batch of proposals' chains is checked in one dispatch on
the engine's device (:mod:`..ops.chain`). Sessions export to and load from
a ``ConsensusStorage`` (:meth:`save_to_storage`, :meth:`load_from_storage`),
which the write-ahead log (:mod:`..wal`) checkpoints through.

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

Idle sessions move out of the pool into a compact tier of snapshot item
bytes (:meth:`demote_session`, or the per-scope TTLs of
:meth:`lifecycle_sweep`, which :meth:`sweep_timeouts` runs at its end), and
decided ones past their TTL are garbage-collected (:meth:`gc_sessions`,
the replay entry point of the WAL's GC records). A demoted session stays
addressable: point reads and mutations page it back in, enumerations read
through the tier, so callers see an engine without a tier.

Observability is the JAX engine's, on this package's own process-wide
objects (:mod:`..obs`): the registry families and scrape-time gauges, the
tracer counts and spans (``observed_span`` around the calls that return
host arrays), per-proposal timelines feeding the decision-latency
histogram and the SLO engine, the health monitor's scorecards, evidence and
watchdog, flight-recorder notes (and a dump on an engine fault), the
distributed trace bound to each proposal, and the advisory adaptive
timeouts. Read them through :meth:`health_report`,
:meth:`explain_decision`, :meth:`proposal_timeline`,
:meth:`trace_context_of`, :meth:`adaptive_timeout` and
:meth:`adaptive_timeout_snapshot`.

The engine runs on any pool the caller passes (``pool=``): a
:class:`~..parallel.ShardedPool` over several devices, or a
:class:`~..parallel.MultiHostPool` across the processes of a gloo group.
On a multi-host pool the engine runs SPMD, as the JAX engine does:
control-plane calls (create and process proposals, ``delete_scope``,
timeouts) are replicated with identical arguments on every process and
mint identical proposal ids; each process ingests votes for its own slots
only (a vote for another process's session reports SESSION_NOT_FOUND,
before validation, and :meth:`is_local` says where to route it); every
ingest call joins the fleet's agreed dispatch cadence, empty ones
included; and each event is emitted by exactly one process. Session
tiering is refused there (:meth:`demote_session` raises,
:meth:`lifecycle_sweep` does nothing).
"""

from __future__ import annotations

import functools
import hashlib
import os
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Generic, Hashable, TypeVar

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

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
from ..obs import (
    CHAIN_KERNEL_SECONDS,
    CHAIN_SUFFIX_LENGTH,
    DECISION_LATENCY,
    DECISIONS_TOTAL,
    DEFAULT_SIZE_BUCKETS,
    DEVICE_INGEST_SECONDS,
    INGEST_BATCH_SIZE,
    LIVE_PROPOSALS,
    PROPOSALS_CREATED_TOTAL,
    TIER_BYTES,
    TIER_DEMOTED_SESSIONS,
    TIER_DEMOTIONS_TOTAL,
    TIER_GC_TOTAL,
    TIER_PROMOTIONS_TOTAL,
    TIMEOUTS_FIRED_TOTAL,
    VERIFIED_SIGNATURES_TOTAL,
    VERIFY_BATCH_SECONDS,
    VOTE_TABLE_OCCUPANCY,
    VOTES_ACCEPTED_TOTAL,
    VOTES_TOTAL,
    WIRE_APPLY_ROWS_TOTAL,
    WIRE_DEVICE_DISPATCHES_TOTAL,
    TimelineStore,
    flight_recorder,
    observed_span,
    slo_engine,
    stage_span,
)
from ..obs import health_monitor as default_health_monitor
from ..obs import registry as default_registry
from ..obs.health import HealthMonitor
from ..obs.prometheus import _escape_label
from ..obs.registry import Counter
from ..obs.timeline import OUTCOME_FAILED, OUTCOME_NO, OUTCOME_YES
from ..obs.trace import TraceContext, current_context, trace_store
from ..ops.decide import (
    STATE_ACTIVE,
    STATE_FAILED,
    STATE_REACHED_NO,
    STATE_REACHED_YES,
    required_votes_np,
)
from ..protocol import (
    _F64_EPSILON,
    _TWO_THIRDS,
    COMPUTE_CHAIN,
    build_vote,
    calculate_required_votes,
    calculate_threshold_based_value,
    compute_vote_hash,
    regenerate_until_unique,
    validate_proposal_timestamp,
    validate_vote,
    validate_vote_chain,
)
from ..scope_config import DEFAULT_TIMEOUT_SECONDS, ScopeConfig, ScopeConfigBuilder
from ..service import (
    DEFAULT_MAX_SESSIONS_PER_SCOPE,
    ConsensusStats,
    ScopeConfigBuilderWrapper,
)
from ..session import ConsensusConfig, ConsensusSession, ConsensusState
from ..signing import ConsensusSignatureScheme, PendingVerdicts
from ..tracing import tracer as default_tracer
from ..types import (
    ConsensusEvent,
    ConsensusFailedEvent,
    ConsensusReached,
    CreateProposalRequest,
)
from ..wire import Proposal, Vote, normalize_wire_votes
from .adaptive import AdaptiveTimeoutBook
from .pool import PoolFullError, ProposalPool
from .session_sync import allocate_slot, load_session_rows, state_code_of
from .verify_cache import MISS, VerifiedVoteCache

Scope = TypeVar("Scope", bound=Hashable)

_U32_MAX = 0xFFFFFFFF


def _spanned(name: str):
    """An entry point timed whole as the tracer span ``name``
    (:func:`..obs.stage_span`: one attribute check with the tracer off)."""

    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            with stage_span(self.tracer, name):
                return fn(self, *args, **kwargs)

        return wrapper

    return wrap


def _canonical_scope_bytes(scope) -> bytes:
    """Process-independent byte encoding of a scope for the multi-host
    deterministic pid derivation. repr() is NOT safe here: the default
    object repr embeds a memory address, which would silently de-sync the
    replicated control plane — the exact failure deterministic pids exist
    to prevent — so non-canonical scope types are a hard error in
    multi-host mode."""
    if isinstance(scope, str):
        return b"s:" + scope.encode()
    if isinstance(scope, (bytes, bytearray)):
        return b"b:" + bytes(scope)
    if isinstance(scope, int):
        # int(scope) so bool encodes identically to the int it equals
        # (True and 1 are the same dict key, so they are the same scope).
        return b"i:" + str(int(scope)).encode()
    raise TypeError(
        f"multi-host mode requires str/bytes/int scopes (canonical "
        f"cross-process encoding); got {type(scope).__name__}"
    )


__all__ = [
    "ConsensusStats",
    "DEFAULT_MAX_SESSIONS_PER_SCOPE",
    "PendingVoteVerdicts",
    "PoolFullError",
    "SessionRecord",
    "TorchConsensusEngine",
    "WireVotePrepass",
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
    # Columnar retention (``wire_votes``): the verbatim wire bytes of
    # accepted rows as (arrival seq, packed blob, local offsets) chunks,
    # decoded on export so the session re-gossips a chain-valid vote list;
    # ``retained_cache`` memoizes the decode (keyed by the chunk count:
    # chunks are only ever appended).
    retained_wire: list[tuple[int, bytes, np.ndarray]] = field(default_factory=list)
    retained_cache: tuple[int, list[tuple[int, list[Vote]]]] | None = None
    # Per-record arrival clock: one tick per scalar accept and per retained
    # chunk, so an export merges both paths back into arrival order.
    arrival_seq: int = 0
    scalar_seqs: list[int] = field(default_factory=list)
    # Wire-path chain continuity: the effective tail hash and accepted
    # owners as the validated wire path tracked them, stamped with
    # (retained chunks, scalar accepts); a stale stamp rebuilds them from
    # the merged chain, so the dangling-vote guard stays armed across
    # frames.
    wire_tail: bytes | None = None
    wire_seen: "set[bytes] | None" = None
    wire_sync: "tuple[int, int] | None" = None
    # The accepted owners of each retained chunk, in its row order: (width,
    # owners end to end) where the wire path retained it, else None until
    # the equivocation probe reads them (then a list). The probe's index
    # of prior votes.
    retained_owners: "list[tuple[int, bytes] | list[bytes] | None]" = field(
        default_factory=list
    )
    # True while every retained chunk came from the validated wire path
    # (its accepts are guard-ordered, so the merged chain stays
    # positional); pre-validated columnar retention clears it.
    wire_only: bool = True
    # The idle clock the per-scope tier TTLs measure against: the logical
    # time of registration, of the last accepted vote or of a fired
    # timeout (set by _track at registration).
    last_activity: int = 0
    # The distributed trace bound at create/process time (None when the
    # trace store is off or the session came through a batch path): every
    # later span and instant of the session joins it.
    trace: "TraceContext | None" = None

    def next_arrival_seq(self) -> int:
        seq = self.arrival_seq
        self.arrival_seq += 1
        return seq

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


_GUARD_WALK, _GUARD_ON, _GUARD_OFF = 0, 1, 2
_BLOOM_WORDS = 16  # 1,024 bits a session


def _bloom_bits(owner_bytes: np.ndarray) -> np.ndarray:
    """The seen-owner filter's bit (0..1023) of owners given as an [N, w]
    byte matrix (w >= 1): their first two bytes, the second 0 if none."""
    bits = owner_bytes[:, 0].astype(np.int64)
    if owner_bytes.shape[1] > 1:
        bits |= owner_bytes[:, 1].astype(np.int64) << 8
    return bits & 1023


class _WireSlotColumns:
    """What the validated wire path reads of each pooled session, as
    columns indexed by slot, so a clean frame's rules, dangling guard and
    chain tracking never visit a record row by row.

    ``rules`` marks slots whose proposal ``created`` and ``expiry``
    timestamps and ``timeout`` (consensus_timeout) are held here. ``guard``
    is the dangling guard's view: ``_GUARD_ON`` guarded, starting from the
    chain tail ``tail`` (``tail_len`` 0 or 32 bytes) with every owner of
    the session's seen set in the 1,024-bit filter ``bloom`` (no false
    negatives); ``_GUARD_OFF`` retention from pre-validated ingest, left
    unguarded; ``_GUARD_WALK`` anything else (host rows, state another
    path changed since), decided by the exact per-row walk and rebuilt
    from the record after it. Written where a record is tracked,
    released, or changed by another path."""

    def __init__(self, size: int):
        self.rules = np.zeros(size, bool)
        self.created = np.zeros(size, np.uint64)
        self.expiry = np.zeros(size, np.uint64)
        self.timeout = np.zeros(size, np.float64)
        self.guard = np.zeros(size, np.int8)
        self.tail = np.zeros((size, 32), np.uint8)
        self.tail_len = np.zeros(size, np.int8)
        self.bloom = np.zeros((size, _BLOOM_WORDS), np.uint64)

    def fit(self, slot: int) -> None:
        size = len(self.rules)
        if slot < size:
            return
        grow = max(slot + 1, 2 * size)
        for name in ("rules", "created", "expiry", "timeout", "guard", "tail", "tail_len", "bloom"):
            old = getattr(self, name)
            new = np.zeros((grow,) + old.shape[1:], old.dtype)
            new[:size] = old
            setattr(self, name, new)

    def track(self, record: "SessionRecord") -> None:
        slot = record.slot
        self.fit(slot)
        ts = record.proposal.timestamp
        exp = record.proposal.expiration_timestamp
        timeout = record.config.consensus_timeout
        ok = (
            type(ts) is int and type(exp) is int and 0 <= ts < 2**64 and 0 <= exp < 2**64
            and type(timeout) in (int, float) and timeout == timeout  # not NaN
        )
        self.rules[slot] = ok
        if ok:
            self.created[slot] = ts
            self.expiry[slot] = exp
            self.timeout[slot] = timeout
        self.rebuild(record)

    def release(self, slots: "list[int]") -> None:
        slots = [s for s in slots if 0 <= s < len(self.rules)]
        self.rules[slots] = False
        self.guard[slots] = _GUARD_WALK

    def rebuild(self, record: "SessionRecord") -> None:
        """The guard's view of a pooled record from its host state: what
        the per-row walk would start from, or ``_GUARD_WALK``."""
        slot = record.slot
        self.guard[slot] = _GUARD_WALK
        if not (record.retained_wire or record.votes or record.proposal.votes):
            # A session no vote reached yet (every new one): no tail, no owner.
            self.tail[slot] = 0
            self.tail_len[slot] = 0
            self.bloom[slot] = 0
            self.guard[slot] = _GUARD_ON
            return
        if record.retained_wire:
            if not record.wire_only:
                self.guard[slot] = _GUARD_OFF
                return
            if record.wire_seen is None or record.wire_sync != (
                len(record.retained_wire), len(record.scalar_seqs)
            ):
                return
            # The filter also holds the scalar votes' owners, so that no
            # prior vote of the session escapes it (the equivocation probe).
            tail, seen = record.wire_tail or b"", [*record.wire_seen, *record.votes]
        else:
            votes = record.proposal.votes
            tail, seen = (votes[-1].vote_hash if votes else b""), record.votes
        if len(tail) not in (0, 32):
            return
        self.tail[slot] = np.frombuffer(tail.ljust(32, b"\0"), np.uint8)
        self.tail_len[slot] = len(tail)
        bloom = self.bloom[slot]
        bloom[:] = 0
        heads = [owner[:2].ljust(2, b"\0") for owner in seen if owner]
        if heads:
            bits = _bloom_bits(np.frombuffer(b"".join(heads), np.uint8).reshape(-1, 2))
            np.bitwise_or.at(bloom, bits >> 6, np.uint64(1) << (bits & 63).astype(np.uint64))
        self.guard[slot] = _GUARD_ON

    def guard_of(self, slots: np.ndarray) -> np.ndarray:
        """The guard state of each slot; host slots (negative) walk."""
        kind = np.full(len(slots), _GUARD_WALK, np.int8)
        pooled = (slots >= 0) & (slots < len(self.guard))
        kind[pooled] = self.guard[slots[pooled]]
        return kind


def _gather_bytes(buf: bytes, starts: np.ndarray, width: int) -> np.ndarray:
    """``width`` bytes of ``buf`` from each of ``starts``, as a C-ordered
    [N, width] array: one row copy a start from a window view of ``buf``."""
    starts = np.asarray(starts, np.int64)
    if len(starts) == 0:
        return np.zeros((0, width), np.uint8)
    return sliding_window_view(np.frombuffer(buf, np.uint8), width)[starts]


def _unique_keys(matrix: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """``np.unique`` of the rows of a [N, width] byte matrix as fixed-width
    keys (byte-lexicographic order) and the inverse. Sorted first by the
    leading 8 bytes as one big-endian integer; that order is the
    lexicographic one unless two different keys share those bytes, and
    then the general sort runs."""
    width = matrix.shape[1]
    keys = np.ascontiguousarray(matrix).view(np.dtype((np.void, width))).reshape(-1)
    if width >= 8:
        prefix = np.ascontiguousarray(matrix[:, :8]).view(">u8").reshape(-1)
        order = np.argsort(prefix, kind="stable")
        by_key = keys[order]
        by_prefix = prefix[order]
        new = np.ones(len(keys), bool)
        new[1:] = by_key[1:] != by_key[:-1]
        if not (new[1:] & (by_prefix[1:] == by_prefix[:-1])).any():
            inverse = np.empty(len(keys), np.int64)
            inverse[order] = np.cumsum(new) - 1
            return by_key[new], inverse
    unique, inverse = np.unique(keys, return_inverse=True)
    return unique, inverse.reshape(-1)


class _FrameOwners:
    """A wire frame's live-row owners as one fixed-width key column:
    ``index`` maps each frame row to its owner's place among the sorted
    unique keys ``objs`` (bytes; -1 for rows that were not live),
    ``matrix`` holds the same keys as [N, width] bytes and ``bits`` their
    seen-filter bits."""

    __slots__ = ("index", "objs", "bits", "matrix", "width")

    def __init__(self, index: np.ndarray, unique: np.ndarray, width: int):
        self.index = index
        self.width = width
        self.objs = unique.astype(object)
        self.matrix = unique.view(np.uint8).reshape(-1, width)
        self.bits = _bloom_bits(self.matrix)

    def in_bloom(self, bloom: np.ndarray, slots: np.ndarray, owner: np.ndarray) -> np.ndarray:
        """Whether each (slot, owner index) pair's bit is set in the slots'
        seen filters: False means the owner is not in that seen set."""
        bit = self.bits[owner]
        word = bloom[slots, bit >> 6]
        return ((word >> (bit & 63).astype(np.uint64)) & np.uint64(1)) != 0


class PendingVoteVerdicts(PendingVerdicts):
    """Handle for an in-flight admission-verify prepass
    (:meth:`TorchConsensusEngine.verify_votes_async`): ``collect()`` blocks
    until the signature batch resolves and returns ``(verdicts,
    computed_hashes)`` aligned with the submitted votes. Idempotent — the
    first collect does the waiting. While uncollected, a device signer's
    batch is in flight on the GPU."""


class WireVotePrepass:
    """Handle for an in-flight wire-columnar validation prepass
    (:meth:`TorchConsensusEngine.wire_verify_begin`): ``pre_status`` holds
    the structural and hash verdicts already decided (0 = still live),
    ``crypto_rows`` the row indices whose signatures were submitted, and
    ``collect()`` blocks for their verdicts (idempotent). While
    uncollected, a device signer's batch is in flight on the GPU, so a
    caller may start frame k+1's prepass while frame k applies.

    ``buf`` caches the frame's vote region as ``bytes`` when the prepass
    sliced it for crypto, so the apply stage (and a durable wrapper's WAL
    record) reuse one copy. ``began`` is the ``perf_counter`` at which the
    prepass started while the tracer was on (None otherwise): the origin
    of the ``engine.decided`` latencies of the frame's deciding votes."""

    __slots__ = ("pre_status", "crypto_rows", "buf", "began", "_collect_fn", "_result")

    def __init__(self, pre_status, crypto_rows, collect_fn, buf=None, began=None):
        self.pre_status = pre_status
        self.crypto_rows = crypto_rows
        self.buf = buf
        self.began = began
        self._collect_fn = collect_fn
        self._result = None

    def collect(self) -> list:
        if self._collect_fn is not None:
            self._result = self._collect_fn()
            self._collect_fn = None
        return self._result


class _TierEntry:
    """One demoted session: its snapshot ITEM_SESSION payload
    (:func:`..sync.snapshot.encode_session_item`, the signed vote wire
    included, so promotion needs no re-signing and ``state_fingerprint``
    hashes the same bytes whether the session is live or demoted), and the
    scalars that reads need without decoding it: the snapshot state code
    (0 active, 1 reached, 2 failed) and result for stats, ``created_at``
    and ``seq`` for the LRU ranking and ``last_activity`` for the GC TTL
    (an active session's expiry sits in the engine's ``_tier_active``)."""

    __slots__ = ("item", "state", "result", "created_at", "seq", "last_activity")

    def __init__(self, item, state, result, created_at, seq, last_activity):
        self.item = item
        self.state = state
        self.result = result
        self.created_at = created_at
        self.seq = seq
        self.last_activity = last_activity


# Dense lifecycle code -> scalar state, for session export.
_STATE_TO_SCALAR = {
    STATE_ACTIVE: ConsensusState.active(),
    STATE_FAILED: ConsensusState.failed(),
    STATE_REACHED_YES: ConsensusState.reached(True),
    STATE_REACHED_NO: ConsensusState.reached(False),
}

# Timeline outcome labels per dense lifecycle state (ACTIVE maps to None:
# a transition list never carries it).
_OUTCOME_OF_STATE = {
    STATE_REACHED_YES: OUTCOME_YES,
    STATE_REACHED_NO: OUTCOME_NO,
    STATE_FAILED: OUTCOME_FAILED,
}


class TorchConsensusEngine(Generic[Scope]):
    """Batch consensus engine with the ConsensusService API surface, its
    state on one device.

    Capacity is fixed at construction: ``capacity`` concurrent sessions
    across all scopes (default 4096), ``voter_capacity`` voter lanes per
    proposal (default 64). ``device`` defaults to ``"cuda"`` and raises
    without a GPU; pass ``device="cpu"`` to run on the CPU, where the scan
    runs its plain PyTorch version. ``pool`` injects a pool instead (a
    :class:`~..parallel.ShardedPool` or
    :class:`~..parallel.MultiHostPool`): its geometry and device win, so
    it is passed instead of ``capacity`` and ``voter_capacity``.
    ``verify_cache`` is ``"default"`` (a cache of this
    engine's own), a :class:`VerifiedVoteCache` to share between engines,
    or ``None`` for the uncached admission flow. ``health_monitor`` is the
    :class:`~..obs.health.HealthMonitor` that scores this engine's peers
    (default: the package's process-wide monitor).
    """

    def __init__(
        self,
        signer: ConsensusSignatureScheme,
        capacity: int | None = None,
        voter_capacity: int | None = None,
        event_bus: ConsensusEventBus[Scope] | None = None,
        max_sessions_per_scope: int = DEFAULT_MAX_SESSIONS_PER_SCOPE,
        device="cuda",
        verify_cache: "VerifiedVoteCache | None | str" = "default",
        health_monitor: "HealthMonitor | None" = None,
        pool: ProposalPool | None = None,
    ):
        self._signer = signer
        # Per-peer health accounting (scorecards, equivocation and fork
        # evidence, the liveness watchdog). Gated off during WAL replay
        # (_health_live): replayed anomalies were recorded before the crash.
        self.health: HealthMonitor = (
            health_monitor if health_monitor is not None else default_health_monitor
        )
        self._health_live = True
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
        # An injected pool (a ShardedPool over a device mesh, a
        # MultiHostPool across processes) swaps the execution substrate
        # without touching engine semantics.
        if pool is not None:
            if capacity is not None or voter_capacity is not None:
                raise ValueError(
                    "pass capacity/voter_capacity OR an explicit pool, not "
                    "both (the pool's own geometry wins)"
                )
            self._pool = pool
        else:
            self._pool = ProposalPool(
                capacity if capacity is not None else 4096,
                voter_capacity if voter_capacity is not None else 64,
                device=device,
            )
        self._max_sessions_per_scope = max_sessions_per_scope
        # Multi-host awareness: a pool exposing local_slots() splits the
        # slot axis across the processes of a gloo group
        # (parallel.MultiHostPool). The engine then runs SPMD: control-plane
        # calls replicated with IDENTICAL arguments on every process, vote
        # ingest process-local, and every event emitted by exactly one
        # owning process (see _owns_slot).
        self._multihost = hasattr(self._pool, "local_slots")
        self._process_zero = (
            self._pool.process_index == 0 if self._multihost else True
        )
        self.tracer = default_tracer
        # Distributed-trace peer label: this engine's spans carry its
        # signer identity.
        self._trace_peer = "peer:" + signer.identity().hex()[:12]
        # Always-on metrics on the process-wide registry, resolved once so
        # the hot paths pay attribute loads, not registry probes.
        self.metrics = default_registry
        self._m_votes_total = self.metrics.counter(VOTES_TOTAL)
        self._m_votes_accepted = self.metrics.counter(VOTES_ACCEPTED_TOTAL)
        self._m_decisions = self.metrics.counter(DECISIONS_TOTAL)
        self._m_proposals = self.metrics.counter(PROPOSALS_CREATED_TOTAL)
        self._m_timeouts = self.metrics.counter(TIMEOUTS_FIRED_TOTAL)
        self._m_batch_size = self.metrics.histogram(
            INGEST_BATCH_SIZE, DEFAULT_SIZE_BUCKETS
        )
        self._m_verify = self.metrics.histogram(VERIFY_BATCH_SECONDS)
        # Signatures handed to the scheme (cache hits excluded): the base
        # family and a per-scheme labelled variant.
        scheme = type(signer)
        self._m_verified_sigs = self.metrics.counter(VERIFIED_SIGNATURES_TOTAL)
        self._m_verified_sigs_scheme = self.metrics.counter(
            f'{VERIFIED_SIGNATURES_TOTAL}{{scheme="{_escape_label(scheme.__name__)}"}}'
        )
        # Every ingest_wire_columnar call is one fused dispatch; its rows
        # ride along (votes a dispatch = rows / dispatches).
        self._m_wire_dispatches = self.metrics.counter(WIRE_DEVICE_DISPATCHES_TOTAL)
        self._m_wire_apply_rows = self.metrics.counter(WIRE_APPLY_ROWS_TOTAL)
        self._m_chain = self.metrics.histogram(CHAIN_KERNEL_SECONDS)
        self._m_device = self.metrics.histogram(DEVICE_INGEST_SECONDS)
        self._m_suffix_len = self.metrics.histogram(
            CHAIN_SUFFIX_LENGTH, DEFAULT_SIZE_BUCKETS
        )
        # Per-proposal lifecycle timelines (created -> first vote ->
        # decided / timed out), feeding the decision-latency histogram and,
        # through slo_sink, the SLO engine and the adaptive timeouts.
        self._timelines = TimelineStore(self.metrics.histogram(DECISION_LATENCY))
        self._slo_shard: str | None = None
        self._timelines.slo_sink = self._slo_observe
        # Advisory per-scope consensus timeouts (adaptive_timeout()); learning
        # shares the _health_live gate: WAL replay must not teach.
        self._adaptive = AdaptiveTimeoutBook()
        # Engine-state gauges sampled at scrape time, weakly bound: a
        # collected engine's contribution vanishes instead of freezing.
        ref = weakref.ref(self)

        def _live_proposals() -> int:
            engine = ref()
            return len(engine._records) if engine is not None else 0

        def _pool_occupancy() -> int:
            engine = ref()
            if engine is None:
                return 0
            # Claimed pool slots (host-spilled sessions hold none). list()
            # snapshots the keys in one call: the scrape thread runs
            # without the engine lock.
            return sum(1 for s in list(engine._records) if s >= 0)

        def _tier_sessions() -> int:
            engine = ref()
            return engine._tier_count if engine is not None else 0

        def _tier_bytes() -> int:
            engine = ref()
            return engine._tier_bytes if engine is not None else 0

        self.metrics.register_gauge(LIVE_PROPOSALS, _live_proposals, owner=self)
        self.metrics.register_gauge(VOTE_TABLE_OCCUPANCY, _pool_occupancy, owner=self)
        self.metrics.register_gauge(TIER_DEMOTED_SESSIONS, _tier_sessions, owner=self)
        self.metrics.register_gauge(TIER_BYTES, _tier_bytes, owner=self)
        self._m_tier_demotions = self.metrics.counter(TIER_DEMOTIONS_TOTAL)
        self._m_tier_promotions = self.metrics.counter(TIER_PROMOTIONS_TOTAL)
        self._m_tier_gc = self.metrics.counter(TIER_GC_TOTAL)
        # One engine-wide reentrant lock, as the JAX engine holds: scalar
        # entry points funnel into ingest_votes.
        self._lock = threading.RLock()
        self._records: dict[int, SessionRecord[Scope]] = {}  # slot -> record
        self._wire_cols = _WireSlotColumns(int(getattr(self._pool, "capacity", 0)))
        self._index: dict[tuple[Scope, int], int] = {}  # (scope, pid) -> slot
        self._scopes: dict[Scope, list[int]] = {}  # scope -> slots (insertion order)
        self._scope_configs: dict[Scope, ScopeConfig] = {}
        self._scope_seq: dict[Scope, int] = {}
        self._next_host_slot = -1  # synthetic ids for host-spilled sessions
        # Columnar-path cache: per-scope (pids, slots) arrays and their
        # pid -> slot hash; dropped on any membership change.
        self._pid_tables: dict[Scope, tuple[np.ndarray, np.ndarray]] = {}
        self._pid_hashes: dict[Scope, _PidLookup] = {}
        # Multi-scope resolution cache: one composite-key hash per distinct
        # scope tuple of a multi-scope call; any membership change clears it.
        self._fused_pid_cache: dict[tuple, _PidLookup] = {}
        # The demoted tier: scope -> {pid -> _TierEntry}, per scope in
        # demotion order. Every public read and mutation either pages a
        # demoted session back in (_promote_key) or reads through the tier.
        self._tier: dict[Scope, dict[int, _TierEntry]] = {}
        self._tier_count = 0
        self._tier_bytes = 0
        # Active demoted sessions only, (scope, pid) -> expiry: the timeout
        # sweep pages expired ones back in without scanning the decided mass.
        self._tier_active: dict[tuple[Scope, int], int] = {}
        # Per-scope demoted pids for batch id draws (rebuilt by _taken_pids).
        self._tier_pid_arrays: dict[Scope, np.ndarray] = {}
        # Scopes the lifecycle sweep leaves alone (pin_scope).
        self._pinned_scopes: set[Scope] = set()
        # This engine's tier traffic, as occupancy() reports it.
        self._tier_demotions = 0
        self._tier_promotions = 0
        self._tier_gc = 0
        # Reentrancy flag: promotion registers a session again, which is
        # not a fresh proposal.
        self._promoting = False
        # Lifecycle gate (set_replay_mode): False during WAL replay.
        self._lifecycle_live = True

    # ── Accessors ──────────────────────────────────────────────────────

    def signer(self) -> ConsensusSignatureScheme:
        return self._signer

    def set_replay_mode(self, on: bool) -> None:
        """Metrics gate for WAL recovery (``DurableEngine.recover``):
        replayed traffic drives the live ingest paths, but the decisions it
        re-applies were made before the crash. With replay mode on,
        timelines stamp them ``pre_decided`` (outcome without latency), the
        decisions and timeouts counters hold still, health notes pause
        (replayed anomalies were scored before the crash) and the tier
        lifecycle pauses (its TTLs ride idle clocks a restore does not
        carry). Vote and proposal counters keep counting: replay is work
        this process performed."""
        self._timelines.replay_mode = on
        self._health_live = not on
        self._lifecycle_live = not on
        if on:
            # Throwaway instruments: the ingest paths inc their attributes
            # unconditionally, so swapping the targets replaces a flag
            # check at every site.
            self._m_decisions = Counter("replay.decisions.discard")
            self._m_timeouts = Counter("replay.timeouts.discard")
        else:
            self._m_decisions = self.metrics.counter(DECISIONS_TOTAL)
            self._m_timeouts = self.metrics.counter(TIMEOUTS_FIRED_TOTAL)

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
        wall0 = time.time()
        proposal = request.into_proposal(now)
        self._ensure_unique_pid(scope, proposal)
        validate_proposal_timestamp(proposal.expiration_timestamp, now)
        resolved = self._resolve_config(scope, config, proposal)
        record = self._register(scope, proposal, resolved, now)
        if trace_store.enabled and record is not None:
            self._bind_trace(record, "consensus.create_proposal", scope, wall0)
        return proposal.clone()

    def _bind_trace(
        self, record: "SessionRecord[Scope]", span_name: str, scope, wall0: float
    ) -> None:
        """Mint (or continue) the distributed trace of a freshly registered
        session: the ambient context (an embedder's around a gossip
        delivery) is the causal parent; with none this engine is the trace
        root. The bound context's span is recorded, so every peer gives at
        least one span a proposal to the stitched timeline."""
        parent = current_context()
        ctx = parent.child() if parent is not None else TraceContext.generate()
        record.trace = ctx
        tl = self._timelines.get(record.slot)
        if tl is not None and tl.proposal_id == record.proposal.proposal_id:
            tl.trace_hex = ctx.trace_id.hex()
        trace_store.record(
            span_name,
            ctx,
            wall0,
            time.time() - wall0,
            parent=parent.span_id if parent is not None else None,
            peer=self._trace_peer,
            attrs={
                "scope": str(scope),
                "proposal_id": record.proposal.proposal_id,
            },
        )

    def _slo_observe(self, tl, latency: float) -> None:
        """TimelineStore slo_sink: one call per observed decision (gated as
        the latency histogram is). Resolves the scope's declared objective
        and forwards to the process SLO engine; a vote-driven decision also
        decays the scope's learned timeout toward the observed tail."""
        cfg = self._scope_configs.get(tl.scope)
        objective = None
        if cfg is not None and cfg.decide_p99_ms is not None:
            objective = cfg.decide_p99_ms * 1e-3
        slo_engine.observe(
            tl.scope,
            latency,
            shard=self._slo_shard,
            objective_s=objective,
            trace_hex=tl.trace_hex,
        )
        if (
            self._health_live
            and not tl.by_timeout
            and cfg is not None
            and cfg.adaptive_timeout_enabled()
        ):
            self._adaptive.on_decided(
                tl.scope, cfg, slo_engine.observed_p99(tl.scope)
            )

    def _ensure_unique_pid(
        self, scope: Scope, proposal: Proposal, taken: set[int] | None = None
    ) -> None:
        """Collision-proof a locally generated proposal id against live
        and demoted sessions in this scope and (for batch creation) earlier
        proposals of the same batch (protocol.regenerate_until_unique).

        Multi-host: random ids would differ per process and silently
        de-sync the replicated control plane, so the id is derived
        deterministically from the proposal's content plus the
        (replicated) per-scope population — identical create_proposal
        calls then mint the identical pid on every process.
        """
        if self._multihost:
            taken_set = taken or set()
            seq = len(self._scopes.get(scope, []))
            salt = 0
            while True:
                digest = hashlib.sha256(
                    b"|".join(
                        [
                            _canonical_scope_bytes(scope),
                            proposal.name.encode(),
                            proposal.payload,
                            proposal.proposal_owner,
                            str(
                                (
                                    proposal.expected_voters_count,
                                    proposal.timestamp,
                                    seq,
                                    salt,
                                )
                            ).encode(),
                        ]
                    )
                ).digest()
                pid = int.from_bytes(digest[:4], "little") ^ int.from_bytes(
                    digest[4:8], "little"
                )
                if (
                    pid
                    and (scope, pid) not in self._index
                    and not self._tier_has(scope, pid)
                    and pid not in taken_set
                ):
                    proposal.proposal_id = pid
                    return
                salt += 1
                self.tracer.count("engine.pid_collisions")
        collisions = regenerate_until_unique(
            proposal,
            lambda pid: (scope, pid) in self._index
            or self._tier_has(scope, pid)
            or (taken is not None and pid in taken),
        )
        if collisions:
            self.tracer.count("engine.pid_collisions", collisions)

    def _draw_unique_pids(self, existing: np.ndarray, count: int) -> np.ndarray:
        """Batch id draw: one urandom read, vectorized collision rejection
        against ``existing`` pids and within the batch itself (0 is
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
            self.tracer.count("engine.pid_collisions", n_bad)
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
        return self.create_proposals_multi([(scope, requests)], now, config)[0]

    def create_proposals_multi(
        self,
        items: "list[tuple[Scope, list[CreateProposalRequest]]]",
        now: int,
        config: ConsensusConfig | None = None,
    ) -> "list[list[Proposal]]":
        """Multi-scope batch creation: one device dispatch claims slots for
        every scope's proposals. Returns one Proposal list per item, in
        order. Scopes must be distinct within a call. A scope near its
        session cap takes the per-proposal path after the batched
        allocation, so device slots go to the batched population first
        when the pool is nearly full."""
        seen: set = set()
        for scope, _ in items:
            if scope in seen:
                raise ValueError("create_proposals_multi: duplicate scope")
            seen.add(scope)
        # Demoted sessions count against the per-scope cap, so a tiered
        # engine evicts at the points an untiered one does.
        batched = [
            i for i, (scope, requests) in enumerate(items)
            if len(self._scopes.get(scope, [])) + len(self._tier.get(scope, ()))
            + len(requests) <= self._max_sessions_per_scope
        ]
        # Single-host: one id draw for the whole call, checked against the
        # union of the batched scopes' live and demoted pids and sliced per
        # scope. Multi-host: the deterministic per-proposal derivation
        # (_ensure_unique_pid).
        total = sum(len(items[i][1]) for i in batched)
        all_ids = (
            self._draw_unique_pids(
                np.concatenate([self._taken_pids(items[i][0]) for i in batched]),
                total,
            )
            if total and not self._multihost
            else None
        )
        entries: list[tuple[Scope, Proposal, ConsensusConfig]] = []
        spans: dict[int, tuple[int, int]] = {}
        for i in batched:
            scope, requests = items[i]
            ids = (
                all_ids[len(entries):len(entries) + len(requests)].tolist()
                if all_ids is not None
                else [None] * len(requests)
            )
            spans[i] = (len(entries), len(requests))
            batch_pids: set[int] = set()
            # Config resolution is identical for requests sharing
            # (expiration, liveness) when no per-proposal override exists.
            cfg_cache: dict = {}
            for request, pid in zip(requests, ids):
                proposal = request.into_proposal(now, pid=pid)
                if pid is None:
                    self._ensure_unique_pid(scope, proposal, taken=batch_pids)
                    batch_pids.add(proposal.proposal_id)
                validate_proposal_timestamp(proposal.expiration_timestamp, now)
                key = (proposal.expiration_timestamp, proposal.liveness_criteria_yes)
                resolved = cfg_cache.get(key)
                if resolved is None:
                    resolved = self._resolve_config(scope, config, proposal)
                    cfg_cache[key] = resolved
                entries.append((scope, proposal, resolved))
        self._allocate_and_register(entries, now)
        out: list = [None] * len(items)
        for i, (start, count) in spans.items():
            out[i] = [p.clone() for _, p, _ in entries[start:start + count]]
        for i, (scope, requests) in enumerate(items):
            if i not in spans:
                out[i] = [self.create_proposal(scope, r, now, config) for r in requests]
        return out

    def _allocate_and_register(
        self, entries: "list[tuple[Scope, Proposal, ConsensusConfig]]", now: int
    ) -> None:
        """One ``pool.allocate_batch`` for every (scope, proposal, config)
        entry, first fit in entry order, then host registration; an entry
        wider than the lane grid, or past the last free slot, spills to the
        host (the JAX engine's _allocate_and_register)."""
        if not entries:
            return
        n_arr = np.asarray([p.expected_voters_count for _, p, _ in entries], np.int64)
        thr = np.asarray([c.consensus_threshold for _, _, c in entries], np.float64)
        gossip = np.asarray([c.use_gossipsub_rounds for _, _, c in entries], bool)
        maxr = np.asarray([c.max_rounds for _, _, c in entries], np.int64)
        req_arr = required_votes_np(n_arr, thr)
        # max_round_limit semantics (reference: src/session.rs:120-128):
        # gossipsub -> max_rounds; P2P -> explicit override, else the
        # dynamic ceil(n*t) cap, which equals the required votes.
        cap_arr = np.where(gossip, maxr, np.where(maxr == 0, req_arr, maxr))
        fits = n_arr <= self._pool.voter_capacity
        fits &= np.cumsum(fits) <= self._pool.free_slots
        fit = np.nonzero(fits)[0]
        placed = [entries[i][1] for i in fit.tolist()]
        slots = self._pool.allocate_batch(
            keys=[(entries[i][0], entries[i][1].proposal_id) for i in fit.tolist()],
            n=n_arr[fit],
            req=req_arr[fit],
            cap=cap_arr[fit],
            gossip=gossip[fit],
            liveness=np.asarray([p.liveness_criteria_yes for p in placed], bool),
            expiry=np.asarray([p.expiration_timestamp for p in placed], np.int64),
            created_at=np.full(len(placed), now, np.int64),
        ) if len(fit) else []
        slot_of = dict(zip(fit.tolist(), slots))
        # Batch-registered records keep seq 0 and leave the per-scope
        # sequence alone, as the JAX engine's batch registration does, so
        # later LRU evictions rank sessions identically.
        for i, (scope, proposal, cfg) in enumerate(entries):
            slot = slot_of.get(i)
            self._track(
                SessionRecord(scope, slot, proposal, cfg, now)
                if slot is not None
                else self._spilled(scope, proposal, cfg, now)
            )
        for scope in {scope for scope, _, _ in entries}:
            self._drop_pid_cache(scope)
        self._m_proposals.inc(len(entries))
        flight_recorder.record("engine.create", proposals=len(entries))

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
        if not self._promoting:
            # Paging a demoted session back in is not a fresh proposal.
            self._m_proposals.inc()
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
        self.tracer.count("engine.host_spills")
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
        if record is None:
            return  # evicted at once by the per-scope cap
        state = state_code_of(session.state)
        if state != STATE_ACTIVE:
            # Loaded already decided (restore, vote-carrying gossip): stamp
            # the timeline's outcome without a latency, since this engine
            # did not make the decision.
            self._timelines.decided(
                record.slot,
                _OUTCOME_OF_STATE[state],
                created_at,
                time.monotonic(),
                pre_decided=True,
            )
        if record.session is not None:
            return  # host-backed: the session IS the state
        record.votes = {k: v.clone() for k, v in session.votes.items()}
        self._wire_cols.rebuild(record)
        if session.votes or not session.state.is_active:
            if not load_session_rows(self._pool, record.slot, session):
                raise RuntimeError("a session that fits the lanes did not load")

    def _track(self, record: SessionRecord[Scope]) -> None:
        scope = record.scope
        record.last_activity = record.created_at
        self._records[record.slot] = record
        if record.slot >= 0:
            self._wire_cols.track(record)
        self._index[(scope, record.proposal.proposal_id)] = record.slot
        self._scopes.setdefault(scope, []).append(record.slot)
        self._timelines.created(
            record.slot, scope, record.proposal.proposal_id, record.created_at,
            time.monotonic(),
        )

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
        if (scope, proposal.proposal_id) in self._index or self._tier_has(
            scope, proposal.proposal_id
        ):
            # A demoted session exists: rejected without paging it in.
            raise ProposalAlreadyExist()
        wall0 = time.time()
        config = self._resolve_config(scope, config, proposal)
        # Fail fast BEFORE the signature prepass: expired gossip buys no
        # signature work and does not churn the cache.
        try:
            validate_proposal_timestamp(proposal.expiration_timestamp, now)
        except ConsensusError:
            self._note_expired_proposal(proposal, now)
            raise
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
        if transition.is_reached and self._owns_replicated_event():
            self._emit(
                scope,
                ConsensusReached(
                    proposal_id=proposal.proposal_id,
                    result=transition.reached,
                    timestamp=now,
                ),
            )
        self._register_session(scope, session, now)
        self._note_chain_admitted(proposal.votes, config, now)
        if trace_store.enabled:
            slot = self._index.get((scope, proposal.proposal_id))
            if slot is not None:
                # Continues the trace the proposal travelled with (the
                # ambient context); roots a fresh one for untraced senders.
                self._bind_trace(
                    self._records[slot], "consensus.process_proposal", scope, wall0
                )

    def _note_chain_admitted(
        self, votes: "list[Vote]", config: ConsensusConfig, now: int
    ) -> None:
        """Scorecard admissions for an embedded chain accepted whole: one
        dict pass a chain, one monitor call."""
        if not self._health_live or not votes:
            return
        counts: dict[bytes, int] = {}
        for vote in votes:
            counts[vote.vote_owner] = counts.get(vote.vote_owner, 0) + 1
        self.health.note_admitted(
            counts, now, timeout_hint=config.consensus_timeout
        )

    def _note_expired_proposal(self, proposal: Proposal, now: int) -> None:
        """Expired-gossip scorecard hit for a whole stale proposal, on the
        chain's most recent signer (the proposal owner for a vote-free
        proposal)."""
        if not self._health_live:
            return
        source = (
            proposal.votes[-1].vote_owner
            if proposal.votes
            else proposal.proposal_owner
        )
        if source:
            self.health.note_expired(source, now)

    @_spanned("engine.ingest_proposals")
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

        with stage_span(self.tracer, "engine.proposals.admit"):
            # Items that cannot pass — registered or expired at entry — stay
            # out of the verify batch and the chain check: redelivered and
            # expired chains buy no signature work. The final loop's inline
            # gauntlet gives their statuses (PROPOSAL_ALREADY_EXIST, or
            # ProposalExpired before any signature work).
            skip = [
                (scope, proposal.proposal_id) in self._index
                or self._tier_has(scope, proposal.proposal_id)
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
                with observed_span(
                    self.tracer,
                    "engine.chain_kernel",
                    self._m_chain,
                    chains=len(chain_idx),
                ):
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

        # Every host decision is made item by item; the pool holds the slot
        # writes back and makes them once at the loop's end.
        with stage_span(self.tracer, "engine.register"), self._pool.deferred_writes(
            self._count_register_flush
        ):
            for i, (scope, proposal) in enumerate(items):
                # Re-checked: an earlier item may have registered this pid. A
                # demoted session is rejected without paging it in.
                if (scope, proposal.proposal_id) in self._index or self._tier_has(
                    scope, proposal.proposal_id
                ):
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
                    if transition.is_reached and self._owns_replicated_event():
                        self._emit(
                            scope,
                            ConsensusReached(
                                proposal_id=proposal.proposal_id,
                                result=transition.reached,
                                timestamp=now,
                            ),
                        )
                    self._register_session(scope, session, now)
                    self._note_chain_admitted(proposal.votes, config, now)
                except ConsensusError as exc:
                    statuses[i] = int(exc.code)
                    if exc.code == StatusCode.PROPOSAL_EXPIRED:
                        self._note_expired_proposal(proposal, now)
        return statuses

    def _count_register_flush(self, slots: int, forced: bool) -> None:
        """Tracer counts of the register loop's deferred slot writes: each
        flush, the slots it wrote, and the flushes that another pool
        operation (a vote-carrying session's row load) forced early."""
        self.tracer.count("engine.register.flushes")
        self.tracer.count("engine.register.flushed_slots", slots)
        if forced:
            self.tracer.count("engine.register.forced_flushes")

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
            # the state all earlier items produced: flush first. A demoted
            # session is known: a strict extension pages it back in.
            if key in self._index or key in run_keys or self._tier_has(*key):
                flush_run()
            slot = self._index.get(key)
            if slot is None:
                slot = self._tier_lookup_promote(*key)
            if slot is None:
                run.append(k)
                run_keys.add(key)
                continue
            record = self._records[slot]
            if self._misrouted(record):
                # Rejected BEFORE validation: the relay routes on this
                # status, and a misrouted-but-invalid delivery must look
                # the same as a misrouted-valid one.
                statuses[k] = int(StatusCode.SESSION_NOT_FOUND)
                continue
            if k in verified:
                suffix, verdicts = verified[k]
            else:
                suffix, verdicts = self._extension_suffix(record, proposal), None
            if suffix:
                statuses[k] = self._apply_chain_suffix(record, suffix, now, verdicts)
            else:
                statuses[k] = int(StatusCode.PROPOSAL_ALREADY_EXIST)
                # Still crypto-free: the probe re-walks the compared prefix
                # to classify why the redelivery did not extend (fork
                # evidence, truncation lag).
                self._note_redelivery_health(record, proposal, now)
        flush_run()
        return statuses

    def _note_redelivery_health(
        self, record: SessionRecord[Scope], proposal: Proposal, now: int
    ) -> None:
        """Classify a non-extending redelivery for the health layer. A
        prefix mismatch where the divergent vote's signer also has a
        different accepted vote in the session is a FORK, retained as a
        self-authenticating evidence pair (the watermark settles forks
        crypto-free; the bytes authenticate themselves offline). A weaker
        divergence is counted (``engine.divergent_redeliveries``), not
        convicted. A matching but shorter chain is a TRUNCATION, scored on
        the chain's most recent signer. Identical redeliveries score
        nothing. Pre-validated columnar retention is skipped: its merged
        order is not positional."""
        if not self._health_live or (
            record.retained_wire and not record.wire_only
        ):
            return
        accepted = (
            self._accepted_vote_chain(record)
            if record.retained_wire
            else record.proposal.votes
        )
        incoming = proposal.votes
        n = len(incoming)
        if n and n <= len(accepted):
            # Identical (equal length) or lagging (shorter): one tail-hash
            # compare. received_hash links commit each vote to its
            # predecessor, so a matching tail at one position means a
            # matching prefix for fully linked chains.
            if incoming[-1].vote_hash == accepted[n - 1].vote_hash:
                if n < len(accepted):
                    self.health.note_truncation(
                        incoming[-1].vote_owner, len(accepted) - n, now
                    )
                return
        elif not n:
            if accepted and proposal.proposal_owner:
                self.health.note_truncation(
                    proposal.proposal_owner, len(accepted), now
                )
            return
        for ours, theirs in zip(accepted, incoming):
            if ours.vote_hash != theirs.vote_hash:
                prior = record.votes.get(theirs.vote_owner)
                if prior is None and record.session is not None:
                    prior = record.session.votes.get(theirs.vote_owner)
                if prior is None and record.retained_wire:
                    # Wire-retained accepts live in the merged chain.
                    for vote in accepted:
                        if vote.vote_owner == theirs.vote_owner:
                            prior = vote
                            break
                if prior is not None and prior.vote_hash != theirs.vote_hash:
                    self.health.note_fork(
                        record.scope,
                        proposal.proposal_id,
                        prior.encode(),
                        theirs.encode(),
                        theirs.vote_owner,
                        now,
                    )
                else:
                    self.tracer.count("engine.divergent_redeliveries")
                return

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
                # A demoted session's suffix verifies when it is paged in.
                if (
                    self._verify_cache is not None
                    and now < proposal.expiration_timestamp
                    and not self._tier_has(*key)
                ):
                    warm.extend(proposal.votes)
                continue
            record = self._records[slot]
            if now >= record.proposal.expiration_timestamp or self._misrouted(record):
                continue  # expired or another process's: no signature work
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
        (shorter, equal-length, forked before the watermark, or partly
        pre-validated columnar retention, whose merged order is not
        positional). Wire-validated retention stays comparable: its
        accepts are guard-ordered. The prefix compare is bytes equality
        over validated hashes — no crypto."""
        if record.retained_wire:
            if not record.wire_only:
                return None
            accepted = self._accepted_vote_chain(record)
        else:
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
            if self._health_live and suffix[-1].vote_owner:
                # Expired-gossip hit on the chain's most recent signer,
                # still with zero crypto.
                self.health.note_expired(suffix[-1].vote_owner, now)
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
                self._note_reject_health(vote, int(exc.code), now)
                return int(exc.code)
        # The chain rule from the watermark on (the prefix's links were
        # checked at acceptance), over the merged accepted chain when wire
        # bytes were retained: a correctly linked suffix names the
        # retained tail.
        accepted = (
            self._accepted_vote_chain(record)
            if record.retained_wire
            else proposal.votes
        )
        try:
            validate_vote_chain(accepted + suffix, start=len(accepted))
        except ConsensusError as exc:
            return int(exc.code)
        sub = self.ingest_votes(
            [(record.scope, vote) for vote in suffix], now, pre_validated=True
        )
        # "Votes applied per watermark extension": what actually landed,
        # so rejected deliveries and partial applies never read as healthy
        # extension traffic.
        applied = int(np.sum(np.asarray(sub) == int(StatusCode.OK)))
        if applied:
            self._m_suffix_len.observe(applied)
            self.tracer.count("engine.chain_extensions")
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
        ) or (
            record.retained_wire
            and any(
                identity == vote.vote_owner
                for vote in self._accepted_vote_chain(record)
            )
        ):
            raise UserAlreadyVoted()
        # Chain against the merged accepted chain: votes accepted through a
        # columnar path live in retained wire chunks, not in
        # record.proposal.votes.
        link_source = (
            self._materialized_proposal(record)
            if record.retained_wire
            else record.proposal
        )
        vote = build_vote(link_source, choice, self._signer, now)
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
        return self._materialized_proposal(self._get_record(scope, proposal_id))

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

            def _finish_uncached():
                # The span times the collect wait: a well-overlapped
                # pipeline shows near-zero residence.
                with observed_span(
                    self.tracer, "engine.verify_batch", self._m_verify,
                    votes=len(votes),
                ):
                    verdicts = pending.collect()
                self._note_verified(len(votes))
                return list(verdicts), hashes

            return PendingVoteVerdicts(_finish_uncached)
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
            with observed_span(
                self.tracer, "engine.verify_batch", self._m_verify,
                votes=len(rep),
            ):
                fresh = pending.collect()
            self._note_verified(len(rep))
            for miss, verdict in zip(miss_rows.values(), fresh):
                for i in miss:
                    verdicts[i] = verdict
            cache.put_many(list(zip(miss_rows, fresh)))
            return verdicts, hashes

        return PendingVoteVerdicts(_finish)

    def _note_verified(self, count: int) -> None:
        self._m_verified_sigs.inc(count)
        self._m_verified_sigs_scheme.inc(count)

    def _vote_prepass_begin(
        self, items: "list[tuple[Scope, Vote]]", pre_validated: bool
    ) -> "tuple[list[int], PendingVoteVerdicts] | None":
        """Start the signature prepass of an ingest_votes batch: the rows
        that have a session, submitted through the admission cache. Returns
        (row indices, pending handle), or None when the batch takes no
        prepass (pre-validated, or a single vote without the cache, which
        verifies inline).

        Rows of demoted sessions take part: the apply pages them back in.
        Safe to call for batch k+1 BEFORE batch k applies — the
        double-buffered pipeline: a verdict depends on the vote's bytes
        only, and a row whose session is gone by its apply (evicted by a
        promotion's per-scope cap) is SESSION_NOT_FOUND before validation."""
        batch = len(items)
        if pre_validated or not (
            batch > 1 or (batch == 1 and self._verify_cache is not None)
        ):
            return None
        idxs = [
            i for i, (scope, vote) in enumerate(items)
            if (
                (slot := self._index.get((scope, vote.proposal_id))) is not None
                and (slot < 0 or self._owns_slot(slot))  # skip misrouted rows
            )
            or self._tier_has(scope, vote.proposal_id)
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
        self.tracer.count("engine.votes_in", batch)
        wall = time.monotonic()
        if batch:
            self._m_votes_total.inc(batch)
            self._m_batch_size.observe(batch)
            flight_recorder.record("engine.ingest_votes", votes=batch)
        statuses = np.zeros(batch, np.int32)
        dev_rows: list[int] = []  # indices into items that reach the device
        slots = np.empty(batch, np.int64)
        lanes = np.empty(batch, np.int32)
        values = np.empty(batch, bool)
        # Host-spilled sessions apply at once; their events queue as (batch
        # index, scope, event) and interleave with the device path's, so
        # events follow per-vote arrival order across both substrates.
        events: list[tuple[int, Scope, ConsensusEvent]] = []
        host_accepted = 0
        host_transitions = 0
        host_owned_transitions = 0
        # Per-signer admissions accumulate into one dict, flushed in one
        # monitor call (_flush_vote_health): the hot path pays dict stores.
        admit_counts: dict[bytes, int] = {}
        admit_timeout = 0.0
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
                # A late vote on a demoted session pages it back in.
                slot = self._tier_lookup_promote(scope, vote.proposal_id)
                if slot is None:
                    statuses[i] = int(StatusCode.SESSION_NOT_FOUND)
                    continue
            record = self._records[slot]
            if self._misrouted(record):
                # Misrouted vote, rejected BEFORE validation: the relay
                # routes on this status, and a misrouted-but-invalid vote
                # must look the same as a misrouted-valid one.
                statuses[i] = int(StatusCode.SESSION_NOT_FOUND)
                continue
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
                    self._note_reject_health(vote, int(exc.code), now)
                    continue
            # Dangling-vote guard: a FIRST-TIME voter whose received_hash
            # names a vote this session never accepted is rejected instead
            # of appended (an empty chain has no tail, so a first vote
            # claiming a link is dangling by definition). A session whose
            # retained wire came from the validated wire path guards
            # against the wire-tracked tail and owners; pre-validated
            # columnar retention stays permissive.
            wire_guarded = bool(record.retained_wire) and record.wire_only
            if wire_guarded and (
                record.wire_seen is None
                or record.wire_sync
                != (len(record.retained_wire), len(record.scalar_seqs))
            ):
                self._resync_wire_chain(record)
            first_time_voter = not (
                record.retained_wire and not record.wire_only
            ) and (
                vote.vote_owner not in record.votes
                and not (wire_guarded and vote.vote_owner in record.wire_seen)
                and (
                    record.session is None
                    or (
                        vote.vote_owner not in record.session.tallies
                        and vote.vote_owner not in record.session.votes
                    )
                )
            )
            if first_time_voter:
                if vote.received_hash:
                    tail = pending_tail.get(
                        slot,
                        (record.wire_tail or b"")
                        if wire_guarded
                        else record.proposal.votes[-1].vote_hash
                        if record.proposal.votes
                        else b"",
                    )
                    if vote.received_hash != tail:
                        statuses[i] = int(StatusCode.RECEIVED_HASH_MISMATCH)
                        self.tracer.count("engine.dangling_votes_rejected")
                        continue
                pending_tail[slot] = vote.vote_hash
            if record.session is not None:
                was_active = record.session.state.is_active
                code, event = self._host_add_vote(record, vote, now)
                statuses[i] = code
                if code == int(StatusCode.OK):
                    host_accepted += 1
                    record.last_activity = now
                    owner = vote.vote_owner
                    admit_counts[owner] = admit_counts.get(owner, 0) + 1
                    if record.config.consensus_timeout > admit_timeout:
                        admit_timeout = record.config.consensus_timeout
                    self._timelines.voted(slot, now, wall)
                    if trace_store.enabled and record.trace is not None:
                        trace_store.instant(
                            "consensus.vote_applied",
                            record.trace,
                            peer=self._trace_peer,
                            attrs={"owner": vote.vote_owner.hex()[:12]},
                        )
                if was_active and not record.session.state.is_active:
                    host_transitions += 1
                    # Host-spilled sessions are replicated on every
                    # process: decision metrics are ownership-gated like
                    # events so a fleet-wide sum counts each decision once.
                    owned = self._owns_slot(slot)
                    host_owned_transitions += owned
                    outcome = _OUTCOME_OF_STATE[state_code_of(record.session.state)]
                    self._timelines.decided(slot, outcome, now, wall, observe=owned)
                    if trace_store.enabled and record.trace is not None:
                        trace_store.instant(
                            "consensus.decided",
                            record.trace,
                            peer=self._trace_peer,
                            attrs={"outcome": outcome},
                        )
                if event is not None and self._owns_slot(slot):
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
            if self._multihost:
                # Collective cadence: the other processes' batches join the
                # same collective dispatch, so an empty one still does.
                self._pool.ingest(
                    np.empty(0, np.int64), np.empty(0, np.int32),
                    np.empty(0, bool), now,
                )
            self.tracer.count("engine.votes_accepted", host_accepted)
            self.tracer.count("engine.transitions", host_transitions)
            self._m_votes_accepted.inc(host_accepted)
            self._m_decisions.inc(host_owned_transitions)
            for _, ev_scope, event in events:
                self._emit(ev_scope, event)
            self._flush_vote_health(
                items, statuses, admit_counts, admit_timeout, now, pre_validated
            )
            return statuses

        k = len(dev_rows)
        with observed_span(
            self.tracer, "engine.device_ingest", self._m_device, votes=k
        ):
            dev_statuses, transitions = self._pool.ingest(
                slots[:k], lanes[:k], values[:k], now
            )
        statuses[np.asarray(dev_rows)] = dev_statuses
        # Stamp the wall clock after the dispatch: a decision's latency
        # includes the ingest that produced it.
        wall = time.monotonic()
        accepted = int(np.sum(dev_statuses == int(StatusCode.OK))) + host_accepted
        self.tracer.count("engine.votes_accepted", accepted)
        self.tracer.count("engine.transitions", len(transitions) + host_transitions)
        self._m_votes_accepted.inc(accepted)
        # Device transitions are local by construction (misrouted votes
        # were rejected before the dispatch); host-spilled ones were
        # ownership-filtered above.
        self._m_decisions.inc(len(transitions) + host_owned_transitions)
        for slot, new_state in transitions:
            outcome = _OUTCOME_OF_STATE.get(new_state)
            if outcome is not None:
                self._timelines.decided(slot, outcome, now, wall)
                if trace_store.enabled:
                    tctx = self._records[slot].trace
                    if tctx is not None:
                        trace_store.instant(
                            "consensus.decided",
                            tctx,
                            peer=self._trace_peer,
                            attrs={"outcome": outcome},
                        )

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
                record.scalar_seqs.append(record.next_arrival_seq())
                self._wire_cols.guard[record.slot] = _GUARD_WALK
                record.bump_round(1)
                admit_counts[stored.vote_owner] = (
                    admit_counts.get(stored.vote_owner, 0) + 1
                )
                last_ok[int(slots[j])] = j
        for slot in last_ok:
            record = self._records[slot]
            record.last_activity = now
            if record.config.consensus_timeout > admit_timeout:
                admit_timeout = record.config.consensus_timeout
            self._timelines.voted(slot, now, wall)
            if trace_store.enabled and record.trace is not None:
                trace_store.instant(
                    "consensus.vote_applied",
                    record.trace,
                    peer=self._trace_peer,
                    attrs={"batch": int(batch)},
                )

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
        self._flush_vote_health(
            items, statuses, admit_counts, admit_timeout, now, pre_validated
        )
        return statuses

    # Duplicate-shaped statuses worth an equivocation probe: the session
    # already holds a vote by this owner (device DUPLICATE_VOTE, scalar
    # USER_ALREADY_VOTED) or absorbed a late vote after deciding
    # (ALREADY_REACHED). All three come after signature admission, so a
    # differing vote_hash means the owner validly signed two distinct votes
    # for one proposal.
    _EQUIVOCATION_PROBE_CODES = (
        int(StatusCode.DUPLICATE_VOTE),
        int(StatusCode.USER_ALREADY_VOTED),
        int(StatusCode.ALREADY_REACHED),
    )

    def _flush_vote_health(
        self,
        items: "list[tuple[Scope, Vote]]",
        statuses: np.ndarray,
        admit_counts: "dict[bytes, int]",
        admit_timeout: float,
        now: int,
        pre_validated: bool,
    ) -> None:
        """Per-batch health flush of ingest_votes: one batched admission
        update, then an equivocation probe over the (rare) duplicate-shaped
        rejections: two validly signed votes with different hashes from one
        owner on one proposal become a retained evidence pair."""
        if not self._health_live or not len(items):
            return
        if admit_counts:
            self.health.note_admitted(
                admit_counts, now, timeout_hint=admit_timeout
            )
        if pre_validated:
            # No signature admission ran in this call: a duplicate-shaped
            # rejection must not mint verified evidence (a forged replay row
            # could otherwise fabricate "self-authenticating" proof).
            return
        # Candidate selection stays cheap on the clean path: one int for a
        # scalar batch, one vectorized any() (OK == 0) for larger ones.
        if len(items) == 1:
            if int(statuses[0]) not in self._EQUIVOCATION_PROBE_CODES:
                return
            rows = [0]
        else:
            if not statuses.any():
                return
            candidates = statuses == self._EQUIVOCATION_PROBE_CODES[0]
            for code in self._EQUIVOCATION_PROBE_CODES[1:]:
                candidates |= statuses == code
            if not candidates.any():
                return
            rows = np.nonzero(candidates)[0].tolist()
        last_key: "tuple | None" = None  # duplicates cluster a proposal
        record: "SessionRecord[Scope] | None" = None
        for i in rows:
            scope, vote = items[i]
            key = (scope, vote.proposal_id)
            if key != last_key:
                last_key = key
                slot = self._index.get(key)
                record = self._records[slot] if slot is not None else None
            if record is None:
                continue
            prior = record.votes.get(vote.vote_owner)
            if prior is not None and prior.vote_hash != vote.vote_hash:
                self.health.note_equivocation(
                    scope,
                    vote.proposal_id,
                    prior.encode(),
                    vote.encode(),
                    vote.vote_owner,
                    now,
                )

    def _note_reject_health(self, vote: Vote, code: int, now: int) -> None:
        """Scorecard attribution of a per-vote admission rejection, on the
        vote's claimed signer."""
        if not self._health_live:
            return
        if code in (
            int(StatusCode.INVALID_VOTE_SIGNATURE),
            int(StatusCode.INVALID_VOTE_HASH),
            int(StatusCode.SIGNATURE_SCHEME),
        ):
            if vote.vote_owner:
                self.health.note_invalid_signature(vote.vote_owner, now)
        elif code == int(StatusCode.VOTE_EXPIRED):
            if vote.vote_owner:
                self.health.note_expired(vote.vote_owner, now)

    def voter_gid(self, owner: bytes) -> int:
        """Intern an owner identity for the columnar ingest path
        (generation-tagged: a gid freed by a session-releasing call is
        rejected with EMPTY_VOTE_OWNER from then on)."""
        return self._pool.voter_gid(owner)

    @_spanned("engine.ingest_columnar")
    def ingest_columnar(
        self,
        scope: Scope,
        proposal_ids: np.ndarray,
        voter_gids: np.ndarray,
        values: np.ndarray,
        now: int,
        max_depth: int = 8,
        wire_votes: "list[bytes] | tuple[bytes, np.ndarray] | None" = None,
    ) -> np.ndarray:
        """The throughput path: apply an arrival-ordered vote batch given as
        dense columns — proposal ids, interned voter ids (:meth:`voter_gid`),
        yes/no values — with no per-vote Python.

        Same observable semantics as :meth:`ingest_votes` with
        ``pre_validated=True``, except that events are ordered per session,
        not across sessions, and that by default no per-vote ``Vote``
        objects are kept host-side. ``wire_votes`` (the encoded Vote bytes
        per row: a list, or a ``(packed, offsets)`` pair) retains the
        accepted rows' verbatim bytes, so exports re-embed them in arrival
        order and the session re-gossips a chain-valid vote list. A batch
        of fresh slots with no repeated voter takes one closed-form
        dispatch; any other batch runs the arrival-ordered scan, in one
        dispatch while the padded [slots, depth] grid stays within the
        pool's cell budget and otherwise in segments of at most
        ``max_depth`` votes per slot. Returns int32 statuses in batch
        order.
        """
        proposal_ids = np.asarray(proposal_ids, np.int64)
        voter_gids = np.asarray(voter_gids, np.int64)
        values = np.asarray(values, bool)
        wire_norm, statuses, done = self._columnar_preamble(
            len(proposal_ids), wire_votes
        )
        if done:
            return statuses
        with stage_span(self.tracer, "engine.resolve"):
            found, slots = self._pid_lookup(scope).lookup(proposal_ids)
            if self._promote_columnar_misses([scope], None, proposal_ids, found):
                found, slots = self._pid_lookup(scope).lookup(proposal_ids)
        return self._columnar_finish(
            slots, found, voter_gids, values, now, max_depth, statuses, wire_norm
        )

    @_spanned("engine.ingest_columnar")
    def ingest_columnar_multi(
        self,
        scopes: list,
        scope_idx: np.ndarray,
        proposal_ids: np.ndarray,
        voter_gids: np.ndarray,
        values: np.ndarray,
        now: int,
        max_depth: int = 8,
        wire_votes: "list[bytes] | tuple[bytes, np.ndarray] | None" = None,
    ) -> np.ndarray:
        """Mixed-scope :meth:`ingest_columnar`: one device pipeline across
        many scopes. ``scopes`` lists the distinct scopes; ``scope_idx``
        (one entry per row) indexes into it. Only the proposal-id
        resolution is per scope; lanes, dispatches, statuses, events and
        ``wire_votes`` retention are shared with :meth:`ingest_columnar`."""
        proposal_ids = np.asarray(proposal_ids, np.int64)
        scope_idx = np.asarray(scope_idx, np.int64)
        voter_gids = np.asarray(voter_gids, np.int64)
        values = np.asarray(values, bool)
        wire_norm, statuses, done = self._columnar_preamble(
            len(proposal_ids), wire_votes
        )
        if done:
            return statuses
        with stage_span(self.tracer, "engine.resolve"):
            found, slots = self._resolve_slots_multi(scopes, scope_idx, proposal_ids)
        return self._columnar_finish(
            slots, found, voter_gids, values, now, max_depth, statuses, wire_norm
        )

    def _columnar_preamble(
        self, batch: int, wire_votes
    ) -> "tuple[tuple[np.ndarray, np.ndarray] | None, np.ndarray, bool]":
        """The columnar paths' entry: ``wire_votes`` normalized before any
        state mutates (a malformed argument fails the call instead of
        stranding applied votes without their bytes), the statuses, and a
        ``done`` flag that short-circuits empty single-host batches.
        Multi-host must NOT short-circuit: an empty local batch still joins
        the fleet's agreed dispatch cadence (:meth:`_columnar_apply`)."""
        wire_norm = (
            self._normalize_wire(wire_votes, batch) if wire_votes is not None else None
        )
        self.tracer.count("engine.votes_in", batch)
        if batch:
            self._m_votes_total.inc(batch)
            self._m_batch_size.observe(batch)
            flight_recorder.record("engine.ingest_columnar", votes=batch)
        statuses = np.full(batch, int(StatusCode.SESSION_NOT_FOUND), np.int32)
        return wire_norm, statuses, batch == 0 and not self._multihost

    def _resolve_slots_multi(
        self, scopes: list, scope_idx: np.ndarray, proposal_ids: np.ndarray
    ) -> "tuple[np.ndarray, np.ndarray]":
        """Mixed-scope proposal-id resolution of the columnar entry points:
        (found bool[B], slots int64[B]). Rows that miss the live index but
        hit the tier page their sessions back in and resolve again."""
        found, slots = self._resolve_slots_multi_once(scopes, scope_idx, proposal_ids)
        if self._promote_columnar_misses(scopes, scope_idx, proposal_ids, found):
            found, slots = self._resolve_slots_multi_once(scopes, scope_idx, proposal_ids)
        return found, slots

    def _resolve_slots_multi_once(
        self, scopes: list, scope_idx: np.ndarray, proposal_ids: np.ndarray
    ) -> "tuple[np.ndarray, np.ndarray]":
        """One pass of :meth:`_resolve_slots_multi`: one composite-key probe
        (``scope ordinal << 32 | pid``) resolves the whole batch; should a
        scope hold a pid outside u32, each scope's rows probe its own
        table."""
        batch = len(proposal_ids)
        found = np.zeros(batch, bool)
        slots = np.zeros(batch, np.int64)
        fused = self._fused_pid_lookup(scopes)
        if fused is not None:
            # Rows whose pid falls outside u32 can never match.
            rows = np.nonzero(
                (proposal_ids >= 0) & (proposal_ids >> np.int64(32) == 0)
            )[0]
            if rows.size:
                comp = (scope_idx[rows] << np.int64(32)) | proposal_ids[rows]
                found[rows], slots[rows] = fused.lookup(comp)
            return found, slots
        order = np.argsort(scope_idx, kind="stable")
        bounds = np.searchsorted(scope_idx[order], np.arange(len(scopes) + 1))
        for k, scope in enumerate(scopes):
            rows = order[bounds[k]:bounds[k + 1]]
            if rows.size:
                found[rows], slots[rows] = self._pid_lookup(scope).lookup(
                    proposal_ids[rows]
                )
        return found, slots

    def _fused_pid_lookup(self, scopes: list) -> "_PidLookup | None":
        """One composite-key hash for a multi-scope resolution (key =
        scope ordinal << 32 | pid), cached per scope tuple; None when a
        table holds a pid outside u32, which the composite cannot carry."""
        cache_key = tuple(scopes)
        cached = self._fused_pid_cache.get(cache_key)
        if cached is not None:
            return cached
        self.tracer.count("engine.pid_lookup_rebuilds")
        key_parts: list[np.ndarray] = []
        val_parts: list[np.ndarray] = []
        for k, scope in enumerate(scopes):
            pids, slot_arr = self._pid_table(scope)
            if len(pids) and (int(pids.min()) < 0 or (int(pids.max()) >> 32) != 0):
                return None
            key_parts.append(pids | (np.int64(k) << np.int64(32)))
            val_parts.append(slot_arr)
        lookup = _PidLookup(
            np.concatenate(key_parts) if key_parts else np.empty(0, np.int64),
            np.concatenate(val_parts) if val_parts else np.empty(0, np.int64),
        )
        if len(self._fused_pid_cache) >= 8:  # bound the distinct tuples kept
            self._fused_pid_cache.clear()
        self._fused_pid_cache[cache_key] = lookup
        return lookup

    def _columnar_finish(
        self,
        slots: np.ndarray,
        found: np.ndarray,
        voter_gids: np.ndarray,
        values: np.ndarray,
        now: int,
        max_depth: int,
        statuses: np.ndarray,
        wire_norm: "tuple[np.ndarray, np.ndarray] | None",
        wire_validated: bool = False,
        decided: "list | None" = None,
        owners: "_FrameOwners | None" = None,
    ) -> np.ndarray:
        """Shared tail of the columnar paths: apply, then retain the
        accepted rows' wire bytes under their resolved slots.
        ``wire_validated`` marks retention by the guard-ordered wire path,
        the only kind that keeps a record's chain positional. ``decided``
        collects the emission time of each deciding event; ``owners``, the
        frame's owner column, is kept beside each chunk."""
        statuses = self._columnar_apply(
            slots, found, voter_gids, values, now, max_depth, statuses, decided
        )
        if wire_norm is not None:
            with stage_span(self.tracer, "engine.wire.retain"):
                self._retain_wire_slots(
                    statuses, slots, wire_norm, wire_validated, owners
                )
        return statuses

    @staticmethod
    def _normalize_wire(wire_votes, batch: int) -> "tuple[np.ndarray, np.ndarray]":
        """``wire_votes`` as (uint8 data, int64 offsets), validated."""
        blob, offsets = normalize_wire_votes(wire_votes, batch)
        return np.frombuffer(blob, np.uint8), offsets

    def _retain_wire_slots(
        self,
        statuses: np.ndarray,
        slots: np.ndarray,
        wire_norm: "tuple[np.ndarray, np.ndarray]",
        wire_validated: bool = False,
        owners: "_FrameOwners | None" = None,
    ) -> None:
        """Attach the accepted rows' verbatim vote bytes to their session
        records as one chunk a touched session (rows in arrival order),
        with the chunk's owners where the frame's owner column is given."""
        ok_rows = np.nonzero(statuses == int(StatusCode.OK))[0]
        if ok_rows.size == 0:
            return
        data_arr, offsets = wire_norm
        ok_slots = slots[ok_rows]
        order = np.argsort(ok_slots, kind="stable")  # arrival order per slot
        rows = ok_rows[order]
        s_sorted = ok_slots[order]
        starts = offsets[rows]
        lens = offsets[rows + 1] - starts
        uniq, seg_start = np.unique(s_sorted, return_index=True)
        seg_bounds = np.append(seg_start, len(rows))
        # Gather every accepted row's bytes into one blob, slot-major.
        out_off = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(lens, out=out_off[1:])
        gather = (
            np.arange(int(out_off[-1]), dtype=np.int64)
            - np.repeat(out_off[:-1], lens)
            + np.repeat(starts, lens)
        )
        blob = data_arr[gather].tobytes()
        width = owners.width if owners is not None else 0
        if owners is not None:
            owner_blob = owners.matrix[owners.index[rows]].tobytes()
        if not wire_validated:
            self._wire_cols.guard[uniq[uniq >= 0]] = _GUARD_WALK
        for k, slot in enumerate(uniq.tolist()):
            lo, hi = int(seg_bounds[k]), int(seg_bounds[k + 1])
            record = self._records[slot]
            record.wire_only = record.wire_only and wire_validated
            record.retained_wire.append((
                record.next_arrival_seq(),
                blob[int(out_off[lo]):int(out_off[hi])],
                out_off[lo:hi + 1] - out_off[lo],
            ))
            record.retained_owners.append(
                (width, owner_blob[lo * width:hi * width]) if width else None
            )

    # ── Validated wire ingest (OP_VOTE_BATCH columns) ──────────────────

    @_spanned("engine.wire_verify_begin")
    def wire_verify_begin(
        self,
        data: np.ndarray,
        cols: np.ndarray,
        offsets: np.ndarray,
        buf: "bytes | None" = None,
    ) -> WireVotePrepass:
        """Session-independent half of the wire-columnar validation: the
        structural emptiness checks, the batched vote-hash pass and ONE
        cache-aware signature batch over the survivors, all from parsed
        columns (:mod:`..bridge.columnar`), no Vote objects. The batch is
        in flight when this returns (on the card, for a device signer), so
        a caller may start frame k+1's prepass while frame k applies:
        nothing here reads session state.

        Check precedence is ``validate_vote``'s: empty owner, empty hash,
        empty signature, hash mismatch, then signature. The signing
        payload of a canonical row is the prefix ``data[offsets[i] :
        offsets[i] + sign_len]``, so nothing is re-encoded."""
        from ..bridge import columnar as C

        began = time.perf_counter() if self.tracer.enabled else None
        k = len(cols)
        pre = np.zeros(k, np.int32)
        owner_len = cols[:, C.COL_OWNER_LEN]
        hash_len = cols[:, C.COL_HASH_LEN]
        sig_len = cols[:, C.COL_SIG_LEN]
        pre[owner_len == 0] = int(StatusCode.EMPTY_VOTE_OWNER)
        pre[(pre == 0) & (hash_len == 0)] = int(StatusCode.EMPTY_VOTE_HASH)
        pre[(pre == 0) & (sig_len == 0)] = int(StatusCode.EMPTY_SIGNATURE)
        live = pre == 0
        if live.any():
            digests = C.vote_hash_columns(data, cols)
            rows32 = np.nonzero(live & (hash_len == 32))[0]
            if rows32.size:
                gather = (
                    cols[rows32, C.COL_HASH_OFF, None] + np.arange(32, dtype=np.int64)
                )
                mismatch = (data[gather] != digests[rows32]).any(axis=1)
                pre[rows32[mismatch]] = int(StatusCode.INVALID_VOTE_HASH)
            pre[live & (hash_len != 32)] = int(StatusCode.INVALID_VOTE_HASH)
        crypto_rows = np.nonzero(pre == 0)[0]
        if crypto_rows.size == 0:
            return WireVotePrepass(pre, crypto_rows, lambda: [], buf=buf, began=began)
        if buf is None:
            buf = data.tobytes()
        base = np.asarray(offsets, np.int64)[crypto_rows].tolist()
        row_l = cols[crypto_rows].tolist()
        owners: list[bytes] = []
        payloads: list[bytes] = []
        sigs: list[bytes] = []
        for start, c in zip(base, row_l):
            owners.append(buf[c[C.COL_OWNER_OFF]:c[C.COL_OWNER_OFF] + c[C.COL_OWNER_LEN]])
            payloads.append(buf[start:start + c[C.COL_SIGN_LEN]])
            sigs.append(buf[c[C.COL_SIG_OFF]:c[C.COL_SIG_OFF] + c[C.COL_SIG_LEN]])
        return WireVotePrepass(
            pre, crypto_rows, self._wire_crypto_begin(owners, payloads, sigs), buf=buf,
            began=began,
        )

    def _wire_crypto_begin(self, owners, payloads, sigs):
        """Cache-aware batched signature verification over byte triples
        (:meth:`_cached_verify_begin` without Vote objects): identical
        (payload, signature) items collapse to one, the cache answers what
        it holds, ONE ``verify_batch_submit`` takes the misses, and the
        returned zero-argument collect gives verdicts aligned with the
        input."""
        k = len(owners)
        if self._verify_cache is None:
            pending = self._scheme.verify_batch_submit(owners, payloads, sigs)

            def _finish_uncached():
                with observed_span(
                    self.tracer, "engine.verify_batch", self._m_verify, votes=k
                ):
                    verdicts = pending.collect()
                self._note_verified(k)
                return list(verdicts)

            return _finish_uncached
        cache = self._verify_cache
        verdicts: list = [False] * k
        keys = [
            VerifiedVoteCache.key(payload, sig, self._verify_scheme_tag)
            for payload, sig in zip(payloads, sigs)
        ]
        miss_rows: dict[bytes, list[int]] = {}
        for i, (key, hit) in enumerate(zip(keys, cache.get_many(keys))):
            if hit is not MISS:
                verdicts[i] = hit
            else:
                miss_rows.setdefault(key, []).append(i)
        if not miss_rows:
            return lambda: verdicts
        rep = [rows[0] for rows in miss_rows.values()]
        pending = self._scheme.verify_batch_submit(
            [owners[i] for i in rep],
            [payloads[i] for i in rep],
            [sigs[i] for i in rep],
        )

        def _finish():
            with observed_span(
                self.tracer, "engine.verify_batch", self._m_verify,
                votes=len(rep),
            ):
                fresh = pending.collect()
            self._note_verified(len(rep))
            for rows, verdict in zip(miss_rows.values(), fresh):
                for i in rows:
                    verdicts[i] = verdict
            cache.put_many(list(zip(miss_rows, fresh)))
            return verdicts

        return _finish

    def ingest_wire_columnar(
        self,
        scopes: list,
        scope_idx: np.ndarray,
        cols: np.ndarray,
        data: np.ndarray,
        offsets: np.ndarray,
        now: int,
        max_depth: int = 8,
        stage_seconds: "dict | None" = None,
        _prepass: "WireVotePrepass | None" = None,
        _buf: "bytes | None" = None,
    ) -> np.ndarray:
        """The validated wire throughput path: mixed-scope ingest straight
        from parsed ``OP_VOTE_BATCH`` columns. Hash, signature (batched,
        through the admission cache), replay and expiry checks and the
        dangling-vote guard run without a single ``Vote`` object; the rows
        that pass land on the shared columnar apply with wire retention on.

        Status-identical to ``ingest_votes(pre_validated=False)`` over the
        same decoded rows. ``cols``/``data``/``offsets`` come from
        :func:`..bridge.columnar.parse_vote_columns` over canonical rows
        only. ``stage_seconds`` (optional dict) accumulates ``"crypto"``
        and ``"apply"`` wall seconds. ``_prepass`` takes a
        :meth:`wire_verify_begin` started earlier; ``_buf`` the vote
        region already as bytes (a durable wrapper shares its WAL blob)."""
        from ..bridge import columnar as C

        scope_idx = np.asarray(scope_idx, np.int64)
        offsets = np.asarray(offsets, np.int64)
        batch = len(cols)
        self.tracer.count("engine.votes_in", batch)
        if batch:
            self._m_votes_total.inc(batch)
            self._m_batch_size.observe(batch)
            self._m_wire_dispatches.inc()
            self._m_wire_apply_rows.inc(batch)
            flight_recorder.record("engine.ingest_wire_columnar", votes=batch)
        statuses = np.full(batch, int(StatusCode.SESSION_NOT_FOUND), np.int32)
        if batch == 0 and not self._multihost:
            return statuses
        pids = np.ascontiguousarray(cols[:, C.COL_PID])
        with stage_span(self.tracer, "engine.resolve"):
            found, slots = self._resolve_slots_multi(scopes, scope_idx, pids)
        if self._multihost:
            # Misrouted rows reject BEFORE validation (SESSION_NOT_FOUND),
            # mirroring ingest_votes' precedence: the relay routes on this
            # status and a misrouted-but-invalid vote must look the same
            # as a misrouted-valid one.
            found &= ~self._non_local(found, slots)
        with stage_span(self.tracer, "engine.wire.crypto", stage_seconds, "crypto"):
            prepass = (
                _prepass
                if _prepass is not None
                else self.wire_verify_begin(data, cols, offsets, buf=_buf)
            )
            buf = _buf if _buf is not None else prepass.buf
            if buf is None:
                buf = data.tobytes()
            prepass.buf = buf
            verdicts = prepass.collect()
            pre = prepass.pre_status
            valid = found.copy()
            fail = found & (pre != 0)
            statuses[fail] = pre[fail]
            valid &= pre == 0
            # Signature verdicts, with validate_vote's injection semantics: an
            # exception verdict carries its own status code.
            for row, verdict in zip(prepass.crypto_rows.tolist(), verdicts):
                if verdict is True or not valid[row]:
                    continue
                if isinstance(verdict, Exception):
                    statuses[row] = int(getattr(verdict, "code", StatusCode.SIGNATURE_SCHEME))
                else:
                    statuses[row] = int(StatusCode.INVALID_VOTE_SIGNATURE)
                valid[row] = False
        with stage_span(self.tracer, "engine.wire.apply", stage_seconds, "apply"):
            # Emission times of the deciding events, when the tracer is on
            # and the prepass stamped its start.
            decided = [] if self.tracer.enabled and prepass.began is not None else None
            with stage_span(self.tracer, "engine.wire.rules"):
                admit_timeout = self._wire_rules(cols, slots, valid, statuses, now)
                self._wire_reject_health(buf, cols, found, statuses, now)
            with stage_span(self.tracer, "engine.wire.guard"):
                owners = self._wire_owner_column(buf, cols, valid)
                walked = self._wire_dangling_guard(buf, cols, slots, valid, statuses, owners)
            # One gid per unique owner, then the shared columnar apply with
            # wire retention on.
            with stage_span(self.tracer, "engine.wire.intern"):
                gids = self._wire_intern_gids(buf, cols, valid, owners)
            values = cols[:, C.COL_VALUE] != 0
            statuses = self._columnar_finish(
                slots, valid, gids, values, now, max_depth, statuses,
                (data, offsets), wire_validated=True, decided=decided,
                owners=owners,
            )
            with stage_span(self.tracer, "engine.wire.chain"):
                self._wire_track_chain(buf, cols, slots, statuses, owners, walked)
            with stage_span(self.tracer, "engine.wire.admit_health"):
                self._wire_admit_health(
                    buf, cols, scopes, scope_idx, slots, offsets, statuses,
                    admit_timeout, now, owners,
                )
        if decided:
            self.tracer.event(
                "engine.decided", latencies_s=[t - prepass.began for t in decided]
            )
        return statuses

    def _wire_rules(self, cols, slots, valid, statuses, now) -> float:
        """Replay and expiry of the live rows against their sessions'
        timestamps, gathered from the slot columns (one lookup a unique
        slot where a row's session is host-served or not held there).
        Returns the largest consensus_timeout among the rows' sessions
        (0.0 if none is larger), the admission health's timeout hint."""
        from ..bridge import columnar as C

        rows_v = np.nonzero(valid)[0]
        admit_timeout = 0.0
        if rows_v.size == 0:
            return admit_timeout
        ts_rows = np.ascontiguousarray(cols[rows_v, C.COL_TS]).view(np.uint64)
        slots_v = slots[rows_v]
        wc = self._wire_cols
        if slots_v.min() >= 0 and slots_v.max() < len(wc.rules) and wc.rules[slots_v].all():
            creation = wc.created[slots_v]
            expiry = wc.expiry[slots_v]
            timeouts = wc.timeout[slots_v]
            top = timeouts.max()
            if top > 0.0:
                # The loop's pick: the lowest slot holding the largest value.
                slot = int(slots_v[timeouts == top].min())
                admit_timeout = self._records[slot].config.consensus_timeout
        else:
            uniq = np.unique(slots_v)
            created_u = np.empty(len(uniq), np.uint64)
            expiry_u = np.empty(len(uniq), np.uint64)
            for j, slot in enumerate(uniq.tolist()):
                record = self._records[slot]
                created_u[j] = record.proposal.timestamp
                expiry_u[j] = record.proposal.expiration_timestamp
                if record.config.consensus_timeout > admit_timeout:
                    admit_timeout = record.config.consensus_timeout
            pos = np.searchsorted(uniq, slots_v)
            creation = created_u[pos]
            expiry = expiry_u[pos]
        old = ts_rows < creation
        expired = ~old & ((ts_rows > expiry) | (np.uint64(now) > expiry))
        statuses[rows_v[old]] = int(StatusCode.TIMESTAMP_OLDER_THAN_CREATION_TIME)
        statuses[rows_v[expired]] = int(StatusCode.VOTE_EXPIRED)
        valid[rows_v[old | expired]] = False
        return admit_timeout

    def _wire_owner_column(self, buf, cols, valid) -> "_FrameOwners | None":
        """The live rows' owners as one fixed-width key column with a
        frame-local index (sorted, as the gid interning has always
        ordered them), or None where widths differ (the guard then walks
        every row)."""
        from ..bridge import columnar as C

        rows = np.nonzero(valid)[0]
        if rows.size == 0:
            return None
        lens = cols[rows, C.COL_OWNER_LEN]
        width = int(lens[0])
        if (lens != width).any():
            return None
        keys, inverse = _unique_keys(_gather_bytes(buf, cols[rows, C.COL_OWNER_OFF], width))
        index = np.full(len(cols), -1, np.int64)
        index[rows] = inverse
        return _FrameOwners(index, keys, width)

    def _wire_dangling_guard(self, buf, cols, slots, valid, statuses, owners) -> np.ndarray:
        """The ingest_votes dangling-vote guard over columns: a first-time
        voter whose received_hash does not name the session's effective
        tail is rejected (the in-batch tail walk included). A session whose
        slot columns hold its guard state is decided with array passes
        (the seen filter, then :meth:`_wire_chain_links`) unless an owner
        shows twice among its rows; the rest go through the exact per-row
        walk (:meth:`_wire_guard_walk`). Returns the walked sessions'
        slots."""
        from ..bridge import columnar as C

        rows = np.nonzero(valid)[0]
        if rows.size == 0:
            return rows
        order = np.argsort(slots[rows], kind="stable")
        srows = rows[order]
        ss = slots[srows]
        start = np.ones(len(ss), bool)
        np.not_equal(ss[1:], ss[:-1], out=start[1:])
        seg = np.cumsum(start) - 1
        uslots = ss[start]
        wc = self._wire_cols
        walk = np.ones(len(uslots), bool)
        if owners is not None:
            kind = wc.guard_of(uslots)
            walk = kind == _GUARD_WALK
            on = np.nonzero(kind[seg] == _GUARD_ON)[0]  # sorted positions
            if on.size:
                o = owners.index[srows[on]]
                # An owner twice in one session's rows: the walk decides
                # (so does a hash of another width, which the prepass
                # refuses).
                pair = np.sort(seg[on] * len(owners.objs) + o)
                twice = pair[1:][pair[1:] == pair[:-1]] // len(owners.objs)
                walk[twice] = True
                walk[seg[on][cols[srows[on], C.COL_HASH_LEN] != 32]] = True
                keep = ~walk[seg[on]]
                on, o = on[keep], o[keep]
            if on.size:
                fslot = ss[on]
                seen = owners.in_bloom(wc.bloom, fslot, o)
                for j in np.nonzero(seen)[0].tolist():
                    record = self._records[int(fslot[j])]
                    held = record.wire_seen if record.retained_wire else record.votes
                    seen[j] = owners.objs[o[j]] in held
                fresh = on[~seen]
                refused = fresh[~self._wire_chain_links(buf, cols, srows[fresh], seg[fresh], uslots)]
                if refused.size:
                    statuses[srows[refused]] = int(StatusCode.RECEIVED_HASH_MISMATCH)
                    valid[srows[refused]] = False
                    self.tracer.count("engine.dangling_votes_rejected", len(refused))
        walked = walk[seg]
        self.tracer.count("engine.wire.walked_rows", int(walked.sum()))
        if walked.any():
            self._wire_guard_walk(buf, cols, slots, valid, statuses, srows[walked])
        return uslots[walk]

    def _wire_chain_links(self, buf, cols, rows, seg, uslots) -> np.ndarray:
        """Which first-time voters of guarded sessions the chain rule
        admits: ``rows`` in slot-sorted frame order, ``seg`` their
        session's place in ``uslots``, no owner twice in a session. A row
        passes when its received hash is empty or names the last passing
        row's hash before it in its session (the session's tail for
        none); a refused row leaves that tail where it was. Row k's
        verdict depends only on the rows before it, so iterating from
        "all pass" fixes one more row of every session each round and
        stops at the walk's own answer."""
        from ..bridge import columnar as C

        wc = self._wire_cols
        n = len(rows)
        if n == 0:
            return np.ones(0, bool)
        first = np.ones(n, bool)
        np.not_equal(seg[1:], seg[:-1], out=first[1:])
        seg_start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
        recv_len = cols[rows, C.COL_RECV_LEN]
        named = np.nonzero(recv_len > 0)[0]
        ok = np.ones(n, bool)
        if named.size == 0:
            return ok
        # 32-byte hashes as four 64-bit words; a received hash of any other
        # length than 32 names no row.
        hashes = _gather_bytes(buf, cols[rows, C.COL_HASH_OFF], 32).view(np.uint64)
        full = recv_len[named] == 32
        recv = np.zeros((len(named), 4), np.uint64)
        recv[full] = _gather_bytes(
            buf, cols[rows[named[full]], C.COL_RECV_OFF], 32
        ).view(np.uint64)
        tail_slots = uslots[seg[named]]
        tail_ok = full & (wc.tail_len[tail_slots] == 32)
        tails = np.ascontiguousarray(wc.tail[tail_slots]).view(np.uint64)
        # The received hash against the session's tail and against the row
        # just before are fixed; only which row is "last passing" moves
        # between rounds, and it is rarely further back.
        named_start = seg_start[named]
        against_tail = tail_ok & (recv == tails).all(axis=1)
        prev = named - 1
        inner = prev >= named_start
        against_prev = np.zeros(len(named), bool)
        against_prev[inner] = full[inner] & (recv[inner] == hashes[prev[inner]]).all(axis=1)
        passed = np.ones(n, bool)
        idx = np.arange(n)
        while True:
            # The last passing row strictly before each row, in its session.
            last = np.maximum.accumulate(np.where(passed, idx, -1))
            before = np.full(len(named), -1, np.int64)
            before[inner] = last[prev[inner]]
            before[before < named_start] = -1
            near = inner & (before == prev)
            ok_named = np.where(near, against_prev, against_tail)
            far = np.nonzero((before >= 0) & ~near)[0]
            if far.size:
                ok_named[far] = full[far] & (recv[far] == hashes[before[far]]).all(axis=1)
            ok = np.ones(n, bool)
            ok[named] = ok_named
            if np.array_equal(ok, passed):
                return ok
            passed = ok

    def _wire_guard_walk(self, buf, cols, slots, valid, statuses, rows) -> None:
        """The dangling guard row by row over ``rows`` (slot-sorted, frame
        order within a slot): the exact rule every session can take. The
        guard stays armed across frames through the record's wire
        continuity state (:meth:`_wire_track_chain`); a session whose
        retained wire came from pre-validated columnar ingest stays
        permissive."""
        from ..bridge import columnar as C

        # -1 as "no slot yet", as the JAX engine has it: -1 is also the
        # first host-spilled session's slot, so when that session holds
        # the frame's lowest slot its rows go unguarded there too (kept
        # for parity; ROADMAP queue 3 records it). Host rows always walk,
        # so the walked rows start where the frame's sorted rows do.
        prev_slot = -1
        guard = False
        tail = b""
        seen: set = set()
        for i in rows.tolist():
            slot = int(slots[i])
            if slot != prev_slot:
                prev_slot = slot
                record = self._records[slot]
                if not record.retained_wire:
                    guard = True
                    tail = (
                        record.proposal.votes[-1].vote_hash
                        if record.proposal.votes
                        else b""
                    )
                    seen = set(record.votes)
                elif record.wire_only:
                    if record.wire_seen is None or record.wire_sync != (
                        len(record.retained_wire), len(record.scalar_seqs)
                    ):
                        self._resync_wire_chain(record)
                    guard = True
                    tail = record.wire_tail or b""
                    seen = set(record.wire_seen)
                else:
                    guard = False
                if guard and record.session is not None:
                    seen.update(record.session.tallies)
                    seen.update(record.session.votes)
            if not guard:
                continue
            c = cols[i]
            owner = buf[c[C.COL_OWNER_OFF]:c[C.COL_OWNER_OFF] + c[C.COL_OWNER_LEN]]
            if owner in seen:
                continue
            received = buf[c[C.COL_RECV_OFF]:c[C.COL_RECV_OFF] + c[C.COL_RECV_LEN]]
            if received and received != tail:
                statuses[i] = int(StatusCode.RECEIVED_HASH_MISMATCH)
                valid[i] = False
                self.tracer.count("engine.dangling_votes_rejected")
                continue
            tail = buf[c[C.COL_HASH_OFF]:c[C.COL_HASH_OFF] + c[C.COL_HASH_LEN]]
            seen.add(owner)

    def _wire_reject_health(self, buf, cols, found, statuses, now) -> None:
        """Scorecard attribution of wire-columnar validation rejects: the
        vectorized twin of :meth:`_note_reject_health` (same codes, same
        claimed-signer attribution), sliced from the frame only on the
        failure path."""
        if not self._health_live:
            return
        from ..bridge import columnar as C

        sig_codes = (
            int(StatusCode.INVALID_VOTE_SIGNATURE),
            int(StatusCode.INVALID_VOTE_HASH),
            int(StatusCode.SIGNATURE_SCHEME),
        )
        mask = found & (
            (statuses == sig_codes[0])
            | (statuses == sig_codes[1])
            | (statuses == sig_codes[2])
            | (statuses == int(StatusCode.VOTE_EXPIRED))
        )
        for row in np.nonzero(mask)[0].tolist():
            c = cols[row]
            owner = buf[c[C.COL_OWNER_OFF]:c[C.COL_OWNER_OFF] + c[C.COL_OWNER_LEN]]
            if not owner:
                continue
            if int(statuses[row]) == int(StatusCode.VOTE_EXPIRED):
                self.health.note_expired(owner, now)
            else:
                self.health.note_invalid_signature(owner, now)

    def _wire_admit_health(
        self, buf, cols, scopes, scope_idx, slots, offsets, statuses,
        admit_timeout, now, owners,
    ) -> None:
        """Post-apply health flush of the wire path: batched admission
        counts for the accepted rows (owners in order of first
        acceptance), then the equivocation probe over the duplicate-shaped
        rejections. A probed owner the session's seen filter does not
        hold has no prior vote there; the others take it from the
        session's scalar votes or its retained-owner index."""
        if not self._health_live:
            return
        from ..bridge import columnar as C

        ok = statuses == int(StatusCode.OK)
        if ok.any():
            if owners is not None:
                o = owners.index[np.nonzero(ok)[0]]
                uniq, first = np.unique(o, return_index=True)
                by_arrival = uniq[np.argsort(first)]
                admit_counts = dict(zip(
                    owners.objs[by_arrival].tolist(),
                    np.bincount(o)[by_arrival].tolist(),
                ))
            else:
                admit_counts: dict[bytes, int] = {}
                for row in np.nonzero(ok)[0].tolist():
                    c = cols[row]
                    owner = buf[c[C.COL_OWNER_OFF]:c[C.COL_OWNER_OFF] + c[C.COL_OWNER_LEN]]
                    admit_counts[owner] = admit_counts.get(owner, 0) + 1
            skipped = self.health.note_admitted(
                admit_counts, now, timeout_hint=admit_timeout
            )
            self.tracer.count("engine.wire.admit_cards_skipped", skipped or 0)
        probe = np.nonzero(np.isin(statuses, self._EQUIVOCATION_PROBE_CODES))[0]
        if probe.size == 0:
            return
        # In a guarded session every owner with a vote there is in the
        # seen filter, and in wire_seen or the scalar votes.
        guarded = np.zeros(len(probe), bool)
        if owners is not None:
            guarded = self._wire_cols.guard_of(slots[probe]) == _GUARD_ON
            on = np.nonzero(guarded)[0]
            unseen = ~owners.in_bloom(
                self._wire_cols.bloom, slots[probe[on]], owners.index[probe[on]]
            )
            probe, guarded = np.delete(probe, on[unseen]), np.delete(guarded, on[unseen])
        for row, on_guard in zip(probe.tolist(), guarded.tolist()):
            record = self._records[int(slots[row])]
            c = cols[row]
            owner = buf[c[C.COL_OWNER_OFF]:c[C.COL_OWNER_OFF] + c[C.COL_OWNER_LEN]]
            if on_guard and owner not in record.votes and owner not in (record.wire_seen or ()):
                continue
            vote_hash = buf[c[C.COL_HASH_OFF]:c[C.COL_HASH_OFF] + c[C.COL_HASH_LEN]]
            prior = record.votes.get(owner)
            prior_bytes = None
            if prior is not None and prior.vote_hash != vote_hash:
                prior_bytes = prior.encode()
            elif prior is None:
                for vote in self._retained_votes_of(record, owner):
                    if vote.vote_hash != vote_hash:
                        prior_bytes = vote.encode()
                        break
            if prior_bytes is not None:
                self.health.note_equivocation(
                    scopes[int(scope_idx[row])],
                    int(cols[row, C.COL_PID]),
                    prior_bytes,
                    buf[int(offsets[row]):int(offsets[row + 1])],
                    owner,
                    now,
                )

    def _retained_votes_of(self, record: SessionRecord[Scope], owner: bytes):
        """``owner``'s first vote in each retained chunk, in chunk order,
        found in the chunks' owner index (a chunk retained without it is
        read once, from its parsed columns, and indexed then)."""
        from ..bridge import columnar as C

        index = record.retained_owners
        for ci, (_seq, blob, offs) in enumerate(record.retained_wire):
            held = index[ci]
            if held is None:
                offs64 = np.asarray(offs, np.int64)
                cols, canonical = C.parse_vote_columns(np.frombuffer(blob, np.uint8), offs64)
                if canonical.all():
                    spans = cols[:, [C.COL_OWNER_OFF, C.COL_OWNER_LEN]].tolist()
                    held = index[ci] = [blob[a:a + b] for a, b in spans]
                else:
                    held = index[ci] = [
                        Vote.decode(blob[offs64[k]:offs64[k + 1]]).vote_owner
                        for k in range(len(offs64) - 1)
                    ]
            if isinstance(held, list):
                k = held.index(owner) if owner in held else -1
            else:
                width, owners_blob = held
                k = -1
                if len(owner) == width:
                    pos = owners_blob.find(owner)
                    while pos > 0 and pos % width:
                        pos = owners_blob.find(owner, pos + 1)
                    k = pos // width if pos >= 0 else -1
            if k >= 0:
                yield Vote.decode(blob[int(offs[k]):int(offs[k + 1])])

    def _accepted_vote_chain(self, record: SessionRecord[Scope]) -> list[Vote]:
        """The session's accepted votes in arrival order, retained wire
        chunks and scalar accepts merged (not cloned: callers only read)."""
        retained = self._decoded_retained(record)
        scalar = record.proposal.votes
        if not retained:
            return scalar
        n_pre = len(scalar) - len(record.scalar_seqs)
        items: list[tuple[int, list[Vote]]] = [(-1, scalar[:n_pre])] if n_pre else []
        items.extend((seq, [vote]) for seq, vote in zip(record.scalar_seqs, scalar[n_pre:]))
        items.extend(retained)
        items.sort(key=lambda t: t[0])
        return [vote for _, votes in items for vote in votes]

    def _resync_wire_chain(self, record: SessionRecord[Scope]) -> None:
        """Rebuild the wire guard's continuity state from the merged
        accepted chain (after scalar accepts touched a wire-fed record)."""
        chain = self._accepted_vote_chain(record)
        record.wire_seen = {vote.vote_owner for vote in chain}
        record.wire_tail = chain[-1].vote_hash if chain else b""
        record.wire_sync = (len(record.retained_wire), len(record.scalar_seqs))
        if record.slot >= 0:
            self._wire_cols.guard[record.slot] = _GUARD_WALK

    def _wire_track_chain(self, buf, cols, slots, statuses, owners, walked) -> None:
        """Fold each session's accepted rows (frame order) into its wire
        continuity state, once a session: tail hash, accepted owners and
        the sync stamp that shows no other path touched the record since.
        The slot columns follow: a guarded session's tail and seen filter
        take the rows; a walked one, or one whose filter bits are not at
        hand, is rebuilt from its record."""
        from ..bridge import columnar as C

        wc = self._wire_cols
        # A walked session the columns already guarded stays guarded: the
        # walk and the tracking move its state as they move the columns.
        rebuild = walked[walked >= 0]
        rebuild = rebuild[wc.guard[rebuild] != _GUARD_ON]
        ok_rows = np.nonzero(statuses == int(StatusCode.OK))[0]
        if ok_rows.size:
            rows = ok_rows[np.argsort(slots[ok_rows], kind="stable")]
            s = slots[rows]
            start = np.ones(len(s), bool)
            np.not_equal(s[1:], s[:-1], out=start[1:])
            bounds = np.append(np.nonzero(start)[0], len(s))
            uniq = s[start]
            last = rows[bounds[1:] - 1]
            if owners is not None:
                accepted = owners.objs[owners.index[rows]].tolist()
            else:
                accepted = [
                    buf[a:a + b]
                    for a, b in cols[rows][:, [C.COL_OWNER_OFF, C.COL_OWNER_LEN]].tolist()
                ]
            hash_len = cols[last, C.COL_HASH_LEN]
            if (hash_len == 32).all():
                tail_matrix = _gather_bytes(buf, cols[last, C.COL_HASH_OFF], 32)
                tails = tail_matrix.view(np.dtype((np.void, 32))).reshape(-1).tolist()
            else:
                tail_matrix = None
                tails = [
                    buf[a:a + b]
                    for a, b in zip(cols[last, C.COL_HASH_OFF].tolist(), hash_len.tolist())
                ]
            lo = 0
            for record, hi, tail in zip(
                map(self._records.__getitem__, uniq.tolist()), bounds[1:].tolist(), tails
            ):
                seen = record.wire_seen
                if seen is None:
                    seen = record.wire_seen = set(record.votes)
                if hi - lo == 1:
                    seen.add(accepted[lo])
                else:
                    seen.update(accepted[lo:hi])
                record.wire_tail = tail
                record.wire_sync = (len(record.retained_wire), len(record.scalar_seqs))
                lo = hi
            kind = wc.guard_of(uniq)
            on = kind == _GUARD_ON
            if owners is None or tail_matrix is None:
                rebuild = np.concatenate([rebuild, uniq[on]])
            else:
                on_slots = uniq[on]
                wc.tail[on_slots] = tail_matrix[on]
                wc.tail_len[on_slots] = 32
                row_on = on[np.cumsum(start) - 1]
                bits = owners.bits[owners.index[rows[row_on]]]
                np.bitwise_or.at(
                    wc.bloom, (s[row_on], bits >> 6),
                    np.uint64(1) << (bits & 63).astype(np.uint64),
                )
            rebuild = np.concatenate([rebuild, uniq[(uniq >= 0) & ~on]])
        for slot in np.unique(rebuild).tolist():
            wc.rebuild(self._records[slot])

    def _wire_intern_gids(self, buf, cols, valid, owners) -> np.ndarray:
        """The gid column of the apply stage: each unique owner interned
        once. Fixed-width identities dedupe through the frame's owner
        column, in key order; mixed widths go through a memo dict."""
        from ..bridge import columnar as C

        gids = np.zeros(len(cols), np.int64)
        rows = np.nonzero(valid)[0]
        if rows.size == 0:
            return gids
        if owners is not None:
            uniq, inverse = np.unique(owners.index[rows], return_inverse=True)
            uniq_gids = self._pool.voter_gids(owners.objs[uniq].tolist())
            gids[rows] = uniq_gids[inverse.reshape(-1)]
            return gids
        memo: dict[bytes, int] = {}
        for i in rows.tolist():
            c = cols[i]
            owner = buf[c[C.COL_OWNER_OFF]:c[C.COL_OWNER_OFF] + c[C.COL_OWNER_LEN]]
            gid = memo.get(owner)
            if gid is None:
                gid = memo[owner] = self._pool.voter_gid(owner)
            gids[i] = gid
        return gids

    def _columnar_apply(
        self,
        slots: np.ndarray,
        found: np.ndarray,
        voter_gids: np.ndarray,
        values: np.ndarray,
        now: int,
        max_depth: int,
        statuses: np.ndarray,
        decided: "list | None" = None,
    ) -> np.ndarray:
        """Slot-resolved columnar pipeline: gid filter, lane resolution,
        the dispatch plan (fresh or segmented scan), round bookkeeping and
        event emission (``decided``, when a list, gets the
        ``perf_counter`` of each deciding ``ConsensusReached``)."""
        if self._multihost:
            # Misrouted rows (device slots another process owns) report the
            # session as not found on this host; the relay routes by
            # is_local(). Host-spilled rows (slots < 0) are replicated
            # control-plane state and apply everywhere. This runs BEFORE the
            # gid check: a misrouted voter is typically not interned here,
            # and the relay must see the routing status, not an identity one.
            non_local = self._non_local(found, slots)
            if non_local.any():
                statuses[non_local] = int(StatusCode.SESSION_NOT_FOUND)
                found = found & ~non_local
        # Gids must be LIVE current-generation identities: out-of-range,
        # freed and stale-generation ids get a typed per-row status.
        bad_gid = ~self._pool.gids_live(voter_gids)
        if bad_gid.any():
            statuses[found & bad_gid] = int(StatusCode.EMPTY_VOTE_OWNER)
            found = found & ~bad_gid
        # Host-spilled sessions (negative slots) take their rows tally-only,
        # in arrival order: no Vote object is made up for them.
        wall = time.monotonic()
        host_rows = found & (slots < 0)
        if host_rows.any():
            for i in np.nonzero(host_rows)[0].tolist():
                slot = int(slots[i])
                record = self._records[slot]
                was_active = record.session.state.is_active
                code, event = self._host_add_tally(
                    record, self._pool.owner_of_gid(int(voter_gids[i])),
                    bool(values[i]), now,
                )
                statuses[i] = code
                if code == int(StatusCode.OK):
                    record.last_activity = now
                    self._timelines.voted(slot, now, wall)
                    self._m_votes_accepted.inc()
                self.tracer.count(
                    "engine.votes_accepted", int(code == int(StatusCode.OK))
                )
                if was_active and not record.session.state.is_active:
                    # Ownership-gated like events: host-spilled sessions are
                    # replicated fleet-wide, decision metrics must not be.
                    owned = self._owns_slot(slot)
                    self._timelines.decided(
                        slot,
                        _OUTCOME_OF_STATE[state_code_of(record.session.state)],
                        now,
                        wall,
                        observe=owned,
                    )
                    if owned:
                        self._m_decisions.inc()
                self.tracer.count(
                    "engine.transitions",
                    int(was_active and not record.session.state.is_active),
                )
                if event is not None and self._owns_slot(slot):
                    self._emit(record.scope, event)
                    if (
                        decided is not None
                        and was_active
                        and isinstance(event, ConsensusReached)
                    ):
                        decided.append(time.perf_counter())
            found = found & ~host_rows
        dev_rows = np.nonzero(found)[0]
        # Multi-host: an empty local batch still takes part in the fleet's
        # plan and dispatch-count agreement below.
        if dev_rows.size == 0 and not self._multihost:
            return statuses

        def _group(s_sorted: np.ndarray):
            b = len(s_sorted)
            is_start = np.ones(b, bool)
            if b:
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
            if len(order) == 0 and not self._multihost:
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
        depth = int(counts.max()) if len(order) else 0
        everything = np.arange(len(order), dtype=np.int64)
        use_fresh = (
            fast_lanes
            and len(order) > 0
            and self._pool.fresh_ingest_viable(uniq, depth, len(order))
        )
        fleet_fresh = False
        if self._multihost:
            # Fleet agreement on the dispatch PLAN, not just the count: the
            # path is fresh only when EVERY process votes yes (an empty
            # local batch votes yes if its pool supports the kernel — it
            # then dispatches one empty fresh call to hold the collective
            # cadence), AND the fleet-max grid shapes fit the cell budget.
            use_fresh = fleet_fresh = self._agree_fresh_plan(
                use_fresh or len(order) == 0, len(uniq), depth
            )
            if use_fresh and len(order) == 0:
                segs.append((uniq, grp_sorted, col_sorted, 0, everything, True))
        if use_fresh and len(order) > 0:
            self.tracer.count("engine.fresh_dispatches")
            segs.append((uniq, grp_sorted, col_sorted, depth, everything, True))
        elif len(order) and depth > max_depth and not self._pool.grid_within_budget(
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
        elif len(order):
            segs.append((uniq, grp_sorted, col_sorted, depth, everything, False))
        if self._multihost and not fleet_fresh:
            # Collective cadence for the scan plan: every process issues
            # the same number of dispatches this call, empty ones included.
            # (The fresh plan is exactly one dispatch per process by
            # construction, so it needs no second collective.)
            empty = np.empty(0, np.int64)
            for _ in range(self._agree_dispatch_count(len(segs)) - len(segs)):
                segs.append((empty, empty, empty, 0, empty, False))
        if not segs:
            return statuses

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
        # The span ends where the host holds the results: complete_all is
        # the call that brings the statuses back.
        with observed_span(
            self.tracer, "engine.device_ingest", self._m_device,
            votes=int(len(order)),
        ):
            results = self._pool.complete_all(pendings)

        wall = time.monotonic()
        accepted = 0
        n_transitions = 0
        reached_transitions: list[tuple[int, int]] = []
        for orig_rows, (seg_statuses, transitions) in zip(orig_of, results):
            statuses[orig_rows] = seg_statuses
            accepted += int(np.sum(seg_statuses == int(StatusCode.OK)))
            n_transitions += len(transitions)
            for slot, st in transitions:
                if st in (STATE_REACHED_YES, STATE_REACHED_NO):
                    reached_transitions.append((slot, st))
                outcome = _OUTCOME_OF_STATE.get(st)
                if outcome is not None:
                    self._timelines.decided(slot, outcome, now, wall)
        self.tracer.count("engine.votes_accepted", accepted)
        self.tracer.count("engine.transitions", n_transitions)
        self._m_votes_accepted.inc(accepted)
        self._m_decisions.inc(n_transitions)

        # Round bookkeeping per touched slot, via bincount over the
        # sorted-domain group index (totals are order-independent).
        sorted_statuses = statuses[sel]
        ok_m = sorted_statuses == int(StatusCode.OK)
        if ok_m.any():
            cnt = np.bincount(grp_sorted[ok_m], minlength=len(uniq))
            for g in np.nonzero(cnt)[0].tolist():
                slot = int(uniq[g])
                record = self._records[slot]
                record.bump_round(int(cnt[g]))
                record.last_activity = now
                self._timelines.voted(slot, now, wall)

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

        with stage_span(self.tracer, "engine.apply.events"):
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
                if decided is not None:
                    decided.append(time.perf_counter())
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
        """Invalidate the pid-resolution caches after a membership change
        in ``scope``; the multi-scope cache's tuples may span any scope,
        so it is cleared outright."""
        self._pid_tables.pop(scope, None)
        self._pid_hashes.pop(scope, None)
        self._fused_pid_cache.clear()

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
            self.tracer.count("engine.pid_tables_rebuilt")
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
        code, event = self._host_apply(record, lambda s: s.add_vote(vote, now), now)
        if code == int(StatusCode.OK):
            # add_vote appended to the shared proposal's vote list.
            record.scalar_seqs.append(record.next_arrival_seq())
        return code, event

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
            # A demoted session can still be timed out: page it back in.
            slot = self._tier_lookup_promote(scope, proposal_id)
            if slot is None:
                raise SessionNotFound()
        # Timeout calls carry the embedder's clock even when vote traffic
        # has stopped: the liveness watchdog measures silence against it.
        self.health.tick(now)
        record = self._records[slot]
        owned = self._owns_slot(slot)
        was_active = self._state_code(record) == STATE_ACTIVE
        if was_active:
            # A fired timeout is the session's deciding activity.
            record.last_activity = now
        if record.session is not None:
            new_state = self._host_timeout(record)
        else:
            transitions = self._pool.timeout([slot])
            if transitions:
                [(_, new_state)] = transitions
            else:
                # Multi-host collective: this process joined the dispatch
                # but another process owns the slot; pool.timeout synced the
                # state mirror, so the result is readable (and the owner
                # emits the event).
                new_state = self._pool.state_of(slot)
        if was_active and owned:
            # Only timeouts that fired count, on the owning process only:
            # the call is idempotent for decided sessions (polls must not
            # inflate the counter), and a multi-host fleet's metrics sum
            # must report one firing.
            self._m_timeouts.inc()
        if was_active and self._health_live:
            # A fired timeout backs off the scope's learned timeout
            # (ownership-independent: each process keeps its own book).
            self._adaptive.on_timeout(scope, self._scope_configs.get(scope))
        outcome = _OUTCOME_OF_STATE.get(new_state)
        if outcome is not None:
            # The store ignores a second outcome for a session decided by
            # votes; the latency observation is ownership-gated like
            # events, the timeline stamp is not.
            self._timelines.decided(
                slot, outcome, now, time.monotonic(), by_timeout=True,
                observe=owned,
            )
            if trace_store.enabled and was_active and record.trace is not None:
                trace_store.instant(
                    "consensus.timeout_decided",
                    record.trace,
                    peer=self._trace_peer,
                    attrs={"outcome": outcome},
                )
        if new_state in (STATE_REACHED_YES, STATE_REACHED_NO):
            result = new_state == STATE_REACHED_YES
            if owned:
                self._emit(
                    scope,
                    ConsensusReached(
                        proposal_id=proposal_id, result=result, timestamp=now
                    ),
                )
            return result
        if owned:
            self._emit(
                scope, ConsensusFailedEvent(proposal_id=proposal_id, timestamp=now)
            )
        raise InsufficientVotesAtTimeout()

    @_spanned("engine.sweep")
    def sweep_timeouts(
        self, now: int, _gc_sink: "list | None" = None
    ) -> list[tuple[Scope, int, bool | None]]:
        """Fire the timeout decision for every still-ACTIVE session whose
        expiration has passed, in one device dispatch. Returns
        (scope, proposal_id, result-or-None) per swept session and emits the
        same events as per-session timeouts. A FAILED session is not swept
        again (its tallies are frozen, so it would re-fail forever).

        Expired active sessions in the tier are paged in first and fire
        like live ones. The sweep ends with :meth:`lifecycle_sweep` at
        ``now``; ``_gc_sink`` (private, the durable wrapper's) collects the
        (scope, proposal_id) keys it garbage-collects.

        Multi-host: collective (same cadence everywhere). The state mirror
        is synced first so every process computes the IDENTICAL expired
        set (remote slots' mirrored states lag between collectives), and
        each process returns and emits only the sessions it owns."""
        if self._multihost:
            self._pool.sync_states()
        with stage_span(self.tracer, "engine.sweep.scan"):
            self._promote_expired_tier(now)
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
        self.tracer.count("engine.timeout_sweeps")
        self.tracer.count("engine.timeouts_fired", len(expired) + len(host_expired))
        self.health.tick(now)  # the watchdog clock advances with the sweeps
        if expired or host_expired:
            flight_recorder.record(
                "engine.sweep", fired=len(expired) + len(host_expired)
            )
        wall = time.monotonic()
        # Pooled sessions in one dispatch (collective on a multi-host pool,
        # which returns this process's slots only), then the host-spilled
        # ones, in the JAX engine's order. Host-spilled sessions advance on
        # every process, but their events and results belong to process 0.
        with stage_span(self.tracer, "engine.sweep.timeout"):
            swept = [(slot, st, True) for slot, st in self._pool.timeout(expired)] + [
                (slot, self._host_timeout(self._records[slot]), self._owns_slot(slot))
                for slot in host_expired
            ]
        if self.tracer.enabled:
            reached = sum(
                1 for _, st, _ in swept if st in (STATE_REACHED_YES, STATE_REACHED_NO)
            )
            self.tracer.count("engine.timeouts_reached", reached)
            self.tracer.count("engine.timeouts_failed", len(swept) - reached)
        # Fired count and latency observations are ownership-gated like
        # events: a fleet's metrics sum reports each swept session once.
        self._m_timeouts.inc(sum(1 for _, _, owned in swept if owned))
        out: list[tuple[Scope, int, bool | None]] = []
        with stage_span(self.tracer, "engine.sweep.emit"):
            for slot, new_state, owned in swept:
                record = self._records[slot]
                record.last_activity = now  # the fired timeout (the GC TTL's start)
                if self._health_live:
                    self._adaptive.on_timeout(
                        record.scope, self._scope_configs.get(record.scope)
                    )
                outcome = _OUTCOME_OF_STATE.get(new_state)
                if outcome is not None:
                    self._timelines.decided(
                        slot, outcome, now, wall, by_timeout=True, observe=owned
                    )
                    if trace_store.enabled and record.trace is not None:
                        trace_store.instant(
                            "consensus.timeout_decided",
                            record.trace,
                            peer=self._trace_peer,
                            attrs={"outcome": outcome},
                        )
                if not owned:
                    continue
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
        self.lifecycle_sweep(now, _gc_sink=_gc_sink)
        return out

    # ── Queries (reference: src/storage.rs:112-180 derived helpers) ────

    def _decoded_retained(
        self, record: SessionRecord[Scope]
    ) -> list[tuple[int, list[Vote]]]:
        """A record's retained wire chunks decoded as (arrival seq, votes),
        once per growth; readers clone what they hand out."""
        n = len(record.retained_wire)
        if n == 0:
            return []
        if record.retained_cache is None or record.retained_cache[0] != n:
            chunks = [
                (seq, [Vote.decode(data[offs[k]:offs[k + 1]]) for k in range(len(offs) - 1)])
                for seq, data, offs in record.retained_wire
            ]
            record.retained_cache = (n, chunks)
        return record.retained_cache[1]

    def _materialized_proposal(self, record: SessionRecord[Scope]) -> Proposal:
        """Export view of a record's proposal: retained wire votes decoded
        and merged with the scalar-ingested ones in arrival order (one
        tick a scalar accept, one a retained chunk), so a session fed
        through both paths re-gossips a chain-valid vote list."""
        proposal = record.proposal.clone()
        retained = self._decoded_retained(record)
        if retained:
            scalar = proposal.votes
            # Votes embedded at registration predate the arrival clock and
            # keep their leading position.
            n_pre = len(scalar) - len(record.scalar_seqs)
            items: list[tuple[int, list[Vote]]] = [(-1, scalar[:n_pre])] if n_pre else []
            items.extend((seq, [vote]) for seq, vote in zip(record.scalar_seqs, scalar[n_pre:]))
            items.extend((seq, [v.clone() for v in votes]) for seq, votes in retained)
            items.sort(key=lambda t: t[0])
            proposal.votes = [v for _, votes in items for v in votes]
        return proposal

    def get_proposal(self, scope: Scope, proposal_id: int) -> Proposal:
        return self._materialized_proposal(self._get_record(scope, proposal_id))

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

    def _tier_sessions_where(self, scope: Scope, want_state: "int | None"):
        """A scope's demoted sessions as (entry, decoded session), without
        promoting them; ``want_state`` filters on the stored snapshot state
        code (None: all). Enumerations read through the tier; only point
        reads and mutations page sessions back in."""
        from ..sync.snapshot import decode_session_item

        for entry in self._tier.get(scope, {}).values():
            if want_state is None or entry.state == want_state:
                yield entry, decode_session_item(entry.item)[1]

    def get_active_proposals(self, scope: Scope) -> list[Proposal]:
        out = [
            self._materialized_proposal(r)
            for r in self._scope_records(scope)
            if self._state_code(r) == STATE_ACTIVE
        ]
        out.extend(session.proposal for _, session in self._tier_sessions_where(scope, 0))
        return out

    def get_reached_proposals(self, scope: Scope) -> list[tuple[Proposal, bool]]:
        out = []
        for r in self._scope_records(scope):
            state = self._state_code(r)
            if state in (STATE_REACHED_YES, STATE_REACHED_NO):
                out.append((self._materialized_proposal(r), state == STATE_REACHED_YES))
        out.extend(
            (session.proposal, bool(entry.result))
            for entry, session in self._tier_sessions_where(scope, 1)
        )
        return out

    def get_scope_stats(self, scope: Scope) -> ConsensusStats:
        """reference: src/service_stats.rs:32-59 (zeros for unknown scope).
        Demoted sessions count from their stored state, undecoded."""
        stats = ConsensusStats()
        # Snapshot state codes: 0 active, 1 reached, 2 failed.
        tier_codes = {0: STATE_ACTIVE, 1: STATE_REACHED_YES, 2: STATE_FAILED}
        codes = [self._state_code(r) for r in self._scope_records(scope)]
        codes += [tier_codes[e.state] for e in self._tier.get(scope, {}).values()]
        for state in codes:
            stats.total_sessions += 1
            if state == STATE_ACTIVE:
                stats.active_sessions += 1
            elif state == STATE_FAILED:
                stats.failed_sessions += 1
            else:
                stats.consensus_reached += 1
        return stats

    def proposal_timeline(self, scope: Scope, proposal_id: int) -> dict | None:
        """Lifecycle timeline of one proposal: created / first_vote /
        quorum / decided logical timestamps, the outcome (yes/no/failed and
        by_timeout) and the wall-clock latencies derived from them
        (``decision_latency_s`` feeds
        ``hashgraph_decision_latency_seconds``). Falls back to the bounded
        ring of finished timelines for recently deleted or evicted
        sessions; None when the proposal was never seen or aged out."""
        slot = self._index.get((scope, proposal_id))
        if slot is not None:
            tl = self._timelines.get(slot)
            if tl is not None and tl.proposal_id == proposal_id:
                return tl.as_dict()
        tl = self._timelines.find(scope, proposal_id)
        return tl.as_dict() if tl is not None else None

    def trace_context_of(self, scope: Scope, proposal_id: int):
        """The distributed :class:`~..obs.trace.TraceContext` bound to a
        live session (None when untracked or untraced), for embedders to
        carry to the peers they gossip to."""
        slot = self._index.get((scope, proposal_id))
        if slot is None:
            return None
        return self._records[slot].trace

    def explain_decision(self, scope: Scope, proposal_id: int) -> dict:
        """Decision provenance: one JSON-ready verdict on why and how this
        proposal is in its current state. The accepted vote chain (chain
        order, per-peer contributions, columnar tallies included), the
        quorum arithmetic (``div_ceil(2n, 3)``, ``ceil(n·t)`` or n <= 2
        unanimity, with the observed yes/no/silent counts and an
        independent re-run of the decision rule as a cross-check), the
        lifecycle timeline and the bound distributed-trace identity.
        Raises SessionNotFound for an unknown proposal; a
        :class:`~..wal.DurableEngine` overlays the WAL LSN watermark."""
        record = self._get_record(scope, proposal_id)
        session = self.export_session(scope, proposal_id)
        proposal = session.proposal
        n = proposal.expected_voters_count
        thr = session.config.consensus_threshold
        state = self._state_code(record)
        status = {
            STATE_ACTIVE: "active",
            STATE_FAILED: "failed",
            STATE_REACHED_YES: "reached",
            STATE_REACHED_NO: "reached",
        }[state]
        result = (
            state == STATE_REACHED_YES
            if state in (STATE_REACHED_YES, STATE_REACHED_NO)
            else None
        )
        timeline = self.proposal_timeline(scope, proposal_id)
        by_timeout = bool(timeline and timeline.get("by_timeout"))
        yes, total = session.tally_counts()
        if n <= 2:
            # Unanimity rule (reference: src/utils.rs:239-244).
            rule = "unanimity (n <= 2)"
            required = choice_required = n
        else:
            required = calculate_required_votes(n, thr)
            choice_required = calculate_threshold_based_value(n, thr)
            # Exactly the comparison calculate_threshold_based_value makes,
            # so the stated rule names the path that gave the numbers.
            rule = (
                "div_ceil(2n, 3)"
                if abs(thr - _TWO_THIRDS) < _F64_EPSILON
                else f"ceil(n * {thr!r})"
            )
        # Independent re-run of the decision rule over the reconstructed
        # session (the scalar substrate's decide_now).
        recomputed = session.decide_now(by_timeout)
        chain = [
            {
                "position": i,
                "owner": v.vote_owner.hex(),
                "vote": v.vote,
                "vote_id": v.vote_id,
                "timestamp": v.timestamp,
                "parent_hash": v.parent_hash.hex(),
                "vote_hash": v.vote_hash.hex(),
            }
            for i, v in enumerate(proposal.votes)
        ]
        contributions = {
            v.vote_owner.hex(): {"vote": v.vote, "via": "vote"}
            for v in session.votes.values()
        }
        for owner, value in session.tallies.items():
            contributions[owner.hex()] = {"vote": value, "via": "tally"}
        trace = None
        if record.trace is not None:
            trace = {
                "traceparent": record.trace.to_traceparent(),
                "trace_id": record.trace.trace_id.hex(),
                "span_id": record.trace.span_id.hex(),
            }
        return {
            "scope": str(scope),
            "proposal_id": proposal.proposal_id,
            "status": status,
            "result": result,
            "by_timeout": by_timeout,
            "proposal": {
                "name": proposal.name,
                "owner": proposal.proposal_owner.hex(),
                "round": proposal.round,
                "created_at": record.created_at,
                "expiration_timestamp": proposal.expiration_timestamp,
                "liveness_criteria_yes": proposal.liveness_criteria_yes,
            },
            "quorum": {
                "expected_voters": n,
                "threshold": thr,
                "rule": rule,
                "required_votes": required,
                "required_choice_votes": choice_required,
                "yes": yes,
                "no": total - yes,
                "total": total,
                "silent": max(n - total, 0),
                "reached": status == "reached",
                "recomputed_result": recomputed,
            },
            "vote_chain": chain,
            "contributions": contributions,
            "timeline": timeline,
            "trace": trace,
        }

    def health_report(self, now: int | None = None) -> dict:
        """Consensus-health snapshot: graded per-peer scorecards, the
        retained equivocation and fork evidence, the liveness watchdog and
        the firing alert rules (:meth:`HealthMonitor.snapshot`) plus this
        engine's signer identity. ``now`` is the embedder's logical tick
        (default: the latest tick the monitor has seen). Not engine-locked:
        the monitor has its own lock, so scrapes never contend with ingest.
        A :class:`~..wal.DurableEngine` overlays the WAL LSN watermark."""
        out = self.health.snapshot(now)
        out["identity"] = self._signer.identity().hex()
        return out

    def occupancy(self) -> dict:
        """Capacity snapshot: live sessions, device slots claimed vs the
        pool's capacity, host-spilled sessions (negative synthetic ids hold
        no pool row), and the tier: its sessions, their item bytes, and
        this engine's demotions, promotions and garbage-collected
        sessions."""
        with self._lock:
            slots = list(self._records)
            tier = (self._tier_count, self._tier_bytes, self._tier_demotions,
                    self._tier_promotions, self._tier_gc)
        device_used = sum(1 for s in slots if s >= 0)
        return {
            "live_sessions": len(slots),
            "device_slots_used": device_used,
            "host_spilled": len(slots) - device_used,
            "capacity": self._pool.capacity,
            "voter_capacity": self._pool.voter_capacity,
            "tier_sessions": tier[0],
            "tier_bytes": tier[1],
            "tier_demotions_total": tier[2],
            "tier_promotions_total": tier[3],
            "tier_gc_total": tier[4],
        }

    def session_keys(self) -> "list[tuple[Scope, int]]":
        """Every tracked ``(scope, proposal_id)`` in one consistent read,
        demoted sessions included."""
        with self._lock:
            keys = list(self._index.keys())
            for scope, entries in self._tier.items():
                keys.extend((scope, pid) for pid in entries)
            return keys

    # ── Checkpoint (host storage is the source of truth; the pool is a
    #    cache rebuilt from it) ──────────────────────────────────────────

    def export_session(self, scope: Scope, proposal_id: int) -> ConsensusSession:
        """A scalar ConsensusSession of a tracked session, the bridge to
        ``ConsensusStorage`` backends. A pooled session's tallies are read
        back from the device (lane -> owner through the gid registry);
        rows whose wire bytes were retained export as signed votes instead
        of tallies, so the session can still be re-gossiped after a save
        and load."""
        return self._export_record(self._get_record(scope, proposal_id))

    def _export_record(
        self, record: SessionRecord[Scope], row: "dict | None" = None
    ) -> ConsensusSession:
        """Body of :meth:`export_session` over a resolved record. ``row``
        optionally supplies the slot's device row (``vote_mask``,
        ``vote_val``) from a batched ``pool.read_slots``."""
        retained_votes = [
            vote for _, votes in self._decoded_retained(record) for vote in votes
        ]
        if record.session is not None:
            session = record.session.clone()
            if retained_votes:
                session.proposal = self._materialized_proposal(record)
                for vote in retained_votes:
                    # A retained signed vote supersedes its tally entry.
                    session.tallies.pop(vote.vote_owner, None)
                    if vote.vote_owner not in session.votes:
                        session.votes[vote.vote_owner] = vote.clone()
            return session
        votes = {k: v.clone() for k, v in record.votes.items()}
        tallies: dict[bytes, bool] = {}
        if row is None:
            row = self._pool.read_slot(record.slot)
        lane_owners = self._pool.lane_owners(record.slot)
        for lane in np.nonzero(row["vote_mask"])[0]:
            owner = lane_owners.get(int(lane))
            if owner is None or owner in votes:
                continue  # a scalar vote already carries this participant
            tallies[owner] = bool(row["vote_val"][lane])
        for vote in retained_votes:
            tallies.pop(vote.vote_owner, None)
            votes.setdefault(vote.vote_owner, vote.clone())
        return ConsensusSession(
            proposal=self._materialized_proposal(record),
            state=_STATE_TO_SCALAR[self._pool.state_of(record.slot)],
            votes=votes,
            created_at=record.created_at,
            config=record.config,
            tallies=tallies,
        )

    def save_to_storage(self, storage) -> int:
        """Persist every tracked session and scope config into a
        ``ConsensusStorage`` backend (reference: src/storage.rs:18-22).
        Returns the number of sessions written. The pooled sessions' rows
        come back from the device in one gather; demoted sessions are
        decoded from their tier bytes, so a snapshot or fingerprint holds
        the same session items whether a session is live or demoted."""
        records = [
            self._records[slot]
            for slots in self._scopes.values()
            for slot in slots
        ]
        pooled = [r.slot for r in records if r.session is None]
        rows = self._pool.read_slots(pooled) if pooled else None
        row_of = {slot: k for k, slot in enumerate(pooled)}
        for record in records:
            row = None
            if record.session is None:
                k = row_of[record.slot]
                row = {"vote_mask": rows["vote_mask"][k], "vote_val": rows["vote_val"][k]}
            storage.save_session(record.scope, self._export_record(record, row))
        count = len(records)
        for scope in self._tier:
            for _, session in self._tier_sessions_where(scope, None):
                storage.save_session(scope, session)
                count += 1
        for scope, config in self._scope_configs.items():
            storage.set_scope_config(scope, config.clone())
        return count

    def load_from_storage(self, storage) -> int:
        """Rebuild pool state from a ``ConsensusStorage`` backend: every
        stored session loads into a fresh slot (or the host, as
        registration places it) with its created_at, tallies, lanes and
        lifecycle state, unvalidated (storage is trusted, as the reference
        trusts its own). Sessions already tracked are skipped. Returns the
        number of sessions loaded."""
        count = 0
        for scope in storage.list_scopes() or []:
            config = storage.get_scope_config(scope)
            if config is not None:
                self._scope_configs[scope] = config.clone()
            sessions = storage.list_scope_sessions(scope) or []
            for session in sorted(sessions, key=lambda s: s.created_at):
                pid = session.proposal.proposal_id
                if (scope, pid) in self._index or self._tier_has(scope, pid):
                    continue  # idempotent restore
                self._register_session(scope, session.clone(), session.created_at)
                count += 1
        return count

    def delete_scope(self, scope: Scope) -> None:
        """Drop every session and the config of a scope
        (reference: src/storage.rs:92 delete_scope semantics)."""
        self.delete_scopes([scope])

    def delete_scopes(self, scopes: "list[Scope]") -> None:
        """Batched :meth:`delete_scope`: one pool release covers every
        scope's sessions; observably the same as one call a scope."""
        all_slots: list[int] = []
        for scope in scopes:
            slots = self._scopes.pop(scope, [])
            for slot in slots:
                record = self._records.pop(slot)
                del self._index[(scope, record.proposal.proposal_id)]
                self._timelines.forget(slot)
            # A host-spilled record holds no pool slot to release.
            all_slots.extend(s for s in slots if s >= 0)
            self._wire_cols.release(slots)
            self._scope_configs.pop(scope, None)
            self._drop_pid_cache(scope)
            # The scope's demoted sessions go with it.
            if scope in self._tier:
                self._drop_tier_entries(scope, list(self._tier[scope]))
            self._pinned_scopes.discard(scope)
            self._scope_seq.pop(scope, None)
        self._pool.release(all_slots)

    # ── Session tier (demote / page in / garbage-collect) ──────────────
    #
    # The write-ahead log makes any in-memory form of a session a cache, so
    # an idle or decided session can leave its pool slot or host record
    # and live on as its canonical snapshot item (the signed wire
    # included): promotion re-registers it without re-signing, and
    # fingerprints hash the same items either way. Point reads and
    # mutations page a demoted session back in; enumerations, stats and
    # save_to_storage read through the tier without promoting.

    def _tier_has(self, scope: Scope, proposal_id: int) -> bool:
        entries = self._tier.get(scope)
        return entries is not None and proposal_id in entries

    def _tier_lookup_promote(self, scope: Scope, proposal_id: int) -> "int | None":
        """Slot of a demoted session after paging it back in; None when
        the session is not in the tier (the caller's miss is real)."""
        if not self._tier_has(scope, proposal_id):
            return None
        return self._promote_key(scope, proposal_id)

    def demote_session(self, scope: Scope, proposal_id: int) -> bool:
        """Move one session out of its pool slot or host record into the
        tier. Idempotent: False when already demoted. Raises
        SessionNotFound for an unknown session. Any read or late vote
        pages it back in. Refused on a multi-host pool."""
        if self._multihost:
            raise RuntimeError(
                "session tiering is not supported on multi-host pools"
            )
        if self._tier_has(scope, proposal_id):
            return False
        slot = self._index.get((scope, proposal_id))
        if slot is None:
            raise SessionNotFound()
        self._demote_records(scope, [slot])
        return True

    # Pool lifecycle code -> (snapshot state code, result).
    _POOL_TO_SNAP = {
        STATE_ACTIVE: (0, False),
        STATE_REACHED_YES: (1, True),
        STATE_REACHED_NO: (1, False),
        STATE_FAILED: (2, False),
    }

    def _demote_records(self, scope: Scope, slots: "list[int]") -> int:
        """Demote live sessions of one scope: one ``read_slots`` gather of
        every pooled slot's row and one ``states_of`` read, then one pool
        release. A plain pooled session (no host record, no retained wire)
        encodes field-direct: the scope and config bytes memoized a call,
        its tallies straight off the gathered row, and a vote-free
        proposal's wire from one cached (head, tail) split a request shape
        plus its id. Host-spilled and wire-retaining sessions go through
        :meth:`_export_record` and :func:`encode_session_item`. Both routes
        write the bytes the JAX package writes for the same session."""
        from ..sync.snapshot import _STATE_CODE, encode_session_fields, encode_session_item
        from ..wal import format as F
        from ..wire import _U32_MASK, _encode_uint_field

        records = [self._records[s] for s in slots]
        rows: dict[int, dict] = {}
        pool_states: dict[int, int] = {}
        pooled = [r.slot for r in records if r.session is None]
        if pooled:
            batch = self._pool.read_slots(pooled)
            states = self._pool.states_of(pooled).tolist()
            for k, slot in enumerate(pooled):
                rows[slot] = {"vote_mask": batch["vote_mask"][k], "vote_val": batch["vote_val"][k]}
                pool_states[slot] = states[k]
        entries = self._tier.setdefault(scope, {})
        scope_bytes = F.encode_scope(scope)
        cfg_bytes: dict[int, bytes] = {}  # id(config) -> its encoding
        split_cache: dict[tuple, tuple[bytes, bytes]] = {}
        for record in records:
            pid = record.proposal.proposal_id
            if record.session is None and not record.retained_wire:
                state, result = self._POOL_TO_SNAP[pool_states[record.slot]]
                row = rows[record.slot]
                votes = record.votes
                # Assigned lanes only, in lane order (what a walk over the
                # whole row would find, without its voter_capacity steps).
                lane_owners = self._pool.lane_owners(record.slot)
                width = max(lane_owners, default=-1) + 1
                mask_row = row["vote_mask"][:width].tolist()
                val_row = row["vote_val"][:width].tolist()
                tallies: dict[bytes, bool] = {}
                for lane, owner in lane_owners.items():
                    if mask_row[lane] and owner not in votes:
                        tallies[owner] = bool(val_row[lane])
                config_bytes = cfg_bytes.get(id(record.config))
                if config_bytes is None:
                    config_bytes = F.encode_consensus_config(record.config)
                    cfg_bytes[id(record.config)] = config_bytes
                p = record.proposal
                if p.votes:
                    proposal_wire = p.encode()
                else:
                    shape = (p.name, p.payload, p.proposal_owner, p.expected_voters_count,
                             p.round, p.timestamp, p.expiration_timestamp,
                             p.liveness_criteria_yes)
                    parts = split_cache.get(shape)
                    if parts is None:
                        parts = split_cache[shape] = p.encode_split()
                    buf = bytearray(parts[0])
                    _encode_uint_field(buf, 12, p.proposal_id & _U32_MASK)
                    buf += parts[1]
                    proposal_wire = bytes(buf)
                item = encode_session_fields(scope_bytes, state, result, record.created_at,
                                             config_bytes, tallies, proposal_wire)
            else:
                session = self._export_record(record, row=rows.get(record.slot))
                item = encode_session_item(scope, session)
                state = _STATE_CODE[session.state.kind]
                result = bool(session.state.result)
            entries[pid] = _TierEntry(item, state, result, record.created_at, record.seq,
                                      record.last_activity)
            self._tier_count += 1
            self._tier_bytes += len(item)
            if state == 0:
                # Idle but active: the timeout sweep must still find it.
                self._tier_active[(scope, pid)] = record.proposal.expiration_timestamp
        self._drop_live_slots(scope, slots)
        self._tier_pid_arrays.pop(scope, None)
        n = len(records)
        self._tier_demotions += n
        self._m_tier_demotions.inc(n)
        self.tracer.count("engine.tier_demotions", n)
        return n

    def _drop_tier_entries(self, scope: Scope, pids: "list[int]") -> "list[_TierEntry]":
        """Shared tier teardown (promotion, cap eviction, GC, scope
        delete): the entries leave the tier, its counts and side maps."""
        entries = self._tier[scope]
        out = []
        for pid in pids:
            entry = entries.pop(pid)
            self._tier_count -= 1
            self._tier_bytes -= len(entry.item)
            if entry.state == 0:
                self._tier_active.pop((scope, pid), None)
            out.append(entry)
        if not entries:
            del self._tier[scope]
        self._tier_pid_arrays.pop(scope, None)
        return out

    def _promote_key(self, scope: Scope, proposal_id: int) -> "int | None":
        """Page one demoted session back in: decode its item and register
        it again (a pool slot, or the host when the session carries
        tallies or the pool cannot hold it, as registration places any
        session). It keeps its ``created_at``, its LRU ``seq`` and its
        idle clock, so demotion and promotion are invisible to eviction and
        the TTLs. None when the session lost the per-scope LRU ranking."""
        from ..sync.snapshot import decode_session_item

        [entry] = self._drop_tier_entries(scope, [proposal_id])
        _, session = decode_session_item(entry.item)
        self._promoting = True
        try:
            self._register_session(scope, session, entry.created_at)
        finally:
            self._promoting = False
        self._tier_promotions += 1
        self._m_tier_promotions.inc()
        self.tracer.count("engine.tier_promotions")
        slot = self._index.get((scope, proposal_id))
        if slot is None:
            return None
        record = self._records[slot]
        record.last_activity = entry.last_activity
        record.seq = entry.seq
        return slot

    def _promote_expired_tier(self, now: int) -> None:
        """Page back every active demoted session whose expiry has passed,
        so the timeout sweep fires it as if it had never left. Reads only
        the active side map, never the decided mass."""
        due = [key for key, expiry in self._tier_active.items() if expiry <= now]
        for scope, pid in due:
            if self._tier_has(scope, pid):
                self._promote_key(scope, pid)

    def _promote_columnar_misses(
        self, scopes: list, scope_idx, proposal_ids: np.ndarray, found: np.ndarray
    ) -> bool:
        """Page in the demoted sessions a columnar batch's unresolved rows
        name; True when any was promoted (the caller resolves again: the
        registrations dropped the pid caches). Free while the tier is
        empty, and Python work a missed row otherwise, never a row."""
        if not self._tier:
            return False
        promoted = False
        seen: set = set()
        for i in np.nonzero(~found)[0].tolist():
            scope = scopes[0] if scope_idx is None else scopes[int(scope_idx[i])]
            key = (scope, int(proposal_ids[i]))
            if key in seen:
                continue
            seen.add(key)
            if self._tier_has(*key):
                self._promote_key(*key)
                promoted = True
        return promoted

    def _drop_live_slots(self, scope: Scope, slots: "list[int]") -> None:
        """Shared live-session teardown (cap eviction, TTL GC, demotion):
        untrack the records, filter the scope's list, release the pool
        slots and drop the pid caches."""
        gone = set(slots)
        for slot in slots:
            record = self._records.pop(slot)
            del self._index[(scope, record.proposal.proposal_id)]
            self._timelines.forget(slot)
        self._wire_cols.release(slots)
        live = self._scopes.get(scope)
        if live is not None:
            self._scopes[scope] = [s for s in live if s not in gone]
        # A host-spilled record holds no pool slot to release.
        self._pool.release([s for s in slots if s >= 0])
        self._drop_pid_cache(scope)

    @_spanned("engine.lifecycle_sweep")
    def lifecycle_sweep(self, now: int, _gc_sink: "list | None" = None) -> dict:
        """Apply every scope's tier TTLs (``ScopeConfig.demote_after`` and
        ``evict_decided_after``) at the logical clock ``now``: first
        garbage-collect decided and failed sessions idle past the eviction
        TTL, live or demoted, then demote live sessions idle past the
        demotion TTL. :meth:`sweep_timeouts` runs it at its end; it may be
        called alone. Pinned scopes and scopes without TTLs are left
        alone. Returns ``{"demoted", "gc_live", "gc_tier"}``.

        ``_gc_sink`` (private) collects the collected (scope, pid) keys: a
        DurableEngine logs them as the KIND_GC record. Under
        :meth:`set_replay_mode` the sweep does nothing: the TTLs ride idle
        clocks a restore does not carry, so recovery applies the logged
        outcome (:meth:`gc_sessions`) instead of deciding again. On a
        multi-host pool it does nothing either: the control plane is
        replicated, and tiering is refused there."""
        out = {"demoted": 0, "gc_live": 0, "gc_tier": 0}
        if self._multihost or not self._lifecycle_live:
            return out  # replicated control plane / WAL replay
        records = self._records
        for scope, config in list(self._scope_configs.items()):
            demote_after = config.demote_after
            evict_after = config.evict_decided_after
            if (demote_after is None and evict_after is None) or scope in self._pinned_scopes:
                continue
            if evict_after is not None:
                cutoff = now - evict_after
                # The cheap clock filter first, then the states of the
                # survivors (one host-mirror read for the pooled ones).
                cand = [s for s in self._scopes.get(scope, [])
                        if records[s].last_activity <= cutoff]
                pooled = [s for s in cand if records[s].session is None]
                pooled_state = (
                    dict(zip(pooled, self._pool.states_of(pooled).tolist())) if pooled else {}
                )
                gc_slots = []
                for s in cand:
                    state = pooled_state.get(s)
                    if state is None:
                        state = state_code_of(records[s].session.state)
                    if state != STATE_ACTIVE:
                        gc_slots.append(s)
                if gc_slots:
                    if _gc_sink is not None:
                        _gc_sink.extend((scope, records[s].proposal.proposal_id)
                                        for s in gc_slots)
                    out["gc_live"] += self._gc_live(scope, gc_slots)
                dead = [pid for pid, e in self._tier.get(scope, {}).items()
                        if e.state != 0 and e.last_activity <= cutoff]
                if dead:
                    if _gc_sink is not None:
                        _gc_sink.extend((scope, pid) for pid in dead)
                    out["gc_tier"] += self._gc_tier(scope, dead)
            if demote_after is not None:
                cutoff = now - demote_after
                idle = [s for s in self._scopes.get(scope, [])
                        if records[s].last_activity <= cutoff]
                if idle:
                    out["demoted"] += self._demote_records(scope, idle)
        if out["demoted"] or out["gc_live"] or out["gc_tier"]:
            flight_recorder.record("engine.lifecycle_sweep", **out)
        return out

    def _gc_live(self, scope: Scope, slots: "list[int]") -> int:
        """Drop decided live sessions past their TTL, as a cap eviction
        drops them, counted as tier GC."""
        self._drop_live_slots(scope, slots)
        n = len(slots)
        self._tier_gc += n
        self._m_tier_gc.inc(n)
        self.tracer.count("engine.tier_gc", n)
        return n

    def _gc_tier(self, scope: Scope, pids: "list[int]") -> int:
        """Drop demoted sessions past their TTL, counted as tier GC."""
        self._drop_tier_entries(scope, pids)
        n = len(pids)
        self._tier_gc += n
        self._m_tier_gc.inc(n)
        self.tracer.count("engine.tier_gc", n)
        return n

    def gc_sessions(self, keys: "list[tuple[Scope, int]]") -> int:
        """Apply an exact GC outcome: drop each ``(scope, pid)``, live or
        demoted, counted as tier GC; unknown keys are skipped (idempotent).
        The replay entry point of KIND_GC records, and an explicit
        retirement for embedders. Returns the sessions dropped."""
        live: dict[Scope, list[int]] = {}
        tier: dict[Scope, list[int]] = {}
        for scope, pid in keys:
            slot = self._index.get((scope, pid))
            if slot is not None:
                live.setdefault(scope, []).append(slot)
            elif self._tier_has(scope, pid):
                tier.setdefault(scope, []).append(pid)
        applied = sum(self._gc_live(scope, slots) for scope, slots in live.items())
        return applied + sum(self._gc_tier(scope, pids) for scope, pids in tier.items())

    def pin_scope(self, scope: Scope) -> None:
        """Leave a scope out of the lifecycle sweep's demotion and GC
        (idempotent), as a router pins a shard's scopes while it migrates
        them."""
        self._pinned_scopes.add(scope)

    def unpin_scope(self, scope: Scope) -> None:
        self._pinned_scopes.discard(scope)

    def _taken_pids(self, scope: Scope) -> np.ndarray:
        """Every proposal id claimed in ``scope``, live and demoted, for
        batch id draws (a fresh id equal to a demoted one would put two
        sessions under one key at promotion)."""
        live = self._pid_table(scope)[0]
        entries = self._tier.get(scope)
        if not entries:
            return live
        tier = self._tier_pid_arrays.get(scope)
        if tier is None:
            tier = self._tier_pid_arrays[scope] = np.fromiter(
                entries.keys(), np.int64, len(entries)
            )
        return np.concatenate([live, tier])

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

    def adaptive_timeout(self, scope: Scope) -> float:
        """The consensus timeout the embedder should schedule next for
        ``scope``, in seconds: the learned value when the scope declared
        ``timeout_min``/``timeout_max`` bounds, else the scope's static
        ``default_timeout`` (or the gossipsub default), the reference
        behaviour. Advisory: timers stay the embedder's
        (reference: src/lib.rs:15-34)."""
        cfg = self._scope_configs.get(scope)
        learned = self._adaptive.current(scope, cfg)
        if learned is not None:
            return learned
        return cfg.default_timeout if cfg is not None else DEFAULT_TIMEOUT_SECONDS

    def adaptive_timeout_snapshot(self) -> dict:
        """Learner introspection (per-scope learned values and counters)."""
        return self._adaptive.snapshot()

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
            # A point read on a demoted session pages it back in.
            slot = self._tier_lookup_promote(scope, proposal_id)
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
        True when the newcomer itself loses the ranking.

        Demoted sessions are incumbents too, ranked by their kept
        ``seq`` (the original insertion order, even after a promotion
        re-appended a record), so a tiered engine evicts exactly what an
        untiered one does."""
        slots = self._scopes.get(scope, [])
        tier_entries = self._tier.get(scope)
        n_tier = len(tier_entries) if tier_entries else 0
        if len(slots) + n_tier + 1 <= self._max_sessions_per_scope:
            return False
        # (created_at, seq, is_tier, key); the newcomer's infinite seq loses
        # created_at ties to every incumbent.
        items = [
            (self._records[s].created_at, self._records[s].seq, False, s)
            for s in slots
        ]
        if tier_entries:
            items.extend((e.created_at, e.seq, True, pid) for pid, e in tier_entries.items())
        newcomer = (now, float("inf"), False, None)
        items.append(newcomer)
        items.sort(key=lambda t: t[1])
        items.sort(key=lambda t: t[0], reverse=True)
        keep = items[: self._max_sessions_per_scope]
        evicted = items[self._max_sessions_per_scope:]
        evicted_slots = [k for _, _, is_tier, k in evicted if not is_tier and k is not None]
        evicted_pids = [k for _, _, is_tier, k in evicted if is_tier]
        if evicted_slots:
            self._drop_live_slots(scope, evicted_slots)
        if evicted_pids:
            self._drop_tier_entries(scope, evicted_pids)
        return newcomer not in keep

    def _emit(self, scope: Scope, event: ConsensusEvent) -> None:
        self._event_bus.publish(scope, event)

    # ── Multi-host ownership (parallel/multihost.py contract) ──────────

    def _owns_replicated_event(self) -> bool:
        """Events arising from replicated, not-slot-owned work — proposal
        loads and host-spilled sessions — are emitted by process 0 only in
        multi-host mode, so a fleet of engine front-ends never
        double-publishes."""
        return self._process_zero

    def _owns_slot(self, slot: int) -> bool:
        """EVENT-emission ownership of one session. Single-host pools own
        everything. On a multi-host pool a device slot belongs to the
        process whose local range holds it; host-spilled sessions
        (replicated on every process) belong to process 0."""
        if not self._multihost:
            return True
        if slot < 0:
            return self._process_zero
        lo, hi = self._pool.local_slots()
        return lo <= slot < hi

    def _misrouted(self, record: SessionRecord[Scope]) -> bool:
        """A device-pooled session another process owns: its votes and
        deliveries report SESSION_NOT_FOUND here, before validation."""
        return (
            self._multihost
            and record.session is None
            and not self._owns_slot(record.slot)
        )

    def _non_local(self, found: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """Columnar rows whose device slot another process owns."""
        lo, hi = self._pool.local_slots()
        return found & (slots >= 0) & ((slots < lo) | (slots >= hi))

    def _agree_fresh_plan(self, fresh_ok: bool, s_count: int, depth: int) -> bool:
        """Multi-host columnar plan: the closed-form path is taken only when
        every process votes for it and the fleet-max grid fits the pool's
        cell budget (one all-gather, collective)."""
        from ..parallel.multihost import process_allgather

        fresh_ok = fresh_ok and getattr(self._pool, "supports_fresh_ingest", False)
        agreed = process_allgather(
            np.array([1 if fresh_ok else 0, s_count, depth], np.int64)
        )
        return bool(np.min(agreed[..., 0])) and self._pool.fresh_grid_within_budget(
            int(np.max(agreed[..., 1])), int(np.max(agreed[..., 2]))
        )

    def _agree_dispatch_count(self, count: int) -> int:
        """Multi-host scan plan: the most dispatches any process makes this
        call (one all-gather, collective); the others pad with empty ones."""
        from ..parallel.multihost import process_allgather

        return int(np.max(process_allgather(np.array([count], np.int64))))

    def is_local(self, scope: Scope, proposal_id: int) -> bool:
        """Routing query for multi-host embedders: should THIS process
        apply the session's votes? Device-pooled sessions: the slot-owning
        process only (route to it). Host-spilled sessions are replicated
        control-plane state: True on EVERY process — the relay must deliver
        their votes fleet-wide (like proposals) so the replicas advance
        identically; their events still come from process 0 only."""
        slot = self._index.get((scope, proposal_id))
        if slot is None:
            raise SessionNotFound()
        if slot < 0:
            return True
        return self._owns_slot(slot)


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
            try:
                return fn(self, *args, **kwargs)
            except ConsensusError:
                # The caller-facing contract: typed rejections, not faults.
                raise
            except Exception as exc:
                # Anything else is a fault: keep the evidence. The ring
                # holds the recent batch, creation and sweep notes; dumps
                # are rate-limited inside the recorder.
                flight_recorder.record(
                    "engine.fault", api=fn.__name__, error=repr(exc)
                )
                flight_recorder.dump(f"engine-fault:{fn.__name__}")
                raise

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
    "create_proposals_multi",
    "ingest_columnar",
    "ingest_columnar_multi",
    "ingest_wire_columnar",
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
    "proposal_timeline",
    "trace_context_of",
    "explain_decision",
    "export_session",
    "save_to_storage",
    "load_from_storage",
    "delete_scope",
    "delete_scopes",
    "demote_session",
    "lifecycle_sweep",
    "gc_sessions",
    "pin_scope",
    "unpin_scope",
    "set_replay_mode",
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
