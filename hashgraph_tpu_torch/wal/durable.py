"""DurableEngine: write-ahead-logged wrapper around a consensus engine.

The library core performs no I/O by contract (the embedder owns
persistence); a crash between ``save_to_storage`` snapshots therefore loses
every proposal and vote ingested since the last snapshot. ``DurableEngine``
closes that window with the classic ARIES + Raft-snapshot recipe:

1. **Log before acknowledging.** Every mutating call appends one WAL record
   of the canonical wire bytes (network ingest logs BEFORE applying;
   locally-minted data — ``create_proposal`` / ``cast_vote``, whose bytes
   only exist after the engine builds them — and columnar batches — whose
   per-row accept/reject outcome only the engine knows, see
   :meth:`DurableEngine._log_columnar_accepted` — log after applying but
   before returning, so nothing unlogged is ever acknowledged).
2. **Replay the tail on restart.** :meth:`recover` loads the latest
   snapshot (if any) and replays every record past its watermark through
   the engine's own batch ingest paths — recovered traffic is validated
   exactly like live traffic.
3. **Compact behind snapshots.** :meth:`checkpoint` saves a snapshot,
   appends a watermark mark, and deletes every sealed segment the snapshot
   fully covers.

The wrapper exposes the full engine surface: mutators are intercepted and
logged; reads (and everything else) delegate to the wrapped engine
untouched. One wrapper-level lock serializes mutators so WAL order always
equals apply order across threads — acceptable because the engine itself is
coarse-locked by design.

A copy of the JAX package's ``wal/durable.py`` over
:class:`~hashgraph_tpu_torch.engine.TorchConsensusEngine`. The checkpoint
and recovery counts and the flight-recorder notes that package sends to its
process-wide metrics stay on the wrapper (:meth:`DurableEngine.stats`,
:meth:`DurableEngine.flight_notes`); the ``explain_decision`` and
``health_report`` overlays wait for the port's health layer.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

import numpy as np

from ..errors import StatusCode
from ..scope_config import ScopeConfig, ScopeConfigBuilder
from ..wire import normalize_wire_votes
from . import format as F
from .recovery import ReplayStats, replay
from .writer import WalWriter


class DurableEngine:
    """Write-ahead-logged engine front-end.

    ``engine`` is typically a
    :class:`~hashgraph_tpu_torch.engine.TorchConsensusEngine` but any object
    with the same surface works (the wrapper never imports the engine
    class). ``wal`` is a :class:`WalWriter` or a
    directory path (extra keyword arguments are forwarded to the writer —
    ``fsync_policy``, ``segment_bytes``, ...).
    """

    def __init__(self, engine, wal, *, record_budget: int = F.MAX_RECORD, **wal_kwargs):
        if isinstance(wal, (str, os.PathLike)):
            wal = WalWriter(wal, **wal_kwargs)
        elif wal_kwargs:
            raise ValueError(
                "wal_kwargs are only valid when wal is a directory path"
            )
        if record_budget <= 0 or record_budget > F.MAX_RECORD:
            raise ValueError("record_budget must be in (0, format.MAX_RECORD]")
        self._engine = engine
        self._wal = wal
        # Soft per-record payload budget: batches whose encoding would
        # cross it are split across multiple records (one engine apply,
        # several log records — replay applies them as consecutive smaller
        # batches, which is semantically identical because the engine's
        # batch semantics equal its sequential semantics at any batch
        # size). The writer independently enforces the hard MAX_RECORD cap.
        self._record_budget = record_budget
        self._ckpt_watermark = 0
        self._lock = threading.RLock()
        # Checkpoint and recovery counts, and the last flight-recorder
        # notes (kind, fields), kept on the wrapper.
        self._checkpoints = 0
        self._recover_seconds: list[float] = []
        self._notes: deque = deque(maxlen=256)

    def _append_split(self, kind, items, encode, lead, sizeof) -> None:
        """Append ``encode(chunk)`` for consecutive chunks of ``items``,
        each chunk's payload (``lead`` header bytes + per-item ``sizeof``
        footprints) inside the record budget. Boundaries are chosen
        arithmetically so every byte is encoded exactly once — no trial
        encodes of oversized payloads. A single item over the budget is
        appended as-is (the writer raises if it also exceeds the hard cap —
        nothing is acked in that case). Splitting is invisible to replay:
        consecutive smaller batches are semantically identical because the
        engine's batch semantics equal its sequential semantics at any
        batch size."""
        budget = self._record_budget - F.BODY_LEAD_BYTES - lead
        chunk: list = []
        used = 0
        for item in items:
            size = sizeof(item)
            if chunk and used + size > budget:
                self._wal.append(kind, encode(chunk))
                chunk, used = [], 0
            chunk.append(item)
            used += size
        if chunk:
            self._wal.append(kind, encode(chunk))

    def _append_columnar_split(
        self, now, scopes, scope_idx, blob, offsets, kind=None
    ) -> None:
        """Columnar counterpart of :meth:`_append_split`: chunk the ROW
        range by walking the offsets (per-row footprint = wire bytes + one
        u32 offset entry + one u32 scope_idx entry when multi-scope),
        rebasing offsets and slicing scope_idx per chunk. Each chunk keeps
        the full scope list — only the rows are split."""
        if kind is None:
            kind = F.KIND_COLUMNAR
        multi = len(scopes) > 1
        # Fixed per-record lead: now + scope count + scopes + row count +
        # blob length prefix + the offsets array's extra (rows+1)th entry.
        lead = 8 + 4 + sum(len(F.encode_scope(s)) for s in scopes) + 4 + 4 + 4
        budget = self._record_budget - F.BODY_LEAD_BYTES - lead
        per_row_fixed = 8 if multi else 4
        count = len(offsets) - 1
        start = 0
        while start < count:
            end, used = start, 0
            while end < count:
                row = per_row_fixed + int(offsets[end + 1] - offsets[end])
                if end > start and used + row > budget:
                    break
                used += row
                end += 1
            lo, hi = int(offsets[start]), int(offsets[end])
            self._wal.append(
                kind,
                F.encode_columnar(
                    now,
                    scopes,
                    scope_idx[start:end] if multi else None,
                    blob[lo:hi],
                    offsets[start : end + 1] - lo,
                ),
            )
            start = end

    def _log_columnar_accepted(
        self, now, scopes, scope_idx, blob, offsets, statuses, kind=None
    ) -> None:
        """Log the rows the engine ACCEPTED (status OK) out of an applied
        columnar batch. Columnar records are logged after the apply, before
        the ack, because only the engine knows which rows it tallied: the
        live call trusts the caller's interned gid column (stale gids are
        dropped by the liveness check), while replay must re-derive gids
        from the wire bytes — fresh interning that would ACCEPT a row the
        live engine rejected. Logging only tallied rows keeps the recovered
        engine observably identical. A crash between apply and log loses an
        unacknowledged batch — same contract as the locally-minted paths."""
        ok = np.asarray(statuses, np.int64) == int(StatusCode.OK)
        if not ok.any():
            return
        if ok.all():
            self._append_columnar_split(
                now, scopes, scope_idx, blob, offsets, kind=kind
            )
            return
        keep = np.flatnonzero(ok)
        lens = (offsets[1:] - offsets[:-1])[keep]
        new_offsets = np.zeros(len(keep) + 1, np.int64)
        np.cumsum(lens, out=new_offsets[1:])
        new_blob = b"".join(
            blob[int(offsets[i]) : int(offsets[i + 1])] for i in keep
        )
        idx = None if scope_idx is None else np.asarray(scope_idx)[keep]
        self._append_columnar_split(
            now, scopes, idx, new_blob, new_offsets, kind=kind
        )

    # ── Accessors ──────────────────────────────────────────────────────

    @property
    def engine(self):
        return self._engine

    @property
    def wal(self) -> WalWriter:
        return self._wal

    def close(self) -> None:
        self._wal.close()

    def abandon(self) -> None:
        """Simulated ``kill -9`` (see :meth:`WalWriter.abandon`): release
        the WAL's handles and flock without the close-path fsync, so a
        chaos harness can restart this identity from the surviving log
        in-process. The wrapped engine object is left as-is — a crashed
        process's memory is simply gone; callers drop their reference."""
        self._wal.abandon()

    def __enter__(self) -> "DurableEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __getattr__(self, name):
        # Reads and anything else not intercepted delegate to the engine.
        return getattr(self._engine, name)

    def capture_consistent(self, capture):
        """Run ``capture(engine, watermark)`` under the mutator lock and
        return its result: the callback observes a frozen engine whose
        state reflects exactly the records with ``lsn <= watermark``
        (mutators and the capture serialize on the same lock, so nothing
        can land between reading the LSN and reading the state). This is
        the consistency primitive state-sync snapshot builds ride on; the capture
        should be read-only and brief — writes stall for its duration."""
        with self._lock:
            return capture(self._engine, self._wal.last_lsn)

    def stats(self) -> dict:
        """The writer's counts (:meth:`WalWriter.stats`) with this
        wrapper's: checkpoints taken and the seconds of each recovery, under
        the JAX package's metric names."""
        out = self._wal.stats()
        with self._lock:
            out["wal_checkpoints_total"] = self._checkpoints
            out["wal_recover_seconds"] = list(self._recover_seconds)
        return out

    def flight_notes(self) -> list:
        """The wrapper's last flight-recorder notes, oldest first:
        ``("wal.recover", fields)`` and ``("wal.checkpoint", fields)``."""
        with self._lock:
            return list(self._notes)

    # ── Recovery ───────────────────────────────────────────────────────

    def recover(
        self,
        storage=None,
        *,
        after_lsn: "int | None" = None,
        on_record=None,
    ) -> ReplayStats:
        """Rebuild the wrapped engine from the WAL (and optionally a
        snapshot): with ``storage``, loads it first and replays only records
        the snapshot does not cover; without, replays every surviving
        record from the start of the log. If compaction ever ran, records
        before the watermark no longer exist on disk, so the snapshot
        ``storage`` is required to recover them.

        By default a loaded ``storage`` is assumed to be the LATEST
        checkpoint, and replay skips up to the log's most recent snapshot
        mark. If you keep older snapshots too, that assumption is unsafe —
        recovering an older (or empty) storage under it would silently skip
        acknowledged records the snapshot does not actually contain. For
        that case persist :attr:`last_checkpoint_watermark` alongside each
        snapshot and pass it back here as ``after_lsn``: replay then skips
        exactly the records that snapshot covers. (Over-replay is safe — a
        watermark older than the snapshot just re-ingests records the
        engine rejects as duplicates — so when unsure, pass a smaller
        ``after_lsn``.)

        ``on_record(lsn, kind)`` forwards to
        :func:`~.recovery.replay` — replay-progress
        observation for long logs (a fleet supervisor reporting a
        recovering shard's position)."""
        with self._lock:
            start = time.perf_counter()
            # Replay-mode metrics gate (engines without one — this module
            # is duck-typed — just replay unguarded): replayed decisions
            # were made before the crash, so they must not feed the
            # decision-latency histogram or re-count as fresh decisions.
            set_mode = getattr(self._engine, "set_replay_mode", None)
            if set_mode is not None:
                set_mode(True)
            try:
                if storage is None:
                    stats = replay(
                        self._wal.directory,
                        self._engine,
                        after_lsn=0 if after_lsn is None else after_lsn,
                        on_record=on_record,
                    )
                else:
                    self._engine.load_from_storage(storage)
                    # after_lsn=None: skip records the latest snapshot
                    # covers (replay finds the watermark on a first
                    # metadata pass and streams the tail one segment at a
                    # time).
                    stats = replay(
                        self._wal.directory,
                        self._engine,
                        after_lsn=after_lsn,
                        on_record=on_record,
                    )
            finally:
                if set_mode is not None:
                    set_mode(False)
            duration = time.perf_counter() - start
            self._recover_seconds.append(duration)
            self._notes.append(("wal.recover", dict(
                directory=self._wal.directory,
                records=stats.records_applied,
                errors=len(stats.errors),
                segments_dropped=stats.segments_dropped,
                seconds=round(duration, 6),
            )))
            return stats

    # ── Proposal lifecycle ─────────────────────────────────────────────

    # Conservative upper bound on everything a single-proposal record adds
    # beyond the request's variable-length fields (wire varints/tags, the
    # consensus-config override, counts, framing).
    _MINT_SLACK = 1024

    def _ensure_mintable(self, scope, request) -> None:
        """Reject a create request whose logged record could exceed the
        hard MAX_RECORD cap BEFORE the engine mints anything. The minted
        wire bytes only exist after the engine builds them, so the
        locally-minted paths log after applying — an unloggable request
        must therefore fail before the apply, or the live engine would
        hold state recovery can never reproduce."""
        bound = (
            len(request.payload)
            + len(request.name.encode("utf-8"))
            + len(request.proposal_owner)
            + len(F.encode_scope(scope))
            + self._MINT_SLACK
        )
        if F.BODY_LEAD_BYTES + bound > F.MAX_RECORD:
            raise ValueError(
                f"proposal payload too large to log durably: the WAL record "
                f"could exceed MAX_RECORD ({F.MAX_RECORD} bytes)"
            )

    def create_proposal(self, scope, request, now, config=None):
        with self._lock:
            self._ensure_mintable(scope, request)
            proposal = self._engine.create_proposal(scope, request, now, config)
            self._wal.append(
                F.KIND_PROPOSALS,
                F.encode_proposals(now, [(scope, proposal.encode(), config)]),
            )
            return proposal

    def create_proposals(self, scope, requests, now, config=None):
        with self._lock:
            for request in requests:
                self._ensure_mintable(scope, request)
            proposals = self._engine.create_proposals(scope, requests, now, config)
            self._append_split(
                F.KIND_PROPOSALS,
                [(scope, p.encode(), config) for p in proposals],
                lambda items: F.encode_proposals(now, items),
                F.PROPOSALS_LEAD_BYTES,
                F.sizeof_proposal_item,
            )
            return proposals

    def create_proposals_multi(self, items, now, config=None):
        with self._lock:
            for scope, requests in items:
                for request in requests:
                    self._ensure_mintable(scope, request)
            out = self._engine.create_proposals_multi(items, now, config)
            flat = [
                (scope, p.encode(), config)
                for (scope, _), proposals in zip(items, out)
                for p in proposals
            ]
            self._append_split(
                F.KIND_PROPOSALS,
                flat,
                lambda its: F.encode_proposals(now, its),
                F.PROPOSALS_LEAD_BYTES,
                F.sizeof_proposal_item,
            )
            return out

    def process_incoming_proposal(self, scope, proposal, now, config=None):
        with self._lock:
            self._wal.append(
                F.KIND_PROPOSALS,
                F.encode_proposals(now, [(scope, proposal.encode(), config)]),
            )
            self._engine.process_incoming_proposal(scope, proposal, now, config)

    def ingest_proposals(self, items, now, configs=None):
        with self._lock:
            self._append_split(
                F.KIND_PROPOSALS,
                [
                    (
                        scope,
                        proposal.encode(),
                        configs[i] if configs is not None else None,
                    )
                    for i, (scope, proposal) in enumerate(items)
                ],
                lambda its: F.encode_proposals(now, its),
                F.PROPOSALS_LEAD_BYTES,
                F.sizeof_proposal_item,
            )
            return self._engine.ingest_proposals(items, now, configs=configs)

    def deliver_proposal(self, scope, proposal, now, config=None):
        with self._lock:
            self._wal.append(
                F.KIND_DELIVER,
                F.encode_proposals(now, [(scope, proposal.encode(), config)]),
            )
            return self._engine.deliver_proposal(scope, proposal, now, config)

    def deliver_proposals(self, items, now, configs=None):
        """Create-or-extend gossip delivery, logged under KIND_DELIVER so
        replay re-runs the watermark path (a KIND_PROPOSALS record would
        replay as plain ingest and silently DROP the suffix votes an
        extension applied live). Record splitting is safe because
        deliver_proposals processes items strictly in order — a batch
        call is definitionally equivalent to the same deliveries made as
        consecutive smaller batches (the engine documents that guarantee
        as load-bearing for exactly this splitting)."""
        with self._lock:
            self._append_split(
                F.KIND_DELIVER,
                [
                    (
                        scope,
                        proposal.encode(),
                        configs[i] if configs is not None else None,
                    )
                    for i, (scope, proposal) in enumerate(items)
                ],
                lambda its: F.encode_proposals(now, its),
                F.PROPOSALS_LEAD_BYTES,
                F.sizeof_proposal_item,
            )
            return self._engine.deliver_proposals(items, now, configs=configs)

    # ── Voting ─────────────────────────────────────────────────────────

    def cast_vote(self, scope, proposal_id, choice, now):
        with self._lock:
            vote = self._engine.cast_vote(scope, proposal_id, choice, now)
            # Locally built and signed by this engine's own signer — replay
            # skips re-validation exactly as the live apply did.
            self._wal.append(
                F.KIND_VOTES,
                F.encode_votes(now, True, [(scope, vote.encode())]),
            )
            return vote

    def cast_vote_and_get_proposal(self, scope, proposal_id, choice, now):
        with self._lock:
            self.cast_vote(scope, proposal_id, choice, now)
            return self._engine.get_proposal(scope, proposal_id)

    def process_incoming_vote(self, scope, vote, now):
        with self._lock:
            self._wal.append(
                F.KIND_VOTES, F.encode_votes(now, False, [(scope, vote.encode())])
            )
            self._engine.process_incoming_vote(scope, vote, now)

    def ingest_votes(self, items, now, pre_validated=False):
        with self._lock:
            self._append_split(
                F.KIND_VOTES,
                [(scope, vote.encode()) for scope, vote in items],
                lambda its: F.encode_votes(now, pre_validated, its),
                F.VOTES_LEAD_BYTES,
                F.sizeof_vote_item,
            )
            return self._engine.ingest_votes(items, now, pre_validated=pre_validated)

    def ingest_votes_pipelined(self, batches, now, pre_validated=False):
        """Durable :meth:`TorchConsensusEngine.ingest_votes_pipelined`: one
        KIND_VOTES record per batch, all logged IN ORDER before any batch
        applies (log-before-ack at the granularity of the whole pipelined
        call — statuses are not returned until every batch applied, so a
        crash replays exactly the batch sequence the caller would have
        been acked for, and replay runs them as plain sequential
        ingest_votes calls, which the pipelined path is result-identical
        to by contract)."""
        with self._lock:
            batches = [list(b) for b in batches]
            for items in batches:
                self._append_split(
                    F.KIND_VOTES,
                    [(scope, vote.encode()) for scope, vote in items],
                    lambda its: F.encode_votes(now, pre_validated, its),
                    F.VOTES_LEAD_BYTES,
                    F.sizeof_vote_item,
                )
            return self._engine.ingest_votes_pipelined(
                batches, now, pre_validated=pre_validated
            )

    def ingest_columnar(
        self,
        scope,
        proposal_ids,
        voter_gids,
        values,
        now,
        max_depth=8,
        wire_votes=None,
    ):
        if wire_votes is None:
            raise ValueError(
                "durable columnar ingest requires wire_votes: without the "
                "canonical vote bytes the batch cannot be logged or replayed "
                "(gid interning is process-local)"
            )
        with self._lock:
            blob, offsets = normalize_wire_votes(wire_votes, len(proposal_ids))
            statuses = self._engine.ingest_columnar(
                scope,
                proposal_ids,
                voter_gids,
                values,
                now,
                max_depth=max_depth,
                wire_votes=(blob, offsets),
            )
            self._log_columnar_accepted(
                now, [scope], None, blob, offsets, statuses
            )
            return statuses

    def ingest_columnar_multi(
        self,
        scopes,
        scope_idx,
        proposal_ids,
        voter_gids,
        values,
        now,
        max_depth=8,
        wire_votes=None,
    ):
        if wire_votes is None:
            raise ValueError(
                "durable columnar ingest requires wire_votes: without the "
                "canonical vote bytes the batch cannot be logged or replayed "
                "(gid interning is process-local)"
            )
        with self._lock:
            blob, offsets = normalize_wire_votes(wire_votes, len(proposal_ids))
            idx = None if len(scopes) <= 1 else np.asarray(scope_idx)
            statuses = self._engine.ingest_columnar_multi(
                scopes,
                scope_idx,
                proposal_ids,
                voter_gids,
                values,
                now,
                max_depth=max_depth,
                wire_votes=(blob, offsets),
            )
            self._log_columnar_accepted(
                now, list(scopes), idx, blob, offsets, statuses
            )
            return statuses

    def ingest_wire_columnar(
        self,
        scopes,
        scope_idx,
        cols,
        data,
        offsets,
        now,
        max_depth=8,
        stage_seconds=None,
        _prepass=None,
    ):
        """Durable wire-columnar ingest (the bridge's OP_VOTE_BATCH fast
        path): apply-validated rows log as a KIND_WIRE_COLUMNAR record of
        their verbatim wire bytes — same accepted-rows-only discipline as
        :meth:`ingest_columnar_multi`, logged after the apply, before the
        ack, but the kind byte routes replay back through
        ``ingest_wire_columnar`` (crypto skipped) so a recovered peer
        keeps wire-validated retention and the cross-frame dangling-vote
        guard its non-crashed twins have (see format.KIND_WIRE_COLUMNAR).
        The WAL blob doubles as the engine's working copy (``_buf``) —
        one ``tobytes()`` per frame across the whole durable path."""
        with self._lock:
            blob = (
                _prepass.buf if _prepass is not None and _prepass.buf is not None
                else data.tobytes() if hasattr(data, "tobytes")
                else bytes(data)
            )
            statuses = self._engine.ingest_wire_columnar(
                scopes,
                scope_idx,
                cols,
                data,
                offsets,
                now,
                max_depth=max_depth,
                stage_seconds=stage_seconds,
                _prepass=_prepass,
                _buf=blob,
            )
            offs = np.asarray(offsets, np.int64)
            idx = None if len(scopes) <= 1 else np.asarray(scope_idx)
            self._log_columnar_accepted(
                now, list(scopes), idx, blob, offs, statuses,
                kind=F.KIND_WIRE_COLUMNAR,
            )
            return statuses

    # ── Timeouts ───────────────────────────────────────────────────────

    def handle_consensus_timeout(self, scope, proposal_id, now):
        with self._lock:
            # Log first: the call mutates (and emits) even when it raises
            # InsufficientVotesAtTimeout; replay re-raises identically.
            self._wal.append(
                F.KIND_TIMEOUT, F.encode_timeout(scope, proposal_id, now)
            )
            return self._engine.handle_consensus_timeout(scope, proposal_id, now)

    def sweep_timeouts(self, now):
        """Timeout sweep + tier lifecycle, logged in two parts: the
        KIND_SWEEP record (before the apply — the timeout half replays
        deterministically from persisted expiries) and, when the
        lifecycle hook garbage-collected anything, a KIND_GC record of
        the exact keys (after the apply, before the ack — the TTL
        decision rides idle clocks a snapshot restore does not carry, so
        replay applies the logged outcome instead of re-deriving the
        policy; see format.KIND_GC). A crash between apply and GC-log
        merely leaves the collected sessions to be re-collected by the
        recovered engine's next sweep."""
        with self._lock:
            self._wal.append(F.KIND_SWEEP, F.encode_sweep(now))
            sink: list = []
            out = self._engine.sweep_timeouts(now, _gc_sink=sink)
            if sink:
                self._wal.append(F.KIND_GC, F.encode_gc(sink))
            return out

    def lifecycle_sweep(self, now):
        """Standalone tier sweep, logged like :meth:`sweep_timeouts`'s
        lifecycle half (KIND_LIFECYCLE + the KIND_GC outcome): its TTL
        GC is semantic — demoted sessions past ``evict_decided_after``
        cease to exist — so an unlogged call would let a crash resurrect
        sessions the live engine already dropped. ``demote_session``
        stays unlogged by design — demotion is cache management, and
        recovery rebuilding a demoted session as live is
        fingerprint-identical.

        An engine without ``lifecycle_sweep`` fails here as it fails
        itself, before anything is logged: a logged call the engine cannot
        replay would stop every later recovery."""
        with self._lock:
            sweep = self._engine.lifecycle_sweep
            self._wal.append(F.KIND_LIFECYCLE, F.encode_lifecycle(now))
            sink: list = []
            out = sweep(now, _gc_sink=sink)
            if sink:
                self._wal.append(F.KIND_GC, F.encode_gc(sink))
            return out

    # ── Scope config ───────────────────────────────────────────────────

    def scope(self, scope):
        """Fluent builder bound to THIS wrapper, so the terminal
        initialize/update calls are logged (the engine's own builder would
        bypass the WAL)."""
        from ..service import ScopeConfigBuilderWrapper

        existing = self._engine.get_scope_config(scope)
        builder = (
            ScopeConfigBuilder.from_existing(existing)
            if existing is not None
            else ScopeConfigBuilder()
        )
        return ScopeConfigBuilderWrapper(self, scope, builder)

    def set_scope_config(self, scope, config: ScopeConfig) -> None:
        self._scope_config_op(F.SCOPE_CONFIG_SET, scope, config)

    def _initialize_scope(self, scope, config: ScopeConfig) -> None:
        self._scope_config_op(F.SCOPE_CONFIG_INITIALIZE, scope, config)

    def _update_scope_config(self, scope, config: ScopeConfig) -> None:
        self._scope_config_op(F.SCOPE_CONFIG_UPDATE, scope, config)

    def _scope_config_op(self, mode: int, scope, config: ScopeConfig) -> None:
        apply = {
            F.SCOPE_CONFIG_SET: self._engine.set_scope_config,
            F.SCOPE_CONFIG_INITIALIZE: self._engine._initialize_scope,
            F.SCOPE_CONFIG_UPDATE: self._engine._update_scope_config,
        }[mode]
        with self._lock:
            self._wal.append(
                F.KIND_SCOPE_CONFIG,
                F.encode_scope_config_record(mode, scope, config),
            )
            apply(scope, config)

    def delete_scope(self, scope) -> None:
        self.delete_scopes([scope])

    def delete_scopes(self, scopes) -> None:
        with self._lock:
            self._wal.append(F.KIND_SCOPE_DELETE, F.encode_scope_delete(list(scopes)))
            self._engine.delete_scopes(list(scopes))

    # ── Snapshot + compaction ──────────────────────────────────────────

    @property
    def last_checkpoint_watermark(self) -> int:
        """Watermark of the most recent save_to_storage/checkpoint in this
        process (0 = none yet). Embedders keeping more than the latest
        snapshot should persist it alongside each one and hand it back to
        :meth:`recover` as ``after_lsn``."""
        return self._ckpt_watermark

    def save_to_storage(self, storage) -> int:
        """Snapshot every tracked session into ``storage`` and append a
        snapshot watermark: records up to the pre-snapshot LSN are now
        covered and eligible for compaction. The watermark is readable as
        :attr:`last_checkpoint_watermark` until the next checkpoint."""
        count, _ = self._save_and_mark(storage)
        return count

    def checkpoint(self, storage, compact: bool = True) -> int:
        """save_to_storage + (optionally) drop every segment the new
        snapshot fully covers. Returns the number of sessions saved.

        ``compact=True`` is only safe when ``storage`` persists
        SYNCHRONOUSLY — by the time ``save_to_storage`` returns, the
        snapshot must survive a crash. Compaction deletes the only other
        copy of the covered records; if the backend buffers (writes its
        snapshot file later), a crash in that window loses acknowledged
        records unrecoverably, even under ``fsync_policy="always"``. For a
        buffering backend use the two-phase form: ``checkpoint(storage,
        compact=False)``, make the snapshot durable, then
        ``wal.compact(last_checkpoint_watermark)``."""
        count, watermark = self._save_and_mark(storage)
        if compact:
            self._wal.compact(watermark)
        return count

    def compact(self) -> int:
        """Second phase of the two-phase checkpoint for BUFFERING storage
        backends: drop every sealed segment the most recent checkpoint
        covers. The documented safe flow is ``checkpoint(storage,
        compact=False)`` → make the snapshot durable → ``compact()``; this
        method is that last step as one safe call (it compacts to
        :attr:`last_checkpoint_watermark`, never beyond what a snapshot in
        this process actually covered). Raises if no checkpoint ran yet —
        compacting without one would delete the only copy of acknowledged
        records. Returns the number of segments removed. A crash in the
        window between the phases is safe in both orders: snapshot durable
        but not compacted merely re-replays covered records (duplicate
        rejection converges), and the un-compacted log still covers a
        snapshot that never became durable."""
        with self._lock:
            if self._ckpt_watermark <= 0:
                raise ValueError(
                    "no checkpoint in this process: call "
                    "checkpoint(storage, compact=False) first, make the "
                    "snapshot durable, then compact()"
                )
            return self._wal.compact(self._ckpt_watermark)

    def load_from_storage(self, storage) -> int:
        """Delegates without logging: a bulk restore is snapshot-shaped
        state, not traffic — callers restoring a crashed node should use
        :meth:`recover`, which also replays the WAL tail."""
        with self._lock:
            return self._engine.load_from_storage(storage)

    def _save_and_mark(self, storage) -> tuple[int, int]:
        with self._lock:
            count = self._engine.save_to_storage(storage)
            self._checkpoints += 1
            self._notes.append(("wal.checkpoint", dict(sessions=count)))
            # Everything logged before the save is inside the snapshot
            # (mutators and the save both run under this lock). Sealing the
            # active segment first puts the whole covered history into
            # sealed segments, so a following compact() can drop ALL of it;
            # the mark itself lands in the fresh active segment.
            watermark = self._wal.last_lsn
            self._wal.rotate()
            self._wal.append_snapshot_mark(watermark)
            self._ckpt_watermark = watermark
            return count, watermark
