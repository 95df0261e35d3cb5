"""Crash recovery: scan a WAL directory and replay it into an engine.

Replay feeds records through the engine's EXISTING batch entry points —
``ingest_proposals`` / ``ingest_votes`` / ``ingest_columnar`` /
``ingest_columnar_multi`` — so recovered state runs the same validation
gauntlet as live traffic (signatures, chains, expiry, duplicate rejection,
round caps). A record that was rejected live is rejected identically on
replay; statuses are not errors, they are the log converging to the same
observable state the live engine had.

Torn-tail rule (ARIES-style): the scan accepts records up to the first bad
frame — short header, bad length, truncated body, or CRC mismatch — and
ignores everything after it. A torn tail can only exist in the ACTIVE
(last) segment of a clean history (sealed segments are fsynced at
rotation); if an EARLIER segment is torn, every later segment is
unreachable-after-corruption and replay stops there too, reporting the
dropped segments in the scan result rather than replaying around a hole
(log order is the correctness invariant — skipping a gap could replay a
vote before its proposal).

A copy of the JAX package's ``wal/recovery.py``. What that package counts
through its tracer is read here from :class:`ReplayStats`
(``records_applied``, ``torn_bytes``, ``segments_dropped``, ``errors``). A
record kind whose engine entry point the port does not have yet (the tier
lifecycle's ``KIND_LIFECYCLE`` and ``KIND_GC``) raises
:class:`UnsupportedRecord`: recovery that skipped it would silently drop
acknowledged state.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..errors import ConsensusError
from ..wire import Proposal, Vote
from . import format as F
from .segment import list_segments, scan_segment


class UnsupportedRecord(RuntimeError):
    """A WAL record the engine has no entry point to apply. Replay stops
    here instead of skipping it: a skipped record is acknowledged state
    lost without a trace."""


@dataclass
class WalScan:
    """Result of scanning a WAL directory (no engine involved)."""

    records: list  # [(lsn, kind, payload)] in log order
    last_lsn: int = 0
    watermark: int = 0  # max snapshot mark seen (0 = no snapshot)
    torn_path: str | None = None  # segment holding the first bad frame
    torn_bytes: int = 0  # bytes ignored after the first bad frame
    segments_dropped: int = 0  # later segments unreachable past a torn one

    @property
    def torn(self) -> bool:
        return self.torn_path is not None


@dataclass
class ReplayStats:
    """Result of replaying a scan into an engine."""

    records_total: int = 0  # records seen (incl. snapshot marks)
    records_applied: int = 0  # records dispatched into the engine
    records_skipped: int = 0  # covered by the watermark (snapshot holds them)
    votes_replayed: int = 0  # individual vote rows across all records
    proposals_replayed: int = 0
    last_lsn: int = 0
    watermark: int = 0
    errors: list = field(default_factory=list)  # (lsn, repr(exc)) decode faults
    # Torn-tail diagnostics, mirrored from the scan so recover() callers see
    # them without a separate scan: torn_path is the segment holding the
    # first bad frame; segments_dropped counts LATER segments that were
    # unreachable past it (nonzero = mid-log corruption, not a crash tail —
    # acknowledged records were lost and the embedder should be told).
    torn_path: "str | None" = None
    torn_bytes: int = 0
    segments_dropped: int = 0

    @property
    def torn(self) -> bool:
        return self.torn_path is not None


def _iter_intact(directory: str, meta: WalScan):
    """Yield each segment's intact records (one list per segment, so the
    caller holds at most one segment in memory), applying the torn-tail
    rule — stop after the first torn segment — and filling ``meta``'s
    torn/last_lsn/watermark fields as a side effect."""
    segments = list_segments(directory)
    for i, (_base, path) in enumerate(segments):
        records, valid_end, size = scan_segment(path)
        for lsn, kind, payload in records:
            if kind == F.KIND_SNAPSHOT:
                mark = F.decode_snapshot(payload)
                if mark > meta.watermark:
                    meta.watermark = mark
        if records:
            meta.last_lsn = records[-1][0]
        yield records
        if valid_end < size:
            meta.torn_path = path
            meta.torn_bytes = size - valid_end
            meta.segments_dropped = len(segments) - i - 1
            return


def scan(directory: str) -> WalScan:
    """Read every intact record in LSN order, applying the torn-tail rule.

    Materializes the whole surviving log; for replay of large logs prefer
    passing the directory path straight to :func:`replay`, which streams
    one segment at a time (the snapshot watermark is found on a cheap
    first pass, so covered records are decoded but never retained)."""
    result = WalScan(records=[])
    for records in _iter_intact(directory, result):
        result.records.extend(records)
    return result


def replay(
    source: "str | WalScan",
    engine,
    *,
    after_lsn: "int | None" = 0,
    on_record=None,
) -> ReplayStats:
    """Replay a WAL (directory path or a prior :func:`scan`) into ``engine``.

    ``after_lsn`` skips records the caller has already restored by other
    means — pass the snapshot watermark after ``load_from_storage``, or
    ``None`` to use the log's own latest watermark (that is what
    :meth:`DurableEngine.recover` does); the default ``0`` replays every
    surviving record into a fresh engine.

    A directory-path ``source`` is streamed one segment at a time, so
    recovery memory is bounded by a single segment, not the log
    (``after_lsn=None`` costs one extra metadata pass over the files to
    find the watermark first). A :class:`WalScan` source replays the
    already-materialized records.

    The engine will emit events for replayed transitions exactly as live
    traffic would; attach/subscribe the event bus AFTER recovery unless the
    embedder wants the replayed stream.

    ``on_record(lsn, kind)`` (optional) is invoked before each surviving
    record is applied — replay progress observation for long logs (a
    fleet supervisor reporting a recovering shard's position, or a test
    holding a replay mid-flight to assert other shards keep serving).
    Exceptions from the callback abort the replay.
    """
    log_watermark = 0  # marks the probe saw beyond forward-reachable ones
    if isinstance(source, str):
        if after_lsn is None:
            after_lsn = log_watermark = latest_watermark(source)
        meta = WalScan(records=[])
        stats = ReplayStats()
        for records in _iter_intact(source, meta):
            for lsn, kind, payload in records:
                if on_record is not None:
                    on_record(lsn, kind)
                _replay_record(engine, lsn, kind, payload, after_lsn, stats)
    else:
        meta = source
        if after_lsn is None:
            after_lsn = meta.watermark
        stats = ReplayStats()
        for lsn, kind, payload in meta.records:
            if on_record is not None:
                on_record(lsn, kind)
            _replay_record(engine, lsn, kind, payload, after_lsn, stats)
    stats.last_lsn = meta.last_lsn
    stats.watermark = max(meta.watermark, log_watermark)
    stats.torn_path = meta.torn_path
    stats.torn_bytes = meta.torn_bytes
    stats.segments_dropped = meta.segments_dropped
    return stats


def latest_watermark(directory: str) -> int:
    """Find the most recent snapshot watermark by scanning segments
    NEWEST-first and stopping at the first one holding a snapshot record —
    for a checkpointing node that is the active (or last sealed) segment,
    so recovery's watermark probe reads one or two files, not the log.

    A watermark found past a torn mid-log segment (which forward replay
    would drop) is still safe to honor: the snapshot covers every record
    ``lsn <= watermark`` regardless of whether the log bytes carrying the
    mark are forward-reachable."""
    for _base, path in reversed(list_segments(directory)):
        records, _, _ = scan_segment(path)
        marks = [
            F.decode_snapshot(payload)
            for _lsn, kind, payload in records
            if kind == F.KIND_SNAPSHOT
        ]
        if marks:
            return max(marks)
    return 0


def _replay_record(engine, lsn, kind, payload, after_lsn, stats) -> None:
    stats.records_total += 1
    if kind == F.KIND_SNAPSHOT:
        return  # bookkeeping, not state
    if lsn <= after_lsn:
        stats.records_skipped += 1
        return
    apply_record(engine, kind, payload, stats, lsn=lsn)


def apply_record(
    engine, kind: int, payload: bytes, stats: "ReplayStats | None" = None,
    *, lsn: int = 0,
) -> ReplayStats:
    """Dispatch ONE decoded WAL record through the engine's live batch
    entry points — the unit step of :func:`replay`, public so other
    consumers of the record stream (a state-sync tail) apply records with identical
    semantics: validation runs exactly as live traffic, rejections settle
    as converged state, payload decode faults land in ``stats.errors``.
    Snapshot marks are bookkeeping and apply nothing."""
    if stats is None:
        stats = ReplayStats()
    if kind == F.KIND_SNAPSHOT:
        return stats
    try:
        _apply(engine, kind, payload, stats)
    except ConsensusError:
        # Scalar entry points raise on rejection (process_incoming_vote
        # style); the live call raised the same way — state converged.
        pass
    except ValueError as exc:
        # Payload decode fault inside a CRC-valid record: surface it,
        # keep replaying (the frame layer guarantees record boundaries).
        stats.errors.append((lsn, repr(exc)))
        return stats
    stats.records_applied += 1
    return stats


def read_tail(
    directory: str,
    after_lsn: int = 0,
    max_bytes: int = 4 * 1024 * 1024,
) -> "tuple[list[tuple[int, int, bytes]], bool]":
    """Read intact records with ``lsn > after_lsn`` in log order, bounded
    by ``max_bytes`` of payload — the serving side of WAL tailing
    (``OP_WAL_TAIL``). Returns ``(records, more)``: ``more`` is True when
    the budget stopped the read with further intact records available, so
    a caller loops with ``after_lsn`` advanced to the last served LSN
    until ``(few records, False)``.

    Sealed segments entirely below ``after_lsn`` are skipped by filename
    (their base LSNs bound their contents), so repeated tail polls on a
    long log do not rescan history. The torn-tail rule applies: records
    past the first bad frame are not served (a concurrent writer's
    in-flight append parses as a torn tail and is simply served on the
    next poll). LSN continuity of the result is the CLIENT's check —
    a gap here means compaction or mid-log corruption ate part of the
    suffix, and applying around it would reorder history."""
    records: list[tuple[int, int, bytes]] = []
    used = 0
    segments = list_segments(directory)
    for i, (base, path) in enumerate(segments):
        if i + 1 < len(segments) and segments[i + 1][0] - 1 <= after_lsn:
            continue  # sealed segment fully at or below the watermark
        seg_records, valid_end, size = scan_segment(path)
        for lsn, kind, payload in seg_records:
            if lsn <= after_lsn:
                continue
            if records and used + len(payload) > max_bytes:
                return records, True
            records.append((lsn, kind, payload))
            used += len(payload)
        if valid_end < size:
            break  # torn: later segments are unreachable-after-corruption
    return records, False


def _replay_columnar(engine, now, scopes, scope_idx, blob, offsets) -> None:
    """Re-apply a columnar record through the pre-validated columnar
    ingest, re-deriving gids from the wire bytes (fresh interning)."""
    votes = [
        Vote.decode(blob[offsets[i] : offsets[i + 1]])
        for i in range(len(offsets) - 1)
    ]
    pids = np.fromiter((v.proposal_id for v in votes), np.int64, len(votes))
    gids = np.fromiter(
        (engine.voter_gid(v.vote_owner) for v in votes), np.int64, len(votes)
    )
    values = np.fromiter((v.vote for v in votes), bool, len(votes))
    if len(scopes) > 1:
        engine.ingest_columnar_multi(
            scopes, scope_idx, pids, gids, values, now,
            wire_votes=(blob, offsets),
        )
    else:
        engine.ingest_columnar(
            scopes[0], pids, gids, values, now, wire_votes=(blob, offsets)
        )


def _apply(engine, kind: int, payload: bytes, stats: ReplayStats) -> None:
    if kind == F.KIND_PROPOSALS:
        now, items = F.decode_proposals(payload)
        decoded = [(scope, Proposal.decode(wire)) for scope, wire, _ in items]
        configs = [config for _, _, config in items]
        engine.ingest_proposals(decoded, now, configs=configs)
        stats.proposals_replayed += len(decoded)
    elif kind == F.KIND_DELIVER:
        # Same payload as KIND_PROPOSALS, different entry point: the
        # create-or-extend path is deterministic given engine state, so
        # replay re-derives the live run's exact suffix applications.
        now, items = F.decode_proposals(payload)
        decoded = [(scope, Proposal.decode(wire)) for scope, wire, _ in items]
        configs = [config for _, _, config in items]
        engine.deliver_proposals(decoded, now, configs=configs)
        stats.proposals_replayed += len(decoded)
    elif kind == F.KIND_VOTES:
        now, pre_validated, items = F.decode_votes(payload)
        decoded = [(scope, Vote.decode(wire)) for scope, wire in items]
        engine.ingest_votes(decoded, now, pre_validated=pre_validated)
        stats.votes_replayed += len(decoded)
    elif kind == F.KIND_COLUMNAR:
        now, scopes, scope_idx, blob, offsets = F.decode_columnar(payload)
        _replay_columnar(engine, now, scopes, scope_idx, blob, offsets)
        stats.votes_replayed += len(offsets) - 1
    elif kind == F.KIND_WIRE_COLUMNAR:
        # Same payload as KIND_COLUMNAR, replayed through the WIRE path:
        # the live call retained its chains wire-validated, so replay
        # must too — routing through plain columnar ingest would demote
        # ``wire_only`` and the recovered peer would silently drop the
        # cross-frame dangling-vote guard its non-crashed twins keep
        # (see format.KIND_WIRE_COLUMNAR). Only accepted rows were
        # logged, so crypto is skipped: a trusted prepass marks every
        # row verified — the KIND_COLUMNAR replay trust model, same WAL.
        from ..bridge import columnar as C
        from ..engine.engine import WireVotePrepass

        now, scopes, scope_idx, blob, offsets = F.decode_columnar(payload)
        offs = np.asarray(offsets, np.int64)
        n = len(offs) - 1
        cols, flags = C.parse_vote_columns(blob, offs)
        if bool(flags.all()) and hasattr(engine, "ingest_wire_columnar"):
            trusted = WireVotePrepass(
                np.zeros(n, np.int32),
                np.zeros(0, np.int64),
                lambda: [],
                buf=bytes(blob),
            )
            engine.ingest_wire_columnar(
                scopes,
                scope_idx if scope_idx is not None else np.zeros(n, np.int64),
                cols,
                np.frombuffer(blob, np.uint8),
                offs,
                now,
                _prepass=trusted,
            )
        else:  # pragma: no cover — live rows were canonical by construction
            _replay_columnar(engine, now, scopes, scope_idx, blob, offsets)
        stats.votes_replayed += n
    elif kind == F.KIND_SCOPE_CONFIG:
        mode, scope, config = F.decode_scope_config_record(payload)
        if mode == F.SCOPE_CONFIG_INITIALIZE:
            engine._initialize_scope(scope, config)
        elif mode == F.SCOPE_CONFIG_UPDATE:
            engine._update_scope_config(scope, config)
        else:
            engine.set_scope_config(scope, config)
    elif kind == F.KIND_SCOPE_DELETE:
        engine.delete_scopes(F.decode_scope_delete(payload))
    elif kind == F.KIND_TIMEOUT:
        scope, pid, now = F.decode_timeout(payload)
        engine.handle_consensus_timeout(scope, pid, now)
    elif kind == F.KIND_SWEEP:
        engine.sweep_timeouts(F.decode_sweep(payload))
    elif kind == F.KIND_LIFECYCLE:
        # Standalone tier sweep. Under recovery's replay mode the
        # engine's lifecycle hook is a no-op — the live run's TTL GC
        # arrives as the following KIND_GC record — so this replays the
        # call for engines replaying OUTSIDE replay mode (direct
        # replay() use, where live-path clock reconstruction makes the
        # policy re-derivable) and is otherwise inert.
        _entry_point(engine, kind, "lifecycle_sweep")(F.decode_sweep(payload))
    elif kind == F.KIND_GC:
        # The live sweep's exact TTL-GC outcome (see format.KIND_GC):
        # applied verbatim, idempotent for keys a re-derived sweep
        # already collected.
        _entry_point(engine, kind, "gc_sessions")(F.decode_gc(payload))
    else:
        raise ValueError(f"unknown WAL record kind {kind}")


def _entry_point(engine, kind: int, name: str):
    """The engine method a record kind replays through, or
    :class:`UnsupportedRecord` when the engine has none."""
    method = getattr(engine, name, None)
    if method is None:
        raise UnsupportedRecord(
            f"WAL record kind {kind} ({F.KIND_NAMES[kind]}) needs "
            f"{type(engine).__name__}.{name}, which this engine does not "
            f"have: recovery stops instead of dropping the record"
        )
    return method
