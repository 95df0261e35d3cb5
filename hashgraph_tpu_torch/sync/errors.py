"""Typed state-sync failures (a copy of ``hashgraph_tpu/sync/errors.py``).

Every failure mode of the catch-up path gets its own type so embedders can
route them: a digest mismatch is a corrupt/hostile source (retry another
peer), a verification failure is a hostile snapshot (never install), a
tail gap is a source whose log no longer covers the requested suffix
(refresh the manifest and re-snapshot), and a state error is a caller bug
(catch-up targets a fresh engine). All of them guarantee NO PARTIAL
INSTALL: the joiner engine is untouched unless the whole snapshot
verified and decoded.
"""

from __future__ import annotations


class SyncError(RuntimeError):
    """Base class for state-sync failures."""


class SnapshotDecodeError(SyncError):
    """Snapshot byte stream is malformed (bad magic/version, truncated or
    CRC-invalid frame, item counts disagreeing with the trailer)."""


class SnapshotDigestError(SyncError):
    """A received chunk's bytes do not match the manifest's digest — the
    transfer was corrupted or the source is serving hostile bytes. Nothing
    was installed; re-request the chunk or pick another source."""


class SyncVerificationError(SyncError):
    """The snapshot's signed vote chains failed verification (bad
    signature, wrong vote hash, broken chain link, proposal-id mismatch).
    Nothing was installed. ``trust_snapshot=True`` bypasses this check for
    operator-trusted sources."""


class TailGapError(SyncError):
    """The served WAL tail is not contiguous with the requested position:
    the source compacted past the snapshot watermark (re-fetch a fresh
    manifest) or lost records to mid-log corruption. Applying around a gap
    could replay a vote before its proposal, so the catch-up refuses."""

    def __init__(self, expected_lsn: int, got_lsn: int):
        super().__init__(
            f"WAL tail gap: expected lsn {expected_lsn}, source served "
            f"{got_lsn} — the log no longer covers the requested suffix "
            f"(compacted past the watermark, or mid-log corruption)"
        )
        self.expected_lsn = expected_lsn
        self.got_lsn = got_lsn


class TailRecordError(SyncError):
    """A served WAL tail record's payload failed to decode. Local crash
    recovery tolerates this (it surfaces the fault in ReplayStats and
    keeps replaying — the frame layer guarantees record boundaries), but
    a remote catch-up must not: a joiner that silently skips a record
    diverges from the source, so the sync path fails typed instead."""


class SyncStateError(SyncError):
    """The joiner engine is not in a state catch-up supports (e.g. it
    already tracks sessions and no snapshot was installed through this
    catch-up state — a snapshot install must target a fresh engine)."""


class SyncTimeoutError(SyncError):
    """A catch-up network operation (manifest, chunk, or tail request)
    exceeded the client's wall-clock timeout — the source stalled
    mid-transfer. Distinct from a dead connection (``ConnectionError``):
    the socket is up but the peer stopped answering, so a joiner thread
    must not hang on it forever. Progress already verified stays in the
    ``CatchUpState`` of the catch-up client; hand it to a fresh client
    (same or different source) to resume."""

    def __init__(self, operation: str, timeout: float):
        super().__init__(
            f"state-sync {operation} timed out after {timeout:g}s — the "
            f"source stalled; resume with the same CatchUpState on a "
            f"fresh client or pick another source"
        )
        self.operation = operation
        self.timeout = timeout
