"""hashgraph_tpu_torch.sync — the state-sync snapshot codec.

A snapshot is an engine's tracked state as CRC-framed items — every
session as its canonical proposal/vote wire bytes plus the lifecycle
fields the wire does not carry, and every scope config — at a WAL LSN
watermark (:mod:`.snapshot`). The engine's session tier stores exactly
these session items, and :func:`state_fingerprint` hashes them, so a
session hashes the same whether it is live or demoted.

Port of the JAX package's ``sync/`` without its catch-up client: the
``client`` module (``CatchUpClient``, ``CatchUpReport``, ``CatchUpState``,
``verify_sessions``) needs the bridge transport and is not ported yet.
"""

from .errors import (
    SnapshotDecodeError,
    SnapshotDigestError,
    SyncError,
    SyncStateError,
    SyncTimeoutError,
    SyncVerificationError,
    TailGapError,
    TailRecordError,
)
from .snapshot import (
    DEFAULT_CHUNK_BYTES,
    SnapshotManifest,
    build_snapshot,
    decode_snapshot,
    state_fingerprint,
)

__all__ = [
    "DEFAULT_CHUNK_BYTES",
    "SnapshotDecodeError",
    "SnapshotDigestError",
    "SnapshotManifest",
    "SyncError",
    "SyncStateError",
    "SyncTimeoutError",
    "SyncVerificationError",
    "TailGapError",
    "TailRecordError",
    "build_snapshot",
    "decode_snapshot",
    "state_fingerprint",
]
