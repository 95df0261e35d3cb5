"""hashgraph_tpu_torch.sync — state sync: snapshot shipping + WAL tailing.

A snapshot is an engine's tracked state as CRC-framed items — every
session as its canonical proposal/vote wire bytes plus the lifecycle
fields the wire does not carry, and every scope config — at a WAL LSN
watermark (:mod:`.snapshot`). The engine's session tier stores exactly
these session items, and :func:`state_fingerprint` hashes them, so a
session hashes the same whether it is live or demoted.

The joiner (:class:`.client.CatchUpClient`) downloads a snapshot from a
peer's bridge server (``OP_SYNC_MANIFEST``/``OP_SYNC_CHUNK``), verifies
its signed vote chains in one batched pass (:func:`verify_sessions`: with
``Ed25519DeviceConsensusSigner`` that is one device batch through the
MSM kernels), installs it atomically, then tails and applies only the WAL
records past the watermark (``OP_WAL_TAIL``) through the engine's live
entry points.

Port of the JAX package's ``sync/``, held byte for byte against it: both
packages' clients install from both packages' servers.
"""

from .client import CatchUpClient, CatchUpReport, CatchUpState, verify_sessions
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
    "CatchUpClient",
    "CatchUpReport",
    "CatchUpState",
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
    "verify_sessions",
]
