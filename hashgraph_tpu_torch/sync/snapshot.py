"""Canonical chunked snapshot wire format for state sync.

A snapshot is the byte-serialized form of an engine's full tracked state —
every session (as the exact canonical proposal/vote wire bytes the
signatures cover, plus the scalar lifecycle fields the wire does not
carry) and every scope config — captured at a WAL LSN *watermark*: the
state contains exactly the effects of records with ``lsn <= watermark``,
so a joiner that installs it and then applies the WAL suffix after the
watermark converges to the source's state (the ARIES / Raft
InstallSnapshot recipe).

Layout: a flat stream of CRC-framed items, byte-split into fixed-size
chunks for transfer (chunk boundaries are arbitrary byte offsets — the
frame parser is incremental, so a multi-GB snapshot never materializes in
one buffer on either side)::

    frame := u32 body_len | u32 crc32(body) | body
    body  := u8 item_kind | payload

    ITEM_HEADER        MAGIC(8) | u32 version | u64 watermark
    ITEM_SESSION       scope | u8 state | u8 result | u64 created_at |
                       consensus_config | u32 n_tallies |
                       n × (blob owner | u8 value) | blob proposal_wire
    ITEM_SCOPE_CONFIG  scope | scope_config
    ITEM_END           u32 session_count | u32 config_count

Scope / config codecs are the WAL's (:mod:`..wal.format`):
one canonical cross-process encoding per concept, not two. The embedded
``proposal_wire`` is the prost-compatible protobuf encoding carrying the
full vote chain — the same bytes the votes' signatures cover, which is
what lets a joiner verify the whole snapshot cryptographically before
trusting it.

A copy of the JAX package's ``sync/snapshot.py``: the engine's session
tier stores :func:`encode_session_item` bytes, so both packages must write
the same bytes for the same session.
"""

from __future__ import annotations

import hashlib
import os
import struct
import zlib
from dataclasses import dataclass

from ..session import ConsensusSession, ConsensusState, ConsensusStateKind
from ..wal import format as F
from ..wire import Proposal
from .errors import SnapshotDecodeError

MAGIC = b"HGSYNC01"
VERSION = 1

ITEM_HEADER = 1
ITEM_SESSION = 2
ITEM_SCOPE_CONFIG = 3
ITEM_END = 4

_HEADER = struct.Struct("<II")  # body_len | crc32
HEADER_BYTES = _HEADER.size
# Hard cap against garbage length prefixes (the WAL / bridge rationale).
MAX_FRAME = 64 * 1024 * 1024

DEFAULT_CHUNK_BYTES = 4 * 1024 * 1024

_STATE_CODE = {
    ConsensusStateKind.ACTIVE: 0,
    ConsensusStateKind.CONSENSUS_REACHED: 1,
    ConsensusStateKind.FAILED: 2,
}


def _u8(v: int) -> bytes:
    return struct.pack("<B", v)


def _u32(v: int) -> bytes:
    return struct.pack("<I", v)


def _u64(v: int) -> bytes:
    return struct.pack("<Q", v)


def _blob(b: bytes) -> bytes:
    return _u32(len(b)) + bytes(b)


@dataclass(frozen=True)
class SnapshotManifest:
    """What a joiner needs BEFORE transferring a snapshot: identity,
    integrity, and resume geometry. ``snapshot_id`` identifies one BUILD
    artifact — the exact (file bytes, chunk geometry) pair chunks are
    served from; it defaults to the watermark, but a server that can
    rebuild (new watermark, or a different requested chunk size over the
    same state) must mint a fresh unique id per build so a client holding
    a stale manifest gets a typed stale signal instead of chunks read at
    the wrong offsets. ``digests`` are per-chunk SHA-256 over the raw
    chunk bytes, verified as each chunk arrives so a corrupt transfer is
    caught per-chunk, not after gigabytes."""

    snapshot_id: int
    watermark: int
    total_bytes: int
    chunk_bytes: int
    session_count: int
    config_count: int
    digests: "tuple[bytes, ...]"

    @property
    def chunk_count(self) -> int:
        return len(self.digests)

    def chunk_size(self, index: int) -> int:
        if index < 0 or index >= len(self.digests):
            raise IndexError(f"chunk {index} out of range")
        if index < len(self.digests) - 1:
            return self.chunk_bytes
        return self.total_bytes - self.chunk_bytes * (len(self.digests) - 1)


# ── Frame + item codecs ────────────────────────────────────────────────


def encode_frame(item_kind: int, payload: bytes) -> bytes:
    body = _u8(item_kind) + payload
    return _HEADER.pack(len(body), zlib.crc32(body)) + body


# C-level packers for the bulk path (byte-identical to _u8/_u64/_u32
# sequences: little-endian "<" structs never pad).
_SRC_PACK = struct.Struct("<BBQ").pack  # state | result | created_at
_U32_PACK = struct.Struct("<I").pack


def encode_session_fields(
    scope_bytes: bytes,
    state: int,
    result: bool,
    created_at: int,
    config_bytes: bytes,
    tallies,
    proposal_wire: bytes,
) -> bytes:
    """ITEM_SESSION payload from pre-resolved components — the layout
    :func:`encode_session_item` delegates to. Callers that already hold
    the canonical pieces (the engine's bulk demotion path: per-call
    memoized scope/config encodes, tallies straight off the device row,
    the live proposal's wire bytes) skip materializing a scalar
    ConsensusSession per item; byte-identity with the session-object
    path is pinned by the tier fingerprint property suite."""
    out = [
        scope_bytes,
        _SRC_PACK(state, 1 if result else 0, created_at),
        config_bytes,
        _U32_PACK(len(tallies)),
    ]
    append = out.append
    for owner, value in tallies.items():
        append(_U32_PACK(len(owner)))
        append(bytes(owner))
        append(b"\x01" if value else b"\x00")
    append(_U32_PACK(len(proposal_wire)))
    append(proposal_wire)
    return b"".join(out)


def encode_session_item(scope, session: ConsensusSession) -> bytes:
    return encode_session_fields(
        F.encode_scope(scope),
        _STATE_CODE[session.state.kind],
        bool(session.state.result),
        session.created_at,
        F.encode_consensus_config(session.config),
        session.tallies,
        session.proposal.encode(),
    )


def decode_session_item(payload: bytes) -> "tuple[object, ConsensusSession]":
    r = F.Reader(payload)
    scope = F.decode_scope(r)
    state_code = r.u8()
    result = bool(r.u8())
    created_at = r.u64()
    config = F.decode_consensus_config(r)
    tallies = {}
    for _ in range(r.u32()):
        owner = r.blob()
        tallies[owner] = bool(r.u8())
    proposal = Proposal.decode(r.blob())
    if state_code == 0:
        state = ConsensusState.active()
    elif state_code == 1:
        state = ConsensusState.reached(result)
    elif state_code == 2:
        state = ConsensusState.failed()
    else:
        raise ValueError(f"unknown session state code {state_code}")
    # ``votes`` is derived state: one vote per owner, and the proposal's
    # embedded chain is the canonical (signed) record of exactly those
    # votes — the scalar session maintains the two in lockstep.
    votes = {v.vote_owner: v for v in proposal.votes}
    session = ConsensusSession(
        proposal=proposal,
        state=state,
        votes=votes,
        created_at=created_at,
        config=config,
        tallies=tallies,
    )
    return scope, session


def encode_scope_config_item(scope, config) -> bytes:
    return F.encode_scope(scope) + F.encode_scope_config(config)


def decode_scope_config_item(payload: bytes):
    r = F.Reader(payload)
    return F.decode_scope(r), F.decode_scope_config(r)


# ── Building (source side) ─────────────────────────────────────────────


class _SnapshotSink:
    """ConsensusStorage-shaped collector framing sessions/configs straight
    to a byte sink. Only the two methods ``save_to_storage`` drives exist:
    the engine streams one materialized session at a time through
    ``save_session``, so the build holds one session in memory, never the
    whole state."""

    def __init__(self, write):
        self._write = write
        self.sessions = 0
        self.configs = 0

    def save_session(self, scope, session) -> None:
        self._write(encode_frame(ITEM_SESSION, encode_session_item(scope, session)))
        self.sessions += 1

    def set_scope_config(self, scope, config) -> None:
        self._write(
            encode_frame(ITEM_SCOPE_CONFIG, encode_scope_config_item(scope, config))
        )
        self.configs += 1


def build_snapshot(
    engine,
    path: str,
    *,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    snapshot_id: "int | None" = None,
) -> SnapshotManifest:
    """Serialize ``engine``'s tracked state to ``path`` and return the
    manifest. A :class:`~..wal.DurableEngine` is captured
    under its mutator lock via ``capture_consistent``, so the file's
    watermark is exactly consistent with its contents (mutators stall for
    the duration of the capture — the price of a consistent cut); a bare
    engine snapshots with watermark 0 (no WAL position to tail from).

    The file is written to ``path + ".tmp"`` and renamed into place, so a
    crashed build never leaves a half-snapshot under the served name.
    Chunk digests are computed in a second streaming pass over the file.
    """
    if chunk_bytes <= 0 or chunk_bytes > MAX_FRAME:
        raise ValueError(f"chunk_bytes must be in (0, {MAX_FRAME}]")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    info: dict = {}
    with open(tmp, "wb") as fh:
        def run(inner, watermark: int) -> None:
            fh.write(
                encode_frame(
                    ITEM_HEADER, MAGIC + _u32(VERSION) + _u64(watermark)
                )
            )
            sink = _SnapshotSink(fh.write)
            inner.save_to_storage(sink)
            fh.write(
                encode_frame(ITEM_END, _u32(sink.sessions) + _u32(sink.configs))
            )
            info.update(
                watermark=watermark,
                sessions=sink.sessions,
                configs=sink.configs,
            )

        capture = getattr(engine, "capture_consistent", None)
        if capture is not None:
            capture(run)
        else:
            run(engine, 0)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    digests: list[bytes] = []
    total = 0
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk_bytes)
            if not block:
                break
            digests.append(hashlib.sha256(block).digest())
            total += len(block)
    return SnapshotManifest(
        snapshot_id=(
            info["watermark"] if snapshot_id is None else snapshot_id
        ),
        watermark=info["watermark"],
        total_bytes=total,
        chunk_bytes=chunk_bytes,
        session_count=info["sessions"],
        config_count=info["configs"],
        digests=tuple(digests),
    )


# ── Parsing (joiner side) ──────────────────────────────────────────────


def iter_snapshot_frames(chunks):
    """Yield ``(item_kind, payload)`` from an iterable of byte blocks with
    ARBITRARY boundaries (transfer chunks). Incremental: memory is bounded
    by one frame plus one chunk, not the snapshot. Raises
    :class:`SnapshotDecodeError` on any malformed frame — unlike the WAL's
    torn-tail tolerance, a snapshot is a complete artifact whose length
    and digests the manifest pinned, so truncation IS corruption."""
    buf = bytearray()
    pos = 0
    for chunk in chunks:
        buf += chunk
        while True:
            if len(buf) - pos < HEADER_BYTES:
                break
            body_len, crc = _HEADER.unpack_from(buf, pos)
            if body_len < 1 or body_len > MAX_FRAME:
                raise SnapshotDecodeError(
                    f"snapshot frame with invalid body length {body_len}"
                )
            end = pos + HEADER_BYTES + body_len
            if end > len(buf):
                break
            body = bytes(buf[pos + HEADER_BYTES : end])
            if zlib.crc32(body) != crc:
                raise SnapshotDecodeError("snapshot frame CRC mismatch")
            yield body[0], body[1:]
            pos = end
        if pos:
            del buf[:pos]
            pos = 0
    if len(buf) - pos:
        raise SnapshotDecodeError(
            f"snapshot stream ends with {len(buf) - pos} trailing bytes "
            "inside an incomplete frame"
        )


def decode_snapshot(chunks):
    """Parse a full snapshot byte stream into ``(watermark, sessions,
    configs)`` where sessions are ``(scope, ConsensusSession)`` and
    configs are ``(scope, ScopeConfig)``. Validates the header
    magic/version, the trailer's item counts, and every frame's CRC."""
    watermark = None
    sessions: list = []
    configs: list = []
    ended = False
    for item, payload in iter_snapshot_frames(chunks):
        if ended:
            raise SnapshotDecodeError("snapshot frames after the END trailer")
        if watermark is None:
            if item != ITEM_HEADER:
                raise SnapshotDecodeError("snapshot does not start with a header")
            r = F.Reader(payload)
            magic = r.raw(len(MAGIC))
            if magic != MAGIC:
                raise SnapshotDecodeError(f"bad snapshot magic {magic!r}")
            version = r.u32()
            if version != VERSION:
                raise SnapshotDecodeError(f"unsupported snapshot version {version}")
            watermark = r.u64()
            continue
        try:
            if item == ITEM_SESSION:
                sessions.append(decode_session_item(payload))
            elif item == ITEM_SCOPE_CONFIG:
                configs.append(decode_scope_config_item(payload))
            elif item == ITEM_END:
                r = F.Reader(payload)
                want_sessions, want_configs = r.u32(), r.u32()
                if want_sessions != len(sessions) or want_configs != len(configs):
                    raise SnapshotDecodeError(
                        f"snapshot trailer claims {want_sessions} sessions / "
                        f"{want_configs} configs, stream carried "
                        f"{len(sessions)} / {len(configs)}"
                    )
                ended = True
            else:
                raise SnapshotDecodeError(f"unknown snapshot item kind {item}")
        except ValueError as exc:
            raise SnapshotDecodeError(
                f"snapshot item payload undecodable: {exc}"
            ) from exc
    if watermark is None:
        raise SnapshotDecodeError("empty snapshot stream")
    if not ended:
        raise SnapshotDecodeError("snapshot stream missing the END trailer")
    return watermark, sessions, configs


# ── State equality ─────────────────────────────────────────────────────


def state_fingerprint(engine) -> str:
    """Order-insensitive content digest of an engine's full tracked state
    (sessions + scope configs), built from the same canonical item frames
    the snapshot ships. Two engines fingerprint equal iff their
    ``save_to_storage`` dumps carry byte-identical session/config items —
    the acceptance criterion for catch-up convergence. DurableEngine
    wrappers are unwrapped first (the wrapper's own ``save_to_storage``
    appends a checkpoint mark; a read-only fingerprint must not)."""
    target = getattr(engine, "engine", engine)
    frames: list[bytes] = []
    target.save_to_storage(_SnapshotSink(frames.append))
    item_digests = sorted(hashlib.sha256(f).digest() for f in frames)
    return hashlib.sha256(b"".join(item_digests)).hexdigest()
