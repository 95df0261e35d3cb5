"""WAL record framing and payload codecs.

One record is one durable unit, framed as (all integers little-endian)::

    u32 body_len | u32 crc32 | body
    body = u64 lsn | u8 kind | payload

``body_len`` counts the body (lsn + kind + payload, so ``9 + len(payload)``);
``crc32`` is :func:`zlib.crc32` over the body. A reader accepts a record only
when the full frame is present AND the CRC matches, so a torn tail — a crash
mid-``write(2)``, a short frame, or garbage after a partially-flushed page —
is detected at the first bad frame and everything before it stays usable.
This is the classic ARIES/Raft log-framing discipline; see
:mod:`.recovery` for the truncate-at-first-bad-frame rule.

Payloads reuse the framework's canonical byte encodings: ``Proposal`` /
``Vote`` records embed the exact prost-compatible wire bytes of
:mod:`..wire` (no second serialization format — the bytes that
were validated/signed are the bytes that are logged), and scopes use the
same canonical str/bytes/int encoding the multi-host control plane requires
(engine._canonical_scope_bytes rationale: arbitrary ``repr`` is not stable
across processes, and a WAL must be readable by a different process than
the one that wrote it).

A copy of the JAX package's ``wal/format.py`` over the port's own
``ScopeConfig``, ``ConsensusConfig`` and wire codecs: the two packages
write and read the same bytes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..scope_config import NetworkType, ScopeConfig
from ..session import ConsensusConfig

# ── Record kinds ───────────────────────────────────────────────────────

KIND_PROPOSALS = 1  # batch of (scope, proposal wire bytes, optional config)
KIND_VOTES = 2  # batch of (scope, vote wire bytes) + pre_validated flag
KIND_COLUMNAR = 3  # columnar vote batch: scopes + packed wire bytes
KIND_SCOPE_CONFIG = 4  # scope config set/initialize/update
KIND_SCOPE_DELETE = 5  # batch of scopes dropped
KIND_TIMEOUT = 6  # app-driven per-session timeout decision
KIND_SWEEP = 7  # engine-level timeout sweep
KIND_SNAPSHOT = 8  # snapshot watermark: records with lsn <= mark are covered
# Gossip create-or-extend delivery (engine.deliver_proposals). Payload is
# the KIND_PROPOSALS encoding verbatim; the kind byte alone routes replay
# through the watermark path, because the same proposal bytes mean
# different state transitions under deliver (extension applies a suffix)
# vs ingest (redelivery rejects) — replay must re-run the call that was
# acked, not a lookalike.
KIND_DELIVER = 9
# Wire-columnar ingest (engine.ingest_wire_columnar). Payload is the
# KIND_COLUMNAR encoding verbatim; the kind byte alone routes replay back
# through the wire path (crypto skipped — only accepted rows are logged),
# because the wire path RETAINS its chains wire-validated: replaying
# through plain columnar ingest would demote ``wire_only`` and a
# recovered peer would silently drop the cross-frame dangling-vote guard
# its non-crashed twins keep.
KIND_WIRE_COLUMNAR = 10
# Standalone engine.lifecycle_sweep call (tier demote/GC at the
# embedder's clock). Demotion alone would be replay-neutral (the tier is
# a cache), but the sweep's TTL GC is semantic — sessions past
# evict_decided_after cease to exist — so an unlogged sweep would let a
# crash resurrect sessions the live engine already dropped. Sweeps that
# ride sweep_timeouts are covered by KIND_SWEEP.
KIND_LIFECYCLE = 11
# TTL-GC OUTCOME of the immediately preceding KIND_SWEEP/KIND_LIFECYCLE
# record: the exact (scope, pid) set the live sweep collected. Logged
# after the apply, before the ack (the columnar discipline), because the
# GC decision depends on per-session idle clocks a SNAPSHOT restore does
# not carry (last_activity is deliberately absent from the fingerprinted
# session item — two converged peers with different local clocks must
# not fingerprint-diverge): re-deriving the TTL policy on replay over
# restored clocks could collect a different set than the live engine
# did. Replay therefore applies the logged outcome verbatim
# (engine.gc_sessions), while recovery's replay mode suppresses the
# re-derived lifecycle policy inside KIND_SWEEP/KIND_LIFECYCLE.
KIND_GC = 12

KIND_NAMES = {
    KIND_PROPOSALS: "proposals",
    KIND_VOTES: "votes",
    KIND_COLUMNAR: "columnar",
    KIND_SCOPE_CONFIG: "scope_config",
    KIND_SCOPE_DELETE: "scope_delete",
    KIND_TIMEOUT: "timeout",
    KIND_SWEEP: "sweep",
    KIND_SNAPSHOT: "snapshot",
    KIND_DELIVER: "deliver",
    KIND_WIRE_COLUMNAR: "wire_columnar",
    KIND_LIFECYCLE: "lifecycle",
    KIND_GC: "gc",
}

# Scope-config record modes (the engine has three distinct mutation
# semantics; replay must re-run the SAME one).
SCOPE_CONFIG_SET = 0
SCOPE_CONFIG_INITIALIZE = 1
SCOPE_CONFIG_UPDATE = 2

_HEADER = struct.Struct("<II")  # body_len | crc32
_BODY_LEAD = struct.Struct("<QB")  # lsn | kind
HEADER_BYTES = _HEADER.size
BODY_LEAD_BYTES = _BODY_LEAD.size

# Hard cap against garbage length prefixes (same rationale as the bridge's
# MAX_FRAME): a corrupt length must not trigger a giant allocation.
MAX_RECORD = 64 * 1024 * 1024


# ── Framing ────────────────────────────────────────────────────────────


def encode_record(lsn: int, kind: int, payload: bytes) -> bytes:
    """Frame one record. ``len(result)`` is the on-disk footprint."""
    body = _BODY_LEAD.pack(lsn, kind) + payload
    return _HEADER.pack(len(body), zlib.crc32(body)) + body


def scan_buffer(
    data: bytes, pos: int = 0
) -> tuple[list[tuple[int, int, bytes]], int]:
    """Parse consecutive records from ``data`` starting at ``pos``.

    Returns ``(records, valid_end)`` where records are ``(lsn, kind,
    payload)`` tuples and ``valid_end`` is the offset just past the last
    intact record. ``valid_end < len(data)`` means a torn tail: a short
    header, an out-of-range length, a truncated body, or a CRC mismatch.
    The scan never raises on malformed input — torn tails are an expected
    crash artifact, not an error.
    """
    records: list[tuple[int, int, bytes]] = []
    n = len(data)
    while True:
        if n - pos < HEADER_BYTES:
            return records, pos
        body_len, crc = _HEADER.unpack_from(data, pos)
        if body_len < BODY_LEAD_BYTES or body_len > MAX_RECORD:
            return records, pos
        end = pos + HEADER_BYTES + body_len
        if end > n:
            return records, pos
        body = data[pos + HEADER_BYTES : end]
        if zlib.crc32(body) != crc:
            return records, pos
        lsn, kind = _BODY_LEAD.unpack_from(body, 0)
        records.append((lsn, kind, body[BODY_LEAD_BYTES:]))
        pos = end


# ── Payload reader ─────────────────────────────────────────────────────


class Reader:
    """Sequential reader over one record's payload. Raises ValueError on
    overrun — a record that passed its CRC but fails payload decode is
    corruption beyond what framing can mask, and recovery surfaces it.

    Deliberately mirrors (not reuses) ``bridge/protocol.Cursor``: the
    durability layer must not depend on the bridge transport, and the two
    formats genuinely differ (u32 blob prefixes here vs u16 strings there,
    f64 fields here) — sharing the core would couple the WAL's on-disk
    layout to a network protocol that evolves on its own schedule."""

    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def _take(self, n: int) -> bytes:
        end = self._pos + n
        if end > len(self._data):
            raise ValueError("WAL payload truncated inside a CRC-valid record")
        out = self._data[self._pos : end]
        self._pos = end
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def blob(self) -> bytes:
        return self._take(self.u32())

    def raw(self, n: int) -> bytes:
        """``n`` raw bytes — fixed-width arrays whose length the caller
        derives from earlier fields (no length prefix of their own)."""
        return self._take(n)

    def done(self) -> bool:
        return self._pos == len(self._data)


def _u8(v: int) -> bytes:
    return struct.pack("<B", v)


def _u32(v: int) -> bytes:
    return struct.pack("<I", v)


def _u64(v: int) -> bytes:
    return struct.pack("<Q", v)


def _f64(v: float) -> bytes:
    return struct.pack("<d", v)


def _blob(b: bytes) -> bytes:
    return _u32(len(b)) + bytes(b)


# ── Scope codec ────────────────────────────────────────────────────────

_SCOPE_STR = 0x73  # 's'
_SCOPE_BYTES = 0x62  # 'b'
_SCOPE_INT = 0x69  # 'i'


def encode_scope(scope) -> bytes:
    """Canonical scope encoding — str/bytes/int only (same restriction and
    rationale as the engine's multi-host scope canonicalization: the WAL is
    read by a different process, so the encoding must be process-independent
    and round-trippable)."""
    if isinstance(scope, str):
        return _u8(_SCOPE_STR) + _blob(scope.encode("utf-8"))
    if isinstance(scope, (bytes, bytearray)):
        return _u8(_SCOPE_BYTES) + _blob(bytes(scope))
    if isinstance(scope, int):
        # int(scope) so bool encodes identically to the int it equals.
        return _u8(_SCOPE_INT) + _blob(str(int(scope)).encode())
    raise TypeError(
        f"durable logging requires str/bytes/int scopes (canonical "
        f"cross-process encoding); got {type(scope).__name__}"
    )


def decode_scope(r: Reader):
    tag = r.u8()
    raw = r.blob()
    if tag == _SCOPE_STR:
        return raw.decode("utf-8")
    if tag == _SCOPE_BYTES:
        return raw
    if tag == _SCOPE_INT:
        return int(raw.decode())
    raise ValueError(f"unknown scope tag {tag:#x}")


# ── Config codecs ──────────────────────────────────────────────────────

_NT_GOSSIPSUB = 0
_NT_P2P = 1


def encode_scope_config(config: ScopeConfig) -> bytes:
    override = config.max_rounds_override
    # Tier-TTL presence flags: absent TTLs encode as flag 0 + value 0.0 so
    # the layout stays fixed-width and canonical (fingerprints hash these
    # bytes — two equal configs must encode identically).
    tier_flags = (0 if config.demote_after is None else 1) | (
        0 if config.evict_decided_after is None else 2
    )
    # Adaptive-timeout bounds follow the same fixed-width presence-flag
    # pattern (bit 1 = timeout_min, bit 2 = timeout_max; validate() makes
    # them all-or-nothing, but the bits stay independent for symmetry).
    adaptive_flags = (0 if config.timeout_min is None else 1) | (
        0 if config.timeout_max is None else 2
    )
    return b"".join(
        (
            _u8(_NT_P2P if config.network_type == NetworkType.P2P else _NT_GOSSIPSUB),
            _f64(config.default_consensus_threshold),
            _f64(config.default_timeout),
            _u8(1 if config.default_liveness_criteria_yes else 0),
            _u8(0 if override is None else 1),
            _u32(override or 0),
            _u8(tier_flags),
            _f64(config.demote_after or 0.0),
            _f64(config.evict_decided_after or 0.0),
            _u8(adaptive_flags),
            _f64(config.timeout_min or 0.0),
            _f64(config.timeout_max or 0.0),
        )
    )


def decode_scope_config(r: Reader) -> ScopeConfig:
    nt = NetworkType.P2P if r.u8() == _NT_P2P else NetworkType.GOSSIPSUB
    threshold = r.f64()
    timeout = r.f64()
    liveness = bool(r.u8())
    has_override = bool(r.u8())
    override = r.u32()
    tier_flags = r.u8()
    demote_after = r.f64()
    evict_decided_after = r.f64()
    adaptive_flags = r.u8()
    timeout_min = r.f64()
    timeout_max = r.f64()
    return ScopeConfig(
        network_type=nt,
        default_consensus_threshold=threshold,
        default_timeout=timeout,
        default_liveness_criteria_yes=liveness,
        max_rounds_override=override if has_override else None,
        demote_after=demote_after if tier_flags & 1 else None,
        evict_decided_after=evict_decided_after if tier_flags & 2 else None,
        timeout_min=timeout_min if adaptive_flags & 1 else None,
        timeout_max=timeout_max if adaptive_flags & 2 else None,
    )


def encode_consensus_config(config: ConsensusConfig) -> bytes:
    return b"".join(
        (
            _f64(config.consensus_threshold),
            _f64(config.consensus_timeout),
            _u32(config.max_rounds),
            _u8(1 if config.use_gossipsub_rounds else 0),
            _u8(1 if config.liveness_criteria else 0),
        )
    )


def decode_consensus_config(r: Reader) -> ConsensusConfig:
    return ConsensusConfig(
        consensus_threshold=r.f64(),
        consensus_timeout=r.f64(),
        max_rounds=r.u32(),
        use_gossipsub_rounds=bool(r.u8()),
        liveness_criteria=bool(r.u8()),
    )


# ── Per-item payload footprints ────────────────────────────────────────
# Used by DurableEngine's record splitting to pick chunk boundaries
# arithmetically, so each byte is encoded exactly once (no trial encodes
# of payloads that turn out oversized). Keep in lockstep with the encoders
# below — every field is fixed-width except the scope and the wire blob.

PROPOSALS_LEAD_BYTES = 12  # u64 now + u32 count
VOTES_LEAD_BYTES = 13  # u64 now + u8 pre_validated + u32 count
CONSENSUS_CONFIG_BYTES = 22  # 2 × f64 + u32 + 2 × u8 (encode_consensus_config)


def sizeof_proposal_item(item) -> int:
    """Encoded footprint of one ``encode_proposals`` item."""
    scope, wire, config = item
    return (
        len(encode_scope(scope))
        + 1  # has-config flag
        + (CONSENSUS_CONFIG_BYTES if config is not None else 0)
        + 4  # wire length prefix
        + len(wire)
    )


def sizeof_vote_item(item) -> int:
    """Encoded footprint of one ``encode_votes`` item."""
    scope, wire = item
    return len(encode_scope(scope)) + 4 + len(wire)


# ── Record payloads ────────────────────────────────────────────────────


def encode_proposals(
    now: int, items: "list[tuple[object, bytes, ConsensusConfig | None]]"
) -> bytes:
    """items: (scope, Proposal wire bytes, optional per-item config
    override). The override preserves create_proposal's explicit-config
    precedence across replay."""
    out = [_u64(now), _u32(len(items))]
    for scope, wire, config in items:
        out.append(encode_scope(scope))
        if config is None:
            out.append(_u8(0))
        else:
            out.append(_u8(1))
            out.append(encode_consensus_config(config))
        out.append(_blob(wire))
    return b"".join(out)


def decode_proposals(
    payload: bytes,
) -> "tuple[int, list[tuple[object, bytes, ConsensusConfig | None]]]":
    r = Reader(payload)
    now = r.u64()
    items = []
    for _ in range(r.u32()):
        scope = decode_scope(r)
        config = decode_consensus_config(r) if r.u8() else None
        items.append((scope, r.blob(), config))
    return now, items


def encode_votes(
    now: int, pre_validated: bool, items: "list[tuple[object, bytes]]"
) -> bytes:
    """items: (scope, Vote wire bytes). ``pre_validated`` mirrors the live
    ingest_votes flag so replay repeats the exact validation the live call
    performed (locally-built votes skip it; network votes re-validate)."""
    out = [_u64(now), _u8(1 if pre_validated else 0), _u32(len(items))]
    for scope, wire in items:
        out.append(encode_scope(scope))
        out.append(_blob(wire))
    return b"".join(out)


def decode_votes(payload: bytes) -> "tuple[int, bool, list[tuple[object, bytes]]]":
    r = Reader(payload)
    now = r.u64()
    pre_validated = bool(r.u8())
    items = [(decode_scope(r), r.blob()) for _ in range(r.u32())]
    return now, pre_validated, items


def encode_columnar(
    now: int,
    scopes: list,
    scope_idx: "np.ndarray | None",
    blob: bytes,
    offsets: np.ndarray,
) -> bytes:
    """Columnar batch: the record stores the verbatim wire bytes of the
    rows the live engine ACCEPTED (DurableEngine filters by status before
    logging — the live call trusts the caller's gid column, which replay
    cannot reproduce: gid interning is process-local, so recovery re-derives
    the pid/gid/value columns from the wire bytes with fresh interning)."""
    count = len(offsets) - 1
    out = [_u64(now), _u32(len(scopes))]
    for scope in scopes:
        out.append(encode_scope(scope))
    out.append(_u32(count))
    if len(scopes) > 1:
        idx = np.asarray(scope_idx, np.uint32)
        if len(idx) != count:
            raise ValueError("scope_idx must supply one entry per batch row")
        out.append(idx.astype("<u4").tobytes())
    out.append(_blob(blob))
    out.append(np.asarray(offsets, np.int64).astype("<u4").tobytes())
    return b"".join(out)


def decode_columnar(
    payload: bytes,
) -> "tuple[int, list, np.ndarray | None, bytes, np.ndarray]":
    r = Reader(payload)
    now = r.u64()
    scopes = [decode_scope(r) for _ in range(r.u32())]
    count = r.u32()
    scope_idx = None
    if len(scopes) > 1:
        scope_idx = np.frombuffer(r.raw(4 * count), "<u4").astype(np.int64)
    blob = r.blob()
    offsets = np.frombuffer(r.raw(4 * (count + 1)), "<u4").astype(np.int64)
    return now, scopes, scope_idx, blob, offsets


def encode_scope_config_record(mode: int, scope, config: ScopeConfig) -> bytes:
    return _u8(mode) + encode_scope(scope) + encode_scope_config(config)


def decode_scope_config_record(payload: bytes) -> tuple[int, object, ScopeConfig]:
    r = Reader(payload)
    mode = r.u8()
    return mode, decode_scope(r), decode_scope_config(r)


def encode_scope_delete(scopes: list) -> bytes:
    return _u32(len(scopes)) + b"".join(encode_scope(s) for s in scopes)


def decode_scope_delete(payload: bytes) -> list:
    r = Reader(payload)
    return [decode_scope(r) for _ in range(r.u32())]


def encode_timeout(scope, proposal_id: int, now: int) -> bytes:
    # Full u64, NOT masked to the engine's u32 pid space: the record must
    # reproduce the argument the live call received, so a bogus >u32 pid
    # that raised SessionNotFound live raises identically on replay
    # (masking would silently retarget the timeout at a different pid).
    return encode_scope(scope) + _u64(proposal_id) + _u64(now)


def decode_timeout(payload: bytes) -> tuple[object, int, int]:
    r = Reader(payload)
    return decode_scope(r), r.u64(), r.u64()


def encode_sweep(now: int) -> bytes:
    return _u64(now)


# KIND_LIFECYCLE shares the sweep payload: one u64 logical timestamp.
encode_lifecycle = encode_sweep


def encode_gc(keys: list) -> bytes:
    return _u32(len(keys)) + b"".join(
        encode_scope(scope) + _u64(pid) for scope, pid in keys
    )


def decode_gc(payload: bytes) -> list:
    r = Reader(payload)
    return [(decode_scope(r), r.u64()) for _ in range(r.u32())]


def decode_sweep(payload: bytes) -> int:
    return Reader(payload).u64()


def encode_snapshot(watermark: int) -> bytes:
    return _u64(watermark)


def decode_snapshot(payload: bytes) -> int:
    return Reader(payload).u64()
