"""Embedder bridge wire protocol: framing, opcodes, and field codecs.

The reference is a library an application embeds in-process
(reference: README.md:183-197, src/lib.rs:15-34); its FFI story is "link the
crate". This framework's compute engine lives in a Python process, so the
embedder boundary is a byte protocol instead: any language opens a TCP
connection to :class:`~hashgraph_tpu_torch.bridge.server.BridgeServer` and drives
the full ConsensusService surface (create_proposal, cast_vote,
process_incoming_{proposal,vote}, handle_consensus_timeout, events out) with
`Proposal`/`Vote` payloads as the exact protobuf bytes of
``protos/messages/v1/consensus.proto`` — the same bytes the reference's prost
codec produces, so a Rust embedder can decode them with its own generated
types. ``native/bridge_client.c`` is the C reference client.

Frame layout (all integers little-endian):

    request:  u32 length | u8 opcode | payload
    response: u32 length | u8 status | payload

``length`` counts the opcode/status byte plus the payload. Field codecs:
strings are ``u16 len + UTF-8``; byte blobs are ``u32 len + bytes``. Every
opcode except PING and ADD_PEER starts its payload with the ``u32 peer_id``
returned by ADD_PEER (a bridge server hosts many independent peers, mirroring
the reference's one-service-per-peer deployment, src/service.rs:26-29).

Statuses: 0 = OK; 1..29 mirror :class:`hashgraph_tpu_torch.errors.StatusCode`;
240+ are bridge-level (unknown peer / malformed frame / unknown opcode /
internal error). Error responses carry the message as a string payload.

**Trace context (optional, backward compatible).** Proposal-lifecycle
requests (CREATE_PROPOSAL, CAST_VOTE, PROCESS_PROPOSAL, PROCESS_VOTE,
PROCESS_VOTES, HANDLE_TIMEOUT) may append a 26-byte trace-context suffix
after their last field: ``u8 version (0)`` + the 25-byte
:class:`~hashgraph_tpu_torch.obs.trace.TraceContext` wire form (16-byte
trace_id, 8-byte parent span_id, u8 flags). CREATE_PROPOSAL and
CAST_VOTE responses append the same suffix carrying the proposal's bound
context, so the embedder can ferry it to the peers it gossips to.
Handlers never require the suffix (frames without it decode exactly as
before) and never read past their declared fields, so old and new peers
interoperate in both directions: an old server ignores the trailing
bytes, an old client ignores the suffixed response tail.

**Feature negotiation + pipelining (optional, backward compatible).**
``OP_HELLO`` (``u32 protocol_version + u32 offered feature bits`` ->
``u32 protocol_version + u32 granted feature bits``) lets a connection
upgrade itself. A peer that never sends HELLO gets exactly the old wire;
an old server answers HELLO with ``STATUS_UNKNOWN_OPCODE`` — the
canonical "no features" reply, after which the connection continues in
the old one-at-a-time framing. When ``FEATURE_PIPELINING`` is granted,
every subsequent frame on that connection (both directions) switches to
the *tagged* layout:

    request:  u32 length | u8 opcode | u32 correlation_id | payload
    response: u32 length | u8 status | u32 correlation_id | payload

(``length`` counts the lead byte, the 4-byte correlation id, and the
payload.) Many requests may be in flight; the server answers each with
its request's correlation id, and responses MAY complete out of order —
read-only opcodes dispatch concurrently, while state-mutating opcodes
(create/cast/process/deliver/timeout) from one connection execute in
receive order, so a pipelined vote stream keeps its chain order without
waiting a round trip per frame. Correlation ids are opaque to the
server; clients allocate them (wrapping u32 counters).

``FEATURE_VOTE_BATCH`` grants ``OP_VOTE_BATCH`` — the coalesced columnar
vote frame (see :func:`encode_vote_batch`) landing many small votes for
many (peer, scope) targets in one frame and one pipelined engine
dispatch per peer. ``FEATURE_DELIVER`` grants ``OP_DELIVER_PROPOSALS`` —
gossip anti-entropy delivery riding the engine's validated-chain
watermark (redelivered chains verify only their suffix).
``FEATURE_EVENT_BOUND`` grants the bounded ``OP_POLL_EVENTS`` request
form (trailing ``u32 max_events``; the response then carries a trailing
``u8 more`` flag).
"""

from __future__ import annotations

import socket as _socket
import struct

import numpy as np

from ..obs.trace import TRACE_WIRE_BYTES, TraceContext

PROTOCOL_VERSION = 1

# Opcodes.
OP_PING = 0
OP_ADD_PEER = 1
OP_CREATE_PROPOSAL = 2
OP_CAST_VOTE = 3
OP_PROCESS_PROPOSAL = 4
OP_PROCESS_VOTE = 5
OP_HANDLE_TIMEOUT = 6
OP_GET_RESULT = 7
OP_POLL_EVENTS = 8
OP_GET_PROPOSAL = 9
OP_GET_STATS = 10
OP_PROCESS_VOTES = 11  # batch: u32 count + count vote blobs -> u8 statuses
# Server-wide observability scrape (no peer_id prefix, like PING): returns
# the process metrics registry rendered in Prometheus text format as one
# byte blob — remote embedders scrape over the wire they already hold
# instead of needing the HTTP sidecar reachable.
OP_GET_METRICS = 12
# Decision provenance: u32 peer_id + string scope + u32 proposal_id ->
# one JSON blob (TorchConsensusEngine.explain_decision: vote chain, quorum
# arithmetic, timeline phases, trace identity, WAL watermark).
OP_EXPLAIN = 13
# Consensus health observatory: u32 peer_id + u64 now (0 = the monitor's
# latest observed logical tick) -> one JSON blob
# (TorchConsensusEngine.health_report: per-peer scorecards with derived
# grades, self-authenticating equivocation/fork evidence, liveness
# watchdog, firing alert rules; durable peers overlay the WAL watermark).
OP_HEALTH = 14
# ── State sync (snapshot shipping + WAL tailing; durable peers only) ──
# SYNC_MANIFEST: u32 peer_id + u32 max_chunk_bytes (0 = server default)
# -> u64 snapshot_id | u64 watermark_lsn | u64 total_bytes |
#    u32 chunk_bytes | u32 session_count | u32 config_count |
#    u32 chunk_count | chunk_count × 32-byte SHA-256 chunk digests.
# The server captures (or reuses, when the WAL position is unchanged) a
# consistent snapshot of the peer's state at its WAL watermark; chunks
# are byte ranges of the serialized snapshot (sync.snapshot format).
OP_SYNC_MANIFEST = 15
# SYNC_CHUNK: u32 peer_id + u64 snapshot_id + u32 chunk_index -> one
# byte blob (that chunk of the snapshot). STATUS_SYNC_STALE means the
# identified snapshot is no longer served (the source's state moved on
# and the snapshot was rebuilt) — re-fetch the manifest and resume.
OP_SYNC_CHUNK = 16
# WAL_TAIL: u32 peer_id + u64 after_lsn + u32 max_bytes ->
# u32 count | count × (u64 lsn | u8 kind | u32 len | record payload) |
# u8 more. Streams the peer's WAL records after ``after_lsn`` in log
# order, resumable by advancing after_lsn to the last received LSN;
# ``more`` = 1 when the byte budget stopped the read short.
OP_WAL_TAIL = 17
# ── Gossip fabric (feature-negotiated; see the module docstring) ──────
# HELLO: u32 protocol_version + u32 offered feature bits ->
# u32 protocol_version + u32 granted bits (offered ∩ supported). No
# peer_id prefix (like PING). Old servers answer STATUS_UNKNOWN_OPCODE,
# which clients treat as "zero features granted".
OP_HELLO = 18
# VOTE_BATCH: the coalesced columnar vote frame (encode_vote_batch) —
# many (peer_id, scope) groups of small vote payloads in ONE frame,
# landed via ingest_votes_pipelined per peer. Response: u32 total |
# one status byte per vote in flattened batch order. No peer_id prefix
# (groups carry their own).
OP_VOTE_BATCH = 19
# DELIVER_PROPOSALS: u32 peer_id | u64 now | u32 count |
# count × (string scope | blob proposal) -> u32 count | count status
# bytes. Lands on TorchConsensusEngine.deliver_proposals: unknown
# sessions are created, known ones EXTEND along the validated-chain
# watermark (suffix-only crypto), redeliveries settle crypto-free —
# the anti-entropy primitive.
OP_DELIVER_PROPOSALS = 20

# STATE_FINGERPRINT: u32 peer_id -> string (hex). The peer engine's
# order-insensitive content digest (sync.state_fingerprint) — the
# convergence check the gossip bench/smoke asserts across peers that
# live in DIFFERENT processes (in-process tests can reach the engine;
# networked peers cannot).
OP_STATE_FINGERPRINT = 21

# SHM_ATTACH (FEATURE_SHM_RING; pipelined connections only): u32
# ring_bytes | string c2s shm name | string s2c shm name -> empty OK.
# The client creates two single-producer single-consumer shared-memory
# byte rings (hashgraph_tpu_torch.gossip.shm layout) and the server maps them;
# from the OK on, the client MAY send any tagged request frame through
# the c2s ring and the server answers through the s2c ring. The TCP
# socket stays open as the control/fallback lane and its close tears the
# rings down. Co-located peers skip the kernel socket path entirely —
# a frame is one memcpy each way.
OP_SHM_ATTACH = 22

# FLEET_TALLY: u32 peer_id -> u32 n | n x (u32 state_code, u64 count).
# The peer engine's slot-state histogram — for a federation host whose
# peer engine is a fleet adapter this is the host's ONE-psum
# fleet_state_counts; a plain engine answers its pool's local counts.
# This is the fabric half of the cross-host tally contract: where the
# backend implements cross-process collectives
# (parallel.multihost.collectives_available) the fleet psums instead;
# where it doesn't, a driver sums these frames across hosts.
OP_FLEET_TALLY = 23

# Federated metrics pull (server-wide, no peer_id — like GET_METRICS):
# returns one JSON blob {"host": <label>, "state": <registry
# export_state>, "slo": <SloEngine.state>}. GET_METRICS ships *rendered*
# Prometheus text, which cannot be merged; this ships the raw mergeable
# registry state (non-cumulative histogram buckets + exemplars) that
# parallel.rollup.merge_metric_states sums into a single fleet-wide
# /metrics + /slo view with per-host labels.
OP_METRICS_PULL = 24

# Server-wide (no peer_id) -> JSON blob {"host": <label>, "profile":
# <obs.attribution.attribution_report()>}: the wall-clock attribution
# readout (per-stage busy shares, reactor dispatch counters, continuous
# profiler sample summary). Host-labelled like OP_METRICS_PULL so
# parallel.rollup.merge_profile_states federates frames into one fleet
# view. Old servers answer STATUS_UNKNOWN_OPCODE — callers treat that
# as "no profile plane", the HELLO interop discipline.
OP_PROFILE = 25

# Opcodes that mutate server-side state (plus POLL_EVENTS, whose read is
# DESTRUCTIVE — it drains the peer's event queue). On a pipelined
# connection the server executes these in receive order per connection;
# read-only opcodes dispatch concurrently and may complete out of order.
# The client transport uses the same set to keep an ordered stream on
# ONE lane when a connection carries both a shm ring and the TCP
# control/fallback lane (see gossip.transport.GossipTransport).
MUTATING_OPCODES = frozenset({
    OP_ADD_PEER,
    OP_CREATE_PROPOSAL,
    OP_CAST_VOTE,
    OP_PROCESS_PROPOSAL,
    OP_PROCESS_VOTE,
    OP_PROCESS_VOTES,
    OP_VOTE_BATCH,
    OP_DELIVER_PROPOSALS,
    OP_HANDLE_TIMEOUT,
    OP_POLL_EVENTS,
})

# HELLO feature bits.
FEATURE_PIPELINING = 1 << 0
FEATURE_VOTE_BATCH = 1 << 1
FEATURE_DELIVER = 1 << 2
FEATURE_EVENT_BOUND = 1 << 3
FEATURE_SHM_RING = 1 << 4
SUPPORTED_FEATURES = (
    FEATURE_PIPELINING | FEATURE_VOTE_BATCH | FEATURE_DELIVER
    | FEATURE_EVENT_BOUND | FEATURE_SHM_RING
)

# Bridge-level statuses (protocol StatusCode values occupy 0..29).
STATUS_OK = 0
STATUS_UNKNOWN_PEER = 240
STATUS_BAD_REQUEST = 241
STATUS_UNKNOWN_OPCODE = 242
STATUS_SYNC_STALE = 245  # requested snapshot_id no longer served
# The scope's owning shard is frozen mid-migration to another host; the
# response payload is the retry-after hint (seconds, decimal string).
# Back off and retry — the placement flips within the window; votes are
# never dropped, only deferred.
STATUS_SHARD_MIGRATING = 246
# Overload admission: the connection's in-order dispatch lane is too
# deep to accept another state-mutating frame. The response payload is a
# server-computed backoff hint (seconds, decimal string) derived from
# the lane's queue depth. Semantics mirror STATUS_SHARD_MIGRATING:
# nothing was applied, back off for the hinted window and let
# anti-entropy repair the deferred scopes — shed, never silently lost.
STATUS_RETRY_AFTER = 247
STATUS_INTERNAL = 250

# GET_RESULT payload byte.
RESULT_NO = 0
RESULT_YES = 1
RESULT_FAILED = 2
RESULT_UNDECIDED = 255

# POLL_EVENTS event kinds.
EVENT_REACHED = 1
EVENT_FAILED = 2

MAX_FRAME = 64 * 1024 * 1024  # hard cap against garbage length prefixes

# Precompiled header/field structs: encode_frame and the Cursor integer
# reads are the per-frame hot path (the coalesced fabric moves hundreds
# of thousands of frames and fields per second), and `struct.pack("<I",
# v)` re-parses its format string and allocates an intermediate on every
# call. One compiled Struct per width, reused for the process lifetime.
_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_FRAME_HEADER = struct.Struct("<IB")  # length | lead
_TAGGED_HEADER = struct.Struct("<IBI")  # length | lead | correlation id


class Cursor:
    """Sequential reader over one frame's payload. ``start`` lets framed
    readers hand the body over without slicing off the already-consumed
    header bytes (one allocation saved per frame)."""

    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes, start: int = 0):
        self._data = data
        self._pos = start

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._data):
            raise ValueError("frame truncated")
        out = self._data[self._pos : self._pos + n]
        self._pos += n
        return out

    def raw(self, n: int) -> bytes:
        return self._take(n)

    def u8(self) -> int:
        pos = self._pos
        if pos + 1 > len(self._data):
            raise ValueError("frame truncated")
        self._pos = pos + 1
        return self._data[pos]

    def u16(self) -> int:
        pos = self._pos
        if pos + 2 > len(self._data):
            raise ValueError("frame truncated")
        self._pos = pos + 2
        return _U16.unpack_from(self._data, pos)[0]

    def u32(self) -> int:
        pos = self._pos
        if pos + 4 > len(self._data):
            raise ValueError("frame truncated")
        self._pos = pos + 4
        return _U32.unpack_from(self._data, pos)[0]

    def u64(self) -> int:
        pos = self._pos
        if pos + 8 > len(self._data):
            raise ValueError("frame truncated")
        self._pos = pos + 8
        return _U64.unpack_from(self._data, pos)[0]

    def string(self) -> str:
        return self._take(self.u16()).decode("utf-8")

    def blob(self) -> bytes:
        return self._take(self.u32())

    def skip(self, n: int) -> None:
        if self._pos + n > len(self._data):
            raise ValueError("frame truncated")
        self._pos += n

    def fork(self) -> "Cursor":
        """Independent cursor at the current position over the same
        buffer — lets a fast path consume the frame and still hand the
        untouched bytes to the fallback decoder."""
        return Cursor(self._data, self._pos)

    def done(self) -> bool:
        return self._pos == len(self._data)

    def remaining(self) -> int:
        return len(self._data) - self._pos


# Field encoders: the compiled Structs' bound ``pack`` methods ARE the
# functions (same signatures, same struct.error on out-of-range values,
# no per-call format parse).
u8 = _U8.pack
u16 = _U16.pack
u32 = _U32.pack
u64 = _U64.pack


def string(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _U16.pack(len(raw)) + raw


def blob(b: bytes) -> bytes:
    return _U32.pack(len(b)) + b


def encode_frame(lead: int, payload: bytes = b"") -> bytes:
    """``lead`` is the opcode (requests) or status (responses)."""
    return _FRAME_HEADER.pack(1 + len(payload), lead) + payload


def encode_tagged_frame(lead: int, corr_id: int, payload: bytes = b"") -> bytes:
    """Pipelined-mode frame: ``lead`` + correlation id + payload (only
    valid on a connection that negotiated ``FEATURE_PIPELINING``)."""
    return _TAGGED_HEADER.pack(5 + len(payload), lead, corr_id) + payload


# ── Optional trace-context suffix ──────────────────────────────────────

TRACE_SUFFIX_VERSION = 0


def encode_trace_context(ctx: TraceContext | None) -> bytes:
    """The 26-byte optional frame suffix (empty bytes for None, so call
    sites can append unconditionally)."""
    if ctx is None:
        return b""
    return u8(TRACE_SUFFIX_VERSION) + ctx.to_wire()


def read_trace_context(c: Cursor) -> TraceContext | None:
    """Consume a trailing trace-context suffix, if present. Returns None
    for frames without one (old peers), with an unknown suffix version,
    or with a short/odd-sized tail (future peers, foreign embedders
    appending their own trailers — the bytes are consumed and ignored,
    never an error, matching the pre-suffix server's tolerance)."""
    if c.done():
        return None
    if c.remaining() < 1 + TRACE_WIRE_BYTES:
        c.raw(c.remaining())
        return None
    version = c.u8()
    raw = c.raw(TRACE_WIRE_BYTES)
    if version != TRACE_SUFFIX_VERSION:
        return None
    return TraceContext.from_wire(raw)


def read_exact(sock, n: int) -> bytes:
    """Read exactly n bytes from a socket; raises ConnectionError on EOF.
    Reads into one preallocated buffer (``recv_into``) instead of
    accumulating chunk objects and joining — one allocation per frame
    body regardless of how the kernel segments it."""
    buf = bytearray(n)
    view = memoryview(buf)
    pos = 0
    while pos < n:
        got = sock.recv_into(view[pos:])
        if not got:
            raise ConnectionError("bridge peer closed the connection")
        pos += got
    return bytes(buf)


def read_frame(sock) -> tuple[int, Cursor]:
    """Returns (opcode-or-status, payload cursor)."""
    (length,) = _U32.unpack(read_exact(sock, 4))
    if length < 1 or length > MAX_FRAME:
        raise ValueError(f"bad frame length {length}")
    body = read_exact(sock, length)
    return body[0], Cursor(body, 1)


def read_tagged_frame(sock) -> tuple[int, int, Cursor]:
    """Pipelined-mode :func:`read_frame`: returns (opcode-or-status,
    correlation id, payload cursor)."""
    (length,) = _U32.unpack(read_exact(sock, 4))
    if length < 5 or length > MAX_FRAME:
        raise ValueError(f"bad tagged frame length {length}")
    body = read_exact(sock, length)
    return body[0], _U32.unpack_from(body, 1)[0], Cursor(body, 5)


def split_frames(buf: bytearray, min_len: int = 1) -> "list[bytes]":
    """Split every COMPLETE length-prefixed frame body off the front of
    ``buf`` (mutated in place; a trailing partial frame stays buffered
    for the next feed). One home for the accumulate/length-check/slice
    loop every buffered lane runs — the TCP reader and both shm ring
    readers stay provably consistent. Raises ValueError on a
    structurally impossible length: the stream has lost framing and the
    caller must kill it (frames split earlier in the same feed are
    dropped with it — their futures fail typed when the lane dies)."""
    frames: list[bytes] = []
    pos = 0
    n = len(buf)
    while n - pos >= 4:
        (length,) = _U32.unpack_from(buf, pos)
        if length < min_len or length > MAX_FRAME:
            raise ValueError(f"bad frame length {length}")
        if n - pos < 4 + length:
            break
        frames.append(bytes(buf[pos + 4 : pos + 4 + length]))
        pos += 4 + length
    if pos:
        del buf[:pos]
    return frames


def parse_frame(body: bytes, tagged: bool) -> tuple[int, int, Cursor]:
    """Parse one already-read frame body (the length prefix stripped):
    returns (lead, correlation id — 0 when untagged, payload cursor).
    The non-blocking transport reads socket bytes into its own buffer
    and hands complete bodies here."""
    if tagged:
        if len(body) < 5:
            raise ValueError("tagged frame truncated")
        return body[0], _U32.unpack_from(body, 1)[0], Cursor(body, 5)
    if len(body) < 1:
        raise ValueError("frame truncated")
    return body[0], 0, Cursor(body, 1)


# ── Coalesced columnar vote frames (OP_VOTE_BATCH) ─────────────────────
#
# Layout: u64 now | u32 group_count
#         | group_count × (u32 peer_id | string scope | u32 vote_count)
#         | Σvote_count × u32 vote_len        (columnar lengths)
#         | concatenated vote payload bytes    (same flattened order)
# Response: u32 total | total × u8 status (flattened batch order; the
# per-vote codes mirror OP_PROCESS_VOTES: StatusCode values, 241 for an
# undecodable blob, STATUS_UNKNOWN_PEER for a group naming no peer).


def encode_vote_batch(
    now: int, groups: "list[tuple[int, str, list[bytes]]]"
) -> bytes:
    """One coalesced frame payload from ``(peer_id, scope, votes)``
    groups (votes as wire bytes). Order inside a group — and across
    groups — is preserved end to end, so chained votes coalesced in
    submission order land in submission order."""
    head = [u64(now), u32(len(groups))]
    lens: list[bytes] = []
    bodies: list[bytes] = []
    for peer_id, scope, votes in groups:
        head.append(u32(peer_id) + string(scope) + u32(len(votes)))
        for v in votes:
            lens.append(u32(len(v)))
            bodies.append(v)
    return b"".join(head) + b"".join(lens) + b"".join(bodies)


def encode_vote_batch_segments(
    now: int, groups: "list[tuple[int, str, list[bytes]]]"
) -> "tuple[list[bytes], int]":
    """Scatter-gather :func:`encode_vote_batch`: returns ``(segments,
    total_bytes)`` where the segments are the frame head (header fields +
    length columns, one joined blob) followed by the vote payloads AS THE
    CALLER'S OWN bytes objects — no concatenation copy of the vote
    region. ``b"".join(segments)`` equals :func:`encode_vote_batch`'s
    output byte for byte; the transport hands the list to
    ``socket.sendmsg`` (or writes it segment-wise into a shm ring)."""
    head = [u64(now), u32(len(groups))]
    lens: list[bytes] = []
    bodies: list[bytes] = []
    body_bytes = 0
    for peer_id, scope, votes in groups:
        head.append(u32(peer_id) + string(scope) + u32(len(votes)))
        for v in votes:
            lens.append(u32(len(v)))
            bodies.append(v)
            body_bytes += len(v)
    lead = b"".join(head) + b"".join(lens)
    return [lead, *bodies], len(lead) + body_bytes


class VoteBatchView:
    """Zero-copy columnar view of one decoded ``OP_VOTE_BATCH`` payload:
    group metadata plus numpy views (no per-vote slicing) over the
    length column and the contiguous vote-bytes region."""

    __slots__ = ("now", "groups", "offsets", "data", "total")

    def __init__(self, now, groups, offsets, data, total):
        self.now = now
        self.groups = groups  # [(peer_id, scope, vote_count)]
        self.offsets = offsets  # int64[total+1], absolute into `data`
        self.data = data  # uint8 view over the frame's vote region
        self.total = total


def decode_vote_batch_views(c: Cursor) -> VoteBatchView:
    """Columnar :func:`decode_vote_batch`: same header walk (so
    malformed frames raise the same ``ValueError`` the object decoder
    would), but the length column becomes one u32 numpy view and the
    vote bytes stay one contiguous uint8 view — zero per-vote Python
    objects. Trailing bytes past the vote region are tolerated exactly
    as the object decoder tolerates them."""
    now = c.u64()
    groups: list[tuple[int, str, int]] = []
    for _ in range(c.u32()):
        peer_id = c.u32()
        scope = c.string()
        groups.append((peer_id, scope, c.u32()))
    total = sum(g[2] for g in groups)
    if c.remaining() < 4 * total:
        raise ValueError("frame truncated")
    lens = np.frombuffer(c._data, np.dtype("<u4"), count=total, offset=c._pos)
    c.skip(4 * total)
    offsets = np.zeros(total + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    need = int(offsets[-1])
    if c.remaining() < need:
        raise ValueError("frame truncated")
    data = np.frombuffer(c._data, np.uint8, count=need, offset=c._pos)
    c.skip(need)
    return VoteBatchView(now, groups, offsets, data, total)


def decode_vote_batch(
    c: Cursor,
) -> "tuple[int, list[tuple[int, str, list[bytes]]]]":
    """Inverse of :func:`encode_vote_batch`: (now, groups)."""
    now = c.u64()
    metas: list[tuple[int, str, int]] = []
    for _ in range(c.u32()):
        peer_id = c.u32()
        scope = c.string()
        metas.append((peer_id, scope, c.u32()))
    lens: list[int] = [c.u32() for _ in range(sum(m[2] for m in metas))]
    groups: list[tuple[int, str, list[bytes]]] = []
    k = 0
    for peer_id, scope, count in metas:
        votes = []
        for _ in range(count):
            votes.append(c.raw(lens[k]))
            k += 1
        groups.append((peer_id, scope, votes))
    return now, groups


def encode_deliver_proposals(
    peer_id: int, items: "list[tuple[str, bytes]]", now: int
) -> bytes:
    """``OP_DELIVER_PROPOSALS`` request payload: one home for the field
    walk (serial client, pipelined client, gossip node all send it)."""
    out = [u32(peer_id), u64(now), u32(len(items))]
    for scope, proposal in items:
        out.append(string(scope))
        out.append(blob(proposal))
    return b"".join(out)


def encode_fleet_tally(counts: "dict[int, int]") -> bytes:
    """``OP_FLEET_TALLY`` response payload: the slot-state histogram as
    (state_code, count) pairs, code-sorted for a stable wire image."""
    out = [u32(len(counts))]
    for code in sorted(counts):
        out.append(u32(int(code)) + u64(int(counts[code])))
    return b"".join(out)


def parse_fleet_tally(c: Cursor) -> "dict[int, int]":
    """Decode an ``OP_FLEET_TALLY`` response into {state_code: count}."""
    return {c.u32(): c.u64() for _ in range(c.u32())}


# ── Socket tuning ──────────────────────────────────────────────────────


def tune_socket(sock, *, nodelay: bool = True,
                sndbuf: int | None = None, rcvbuf: int | None = None) -> None:
    """Apply the bridge's socket defaults. ``TCP_NODELAY`` is ON for
    every bridge socket (both ends): the wire is dominated by small
    request/response frames, and Nagle coalescing would serialize each
    one behind the peer's delayed ACK (~40 ms stalls on the serial
    path). ``SO_SNDBUF``/``SO_RCVBUF`` default to the OS autotuned
    sizes, which are right for loopback and LAN; set them explicitly
    (e.g. 1–4 MiB) only for high-BDP WAN links where the pipelined
    fabric must keep a full window in flight — note Linux doubles the
    requested value and caps it at ``net.core.{w,r}mem_max``, so a
    silently clamped setsockopt is worth checking with getsockopt when
    tuning."""
    if nodelay:
        sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
    if sndbuf is not None:
        sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_SNDBUF, sndbuf)
    if rcvbuf is not None:
        sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_RCVBUF, rcvbuf)
