"""Distributed causal tracing: trace context, span store, Perfetto export.

PR 2 made a single node legible; this module makes the *fleet* legible.
One proposal's life — ``create_proposal`` on peer A, gossip, votes on
peers B..N, quorum, ``decided`` — becomes one causally-stitched trace:

- :class:`TraceContext` is a compact traceparent-style identity
  (16-byte ``trace_id``, 8-byte ``span_id``, 1-byte flags) minted at
  ``create_proposal`` and carried with the proposal wherever it travels:
  as an optional trailing field on bridge frames
  (:mod:`hashgraph_tpu_torch.bridge.protocol`) and as an unknown-but-skippable
  protobuf field appended to gossiped ``Proposal``/``Vote`` bytes
  (:func:`attach_trace` / :func:`extract_trace` — peers built without
  tracing decode the message identically, proto3 unknown-field rules).
- The active context rides a :mod:`contextvars` variable
  (:func:`use_context` / :func:`current_context`); every span recorded
  through :func:`hashgraph_tpu_torch.obs.observed_span` while a context is
  active lands in the process-wide :data:`trace_store` tagged with it —
  engine, bridge, and WAL spans alike.
- :class:`TraceStore` is bounded (a rolling window: past capacity the
  OLDEST spans are evicted and counted) and exports two ways: JSON-lines
  per peer
  (:meth:`TraceStore.export_jsonl`) and Chrome trace-event JSON
  (:meth:`TraceStore.export_chrome`) that Perfetto / ``chrome://tracing``
  open directly. :func:`merge_traces` stitches N peers' JSONL dumps into
  one causal timeline (one Perfetto "process" per peer, spans of one
  proposal share a ``trace_id`` row).

Correlating with device traces: capture a ``torch.profiler`` trace around
the same window (:func:`hashgraph_tpu_torch.tracing.device_profile`) and open
both files in Perfetto — host spans carry wall-clock microsecond
timestamps, so the engine's ``device_ingest`` spans line up with the CUDA
kernels of the same dispatch.

Decision provenance (the "why was this decided" readout built on these
contexts) lives in ``TorchConsensusEngine.explain_decision`` and the
bridge's ``OP_EXPLAIN`` opcode.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field

__all__ = [
    "TRACE_WIRE_BYTES",
    "TraceContext",
    "TraceSpan",
    "TraceStore",
    "attach_trace",
    "chrome_trace",
    "current_context",
    "extract_trace",
    "load_spans_jsonl",
    "merge_traces",
    "trace_store",
    "use_context",
]

# Wire footprint of one context: 16-byte trace_id + 8-byte span_id + flags.
TRACE_WIRE_BYTES = 25

# Protobuf field number used by attach_trace: far above the schema's
# 10..28 range, chosen so the 2-byte tag survives any plausible schema
# growth. Decoders that don't know it skip it (proto3 unknown fields),
# which is the whole backward-compatibility story.
TRACE_FIELD_NUMBER = 2047
_TRACE_TAG = (TRACE_FIELD_NUMBER << 3) | 2  # length-delimited

# Trace/span ids need collision resistance, not crypto strength — and id
# generation sits on the create_proposal path, so it must not consume
# os.urandom per call (the engine's deterministic-pid machinery draws
# from urandom; tracing sharing that stream would perturb it). One
# urandom seed at import, a private PRNG + lock afterwards.
_ID_RNG = random.Random(os.urandom(16))
_ID_LOCK = threading.Lock()


def _random_ids() -> tuple[bytes, bytes]:
    with _ID_LOCK:
        bits = _ID_RNG.getrandbits(192)
    return (bits >> 64).to_bytes(16, "big"), (bits & ((1 << 64) - 1)).to_bytes(
        8, "big"
    )


@dataclass(frozen=True, slots=True)
class TraceContext:
    """W3C-traceparent-shaped identity for one causal trace.

    ``trace_id`` names the whole multi-peer story (one per proposal);
    ``span_id`` names the position in it that new work should parent to.
    Immutable: propagation mints children (:meth:`child`), never mutates.
    """

    trace_id: bytes  # 16 bytes
    span_id: bytes  # 8 bytes
    flags: int = 1  # bit 0: sampled

    @classmethod
    def generate(cls) -> "TraceContext":
        trace_id, span_id = _random_ids()
        return cls(trace_id, span_id)

    def child(self) -> "TraceContext":
        """Same trace, fresh span identity — what a peer mints when it
        continues work it received from the wire."""
        return TraceContext(self.trace_id, _random_ids()[1], self.flags)

    # ── Compact binary form (bridge frames, gossip field) ──────────────

    def to_wire(self) -> bytes:
        return self.trace_id + self.span_id + bytes([self.flags & 0xFF])

    @classmethod
    def from_wire(cls, raw: bytes) -> "TraceContext":
        if len(raw) != TRACE_WIRE_BYTES:
            raise ValueError(
                f"trace context must be {TRACE_WIRE_BYTES} bytes, got {len(raw)}"
            )
        return cls(bytes(raw[:16]), bytes(raw[16:24]), raw[24])

    # ── Text form (logs, HTTP headers, explain output) ─────────────────

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id.hex()}-{self.span_id.hex()}-{self.flags:02x}"

    @classmethod
    def from_traceparent(cls, header: str) -> "TraceContext":
        parts = header.strip().split("-")
        if len(parts) != 4 or parts[0] != "00":
            raise ValueError(f"unsupported traceparent: {header!r}")
        trace_id = bytes.fromhex(parts[1])
        span_id = bytes.fromhex(parts[2])
        if len(trace_id) != 16 or len(span_id) != 8:
            raise ValueError(f"bad traceparent field widths: {header!r}")
        return cls(trace_id, span_id, int(parts[3], 16))


# ── Ambient context propagation ────────────────────────────────────────

_ACTIVE: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "hashgraph_trace_context", default=None
)


def current_context() -> TraceContext | None:
    """The trace context active on this thread/task, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_context(ctx: TraceContext | None):
    """Activate ``ctx`` for the block (None = no-op, so wire-parsing call
    sites can pass whatever they decoded without branching)."""
    if ctx is None:
        yield
        return
    token = _ACTIVE.set(ctx)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


# ── Span records and the bounded store ─────────────────────────────────


@dataclass(slots=True)
class TraceSpan:
    """One completed, context-tagged span (or instant event)."""

    name: str
    trace_id: bytes
    span_id: bytes
    parent_id: bytes | None
    start: float  # wall epoch seconds (cross-peer mergeable)
    duration: float  # seconds; 0.0 for instants
    peer: str
    kind: str = "span"  # "span" | "instant"
    attrs: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "type": "span",
            "name": self.name,
            "trace_id": self.trace_id.hex(),
            "span_id": self.span_id.hex(),
            "parent_id": self.parent_id.hex() if self.parent_id else None,
            "start": self.start,
            "duration": self.duration,
            "peer": self.peer,
            "kind": self.kind,
            **({"attrs": self.attrs} if self.attrs else {}),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TraceSpan":
        return cls(
            name=d["name"],
            trace_id=bytes.fromhex(d["trace_id"]),
            span_id=bytes.fromhex(d["span_id"]),
            parent_id=bytes.fromhex(d["parent_id"]) if d.get("parent_id") else None,
            start=float(d["start"]),
            duration=float(d.get("duration", 0.0)),
            peer=str(d.get("peer", "?")),
            kind=str(d.get("kind", "span")),
            attrs=dict(d.get("attrs", {})),
        )


class TraceStore:
    """Bounded, thread-safe store of context-tagged spans.

    Always on by default (the per-record cost is one lock + one deque
    append; spans only arrive when a trace context is active or a
    proposal lifecycle stamps its bound context), bounded at ``capacity``
    as a ROLLING window — past the cap the oldest span is evicted per
    new one (flight-recorder semantics: a long-running server always
    holds the most recent spans, so an incident trace requested months
    in is still captured) and evictions are counted in :attr:`dropped`;
    :meth:`export_chrome` embeds that count so a truncated capture never
    reads as a complete one. ``peer`` labels which node recorded a span:
    the store default is the process, engines override with their signer
    identity so one process hosting many bridge peers still attributes
    spans per peer.
    """

    def __init__(self, capacity: int = 65536, peer: str | None = None):
        self.enabled = True
        self.capacity = capacity
        self.peer = peer if peer is not None else f"proc:{os.getpid()}"
        self.dropped = 0
        self._spans: deque[TraceSpan] = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def set_peer(self, peer: str) -> None:
        self.peer = peer

    # ── Recording ──────────────────────────────────────────────────────

    def record(
        self,
        name: str,
        ctx: TraceContext,
        start: float,
        duration: float,
        *,
        parent: bytes | None = None,
        peer: str | None = None,
        kind: str = "span",
        attrs: dict | None = None,
    ) -> None:
        """Store one completed span. ``ctx.span_id`` IS the span's own
        identity (mint a :meth:`TraceContext.child` per span); ``parent``
        is the causal predecessor's span_id, if known."""
        if not self.enabled:
            return
        span = TraceSpan(
            name,
            ctx.trace_id,
            ctx.span_id,
            parent,
            start,
            duration,
            peer if peer is not None else self.peer,
            kind,
            attrs if attrs is not None else {},
        )
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped += 1  # maxlen deque evicts the oldest
            self._spans.append(span)

    def instant(
        self,
        name: str,
        ctx: TraceContext,
        ts: float | None = None,
        *,
        peer: str | None = None,
        attrs: dict | None = None,
    ) -> None:
        """Zero-duration marker on ``ctx``'s own span row (vote applied,
        decided, timeout fired)."""
        self.record(
            name,
            ctx,
            ts if ts is not None else time.time(),
            0.0,
            parent=None,
            peer=peer,
            kind="instant",
            attrs=attrs,
        )

    # ── Readout / export ───────────────────────────────────────────────

    def spans(
        self, *, peer: str | None = None, trace_id: bytes | None = None
    ) -> list[TraceSpan]:
        with self._lock:
            out = list(self._spans)
        if peer is not None:
            out = [s for s in out if s.peer == peer]
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def export_jsonl(self, path: str, *, peer: str | None = None) -> int:
        """Atomically write spans (optionally one peer's only) as JSON
        lines — the per-peer dump format :func:`merge_traces` stitches.
        A leading ``store`` metadata line carries the eviction count so a
        truncated capture stays visibly incomplete after merging. Returns
        the number of spans written."""
        spans = self.spans(peer=peer)
        head = json.dumps(
            {"type": "store", "peer": self.peer, "dropped": self.dropped}
        )
        _atomic_write(
            path,
            head + "\n" + "".join(json.dumps(s.as_dict()) + "\n" for s in spans),
        )
        return len(spans)

    def export_chrome(self, path: str, *, peer: str | None = None) -> int:
        """Atomically write a Chrome trace-event JSON file (Perfetto /
        chrome://tracing open it directly). Returns the event count; a
        nonzero store drop count is embedded as ``otherData`` so a capped
        capture is visibly incomplete."""
        spans = self.spans(peer=peer)
        doc = chrome_trace(spans)
        if self.dropped:
            doc["otherData"] = {"dropped_spans": self.dropped}
        _atomic_write(path, json.dumps(doc))
        return len(doc["traceEvents"])


# Process-wide default store (mirrors tracing.tracer / obs.registry).
trace_store = TraceStore()


def _atomic_write(path: str, text: str) -> None:
    # One crash-safe text-export implementation for the whole tracing
    # stack (temp file + umask-widened mode + os.replace).
    from ..tracing import atomic_write_text

    atomic_write_text(path, text)


# ── Chrome trace-event rendering and cross-peer stitching ──────────────


def chrome_trace(spans: list[TraceSpan]) -> dict:
    """Render spans as a Chrome trace-event document: one Perfetto
    "process" per peer (metadata-named), one thread row per trace_id so a
    proposal's causal chain reads left-to-right on a single line, spans as
    complete ("X") events and instants as instant ("i") events. Timestamps
    are wall-clock microseconds, so documents from different peers (or a
    concurrent ``torch.profiler`` device capture) line up on one axis."""
    peer_pids: dict[str, int] = {}
    for s in spans:
        peer_pids.setdefault(s.peer, len(peer_pids) + 1)
    events: list[dict] = []
    for peer, pid in peer_pids.items():
        events.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": f"peer {peer}"},
            }
        )
    for s in sorted(spans, key=lambda s: (s.start, s.duration)):
        # 48 bits of the trace_id: well inside JSON-safe integer range,
        # collision odds negligible for any store-sized trace population
        # (a 10^6 space would birthday-collide around ~1.2k traces).
        tid = int.from_bytes(s.trace_id[:6], "big")
        args = {
            "trace_id": s.trace_id.hex(),
            "span_id": s.span_id.hex(),
            **({"parent_id": s.parent_id.hex()} if s.parent_id else {}),
            **s.attrs,
        }
        event = {
            "name": s.name,
            "cat": "consensus",
            "pid": peer_pids[s.peer],
            "tid": tid,
            "ts": s.start * 1e6,
            "args": args,
        }
        if s.kind == "instant":
            event["ph"] = "i"
            event["s"] = "t"  # thread-scoped marker
        else:
            event["ph"] = "X"
            event["dur"] = max(s.duration, 0.0) * 1e6
        events.append(event)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _load_jsonl(path: str) -> tuple[list[TraceSpan], int]:
    """(spans, dropped-count) from one dump; unknown line types are
    skipped, so the files stay forward-extensible."""
    spans: list[TraceSpan] = []
    dropped = 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if d.get("type") == "span":
                spans.append(TraceSpan.from_dict(d))
            elif d.get("type") == "store":
                dropped += int(d.get("dropped", 0))
    return spans, dropped


def load_spans_jsonl(path: str) -> list[TraceSpan]:
    """Read one peer's :meth:`TraceStore.export_jsonl` dump."""
    return _load_jsonl(path)[0]


def merge_traces(paths: list[str], out_path: str) -> dict:
    """Stitch N peers' JSONL span dumps into ONE Chrome trace-event file.

    Spans are merged, ordered by wall-clock start, and grouped by peer
    (Perfetto process) and trace_id (thread row) — so one proposal's
    spans from every peer land on the same row in causal order. Returns a
    summary: span/peer counts and per-trace span counts (hex trace_id →
    spans), which is also what ``examples/trace_smoke.py`` asserts on.
    """
    spans: list[TraceSpan] = []
    dropped = 0
    for path in paths:
        loaded, peer_dropped = _load_jsonl(path)
        spans.extend(loaded)
        dropped += peer_dropped
    spans.sort(key=lambda s: (s.start, s.duration))
    doc = chrome_trace(spans)
    if dropped:
        # Capped captures stay visibly incomplete in the merged view too.
        doc["otherData"] = {"dropped_spans": dropped}
    _atomic_write(out_path, json.dumps(doc))
    traces: dict[str, int] = {}
    for s in spans:
        key = s.trace_id.hex()
        traces[key] = traces.get(key, 0) + 1
    return {
        "spans": len(spans),
        "dropped": dropped,
        "peers": sorted({s.peer for s in spans}),
        "traces": traces,
        "out": out_path,
    }


# ── Gossip-envelope field: trace context inside protobuf bytes ─────────
# Varint primitives come from the wire codec — one protobuf
# implementation in the package, not two that can drift.


def attach_trace(message: bytes, ctx: TraceContext) -> bytes:
    """Append the trace context to encoded ``Proposal``/``Vote`` bytes as
    protobuf field :data:`TRACE_FIELD_NUMBER`.

    Backward compatible by construction: proto3 decoders (including this
    framework's and the reference's prost codec) skip unknown fields, so
    a peer built without tracing decodes the message identically — and
    signatures are unaffected because they cover the *decoded* signed
    fields re-encoded canonically, never the raw gossip bytes."""
    from ..wire import _encode_varint

    wire = ctx.to_wire()
    out = bytearray(message)
    _encode_varint(out, _TRACE_TAG)
    _encode_varint(out, len(wire))
    out += wire
    return bytes(out)


def extract_trace(message: bytes) -> TraceContext | None:
    """Scan encoded message bytes for an attached trace context (None when
    absent or malformed — gossip input is untrusted, so this never
    raises on junk)."""
    from ..wire import _decode_varint

    pos = 0
    n = len(message)
    try:
        while pos < n:
            key, pos = _decode_varint(message, pos)
            field_number, wire_type = key >> 3, key & 7
            if wire_type == 2:
                length, pos = _decode_varint(message, pos)
                end = pos + length
                if end > n:
                    return None
                if field_number == TRACE_FIELD_NUMBER and length == TRACE_WIRE_BYTES:
                    return TraceContext.from_wire(message[pos:end])
                pos = end
            elif wire_type == 0:
                _, pos = _decode_varint(message, pos)
            elif wire_type == 1:
                pos += 8
            elif wire_type == 5:
                pos += 4
            else:
                return None
    except ValueError:
        return None
    return None
