"""Python reference client for the embedder bridge.

Mirrors ``native/bridge_client.c`` one call per opcode; used by the test
suite and as executable documentation of the wire protocol. An embedder in
any language reproduces exactly these byte sequences.
"""

from __future__ import annotations

import json
import random
import socket
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

from ..errors import StatusCode, error_for_code
from ..obs import flight_recorder
from ..obs.trace import TraceContext, current_context
from . import protocol as P


class BridgeError(Exception):
    """Non-OK response from the bridge, carrying the wire status."""

    def __init__(self, status: int, message: str = ""):
        self.status = status
        # Raw payload string, pre-formatting: typed statuses
        # (STATUS_SHARD_MIGRATING, STATUS_RETRY_AFTER) carry their
        # retry-after hint here as a decimal-seconds string.
        self.message = message
        try:
            name = StatusCode(status).name
        except ValueError:
            name = f"bridge status {status}"
        super().__init__(f"{name}: {message}" if message else name)


class BridgeConnectionLost(ConnectionError):
    """The bridge connection died with requests still in flight. Every
    pending future of a :class:`PipelinedBridgeClient` (and of the gossip
    transport's channels) resolves to this — a typed, per-request signal
    that the response will never arrive, distinct from a server-side
    rejection (:class:`BridgeError`)."""


@dataclass(frozen=True)
class ReconnectPolicy:
    """Bounded, jittered exponential backoff for opt-in channel
    auto-reconnect (:class:`PipelinedBridgeClient` takes one, as the JAX
    package's gossip transport does). The contract is deliberately narrow: in-flight requests on a
    dying channel STILL fail typed (``BridgeConnectionLost`` — a lost
    frame cannot be replayed safely by a generic layer), but the channel
    itself comes back — fresh socket, fresh HELLO feature negotiation —
    so a crash-restarting peer heals without embedder plumbing. Jitter
    (a random fraction shaved off each delay) keeps a fleet of clients
    from stampeding a peer the moment it returns."""

    max_attempts: int = 6
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.5  # fraction of each delay randomized away

    def __post_init__(self):
        if self.max_attempts <= 0:
            raise ValueError("max_attempts must be positive")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError("jitter must be in [0, 1]")

    def delay(self, attempt: int, rng=random) -> float:
        """Backoff before attempt ``attempt`` (0-based): exponential from
        ``base_delay``, capped at ``max_delay``, minus a random slice up
        to ``jitter`` of itself."""
        full = min(self.max_delay, self.base_delay * (2.0 ** attempt))
        return full * (1.0 - self.jitter * rng.random())


@dataclass(frozen=True)
class BridgeEvent:
    scope: str
    kind: int  # P.EVENT_REACHED / P.EVENT_FAILED
    proposal_id: int
    result: bool
    timestamp: int


class BridgeClient:
    """One bridge connection.

    Distributed tracing: proposal-lifecycle calls accept an optional
    ``trace=`` :class:`~hashgraph_tpu_torch.obs.trace.TraceContext` (falling
    back to the ambient :func:`~hashgraph_tpu_torch.obs.trace.current_context`)
    appended as the protocol's backward-compatible frame suffix.
    ``create_proposal``/``cast_vote`` store the proposal's server-bound
    context in :attr:`last_trace_context` — pass it as ``trace=`` when
    ferrying the returned bytes to other peers so every peer's spans
    stitch into one trace."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        P.tune_socket(self._sock)  # TCP_NODELAY on: small-frame wire
        #: Trace context returned by the last create_proposal/cast_vote.
        self.last_trace_context: TraceContext | None = None

    def close(self) -> None:
        self._sock.close()

    def __enter__(self) -> "BridgeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ── plumbing ───────────────────────────────────────────────────────

    def _call(self, opcode: int, payload: bytes = b"") -> P.Cursor:
        self._sock.sendall(P.encode_frame(opcode, payload))
        status, cursor = P.read_frame(self._sock)
        if status != P.STATUS_OK:
            message = ""
            try:
                message = cursor.string()
            except ValueError:
                pass
            raise BridgeError(status, message)
        return cursor

    # ── API ────────────────────────────────────────────────────────────

    @staticmethod
    def _suffix(trace: TraceContext | None) -> bytes:
        """Explicit ``trace=`` wins; otherwise the ambient context (if
        any); empty bytes keep the frame byte-identical to the old wire."""
        return P.encode_trace_context(
            trace if trace is not None else current_context()
        )

    def ping(self) -> int:
        return self._call(P.OP_PING).u32()

    def add_peer(self, private_key: bytes | None = None) -> tuple[int, bytes]:
        """Returns (peer_id, identity bytes)."""
        key = private_key or b""
        cursor = self._call(P.OP_ADD_PEER, P.u8(len(key)) + key)
        peer_id = cursor.u32()
        identity = cursor.raw(cursor.u8())
        return peer_id, identity

    def create_proposal(
        self,
        peer: int,
        scope: str,
        now: int,
        name: str,
        payload: bytes,
        expected_voters: int,
        rel_expiration: int,
        liveness_yes: bool = True,
        trace: TraceContext | None = None,
    ) -> tuple[int, bytes]:
        """Returns (proposal_id, proposal protobuf bytes); the proposal's
        bound trace context lands in :attr:`last_trace_context`."""
        cursor = self._call(
            P.OP_CREATE_PROPOSAL,
            P.u32(peer)
            + P.string(scope)
            + P.u64(now)
            + P.string(name)
            + P.blob(payload)
            + P.u32(expected_voters)
            + P.u64(rel_expiration)
            + P.u8(1 if liveness_yes else 0)
            + self._suffix(trace),
        )
        pid, blob = cursor.u32(), cursor.blob()
        self.last_trace_context = P.read_trace_context(cursor)
        return pid, blob

    def cast_vote(
        self,
        peer: int,
        scope: str,
        pid: int,
        choice: bool,
        now: int,
        trace: TraceContext | None = None,
    ) -> bytes:
        """Returns the signed Vote protobuf bytes for gossiping; the
        proposal's bound trace context lands in :attr:`last_trace_context`."""
        cursor = self._call(
            P.OP_CAST_VOTE,
            P.u32(peer)
            + P.string(scope)
            + P.u32(pid)
            + P.u8(1 if choice else 0)
            + P.u64(now)
            + self._suffix(trace),
        )
        blob = cursor.blob()
        self.last_trace_context = P.read_trace_context(cursor)
        return blob

    def process_proposal(
        self,
        peer: int,
        scope: str,
        proposal: bytes,
        now: int,
        trace: TraceContext | None = None,
    ) -> None:
        self._call(
            P.OP_PROCESS_PROPOSAL,
            P.u32(peer)
            + P.string(scope)
            + P.u64(now)
            + P.blob(proposal)
            + self._suffix(trace),
        )

    def process_vote(
        self,
        peer: int,
        scope: str,
        vote: bytes,
        now: int,
        trace: TraceContext | None = None,
    ) -> None:
        self._call(
            P.OP_PROCESS_VOTE,
            P.u32(peer)
            + P.string(scope)
            + P.u64(now)
            + P.blob(vote)
            + self._suffix(trace),
        )

    # Soft ceiling per PROCESS_VOTES frame, comfortably under the server's
    # 64 MiB MAX_FRAME; larger batches are chunked transparently.
    _VOTE_FRAME_BUDGET = 8 * 1024 * 1024

    def process_votes(
        self,
        peer: int,
        scope: str,
        votes: list[bytes],
        now: int,
        trace: TraceContext | None = None,
    ) -> list[int]:
        """Batch delivery: one frame (chunked past ~8 MiB), per-vote
        StatusCode list back in batch order (0 OK / 28 ALREADY_REACHED are
        successes; 241 marks an undecodable blob; others are rejections)."""
        statuses: list[int] = []
        start = 0
        while start < len(votes):
            size = 0
            stop = start
            while stop < len(votes) and (
                size + len(votes[stop]) + 4 <= self._VOTE_FRAME_BUDGET
                or stop == start
            ):
                size += len(votes[stop]) + 4
                stop += 1
            chunk = votes[start:stop]
            payload = [P.u32(peer), P.string(scope), P.u64(now), P.u32(len(chunk))]
            payload.extend(P.blob(v) for v in chunk)
            payload.append(self._suffix(trace))
            cursor = self._call(P.OP_PROCESS_VOTES, b"".join(payload))
            statuses.extend(cursor.raw(cursor.u32()))
            start = stop
        return statuses

    def handle_timeout(
        self,
        peer: int,
        scope: str,
        pid: int,
        now: int,
        trace: TraceContext | None = None,
    ) -> bool:
        cursor = self._call(
            P.OP_HANDLE_TIMEOUT,
            P.u32(peer)
            + P.string(scope)
            + P.u32(pid)
            + P.u64(now)
            + self._suffix(trace),
        )
        return bool(cursor.u8())

    def get_result(self, peer: int, scope: str, pid: int) -> bool | None:
        """True/False once decided, None while active; raises on failed."""
        cursor = self._call(P.OP_GET_RESULT, P.u32(peer) + P.string(scope) + P.u32(pid))
        value = cursor.u8()
        if value == P.RESULT_UNDECIDED:
            return None
        if value == P.RESULT_FAILED:
            raise error_for_code(int(StatusCode.CONSENSUS_FAILED))()
        return value == P.RESULT_YES

    def poll_events(self, peer: int, max_events: int | None = None):
        """Drain the peer's pending consensus events in ONE frame.

        ``max_events=None`` (the old wire form) returns the full drained
        ``list[BridgeEvent]``. With a bound — the gossip fabric's event
        pump, which must not let one hot peer monopolize a poll window —
        the request carries a trailing ``u32`` and the reply a trailing
        ``more`` flag: returns ``(events, more)``, where ``more`` means
        the bound stopped the drain and another poll should follow
        immediately (requires a ``FEATURE_EVENT_BOUND`` server; old
        servers ignore the extra bytes and drain fully, so the caller
        sees ``more=False`` with a possibly over-bound list)."""
        payload = P.u32(peer)
        if max_events is not None:
            payload += P.u32(max_events)
        cursor = self._call(P.OP_POLL_EVENTS, payload)
        events = []
        for _ in range(cursor.u32()):
            scope = cursor.string()
            kind = cursor.u8()
            pid = cursor.u32()
            result = bool(cursor.u8())
            ts = cursor.u64()
            events.append(BridgeEvent(scope, kind, pid, result, ts))
        if max_events is None:
            return events
        more = bool(cursor.u8()) if cursor.remaining() >= 1 else False
        return events, more

    def get_proposal(self, peer: int, scope: str, pid: int) -> bytes:
        return self._call(
            P.OP_GET_PROPOSAL, P.u32(peer) + P.string(scope) + P.u32(pid)
        ).blob()

    def get_stats(self, peer: int, scope: str) -> tuple[int, int, int, int]:
        """(total, active, failed, reached)."""
        cursor = self._call(P.OP_GET_STATS, P.u32(peer) + P.string(scope))
        return cursor.u32(), cursor.u32(), cursor.u32(), cursor.u32()

    def explain(self, peer: int, scope: str, pid: int) -> dict:
        """Decision provenance for one proposal (``OP_EXPLAIN``): the
        accepted vote chain with per-peer contributions, the quorum
        arithmetic (required votes, yes/no/silent counts, decision rule),
        lifecycle timeline, distributed-trace identity, and — for durable
        peers — the WAL LSN watermark. Raises the usual wire-mapped
        errors (e.g. SESSION_NOT_FOUND) for unknown proposals."""
        cursor = self._call(
            P.OP_EXPLAIN, P.u32(peer) + P.string(scope) + P.u32(pid)
        )
        return json.loads(cursor.blob().decode("utf-8"))

    def health(self, peer: int, now: int | None = None) -> dict:
        """Consensus-health snapshot for one peer (``OP_HEALTH``):
        per-peer scorecards with derived ``healthy | suspect | faulty``
        grades, the retained self-authenticating equivocation/fork
        evidence (verbatim signed vote bytes, hex), liveness-watchdog
        state, and the firing alert rules — plus the WAL watermark for
        durable peers. ``now`` is the embedder's logical tick for
        staleness grading (omit to use the server monitor's latest)."""
        cursor = self._call(
            P.OP_HEALTH, P.u32(peer) + P.u64(now if now is not None else 0)
        )
        return json.loads(cursor.blob().decode("utf-8"))

    def sync_manifest(self, peer: int, max_chunk_bytes: int = 0) -> dict:
        """State-sync snapshot manifest for a durable peer
        (``OP_SYNC_MANIFEST``): the snapshot's identity (``snapshot_id``),
        its WAL ``watermark`` LSN, transfer geometry (``total_bytes``,
        ``chunk_bytes``, ``chunk_count``), item counts, and per-chunk
        SHA-256 ``digests``. ``max_chunk_bytes`` caps the server's chunk
        size (0 = server default). Raises BridgeError(241) for
        undurable peers."""
        return parse_sync_manifest(
            self._call(P.OP_SYNC_MANIFEST, P.u32(peer) + P.u32(max_chunk_bytes))
        )

    def sync_chunk(self, peer: int, snapshot_id: int, index: int) -> bytes:
        """One snapshot chunk (``OP_SYNC_CHUNK``). Raises
        BridgeError(``P.STATUS_SYNC_STALE``) when the identified snapshot
        is no longer served — re-fetch the manifest and resume from the
        chunks already verified."""
        return self._call(
            P.OP_SYNC_CHUNK, P.u32(peer) + P.u64(snapshot_id) + P.u32(index)
        ).blob()

    def wal_tail(
        self, peer: int, after_lsn: int, max_bytes: int = 0
    ) -> "tuple[list[tuple[int, int, bytes]], bool]":
        """WAL records after ``after_lsn`` (``OP_WAL_TAIL``): returns
        ``(records, more)`` with records as ``(lsn, kind, payload)`` in
        log order; ``more`` means the server's byte budget stopped the
        read short — loop with ``after_lsn`` advanced to the last
        received LSN."""
        cursor = self._call(
            P.OP_WAL_TAIL, P.u32(peer) + P.u64(after_lsn) + P.u32(max_bytes)
        )
        records = []
        for _ in range(cursor.u32()):
            lsn = cursor.u64()
            kind = cursor.u8()
            records.append((lsn, kind, cursor.blob()))
        return records, bool(cursor.u8())

    def get_metrics(self) -> str:
        """Prometheus text-format scrape of the server process's metrics
        registry (server-wide — no peer id). The same text the HTTP
        sidecar's ``/metrics`` serves, for embedders that only hold the
        bridge wire."""
        return self._call(P.OP_GET_METRICS).blob().decode("utf-8")

    def metrics_pull(self) -> dict:
        """Raw metric-federation frame (``OP_METRICS_PULL``, server-wide):
        ``{"host": <label>, "state": <mergeable registry state>, "slo":
        <SLO engine state>}``. Unlike :meth:`get_metrics` this is the
        UNRENDERED registry (non-cumulative histogram buckets, exemplars)
        — the input ``parallel.rollup.merge_metric_states`` sums across
        hosts into one fleet-wide scrape."""
        return json.loads(self._call(P.OP_METRICS_PULL).blob().decode("utf-8"))

    def profile(self) -> "dict | None":
        """Wall-clock attribution frame (``OP_PROFILE``, server-wide):
        ``{"host": <label>, "profile": <attribution report>}`` — stage
        busy shares, reactor dispatch counters, and the continuous
        profiler's sampled per-role stack summary. Host-labelled so
        ``parallel.rollup.merge_profile_states`` can federate frames.
        Returns None against an old peer (STATUS_UNKNOWN_OPCODE — the
        HELLO interop discipline: absence of the plane, not a fault)."""
        try:
            return json.loads(self._call(P.OP_PROFILE).blob().decode("utf-8"))
        except BridgeError as exc:
            if exc.status == P.STATUS_UNKNOWN_OPCODE:
                return None
            raise

    def state_fingerprint(self, peer: int) -> str:
        """The peer engine's order-insensitive content digest
        (``OP_STATE_FINGERPRINT``; see ``sync.state_fingerprint``) — two
        peers are state-identical iff their fingerprints match."""
        return self._call(P.OP_STATE_FINGERPRINT, P.u32(peer)).string()

    def fleet_tally(self, peer: int) -> "dict[int, int]":
        """The peer engine's slot-state histogram (``OP_FLEET_TALLY``) as
        {state_code: count}. Against a federation host this is the whole
        local fleet's tally — the frame a driver sums across hosts when
        the backend lacks cross-process collectives."""
        return P.parse_fleet_tally(self._call(P.OP_FLEET_TALLY, P.u32(peer)))

    def hello(self, features: int | None = None) -> int:
        """Feature negotiation (``OP_HELLO``); returns the granted bits.
        The default offer deliberately EXCLUDES ``FEATURE_PIPELINING``:
        this client reads one response per request, and a granted
        pipelining bit switches the connection to tagged frames it does
        not speak — use :class:`PipelinedBridgeClient` for that. An old
        server answers UNKNOWN_OPCODE, reported here as 0 (no features),
        after which this connection continues exactly as before."""
        if features is None:
            features = P.SUPPORTED_FEATURES & ~P.FEATURE_PIPELINING
        if features & P.FEATURE_PIPELINING:
            raise ValueError(
                "BridgeClient cannot negotiate FEATURE_PIPELINING "
                "(tagged frames); use PipelinedBridgeClient"
            )
        try:
            cursor = self._call(
                P.OP_HELLO, P.u32(P.PROTOCOL_VERSION) + P.u32(features)
            )
        except BridgeError as exc:
            if exc.status == P.STATUS_UNKNOWN_OPCODE:
                return 0
            raise
        cursor.u32()  # server protocol version (1)
        return cursor.u32()

    def deliver_proposals(
        self, peer: int, items: "list[tuple[str, bytes]]", now: int
    ) -> list[int]:
        """Anti-entropy delivery (``OP_DELIVER_PROPOSALS``): create-or-
        extend each ``(scope, proposal wire bytes)`` along the engine's
        validated-chain watermark. Returns per-item StatusCode values
        (0 OK = created or suffix-extended; 21 PROPOSAL_ALREADY_EXIST =
        benign redelivery; 241 = undecodable blob). Requires a
        ``FEATURE_DELIVER`` server."""
        cursor = self._call(
            P.OP_DELIVER_PROPOSALS,
            P.encode_deliver_proposals(peer, items, now),
        )
        return list(cursor.raw(cursor.u32()))


# ── Shared response parsers (serial client, pipelined client, gossip
#    transport — one home for each payload's field walk) ───────────────


def parse_sync_manifest(cursor: P.Cursor) -> dict:
    """Field walk of an ``OP_SYNC_MANIFEST`` OK response."""
    manifest = {
        "snapshot_id": cursor.u64(),
        "watermark": cursor.u64(),
        "total_bytes": cursor.u64(),
        "chunk_bytes": cursor.u32(),
        "session_count": cursor.u32(),
        "config_count": cursor.u32(),
    }
    count = cursor.u32()
    manifest["chunk_count"] = count
    manifest["digests"] = [cursor.raw(32) for _ in range(count)]
    return manifest


def parse_status_list(cursor: P.Cursor) -> list[int]:
    """``u32 count + count status bytes`` (PROCESS_VOTES / VOTE_BATCH /
    DELIVER_PROPOSALS responses)."""
    return list(cursor.raw(cursor.u32()))


class MappedFuture:
    """A :class:`concurrent.futures.Future` view whose ``result()``
    applies a parse function to the resolved cursor. The underlying
    future resolves to the response payload cursor (or raises
    :class:`BridgeError` / :class:`BridgeConnectionLost`)."""

    __slots__ = ("_future", "_fn")

    def __init__(self, future: Future, fn):
        self._future = future
        self._fn = fn

    def result(self, timeout: float | None = None):
        return self._fn(self._future.result(timeout))

    def exception(self, timeout: float | None = None):
        return self._future.exception(timeout)

    def done(self) -> bool:
        return self._future.done()

    def add_done_callback(self, fn) -> None:
        self._future.add_done_callback(lambda _f: fn(self))


class PipelinedBridgeClient:
    """A bridge connection with many requests in flight.

    On connect it sends ``OP_HELLO``; a new server grants
    ``FEATURE_PIPELINING`` and the connection switches to tagged frames —
    :meth:`submit` then returns immediately with a future, a background
    reader matches responses to futures by correlation id (responses may
    complete out of order), and ``max_inflight`` bounds the outstanding
    window (submit blocks — natural backpressure — when the server falls
    behind). Against an OLD server (HELLO answered UNKNOWN_OPCODE) every
    call degrades to the serial one-frame-at-a-time exchange and
    :meth:`submit` returns an already-resolved future, so callers write
    one code path and interoperate both ways; :attr:`pipelined` says
    which mode the connection landed in.

    If the connection drops with requests in flight, every pending
    future raises :class:`BridgeConnectionLost`.

    ``reconnect`` (a :class:`ReconnectPolicy`; default None = the old
    stay-dead behavior) opts into auto-reconnect: when the connection
    dies, pending futures still fail typed, but a background thread
    re-dials with capped, jittered exponential backoff and re-runs the
    HELLO negotiation, after which new submits flow again — the healing
    a crash-restarting server needs without embedder plumbing. Submits
    issued while the channel is down fail fast with
    :class:`BridgeConnectionLost` (callers retry; nothing queues against
    a dead peer).

    Not thread-safe for concurrent submitters by design EXCEPT
    :meth:`submit`/the async helpers, which take the writer lock; the
    sync convenience wrappers just await their own future.
    """

    def __init__(
        self,
        host: str,
        port: int,
        timeout: float = 10.0,
        *,
        max_inflight: int = 256,
        features: int = P.SUPPORTED_FEATURES,
        reconnect: "ReconnectPolicy | None" = None,
    ):
        self._host = host
        self._port = port
        self._timeout = timeout
        self._offered = features
        self._reconnect = reconnect
        self._shutdown = False  # user called close(); never resurrect
        self._closed = True
        self._features = 0
        self._write_lock = threading.Lock()
        self._pending: dict[int, Future] = {}
        self._pending_lock = threading.Lock()
        self._next_corr = 0
        # ONE window for the client's lifetime: credits released by the
        # old connection's cleanup must be the same tokens new submits
        # acquire, or a reconnect could over-release the semaphore.
        self._window = threading.BoundedSemaphore(max_inflight)
        self._reader: threading.Thread | None = None
        self._reconnector: threading.Thread | None = None
        self._establish()

    def _establish(self) -> None:
        """Dial + HELLO + (when granted) start the reader — the shared
        path of the constructor and every reconnect attempt."""
        sock = socket.create_connection(
            (self._host, self._port), timeout=self._timeout
        )
        P.tune_socket(sock)
        features = 0
        try:
            # HELLO handshake runs in the plain one-frame framing; only a
            # granted pipelining bit switches the connection.
            sock.sendall(
                P.encode_frame(
                    P.OP_HELLO,
                    P.u32(P.PROTOCOL_VERSION) + P.u32(self._offered),
                )
            )
            status, cursor = P.read_frame(sock)
            if status == P.STATUS_OK:
                cursor.u32()  # server protocol version
                features = cursor.u32()
            elif status != P.STATUS_UNKNOWN_OPCODE:
                message = ""
                try:
                    message = cursor.string()
                except ValueError:
                    pass
                raise BridgeError(status, message)
        except BaseException:
            sock.close()
            raise
        with self._pending_lock:
            # A close() racing a reconnect attempt must not be undone by
            # a late _establish: once shutdown is set, refuse the fresh
            # socket instead of resurrecting the client.
            if self._shutdown:
                sock.close()
                raise BridgeConnectionLost("client closed during reconnect")
            self._sock = sock
            self._features = features
            self.pipelined = bool(features & P.FEATURE_PIPELINING)
            if self.pipelined:
                # The reader blocks in recv for the connection's
                # lifetime; close() unblocks it by shutting the socket
                # down.
                self._sock.settimeout(None)
                self._reader = threading.Thread(
                    target=self._read_loop, daemon=True,
                    name="bridge-pipelined-reader",
                )
                self._reader.start()
            # Open for submits only once the connection is fully set up.
            self._closed = False

    @property
    def features(self) -> int:
        """Feature bits the server granted (0 against an old server)."""
        return self._features

    def _spawn_reconnector(self) -> None:
        """Start (at most one) background reconnect loop, if opted in and
        the death was not a user close()."""
        if self._reconnect is None or self._shutdown:
            return
        with self._pending_lock:
            if self._reconnector is not None and self._reconnector.is_alive():
                return
            thread = threading.Thread(
                target=self._reconnect_loop, daemon=True,
                name="bridge-reconnector",
            )
            self._reconnector = thread
        thread.start()

    def _reconnect_loop(self) -> None:
        policy = self._reconnect
        for attempt in range(policy.max_attempts):
            time.sleep(policy.delay(attempt))
            if self._shutdown:
                return
            try:
                self._establish()
            except (ConnectionError, OSError, BridgeError):
                continue
            flight_recorder.record(
                "bridge.reconnected",
                host=self._host, port=self._port, attempt=attempt + 1,
            )
            return
        flight_recorder.record(
            "bridge.reconnect_failed",
            host=self._host, port=self._port, attempts=policy.max_attempts,
        )

    def close(self) -> None:
        self._shutdown = True
        self._closed = True
        # Two sweeps: the first closes the current socket and waits out
        # the reconnector; a reconnect attempt that raced the shutdown
        # flag may have installed a fresh socket/reader in between, so
        # the second sweep (after the reconnector is provably done —
        # _establish refuses once _shutdown is set) closes that one too.
        for _ in range(2):
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            if self._reader is not None:
                self._reader.join(timeout=5)
            if self._reconnector is not None:
                self._reconnector.join(timeout=5)

    def __enter__(self) -> "PipelinedBridgeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ── plumbing ───────────────────────────────────────────────────────

    def submit(self, opcode: int, payload: bytes = b"") -> Future:
        """Send one request; the future resolves to the response payload
        cursor on STATUS_OK, or raises :class:`BridgeError` (non-OK) /
        :class:`BridgeConnectionLost` (connection died first). In serial
        fallback mode the exchange happens inline and the returned
        future is already resolved."""
        future: Future = Future()
        if not self.pipelined:
            if self._closed:
                future.set_exception(
                    BridgeConnectionLost("bridge connection is down")
                )
                return future
            try:
                with self._write_lock:
                    self._sock.sendall(P.encode_frame(opcode, payload))
                    status, cursor = P.read_frame(self._sock)
            except (ConnectionError, OSError) as exc:
                self._closed = True
                future.set_exception(
                    BridgeConnectionLost(f"bridge connection lost: {exc}")
                )
                self._spawn_reconnector()
                return future
            if status == P.STATUS_OK:
                future.set_result(cursor)
            else:
                future.set_exception(BridgeError(status, _error_message(cursor)))
            return future
        # Window credit: bounds client-side memory AND stops a runaway
        # submitter from ballooning the server's per-connection queue.
        self._window.acquire()
        with self._pending_lock:
            if self._closed:
                self._window.release()
                future.set_exception(
                    BridgeConnectionLost("client closed with request unsent")
                )
                return future
            corr = self._next_corr
            self._next_corr = (corr + 1) & 0xFFFFFFFF
            self._pending[corr] = future
        try:
            with self._write_lock:
                self._sock.sendall(P.encode_tagged_frame(opcode, corr, payload))
        except (ConnectionError, OSError) as exc:
            # The reader may have noticed the death first and already
            # failed (and released the window for) every pending future,
            # this one included — only the side that POPS the entry owns
            # its release + exception, so neither is ever doubled.
            with self._pending_lock:
                owned = self._pending.pop(corr, None) is not None
            if owned:
                self._window.release()
                future.set_exception(
                    BridgeConnectionLost(f"bridge connection lost: {exc}")
                )
        return future

    def _read_loop(self) -> None:
        try:
            while True:
                status, corr, cursor = P.read_tagged_frame(self._sock)
                with self._pending_lock:
                    future = self._pending.pop(corr, None)
                if future is None:
                    continue  # cancelled/unknown id: drop, keep reading
                self._window.release()
                if status == P.STATUS_OK:
                    future.set_result(cursor)
                else:
                    future.set_exception(
                        BridgeError(status, _error_message(cursor))
                    )
        except (ConnectionError, OSError, ValueError) as exc:
            with self._pending_lock:
                pending = list(self._pending.values())
                self._pending.clear()
                self._closed = True
            lost = BridgeConnectionLost(
                "bridge connection lost with "
                f"{len(pending)} requests in flight: {exc}"
            )
            for future in pending:
                self._window.release()
                future.set_exception(lost)
            self._spawn_reconnector()

    def call(self, opcode: int, payload: bytes = b"") -> P.Cursor:
        """Blocking :meth:`submit` (one round trip in either mode)."""
        return self.submit(opcode, payload).result(self._timeout)

    # ── async API (futures) ────────────────────────────────────────────

    def ping_async(self) -> MappedFuture:
        return MappedFuture(self.submit(P.OP_PING), lambda c: c.u32())

    def process_votes_async(
        self, peer: int, scope: str, votes: list[bytes], now: int
    ) -> MappedFuture:
        """One OP_PROCESS_VOTES frame in flight; resolves to the per-vote
        status list (no transparent chunking — the coalescer owns frame
        sizing on the fabric path)."""
        payload = [P.u32(peer), P.string(scope), P.u64(now), P.u32(len(votes))]
        payload.extend(P.blob(v) for v in votes)
        return MappedFuture(
            self.submit(P.OP_PROCESS_VOTES, b"".join(payload)),
            parse_status_list,
        )

    def vote_batch_async(
        self, now: int, groups: "list[tuple[int, str, list[bytes]]]"
    ) -> MappedFuture:
        """One coalesced columnar ``OP_VOTE_BATCH`` frame (requires
        ``FEATURE_VOTE_BATCH``); resolves to the flattened status list."""
        return MappedFuture(
            self.submit(P.OP_VOTE_BATCH, P.encode_vote_batch(now, groups)),
            parse_status_list,
        )

    def deliver_proposals_async(
        self, peer: int, items: "list[tuple[str, bytes]]", now: int
    ) -> MappedFuture:
        return MappedFuture(
            self.submit(
                P.OP_DELIVER_PROPOSALS,
                P.encode_deliver_proposals(peer, items, now),
            ),
            parse_status_list,
        )

    # ── sync conveniences (setup traffic; same wire as BridgeClient) ───

    def ping(self) -> int:
        return self.ping_async().result(self._timeout)

    def add_peer(self, private_key: bytes | None = None) -> tuple[int, bytes]:
        key = private_key or b""
        cursor = self.call(P.OP_ADD_PEER, P.u8(len(key)) + key)
        peer_id = cursor.u32()
        return peer_id, cursor.raw(cursor.u8())

    def create_proposal(
        self,
        peer: int,
        scope: str,
        now: int,
        name: str,
        payload: bytes,
        expected_voters: int,
        rel_expiration: int,
        liveness_yes: bool = True,
    ) -> tuple[int, bytes]:
        cursor = self.call(
            P.OP_CREATE_PROPOSAL,
            P.u32(peer)
            + P.string(scope)
            + P.u64(now)
            + P.string(name)
            + P.blob(payload)
            + P.u32(expected_voters)
            + P.u64(rel_expiration)
            + P.u8(1 if liveness_yes else 0),
        )
        return cursor.u32(), cursor.blob()

    def process_proposal(
        self, peer: int, scope: str, proposal: bytes, now: int
    ) -> None:
        self.call(
            P.OP_PROCESS_PROPOSAL,
            P.u32(peer) + P.string(scope) + P.u64(now) + P.blob(proposal),
        )

    def process_votes(
        self, peer: int, scope: str, votes: list[bytes], now: int
    ) -> list[int]:
        return self.process_votes_async(peer, scope, votes, now).result(
            self._timeout
        )

    def deliver_proposals(
        self, peer: int, items: "list[tuple[str, bytes]]", now: int
    ) -> list[int]:
        return self.deliver_proposals_async(peer, items, now).result(
            self._timeout
        )

    def sync_manifest(self, peer: int, max_chunk_bytes: int = 0) -> dict:
        return parse_sync_manifest(
            self.call(P.OP_SYNC_MANIFEST, P.u32(peer) + P.u32(max_chunk_bytes))
        )


def _error_message(cursor: P.Cursor) -> str:
    try:
        return cursor.string()
    except ValueError:
        return ""
