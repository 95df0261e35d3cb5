"""Embedder bridge server: the framework's consensus surface over TCP.

Port of the JAX package's ``bridge/server.py`` over the port's engine.
One :class:`BridgeServer` hosts many independent *peers*; each peer is a
:class:`~hashgraph_tpu_torch.engine.TorchConsensusEngine` with its own signer and
event subscription — the same one-service-per-peer unit the reference
deploys (reference: src/service.rs:26-29, README.md:120-171). A non-Python
embedder (see ``native/bridge_client.c``) ferries the protobuf
``Proposal``/``Vote`` bytes between peers exactly the way the reference's
host application ferries prost messages between its services
(reference: README.md:183-197, tests/network_gossip_tests.rs:20-152).

The server binds loopback by default: it is an in-machine FFI boundary, not
a network service — transport security is the embedder's job, as in the
reference's no-I/O contract (reference: src/lib.rs:15-34).

The wire is the JAX package's, byte for byte: a client of either package
(or ``native/bridge_client.c``) talks to a server of either. The one
constructor argument the JAX server lacks is ``device``: the engines this
server builds hold their pools on it (``"cuda"`` by default, raising
without a GPU; ``"cpu"`` on request).
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from struct import error as struct_error

import numpy as np

from ..engine import TorchConsensusEngine, VerifiedVoteCache
from ..engine.pool import resolve_device
from ..errors import ConsensusError
from ..events import BroadcastEventBus, EventReceiver
from ..obs import (
    BRIDGE_ERRORS_TOTAL,
    BRIDGE_REQUESTS_TOTAL,
    BRIDGE_RETRY_AFTER_TOTAL,
    SHM_RINGS_ATTACHED_TOTAL,
    SYNC_CHUNKS_SENT_TOTAL,
    WIRE_APPLY_SECONDS_TOTAL,
    WIRE_COLUMNAR_FRAMES_TOTAL,
    WIRE_CRYPTO_SECONDS_TOTAL,
    WIRE_DECODE_SECONDS_TOTAL,
    WIRE_FALLBACK_FRAMES_TOTAL,
    HealthMonitor,
    MetricsSidecar,
    flight_recorder,
)
from ..obs import registry as default_registry
from ..obs import slo_engine as default_slo_engine
from ..obs.profiler import maybe_start_default as maybe_start_profiler
from ..obs.trace import trace_store, use_context
from ..parallel.fleet import ShardRecoveringError
from ..signing import ConsensusSignatureScheme
from ..signing.ethereum import EthereumConsensusSigner
from ..types import (
    ConsensusEvent,
    ConsensusFailedEvent,
    ConsensusReached,
    CreateProposalRequest,
)
from ..wire import Proposal, Vote
from . import protocol as P
from .reactor import ApplyReactor, reactor_enabled


class _Peer:
    def __init__(self, peer_id: int, engine: TorchConsensusEngine, receiver: EventReceiver):
        self.peer_id = peer_id
        self.engine = engine
        self.receiver = receiver


class _SerialLane:
    """Per-connection in-order execution lane over a shared pool: jobs
    run one at a time in submission order, but on pool threads so the
    connection's reader keeps draining frames. State-mutating opcodes on
    a pipelined connection go through this — pipelining removes the
    round-trip stall WITHOUT reordering a vote stream's chain links."""

    __slots__ = ("_pool", "_jobs", "_lock", "_active")

    def __init__(self, pool: ThreadPoolExecutor):
        self._pool = pool
        self._jobs: deque = deque()
        self._lock = threading.Lock()
        self._active = False

    def depth(self) -> int:
        """Queued jobs plus the one running — the overload-admission
        signal (server answers STATUS_RETRY_AFTER past its limit)."""
        with self._lock:
            return len(self._jobs) + (1 if self._active else 0)

    def submit(self, job) -> None:
        with self._lock:
            self._jobs.append(job)
            if self._active:
                return
            self._active = True
        try:
            self._pool.submit(self._drain)
        except RuntimeError:
            # Pool shutting down (server stop): run inline on the
            # connection thread — jobs still execute exactly once, in
            # order, before the connection unwinds.
            self._drain()

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._jobs:
                    self._active = False
                    return
                job = self._jobs.popleft()
            try:
                job()
            except Exception:  # pragma: no cover - job() handles its own
                pass


class _WireFramePrep:
    """One prepared OP_VOTE_BATCH frame on the columnar fast path: the
    decoded views plus per-peer row groups, each with its validation
    prepass already in flight on the verify pool."""

    __slots__ = ("view", "per_peer")

    def __init__(self, view, per_peer):
        self.view = view
        self.per_peer = per_peer


class _ConnState:
    """Per-connection pipelining state (created on HELLO upgrade)."""

    __slots__ = (
        "write_lock", "inflight", "ordered", "shm_running",
        "reactor_lock", "reactor_frames", "reactor_rows", "reactor_handles",
    )

    def __init__(self, pool: ThreadPoolExecutor, max_inflight: int):
        self.write_lock = threading.Lock()
        # Bounds concurrently-dispatched frames per connection: when the
        # window is full the reader blocks HERE instead of queueing
        # unboundedly — TCP backpressure does the rest.
        self.inflight = threading.BoundedSemaphore(max_inflight)
        self.ordered = _SerialLane(pool)
        # Flipped off when the owning TCP connection unwinds: the shm
        # serving thread (if any) watches it and exits.
        self.shm_running = True
        # Apply-reactor bookkeeping: frames/rows this connection has
        # queued into reactor windows but not yet had applied — the
        # overload-admission shed counts them (a full window must not
        # bypass admission control), and the handle deque is the
        # ordering barrier other mutating opcodes wait on.
        self.reactor_lock = threading.Lock()
        self.reactor_frames = 0
        self.reactor_rows = 0
        self.reactor_handles: deque = deque()


# Opcodes that execute in receive order on a pipelined connection; the
# set lives in protocol.py because the client transport's lane routing
# must agree with it (see MUTATING_OPCODES there for the rationale).
_ORDERED_OPCODES = P.MUTATING_OPCODES

# Reader-thread verdict: "_vote_batch_prepare already ran and chose the
# object fallback (a non-canonical row)" — the serial lane goes straight
# to the object path instead of re-decoding + re-parsing the frame just
# to reach the same conclusion. Distinct from None, which means "not
# attempted" (no reader prepass) or "prepare raised" (the lane re-runs
# the decode so the wire error contract answers with the exact message).
_PREP_FALLBACK = object()


@contextlib.contextmanager
def _traced(name: str, ctx, peer_id: int):
    """Activate a frame's trace context around its engine call and record
    the bridge dispatch itself as a child span (no-op for untraced
    frames, so the old wire stays zero-cost)."""
    if ctx is None or not trace_store.enabled:
        yield
        return
    start = time.time()
    with use_context(ctx):
        try:
            yield
        finally:
            trace_store.record(
                name,
                ctx.child(),
                start,
                time.time() - start,
                parent=ctx.span_id,
                peer=f"bridge:{peer_id}",
            )


class BridgeServer:
    """Threaded TCP front-end over per-peer consensus engines.

    ``port=0`` binds an ephemeral port (read it back from :attr:`address`).
    ``engine_factory(signer)`` swaps the backing engine; the default builds
    a small single-GPU engine per peer on ``device`` (``"cuda"``, which
    needs a visible GPU, or ``"cpu"``).

    ``metrics_port`` (None = off, 0 = ephemeral) attaches an HTTP sidecar
    serving ``/metrics`` (Prometheus text format over the process-wide
    registry) and ``/healthz`` (JSON: running + peer count) for the
    server's lifetime; read the bound port from :attr:`metrics_address`.
    The ``GET_METRICS`` opcode serves the identical text over the bridge
    wire itself, sidecar or not.

    ``verify_cache`` ("shared" default) gives every default-built peer
    engine ONE :class:`~hashgraph_tpu_torch.engine.VerifiedVoteCache`, so a vote
    gossiped to N co-hosted peers is signature-verified once per process;
    its hit/miss/evict counters land on the registry above.

    ``health_monitor`` (default: one fresh
    :class:`~hashgraph_tpu_torch.obs.HealthMonitor` per server) collects every
    default-built peer engine's scorecards/evidence/alerts; firing
    critical rules flip ``/healthz`` to 503 and the ``OP_HEALTH`` opcode
    serves the full snapshot (``BridgeClient.health``).
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        capacity: int = 256,
        voter_capacity: int = 16,
        engine_factory=None,
        wal_dir: str | None = None,
        wal_fsync: str = "batch",
        metrics_port: int | None = None,
        metrics_host: str = "127.0.0.1",
        verify_cache: "VerifiedVoteCache | None | str" = "shared",
        health_monitor: "HealthMonitor | None" = None,
        signer_factory: type | None = None,
        pipeline_workers: int | None = None,
        max_inflight_per_connection: int = 256,
        ordered_admission_limit: int | None = None,
        wire_columnar: "bool | None" = None,
        apply_reactor: "bool | ApplyReactor | None" = None,
        host_label: str | None = None,
        device="cuda",
    ):
        # The default engines' device: no silent move to the CPU, which the
        # caller asks for. A factory builds its own engines.
        if engine_factory is None:
            resolve_device(device)
        self._device = device
        self._host = host
        self._port = port
        # Identity stamped on OP_METRICS_PULL frames: federation merges
        # per-host registry states under this label (default: the bound
        # host:port once the listener is up).
        self.host_label = host_label
        self._capacity = capacity
        self._voter_capacity = voter_capacity
        self._engine_factory = engine_factory
        # Scheme the ADD_PEER opcode mints signers from (all peers on a
        # network must share one scheme, reference src/signing.rs:46-74):
        # any ConsensusSignatureScheme class with ``random()`` and a
        # 32-byte-key constructor works — EthereumConsensusSigner
        # (default, the reference's scheme) or Ed25519ConsensusSigner
        # (batch-verified; the state-sync/catch-up benches use it).
        self._signer_factory = (
            signer_factory if signer_factory is not None
            else EthereumConsensusSigner
        )
        # ONE admission cache for every peer engine this server builds
        # ("shared", the default): co-hosted peers receive the same
        # gossiped votes, so a vote is ECDSA-verified once per server
        # process instead of once per peer. Pass an instance to share it
        # wider (or size it), or None to disable caching. Engines from
        # ``engine_factory`` manage their own cache.
        if isinstance(verify_cache, str) and verify_cache != "shared":
            # An unknown string would propagate into every peer engine and
            # crash each one at its first ingest — reject it here.
            raise ValueError(
                'verify_cache must be "shared", a VerifiedVoteCache, or None'
            )
        self._verify_cache = (
            VerifiedVoteCache() if verify_cache == "shared" else verify_cache
        )
        # ONE health monitor for every default-built peer engine: the
        # scorecards, evidence log, and /healthz verdict describe THIS
        # server's peers, not whatever other engines share the process
        # (the engine's process-wide default monitor would bleed an
        # unrelated engine's faulty peer into this server's 503). Anomaly
        # counters still land on the process-wide registry. Engines from
        # ``engine_factory`` keep whatever monitor they were built with.
        # Gauges are registered only for a monitor this server built —
        # a caller-passed monitor owns its own registration (it may
        # already be registered; providers are additive, so a second
        # registration would double its gauge contributions).
        if health_monitor is not None:
            self._health_monitor = health_monitor
        else:
            self._health_monitor = HealthMonitor(registry=default_registry)
            self._health_monitor.register_gauges(default_registry)
        # Durability: with a wal_dir every peer's engine is wrapped in a
        # DurableEngine logging each incoming wire message BEFORE its ack
        # frame is sent (the response is only written after the handler —
        # and therefore the WAL append — returns). Peer logs are keyed by
        # signer identity, which is stable across restarts for key-carrying
        # ADD_PEER calls, so re-adding the same key replays the peer's log.
        self._wal_dir = wal_dir
        self._wal_fsync = wal_fsync
        # identity -> live DurableEngine for this run: one WalWriter per
        # directory, ever. Re-adding a key reuses the open engine instead
        # of opening a second writer on the same segment files (which
        # would interleave duplicate LSNs and corrupt watermark skipping
        # on the next restart). _durable_gates serializes same-identity
        # creation without holding the server-wide lock through recovery;
        # _recovery keeps each identity's ReplayStats for the embedder.
        self._durable: dict[bytes, object] = {}
        self._durable_gates: dict[bytes, threading.Lock] = {}
        self._recovery: dict[bytes, object] = {}
        self._peers: dict[int, _Peer] = {}
        self._next_peer = 1
        self._lock = threading.Lock()
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._connections: set[socket.socket] = set()
        self._handlers: set[threading.Thread] = set()
        self._running = False
        # Observability: /metrics + /healthz HTTP sidecar (metrics_port
        # 0 = ephemeral, None = no sidecar; the GET_METRICS opcode serves
        # the same text over the bridge wire regardless).
        self._metrics_port = metrics_port
        self._metrics_host = metrics_host
        self._sidecar: MetricsSidecar | None = None
        self._m_requests = default_registry.counter(BRIDGE_REQUESTS_TOTAL)
        self._m_errors = default_registry.counter(BRIDGE_ERRORS_TOTAL)
        self._m_retry_after = default_registry.counter(BRIDGE_RETRY_AFTER_TOTAL)
        # State sync: per-peer cached snapshot (manifest, file path),
        # rebuilt when the peer's WAL position (or the requested chunk
        # geometry) moves. ``_sync_lock`` guards only the cache dict and
        # the id counter; per-peer gates serialize builds so one peer's
        # multi-second snapshot capture never stalls another peer's
        # manifest or chunk traffic. Snapshot ids are unique PER BUILD
        # (never reused across rebuilds, even at an unchanged watermark),
        # so a client holding a stale manifest always gets
        # STATUS_SYNC_STALE rather than chunks from a different artifact.
        self._sync_cache: dict[int, tuple[object, str]] = {}
        self._sync_gates: dict[int, threading.Lock] = {}
        self._sync_lock = threading.Lock()
        self._sync_seq = 0
        self._m_sync_chunks = default_registry.counter(SYNC_CHUNKS_SENT_TOTAL)
        # Pipelined dispatch: one shared worker pool for every upgraded
        # connection (HELLO + FEATURE_PIPELINING). Read-only frames run
        # concurrently on it; mutating frames run through a per-connection
        # _SerialLane so a pipelined vote stream applies in receive order.
        # max_inflight_per_connection bounds dispatched-but-unanswered
        # frames per connection (the reader blocks past it).
        if pipeline_workers is None:
            pipeline_workers = min(8, (os.cpu_count() or 2) + 2)
        self._pipeline_workers = max(1, pipeline_workers)
        self._max_inflight = max(1, max_inflight_per_connection)
        # Overload admission for mutating frames on pipelined/shm
        # connections: past this serial-lane depth the server answers
        # STATUS_RETRY_AFTER (depth-derived backoff hint) instead of
        # queueing deeper. Defaults just under the inflight window so
        # shedding fires BEFORE the semaphore wedges the reader thread.
        self._admission_limit = max(
            1,
            ordered_admission_limit
            if ordered_admission_limit is not None
            else self._max_inflight * 3 // 4,
        )
        self._pipeline_pool: ThreadPoolExecutor | None = None
        # Zero-copy wire ingest: OP_VOTE_BATCH frames whose rows all parse
        # strict-canonical land as numpy columns on ingest_wire_columnar
        # (full validation, no per-vote Python objects); anything else —
        # and engines without the columnar entry point — takes the object
        # path, which stays the parity oracle. Default on; force off with
        # wire_columnar=False or HASHGRAPH_TPU_WIRE_COLUMNAR=0 (the CI
        # fallback leg runs the smoke that way).
        if wire_columnar is None:
            wire_columnar = os.environ.get(
                "HASHGRAPH_TPU_WIRE_COLUMNAR", "1"
            ) != "0"
        self._wire_columnar = bool(wire_columnar)
        self._m_wire_columnar = default_registry.counter(
            WIRE_COLUMNAR_FRAMES_TOTAL
        )
        self._m_wire_fallback = default_registry.counter(
            WIRE_FALLBACK_FRAMES_TOTAL
        )
        self._m_wire_decode_s = default_registry.counter(
            WIRE_DECODE_SECONDS_TOTAL
        )
        self._m_wire_crypto_s = default_registry.counter(
            WIRE_CRYPTO_SECONDS_TOTAL
        )
        self._m_wire_apply_s = default_registry.counter(
            WIRE_APPLY_SECONDS_TOTAL
        )
        self._m_shm_attached = default_registry.counter(
            SHM_RINGS_ATTACHED_TOTAL
        )
        # Apply reactor (cross-connection continuous batching): validated
        # columnar vote frames from ALL connections and lanes merge into
        # per-engine micro-windows, one fused device dispatch each —
        # amortizing the fixed kernel launch + readback cost the per-frame
        # dispatches pay. Off by default (construction-compatible escape
        # hatch); turn on with apply_reactor=True, an ApplyReactor
        # instance (custom windowing), or HASHGRAPH_TPU_APPLY_REACTOR=1.
        # start() runs its flusher thread; an embedded server leaves it
        # in manual mode (inline, deterministic flush per dispatch).
        if isinstance(apply_reactor, ApplyReactor):
            self._reactor: "ApplyReactor | None" = apply_reactor
        elif reactor_enabled(apply_reactor):
            self._reactor = ApplyReactor()
        else:
            self._reactor = None
        if self._reactor is not None and self._reactor._on_stage is None:
            self._reactor._on_stage = self._note_reactor_stage
        # Live shm ring pairs: (rx, tx) per serving thread, torn down on
        # stop() and when the owning TCP connection closes.
        self._shm_rings: "set[tuple[object, object]]" = set()

    # ── lifecycle ──────────────────────────────────────────────────────

    @property
    def address(self) -> tuple[str, int]:
        if self._listener is None:
            raise RuntimeError("server not started")
        return self._listener.getsockname()[:2]

    @property
    def metrics_address(self) -> tuple[str, int]:
        """(host, port) of the HTTP metrics sidecar (requires
        ``metrics_port`` and a started server)."""
        if self._sidecar is None:
            raise RuntimeError("metrics sidecar not running")
        return self._sidecar.address

    def _health(self) -> dict:
        """``/healthz`` body: liveness plus the consensus-health verdict.
        Every distinct health monitor behind the peer engines (one, when
        the default process-wide monitor is shared; several, when an
        engine_factory supplies private ones) is evaluated; firing
        CRITICAL rules — signed misbehavior like an equivocating peer —
        flip ``ok`` to false, which the sidecar serves as 503, with the
        machine-readable reasons alongside so the balancer's operator
        sees *why* without a second query. Warnings ride along in
        ``alerts`` without degrading."""
        with self._lock:
            peers = len(self._peers)
            # The server's own monitor always participates (it exists
            # before the first ADD_PEER); engine_factory-built engines
            # may carry different monitors — aggregate the distinct set.
            monitors = {id(self._health_monitor): self._health_monitor}
            for peer in self._peers.values():
                monitor = getattr(peer.engine, "health", None)
                if monitor is not None:
                    monitors[id(monitor)] = monitor
        alerts: list[dict] = []
        for monitor in monitors.values():
            try:
                alerts.extend(monitor.evaluate_alerts())
            except Exception:
                # A broken rule must degrade the report, not the scrape.
                continue
        reasons = [
            {
                "rule": alert["rule"],
                "severity": alert["severity"],
                "description": alert.get("description", ""),
                "details": alert.get("details", []),
            }
            for alert in alerts
            if alert.get("severity") == "critical"
        ]
        out = {
            "ok": self._running and not reasons,
            "peers": peers,
            "alerts": alerts,
        }
        if reasons:
            out["reasons"] = reasons
        return out

    def start_embedded(self) -> None:
        """Serve frames in-process through :meth:`dispatch_frame` without
        binding a listener or starting any thread. Same dispatch table,
        same per-peer engines, same WAL/recovery machinery as the TCP
        front-end — this is the deterministic cluster simulator's mode
        (the JAX package's ``sim``): every byte still crosses the wire
        codec and the live validation paths, but scheduling is entirely
        the caller's, so a run can be a pure function of its seed.
        ``stop()`` quiesces an embedded server exactly as a started one
        (durable peer WALs flushed and closed, peers evicted)."""
        if self._running:
            raise RuntimeError("server already started")
        self._running = True

    def dispatch_frame(self, opcode: int, payload: bytes = b"") -> tuple[int, bytes]:
        """Dispatch ONE decoded frame (opcode + payload bytes) through
        the live handler table and return ``(status, response payload)``
        — the socketless request/response unit the embedded mode serves.
        The wire's error contract applies (ConsensusError -> status code,
        malformed payloads -> STATUS_BAD_REQUEST), identical to what a
        TCP client would read back."""
        if not self._running:
            raise RuntimeError("server not started")
        self._m_requests.inc()
        flight_recorder.record("bridge.op", opcode=opcode)
        status, out = self._safe_dispatch(opcode, P.Cursor(payload))
        if status >= P.STATUS_UNKNOWN_PEER:
            self._m_errors.inc()
        return status, out

    def start(self) -> tuple[str, int]:
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self._host, self._port))
        listener.listen(16)
        self._listener = listener
        self._running = True
        if self._metrics_port is not None:
            try:
                self._sidecar = MetricsSidecar(
                    default_registry,
                    host=self._metrics_host,
                    port=self._metrics_port,
                    health_fn=self._health,
                )
                self._sidecar.start()
            except Exception:
                # A sidecar bind failure (port in use) must not leave a
                # half-started server holding the bridge listener: in the
                # `with BridgeServer(...)` pattern a raising __enter__
                # never reaches __exit__/stop().
                self._sidecar = None
                self._running = False
                self._listener = None
                try:
                    listener.close()
                except OSError:
                    pass
                raise
        self._pipeline_pool = ThreadPoolExecutor(
            max_workers=self._pipeline_workers,
            thread_name_prefix="bridge-pipeline",
        )
        if self._reactor is not None:
            self._reactor.start()
        # Always-on stack sampling, $HASHGRAPH_TPU_PROFILE=1 opt-in (the
        # reactor's env-gate pattern): every serving process gets the
        # continuous-profiling loop without per-embedder wiring. The
        # process-wide instance is idempotent across servers.
        maybe_start_profiler()
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()
        return self.address

    def stop(self) -> None:
        """Quiesce the bridge: no new connections, live connections closed.
        After stop() returns no further frames mutate the peer engines."""
        self._running = False
        if self._listener is not None:
            # shutdown() wakes the accept loop's blocked accept() at once;
            # close() alone leaves it blocked until the join times out.
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            connections = list(self._connections)
        for conn in connections:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        self._teardown_shm(None)
        # Join in-flight handlers: a dispatch that was already running keeps
        # the engine lock until it finishes; only after this loop is the
        # "no further frames mutate the peer engines" guarantee true.
        with self._lock:
            handlers = list(self._handlers)
        for thread in handlers:
            thread.join(timeout=5)
        # Pipelined frames that were already dispatched finish on the pool
        # before the engines are considered quiesced (their responses go
        # to closed sockets, which is fine — sendall just fails).
        if self._pipeline_pool is not None:
            self._pipeline_pool.shutdown(wait=True)
            self._pipeline_pool = None
        # Reactor drains AFTER the lanes (no new enqueues) and BEFORE the
        # durable engines close: every queued window either applies or
        # finishes its handles with the shutdown error — nothing mutates
        # a closed WAL, and no waiter is stranded.
        if self._reactor is not None:
            self._reactor.stop()
        # Flush + close the per-identity WALs, then evict those engines and
        # the peers built on them: a closed WalWriter can never append
        # again, so a restarted server must rebuild each durable engine
        # (re-recovering from its log on the next ADD_PEER) rather than
        # hand out the closed one. Undecorated engines hold no file
        # handles; their peers survive a stop()/start() cycle unchanged.
        with self._lock:
            durable = list(self._durable.values())
            self._durable.clear()
            # Stats and gates die with the engines they described: a stale
            # ReplayStats surviving into the next start() would report a
            # previous incarnation's recovery as the current one's.
            self._recovery.clear()
            self._durable_gates.clear()
            closed = {id(engine) for engine in durable}
            for peer_id in [
                pid for pid, p in self._peers.items() if id(p.engine) in closed
            ]:
                del self._peers[peer_id]
        for engine in durable:
            engine.close()
        # Served snapshots die with the server: the files live under the
        # peers' WAL directories and would otherwise accumulate one stale
        # artifact per incarnation.
        with self._sync_lock:
            sync_paths = [path for _, path in self._sync_cache.values()]
            self._sync_cache.clear()
            self._sync_gates.clear()
        for path in sync_paths:
            try:
                os.remove(path)
            except OSError:
                pass
        if self._sidecar is not None:
            self._sidecar.stop()
            self._sidecar = None

    def __enter__(self) -> "BridgeServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ── connection handling ────────────────────────────────────────────

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            threading.Thread(
                target=self._serve_connection,
                args=(conn,),
                # Named so the continuous profiler's role table can
                # attribute reader-thread samples (obs.profiler).
                name="bridge-reader",
                daemon=True,
            ).start()

    def _serve_connection(self, conn: socket.socket) -> None:
        with self._lock:
            self._connections.add(conn)
            self._handlers.add(threading.current_thread())
        try:
            self._serve_frames(conn)
        finally:
            self._teardown_shm(conn)
            with self._lock:
                self._connections.discard(conn)
                self._handlers.discard(threading.current_thread())
            try:
                conn.close()
            except OSError:
                pass

    def _serve_frames(self, conn: socket.socket) -> None:
        P.tune_socket(conn)  # TCP_NODELAY: small-frame request wire
        state: _ConnState | None = None  # non-None once pipelining upgraded
        while self._running:
            try:
                if state is None:
                    opcode, cursor = P.read_frame(conn)
                    corr = 0
                else:
                    opcode, corr, cursor = P.read_tagged_frame(conn)
            except (ConnectionError, OSError):
                return
            except ValueError:
                try:
                    conn.sendall(P.encode_frame(P.STATUS_BAD_REQUEST))
                except OSError:
                    pass
                return
            if not self._running:
                return
            self._m_requests.inc()
            flight_recorder.record("bridge.op", opcode=opcode)
            if opcode == P.OP_HELLO:
                granted = self._handle_hello(conn, cursor, state, corr)
                if granted is None:
                    return  # write failed; connection is dead
                if state is None and granted & P.FEATURE_PIPELINING:
                    pool = self._pipeline_pool
                    if pool is not None:
                        state = _ConnState(pool, self._max_inflight)
                continue
            if state is not None and opcode == P.OP_SHM_ATTACH:
                if not self._handle_shm_attach(conn, state, corr, cursor):
                    return  # write failed; connection is dead
                continue
            if state is None:
                status, payload = self._safe_dispatch(opcode, cursor)
                if status >= P.STATUS_UNKNOWN_PEER:
                    self._m_errors.inc()
                try:
                    conn.sendall(P.encode_frame(status, payload))
                except OSError:
                    return
            else:
                self._dispatch_pipelined(conn, state, opcode, corr, cursor)

    def _handle_hello(
        self, conn, cursor: P.Cursor, state: "_ConnState | None", corr: int
    ) -> int | None:
        """Negotiate features; answer in the connection's CURRENT framing
        (the mode only switches after the grant is on the wire). Returns
        the granted bits, or None when the response write failed."""
        try:
            cursor.u32()  # client protocol version (1; reserved)
            offered = cursor.u32()
        except ValueError:
            offered = 0
        granted = offered & P.SUPPORTED_FEATURES
        if self._pipeline_pool is None:
            granted &= ~P.FEATURE_PIPELINING  # not started / stopping
        payload = P.u32(P.PROTOCOL_VERSION) + P.u32(granted)
        try:
            if state is None:
                conn.sendall(P.encode_frame(P.STATUS_OK, payload))
            else:
                # Re-HELLO on an upgraded connection: answer tagged; the
                # connection stays pipelined (no downgrade path).
                with state.write_lock:
                    conn.sendall(
                        P.encode_tagged_frame(P.STATUS_OK, corr, payload)
                    )
        except OSError:
            return None
        return granted

    def _handle_shm_attach(
        self, conn, state: _ConnState, corr: int, cursor: P.Cursor
    ) -> bool:
        """Map the client's ring pair and serve tagged frames from it on
        a dedicated thread (``OP_SHM_ATTACH``; pipelined connections
        only). Any failure answers a typed error — the client keeps the
        TCP lane and simply never upgrades. Returns False only when the
        response write failed (connection dead)."""
        status, message = P.STATUS_OK, b""
        rings = None
        rx = None
        try:
            cursor.u32()  # ring_bytes (informative)
            c2s = cursor.string()
            s2c = cursor.string()
            from ..gossip.shm import ShmRing, shm_available

            if not shm_available():
                raise ValueError("shared memory unavailable on this host")
            rx = ShmRing.attach(c2s)
            tx = ShmRing.attach(s2c)
            rings = (rx, tx)
        except (ValueError, OSError) as exc:
            if rx is not None:  # c2s attached but s2c failed: unmap it
                rx.close()
            status, message = P.STATUS_BAD_REQUEST, P.string(str(exc))
        try:
            with state.write_lock:
                conn.sendall(P.encode_tagged_frame(status, corr, message))
        except OSError:
            if rings is not None:
                for ring in rings:
                    ring.close()
            return False
        if rings is None:
            return True
        thread = threading.Thread(
            target=self._serve_shm_ring,
            args=(conn, state, rings[0], rings[1]),
            daemon=True,
            name="bridge-shm",
        )
        # Registered and started under one lock: a stop() racing the
        # attach (its reply is already sent) tears down only started
        # threads. The JAX package's server starts the thread after the
        # lock, and its stop() reaches the teardown 5 s later.
        with self._lock:
            self._shm_rings.add((conn, state, rings[0], rings[1], thread))
            thread.start()
        self._m_shm_attached.inc()
        flight_recorder.record("bridge.shm_attach", c2s=c2s, s2c=s2c)
        return True

    def _serve_shm_ring(self, conn, state: _ConnState, rx, tx) -> None:
        """Reader loop for one attached ring pair: the byte stream is
        the same tagged frame stream TCP carries, parsed incrementally
        and dispatched through the connection's pipelining state (same
        serial lane — vote order is preserved across lanes per opcode
        stream; the client routes each request to exactly one lane).
        Responses go back through the tx ring."""
        from ..gossip.shm import ShmSpin

        spin = ShmSpin()
        tx_lock = threading.Lock()
        buf = bytearray()
        while self._running and state.shm_running:
            try:
                chunk = rx.read_available()
            except (OSError, ValueError):
                return  # ring closed under us (teardown)
            if chunk is None:
                spin.wait()
                continue
            spin.hit()
            buf += chunk
            try:
                frames = P.split_frames(buf, min_len=5)
            except ValueError:
                # Stream integrity gone: the ring can never recover its
                # framing, so kill the WHOLE connection — the TCP reader
                # unblocks, its cleanup tears the rings down, and the
                # client sees a typed connection loss (then falls back /
                # reconnects). Stopping just this reader would leave the
                # client writing into a ring nobody drains.
                flight_recorder.record("bridge.shm_bad_frame")
                state.shm_running = False
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                return
            for body in frames:
                self._dispatch_shm_frame(body, conn, state, tx, tx_lock)

    def _dispatch_shm_frame(
        self, body: bytes, conn, state: _ConnState, tx, tx_lock
    ) -> None:
        opcode, corr, cursor = P.parse_frame(body, tagged=True)
        self._m_requests.inc()
        flight_recorder.record("bridge.op", opcode=opcode)
        if self._shed_retry_after(conn, state, opcode, corr):
            return
        state.inflight.acquire()
        prep = self._try_vote_batch_prepare(opcode, cursor)

        def send(status: int, payload: bytes) -> None:
            frame = P.encode_tagged_frame(status, corr, payload)
            if len(frame) > tx.capacity:
                # The ring can NEVER carry this response: answer on
                # the TCP control lane instead (the client matches
                # responses by corr id across lanes). Spinning on
                # try_write would hold tx_lock forever and wedge
                # every later response on the connection.
                try:
                    with state.write_lock:
                        conn.sendall(frame)
                except OSError:
                    pass  # connection died; nothing to answer to
                return
            with tx_lock:
                # Response ring full: the client is the sole drainer
                # and responses are small — wait briefly rather than
                # drop a response (a lost response hangs a future).
                try:
                    while not tx.try_write([frame], len(frame)):
                        if not (self._running and state.shm_running):
                            return
                        time.sleep(0.0005)
                except ValueError:
                    return  # ring closed under us (teardown race)

        if self._reactor_eligible(opcode, prep):
            state.ordered.submit(
                lambda: self._vote_batch_enqueue(prep, state, send)
            )
            return

        def run() -> None:
            try:
                status, payload = self._safe_dispatch(opcode, cursor, prep)
                if status >= P.STATUS_UNKNOWN_PEER:
                    self._m_errors.inc()
                send(status, payload)
            finally:
                state.inflight.release()

        if opcode in _ORDERED_OPCODES:
            state.ordered.submit(self._barriered(state, run))
        else:
            pool = self._pipeline_pool
            if pool is None:
                run()
                return
            try:
                pool.submit(run)
            except RuntimeError:
                run()

    def _teardown_shm(self, conn) -> None:
        """Stop and unmap every ring pair attached to ``conn`` (or all
        of them when ``conn`` is None — server stop)."""
        with self._lock:
            mine = [
                entry for entry in self._shm_rings
                if conn is None or entry[0] is conn
            ]
            self._shm_rings.difference_update(mine)
        for _conn, state, rx, tx, thread in mine:
            state.shm_running = False
            thread.join(timeout=2)
            rx.close()
            tx.close()

    def _safe_dispatch(
        self, opcode: int, cursor: P.Cursor, vote_prep=None
    ) -> tuple[int, bytes]:
        """_dispatch with the wire's error contract applied (one home for
        the serial loop and the pipelined workers)."""
        try:
            return self._dispatch(opcode, cursor, vote_prep)
        except Exception as exc:
            return self._map_dispatch_error(opcode, exc)

    def _map_dispatch_error(self, opcode: int, exc: Exception) -> tuple[int, bytes]:
        """The wire's error contract as a value mapping: also applied to
        engine failures surfacing from a reactor dispatch, whose response
        is written by a completion callback instead of _safe_dispatch."""
        if isinstance(exc, ConsensusError):
            return int(exc.code), P.string(str(exc))
        if isinstance(exc, ShardRecoveringError):
            # A federation host's shard frozen mid-migration (or mid-
            # recovery): typed retry-after on the wire instead of an
            # internal error — the sender backs off and replays, so a
            # migration window never drops votes.
            retry = getattr(exc, "retry_after", 1.0)
            return P.STATUS_SHARD_MIGRATING, P.string(f"{retry}")
        if isinstance(exc, (ValueError, KeyError, struct_error)):
            flight_recorder.record(
                "bridge.bad_request", opcode=opcode, error=str(exc)
            )
            return P.STATUS_BAD_REQUEST, P.string(str(exc))
        # Dispatch blew up unexpectedly (a peer engine died, a bug):
        # preserve the ring for the postmortem before answering.
        flight_recorder.record(
            "bridge.dispatch_error", opcode=opcode, error=repr(exc)
        )
        flight_recorder.dump("bridge-dispatch-error")
        return P.STATUS_INTERNAL, P.string(repr(exc))

    def _shed_retry_after(
        self, conn, state: _ConnState, opcode: int, corr: int
    ) -> bool:
        """Overload admission for one mutating frame: when the
        connection's serial lane is at the admission limit, answer
        STATUS_RETRY_AFTER (backoff hint in seconds, scaled to the depth
        the sender would be queueing behind) and drop the frame —
        nothing is applied, so the sender defers the scopes to
        anti-entropy instead of stacking work the lane cannot reach.
        The answer rides the TCP control lane even for shm frames
        (clients match responses by corr id across lanes). Returns True
        when the frame was shed.

        With the apply reactor on, frames the lane already handed to a
        window are *queued work the sender is stacking up* even though
        the lane itself is empty — they (and their rows) count toward
        the depth signal, so a full window cannot silently bypass
        admission control."""
        if opcode not in _ORDERED_OPCODES:
            return False
        depth = state.ordered.depth()
        reactor_rows = 0
        if self._reactor is not None:
            with state.reactor_lock:
                depth += state.reactor_frames
                reactor_rows = state.reactor_rows
        if depth < self._admission_limit:
            return False
        self._m_retry_after.inc()
        flight_recorder.record(
            "bridge.retry_after", opcode=opcode, depth=depth
        )
        # ~1ms of lane work per queued frame is the drain-time model
        # (queued reactor rows drain vectorized — ~64 rows per frame-
        # equivalent); bounded so a backlog never hints minutes.
        retry = min(1.0, depth / 1000.0 + reactor_rows / 64000.0)
        try:
            with state.write_lock:
                conn.sendall(
                    P.encode_tagged_frame(
                        P.STATUS_RETRY_AFTER, corr, P.string(f"{retry}")
                    )
                )
        except OSError:
            pass  # connection died; nothing to answer to
        return True

    def _try_vote_batch_prepare(self, opcode: int, cursor: P.Cursor):
        """3-stage wire pipeline, stage 1: vote-batch frames parse AND
        submit their crypto on the calling (reader) thread — GIL-free
        native parse, async verify-pool submit — so by the time the
        serial lane reaches the frame, its signatures are already
        verified or in flight while the previous frame's device apply
        runs. Returns the prepass, ``_PREP_FALLBACK`` when the parse
        chose the object path (a non-canonical row), or ``None`` when
        the lane should re-decode from scratch (not a vote batch /
        columnar off / parse raised — the lane answers the exact wire
        error). One home for both the TCP and shm reader threads."""
        if opcode != P.OP_VOTE_BATCH or not self._wire_columnar:
            return None
        try:
            return self._vote_batch_prepare(cursor.fork()) or _PREP_FALLBACK
        except Exception:
            return None  # lane re-decodes and answers the exact error

    # ── Apply reactor (cross-connection continuous batching) ───────────

    @property
    def reactor(self) -> "ApplyReactor | None":
        """The server's apply reactor, or None when disabled."""
        return self._reactor

    def _note_reactor_stage(self, stage: dict) -> None:
        """Stage-attribution hook a reactor dispatch reports through —
        the same wire crypto/apply counters the reactor-off path feeds,
        so GET_METRICS attribution stays comparable either way."""
        crypto = stage.get("crypto", 0.0)
        if crypto:
            self._m_wire_crypto_s.inc(crypto)
        apply_s = stage.get("apply", 0.0)
        if apply_s:
            self._m_wire_apply_s.inc(apply_s)

    def _reactor_eligible(self, opcode: int, prep) -> bool:
        """True when a pipelined/shm frame takes the asynchronous
        reactor path: a columnar-prepared OP_VOTE_BATCH on a server with
        the reactor on. Everything else keeps today's lane semantics."""
        return (
            self._reactor is not None
            and opcode == P.OP_VOTE_BATCH
            and prep is not None
            and prep is not _PREP_FALLBACK
        )

    def _barriered(self, state: _ConnState, run):
        """Wrap a serial-lane job so it waits for the connection's
        pending reactor windows first. With the reactor on, a lane job
        that mutates engine state directly (ADD_PEER, object-path vote
        frames, POLL_EVENTS, ...) must not run ahead of vote frames the
        lane already handed to a window — receive order is the
        contract. No-op (and no wrapper) with the reactor off."""
        if self._reactor is None:
            return run

        def job() -> None:
            self._reactor_barrier(state)
            run()

        return job

    def _reactor_barrier(self, state: _ConnState) -> None:
        """Flush and wait out every reactor window holding this
        connection's enqueued frames (serial lane only, so the deque
        holds exactly the frames received before the barrier)."""
        if self._reactor is None:
            return
        with state.reactor_lock:
            if not state.reactor_handles:
                return
            handles = list(state.reactor_handles)
            state.reactor_handles.clear()
        self._reactor.flush()
        for handle in handles:
            try:
                handle.wait(30.0)
            except Exception:
                pass  # the frame's own response carries its error

    def _vote_batch_enqueue(self, prep, state: _ConnState, send) -> None:
        """Serial-lane half of the reactor path for ONE pipelined/shm
        OP_VOTE_BATCH frame: re-resolve peers in receive order, enqueue
        each columnar entry into its engine's open window, and RETURN —
        the lane moves on while windows accumulate frames from every
        connection. The last entry's completion callback assembles the
        per-row statuses and writes the response; unknown peers and
        object-path engines resolve inline exactly as the reactor-off
        apply does."""
        reactor = self._reactor
        view = prep.view
        statuses = bytearray(view.total)
        out = np.frombuffer(statuses, np.uint8)
        pending: list = []
        try:
            for entry in prep.per_peer:
                rows = entry["rows"]
                peer = self._peers.get(entry["peer_id"])
                if peer is None:
                    out[rows] = P.STATUS_UNKNOWN_PEER
                    continue
                engine = peer.engine
                if not hasattr(engine, "ingest_wire_columnar"):
                    self._apply_rows_objects(engine, entry, view, out)
                    continue
                prepass = (
                    entry["prepass"] if engine is entry["engine"] else None
                )
                pending.append((engine, entry, prepass))
        except Exception as exc:
            status, payload = self._map_dispatch_error(P.OP_VOTE_BATCH, exc)
            self._m_errors.inc()
            send(status, payload)
            state.inflight.release()
            return
        if not pending:
            self._m_wire_columnar.inc()
            send(P.STATUS_OK, P.u32(view.total) + bytes(statuses))
            state.inflight.release()
            return
        join = {"left": len(pending), "error": None}
        join_lock = threading.Lock()
        frame_rows = int(view.total)
        with state.reactor_lock:
            state.reactor_frames += 1
            state.reactor_rows += frame_rows

        def finish(handle, rows) -> None:
            error = handle.error
            if error is None:
                out[rows] = (
                    np.asarray(handle.codes, np.int64) & 0xFF
                ).astype(np.uint8)
            with join_lock:
                if error is not None and join["error"] is None:
                    join["error"] = error
                join["left"] -= 1
                if join["left"]:
                    return
            with state.reactor_lock:
                state.reactor_frames -= 1
                state.reactor_rows -= frame_rows
            error = join["error"]
            if error is None:
                self._m_wire_columnar.inc()
                send(P.STATUS_OK, P.u32(view.total) + bytes(statuses))
            else:
                status, payload = self._map_dispatch_error(
                    P.OP_VOTE_BATCH, error
                )
                self._m_errors.inc()
                send(status, payload)
            state.inflight.release()

        for engine, entry, prepass in pending:
            handle = reactor.submit(
                engine,
                entry["scopes"],
                entry["sidx"],
                entry["cols"],
                entry["data"],
                entry["offsets"],
                view.now,
                prepass=prepass,
                on_done=(lambda h, r=entry["rows"]: finish(h, r)),
            )
            with state.reactor_lock:
                # The deque is the barrier other mutating opcodes wait
                # on; prune settled handles so a vote-only connection
                # never accumulates them unboundedly.
                while (
                    state.reactor_handles and state.reactor_handles[0].done
                ):
                    state.reactor_handles.popleft()
                state.reactor_handles.append(handle)

    def _dispatch_pipelined(
        self,
        conn: socket.socket,
        state: _ConnState,
        opcode: int,
        corr: int,
        cursor: P.Cursor,
    ) -> None:
        """Hand one tagged frame to the worker pool and return to the
        read loop. Mutating opcodes run on the connection's serial lane
        (receive order); read-only opcodes run concurrently, so their
        responses can overtake — the client matches by correlation id."""
        if self._shed_retry_after(conn, state, opcode, corr):
            return
        state.inflight.acquire()  # reader blocks when the window is full
        prep = self._try_vote_batch_prepare(opcode, cursor)

        def send(status: int, payload: bytes) -> None:
            try:
                with state.write_lock:
                    conn.sendall(
                        P.encode_tagged_frame(status, corr, payload)
                    )
            except OSError:
                pass  # connection died; nothing to answer to

        if self._reactor_eligible(opcode, prep):
            # Reactor path: the lane job only ENQUEUES the frame's
            # entries into their engines' open windows and returns — the
            # lane drains ahead while validated work from many
            # connections merges into one fused dispatch. The completion
            # callback writes the response and releases the inflight
            # permit.
            state.ordered.submit(
                lambda: self._vote_batch_enqueue(prep, state, send)
            )
            return

        def run() -> None:
            try:
                status, payload = self._safe_dispatch(opcode, cursor, prep)
                if status >= P.STATUS_UNKNOWN_PEER:
                    self._m_errors.inc()
                send(status, payload)
            finally:
                state.inflight.release()

        if opcode in _ORDERED_OPCODES:
            state.ordered.submit(self._barriered(state, run))
        else:
            pool = self._pipeline_pool
            if pool is None:
                run()
                return
            try:
                pool.submit(run)
            except RuntimeError:
                run()  # pool shut down mid-flight: answer inline

    # ── dispatch ───────────────────────────────────────────────────────

    def _dispatch(
        self, opcode: int, c: P.Cursor, vote_prep=None
    ) -> tuple[int, bytes]:
        if opcode == P.OP_PING:
            return P.STATUS_OK, P.u32(P.PROTOCOL_VERSION)
        if opcode == P.OP_ADD_PEER:
            return self._op_add_peer(c)
        if opcode == P.OP_GET_METRICS:
            # Server-wide (no peer_id): the registry is process-global, so
            # one scrape covers every peer engine plus WAL and bridge.
            return P.STATUS_OK, P.blob(
                default_registry.render_prometheus().encode("utf-8")
            )
        if opcode == P.OP_METRICS_PULL:
            # Server-wide raw metric federation frame: the mergeable
            # registry state + SLO state under this host's label — what a
            # federation driver sums (parallel.rollup.merge_metric_states)
            # into one fleet /metrics + /slo view.
            label = self.host_label
            if label is None:
                try:
                    label = "%s:%d" % (self._host, self.address[1])
                except Exception:
                    label = self._host
            payload = {
                "host": label,
                "state": default_registry.export_state(),
                "slo": default_slo_engine.state(),
            }
            return P.STATUS_OK, P.blob(json.dumps(payload).encode("utf-8"))
        if opcode == P.OP_PROFILE:
            # Server-wide attribution readout (stage busy shares +
            # sampled stacks), host-labelled like OP_METRICS_PULL so
            # merge_profile_states can federate frames across hosts.
            from ..obs.attribution import attribution_report

            label = self.host_label
            if label is None:
                try:
                    label = "%s:%d" % (self._host, self.address[1])
                except Exception:
                    label = self._host
            payload = {"host": label, "profile": attribution_report()}
            return P.STATUS_OK, P.blob(json.dumps(payload).encode("utf-8"))
        if opcode == P.OP_VOTE_BATCH:
            # Multi-peer frame: groups carry their own peer ids.
            return self._op_vote_batch(c, vote_prep)
        handler = _HANDLERS.get(opcode)
        if handler is None:
            return P.STATUS_UNKNOWN_OPCODE, b""
        peer = self._peers.get(c.u32())
        if peer is None:
            return P.STATUS_UNKNOWN_PEER, b""
        return handler(self, peer, c)

    def _op_add_peer(self, c: P.Cursor) -> tuple[int, bytes]:
        keylen = c.u8()
        if keylen == 0:
            signer: ConsensusSignatureScheme = self._signer_factory.random()
        elif keylen == 32:
            signer = self._signer_factory(c.raw(32))
        else:
            return P.STATUS_BAD_REQUEST, P.string("key must be absent or 32 bytes")
        identity = signer.identity()
        # Durability only for key-carrying peers: a keyless ADD_PEER mints a
        # random signer whose identity can never be presented again, so its
        # WAL could never be replayed — wrapping it would only accumulate
        # one dead per-identity directory (plus fsync cost) per ephemeral
        # peer. Keyless peers run undurable by construction.
        if self._wal_dir is not None and keylen == 32:
            engine = self._durable_engine(signer, identity)
        else:
            engine = self._build_engine(signer)
        receiver = engine.event_bus().subscribe()
        with self._lock:
            # stop()'s sweep only evicts peers it can SEE: a registration
            # that lands after the sweep would pin a closed durable engine
            # into the next start(). Refuse instead — the engine itself is
            # either undurable (no handles) or still published in _durable,
            # where the sweep closes it.
            if not self._running:
                raise ValueError("server is stopping")
            peer_id = self._next_peer
            self._next_peer += 1
            self._peers[peer_id] = _Peer(peer_id, engine, receiver)
        return P.STATUS_OK, P.u32(peer_id) + P.u8(len(identity)) + identity

    def _build_engine(self, signer):
        if self._engine_factory is not None:
            return self._engine_factory(signer)
        return TorchConsensusEngine(
            signer,
            event_bus=BroadcastEventBus(),
            capacity=self._capacity,
            voter_capacity=self._voter_capacity,
            device=self._device,
            verify_cache=self._verify_cache,
            health_monitor=self._health_monitor,
        )

    def _durable_engine(self, signer, identity: bytes):
        """Create-or-reuse the durable engine for ``identity``. A
        per-identity gate serializes concurrent ADD_PEERs with the same key
        (two WalWriters on one directory would interleave duplicate LSNs)
        while keeping WAL replay — potentially seconds for a large log —
        off the server-wide lock, so other connections and ADD_PEERs
        proceed during one peer's recovery."""
        import os

        from ..wal import DurableEngine

        with self._lock:
            gate = self._durable_gates.setdefault(identity, threading.Lock())
        with gate:
            with self._lock:
                # Same guard as the publish below: once stop() begins, its
                # sweep owns every published durable engine (and closes
                # it); handing one out here would let a racing ADD_PEER
                # register a peer on an engine that is about to close.
                if not self._running:
                    raise ValueError("server is stopping")
                engine = self._durable.get(identity)
            if engine is not None:
                return engine
            engine = DurableEngine(
                self._build_engine(signer),
                os.path.join(self._wal_dir, "peer-" + identity.hex()),
                fsync_policy=self._wal_fsync,
            )
            # Crash recovery before the peer serves traffic: replay any
            # surviving log from a previous run of this identity. The event
            # subscription happens after, so replayed transitions don't
            # re-surface through OP_POLL_EVENTS. The stats are retained
            # (see recovery_stats) because nonzero segments_dropped /
            # errors means acknowledged records could not be replayed —
            # the embedder should be told, not served silently partial
            # state; replay() itself emits the wal.recover.* counters.
            stats = engine.recover()
            with self._lock:
                # A handler that outlived stop()'s join (recovery of a big
                # log can exceed the 5s timeout) must not publish after the
                # shutdown sweep already cleared _durable — the engine
                # would leak an open WalWriter (flock held until process
                # exit) and its peer could still mutate state after stop()
                # returned. Close and refuse instead.
                if not self._running:
                    engine.close()
                    raise ValueError("server is stopping")
                self._recovery[identity] = stats
                self._durable[identity] = engine
            return engine

    def durable_engine(self, identity: bytes):
        """The live :class:`~hashgraph_tpu_torch.wal.DurableEngine` backing
        ``identity``'s peer (None = identity unknown or not durable).
        Embedders use it for checkpoint scheduling and state-sync
        bookkeeping; tests use it to reach the source engine behind a
        bridged peer."""
        with self._lock:
            return self._durable.get(identity)

    def peer_engine(self, peer_id: int):
        """The engine serving ``peer_id`` (None = unknown peer). Benches
        and fabric smoke tests use it to fingerprint a bridged peer's
        state without going through a durable identity."""
        with self._lock:
            peer = self._peers.get(peer_id)
            return None if peer is None else peer.engine

    def remove_peer(self, peer_id: int) -> None:
        """Unregister a peer WITHOUT closing its engine (the caller owns
        it — the federation's migration source registers a shard engine
        as a temporary sync peer and retires it after the placement
        flip). In-flight requests racing the removal answer
        STATUS_UNKNOWN_PEER, the same as any never-registered id; the
        peer's cached snapshot artifacts (if any) are dropped."""
        with self._lock:
            if self._peers.pop(peer_id, None) is None:
                raise ValueError(f"unknown peer {peer_id}")
        with self._sync_lock:
            cached = self._sync_cache.pop(peer_id, None)
            self._sync_gates.pop(peer_id, None)
        if cached is not None:
            try:
                os.remove(cached[1])
            except OSError:
                pass

    def recovery_stats(self, identity: bytes):
        """:class:`~hashgraph_tpu_torch.wal.ReplayStats` from the WAL recovery
        that backed ``identity``'s engine (None = identity unknown or not
        durable). Nonzero ``segments_dropped`` or ``errors`` means mid-log
        corruption: acknowledged records exist that replay could not
        reproduce."""
        with self._lock:
            return self._recovery.get(identity)

    def _op_create_proposal(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        scope = c.string()
        now = c.u64()
        name = c.string()
        payload = c.blob()
        expected_voters = c.u32()
        rel_expiration = c.u64()
        liveness = bool(c.u8())
        ctx = P.read_trace_context(c)
        request = CreateProposalRequest(
            name=name,
            payload=payload,
            proposal_owner=peer.engine.signer().identity(),
            expected_voters_count=expected_voters,
            expiration_timestamp=rel_expiration,
            liveness_criteria_yes=liveness,
        )
        with _traced("bridge.create_proposal", ctx, peer.peer_id):
            proposal = peer.engine.create_proposal(scope, request, now)
        # Response suffix: the trace the engine bound (root, or child of
        # the request's ctx) — the embedder ferries it with the gossip.
        bound = peer.engine.trace_context_of(scope, proposal.proposal_id)
        return P.STATUS_OK, (
            P.u32(proposal.proposal_id)
            + P.blob(proposal.encode())
            + P.encode_trace_context(bound)
        )

    def _op_cast_vote(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        scope = c.string()
        pid = c.u32()
        choice = bool(c.u8())
        now = c.u64()
        ctx = P.read_trace_context(c)
        with _traced("bridge.cast_vote", ctx, peer.peer_id):
            vote = peer.engine.cast_vote(scope, pid, choice, now)
        bound = peer.engine.trace_context_of(scope, pid)
        return P.STATUS_OK, P.blob(vote.encode()) + P.encode_trace_context(bound)

    def _op_process_proposal(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        scope = c.string()
        now = c.u64()
        proposal = Proposal.decode(c.blob())
        ctx = P.read_trace_context(c)
        with _traced("bridge.process_proposal", ctx, peer.peer_id):
            peer.engine.process_incoming_proposal(scope, proposal, now)
        return P.STATUS_OK, b""

    def _op_process_vote(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        scope = c.string()
        now = c.u64()
        vote = Vote.decode(c.blob())
        ctx = P.read_trace_context(c)
        with _traced("bridge.process_vote", ctx, peer.peer_id):
            peer.engine.process_incoming_vote(scope, vote, now)
        return P.STATUS_OK, b""

    def _op_process_votes(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        """Batch vote delivery: one frame, one engine dispatch, one status
        byte per vote (StatusCode values; OK/ALREADY_REACHED are successes;
        STATUS_BAD_REQUEST marks an undecodable blob without poisoning the
        rest of the batch). This is the embedder's throughput path — the
        scalar opcode costs one round trip per vote."""
        scope = c.string()
        now = c.u64()
        count = c.u32()
        statuses = [P.STATUS_BAD_REQUEST] * count
        decodable: list[tuple[int, Vote]] = []
        for i in range(count):
            blob = c.blob()
            try:
                decodable.append((i, Vote.decode(blob)))
            except (ValueError, IndexError):
                pass  # per-vote 241 already set; the batch proceeds
        ctx = P.read_trace_context(c)
        if decodable:
            with _traced("bridge.process_votes", ctx, peer.peer_id):
                engine_statuses = peer.engine.ingest_votes(
                    [(scope, vote) for _, vote in decodable], now
                )
            for (i, _), status in zip(decodable, engine_statuses):
                statuses[i] = int(status) & 0xFF
        return P.STATUS_OK, P.u32(count) + bytes(statuses)

    # Stage size for a coalesced frame's pipelined ingest: big enough to
    # amortize the per-dispatch fixed cost, small enough that multi-stage
    # frames overlap crypto with apply.
    _PIPELINE_SPLIT = 256

    def _op_vote_batch(
        self, c: P.Cursor, prep: "_WireFramePrep | None" = None
    ) -> tuple[int, bytes]:
        """Coalesced columnar vote frame (``OP_VOTE_BATCH``), two paths:

        - **columnar fast path** (default): the frame decodes to numpy
          views (:func:`protocol.decode_vote_batch_views`), every vote
          row parses strict-canonical into columns
          (:mod:`bridge.columnar` — native, GIL-free when the runtime is
          present), and each peer's rows land on
          :meth:`TorchConsensusEngine.ingest_wire_columnar` — full
          validation, zero per-vote Python objects. A pipelined
          connection's reader thread hands in ``prep`` with the crypto
          already in flight (the 3-stage wire pipeline: transport read,
          verify-pool crypto, serial-lane device apply).
        - **object path** (fallback + parity oracle): any row that is
          malformed or non-canonical, or an engine without the columnar
          entry point, sends the WHOLE frame through the per-vote
          ``Vote.decode`` + ``ingest_votes_pipelined`` path — statuses
          are byte-identical by construction (fuzz-asserted in
          tests/test_wire_fuzz.py).

        Per-vote statuses return in flattened batch order; an
        undecodable blob marks its row 241 and an unknown peer_id marks
        its group's rows STATUS_UNKNOWN_PEER, neither poisoning the
        rest of the frame."""
        if self._wire_columnar:
            if prep is None:
                fallback = c.fork()
                prep = self._vote_batch_prepare(c)
                if prep is None:
                    c = fallback
            if prep is not None and prep is not _PREP_FALLBACK:
                return self._vote_batch_apply(prep)
            self._m_wire_fallback.inc()
        return self._op_vote_batch_objects(c)

    def _op_vote_batch_objects(self, c: P.Cursor) -> tuple[int, bytes]:
        """The object-path ``OP_VOTE_BATCH`` body: per-vote decode into
        ``Vote`` objects, one pipelined engine dispatch per peer
        (:meth:`TorchConsensusEngine.ingest_votes_pipelined` overlaps
        group k+1's signature prepass with group k's apply)."""
        now, groups = P.decode_vote_batch(c)
        total = sum(len(votes) for _, _, votes in groups)
        statuses = bytearray([P.STATUS_BAD_REQUEST]) * total
        # Per engine: ONE flattened batch across all of the peer's groups
        # (ingest_votes handles heterogeneous scopes in one dispatch, and
        # the fixed dispatch cost dominates small batches — merging is a
        # ~3x server-side win over per-group dispatches at 64-vote
        # groups), split into _PIPELINE_SPLIT-vote stages so big frames
        # still overlap stage k+1's signature prepass with stage k's
        # apply. Flattened-in-group-order ≡ per-group sequential calls
        # (ingest_votes applies items strictly in order), so coalescing
        # never reorders a chain. Row indices ride along so statuses land
        # back in flattened frame order.
        per_peer: dict[int, tuple[list[int], list[tuple[str, Vote]]]] = {}
        offset = 0
        for peer_id, scope, votes in groups:
            rows, batch = per_peer.setdefault(peer_id, ([], []))
            for j, blob in enumerate(votes):
                try:
                    batch.append((scope, Vote.decode(blob)))
                    rows.append(offset + j)
                except (ValueError, IndexError):
                    pass  # row already 241
            offset += len(votes)
        for peer_id, (rows, batch) in per_peer.items():
            peer = self._peers.get(peer_id)
            if peer is None:
                for row in rows:
                    statuses[row] = P.STATUS_UNKNOWN_PEER
                continue
            stages = [
                batch[i : i + self._PIPELINE_SPLIT]
                for i in range(0, len(batch), self._PIPELINE_SPLIT)
            ]
            results = peer.engine.ingest_votes_pipelined(stages, now)
            codes = [code for stage in results for code in stage]
            for row, code in zip(rows, codes):
                statuses[row] = int(code) & 0xFF
        return P.STATUS_OK, P.u32(total) + bytes(statuses)

    # ── Zero-copy columnar wire path ───────────────────────────────────

    def _vote_batch_prepare(self, c: P.Cursor) -> "_WireFramePrep | None":
        """Stage 1+2 of the wire pipeline, safe on the READER thread:
        decode the frame to views, parse vote columns (native, GIL-free),
        group rows per peer, and start each peer engine's session-
        independent validation prepass — hash pass + ONE cache-aware
        signature batch submit, running on the verify pool while earlier
        frames still apply on the serial lane. Returns None when any row
        is non-canonical (whole-frame object fallback) and raises the
        object decoder's ``ValueError`` for structurally bad frames (the
        wire contract stays identical). Peer resolution here is only a
        prepass hint — the apply stage re-resolves in receive order, so
        an ADD_PEER queued ahead of this frame still lands first."""
        from . import columnar as WC

        t0 = time.monotonic()
        view = P.decode_vote_batch_views(c)
        cols, flags = WC.parse_vote_columns(view.data, view.offsets)
        if not bool(flags.all()):
            return None
        per_peer: list[dict] = []
        by_peer: dict[int, dict] = {}
        row = 0
        for peer_id, scope, count in view.groups:
            entry = by_peer.get(peer_id)
            if entry is None:
                entry = by_peer[peer_id] = {
                    "peer_id": peer_id,
                    "scopes": [],
                    "scope_of": {},
                    "rows": [],
                    "sidx": [],
                }
                per_peer.append(entry)
            k = entry["scope_of"].get(scope)
            if k is None:
                k = entry["scope_of"][scope] = len(entry["scopes"])
                entry["scopes"].append(scope)
            entry["rows"].extend(range(row, row + count))
            entry["sidx"].extend([k] * count)
            row += count
        single = len(per_peer) == 1
        for entry in per_peer:
            rows = np.asarray(entry["rows"], np.int64)
            entry["rows"] = rows
            entry["sidx"] = np.asarray(entry["sidx"], np.int64)
            if single:
                entry["data"] = view.data
                entry["offsets"] = view.offsets
                entry["cols"] = cols
            else:
                entry["data"], entry["offsets"], entry["cols"] = (
                    self._pack_rows(view, cols, rows)
                )
        self._m_wire_decode_s.inc(time.monotonic() - t0)
        # Prepass start is CRYPTO time (hash pass + cache + batch
        # submit), attributed separately from the wire decode above.
        t1 = time.monotonic()
        for entry in per_peer:
            peer = self._peers.get(entry["peer_id"])
            engine = None if peer is None else peer.engine
            entry["engine"] = engine
            entry["prepass"] = None
            if (
                engine is not None
                and hasattr(engine, "ingest_wire_columnar")
                and hasattr(engine, "wire_verify_begin")
            ):
                entry["prepass"] = engine.wire_verify_begin(
                    entry["data"], entry["cols"], entry["offsets"]
                )
        self._m_wire_crypto_s.inc(time.monotonic() - t1)
        return _WireFramePrep(view, per_peer)

    @staticmethod
    def _pack_rows(view, cols, rows: np.ndarray):
        """Pack a peer's (possibly non-contiguous) rows into one
        contiguous (data, offsets, cols) triple (``columnar.pack_rows``,
        shared with the federation adapter's per-shard packing).
        Multi-peer frames only; a single-peer frame reuses the original
        views copy-free."""
        from . import columnar as WC

        return WC.pack_rows(view.data, view.offsets, cols, rows)

    def _vote_batch_apply(self, prep: "_WireFramePrep") -> tuple[int, bytes]:
        """Stage 3 of the wire pipeline (serial lane, receive order):
        re-resolve each peer and land its rows on
        ``ingest_wire_columnar`` with the prepass the reader started —
        the crypto has been running since. Unknown peers mark their rows
        STATUS_UNKNOWN_PEER; an engine without the columnar entry point
        (custom engine_factory) takes the object path for just its rows
        — peers are independent, so statuses stay per-row exact."""
        view = prep.view
        statuses = bytearray(view.total)
        out = np.frombuffer(statuses, np.uint8)
        stage: dict = {}
        reactor = self._reactor
        waits: list = []
        for entry in prep.per_peer:
            rows = entry["rows"]
            peer = self._peers.get(entry["peer_id"])
            if peer is None:
                out[rows] = P.STATUS_UNKNOWN_PEER
                continue
            engine = peer.engine
            if not hasattr(engine, "ingest_wire_columnar"):
                self._apply_rows_objects(engine, entry, view, out)
                continue
            prepass = (
                entry["prepass"] if engine is entry["engine"] else None
            )
            if reactor is not None:
                # Synchronous reactor path (non-pipelined connections,
                # embedded dispatch_frame): enqueue so rows can merge
                # with whatever the window already holds, flush the
                # engine's window, and wait here. Stage seconds flow
                # through the reactor's on_stage hook instead of the
                # local dict.
                handle = reactor.submit(
                    engine,
                    entry["scopes"],
                    entry["sidx"],
                    entry["cols"],
                    entry["data"],
                    entry["offsets"],
                    view.now,
                    prepass=prepass,
                )
                reactor.flush(engine)
                waits.append((handle, rows))
                continue
            codes = engine.ingest_wire_columnar(
                entry["scopes"],
                entry["sidx"],
                entry["cols"],
                entry["data"],
                entry["offsets"],
                view.now,
                stage_seconds=stage,
                _prepass=prepass,
            )
            out[rows] = (np.asarray(codes, np.int64) & 0xFF).astype(np.uint8)
        for handle, rows in waits:
            codes = handle.wait(30.0)  # engine errors re-raise here
            out[rows] = (np.asarray(codes, np.int64) & 0xFF).astype(np.uint8)
        self._m_wire_columnar.inc()
        self._m_wire_crypto_s.inc(stage.get("crypto", 0.0))
        self._m_wire_apply_s.inc(stage.get("apply", 0.0))
        return P.STATUS_OK, P.u32(view.total) + bytes(statuses)

    def _apply_rows_objects(self, engine, entry, view, out) -> None:
        """Object-path escape hatch for ONE peer's rows inside an
        otherwise-columnar frame (engine_factory engines without the
        columnar entry point). Rows are canonical by construction here,
        so every blob decodes."""
        from ..wire import Vote as _Vote

        data_b = entry["data"].tobytes()
        offsets = entry["offsets"]
        scopes = entry["scopes"]
        sidx = entry["sidx"]
        batch = [
            (
                scopes[int(sidx[j])],
                _Vote.decode(data_b[int(offsets[j]):int(offsets[j + 1])]),
            )
            for j in range(len(entry["rows"]))
        ]
        stages = [
            batch[i:i + self._PIPELINE_SPLIT]
            for i in range(0, len(batch), self._PIPELINE_SPLIT)
        ]
        results = engine.ingest_votes_pipelined(stages, view.now)
        codes = [int(code) & 0xFF for stage in results for code in stage]
        out[entry["rows"]] = np.asarray(codes, np.uint8)

    def _op_deliver_proposals(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        """Anti-entropy delivery (``OP_DELIVER_PROPOSALS``): lands on
        :meth:`TorchConsensusEngine.deliver_proposals` — unknown sessions
        are created, known ones extend along the validated-chain
        watermark (suffix-only crypto), redeliveries settle crypto-free
        as PROPOSAL_ALREADY_EXIST. Per-item statuses in batch order;
        an undecodable blob marks its row 241."""
        now = c.u64()
        count = c.u32()
        statuses = bytearray([P.STATUS_BAD_REQUEST]) * count
        items: list[tuple[int, str, Proposal]] = []
        for i in range(count):
            scope = c.string()
            blob = c.blob()
            try:
                items.append((i, scope, Proposal.decode(blob)))
            except (ValueError, IndexError):
                pass
        if items:
            codes = peer.engine.deliver_proposals(
                [(scope, proposal) for _, scope, proposal in items], now
            )
            for (i, _, _), code in zip(items, codes):
                statuses[i] = int(code) & 0xFF
        return P.STATUS_OK, P.u32(count) + bytes(statuses)

    def _op_handle_timeout(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        scope = c.string()
        pid = c.u32()
        now = c.u64()
        ctx = P.read_trace_context(c)
        with _traced("bridge.handle_timeout", ctx, peer.peer_id):
            result = peer.engine.handle_consensus_timeout(scope, pid, now)
        return P.STATUS_OK, P.u8(1 if result else 0)

    def _op_get_result(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        scope = c.string()
        pid = c.u32()
        try:
            result = peer.engine.get_consensus_result(scope, pid)
        except ConsensusError as exc:
            from ..errors import StatusCode

            if exc.code == StatusCode.CONSENSUS_FAILED:
                return P.STATUS_OK, P.u8(P.RESULT_FAILED)
            raise
        if result is None:
            return P.STATUS_OK, P.u8(P.RESULT_UNDECIDED)
        return P.STATUS_OK, P.u8(P.RESULT_YES if result else P.RESULT_NO)

    def _op_poll_events(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        # Optional trailing u32 bound (FEATURE_EVENT_BOUND): a fabric
        # event pump polling many peers caps each drain so one hot peer
        # cannot monopolize the window. Bounded requests get a trailing
        # u8 ``more`` flag (conservative: set when the bound stopped the
        # drain, so the pump polls again immediately; an empty receiver
        # on the next poll costs one frame, not a missed event).
        max_events = c.u32() if c.remaining() >= 4 else None
        events: list[tuple[str, ConsensusEvent]] = []
        more = False
        while True:
            if max_events is not None and len(events) >= max_events:
                more = True
                break
            item = peer.receiver.try_recv()
            if item is None:
                break
            # Filter to the encodable kinds BEFORE counting so the leading
            # u32 always matches the records that follow.
            if isinstance(item[1], (ConsensusReached, ConsensusFailedEvent)):
                events.append(item)
        out = [P.u32(len(events))]
        for scope, event in events:
            if isinstance(event, ConsensusReached):
                out.append(
                    P.string(str(scope))
                    + P.u8(P.EVENT_REACHED)
                    + P.u32(event.proposal_id)
                    + P.u8(1 if event.result else 0)
                    + P.u64(event.timestamp)
                )
            else:
                out.append(
                    P.string(str(scope))
                    + P.u8(P.EVENT_FAILED)
                    + P.u32(event.proposal_id)
                    + P.u8(0)
                    + P.u64(event.timestamp)
                )
        if max_events is not None:
            out.append(P.u8(1 if more else 0))
        return P.STATUS_OK, b"".join(out)

    def _op_get_proposal(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        scope = c.string()
        pid = c.u32()
        proposal = peer.engine.get_proposal(scope, pid)
        return P.STATUS_OK, P.blob(proposal.encode())

    def _op_get_stats(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        scope = c.string()
        stats = peer.engine.get_scope_stats(scope)
        return P.STATUS_OK, (
            P.u32(stats.total_sessions)
            + P.u32(stats.active_sessions)
            + P.u32(stats.failed_sessions)
            + P.u32(stats.consensus_reached)
        )

    def _op_health(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        """Consensus-health snapshot as one JSON blob (see
        ``TorchConsensusEngine.health_report``): scorecards, evidence,
        watchdog, firing alerts; durable peers overlay their WAL
        watermark. The trailing u64 is the embedder's logical tick (0 =
        use the monitor's latest — remote dashboards have no embedder
        clock)."""
        now = c.u64()
        report = peer.engine.health_report(now if now else None)
        return P.STATUS_OK, P.blob(json.dumps(report).encode("utf-8"))

    # ── State sync: snapshot shipping + WAL tailing ────────────────────

    # Server-side bounds: a chunk must fit one response frame with room
    # to spare; the tail budget caps how much log one response carries.
    _SYNC_MAX_CHUNK = 32 * 1024 * 1024
    _TAIL_DEFAULT_BYTES = 4 * 1024 * 1024
    _TAIL_MAX_BYTES = 16 * 1024 * 1024

    @staticmethod
    def _sync_source(peer: _Peer):
        """The peer's DurableEngine, or None when the peer cannot serve
        state sync (keyless/undurable peers have no WAL watermark to tail
        from — a snapshot without one could never be caught up past)."""
        engine = peer.engine
        if hasattr(engine, "capture_consistent") and hasattr(engine, "wal"):
            return engine
        return None

    def _op_sync_manifest(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        """Serve (building if stale) the snapshot manifest for a durable
        peer. The snapshot file lives under the peer's WAL directory
        (``<wal>/sync/snapshot.bin``) and is rebuilt only when the peer's
        WAL position moved since the cached build — repeated manifest
        requests against a quiet peer are free."""
        from ..sync.snapshot import build_snapshot

        max_chunk = c.u32()
        engine = self._sync_source(peer)
        if engine is None:
            return P.STATUS_BAD_REQUEST, P.string(
                "peer is not durable (no WAL): state sync needs a "
                "watermark to tail from"
            )
        chunk_bytes = self._SYNC_MAX_CHUNK if max_chunk == 0 else max_chunk
        chunk_bytes = min(chunk_bytes, self._SYNC_MAX_CHUNK)
        with self._sync_lock:
            gate = self._sync_gates.setdefault(peer.peer_id, threading.Lock())
        with gate:  # serializes builds for THIS peer only
            with self._sync_lock:
                cached = self._sync_cache.get(peer.peer_id)
            current = engine.wal.last_lsn
            if (
                cached is not None
                and cached[0].watermark == current
                and cached[0].chunk_bytes == chunk_bytes
            ):
                manifest, _path = cached
            else:
                with self._sync_lock:
                    self._sync_seq += 1
                    snapshot_id = self._sync_seq
                path = os.path.join(
                    engine.wal.directory, "sync", f"snapshot-{snapshot_id}.bin"
                )
                manifest = build_snapshot(
                    engine, path,
                    chunk_bytes=chunk_bytes, snapshot_id=snapshot_id,
                )
                with self._sync_lock:
                    self._sync_cache[peer.peer_id] = (manifest, path)
                # The superseded artifact is dead: chunk requests against
                # its id already resolve to STATUS_SYNC_STALE (the cache
                # holds only the new id), so the file can go.
                if cached is not None:
                    try:
                        os.remove(cached[1])
                    except OSError:
                        pass
                flight_recorder.record(
                    "sync.snapshot_built",
                    peer=peer.peer_id,
                    snapshot_id=manifest.snapshot_id,
                    watermark=manifest.watermark,
                    bytes=manifest.total_bytes,
                    sessions=manifest.session_count,
                )
        return P.STATUS_OK, (
            P.u64(manifest.snapshot_id)
            + P.u64(manifest.watermark)
            + P.u64(manifest.total_bytes)
            + P.u32(manifest.chunk_bytes)
            + P.u32(manifest.session_count)
            + P.u32(manifest.config_count)
            + P.u32(manifest.chunk_count)
            + b"".join(manifest.digests)
        )

    def _op_sync_chunk(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        snapshot_id = c.u64()
        index = c.u32()
        with self._sync_lock:
            cached = self._sync_cache.get(peer.peer_id)
        if cached is None or cached[0].snapshot_id != snapshot_id:
            return P.STATUS_SYNC_STALE, P.string(
                f"snapshot {snapshot_id} is no longer served; re-fetch "
                "the manifest"
            )
        manifest, path = cached
        if index >= manifest.chunk_count:
            return P.STATUS_BAD_REQUEST, P.string(
                f"chunk {index} out of range (snapshot has "
                f"{manifest.chunk_count})"
            )
        try:
            with open(path, "rb") as fh:
                fh.seek(index * manifest.chunk_bytes)
                data = fh.read(manifest.chunk_bytes)
        except OSError:
            # Lost the race with a rebuild that removed this artifact
            # between the cache read and the open: same signal as an id
            # mismatch — refresh and resume.
            return P.STATUS_SYNC_STALE, P.string(
                f"snapshot {snapshot_id} was rebuilt; re-fetch the manifest"
            )
        self._m_sync_chunks.inc()
        return P.STATUS_OK, P.blob(data)

    def _op_wal_tail(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        from ..wal.recovery import read_tail

        after_lsn = c.u64()
        max_bytes = c.u32()
        engine = self._sync_source(peer)
        if engine is None:
            return P.STATUS_BAD_REQUEST, P.string(
                "peer is not durable (no WAL): nothing to tail"
            )
        budget = self._TAIL_DEFAULT_BYTES if max_bytes == 0 else max_bytes
        budget = min(budget, self._TAIL_MAX_BYTES)
        records, more = read_tail(engine.wal.directory, after_lsn, budget)
        out = [P.u32(len(records))]
        for lsn, kind, payload in records:
            out.append(P.u64(lsn) + P.u8(kind) + P.blob(payload))
        out.append(P.u8(1 if more else 0))
        return P.STATUS_OK, b"".join(out)

    def _op_state_fingerprint(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        """Order-insensitive content digest of the peer's full tracked
        state (``sync.state_fingerprint``) — lets a remote driver assert
        cross-peer convergence without reaching into the process."""
        from ..sync.snapshot import state_fingerprint

        return P.STATUS_OK, P.string(state_fingerprint(peer.engine))

    def _op_fleet_tally(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        """Slot-state histogram of the peer's engine. A federation host
        (peer engine = fleet adapter) answers its whole local fleet's
        ONE-psum tally; a plain engine answers its pool's counts. This is
        the fabric arm of the cross-host tally contract — the psum arm
        needs cross-process collectives the backend may not implement
        (parallel.multihost.collectives_available)."""
        tally = getattr(peer.engine, "fleet_state_counts", None)
        counts = tally() if tally is not None else peer.engine.pool().state_counts()
        return P.STATUS_OK, P.encode_fleet_tally(
            {int(code): int(count) for code, count in counts.items()}
        )

    def _op_explain(self, peer: _Peer, c: P.Cursor) -> tuple[int, bytes]:
        """Decision provenance as one JSON blob (see
        ``TorchConsensusEngine.explain_decision``); durable peers overlay
        their WAL watermark. SessionNotFound maps to the usual wire
        status through the dispatch loop."""
        scope = c.string()
        pid = c.u32()
        verdict = peer.engine.explain_decision(scope, pid)
        return P.STATUS_OK, P.blob(json.dumps(verdict).encode("utf-8"))


_HANDLERS = {
    P.OP_CREATE_PROPOSAL: BridgeServer._op_create_proposal,
    P.OP_CAST_VOTE: BridgeServer._op_cast_vote,
    P.OP_PROCESS_PROPOSAL: BridgeServer._op_process_proposal,
    P.OP_PROCESS_VOTE: BridgeServer._op_process_vote,
    P.OP_PROCESS_VOTES: BridgeServer._op_process_votes,
    P.OP_HANDLE_TIMEOUT: BridgeServer._op_handle_timeout,
    P.OP_GET_RESULT: BridgeServer._op_get_result,
    P.OP_POLL_EVENTS: BridgeServer._op_poll_events,
    P.OP_GET_PROPOSAL: BridgeServer._op_get_proposal,
    P.OP_GET_STATS: BridgeServer._op_get_stats,
    P.OP_EXPLAIN: BridgeServer._op_explain,
    P.OP_HEALTH: BridgeServer._op_health,
    P.OP_SYNC_MANIFEST: BridgeServer._op_sync_manifest,
    P.OP_SYNC_CHUNK: BridgeServer._op_sync_chunk,
    P.OP_WAL_TAIL: BridgeServer._op_wal_tail,
    P.OP_DELIVER_PROPOSALS: BridgeServer._op_deliver_proposals,
    P.OP_STATE_FINGERPRINT: BridgeServer._op_state_fingerprint,
    P.OP_FLEET_TALLY: BridgeServer._op_fleet_tally,
}
