"""Selectors-based multiplexed transport for the gossip fabric.

One :class:`GossipTransport` drives MANY peer connections from ONE
event-loop thread (`selectors`, non-blocking sockets — no asyncio in the
library core, matching the reference's no-I/O embedder contract: the
loop is plain stdlib an embedder can reason about and replace). Each
:class:`PeerChannel` speaks the bridge wire protocol with the features
its server granted at HELLO:

- against a new server (``FEATURE_PIPELINING``): tagged frames, many in
  flight, responses matched by correlation id;
- against an OLD server: the one-at-a-time framing with a FIFO response
  match and an in-flight window of 1 — same API, interop preserved.

**Backpressure is explicit and bounded.** Every channel has a byte-capped
send queue and a credit window (``max_inflight`` unanswered requests).
Credits gate *sending* — queued frames wait; once the queue's byte cap
would be exceeded, :meth:`GossipTransport.try_request` refuses the frame
(*sheds*) instead of buffering without bound. The caller — the
:class:`~hashgraph_tpu_torch.gossip.node.GossipNode` — records what it shed
and repairs via anti-entropy later, so a slow peer costs a bounded queue
plus deferred repair, never ballooning memory.

A dropped connection fails every queued and in-flight future with
:class:`~hashgraph_tpu_torch.bridge.client.BridgeConnectionLost` — a typed,
per-request signal, never a silent hang.
"""

from __future__ import annotations

import os
import selectors
import socket
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future

from ..bridge import protocol as P
from ..bridge.client import BridgeConnectionLost, BridgeError, ReconnectPolicy
from ..obs import (
    GOSSIP_DRAIN_PRESSURE,
    GOSSIP_FRAMES_SENT_TOTAL,
    GOSSIP_FRAMES_SHED_TOTAL,
    GOSSIP_INFLIGHT_REQUESTS,
    GOSSIP_SEND_QUEUE_BYTES,
    flight_recorder,
)
from ..obs import registry as default_registry

_RECV_CHUNK = 256 * 1024

# Most iovecs one sendmsg accepts (UIO_MAXIOV; EINVAL past it). A frame
# coalesced from more vote segments than this is written in capped
# scatter-gather passes via the partial-send resume path.
try:  # pragma: no cover - platform probe
    _IOV_MAX = os.sysconf("SC_IOV_MAX")
    if _IOV_MAX <= 0:
        _IOV_MAX = 1024
except (AttributeError, ValueError, OSError):  # pragma: no cover
    _IOV_MAX = 1024


def _weak_sample(ref, method_name):
    """Gauge provider over a weakly-referenced transport (0 once dead)."""

    def sample():
        transport = ref()
        return 0 if transport is None else getattr(transport, method_name)()

    return sample


class PeerChannel:
    """One multiplexed connection to a peer's bridge server. Owned by a
    :class:`GossipTransport`; all socket I/O happens on the transport's
    event-loop thread, callers only enqueue frames and await futures.
    Channels that negotiated ``FEATURE_SHM_RING`` additionally carry a
    shared-memory ring pair (``shm_tx``/``shm_rx``): requests write
    straight into the tx ring at enqueue time (one memcpy, no syscall)
    and a per-channel reader thread completes futures from the rx ring;
    the socket stays the control/fallback lane."""

    def __init__(self, name: str, sock: socket.socket, features: int,
                 max_inflight: int, max_queue_bytes: int):
        self.name = name
        self.sock = sock
        self.features = features
        self.pipelined = bool(features & P.FEATURE_PIPELINING)
        self.max_inflight = max_inflight if self.pipelined else 1
        self.max_queue_bytes = max_queue_bytes
        self.alive = True
        self.error: Exception | None = None
        # Guarded by the channel lock: send queue + accounting. Frames
        # are fully encoded at enqueue time (the loop thread only moves
        # bytes). Queue entries are (segments, nbytes, corr, future):
        # segments lists ride to sendmsg un-joined (send-side zero-copy).
        self.lock = threading.Lock()
        self.sendq: deque[tuple[list, int, int, Future]] = deque()
        self.queue_bytes = 0
        self.shed_total = 0
        # Loop-thread-only state: the frame currently being written and
        # the unanswered requests. Tagged channels match by correlation
        # id; untagged channels complete FIFO.
        self.outbuf: "list[memoryview] | None" = None
        self.outfut: Future | None = None
        self.outcorr = 0
        self.inflight: dict[int, Future] = {}
        self.fifo: deque[Future] = deque()
        self.next_corr = 0
        self.rbuf = bytearray()
        # Shared-memory lane (None until an attach succeeds). shm
        # futures are guarded by the channel lock (the rx thread and the
        # kill path both touch them).
        self.shm_tx = None
        self.shm_rx = None
        self.shm_inflight: dict[int, Future] = {}
        self.shm_thread: "threading.Thread | None" = None
        # Corr ids of MUTATING frames routed to the TCP lane (queued or
        # awaiting response), guarded by the channel lock. While any are
        # outstanding, later mutating frames also ride TCP so one
        # ordered opcode stream never splits across lanes (the server
        # serializes per lane, not across them).
        self.tcp_mutating: set[int] = set()

    # ── accounting (any thread) ────────────────────────────────────────

    def inflight_count(self) -> int:
        return len(self.inflight) + len(self.fifo) + (
            1 if self.outfut is not None else 0
        )

    def stats(self) -> dict:
        with self.lock:
            return {
                "alive": self.alive,
                "pipelined": self.pipelined,
                "shm": self.shm_tx is not None,
                "queue_frames": len(self.sendq),
                "queue_bytes": self.queue_bytes,
                "inflight": self.inflight_count() + len(self.shm_inflight),
                "shed_total": self.shed_total,
            }


class GossipTransport:
    """Multiplexed, pipelined fan-out over many bridge connections.

    ``connect`` performs the blocking HELLO handshake, then hands the
    socket to the event loop. ``try_request`` enqueues one frame for a
    peer and returns a future resolving to the response payload cursor
    (or raising :class:`BridgeError` / :class:`BridgeConnectionLost`) —
    or returns ``None`` when the peer's send queue is at its byte cap
    (the shed signal). All sockets run ``TCP_NODELAY``; pass ``sndbuf``/
    ``rcvbuf`` for high-BDP links (see :func:`bridge.protocol.tune_socket`).
    """

    def __init__(
        self,
        *,
        max_inflight: int = 128,
        max_queue_bytes: int = 4 * 1024 * 1024,
        connect_timeout: float = 5.0,
        features: int = P.SUPPORTED_FEATURES,
        sndbuf: int | None = None,
        rcvbuf: int | None = None,
        reconnect: "ReconnectPolicy | None" = None,
        shm_ring_bytes: int | None = None,
    ):
        self._max_inflight = max_inflight
        self._max_queue_bytes = max_queue_bytes
        self._connect_timeout = connect_timeout
        self._features = features
        self._sndbuf = sndbuf
        self._rcvbuf = rcvbuf
        # Shared-memory rings for co-located peers: when set (ring bytes
        # per direction) AND the server grants FEATURE_SHM_RING AND the
        # endpoint is loopback, requests bypass the kernel socket path
        # entirely (gossip.shm). Any attach failure silently keeps TCP.
        self._shm_ring_bytes = shm_ring_bytes
        # Opt-in channel healing: when a peer's channel dies (and the
        # transport itself is not closing), re-dial it with capped
        # jittered backoff and a fresh HELLO. In-flight and queued
        # futures on the dead channel still fail typed — only the
        # CHANNEL heals; lost frames are the anti-entropy layer's job.
        self._reconnect = reconnect
        self._endpoints: dict[str, tuple[str, int]] = {}
        self._reconnecting: set[str] = set()
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._channels: dict[str, PeerChannel] = {}
        self._pending_register: list[PeerChannel] = []
        self._lock = threading.Lock()
        self._running = True
        self._m_sent = default_registry.counter(GOSSIP_FRAMES_SENT_TOTAL)
        self._m_shed = default_registry.counter(GOSSIP_FRAMES_SHED_TOTAL)
        # Providers close over a WEAK ref (the engine/WAL convention): a
        # bound method's __self__ would strongly pin every transport ever
        # created into the process-global registry — the owner weakref
        # only prunes the entry once the owner can actually die.
        ref = weakref.ref(self)
        default_registry.gauge(GOSSIP_SEND_QUEUE_BYTES).add_provider(
            _weak_sample(ref, "_total_queue_bytes"), owner=self
        )
        default_registry.gauge(GOSSIP_INFLIGHT_REQUESTS).add_provider(
            _weak_sample(ref, "_total_inflight"), owner=self
        )
        default_registry.gauge(GOSSIP_DRAIN_PRESSURE).add_provider(
            _weak_sample(ref, "_drain_pressure"), owner=self
        )
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="gossip-transport"
        )
        self._thread.start()

    # ── lifecycle ──────────────────────────────────────────────────────

    def close(self) -> None:
        self._running = False
        self._wake()
        self._thread.join(timeout=5)
        with self._lock:
            channels = list(self._channels.values())
        for ch in channels:
            self._kill_channel(
                ch, BridgeConnectionLost("transport closed"), record=False
            )
        try:
            self._wake_r.close()
            self._wake_w.close()
        except OSError:
            pass
        self._sel.close()

    def __enter__(self) -> "GossipTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass

    # ── connections ────────────────────────────────────────────────────

    def connect(self, name: str, host: str, port: int) -> PeerChannel:
        """Open (blocking) a channel to a peer's bridge server and
        negotiate features; the socket then joins the event loop. A
        ``name`` can be reconnected after its channel died — the dead
        channel is replaced."""
        if not self._running:
            raise RuntimeError("transport is closed")
        sock = socket.create_connection(
            (host, port), timeout=self._connect_timeout
        )
        P.tune_socket(sock, sndbuf=self._sndbuf, rcvbuf=self._rcvbuf)
        features = 0
        try:
            sock.sendall(P.encode_frame(
                P.OP_HELLO,
                P.u32(P.PROTOCOL_VERSION) + P.u32(self._features),
            ))
            status, cursor = P.read_frame(sock)
            if status == P.STATUS_OK:
                cursor.u32()  # server protocol version
                features = cursor.u32()
            elif status != P.STATUS_UNKNOWN_OPCODE:
                raise BridgeError(status)
        except BaseException:
            sock.close()
            raise
        channel = PeerChannel(
            name, sock, features, self._max_inflight, self._max_queue_bytes
        )
        if (
            self._shm_ring_bytes
            and features & P.FEATURE_SHM_RING
            and features & P.FEATURE_PIPELINING
            and host in ("127.0.0.1", "localhost", "::1")
        ):
            self._try_attach_shm(channel)  # still blocking; pre-loop
        sock.setblocking(False)
        with self._lock:
            # Re-checked at registration time: a reconnect attempt's
            # blocking dial can race close() past the entry check, and a
            # channel registered after the loop thread exited would
            # never be serviced — its futures would hang instead of
            # failing typed.
            if not self._running:
                sock.close()
                raise RuntimeError("transport is closed")
            old = self._channels.get(name)
            if old is not None and old.alive:
                sock.close()
                raise ValueError(f"peer {name!r} already connected")
            self._channels[name] = channel
            self._pending_register.append(channel)
            self._endpoints[name] = (host, port)
        self._wake()
        return channel

    def channel(self, name: str) -> PeerChannel | None:
        with self._lock:
            return self._channels.get(name)

    def stats(self) -> dict:
        with self._lock:
            channels = dict(self._channels)
        return {name: ch.stats() for name, ch in channels.items()}

    # ── requests ───────────────────────────────────────────────────────

    def try_request(
        self, name: str, opcode: int, payload: "bytes | list" = b""
    ) -> Future | None:
        """Enqueue one request for ``name``; None = shed (queue at its
        byte cap / shm ring full — bounded backpressure, the caller
        repairs later). ``payload`` may be a LIST of byte segments
        (see :func:`bridge.protocol.encode_vote_batch_segments`): the
        segments ride to ``sendmsg`` — or into the shm ring — without
        ever being joined into one contiguous copy."""
        with self._lock:
            channel = self._channels.get(name)
        if channel is None:
            raise KeyError(f"unknown peer {name!r}")
        if not channel.alive:
            future: Future = Future()
            future.set_exception(
                channel.error
                or BridgeConnectionLost(f"peer {name!r} disconnected")
            )
            return future
        if isinstance(payload, (bytes, bytearray, memoryview)):
            psegs, pbytes = [payload], len(payload)
        else:
            psegs, pbytes = list(payload), sum(len(s) for s in payload)
        future = Future()
        with channel.lock:
            # Re-checked under the SAME lock _kill_channel drains the
            # queue with: without this, a frame enqueued between the
            # loop thread's kill-drain and our append would sit on a
            # dead channel with its future never resolved.
            if not channel.alive:
                future.set_exception(
                    channel.error
                    or BridgeConnectionLost(f"peer {name!r} disconnected")
                )
                return future
            if channel.pipelined:
                corr = channel.next_corr
                channel.next_corr = (corr + 1) & 0xFFFFFFFF
                header = P._TAGGED_HEADER.pack(5 + pbytes, opcode, corr)
            else:
                corr = 0
                header = P._FRAME_HEADER.pack(1 + pbytes, opcode)
            segments = [header, *psegs]
            nbytes = len(header) + pbytes
            mutating = opcode in P.MUTATING_OPCODES
            if (
                channel.shm_tx is not None
                and nbytes <= channel.shm_tx.capacity
                and not (mutating and channel.tcp_mutating)
            ):
                # Shared-memory lane: ONE memcpy into the ring, future
                # completed by the rx thread. Ring full = the same shed
                # signal as the byte cap (never split a stream across
                # lanes — reordering a chained vote stream is worse
                # than a deferred repair). A frame larger than the ring
                # can EVER hold rides TCP below (shedding it would retry
                # the same un-sendable frame forever), and while any
                # mutating frame is on the TCP lane, later mutating
                # frames follow it there — the server only preserves
                # order WITHIN a lane, so admitting them to the ring
                # would let them overtake the TCP frame.
                try:
                    written = channel.shm_tx.try_write(segments, nbytes)
                except ValueError:  # ring closed under us: channel dying
                    future.set_exception(
                        channel.error
                        or BridgeConnectionLost(f"peer {name!r} disconnected")
                    )
                    return future
                if written:
                    channel.shm_inflight[corr] = future
                    self._m_sent.inc()
                    return future
                channel.shed_total += 1
                self._m_shed.inc()
                flight_recorder.record(
                    "gossip.shed", peer=name, opcode=opcode, shm=True,
                )
                return None
            if (
                mutating
                and channel.shm_tx is not None
                and not channel.tcp_mutating
            ):
                # First mutating frame to leave the ring for TCP (it is
                # oversize, or it arrives as the set drains to empty):
                # admit it only once the server has consumed every frame
                # already in the ring — earlier ring frames still queued
                # could otherwise be APPLIED after this newer one (an
                # older shorter chain landing late reads as truncation
                # to the redelivery health probe). Shed until drained;
                # the ring clears in microseconds and the caller's
                # anti-entropy retry resends.
                try:
                    if channel.shm_tx.pending_bytes() > 0:
                        channel.shed_total += 1
                        self._m_shed.inc()
                        flight_recorder.record(
                            "gossip.shed", peer=name, opcode=opcode,
                            shm=True, draining=True,
                        )
                        return None
                except ValueError:  # ring closed under us: channel dying
                    future.set_exception(
                        channel.error
                        or BridgeConnectionLost(f"peer {name!r} disconnected")
                    )
                    return future
            # Byte cap applies only while frames are already queued: an
            # empty queue always admits ONE frame (cap effectively
            # cap + one frame), so a frame bigger than the cap itself
            # degrades to serialized sends instead of shedding forever.
            if channel.sendq and (
                channel.queue_bytes + nbytes > channel.max_queue_bytes
            ):
                channel.shed_total += 1
                self._m_shed.inc()
                flight_recorder.record(
                    "gossip.shed", peer=name, opcode=opcode,
                    queue_bytes=channel.queue_bytes,
                )
                return None
            channel.sendq.append((segments, nbytes, corr, future))
            channel.queue_bytes += nbytes
            if mutating and channel.pipelined:
                channel.tcp_mutating.add(corr)
        self._wake()
        return future

    def request(self, name: str, opcode: int, payload: bytes = b"") -> Future:
        """:meth:`try_request` that raises :class:`ChannelBusy` instead
        of returning None — for control traffic the caller windows
        itself (anti-entropy sends one frame and awaits it)."""
        future = self.try_request(name, opcode, payload)
        if future is None:
            raise ChannelBusy(f"peer {name!r} send queue is full")
        return future

    # ── gauge providers ────────────────────────────────────────────────

    def _total_queue_bytes(self) -> int:
        with self._lock:
            channels = list(self._channels.values())
        return sum(ch.queue_bytes for ch in channels)

    def _total_inflight(self) -> int:
        with self._lock:
            channels = list(self._channels.values())
        return sum(ch.inflight_count() for ch in channels)

    def _drain_pressure(self) -> float:
        """Worst per-channel send-queue fill fraction in [0, 1] — how
        close the slowest peer is to tripping the backpressure shed."""
        with self._lock:
            channels = list(self._channels.values())
        return max(
            (
                ch.queue_bytes / ch.max_queue_bytes
                for ch in channels
                if ch.max_queue_bytes > 0
            ),
            default=0.0,
        )

    # ── event loop (loop thread only below) ────────────────────────────

    def _loop(self) -> None:
        while self._running:
            self._register_pending()
            self._refresh_interest()
            for key, mask in self._sel.select(timeout=0.1):
                if key.data is None:  # wake pipe
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                    continue
                channel: PeerChannel = key.data
                try:
                    if mask & selectors.EVENT_WRITE:
                        self._on_writable(channel)
                    if mask & selectors.EVENT_READ:
                        self._on_readable(channel)
                except (ConnectionError, OSError, ValueError) as exc:
                    self._kill_channel(channel, BridgeConnectionLost(
                        f"peer {channel.name!r} connection lost: {exc}"
                    ))

    def _register_pending(self) -> None:
        with self._lock:
            fresh = self._pending_register
            self._pending_register = []
        for channel in fresh:
            if channel.alive:
                self._sel.register(channel.sock, selectors.EVENT_READ, channel)

    def _refresh_interest(self) -> None:
        with self._lock:
            channels = list(self._channels.values())
        for channel in channels:
            if not channel.alive:
                continue
            want = selectors.EVENT_READ
            credits = channel.max_inflight - channel.inflight_count()
            with channel.lock:
                has_frames = bool(channel.sendq) or channel.outbuf is not None
            if has_frames and (credits > 0 or channel.outbuf is not None):
                want |= selectors.EVENT_WRITE
            try:
                self._sel.modify(channel.sock, want, channel)
            except (KeyError, ValueError):
                pass  # not registered yet / already unregistered

    def _on_writable(self, channel: PeerChannel) -> None:
        while True:
            if channel.outbuf is None:
                credits = channel.max_inflight - channel.inflight_count()
                if credits <= 0:
                    return
                with channel.lock:
                    if not channel.sendq:
                        return
                    segments, nbytes, corr, future = channel.sendq.popleft()
                    channel.queue_bytes -= nbytes
                channel.outbuf = [memoryview(s) for s in segments]
                channel.outfut = future
                channel.outcorr = corr
            # Scatter-gather write: the frame's segments (header + the
            # coalescer's original vote bytes) go to the kernel in one
            # syscall without ever being joined. Capped at IOV_MAX
            # iovecs per call (sendmsg fails whole with EINVAL past it);
            # the partial-send resume below picks up the remainder.
            if hasattr(channel.sock, "sendmsg"):
                sent = channel.sock.sendmsg(channel.outbuf[:_IOV_MAX])
            else:  # pragma: no cover - platforms without sendmsg
                sent = channel.sock.send(b"".join(channel.outbuf))
            remaining: list[memoryview] = []
            for seg in channel.outbuf:
                if sent >= len(seg):
                    sent -= len(seg)
                    continue
                remaining.append(seg[sent:] if sent else seg)
                sent = 0
            if remaining:
                channel.outbuf = remaining
                return  # kernel buffer full; resume on next writable
            # Frame fully handed to the kernel: it is now in flight.
            future = channel.outfut
            corr = channel.outcorr
            channel.outbuf = None
            channel.outfut = None
            self._m_sent.inc()
            if channel.pipelined:
                channel.inflight[corr] = future
            else:
                channel.fifo.append(future)

    def _on_readable(self, channel: PeerChannel) -> None:
        chunk = channel.sock.recv(_RECV_CHUNK)
        if not chunk:
            raise ConnectionError("peer closed the connection")
        channel.rbuf += chunk
        for body in P.split_frames(channel.rbuf):
            self._complete(channel, body)

    def _complete(self, channel: PeerChannel, body: bytes) -> None:
        status, corr, cursor = P.parse_frame(body, channel.pipelined)
        if channel.pipelined:
            future = channel.inflight.pop(corr, None)
            with channel.lock:
                channel.tcp_mutating.discard(corr)
                if future is None:
                    # A ring-sent request whose response outgrew the
                    # ring comes back on the TCP control lane (corr ids
                    # are shared across lanes; the server falls back
                    # rather than wedge the response ring).
                    future = channel.shm_inflight.pop(corr, None)
        else:
            future = channel.fifo.popleft() if channel.fifo else None
        if future is None:
            return  # response to nothing we sent; drop
        if status == P.STATUS_OK:
            future.set_result(cursor)
        else:
            message = ""
            try:
                message = cursor.string()
            except ValueError:
                pass
            future.set_exception(BridgeError(status, message))

    def _kill_channel(
        self, channel: PeerChannel, error: Exception, record: bool = True
    ) -> None:
        if not channel.alive:
            return
        channel.alive = False
        channel.error = error
        try:
            self._sel.unregister(channel.sock)
        except (KeyError, ValueError):
            pass
        try:
            channel.sock.close()
        except OSError:
            pass
        with channel.lock:
            queued = [entry[3] for entry in channel.sendq]
            channel.sendq.clear()
            channel.queue_bytes = 0
            queued.extend(channel.shm_inflight.values())
            channel.shm_inflight.clear()
            channel.tcp_mutating.clear()
            shm_rings = (channel.shm_tx, channel.shm_rx)
            channel.shm_tx = None
            channel.shm_rx = None
        for ring in shm_rings:
            if ring is not None:
                ring.close()
        pending = list(channel.inflight.values()) + list(channel.fifo)
        channel.inflight.clear()
        channel.fifo.clear()
        if channel.outfut is not None:
            pending.append(channel.outfut)
            channel.outbuf = None
            channel.outfut = None
        if record:
            flight_recorder.record(
                "gossip.peer_lost", peer=channel.name,
                pending=len(pending) + len(queued), error=str(error),
            )
        for future in pending + queued:
            if not future.done():
                future.set_exception(error)
        if record and self._running:
            self._maybe_reconnect(channel.name)

    # ── shared-memory lane ─────────────────────────────────────────────

    def _try_attach_shm(self, channel: PeerChannel) -> None:
        """Create a ring pair and offer it to the server (blocking; runs
        during connect, before the socket joins the event loop). Any
        failure keeps the TCP lane silently — old servers, containers
        without a shared /dev/shm, and platform gaps all degrade to
        exactly the pre-shm behavior."""
        tx = rx = None
        try:
            from .shm import ShmRing, shm_available

            if not shm_available():
                return
            tx = ShmRing.create(self._shm_ring_bytes)  # client -> server
            rx = ShmRing.create(self._shm_ring_bytes)  # server -> client
            with channel.lock:
                corr = channel.next_corr
                channel.next_corr = (corr + 1) & 0xFFFFFFFF
            channel.sock.sendall(P.encode_tagged_frame(
                P.OP_SHM_ATTACH,
                corr,
                P.u32(self._shm_ring_bytes)
                + P.string(tx.name)
                + P.string(rx.name),
            ))
            status, _rcorr, _cursor = P.read_tagged_frame(channel.sock)
            if status != P.STATUS_OK:
                raise ValueError(f"shm attach refused (status {status})")
        except (OSError, ValueError, RuntimeError, ConnectionError):
            for ring in (tx, rx):
                if ring is not None:
                    ring.close()
            return
        channel.shm_tx = tx
        channel.shm_rx = rx
        channel.shm_thread = threading.Thread(
            target=self._shm_rx_loop, args=(channel,), daemon=True,
            name=f"gossip-shm-{channel.name}",
        )
        channel.shm_thread.start()
        flight_recorder.record("gossip.shm_attached", peer=channel.name)

    def _shm_rx_loop(self, channel: PeerChannel) -> None:
        """Per-channel response drain for the shm lane: the ring carries
        the same tagged frame stream as the socket; futures complete by
        correlation id."""
        from .shm import ShmSpin

        spin = ShmSpin()
        buf = bytearray()
        while channel.alive and self._running:
            rx = channel.shm_rx
            if rx is None:
                return
            try:
                chunk = rx.read_available()
            except (OSError, ValueError):
                return  # ring closed/unmapped under us (channel died)
            if chunk is None:
                spin.wait()
                continue
            spin.hit()
            buf += chunk
            try:
                frames = P.split_frames(buf, min_len=5)
            except ValueError:
                self._kill_channel(channel, BridgeConnectionLost(
                    f"peer {channel.name!r} shm stream corrupt"
                ))
                return
            for body in frames:
                self._complete_shm(channel, body)

    def _complete_shm(self, channel: PeerChannel, body: bytes) -> None:
        status, corr, cursor = P.parse_frame(body, tagged=True)
        with channel.lock:
            future = channel.shm_inflight.pop(corr, None)
        if future is None:
            return
        if status == P.STATUS_OK:
            future.set_result(cursor)
        else:
            message = ""
            try:
                message = cursor.string()
            except ValueError:
                pass
            future.set_exception(BridgeError(status, message))

    def _maybe_reconnect(self, name: str) -> None:
        """Spawn (at most one per peer) the bounded backoff re-dial loop,
        when the transport opted into a :class:`ReconnectPolicy`."""
        if self._reconnect is None:
            return
        with self._lock:
            endpoint = self._endpoints.get(name)
            if endpoint is None or name in self._reconnecting:
                return
            self._reconnecting.add(name)
        threading.Thread(
            target=self._reconnect_loop, args=(name, *endpoint),
            daemon=True, name=f"gossip-reconnect-{name}",
        ).start()

    def _reconnect_loop(self, name: str, host: str, port: int) -> None:
        policy = self._reconnect
        try:
            for attempt in range(policy.max_attempts):
                time.sleep(policy.delay(attempt))
                if not self._running:
                    return
                try:
                    self.connect(name, host, port)
                except (ConnectionError, OSError, BridgeError, ValueError,
                        RuntimeError):
                    continue
                flight_recorder.record(
                    "gossip.reconnected", peer=name, attempt=attempt + 1,
                )
                return
            flight_recorder.record(
                "gossip.reconnect_failed", peer=name,
                attempts=policy.max_attempts,
            )
        finally:
            with self._lock:
                self._reconnecting.discard(name)


class ChannelBusy(RuntimeError):
    """``request`` refused a frame because the peer's bounded send queue
    is full — the explicit backpressure signal for callers that must not
    shed silently."""
