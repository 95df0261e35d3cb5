"""SimNetwork + SimTransport: the gossip fabric without sockets.

:class:`SimTransport` implements the :class:`~hashgraph_tpu_torch.gossip.
transport.GossipTransport` surface a :class:`~hashgraph_tpu_torch.gossip.node.
GossipNode` drives — ``connect`` / ``try_request`` / ``request`` /
``channel`` / ``stats`` / ``close`` — but every frame crosses a
:class:`SimNetwork` instead of TCP: delivery is an event on the shared
:class:`~hashgraph_tpu_torch.sim.core.SimScheduler`, and the scenario's fault
injectors act on the link the frame crosses:

- **partitions** (symmetric or one-way): the frame is lost in flight and
  its future fails typed (:class:`BridgeConnectionLost`) at delivery
  time — exactly what a sender observes, while an ASYMMETRIC partition
  still executes the request on the target and loses only the response,
  the hardest case for exactly-once assumptions;
- **drop**: same typed loss, by seeded coin-flip;
- **duplicate**: the frame dispatches twice (the receiving engine must
  settle the duplicate benignly); the second response is discarded;
- **delay / reorder**: seeded jitter on the delivery tick — same-tick
  frames keep scheduling order, jittered frames genuinely reorder;
- **mutation**: a per-link ``mutate(opcode, payload) -> payload`` hook
  rewrites request bytes in flight (the Byzantine signature-burst rides
  this).

Backpressure mirrors the real transport: per-channel byte-capped send
accounting, ``try_request`` *sheds* (returns None) at the cap, and
``request`` raises :class:`~hashgraph_tpu_torch.gossip.transport.ChannelBusy`.

Futures are :class:`SimFuture`: ``result()`` pumps the scheduler instead
of blocking a thread, so the GossipNode's synchronous await-style repair
path (anti-entropy windows, drain) runs unmodified on virtual time.
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass

from ..bridge import protocol as P
from ..bridge.client import BridgeConnectionLost, BridgeError
from ..gossip.transport import ChannelBusy
from .core import SimScheduler, derived_rng


class SimFuture(Future):
    """A future whose ``result()`` advances VIRTUAL time: it pumps the
    scheduler until resolved, and raises ``TimeoutError`` if the network
    goes idle first (the sim's equivalent of a wall-clock timeout — the
    response provably can never arrive)."""

    def __init__(self, scheduler: SimScheduler):
        super().__init__()
        self._scheduler = scheduler

    def result(self, timeout: float | None = None):
        while not self.done():
            if not self._scheduler.step():
                raise TimeoutError(
                    "sim future unresolved with the network idle"
                )
        return super().result(0)


@dataclass
class LinkFaults:
    """Injected behavior of one directed link (src -> dst). A missing
    entry means a clean link: delivery after ``SimNetwork.base_delay``
    ticks, in order, exactly once."""

    drop_p: float = 0.0
    dup_p: float = 0.0
    jitter: int = 0  # extra delivery ticks drawn uniformly from [0, jitter]
    extra_delay: int = 0
    mutate: object = None  # fn(opcode, payload) -> payload


@dataclass
class NetStats:
    delivered: int = 0
    dropped: int = 0
    blocked: int = 0
    duplicated: int = 0
    response_lost: int = 0
    mutated: int = 0

    def as_dict(self) -> dict:
        return {
            "delivered": self.delivered,
            "dropped": self.dropped,
            "blocked": self.blocked,
            "duplicated": self.duplicated,
            "response_lost": self.response_lost,
            "mutated": self.mutated,
        }


class SimNetwork:
    """Shared fabric: named endpoints + directed-link fault state."""

    def __init__(self, scheduler: SimScheduler, base_delay: int = 1):
        self.scheduler = scheduler
        self.base_delay = base_delay
        self._rng = derived_rng(scheduler.seed, "network")
        self._endpoints: dict[str, object] = {}  # name -> dispatch fn
        self._down: set[str] = set()
        self._blocked: set[tuple[str, str]] = set()
        self._links: dict[tuple[str, str], LinkFaults] = {}
        self.stats = NetStats()

    # ── membership ─────────────────────────────────────────────────────

    def register(self, name: str, dispatch) -> None:
        """Attach an endpoint: ``dispatch(opcode, payload) -> (status,
        payload)`` — a BridgeServer's ``dispatch_frame`` in embedded
        mode."""
        self._endpoints[name] = dispatch
        self._down.discard(name)

    def mark_down(self, name: str) -> None:
        """The endpoint crashed: frames addressed to it are lost (typed)
        until a re-``register``."""
        self._down.add(name)

    def is_up(self, name: str) -> bool:
        return name in self._endpoints and name not in self._down

    # ── fault injection ────────────────────────────────────────────────

    def partition(self, side_a, side_b, *, bidirectional: bool = True) -> None:
        """Block every (a -> b) link; with ``bidirectional`` also every
        (b -> a). One-way blocking is the asymmetric-partition injector."""
        for a in side_a:
            for b in side_b:
                self._blocked.add((a, b))
                if bidirectional:
                    self._blocked.add((b, a))

    def heal_partition(self) -> None:
        self._blocked.clear()

    def set_link(self, src: str, dst: str, **faults) -> None:
        self._links[(src, dst)] = LinkFaults(**faults)

    def set_all_links(self, names, **faults) -> None:
        for src in names:
            for dst in names:
                if src != dst:
                    self.set_link(src, dst, **faults)

    def clear_faults(self) -> None:
        self._links.clear()
        self._blocked.clear()

    def link(self, src: str, dst: str) -> LinkFaults:
        return self._links.get((src, dst)) or _CLEAN

    def blocked(self, src: str, dst: str) -> bool:
        return (src, dst) in self._blocked

    # ── traffic ────────────────────────────────────────────────────────

    def call_direct(self, target: str, opcode: int, payload: bytes):
        """Synchronous fault-free dispatch (a dedicated connection, e.g.
        the catch-up client's): raises ConnectionError when the target is
        down, else returns ``(status, payload)`` immediately."""
        if not self.is_up(target):
            raise ConnectionError(f"sim endpoint {target!r} is down")
        return self._endpoints[target](opcode, payload)

    def send(self, src: str, dst: str, opcode: int, payload: bytes, on_done) -> None:
        """Route one request frame src -> dst under the current fault
        state. ``on_done(result=None, error=None)`` fires EXACTLY ONCE,
        at a scheduled virtual tick; ``result`` is the ``(status,
        payload)`` pair of the FIRST delivery's response."""
        rng = self._rng
        fwd = self.link(src, dst)
        delay = self.base_delay + fwd.extra_delay
        if fwd.jitter:
            delay += rng.randrange(fwd.jitter + 1)
        settled = [False]

        def settle(result=None, error=None):
            if settled[0]:
                return
            settled[0] = True
            on_done(result=result, error=error)

        def lose(counter: str):
            setattr(self.stats, counter, getattr(self.stats, counter) + 1)
            self.scheduler.at(
                delay,
                lambda: settle(error=BridgeConnectionLost(
                    f"frame {src}->{dst} lost ({counter})"
                )),
            )

        if self.blocked(src, dst):
            lose("blocked")
            return
        if fwd.drop_p and rng.random() < fwd.drop_p:
            lose("dropped")
            return
        body = payload
        if fwd.mutate is not None:
            mutated = fwd.mutate(opcode, payload)
            if mutated is not None and mutated != payload:
                self.stats.mutated += 1
                body = mutated
        copies = 1
        if fwd.dup_p and rng.random() < fwd.dup_p:
            copies = 2
            self.stats.duplicated += 1

        def deliver():
            if not self.is_up(dst):
                settle(error=BridgeConnectionLost(
                    f"peer {dst!r} is down"
                ))
                return
            status, out = self._endpoints[dst](opcode, body)
            self.stats.delivered += 1
            rev = self.link(dst, src)
            rdelay = self.base_delay + rev.extra_delay
            if rev.jitter:
                rdelay += rng.randrange(rev.jitter + 1)
            # Response-path faults: the request EXECUTED, only the answer
            # is lost — the asymmetric-partition signature.
            if self.blocked(dst, src) or (
                rev.drop_p and rng.random() < rev.drop_p
            ):
                self.stats.response_lost += 1
                self.scheduler.at(
                    rdelay,
                    lambda: settle(error=BridgeConnectionLost(
                        f"response {dst}->{src} lost"
                    )),
                )
                return
            self.scheduler.at(rdelay, lambda: settle(result=(status, out)))

        for copy in range(copies):
            # A duplicate trails its original by one tick: the receiver
            # must settle the replay benignly (and does — that's the
            # duplicate-rejection path under test).
            self.scheduler.at(delay + copy, deliver)


_CLEAN = LinkFaults()


@dataclass
class _SimChannel:
    name: str
    alive: bool = True
    error: Exception | None = None
    queue_bytes: int = 0
    max_queue_bytes: int = 256 * 1024
    shed_total: int = 0
    inflight: int = 0
    sent: int = 0

    def stats(self) -> dict:
        return {
            "alive": self.alive,
            "pipelined": True,
            "queue_frames": 0,
            "queue_bytes": self.queue_bytes,
            "inflight": self.inflight,
            "shed_total": self.shed_total,
        }


class SimTransport:
    """GossipTransport look-alike over a :class:`SimNetwork`. One per
    node; ``connect`` targets endpoints by NAME (the host argument — the
    sim cluster registers peers under their names and passes
    ``host=name, port=0`` to ``GossipNode.add_peer``)."""

    def __init__(
        self,
        network: SimNetwork,
        owner: str,
        *,
        max_queue_bytes: int = 256 * 1024,
    ):
        self._network = network
        self.owner = owner
        self._max_queue_bytes = max_queue_bytes
        self._channels: dict[str, _SimChannel] = {}
        self._closed = False

    # ── GossipTransport surface ────────────────────────────────────────

    def connect(self, name: str, host: str, port: int) -> _SimChannel:
        if self._closed:
            raise RuntimeError("transport is closed")
        target = host or name
        if not self._network.is_up(target):
            raise ConnectionError(f"sim endpoint {target!r} is not up")
        old = self._channels.get(name)
        if old is not None and old.alive:
            raise ValueError(f"peer {name!r} already connected")
        channel = _SimChannel(name, max_queue_bytes=self._max_queue_bytes)
        self._channels[name] = channel
        return channel

    def channel(self, name: str) -> _SimChannel | None:
        return self._channels.get(name)

    def stats(self) -> dict:
        return {name: ch.stats() for name, ch in self._channels.items()}

    def try_request(
        self, name: str, opcode: int, payload: "bytes | list" = b""
    ) -> "SimFuture | None":
        channel = self._channels.get(name)
        if channel is None:
            raise KeyError(f"unknown peer {name!r}")
        if not isinstance(payload, (bytes, bytearray, memoryview)):
            # Segment lists (send-side zero-copy on the real transport)
            # join here: the sim ships whole payloads through its
            # virtual-time network, and the mutation/digest hooks want
            # one contiguous byte string.
            payload = b"".join(payload)
        future = SimFuture(self._network.scheduler)
        if not channel.alive:
            future.set_exception(
                channel.error
                or BridgeConnectionLost(f"peer {name!r} disconnected")
            )
            return future
        size = len(payload) + 9
        if channel.queue_bytes + size > channel.max_queue_bytes:
            channel.shed_total += 1
            return None
        channel.queue_bytes += size
        channel.inflight += 1
        channel.sent += 1

        def on_done(result=None, error=None):
            channel.queue_bytes -= size
            channel.inflight -= 1
            if future.done():
                return
            if error is not None:
                future.set_exception(error)
                return
            status, out = result
            if status == P.STATUS_OK:
                future.set_result(P.Cursor(out))
            else:
                message = ""
                try:
                    message = P.Cursor(out).string()
                except ValueError:
                    pass
                future.set_exception(BridgeError(status, message))

        self._network.send(self.owner, name, opcode, payload, on_done)
        return future

    def request(self, name: str, opcode: int, payload: bytes = b"") -> SimFuture:
        future = self.try_request(name, opcode, payload)
        if future is None:
            raise ChannelBusy(f"peer {name!r} send queue is full")
        return future

    def kill_channel(self, name: str, reason: str = "peer crashed") -> None:
        """Mark one channel dead (new requests fail typed until the
        harness reconnects it) — the sim-side analogue of a TCP reset."""
        channel = self._channels.get(name)
        if channel is not None:
            channel.alive = False
            channel.error = BridgeConnectionLost(reason)

    def reconnect(self, name: str) -> None:
        """Replace a dead channel (the harness's explicit heal, mirroring
        the real transport's ReconnectPolicy re-dial)."""
        channel = self._channels.get(name)
        if channel is not None and channel.alive:
            return
        self._channels.pop(name, None)
        self.connect(name, name, 0)

    def close(self) -> None:
        self._closed = True
        for channel in self._channels.values():
            channel.alive = False
            channel.error = BridgeConnectionLost("transport closed")


class SimBridgeAdapter:
    """BridgeClient-shaped state-sync surface over the sim network: the
    injectable ``bridge`` a :class:`~hashgraph_tpu_torch.sync.CatchUpClient`
    rides so the snapshot/tail catch-up path itself — manifests, chunk
    digests, LSN continuity — runs live inside a deterministic scenario.
    Dedicated connection semantics: synchronous, fault-free, but a down
    endpoint still raises ``ConnectionError``."""

    def __init__(self, network: SimNetwork, target: str):
        self._network = network
        self._target = target

    def _call(self, opcode: int, payload: bytes) -> P.Cursor:
        status, out = self._network.call_direct(self._target, opcode, payload)
        if status != P.STATUS_OK:
            message = ""
            try:
                message = P.Cursor(out).string()
            except ValueError:
                pass
            raise BridgeError(status, message)
        return P.Cursor(out)

    def sync_manifest(self, peer: int, max_chunk_bytes: int = 0) -> dict:
        from ..bridge.client import parse_sync_manifest

        return parse_sync_manifest(
            self._call(P.OP_SYNC_MANIFEST, P.u32(peer) + P.u32(max_chunk_bytes))
        )

    def sync_chunk(self, peer: int, snapshot_id: int, index: int) -> bytes:
        return self._call(
            P.OP_SYNC_CHUNK, P.u32(peer) + P.u64(snapshot_id) + P.u32(index)
        ).blob()

    def wal_tail(self, peer: int, after_lsn: int, max_bytes: int = 0):
        cursor = self._call(
            P.OP_WAL_TAIL, P.u32(peer) + P.u64(after_lsn) + P.u32(max_bytes)
        )
        records = []
        for _ in range(cursor.u32()):
            lsn = cursor.u64()
            kind = cursor.u8()
            records.append((lsn, kind, cursor.blob()))
        return records, bool(cursor.u8())

    def close(self) -> None:
        pass
