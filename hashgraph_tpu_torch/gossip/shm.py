"""Shared-memory ring transport for co-located bridge peers.

Same-host shards used to speak loopback TCP: every coalesced frame paid
two syscalls, two kernel copies, and the socket wakeup path. This module
replaces that hop with a pair of single-producer/single-consumer byte
rings in POSIX shared memory (``multiprocessing.shared_memory``), one
per direction. A frame is then ONE userspace memcpy each way, and the
byte stream inside the ring is exactly the bridge's tagged frame stream
— the same incremental parser both ends already run over TCP consumes
it unchanged.

Negotiation (see :mod:`hashgraph_tpu_torch.bridge.protocol`): the client
offers ``FEATURE_SHM_RING`` at HELLO; on grant — and only for loopback
endpoints — it creates the two rings and sends ``OP_SHM_ATTACH`` with
their names over the still-blocking socket. Any failure (feature not
granted, old server, ``/dev/shm`` unavailable, cross-container peer
that cannot map the name) falls back to TCP silently: the socket stays
open as the control lane either way, and its close tears the rings
down on both sides.

Ring layout (``HEADER_BYTES`` header + data):

    [0:8)  head — total bytes ever written (u64 LE, producer-owned)
    [8:16) tail — total bytes ever read    (u64 LE, consumer-owned)
    [16:16+capacity) data, addressed modulo capacity

Head is stored only AFTER the frame bytes are in place and tail only
after they are consumed, so the single producer and single consumer
never read a torn frame. That publish ordering is a TOTAL-STORE-ORDER
property: plain stores through a shared mapping are only guaranteed to
become visible in program order on x86/TSO machines, so
:func:`shm_available` reports False on weakly-ordered architectures
(aarch64 & co) and those hosts keep the TCP lane — correct, just
without the shm shortcut — until the ring grows real barriers. Writes
are all-or-nothing: a frame that does not fit reports False and the
caller falls back (bounded backpressure, never a partial frame).
"""

from __future__ import annotations

import platform
import struct
import time

HEADER_BYTES = 16
_U64 = struct.Struct("<Q")

# Architectures whose plain aligned stores publish in program order
# (total store order) — the property the head-after-payload commit
# protocol depends on. Everything else degrades to TCP.
_TSO_MACHINES = {"x86_64", "amd64", "i686", "i386"}

try:  # pragma: no cover - platform gate
    from multiprocessing import shared_memory as _shm
except ImportError:  # pragma: no cover
    _shm = None


def shm_available() -> bool:
    return _shm is not None and platform.machine().lower() in _TSO_MACHINES


def _untrack(shm) -> None:
    """Detach an ATTACHED mapping from the resource tracker: the creator
    owns unlink; without this, the attaching process's tracker would
    destroy the segment at exit and warn about a leak it caused."""
    try:  # pragma: no cover - stdlib internals, best effort
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


class ShmRing:
    """One SPSC byte ring over a shared-memory segment."""

    __slots__ = ("shm", "capacity", "_buf", "_owner")

    # Names created by THIS process: a same-process attach (tests, the
    # in-process gossip smoke) must not untrack them — the creator's
    # registration is the one the unlink path balances.
    _created: "set[str]" = set()

    def __init__(self, shm, owner: bool):
        self.shm = shm
        self.capacity = shm.size - HEADER_BYTES
        self._buf = shm.buf
        self._owner = owner

    @classmethod
    def create(cls, capacity: int) -> "ShmRing":
        if _shm is None:
            raise RuntimeError("shared_memory unavailable on this platform")
        shm = _shm.SharedMemory(create=True, size=HEADER_BYTES + capacity)
        shm.buf[:HEADER_BYTES] = bytes(HEADER_BYTES)
        cls._created.add(shm.name)
        return cls(shm, owner=True)

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        if _shm is None:
            raise RuntimeError("shared_memory unavailable on this platform")
        shm = _shm.SharedMemory(name=name)
        if name not in cls._created:
            _untrack(shm)
        return cls(shm, owner=False)

    @property
    def name(self) -> str:
        return self.shm.name

    def _live_buf(self):
        """The mapping, snapshotted ONCE per operation; raises ValueError
        once :meth:`close` swapped it out. A snapshot taken before a
        concurrent close stays valid — the exported view keeps the
        mapping alive (``SharedMemory.close`` defers to it)."""
        buf = self._buf
        if len(buf) < HEADER_BYTES:
            raise ValueError("shm ring is closed")
        return buf

    def try_write(self, segments: "list[bytes]", total: int) -> bool:
        """Append ``segments`` (``total`` bytes) as one atomic unit;
        False when the ring lacks space (caller sheds or falls back).
        Single producer: callers serialize writers themselves. Raises
        ValueError on a closed ring (channel died under the caller)."""
        buf = self._live_buf()
        head = _U64.unpack_from(buf, 0)[0]
        if total > self.capacity - (head - _U64.unpack_from(buf, 8)[0]):
            return False
        cap = self.capacity
        pos = head % cap
        for seg in segments:
            view = memoryview(seg)
            n = len(view)
            first = min(n, cap - pos)
            buf[HEADER_BYTES + pos:HEADER_BYTES + pos + first] = view[:first]
            if first < n:
                buf[HEADER_BYTES:HEADER_BYTES + n - first] = view[first:]
            pos = (pos + n) % cap
        _U64.pack_into(buf, 0, head + total)
        return True

    def pending_bytes(self) -> int:
        """Bytes written but not yet read (0 = the consumer has drained
        everything). Raises ValueError on a closed ring."""
        buf = self._live_buf()
        return _U64.unpack_from(buf, 0)[0] - _U64.unpack_from(buf, 8)[0]

    def read_available(self, limit: int = 1 << 20) -> bytes | None:
        """Drain up to ``limit`` buffered bytes (None when empty). The
        stream is frame-structured by the caller's parser, so partial
        frames across calls are fine. Raises ValueError on a closed
        ring (channel died under the caller)."""
        buf = self._live_buf()
        tail = _U64.unpack_from(buf, 8)[0]
        n = _U64.unpack_from(buf, 0)[0] - tail
        if n <= 0:
            return None
        n = min(n, limit)
        cap = self.capacity
        pos = tail % cap
        first = min(n, cap - pos)
        out = bytes(buf[HEADER_BYTES + pos:HEADER_BYTES + pos + first])
        if first < n:
            out += bytes(buf[HEADER_BYTES:HEADER_BYTES + n - first])
        _U64.pack_into(buf, 8, tail + n)
        return out

    def close(self) -> None:
        self._buf = memoryview(b"")
        try:
            self.shm.close()
        except (OSError, BufferError):
            pass
        if self._owner:
            ShmRing._created.discard(self.shm.name)
            try:
                self.shm.unlink()
            except OSError:
                pass


class ShmSpin:
    """Adaptive poll pacing for ring consumers: spin a little while the
    stream is hot, back off to short sleeps when idle — latency stays
    in the microseconds under load without burning a core at rest."""

    __slots__ = ("_misses",)

    def __init__(self):
        self._misses = 0

    def hit(self) -> None:
        self._misses = 0

    def wait(self) -> None:
        self._misses += 1
        if self._misses < 200:
            return  # hot spin
        time.sleep(0.0002 if self._misses < 2000 else 0.002)
