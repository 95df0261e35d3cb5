"""Send-side vote coalescing: many small votes, one columnar frame.

The engine ingests hundreds of thousands of votes per second, but a
gossip arrival is tiny — one signed vote is ~200 bytes — and both the
wire AND the engine charge a fixed cost per frame/dispatch. The
:class:`VoteCoalescer` closes that gap: votes destined for one peer
accumulate into (peer_id, scope)-keyed groups and flush as ONE
``OP_VOTE_BATCH`` frame per (peer, window), where a window closes on
whichever trips first:

- ``flush_votes`` — enough votes to amortize the dispatch,
- ``flush_bytes`` — keep frames well under the wire cap,
- ``flush_interval`` — latency bound; a trickle never waits longer.

Order is preserved end to end (groups keep insertion order, votes keep
append order, the server's pipelined vote lane applies frames in receive
order), so coalescing never reorders a vote chain.
"""

from __future__ import annotations

import threading
import time

from ..bridge import protocol as P
from ..obs import GOSSIP_VOTES_COALESCED_TOTAL
from ..obs import registry as default_registry


class _Window:
    __slots__ = ("groups", "votes", "bytes", "opened", "now")

    def __init__(self, opened: float):
        # (peer_id, scope) -> list[vote bytes]; insertion-ordered.
        self.groups: dict[tuple[int, str], list[bytes]] = {}
        self.votes = 0
        self.bytes = 0
        self.opened = opened
        self.now = 0  # logical consensus time for the frame (max of adds)


class VoteCoalescer:
    """Per-peer vote packing with bounded windows. Thread-safe."""

    def __init__(
        self,
        *,
        flush_votes: int = 256,
        flush_bytes: int = 512 * 1024,
        flush_interval: float = 0.005,
        clock=time.monotonic,
    ):
        self.flush_votes = flush_votes
        self.flush_bytes = flush_bytes
        self.flush_interval = flush_interval
        self._clock = clock
        self._lock = threading.Lock()
        self._windows: dict[str, _Window] = {}
        self._m_votes = default_registry.counter(GOSSIP_VOTES_COALESCED_TOTAL)

    def add(
        self,
        peer_name: str,
        peer_id: int,
        scope: str,
        vote: bytes,
        now: int,
    ) -> "tuple[bytes, list[tuple[int, str, int]]] | None":
        """Buffer one vote for ``peer_name``. Returns a ready frame —
        ``(payload, meta)`` as :meth:`flush` — when this add trips a
        size threshold, else None (the window stays open for more)."""
        with self._lock:
            window = self._windows.get(peer_name)
            if window is None:
                window = self._windows[peer_name] = _Window(self._clock())
            window.groups.setdefault((peer_id, scope), []).append(vote)
            window.votes += 1
            window.bytes += len(vote)
            window.now = max(window.now, now)
            if (
                window.votes >= self.flush_votes
                or window.bytes >= self.flush_bytes
            ):
                return self._seal(peer_name, window)
            return None

    def flush(
        self, peer_name: str
    ) -> "tuple[bytes, list[tuple[int, str, int]]] | None":
        """Seal ``peer_name``'s open window now (interval expiry, drain,
        shutdown). Returns ``(payload, meta)`` — the encoded
        ``OP_VOTE_BATCH`` payload and its ``(peer_id, scope, count)``
        meta, which the sender uses to mark scopes dirty if the frame
        sheds — or None when nothing is buffered."""
        with self._lock:
            window = self._windows.get(peer_name)
            if window is None or not window.votes:
                return None
            return self._seal(peer_name, window)

    def due(self) -> list[str]:
        """Peers whose open window exceeded ``flush_interval``."""
        deadline = self._clock() - self.flush_interval
        with self._lock:
            return [
                name
                for name, window in self._windows.items()
                if window.votes and window.opened <= deadline
            ]

    def pending(self, peer_name: str) -> int:
        with self._lock:
            window = self._windows.get(peer_name)
            return window.votes if window is not None else 0

    def extract(
        self, peer_name: str, predicate
    ) -> "list[tuple[int, str, list[bytes], int]]":
        """Surgically remove the groups whose scope satisfies
        ``predicate(scope)`` from ``peer_name``'s open window, returning
        ``(peer_id, scope, votes, window_now)`` tuples (insertion
        order). The federation driver drains a migrating shard's queued
        votes into its migration tail this way — the rest of the window
        stays queued for its original destination."""
        with self._lock:
            window = self._windows.get(peer_name)
            if window is None:
                return []
            out = []
            for key in [k for k in window.groups if predicate(k[1])]:
                votes = window.groups.pop(key)
                window.votes -= len(votes)
                window.bytes -= sum(len(v) for v in votes)
                out.append((key[0], key[1], votes, window.now))
            if not window.groups:
                del self._windows[peer_name]
            return out

    def _seal(self, peer_name: str, window: _Window):
        # Caller holds the lock. The payload is a SEGMENT LIST (frame
        # head + the buffered vote bytes objects, un-joined): the
        # transport scatter-gathers it to the socket or shm ring, so the
        # votes are never concatenated on the send side
        # (protocol.encode_vote_batch_segments).
        del self._windows[peer_name]
        groups = [
            (peer_id, scope, votes)
            for (peer_id, scope), votes in window.groups.items()
        ]
        self._m_votes.inc(window.votes)
        payload, _nbytes = P.encode_vote_batch_segments(window.now, groups)
        meta = [(peer_id, scope, len(votes)) for peer_id, scope, votes in groups]
        return payload, meta
