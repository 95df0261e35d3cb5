"""Copy of ``hashgraph_tpu/events.py`` for the PyTorch port, which imports
nothing of the JAX package.

Event bus abstraction and default in-process broadcast implementation.

Mirrors the reference semantics (reference: src/events.rs): every event goes
to all current subscribers; a subscriber with a full buffer silently misses
the event (no blocking); closed subscribers are pruned on publish.
"""

from __future__ import annotations

import queue
import threading
from typing import Generic, Hashable, TypeVar

from .types import ConsensusEvent

Scope = TypeVar("Scope", bound=Hashable)

DEFAULT_MAX_QUEUED_EVENTS = 1000  # reference: src/events.rs:59-66


class ConsensusEventBus(Generic[Scope]):
    """Interface for broadcasting consensus events (reference: src/events.rs:15-26)."""

    def subscribe(self):
        """Subscribe to events from all scopes; returns a receiver."""
        raise NotImplementedError

    def publish(self, scope: Scope, event: ConsensusEvent) -> None:
        raise NotImplementedError


class EventReceiver(Generic[Scope]):
    """Receiving end of a broadcast subscription.

    ``recv`` blocks (optionally with timeout); ``try_recv`` is non-blocking;
    ``close`` disconnects, after which the bus prunes this subscriber.
    """

    def __init__(self, capacity: int):
        self._queue: queue.Queue[tuple[Scope, ConsensusEvent]] = queue.Queue(capacity)
        self._closed = False

    def recv(self, timeout: float | None = None) -> tuple[Scope, ConsensusEvent]:
        """Blocking receive; raises queue.Empty on timeout."""
        return self._queue.get(timeout=timeout)

    def try_recv(self) -> tuple[Scope, ConsensusEvent] | None:
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            return None

    def close(self) -> None:
        self._closed = True

    # bus-side API
    def _offer(self, item: tuple[Scope, ConsensusEvent]) -> bool:
        """Returns False iff this receiver is closed (prune me). A full
        buffer silently drops the event but keeps the subscription
        (reference: src/events.rs:84-90)."""
        if self._closed:
            return False
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            pass
        return True


class BroadcastEventBus(ConsensusEventBus[Scope]):
    """Fan-out to every live subscriber, in-process
    (reference: src/events.rs:35-92)."""

    def __init__(self, max_queued_events: int = DEFAULT_MAX_QUEUED_EVENTS):
        self._capacity = max_queued_events
        self._lock = threading.Lock()
        self._subscribers: list[EventReceiver[Scope]] = []

    def subscribe(self) -> EventReceiver[Scope]:
        receiver: EventReceiver[Scope] = EventReceiver(self._capacity)
        with self._lock:
            self._subscribers.append(receiver)
        return receiver

    def publish(self, scope: Scope, event: ConsensusEvent) -> None:
        with self._lock:
            self._subscribers = [
                r for r in self._subscribers if r._offer((scope, event))
            ]
