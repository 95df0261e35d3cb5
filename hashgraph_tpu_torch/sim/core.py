"""Deterministic discrete-event core: virtual time, seeded entropy.

The chaos harness's whole claim is that a scenario run is a **pure
function of its seed**: no wall clock, no real sockets, no thread
scheduling. This module supplies the two primitives that make it true:

- :class:`SimScheduler` — a single-threaded event queue over integer
  *virtual* time. Events fire in (time, insertion-order) order, so two
  events scheduled for the same tick run in the order they were
  scheduled; "blocking" callers (futures awaiting a gossip response)
  advance virtual time by pumping this queue instead of sleeping.
- :func:`derived_rng` — named sub-generators off the scenario seed.
  Seeding ``random.Random`` with a *string* uses SHA-512 internally, so
  the streams are stable across processes and PYTHONHASHSEED values
  (tuple seeds would not be).
- :class:`deterministic_ids` — installs a scenario-rng entropy source
  behind :func:`hashgraph_tpu_torch.protocol.generate_id` for the run, so
  every minted proposal id and vote id — and therefore every signed
  byte, every WAL record, and every state fingerprint — derives from
  the seed.
"""

from __future__ import annotations

import heapq
import random

from .. import protocol


def derived_rng(seed: int, label: str) -> random.Random:
    """A named deterministic sub-generator of the scenario seed. String
    seeding is hashed with SHA-512 inside ``random.Random`` — stable
    across interpreter runs, unlike hash()-based tuple seeding."""
    return random.Random(f"hashgraph-sim:{seed}:{label}")


class SimScheduler:
    """Single-threaded discrete-event loop on integer virtual time."""

    def __init__(self, seed: int):
        self.seed = seed
        self.now = 0
        self._queue: list[tuple[int, int, object]] = []
        self._seq = 0
        self.events_run = 0

    def at(self, delay: int, fn) -> None:
        """Schedule ``fn()`` ``delay`` ticks from now (>= 0). Ties run in
        scheduling order — the determinism backbone."""
        if delay < 0:
            raise ValueError("delay must be >= 0")
        self._seq += 1
        heapq.heappush(self._queue, (self.now + int(delay), self._seq, fn))

    def step(self) -> bool:
        """Run the next pending event (advancing ``now`` to its time).
        Returns False when the queue is empty — the idle signal a
        sim future's ``result()`` turns into a typed timeout."""
        if not self._queue:
            return False
        time, _seq, fn = heapq.heappop(self._queue)
        if time > self.now:
            self.now = time
        self.events_run += 1
        fn()
        return True

    def run_until_idle(self, max_events: int = 1_000_000) -> int:
        """Drain the queue; returns the number of events run. The cap is
        a runaway guard (a scenario bug scheduling events from events
        forever), not a tuning knob."""
        ran = 0
        while ran < max_events and self.step():
            ran += 1
        if ran >= max_events:
            raise RuntimeError(
                f"simulation did not quiesce within {max_events} events"
            )
        return ran

    def advance(self, ticks: int) -> None:
        """Move virtual time forward ``ticks`` with the queue idle (e.g.
        to expire sessions or age the liveness watchdog)."""
        if self._queue:
            raise RuntimeError("advance() requires an idle event queue")
        self.now += int(ticks)


class deterministic_ids:
    """Context manager installing seed-derived entropy behind
    ``protocol.generate_id`` (and restoring the previous source on exit,
    even when the scenario raises)."""

    def __init__(self, seed: int):
        self._rng = derived_rng(seed, "ids")

    def __enter__(self) -> "deterministic_ids":
        self._prior = protocol._id_entropy
        protocol.set_id_entropy(lambda: self._rng.getrandbits(128))
        return self

    def __exit__(self, *exc) -> None:
        protocol.set_id_entropy(self._prior)
