"""Always-on flight recorder: a bounded ring of recent events, dumped as
JSONL when something faults, so a postmortem can see the 2 seconds before
the crash without anyone having enabled tracing first.

Design constraints, in order:

1. **Near-zero overhead.** ``record`` is one tuple build + one
   ``deque.append`` (a single C call, atomic under the GIL — no lock on
   the hot path). Callers record per *batch* / per *request*, never per
   vote.
2. **Bounded.** The deque's ``maxlen`` caps memory; old events fall off.
3. **Always on.** There is no enable switch — the whole point is that the
   evidence exists when the fault nobody predicted happens.

Dumps go to ``$HASHGRAPH_FLIGHT_DIR`` (default
``<tmpdir>/hashgraph-flight``) as one JSONL file per fault, rate-limited
so a crash loop cannot fill the disk. The engine's public-API wrapper and
the bridge's dispatch loop both dump automatically on unexpected
exceptions; embedders can call :meth:`FlightRecorder.dump` on their own
fault paths too.
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
from collections import deque

DEFAULT_CAPACITY = 4096
_ENV_DIR = "HASHGRAPH_FLIGHT_DIR"


def default_dump_dir() -> str:
    return os.environ.get(_ENV_DIR) or os.path.join(
        tempfile.gettempdir(), "hashgraph-flight"
    )


class FlightRecorder:
    """Lock-free bounded event ring with throttled JSONL fault dumps."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        dump_dir: str | None = None,
        min_dump_interval: float = 1.0,
    ):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._ring: deque = deque(maxlen=capacity)
        self._dump_dir = dump_dir
        self._min_interval = min_dump_interval
        self._last_dump = 0.0
        self._dropped_dumps = 0
        # Dump-path serialization only — record() stays lock-free. The
        # sequence uniquifies filenames when two faults land in the same
        # millisecond (itertools.count is atomic under the GIL).
        self._dump_lock = threading.Lock()
        self._dump_seq = itertools.count()
        # Optional Counter wired by hashgraph_tpu_torch.obs (kept injectable to
        # avoid a module cycle with the registry's default instance).
        self.dump_counter = None

    # ── Recording (hot path) ───────────────────────────────────────────

    def record(self, kind: str, **attrs) -> None:
        """Append one event. deque.append is a single atomic C call; the
        ring may be appended to from any thread without a lock."""
        self._ring.append((time.time(), kind, attrs or None))

    # ── Readout / dumping ──────────────────────────────────────────────

    def __len__(self) -> int:
        return len(self._ring)

    def events(self) -> list[tuple[float, str, dict | None]]:
        """Oldest-first copy of the ring (list(deque) is atomic)."""
        return list(self._ring)

    def dump(self, reason: str, path: str | None = None) -> str | None:
        """Write the ring as JSONL (one event per line, oldest first,
        preceded by a header line carrying the reason and pid). Returns the
        file path, or None when throttled (at most one dump per
        ``min_dump_interval`` seconds — a crash loop must not fill the
        disk) or when the filesystem refuses the write. An explicit
        ``path`` bypasses (and does not consume) the throttle window.

        Never raises: this runs on fault paths, and an unwritable dump
        directory must not replace the original exception with an OSError
        — best-effort evidence, never a second fault."""
        with self._dump_lock:
            if path is None:
                # Throttle bookkeeping only for automatic fault dumps; an
                # explicit-path dump (embedder asked) must not consume the
                # window and suppress the next real fault's dump.
                now = time.monotonic()
                if now - self._last_dump < self._min_interval:
                    self._dropped_dumps += 1
                    return None
                self._last_dump = now
        tmp = None
        try:
            if path is None:
                directory = self._dump_dir or default_dump_dir()
                os.makedirs(directory, exist_ok=True)
                path = os.path.join(
                    directory,
                    f"flight-{int(time.time() * 1000)}"
                    f"-{os.getpid()}-{next(self._dump_seq)}.jsonl",
                )
            events = self.events()
            tmp = f"{path}.{next(self._dump_seq)}.tmp"
            with open(tmp, "w") as fh:
                fh.write(
                    json.dumps(
                        {
                            "type": "flight_header",
                            "reason": reason,
                            "pid": os.getpid(),
                            "ts": time.time(),
                            "events": len(events),
                            "dumps_throttled": self._dropped_dumps,
                        }
                    )
                    + "\n"
                )
                for ts, kind, attrs in events:
                    entry = {"ts": ts, "kind": kind}
                    if attrs:
                        for key, value in attrs.items():
                            # An unserializable attr must not turn the dump
                            # itself into a second fault.
                            try:
                                json.dumps(value)
                            except (TypeError, ValueError):
                                value = repr(value)
                            entry[key] = value
                    fh.write(json.dumps(entry) + "\n")
            os.replace(tmp, path)  # a torn dump never shadows a good one
        except Exception:
            self._dropped_dumps += 1
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            return None
        if self.dump_counter is not None:
            self.dump_counter.inc()
        return path

    def clear(self) -> None:
        self._ring.clear()


# Process-wide recorder: the engine, WAL, and bridge all feed this one ring
# so a dump interleaves every subsystem's last events in time order.
flight_recorder = FlightRecorder()
