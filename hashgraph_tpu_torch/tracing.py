"""Structured tracing and metrics for the consensus engine.

The reference declares a ``tracing`` dependency but never emits a single
event (SURVEY §5 — zero macro invocations); this module is the real thing:
near-zero-overhead counters and spans on the host side, JSON-lines export for
offline analysis, and a bridge to ``torch.profiler`` for device-side traces.

Usage::

    from hashgraph_tpu_torch.tracing import tracer

    with tracer.span("ingest", votes=128):
        ...
    tracer.count("votes_accepted", 120)
    tracer.export_jsonl("/tmp/trace.jsonl")

Disabled by default: a disabled tracer's ``span`` is a no-op context manager
and ``count``/``event`` return immediately (one attribute check), so the hot
path pays nothing until someone calls ``tracer.enable()``.

A span's ``start`` is in seconds on the clock that ``torch.profiler`` stamps
its events with, the epoch clock (:func:`span_clock`), so the program's
spans and the profiler's kernels share one timeline; its ``duration`` comes
from ``time.perf_counter``. :func:`device_profile` writes the spans recorded
during its block into the trace it captures, as a track of their own.

For the always-on production layer — Prometheus-style metrics families,
decision-latency histograms, scrape endpoints, and the flight recorder —
see :mod:`hashgraph_tpu_torch.obs`; it layers on this tracer
(:func:`~hashgraph_tpu_torch.obs.observed_span` feeds both) rather than
replacing it. For *distributed* tracing — trace context on the wire,
cross-peer span stitching into one Perfetto timeline, and the
``explain_decision`` provenance readout — see
:mod:`hashgraph_tpu_torch.obs.trace`; ``observed_span`` tags its spans with
the active :class:`~hashgraph_tpu_torch.obs.trace.TraceContext` automatically.

Well-known counter families (all emitted through the process-wide default
tracer unless a component was given its own):

- ``engine.*`` — votes_in / votes_accepted / transitions / host_spills /
  pid_collisions / timeout_sweeps / timeouts_fired / fresh_dispatches;
  ``engine.timeouts_reached`` and ``engine.timeouts_failed`` (of the
  sessions a ``sweep_timeouts`` fired, those the timeout decided YES or NO
  and those it failed);
  ``engine.pid_lookup_rebuilds`` (the multi-scope pid lookup rebuilt after
  a membership change cleared it) and ``engine.pid_tables_rebuilt`` (one
  scope's pid table rebuilt), which explain ``engine.resolve``;
  ``engine.register.flushes`` (the register loop's held-back slot writes
  dispatched: one activate and one release at most),
  ``engine.register.flushed_slots`` (the slots those flushes wrote) and
  ``engine.register.forced_flushes`` (flushes that a vote-carrying
  session's row load forced before the loop's end), which explain
  ``engine.register``; ``engine.wire.walked_rows`` (live rows of a wire
  frame that the dangling guard's exact per-row walk decided; the rest
  took the frame-wide array passes) and ``engine.wire.admit_cards_skipped``
  (identities a wire frame admitted whose health card was never built
  because the same admission evicts it), which explain
  ``engine.wire.guard`` and ``engine.wire.admit_health``;
- ``wal.*`` — the durability subsystem (:mod:`hashgraph_tpu_torch.wal`):
  ``wal.append_records`` and ``wal.append_bytes`` (log growth),
  ``wal.fsync`` (durability syscalls — the throughput/durability dial),
  ``wal.rotate`` (segment seals), ``wal.recover.records`` (replayed on
  restart), ``wal.compact.segments`` (dropped behind snapshots),
  ``wal.repair.truncated_bytes`` (torn tail removed at open), and the
  recovery-loss counters ``wal.recover.torn_bytes`` /
  ``wal.recover.dropped_segments`` / ``wal.recover.decode_errors``
  (nonzero dropped_segments/decode_errors = mid-log corruption, not a
  crash tail — acknowledged records were lost).

Well-known spans of the two hot calls (one a call, a batch or a stage,
never a row; through :func:`hashgraph_tpu_torch.obs.stage_span`):

- proposals: ``engine.ingest_proposals`` (the whole call), inside it
  ``engine.proposals.admit`` (the signature batch and the chain check)
  and ``engine.register`` (the per-item loop: session build, LRU
  eviction, slot writes, events);
- columnar: ``engine.ingest_columnar`` (the whole ``ingest_columnar`` or
  ``ingest_columnar_multi``) and ``engine.resolve`` (proposal id to slot,
  in every columnar entry);
- wire: ``engine.wire_verify_begin`` (the whole prepass), and in
  ``ingest_wire_columnar`` ``engine.resolve``, the stages
  ``engine.wire.crypto`` and ``engine.wire.apply`` (the ``"crypto"`` and
  ``"apply"`` of ``stage_seconds``), inside the apply stage
  ``engine.wire.rules`` (replay and expiry, reject health),
  ``engine.wire.guard`` (the dangling-vote guard), ``engine.wire.intern``,
  ``engine.wire.retain``, ``engine.wire.chain`` (the chain tracking after
  the apply) and ``engine.wire.admit_health``;
- the shared columnar apply: ``engine.device_ingest`` and
  ``engine.apply.events`` (the event emission);
- timeouts: ``engine.sweep`` (the whole ``sweep_timeouts``), inside it
  ``engine.sweep.scan`` (the expired set: every live record's state and
  expiry), ``engine.sweep.timeout`` (the pool's timeout dispatch and its
  readback), ``engine.sweep.emit`` (each fired session's timeline,
  adaptive timeout and event) and ``engine.lifecycle_sweep`` (the tier
  TTLs, also when called alone);
- one device signature batch (:mod:`.crypto_device.backend`), each span
  tagged with the batch's number: ``verify.submit``,
  ``verify.decompress.enqueue``, ``verify.hash.enqueue``,
  ``verify.decompress.wait``, ``verify.hash.wait``,
  ``verify.msm.scalars``, ``verify.msm.nibbles``, ``verify.msm.device``
  and ``verify.fallback``.

The event ``engine.decided`` (once an ``ingest_wire_columnar`` call that
decided sessions) carries ``latencies_s``: for each deciding
``ConsensusReached``, the seconds from the start of the
``wire_verify_begin`` of the frame that held the deciding vote to the
event's emission.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field


# Process umask, probed ONCE at import (imports run before worker threads
# exist): export_jsonl needs it to restore normal file modes on its mkstemp
# temp files, and toggling the process-global umask per export would race
# with concurrent file creation elsewhere (WAL segments, flight dumps).
_UMASK = os.umask(0)
os.umask(_UMASK)


def atomic_write_text(path: str, text: str) -> None:
    """Crash-safe text export: write to an mkstemp temp file in the
    destination directory, widen the 0600 temp mode back to what a plain
    open() would create (so log shippers under another uid keep access),
    and ``os.replace`` into place — ``path`` either holds its previous
    content or the complete new text, never a torn file. Shared by
    :meth:`Tracer.export_jsonl` and the distributed-tracing exports
    (:mod:`hashgraph_tpu_torch.obs.trace`)."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".", dir=directory)
    try:
        os.chmod(tmp, 0o666 & ~_UMASK)
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def span_clock() -> float:
    """Now, in seconds, on the clock of span starts: ``time.time_ns()``,
    the epoch clock on which ``torch.profiler`` stamps host and CUDA
    events."""
    return time.time_ns() * 1e-9


@dataclass
class SpanRecord:
    name: str
    start: float
    duration: float
    attrs: dict = field(default_factory=dict)


class Tracer:
    """Thread-safe span/counter/event collector."""

    def __init__(self, enabled: bool = False, max_records: int = 100_000):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: defaultdict[str, int] = defaultdict(int)
        self._spans: list[SpanRecord] = []
        self._events: list[dict] = []
        self._max_records = max_records

    # ── Control ────────────────────────────────────────────────────────

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._spans.clear()
            self._events.clear()

    # ── Recording ──────────────────────────────────────────────────────

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time a block. Records wall duration; attrs are free-form.

        At most ``max_records`` span records are retained; past the cap the
        per-span record is dropped (the ``span.dropped`` counter says how
        many) while the ``span.<name>.calls`` / ``.ns`` counters keep
        aggregating, so totals stay exact even when the record list is
        full."""
        if not self.enabled:
            yield
            return
        start = span_clock()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record_span(name, start, time.perf_counter() - t0, attrs)

    def record_span(
        self, name: str, start: float, duration: float, attrs: dict
    ) -> None:
        """Record an externally-timed span (the body of :meth:`span`;
        also used by :func:`hashgraph_tpu_torch.obs.observed_span`, which times
        once and feeds both the metrics registry and this tracer)."""
        with self._lock:
            if len(self._spans) < self._max_records:
                self._spans.append(SpanRecord(name, start, duration, attrs))
            else:
                self._counters["span.dropped"] += 1
            self._counters[f"span.{name}.calls"] += 1
            self._counters[f"span.{name}.ns"] += int(duration * 1e9)

    def count(self, name: str, n: int = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] += n

    def event(self, name: str, **attrs) -> None:
        if not self.enabled:
            return
        with self._lock:
            if len(self._events) < self._max_records:
                self._events.append(
                    {"name": name, "ts": time.time(), **attrs}
                )

    # ── Readout ────────────────────────────────────────────────────────

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def spans(self, name: str | None = None) -> list[SpanRecord]:
        with self._lock:
            if name is None:
                return list(self._spans)
            return [s for s in self._spans if s.name == name]

    def events(self, name: str | None = None) -> list[dict]:
        """The recorded events (``name``, ``ts`` on the epoch clock, and
        their attributes), oldest first; only those named ``name`` if
        given."""
        with self._lock:
            return [dict(e) for e in self._events if name is None or e["name"] == name]

    def span_stats(self, name: str) -> dict[str, float]:
        """count / total / mean / max seconds for one span name."""
        durations = [s.duration for s in self.spans(name)]
        if not durations:
            return {"count": 0, "total": 0.0, "mean": 0.0, "max": 0.0}
        return {
            "count": len(durations),
            "total": sum(durations),
            "mean": sum(durations) / len(durations),
            "max": max(durations),
        }

    def export_jsonl(self, path: str) -> None:
        """Write counters, spans, and events as JSON lines, atomically
        (see :func:`atomic_write_text`): a crash or serialization error
        mid-export can never leave a torn trace file."""
        with self._lock:
            lines = [
                json.dumps(
                    {"type": "counters", "values": dict(self._counters)}
                )
            ]
            lines.extend(
                json.dumps(
                    {
                        "type": "span",
                        "name": s.name,
                        "start": s.start,
                        "duration": s.duration,
                        **s.attrs,
                    }
                )
                for s in self._spans
            )
            lines.extend(
                json.dumps({"type": "event", **e}) for e in self._events
            )
            atomic_write_text(path, "".join(line + "\n" for line in lines))


# Process-wide default tracer; engine instances use this unless given one.
tracer = Tracer()


PROGRAM_TRACK = "hashgraph_tpu_torch spans"


@contextlib.contextmanager
def device_profile(log_dir: str):
    """Capture a ``torch.profiler`` trace of the host and the GPU around a
    block, and write it into ``log_dir`` as a Chrome trace
    (``device_trace.json``; Perfetto and ``chrome://tracing`` open it).

    The spans that the process-wide :data:`tracer` recorded starting in the
    block (enable it first) go into the same file, on the profiler's clock,
    as a track of their own (:data:`PROGRAM_TRACK`): beside the card's
    timeline they name the host stage that held each idle gap.

    On a machine with a GPU the capture records CUDA activity (every
    kernel the block launches, by name, on the card's clock) and waits for
    the block's kernels before it stops; a capture that recorded none
    raises :class:`RuntimeError` rather than pass off a host-only trace as
    a device trace. Without a GPU it records the host only. If the block
    raises, its exception propagates and no trace is written."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_gpu = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if on_gpu:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "device_trace.json")
    with profile(activities=activities) as prof:
        opened = span_clock()
        yield
        if on_gpu:
            torch.cuda.synchronize()
        closed = span_clock()
    prof.export_chrome_trace(path)
    _add_program_track(path, [s for s in tracer.spans() if opened <= s.start <= closed])
    if on_gpu and not any(
        e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()
    ):
        raise RuntimeError("device_profile: the capture recorded no CUDA activity")


def _add_program_track(path: str, spans: "list[SpanRecord]") -> None:
    """Append ``spans`` to the Chrome trace at ``path`` as complete events
    of one thread named :data:`PROGRAM_TRACK`. The trace's timestamps are
    microseconds after its ``baseTimeNanoseconds`` (0 where it has none)."""
    with open(path) as fh:
        doc = json.load(fh)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), "program"
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": PROGRAM_TRACK}})
    for s in spans:
        events.append({
            "ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": tid,
            "ts": (round(s.start * 1e9) - base) / 1e3, "dur": s.duration * 1e6,
            "args": {k: v if isinstance(v, (int, float, str, bool)) else repr(v)
                     for k, v in s.attrs.items()},
        })
    atomic_write_text(path, json.dumps(doc))
