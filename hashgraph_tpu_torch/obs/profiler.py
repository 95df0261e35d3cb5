"""Continuous in-process stack profiler (the always-on GWP loop).

Every perf round so far steered by a busy-share number computed after
the fact from stage counters; this module closes the loop the way
Google-Wide Profiling does (Ren et al., IEEE Micro 2010): a background
thread samples every Python thread's stack via ``sys._current_frames()``
at an adaptive rate, folds the samples into a bounded call-graph
aggregate keyed by *thread role*, and exports both collapsed-stack
(flamegraph) text and Chrome trace-event documents that merge onto the
same wall-clock axis as the Dapper-lineage spans in :mod:`.trace`.

Design constraints, in the repo's established idiom:

- **Opt-in like the reactor**: ``$HASHGRAPH_TPU_PROFILE=1`` arms the
  process-wide instance (``obs.default_profiler``); ``enabled = False``
  is the live kill switch (the ``bench.py profile-overhead`` A/B flips
  it), mirroring ``SloEngine.enabled``.
- **Self-measuring overhead**: each sampling tick times itself and
  adapts the rate between ``min_hz`` (~19 Hz) and ``max_hz`` (~97 Hz) —
  backing off when the EWMA of its own cost exceeds ``overhead_budget``
  (a fraction of wall time), speeding back up when well under it. The
  odd primes avoid lockstep with periodic work (a 20 Hz sampler over a
  20 Hz flusher samples the same instant forever).
- **Bounded**: the aggregate holds at most ``max_stacks`` distinct
  (role, stack) keys; novel stacks past the cap count into ``dropped``
  instead of growing memory. A small ring of recent samples backs the
  Perfetto timeline export.
- **Protocol-invisible**: sampling reads interpreter frames only — it
  never touches engine or bridge state, so the sim/chaos corpus is
  byte-identical with the profiler on (asserted in tests).

Thread roles come from the repo's thread-name prefixes (reader threads,
the serial-lane pipeline pool, the apply reactor, gossip loops, WAL
fsync). The native crypto pool's worker threads are C threads invisible
to ``sys._current_frames()`` — time spent *waiting* on them shows up
under the submitting role, which is the schedulable truth.

Metric families (on whatever registry the profiler is bound to):
``hashgraph_profile_samples_total`` (thread-stacks captured),
``hashgraph_profile_dropped_total`` (samples lost to the stack cap),
``hashgraph_profile_overhead_seconds_total`` (the sampler's own cost).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque

PROFILE_SAMPLES_TOTAL = "hashgraph_profile_samples_total"
PROFILE_DROPPED_TOTAL = "hashgraph_profile_dropped_total"
PROFILE_OVERHEAD_SECONDS_TOTAL = "hashgraph_profile_overhead_seconds_total"

PROFILE_SCHEMA = "hashgraph.profile.v1"

_ENV_PROFILE = "HASHGRAPH_TPU_PROFILE"

# Thread-name prefix -> role. Longest-prefix wins, so order by
# specificity. These are the names the repo actually assigns:
# bridge connection readers, the bridge pipeline (serial-lane) pool,
# the apply reactor + its deadline flusher, gossip transport loops,
# WAL writers, and any future Python-side crypto pool.
_ROLE_PREFIXES: tuple[tuple[str, str], ...] = (
    ("bridge-reader", "reader"),
    ("bridge-shm", "reader"),
    ("bridge-pipeline", "serial-lane"),
    ("apply-reactor", "reactor"),
    ("reactor-flusher", "reactor"),
    ("crypto", "crypto-pool"),
    ("gossip", "gossip-loop"),
    ("wal", "wal-fsync"),
    ("MainThread", "main"),
)


def thread_role(name: str) -> str:
    """Role label for a thread name (prefix table above; unmatched
    threads fold under ``other`` so the aggregate stays total)."""
    for prefix, role in _ROLE_PREFIXES:
        if name.startswith(prefix):
            return role
    return "other"


def _frame_label(code) -> str:
    """``module.qualname`` for one frame — short enough for collapsed
    lines, unambiguous enough to find the function."""
    mod = os.path.splitext(os.path.basename(code.co_filename))[0]
    qual = getattr(code, "co_qualname", code.co_name)
    return f"{mod}.{qual}"


def parse_collapsed(text: str) -> dict:
    """Inverse of :meth:`ContinuousProfiler.collapsed`: ``{(role,
    (frame, ...)): samples}``. Round-tripping is a test invariant — the
    export must stay loadable by standard flamegraph tooling AND by us."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, count = line.rpartition(" ")
        parts = stack.split(";")
        key = (parts[0], tuple(parts[1:]))
        out[key] = out.get(key, 0) + int(count)
    return out


class ContinuousProfiler:
    """Adaptive-rate whole-process stack sampler with a bounded
    (role, stack) aggregate. See the module docstring for the contract;
    ``sample_once`` / ``_adapt`` are deliberately public-ish seams so
    tests drive the fold and the backoff deterministically instead of
    racing wall clocks."""

    def __init__(
        self,
        registry=None,
        *,
        min_hz: float = 19.0,
        max_hz: float = 97.0,
        overhead_budget: float = 0.01,
        max_stacks: int = 4096,
        max_depth: int = 64,
        recent_samples: int = 4096,
    ):
        if not (0 < min_hz <= max_hz):
            raise ValueError("need 0 < min_hz <= max_hz")
        self.min_hz = float(min_hz)
        self.max_hz = float(max_hz)
        self.overhead_budget = float(overhead_budget)
        self.max_stacks = int(max_stacks)
        self.max_depth = int(max_depth)
        self.enabled = True  # live kill switch (sampling skipped when off)
        self._interval = 1.0 / self.max_hz  # optimistic start; backs off
        self._overhead_frac = 0.0
        self._overhead_s = 0.0
        self._samples = 0
        self._dropped = 0
        self._stacks: dict = {}
        self._roles: dict = {}
        self._recent: deque = deque(maxlen=int(recent_samples))
        self._lock = threading.Lock()
        self._stop_event = threading.Event()
        self._thread: threading.Thread | None = None
        self._own_ident: int | None = None
        if registry is not None:
            self._samples_counter = registry.counter(PROFILE_SAMPLES_TOTAL)
            self._dropped_counter = registry.counter(PROFILE_DROPPED_TOTAL)
            self._overhead_counter = registry.counter(
                PROFILE_OVERHEAD_SECONDS_TOTAL
            )
        else:
            self._samples_counter = None
            self._dropped_counter = None
            self._overhead_counter = None

    # ── lifecycle ──────────────────────────────────────────────────────

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def rate_hz(self) -> float:
        return 1.0 / self._interval

    def start(self) -> None:
        """Idempotent: a process has one sampling thread, many callers
        (every BridgeServer.start() under the env opt-in)."""
        if self.running:
            return
        self._stop_event.clear()
        self._thread = threading.Thread(
            target=self._loop, name="obs-profiler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop_event.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5)
        self._thread = None

    def _loop(self) -> None:
        self._own_ident = threading.get_ident()
        while not self._stop_event.wait(self._interval):
            if not self.enabled:
                continue
            t0 = time.perf_counter()
            try:
                self.sample_once()
            except Exception:
                # A sampler fault must never take the process (or even
                # the sampler) down — skip the tick, keep the cadence.
                continue
            self._adapt(time.perf_counter() - t0)

    # ── the sampling tick ──────────────────────────────────────────────

    def sample_once(self) -> int:
        """Capture one stack per live thread (self excluded) into the
        aggregate; returns the number of thread-stacks taken."""
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        wall = time.time()
        taken = 0
        dropped = 0
        with self._lock:
            for ident, frame in frames.items():
                if ident == self._own_ident:
                    continue
                role = thread_role(names.get(ident, ""))
                stack = []
                f = frame
                while f is not None and len(stack) < self.max_depth:
                    stack.append(_frame_label(f.f_code))
                    f = f.f_back
                stack.reverse()  # collapsed format is root-first
                key = (role, tuple(stack))
                if key in self._stacks or len(self._stacks) < self.max_stacks:
                    self._stacks[key] = self._stacks.get(key, 0) + 1
                else:
                    dropped += 1
                self._roles[role] = self._roles.get(role, 0) + 1
                self._samples += 1
                taken += 1
                self._recent.append((wall, role, stack[-1] if stack else "?"))
            self._dropped += dropped
        if self._samples_counter is not None and taken:
            self._samples_counter.inc(taken)
        if self._dropped_counter is not None and dropped:
            self._dropped_counter.inc(dropped)
        return taken

    def _adapt(self, cost_s: float) -> None:
        """Fold one tick's measured cost into the overhead EWMA and move
        the rate: over budget -> back off toward ``min_hz``; well under
        (below half the budget) -> speed back up toward ``max_hz``."""
        self._overhead_s += cost_s
        if self._overhead_counter is not None and cost_s > 0:
            self._overhead_counter.inc(cost_s)
        frac = cost_s / self._interval if self._interval > 0 else 1.0
        self._overhead_frac = 0.7 * self._overhead_frac + 0.3 * frac
        hz = 1.0 / self._interval
        if self._overhead_frac > self.overhead_budget:
            hz = max(self.min_hz, hz * 0.6)
        elif self._overhead_frac < 0.5 * self.overhead_budget:
            hz = min(self.max_hz, hz * 1.2)
        self._interval = 1.0 / hz

    def reset(self) -> None:
        with self._lock:
            self._stacks.clear()
            self._roles.clear()
            self._recent.clear()
            self._samples = 0
            self._dropped = 0
            self._overhead_s = 0.0
            self._overhead_frac = 0.0

    # ── readouts ───────────────────────────────────────────────────────

    def snapshot(self) -> dict:
        """Machine-readable aggregate: totals, rate, per-role sample
        counts, and the (bounded) stack table sorted hottest-first."""
        with self._lock:
            stacks = [
                {"role": role, "frames": list(fr), "samples": n}
                for (role, fr), n in sorted(
                    self._stacks.items(), key=lambda kv: (-kv[1], kv[0])
                )
            ]
            return {
                "schema": PROFILE_SCHEMA,
                "enabled": bool(self.enabled),
                "running": self.running,
                "rate_hz": round(self.rate_hz, 2),
                "overhead_budget": self.overhead_budget,
                "samples": self._samples,
                "dropped": self._dropped,
                "overhead_seconds": round(self._overhead_s, 6),
                "roles": dict(sorted(self._roles.items())),
                "stacks": stacks,
            }

    def collapsed(self, snapshot: dict | None = None) -> str:
        """Collapsed-stack text (``role;root;...;leaf N`` per line) —
        the format ``flamegraph.pl`` / speedscope / inferno ingest
        directly. :func:`parse_collapsed` is the exact inverse."""
        snap = self.snapshot() if snapshot is None else snapshot
        lines = [
            ";".join([entry["role"], *entry["frames"]])
            + f" {entry['samples']}"
            for entry in snap["stacks"]
        ]
        return "\n".join(lines) + ("\n" if lines else "")

    def chrome_events(self) -> list[dict]:
        """The retained sample ring as Chrome trace-event instants: one
        synthetic pid 0 "profiler" process (real peers start at pid 1 in
        :func:`..trace.chrome_trace`), one thread row per role, each
        sample an instant at its wall-clock microsecond — so sampled
        stacks and causal spans line up on one Perfetto axis."""
        with self._lock:
            recent = list(self._recent)
        events: list[dict] = [
            {
                "ph": "M",
                "name": "process_name",
                "pid": 0,
                "tid": 0,
                "args": {"name": "profiler (sampled stacks)"},
            }
        ]
        tids: dict[str, int] = {}
        samples: list[dict] = []
        for wall, role, leaf in recent:
            tid = tids.setdefault(role, len(tids) + 1)
            samples.append(
                {
                    "ph": "i",
                    "name": leaf,
                    "pid": 0,
                    "tid": tid,
                    "ts": wall * 1e6,
                    "s": "t",
                    "args": {"role": role},
                }
            )
        for role, tid in tids.items():
            events.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": 0,
                    "tid": tid,
                    "args": {"name": f"role {role}"},
                }
            )
        events.extend(samples)
        return events

    def export_chrome(self, path: str | None = None, spans=None) -> dict:
        """One merged Chrome trace-event document: the trace store's
        spans (or ``spans``) plus this profiler's sampled timeline.
        Writes JSON to ``path`` when given; returns the document."""
        from .trace import chrome_trace, trace_store

        doc = chrome_trace(trace_store.spans() if spans is None else spans)
        doc.setdefault("traceEvents", []).extend(self.chrome_events())
        snap = self.snapshot()
        doc.setdefault("otherData", {})["profile"] = {
            "samples": snap["samples"],
            "dropped": snap["dropped"],
            "rate_hz": snap["rate_hz"],
            "overhead_seconds": snap["overhead_seconds"],
        }
        if path is not None:
            with open(path, "w") as fh:
                json.dump(doc, fh)
        return doc


def profiler_enabled(explicit: "bool | None" = None) -> bool:
    """The reactor's construction-default/escape-hatch contract: an
    explicit argument wins; otherwise ``$HASHGRAPH_TPU_PROFILE`` (``1``
    = on), defaulting to OFF — always-on sampling is an operator's
    opt-in, and the determinism suites gate it."""
    if explicit is not None:
        return bool(explicit)
    return os.environ.get(_ENV_PROFILE, "0") == "1"


def maybe_start_default() -> "ContinuousProfiler | None":
    """Start the process-wide profiler iff the env opt-in is set (called
    from ``BridgeServer.start()`` — every serving process gets the
    always-on loop without per-embedder wiring). Returns the running
    instance, or None when the opt-in is off."""
    if not profiler_enabled():
        return None
    from hashgraph_tpu_torch import obs

    if not obs.default_profiler.running:
        obs.default_profiler.start()
    return obs.default_profiler
