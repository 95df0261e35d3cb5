"""Apply reactor: cross-connection continuous batching for the wire path.

Port of the JAX package's ``bridge/reactor.py`` over
:class:`~hashgraph_tpu_torch.engine.TorchConsensusEngine`. Without it,
every connection lands its own small ``ingest_wire_columnar`` dispatch,
so the engine pays the fixed launch and readback cost of the
``ingest_scan`` kernel per *frame* instead of per *window*. The reactor
is the continuous-batching scheduler (the Orca insight from inference
serving, applied to consensus ingest — PAPERS.md "Serving & dispatch
amortization"): validated columnar frame-entries from all connections,
peers, and lanes enqueue into per-engine micro-windows, one fused device
dispatch flushes each window, and the per-row statuses scatter back to
every pending frame.

Ordering contract (unchanged from the reactor-off wire):

- A connection's mutating frames join windows in receive order (the
  serial lane enqueues them in order, and an engine's windows dispatch
  strictly in creation order with at most one dispatch in flight per
  engine), so a vote stream's chain links never reorder.
- Rows from *different* connections inside one window are order-free —
  exactly as today's concurrent per-connection dispatches are.
- Windows merge only frames that share the same logical ``now``: the
  scalar drives expiry/decide timestamps, so merging across differing
  clocks could change per-row verdicts. A differing-``now`` enqueue
  closes the open window first (flush reason ``now_change``), which
  keeps reactor-on byte-identical to reactor-off unconditionally.

Windowing: flush on rows, bytes, or deadline (sub-millisecond default).
The deadline adapts — deadline-flushes at occupancy 1 shrink it toward
``min_delay`` so light-load p99 decision latency does not regress;
rows/bytes-flushes grow it back toward ``max_delay``.

Determinism: a reactor that was never ``start()``-ed runs no thread and
dispatches nothing on its own — ``submit()`` only queues, and
``flush()`` dispatches inline on the caller's thread, in enqueue order.
That is the embedded/sim mode (``BridgeServer.start_embedded``): every
frame flushes on the scheduler's own tick, so a chaos run stays a pure
function of its seed.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..obs import (
    DEFAULT_SIZE_BUCKETS,
    REACTOR_FLUSH_BYTES_TOTAL,
    REACTOR_FLUSH_DEADLINE_TOTAL,
    REACTOR_FLUSH_FORCED_TOTAL,
    REACTOR_FLUSH_NOW_CHANGE_TOTAL,
    REACTOR_FLUSH_ROWS_TOTAL,
    REACTOR_ROWS_PER_DISPATCH,
    REACTOR_ROWS_TOTAL,
    REACTOR_WINDOW_OCCUPANCY,
    REACTOR_WINDOWS_TOTAL,
)
from ..obs import registry as default_registry


class ReactorHandle:
    """One enqueued frame-entry's pending per-row statuses. ``wait()``
    blocks for the fused dispatch carrying the entry and returns its
    status slice (``np.int32``, one code per row, engine order); a
    dispatch failure re-raises the engine's exception here so the wire
    error contract is applied where the response is written."""

    __slots__ = ("rows", "_event", "_codes", "_error", "_on_done")

    def __init__(self, rows: int, on_done=None):
        self.rows = rows
        self._event = threading.Event()
        self._codes = None
        self._error = None
        self._on_done = on_done

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def codes(self):
        """Per-row status codes once done (None before, or on error)."""
        return self._codes

    @property
    def error(self):
        """The dispatch's exception once done, else None."""
        return self._error

    def _finish(self, codes, error=None) -> None:
        self._codes = codes
        self._error = error
        self._event.set()
        on_done, self._on_done = self._on_done, None
        if on_done is not None:
            try:
                on_done(self)
            except Exception:  # pragma: no cover - callback owns errors
                pass

    def wait(self, timeout: "float | None" = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("reactor dispatch did not complete")
        if self._error is not None:
            raise self._error
        return self._codes


class _Entry:
    """One validated columnar frame-entry queued for a fused dispatch."""

    __slots__ = (
        "scopes", "sidx", "cols", "data", "offsets", "prepass", "handle",
        "nbytes", "mergeable",
    )

    def __init__(self, scopes, sidx, cols, data, offsets, prepass, handle):
        self.scopes = scopes
        self.sidx = sidx
        self.cols = cols
        self.data = data
        self.offsets = offsets
        self.prepass = prepass
        self.handle = handle
        self.nbytes = int(len(data))
        # Concatenation assumes the offsets span the data exactly (true
        # for decode_vote_batch_views and pack_rows outputs); an entry
        # that doesn't gets its own single-entry window instead of a
        # byte-shifted merge.
        offs = offsets
        self.mergeable = bool(
            len(offs) > 0 and int(offs[0]) == 0 and int(offs[-1]) == self.nbytes
        )


class _Window:
    """One open or flush-pending micro-window: entries for ONE engine at
    ONE logical ``now``, dispatched as a single fused device call."""

    __slots__ = ("engine", "now", "entries", "rows", "nbytes", "deadline", "reason")

    def __init__(self, engine, now, deadline: float):
        self.engine = engine
        self.now = now
        self.entries: list[_Entry] = []
        self.rows = 0
        self.nbytes = 0
        self.deadline = deadline
        self.reason = None  # set when the window closes

    def add(self, entry: _Entry) -> None:
        self.entries.append(entry)
        self.rows += entry.handle.rows
        self.nbytes += entry.nbytes


class _EngineQ:
    """Per-engine scheduling state: at most one OPEN window, a FIFO of
    closed windows awaiting dispatch, and a single-dispatch-in-flight
    flag — windows dispatch strictly in creation order, which is what
    preserves a connection's receive order across windows."""

    __slots__ = ("engine", "open", "ready", "busy")

    def __init__(self, engine):
        self.engine = engine
        self.open: "_Window | None" = None
        self.ready: deque = deque()
        self.busy = False


# The five absolute byte-offset columns a row carries into its data
# region — the exact set ``columnar.pack_rows`` rebases when gathering
# rows, shifted here by each entry's base instead.
def _offset_columns():
    from . import columnar as C

    return (
        C.COL_OWNER_OFF, C.COL_PARENT_OFF, C.COL_RECV_OFF,
        C.COL_HASH_OFF, C.COL_SIG_OFF,
    )


def merge_entries(entries: "list[_Entry]"):
    """Concatenate queued frame-entries into ONE ``ingest_wire_columnar``
    call's arguments: data regions concatenate, the per-row offsets and
    the five byte-offset columns shift by each entry's data base, scope
    indices shift by each entry's scope base (duplicate scope strings
    across entries are harmless — each index group resolves the same
    session), and the in-flight prepasses merge into one whose
    ``collect()`` chains the originals in entry order. Returns
    ``(scopes, sidx, cols, data, offsets, prepass)``."""
    from ..engine.engine import WireVotePrepass

    scopes: list = []
    sidx_parts: list[np.ndarray] = []
    cols_parts: list[np.ndarray] = []
    off_parts: list[np.ndarray] = []
    pre_parts: list[np.ndarray] = []
    crypto_parts: list[np.ndarray] = []
    sources: list = []
    bufs: list[bytes] = []
    have_prepass = entries[0].prepass is not None
    offset_cols = _offset_columns()
    data_base = 0
    row_base = 0
    for entry in entries:
        scope_base = len(scopes)
        scopes.extend(entry.scopes)
        sidx_parts.append(np.asarray(entry.sidx, np.int64) + scope_base)
        cols = np.array(entry.cols, np.int64, copy=True)
        if data_base:
            for col in offset_cols:
                cols[:, col] += data_base
        cols_parts.append(cols)
        offs = np.asarray(entry.offsets, np.int64)
        off_parts.append(offs[:-1] + data_base)
        if have_prepass:
            prepass = entry.prepass
            pre_parts.append(np.asarray(prepass.pre_status, np.int32))
            crypto_parts.append(
                np.asarray(prepass.crypto_rows, np.int64) + row_base
            )
            sources.append(prepass)
            bufs.append(
                prepass.buf if prepass.buf is not None
                else entry.data.tobytes()
            )
        data_base += entry.nbytes
        row_base += len(entry.cols)
    off_parts.append(np.asarray([data_base], np.int64))
    data = np.concatenate([entry.data for entry in entries])
    merged_prepass = None
    if have_prepass:

        def _collect():
            out: list = []
            for source in sources:
                out.extend(source.collect())
            return out

        merged_prepass = WireVotePrepass(
            np.concatenate(pre_parts),
            np.concatenate(crypto_parts),
            _collect,
            buf=b"".join(bufs),
        )
    return (
        scopes,
        np.concatenate(sidx_parts),
        np.vstack(cols_parts),
        data,
        np.concatenate(off_parts),
        merged_prepass,
    )


class ApplyReactor:
    """Per-server micro-batching scheduler for the columnar wire path.

    ``submit()`` queues one validated frame-entry for its engine's open
    window and returns a :class:`ReactorHandle`; windows close on rows /
    bytes / deadline / ``now``-change / forced flush and dispatch as ONE
    fused ``ingest_wire_columnar`` call each, scattering status slices
    back to every handle.

    Two modes, one code path:

    - ``start()``-ed (the TCP server): a flusher thread enforces the
      adaptive deadline and a small executor runs the fused dispatches;
      at most one dispatch in flight per engine, windows in creation
      order.
    - never started (embedded/sim, unit tests): no threads exist;
      ``flush()`` closes and dispatches inline on the caller's thread —
      fully deterministic, the simulator's "flush on the scheduler
      tick".

    ``on_stage`` (optional) receives each dispatch's ``stage_seconds``
    dict — the bridge server feeds its wire crypto/apply counters from
    it so stage attribution stays correct with the reactor on.
    """

    def __init__(
        self,
        *,
        max_rows: int = 1024,
        max_bytes: int = 1 << 20,
        max_delay: float = 0.0005,
        min_delay: float = 0.00005,
        adaptive: bool = True,
        dispatch_workers: int = 2,
        on_stage=None,
    ):
        self.max_rows = max(1, int(max_rows))
        self.max_bytes = max(1, int(max_bytes))
        self.max_delay = float(max_delay)
        self.min_delay = min(float(min_delay), self.max_delay)
        self.adaptive = bool(adaptive)
        self._delay = self.max_delay
        self._on_stage = on_stage
        self._dispatch_workers = max(1, int(dispatch_workers))
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queues: dict[int, _EngineQ] = {}
        self._pool: ThreadPoolExecutor | None = None
        self._flusher: threading.Thread | None = None
        self._running = False
        self._m_windows = default_registry.counter(REACTOR_WINDOWS_TOTAL)
        self._m_rows = default_registry.counter(REACTOR_ROWS_TOTAL)
        self._m_flush = {
            "rows": default_registry.counter(REACTOR_FLUSH_ROWS_TOTAL),
            "bytes": default_registry.counter(REACTOR_FLUSH_BYTES_TOTAL),
            "deadline": default_registry.counter(REACTOR_FLUSH_DEADLINE_TOTAL),
            "now_change": default_registry.counter(
                REACTOR_FLUSH_NOW_CHANGE_TOTAL
            ),
            "forced": default_registry.counter(REACTOR_FLUSH_FORCED_TOTAL),
        }
        self._m_occupancy = default_registry.histogram(
            REACTOR_WINDOW_OCCUPANCY, DEFAULT_SIZE_BUCKETS
        )
        self._m_rows_per_dispatch = default_registry.histogram(
            REACTOR_ROWS_PER_DISPATCH, DEFAULT_SIZE_BUCKETS
        )

    # ── lifecycle ──────────────────────────────────────────────────────

    @property
    def started(self) -> bool:
        return self._running

    def start(self) -> None:
        """Start the deadline flusher + dispatch executor (idempotent)."""
        with self._lock:
            if self._running:
                return
            self._running = True
            self._pool = ThreadPoolExecutor(
                max_workers=self._dispatch_workers,
                thread_name_prefix="apply-reactor",
            )
            self._flusher = threading.Thread(
                target=self._flush_loop, daemon=True, name="reactor-flusher"
            )
            self._flusher.start()

    def stop(self) -> None:
        """Flush and dispatch everything still queued, then join the
        threads. Pending handles always finish — a caller blocked in
        ``wait()`` is never stranded by shutdown."""
        with self._lock:
            was_running = self._running
            self._running = False
            self._wake.notify_all()
        flusher, self._flusher = self._flusher, None
        if flusher is not None:
            flusher.join(timeout=5)
        self.flush()
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        if was_running:
            # Late closes that raced the executor shutdown drain inline.
            self._drain_inline()

    # ── enqueue / flush ────────────────────────────────────────────────

    def submit(
        self,
        engine,
        scopes,
        scope_idx,
        cols,
        data,
        offsets,
        now,
        prepass=None,
        on_done=None,
    ) -> ReactorHandle:
        """Queue one validated columnar frame-entry for ``engine``'s
        window at logical time ``now``. Starts the engine's crypto
        prepass if the caller didn't (reader threads already do). In
        started mode the entry dispatches on rows/bytes/deadline; in
        manual mode nothing dispatches until :meth:`flush`."""
        if prepass is None and hasattr(engine, "wire_verify_begin"):
            prepass = engine.wire_verify_begin(data, cols, offsets)
        handle = ReactorHandle(len(cols), on_done)
        entry = _Entry(scopes, scope_idx, cols, data, offsets, prepass, handle)
        with self._lock:
            q = self._queues.get(id(engine))
            if q is None:
                q = self._queues[id(engine)] = _EngineQ(engine)
            window = q.open
            if window is not None and (
                window.now != now or not entry.mergeable
            ):
                self._close(q, "now_change" if window.now != now else "forced")
                window = None
            if window is None:
                window = q.open = _Window(
                    engine, now, time.monotonic() + self._delay
                )
            window.add(entry)
            if not entry.mergeable or window.rows >= self.max_rows:
                self._close(q, "forced" if not entry.mergeable else "rows")
            elif window.nbytes >= self.max_bytes:
                self._close(q, "bytes")
            if self._running:
                self._pump_locked()
                self._wake.notify_all()
        return handle

    def flush(self, engine=None) -> None:
        """Close the open window(s) — ``engine``'s, or every engine's —
        and dispatch. Started mode hands the windows to the executor
        (callers wait on their handles); manual mode dispatches inline,
        in enqueue order, before returning."""
        with self._lock:
            targets = (
                [q for q in self._queues.values() if q.engine is engine]
                if engine is not None
                else list(self._queues.values())
            )
            for q in targets:
                if q.open is not None and q.open.entries:
                    self._close(q, "forced")
            if self._running:
                self._pump_locked()
                return
        self._drain_inline(engine)

    def pending(self, engine=None) -> tuple[int, int]:
        """(frames, rows) queued or dispatching — the admission-control
        signal: a full window is still *unapplied* work the sender is
        stacking up, so overload shedding must see it (ISSUE 19's
        serial-lane shed fix counts these rows, not just lane jobs)."""
        frames = rows = 0
        with self._lock:
            for q in self._queues.values():
                if engine is not None and q.engine is not engine:
                    continue
                windows = list(q.ready)
                if q.open is not None:
                    windows.append(q.open)
                for window in windows:
                    frames += len(window.entries)
                    rows += window.rows
        return frames, rows

    # ── internals ──────────────────────────────────────────────────────

    def _close(self, q: _EngineQ, reason: str) -> None:
        """Move the open window to the dispatch FIFO (lock held)."""
        window = q.open
        if window is None or not window.entries:
            q.open = None
            return
        window.reason = reason
        q.open = None
        q.ready.append(window)
        if self.adaptive:
            if reason == "deadline" and len(window.entries) <= 1:
                # Light load: the window waited its whole deadline for
                # nothing — stop adding latency.
                self._delay = max(self.min_delay, self._delay * 0.5)
            elif reason in ("rows", "bytes"):
                # Saturated before the deadline: let windows grow back.
                self._delay = min(self.max_delay, self._delay * 1.5)

    def _pump_locked(self) -> None:
        """Start a dispatch worker for every engine with ready windows
        and no dispatch in flight (lock held, started mode)."""
        pool = self._pool
        if pool is None:
            return
        for q in self._queues.values():
            if q.ready and not q.busy:
                q.busy = True
                try:
                    pool.submit(self._run_queue, q)
                except RuntimeError:  # executor shutting down
                    q.busy = False

    def _run_queue(self, q: _EngineQ) -> None:
        """Dispatch ``q``'s ready windows one at a time, in creation
        order (executor thread) — the per-engine ordering guarantee."""
        while True:
            with self._lock:
                if not q.ready:
                    q.busy = False
                    if q.open is None:
                        self._queues.pop(id(q.engine), None)
                    return
                window = q.ready.popleft()
            self._dispatch(window)

    def _drain_inline(self, engine=None) -> None:
        """Manual-mode dispatch: run every ready window inline, engines
        in insertion order, windows in creation order (deterministic)."""
        while True:
            window = None
            with self._lock:
                for q in list(self._queues.values()):
                    if engine is not None and q.engine is not engine:
                        continue
                    if q.busy:
                        # A started-mode worker owns this queue's order;
                        # never interleave with it.
                        continue
                    if q.ready:
                        window = q.ready.popleft()
                        break
                    if q.open is None:
                        self._queues.pop(id(q.engine), None)
            if window is None:
                return
            self._dispatch(window)

    def _dispatch(self, window: _Window) -> None:
        """One fused device dispatch for one closed window; scatters the
        status slices (or the failure) back to every entry's handle."""
        entries = window.entries
        try:
            stage: dict = {}
            if len(entries) == 1:
                entry = entries[0]
                codes = window.engine.ingest_wire_columnar(
                    entry.scopes,
                    entry.sidx,
                    entry.cols,
                    entry.data,
                    entry.offsets,
                    window.now,
                    stage_seconds=stage,
                    _prepass=entry.prepass,
                )
                slices = [np.asarray(codes, np.int64)]
            else:
                scopes, sidx, cols, data, offsets, prepass = merge_entries(
                    entries
                )
                codes = np.asarray(
                    window.engine.ingest_wire_columnar(
                        scopes,
                        sidx,
                        cols,
                        data,
                        offsets,
                        window.now,
                        stage_seconds=stage,
                        _prepass=prepass,
                    ),
                    np.int64,
                )
                slices = []
                base = 0
                for entry in entries:
                    slices.append(codes[base:base + entry.handle.rows])
                    base += entry.handle.rows
            self._m_windows.inc()
            self._m_rows.inc(window.rows)
            self._m_flush[window.reason or "forced"].inc()
            self._m_occupancy.observe(len(entries))
            self._m_rows_per_dispatch.observe(max(1, window.rows))
            if self._on_stage is not None and stage:
                try:
                    self._on_stage(stage)
                except Exception:  # pragma: no cover - observer owns errors
                    pass
            for entry, sub in zip(entries, slices):
                entry.handle._finish(sub)
        except Exception as exc:
            for entry in entries:
                if not entry.handle.done:
                    entry.handle._finish(None, exc)

    def _flush_loop(self) -> None:
        """Deadline enforcement (started mode): close expired open
        windows and pump their dispatches."""
        while True:
            with self._wake:
                if not self._running:
                    return
                now = time.monotonic()
                next_deadline = None
                for q in self._queues.values():
                    window = q.open
                    if window is None or not window.entries:
                        continue
                    if window.deadline <= now:
                        self._close(q, "deadline")
                    elif next_deadline is None or window.deadline < next_deadline:
                        next_deadline = window.deadline
                self._pump_locked()
                timeout = (
                    0.05 if next_deadline is None
                    else max(0.0, next_deadline - now)
                )
                self._wake.wait(timeout)


def reactor_enabled(explicit: "bool | None" = None) -> bool:
    """Resolve the construction-default/escape-hatch contract: an
    explicit constructor argument wins; otherwise the
    ``HASHGRAPH_TPU_APPLY_REACTOR`` env var (``1`` = on), defaulting to
    OFF — the reactor is opt-in while the decision-identity suite and
    the chaos corpus gate it."""
    if explicit is not None:
        return bool(explicit)
    import os

    return os.environ.get("HASHGRAPH_TPU_APPLY_REACTOR", "0") == "1"
