"""WalWriter: append-side of the durability subsystem.

Responsibilities: frame records (:mod:`.format`), assign monotonically
increasing LSNs, rotate segments at a size threshold (:mod:`.segment`),
run the configured fsync policy, repair a torn tail left by a previous
crash on open, and drop snapshot-covered segments on compaction.

Fsync policies (the durability/throughput dial — see README "Durability &
recovery" for the guarantee each level buys):

- ``"always"``: fsync after every append. An acknowledged record survives
  OS/power failure. Slowest — one fsync per record.
- ``"batch"``: fsync every ``fsync_interval`` appends (and on rotation,
  ``sync()`` and ``close()``). An acknowledged record survives *process*
  crash immediately (the bytes are in the page cache) and OS/power failure
  up to the last interval boundary.
- ``"off"``: never fsync (the OS flushes on its own schedule). Survives
  process crash; OS/power failure may lose the page-cache tail.

Every policy keeps the framing invariant: a record is written with one
buffered ``write`` call and the frame CRC covers the whole body, so a
partially-persisted record is detected and truncated at recovery — the WAL
never replays garbage, it only ever loses an un-fsynced suffix.
"""

from __future__ import annotations

import errno
import os
import threading
import time
import weakref

from ..obs import (
    WAL_FSYNC_SECONDS,
    WAL_SEGMENT_BYTES,
    WAL_SEGMENT_COUNT,
)
from ..obs import registry as default_registry
from ..tracing import tracer as default_tracer
from . import format as F
from .segment import (
    DEFAULT_SEGMENT_BYTES,
    list_segments,
    scan_segment,
    segment_name,
    truncate_segment,
)

FSYNC_ALWAYS = "always"
FSYNC_BATCH = "batch"
FSYNC_OFF = "off"
_POLICIES = (FSYNC_ALWAYS, FSYNC_BATCH, FSYNC_OFF)

# Writer-liveness lock file. Does not parse as a segment (no ``wal-``
# prefix / ``.seg`` suffix), so listing/compaction ignore it.
LOCK_FILENAME = "wal.lock"

# Crash-point labels a ``crash_hook`` observes, in the order one append
# can traverse them. "append" fires with the encoded frame about to be
# written (a hook raising SimulatedCrash(torn_bytes=k) leaves the first k
# bytes of that frame on disk — a torn write); "append.flushed" fires
# after the frame reached the OS; "fsync"/"fsync.done" bracket each fsync
# syscall; "rotate"/"rotate.done" bracket a segment roll.
CRASH_POINTS = (
    "append",
    "append.flushed",
    "fsync",
    "fsync.done",
    "rotate",
    "rotate.done",
)


class SimulatedCrash(RuntimeError):
    """Raised by a WAL ``crash_hook`` to simulate ``kill -9`` at a chosen
    boundary. The writer dies exactly as a killed process would: file
    handles and the cross-process flock are released WITHOUT the close
    path's final fsync, on-disk bytes stay whatever previous flushes left
    (plus, for ``torn_bytes > 0`` at an "append" point, a partial frame —
    the torn tail recovery must truncate). The exception propagates to
    the caller, which treats the engine as dead and recovers through
    :meth:`~hashgraph_tpu_torch.wal.DurableEngine.recover` on a fresh writer."""

    def __init__(self, point: str, torn_bytes: int = 0):
        super().__init__(
            f"simulated crash at WAL point {point!r}"
            + (f" (torn after {torn_bytes} bytes)" if torn_bytes else "")
        )
        self.point = point
        self.torn_bytes = torn_bytes


def _fsync_dir(path: str) -> None:
    """Persist directory-entry changes. fsync on a segment file makes its
    DATA durable but not its EXISTENCE — after a power failure a freshly
    created file can vanish from the directory even though its blocks were
    synced, silently losing acknowledged records in a just-rotated segment.
    Best-effort on platforms without directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class WalWriter:
    """Segmented append-only record log. Thread-safe (one internal lock);
    appends are strictly serialized so LSN order is write order."""

    def __init__(
        self,
        directory: str | os.PathLike,
        *,
        segment_bytes: int = DEFAULT_SEGMENT_BYTES,
        fsync_policy: str = FSYNC_BATCH,
        fsync_interval: int = 256,
        tracer=None,
        crash_hook=None,
    ):
        if fsync_policy not in _POLICIES:
            raise ValueError(
                f"fsync_policy must be one of {_POLICIES}, got {fsync_policy!r}"
            )
        if segment_bytes <= 0:
            raise ValueError("segment_bytes must be positive")
        if fsync_interval <= 0:
            raise ValueError("fsync_interval must be positive")
        self._dir = os.fspath(directory)
        self._segment_bytes = segment_bytes
        self._policy = fsync_policy
        self._interval = fsync_interval
        self._tracer = tracer if tracer is not None else default_tracer
        self._lock = threading.Lock()
        self._since_fsync = 0
        self._closed = False
        # ``crash_hook(point)`` fires at every CRASH_POINTS boundary; it
        # may raise SimulatedCrash to kill the writer there (see _crash).
        # Deterministic-chaos seam — None in production.
        self._crash_hook = crash_hook
        os.makedirs(self._dir, exist_ok=True)

        # Cross-process exclusivity: two writers on one directory would
        # scan the same tail, mint duplicate LSNs, and interleave frames —
        # exactly the corruption the in-process reuse caches prevent, but
        # across processes (e.g. a supervisor restarting a server before
        # the old process finishes closing). flock is advisory and dies
        # with the process, so a crashed writer never wedges the lock.
        self._lock_file = open(os.path.join(self._dir, LOCK_FILENAME), "ab")
        try:
            import fcntl

            fcntl.flock(self._lock_file.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except ImportError:
            pass  # non-POSIX: best-effort, in-process reuse still guarded
        except OSError as exc:
            if exc.errno in (errno.EAGAIN, errno.EWOULDBLOCK, errno.EACCES):
                self._lock_file.close()
                raise ValueError(
                    f"WAL directory {self._dir!r} is locked by another live "
                    f"writer; a second writer would corrupt the log"
                ) from None
            # Any other errno means the filesystem cannot take the lock at
            # all (ENOTSUP/ENOLCK on some FUSE/network mounts) — degrade to
            # best-effort like the no-fcntl path rather than misreport an
            # unsupported mount as a live contending writer.

        segments = list_segments(self._dir)
        if segments:
            # Tail repair is confined to the ACTIVE (last) segment: sealed
            # segments were fully written before rotation fsynced them.
            base, path = segments[-1]
            records, valid_end, size = scan_segment(path)
            if valid_end < size:
                removed = truncate_segment(path, valid_end)
                self._tracer.count("wal.repair.truncated_bytes", removed)
            last_lsn = records[-1][0] if records else base - 1
            self._segment_base = base
            self._segment_size = valid_end
            self._next_lsn = last_lsn + 1
            self._file = open(path, "ab")
            self._segment_count = len(segments)
            self._total_bytes = valid_end + sum(
                os.path.getsize(p) for _, p in segments[:-1]
            )
        else:
            self._next_lsn = 1
            self._segment_base = 1
            self._segment_size = 0
            self._file = open(
                os.path.join(self._dir, segment_name(1)), "ab"
            )
            self._segment_count = 1
            self._total_bytes = 0
        # Scrape-time gauges for this writer's on-disk footprint; providers
        # sum across writers (one per durable peer), are unregistered on
        # close, and hold only a weakref so an abandoned writer can still
        # be collected.
        self._m_fsync = default_registry.histogram(WAL_FSYNC_SECONDS)
        ref = weakref.ref(self)

        def _segments() -> int:
            writer = ref()
            return writer._segment_count if writer is not None else 0

        def _bytes() -> int:
            writer = ref()
            return writer._total_bytes if writer is not None else 0

        self._gauge_handles = [
            default_registry.register_gauge(WAL_SEGMENT_COUNT, _segments, owner=self),
            default_registry.register_gauge(WAL_SEGMENT_BYTES, _bytes, owner=self),
        ]
        # The directory entries created above (the dir itself, the lock
        # file, a possibly-new active segment) must be durable before any
        # append is acknowledged.
        _fsync_dir(self._dir)

    # ── Introspection ──────────────────────────────────────────────────

    @property
    def directory(self) -> str:
        return self._dir

    @property
    def last_lsn(self) -> int:
        """LSN of the most recently appended record (0 = nothing logged)."""
        return self._next_lsn - 1

    @property
    def fsync_policy(self) -> str:
        return self._policy

    # ── Appending ──────────────────────────────────────────────────────

    def append(self, kind: int, payload: bytes) -> int:
        """Frame and write one record; returns its LSN. Runs the fsync
        policy and rotates the segment when the size threshold is crossed."""
        if F.BODY_LEAD_BYTES + len(payload) > F.MAX_RECORD:
            # Refuse BEFORE acknowledging: a frame whose body_len exceeds
            # MAX_RECORD is indistinguishable from garbage to the reader
            # (scan_buffer treats it as a torn tail), so writing it would
            # silently destroy this record and everything after it at
            # recovery. Callers with oversized batches must split them
            # (DurableEngine does).
            raise ValueError(
                f"WAL record body would be {F.BODY_LEAD_BYTES + len(payload)} "
                f"bytes, over the MAX_RECORD cap ({F.MAX_RECORD}); split the "
                f"batch across records"
            )
        with self._lock:
            if self._closed:
                raise ValueError("WalWriter is closed")
            lsn = self._next_lsn
            frame = F.encode_record(lsn, kind, payload)
            self._crash("append", frame)
            self._file.write(frame)
            # Flush to the page cache on EVERY append: the policy dial is
            # fsync (durability vs the OS/power failure), not write(2) —
            # an acknowledged record must survive a *process* crash under
            # every policy, and user-space buffering would break that.
            self._file.flush()
            self._crash("append.flushed")
            self._next_lsn = lsn + 1
            self._segment_size += len(frame)
            self._total_bytes += len(frame)
            self._tracer.count("wal.append_records")
            self._tracer.count("wal.append_bytes", len(frame))
            self._since_fsync += 1
            if self._policy == FSYNC_ALWAYS or (
                self._policy == FSYNC_BATCH and self._since_fsync >= self._interval
            ):
                self._fsync_locked()
            if self._segment_size >= self._segment_bytes:
                self._rotate_locked()
            return lsn

    def append_snapshot_mark(self, watermark: int | None = None) -> int:
        """Record that a snapshot now covers every record with
        ``lsn <= watermark`` (default: everything appended so far). The mark
        is always fsynced — compaction deletes data on its authority, so it
        must never be the record a crash loses."""
        with self._lock:
            if watermark is None:
                watermark = self._next_lsn - 1
        lsn = self.append(F.KIND_SNAPSHOT, F.encode_snapshot(watermark))
        self.sync()
        return lsn

    def sync(self) -> None:
        """Flush buffered frames and fsync, regardless of policy."""
        with self._lock:
            if not self._closed:
                self._fsync_locked()

    def rotate(self) -> None:
        """Seal the active segment now (no-op when it's empty). Checkpoints
        rotate before marking so the whole pre-snapshot history lives in
        sealed segments and compaction can drop all of it."""
        with self._lock:
            if self._closed:
                raise ValueError("WalWriter is closed")
            if self._segment_size:
                self._rotate_locked()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._fsync_locked()
            self._file.close()
            self._lock_file.close()  # releases the cross-process flock
            self._closed = True
            for handle in self._gauge_handles:
                handle.unregister()

    def abandon(self) -> None:
        """Simulated ``kill -9``: release the file handles and the
        cross-process flock WITHOUT the close path's final fsync. On-disk
        bytes stay exactly what previous flushes left (every append
        flushes to the page cache, so only an in-progress torn write —
        see :class:`SimulatedCrash` — can leave a partial frame). A fresh
        writer can then reopen the directory, which is how the chaos
        harness restarts a crashed peer in-process."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for handle in (self._file, self._lock_file):
                try:
                    handle.close()
                except OSError:
                    pass
            for handle in self._gauge_handles:
                handle.unregister()

    def set_crash_hook(self, hook) -> None:
        """Install/replace the crash hook (``None`` removes it)."""
        self._crash_hook = hook

    def _crash(self, point: str, frame: bytes | None = None) -> None:
        """Fire the crash hook at ``point`` (lock held). A raised
        :class:`SimulatedCrash` kills the writer in place: for a
        ``torn_bytes``-carrying crash at an "append" point the first k
        bytes of the un-written frame land on disk first (the torn write
        the recovery scan must detect and truncate), then handles and
        the flock are released crash-style and the exception
        propagates."""
        hook = self._crash_hook
        if hook is None:
            return
        try:
            hook(point)
        except SimulatedCrash as crash:
            if frame is not None and crash.torn_bytes > 0:
                self._file.write(frame[: min(crash.torn_bytes, len(frame))])
            try:
                self._file.close()  # flushes buffered bytes; no fsync
            except OSError:
                pass
            try:
                self._lock_file.close()
            except OSError:
                pass
            self._closed = True
            for handle in self._gauge_handles:
                handle.unregister()
            raise

    def __enter__(self) -> "WalWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ── Compaction ─────────────────────────────────────────────────────

    def compact(self, watermark: int) -> int:
        """Delete every SEALED segment fully covered by ``watermark`` (all
        its records have lsn <= watermark — equivalently, the next segment's
        base_lsn - 1 <= watermark). The active segment is never deleted,
        so the log always retains the latest snapshot mark. Returns the
        number of segments removed."""
        with self._lock:
            if self._closed:
                raise ValueError("WalWriter is closed")
            segments = list_segments(self._dir)
            removed = 0
            for (base, path), (next_base, _) in zip(segments, segments[1:]):
                if next_base - 1 <= watermark:
                    try:
                        dropped_bytes = os.path.getsize(path)
                    except OSError:
                        dropped_bytes = 0
                    os.remove(path)
                    removed += 1
                    self._segment_count -= 1
                    self._total_bytes -= dropped_bytes
            if removed:
                self._tracer.count("wal.compact.segments", removed)
            return removed

    # ── Internals ──────────────────────────────────────────────────────

    def _fsync_locked(self) -> None:
        self._crash("fsync")
        self._file.flush()
        start = time.perf_counter()
        os.fsync(self._file.fileno())
        self._crash("fsync.done")
        # wal_fsync_seconds is THE durability/throughput dial's price tag:
        # one observation per fsync syscall, always on.
        self._m_fsync.observe(time.perf_counter() - start)
        self._tracer.count("wal.fsync")
        self._since_fsync = 0

    def _rotate_locked(self) -> None:
        """Seal the current segment (flush + fsync so sealed segments are
        durable and repair stays confined to the active one) and open a new
        segment based at the next LSN."""
        self._crash("rotate")
        self._fsync_locked()
        self._file.close()
        self._segment_base = self._next_lsn
        self._segment_size = 0
        self._segment_count += 1
        self._file = open(
            os.path.join(self._dir, segment_name(self._segment_base)), "ab"
        )
        # Make the new segment's directory entry durable before records in
        # it are acknowledged (file fsync alone doesn't persist existence).
        _fsync_dir(self._dir)
        self._tracer.count("wal.rotate")
        self._crash("rotate.done")
