"""Durability for the port: a segmented write-ahead log and crash recovery.

A copy of the JAX package's ``wal`` over
:class:`~hashgraph_tpu_torch.engine.TorchConsensusEngine`; the two packages
write byte-identical logs for the same calls and recover each other's.

- :mod:`.format` — CRC32-framed record layout over the canonical
  ``wire.py`` Proposal/Vote bytes (no second serialization format);
- :mod:`.segment` — ``wal-<base_lsn>.seg`` segmented files, sealed on
  rotation, torn-tail repair confined to the active segment;
- :mod:`.writer` — :class:`WalWriter` with per-record / batched-every-N /
  off fsync policies, rotation, and snapshot-anchored compaction;
- :mod:`.recovery` — :func:`scan` + :func:`replay` through the engine's
  own batch ingest paths (recovered traffic is validated like live
  traffic, torn tails truncate at the first bad frame);
- :mod:`.durable` — :class:`DurableEngine`, the log-before-acknowledge
  engine wrapper with :meth:`~DurableEngine.recover` and
  :meth:`~DurableEngine.checkpoint`.

Quick start::

    from hashgraph_tpu_torch import InMemoryConsensusStorage, TorchConsensusEngine
    from hashgraph_tpu_torch.wal import DurableEngine

    durable = DurableEngine(engine, "/var/lib/app/wal", fsync_policy="batch")
    durable.recover(storage)          # snapshot + WAL tail -> warm engine
    durable.create_proposal(...)      # logged before acknowledged
    durable.checkpoint(storage)       # snapshot, mark, drop covered segments

Tracing: the subsystem emits ``wal.append_records`` / ``wal.append_bytes``
/ ``wal.fsync`` / ``wal.rotate`` / ``wal.recover.records`` /
``wal.compact.segments`` / ``wal.repair.truncated_bytes`` counters, plus
the recovery-loss counters ``wal.recover.torn_bytes`` /
``wal.recover.dropped_segments`` / ``wal.recover.decode_errors``, through
:mod:`hashgraph_tpu_torch.tracing` (no-ops until the tracer is enabled), and
the ``wal_*`` families of :mod:`hashgraph_tpu_torch.obs`.
"""

from . import format, recovery, segment
from .durable import DurableEngine
from .recovery import ReplayStats, UnsupportedRecord, WalScan, replay, scan
from .writer import (
    CRASH_POINTS,
    FSYNC_ALWAYS,
    FSYNC_BATCH,
    FSYNC_OFF,
    SimulatedCrash,
    WalWriter,
)

__all__ = [
    "DurableEngine",
    "WalWriter",
    "ReplayStats",
    "UnsupportedRecord",
    "WalScan",
    "replay",
    "scan",
    "FSYNC_ALWAYS",
    "FSYNC_BATCH",
    "FSYNC_OFF",
    "CRASH_POINTS",
    "SimulatedCrash",
    "format",
    "recovery",
    "segment",
]
