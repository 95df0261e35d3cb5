"""Scope-sharded consensus fleet: N independent engines over N devices,
one logical service.

Hashgraph-style virtual voting has no cross-scope dataflow (the reference
partitions all state by scope — src/storage.rs:188-194 — and every
decision reads only its own session's chain), so the fleet's unit of
sharding is the *scope*: every scope lives entirely on one shard, each
shard is a full :class:`~hashgraph_tpu_torch.engine.TorchConsensusEngine`
whose pool is pinned to its own device, and the only fleet-wide
communication is one device reduction per stats readout. This is the
data-parallel SPMD recipe (shard the batch axis, collective-reduce the
tallies) applied one level above
:class:`~hashgraph_tpu_torch.parallel.sharded.ShardedPool`: the pool
shards *slots* of one engine across a mesh; the fleet shards *scopes*
across engines, so host-side work (crypto, resolution, event emission)
scales with the shard count too — the multiplier the ROADMAP's "millions
of users" arithmetic needs (N shards × per-shard throughput).

Placement is rendezvous (highest-random-weight) hashing over the live
shard set: ``owner(scope) = argmax_s H(s, scope)`` with a keyed blake2b
digest. Deterministic across processes and restarts (no dependence on
Python's randomized ``hash()``), and *minimally disruptive* under elastic
membership — adding a shard steals only the scopes that now hash to it;
removing a shard reassigns only that shard's scopes (every other scope's
argmax is unchanged). Scopes with live state are additionally *pinned* to
their current shard so a membership change never silently splits an
existing scope's sessions; pins release on ``delete_scope`` (migration of
live scopes is the state-sync item, ROADMAP 4).

Each shard carries its own WAL (``wal_root/<shard-id>``) and its own
:class:`~hashgraph_tpu_torch.obs.health.HealthMonitor`, so one shard's
crash-recovery replay (``set_replay_mode`` gating and all) stalls only
its own slice of traffic: the router keeps dispatching to every other
shard while a recovering shard replays, and routes to the recovering
shard either raise :class:`ShardRecoveringError` or report
``SESSION_NOT_FOUND`` (the multihost misroute convention — "owned
elsewhere right now, retry/route"), caller's choice.

Port of the JAX package's ``parallel/fleet.py``. Devices are
``torch.device``s, and a list of them may name one device several times
(``[cuda:0] * 4`` is four shards on one card). The one change of
behaviour is the fleet tally (:meth:`ConsensusFleet.fleet_state_counts`):
the JAX fleet reduces on the devices only when every shard has a device
of its own, because a JAX ``Mesh`` cannot list a device twice; here the
per-shard count vectors are summed on the first shard's device whenever
every shard serves and there are at least two, shared devices included.
Both paths give equal counts.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..engine.pool import resolve_device
from ..errors import StatusCode
from ..obs import (
    FLEET_ROUTED_VOTES_TOTAL,
    FLEET_SHARDS,
    FLEET_SHARDS_RECOVERING,
    FLEET_SWEEP_SECONDS,
)
from ..obs import registry as default_registry
from ..obs.health import HealthMonitor
from ..obs.prometheus import _escape_label
from .mesh import consensus_mesh
from .sharded import _STATE_CODES, ShardedPool

__all__ = [
    "rendezvous_owner",
    "ScopePlacement",
    "FleetShard",
    "ConsensusFleet",
    "ShardRecoveringError",
    "ShardMigratingError",
]


class ShardRecoveringError(RuntimeError):
    """The scope's owning shard is mid-recovery (WAL replay in flight)."""

    def __init__(self, shard_id: str):
        super().__init__(
            f"shard {shard_id!r} is recovering; its scopes are briefly "
            "unavailable (other shards keep serving)"
        )
        self.shard_id = shard_id


class ShardMigratingError(ShardRecoveringError):
    """The scope's owning shard is mid-migration to another host.

    A subclass of :class:`ShardRecoveringError` so existing
    unavailability handling keeps working; ``retry_after`` carries the
    migration orchestrator's hint of when routes resume on the new
    owner — callers back off and retry instead of dropping votes (the
    federation driver buffers them as the migration tail)."""

    def __init__(self, shard_id: str, retry_after: float = 1.0):
        RuntimeError.__init__(
            self,
            f"shard {shard_id!r} is migrating; its scopes resume on the "
            f"new owner in ~{retry_after:.1f}s (retry with backoff)",
        )
        self.shard_id = shard_id
        self.retry_after = retry_after


# ── Placement ──────────────────────────────────────────────────────────


def _scope_bytes(scope) -> bytes:
    """Canonical cross-process bytes for a scope id (the multihost pid
    discipline: a default object repr embeds a memory address and would
    de-sync placement between peers)."""
    from ..engine.engine import _canonical_scope_bytes

    return _canonical_scope_bytes(scope)


def _weight(shard_id: str, scope_bytes: bytes) -> int:
    """HRW weight of (shard, scope): keyed blake2b, 64-bit. The shard id
    is the *key* (domain separation), the scope is the message — stable
    across processes, restarts, and shard-set membership changes."""
    return int.from_bytes(
        hashlib.blake2b(
            scope_bytes, digest_size=8, key=shard_id.encode()[:64]
        ).digest(),
        "big",
    )


def _check_shard_ids(shard_ids) -> None:
    """blake2b keys cap at 64 bytes; a longer shard id would silently
    truncate, giving two ids with a shared 64-byte prefix IDENTICAL
    weights for every scope — one of them would never own anything and
    removing the other would remap every scope at once. Reject outright."""
    for sid in shard_ids:
        if len(sid.encode()) > 64:
            raise ValueError(
                f"shard id {sid!r} exceeds 64 bytes; rendezvous weights "
                "key on the id and would silently truncate"
            )


def rendezvous_owner(scope, shard_ids) -> str:
    """The shard owning ``scope`` under rendezvous hashing: the highest
    64-bit keyed digest wins (ties — a 2^-64 event — break on shard id, so
    the choice is still total and deterministic). Adding/removing a shard
    perturbs only the scopes whose argmax involves that shard: the
    rendezvous invariant the placement property tests pin down."""
    if not shard_ids:
        raise ValueError("rendezvous over an empty shard set")
    _check_shard_ids(shard_ids)
    sb = _scope_bytes(scope)
    return max(shard_ids, key=lambda sid: (_weight(sid, sb), sid))


class ScopePlacement:
    """Deterministic scope→shard assignment over an elastic shard set.

    Thread-safe; memoizes owner lookups per scope and drops the memo on
    membership changes (rendezvous recomputation is cheap but the router
    probes it per batch row group)."""

    def __init__(self, shard_ids):
        self._ids = list(dict.fromkeys(shard_ids))
        if not self._ids:
            raise ValueError("placement needs at least one shard")
        _check_shard_ids(self._ids)
        self._cache: dict = {}
        self._lock = threading.Lock()

    @property
    def shard_ids(self) -> list:
        return list(self._ids)

    # Memo bound: under scope churn (transient scope names, probed
    # candidates that never materialize) the memo would otherwise grow
    # one entry per scope id forever. Recomputation is cheap, so a full
    # reset at the cap beats LRU bookkeeping on the lookup hot path.
    _CACHE_CAP = 65_536

    def owner(self, scope) -> str:
        with self._lock:
            sid = self._cache.get(scope)
            if sid is None:
                if len(self._cache) >= self._CACHE_CAP:
                    self._cache.clear()
                sid = rendezvous_owner(scope, self._ids)
                self._cache[scope] = sid
            return sid

    def evict(self, scope) -> None:
        """Drop a scope's memo entry (fleet.delete_scope calls this —
        deleted scopes are never looked up again)."""
        with self._lock:
            self._cache.pop(scope, None)

    def add_shard(self, shard_id: str) -> None:
        _check_shard_ids([shard_id])
        with self._lock:
            if shard_id in self._ids:
                raise ValueError(f"shard {shard_id!r} already placed")
            self._ids.append(shard_id)
            self._cache.clear()

    def remove_shard(self, shard_id: str, allow_empty: bool = False) -> None:
        with self._lock:
            if shard_id not in self._ids:
                raise ValueError(f"shard {shard_id!r} not placed")
            if len(self._ids) == 1 and not allow_empty:
                # A standalone fleet with zero shards can route nothing;
                # only a federation host DRAINED by migration (its scopes
                # live on other hosts now) legitimately reaches empty.
                raise ValueError("cannot remove the last shard")
            self._ids.remove(shard_id)
            self._cache.clear()


# ── Shards ─────────────────────────────────────────────────────────────


class FleetShard:
    """One engine + device + WAL + health slice of the fleet."""

    def __init__(self, shard_id: str, device, engine, wal_dir=None, index=0):
        self.shard_id = shard_id
        self.device = device
        self.engine = engine  # TorchConsensusEngine or DurableEngine wrapper
        self.wal_dir = wal_dir
        # Construction-time signer index, pinned for the shard's lifetime:
        # recovery MUST rebuild with signer_factory(index) so a
        # deterministic factory reproduces the pre-crash identity even
        # after unrelated membership changes reshuffled dict positions.
        self.index = index
        self.lock = threading.RLock()
        self.recovering = False
        # Migration freeze: the engine stays LIVE (it serves the snapshot
        # + WAL tail the adopting host catches up from) but routes raise
        # ShardMigratingError until the placement flips and the shard is
        # retired (or end_migration aborts).
        self.migrating = False
        self.migration_retry_after = 1.0
        # Scopes pinned against lifecycle demote/GC for the freeze window.
        self.migration_pinned: set = set()
        self.recovery_error: "BaseException | None" = None
        self.votes_routed = 0  # rows this shard was handed by the router
        # Last WAL replay's ReplayStats (recover_shard) — surfaced in
        # occupancy()/health_report() so a fleet operator sees mid-log
        # corruption (torn bytes, dropped segments, decode errors)
        # without ssh'ing into the shard.
        self.recovery_stats = None
        # Last peer catch-up's CatchUpReport (catch_up_shard).
        self.catchup_report = None

    @property
    def available(self) -> bool:
        return (
            not self.recovering
            and not self.migrating
            and self.engine is not None
        )

    def health_report(self, now=None) -> dict:
        return self.engine.health_report(now)

    def pool(self):
        return self.engine.pool()


def _close_engine(engine) -> None:
    """Close a shard engine if it is closable (DurableEngine flushes its
    WAL and releases the directory flock; a bare TorchConsensusEngine has
    no close). Duck-typed on the bound ``close`` method — NOT on the
    ``wal`` property, whose value is a WalWriter instance and therefore
    never callable."""
    close = getattr(engine, "close", None)
    if callable(close):
        close()


class ConsensusFleet:
    """Production topology: a router over scope-sharded engines.

    ``signer_factory(shard_index) -> ConsensusSignatureScheme`` mints each
    shard's signer (deterministic factories make recovery rebuild the
    same identity). One shard per entry of ``devices`` (default: every
    visible GPU, :func:`~.mesh.consensus_mesh`, which raises without one;
    tests pass ``[torch.device("cpu")] * n``) unless ``n_shards``
    overrides; with more shards than devices, shards round-robin over
    devices (one card or the CPU holding several shards).

    Entry points mirror the engine surface; batch entry points are
    *routers*: rows group by owning shard, dispatch per shard on a thread
    pool (each engine carries its own lock, so shards proceed
    concurrently and device work overlaps), and statuses stitch back in
    input order. Per-shard crypto amortization is inherited wholesale:
    ``deliver_proposals`` keeps the validated-chain watermark per shard,
    ``ingest_votes_pipelined`` keeps the crypto/device double-buffering
    per shard.
    """

    def __init__(
        self,
        signer_factory,
        *,
        n_shards: int | None = None,
        devices=None,
        capacity_per_shard: int = 1024,
        voter_capacity: int = 64,
        max_sessions_per_scope: int | None = None,
        wal_root: "str | None" = None,
        fsync_policy: str = "batch",
        verify_cache="default",
        shard_ids=None,
    ):
        from ..engine import TorchConsensusEngine

        self._engine_cls = TorchConsensusEngine
        self._signer_factory = signer_factory
        self._devices = (
            [resolve_device(d) for d in devices]
            if devices is not None
            else consensus_mesh()
        )
        if not self._devices:
            raise ValueError("fleet needs at least one device")
        if n_shards is None:
            n_shards = len(shard_ids) if shard_ids else len(self._devices)
        if n_shards < 1:
            raise ValueError("fleet needs at least one shard")
        if shard_ids is None:
            shard_ids = [f"shard-{k}" for k in range(n_shards)]
        if len(shard_ids) != n_shards:
            raise ValueError("shard_ids must supply one id per shard")
        self._capacity_per_shard = capacity_per_shard
        self._voter_capacity = voter_capacity
        self._max_sessions = (
            max_sessions_per_scope
            if max_sessions_per_scope is not None
            else capacity_per_shard + 16
        )
        self._wal_root = wal_root
        self._fsync_policy = fsync_policy
        self._verify_cache = verify_cache
        self._lock = threading.RLock()  # membership + pin map only
        self._shards: dict[str, FleetShard] = {}
        self._pins: dict = {}  # scope -> shard_id while scope has state
        for k, sid in enumerate(shard_ids):
            self._shards[sid] = self._build_shard(
                sid, self._devices[k % len(self._devices)], k
            )
        # Monotonic signer-index allocator: indices are never reused, so
        # an added shard can never mint an identity a removed (or live)
        # shard already holds under a deterministic factory.
        self._next_index = len(shard_ids)
        self.placement = ScopePlacement(shard_ids)
        # Router concurrency: one worker per shard on real accelerators
        # (dispatch threads mostly wait on device execution), capped at
        # the core count on CPU where shards share the host substrate and
        # extra threads only add GIL/scheduler contention.
        workers = (
            len(shard_ids)
            if self._devices[0].type != "cpu"
            else min(len(shard_ids), os.cpu_count() or 2)
        )
        self._executor = ThreadPoolExecutor(
            max_workers=max(2, workers), thread_name_prefix="fleet"
        )
        # Fleet observability: shard-count gauges ride the process-wide
        # registry (weakly owned — a dropped fleet's series vanish), the
        # routed-votes counter splits per shard for dashboards.
        self.metrics = default_registry
        ref_self = weakref.ref(self)
        self.metrics.register_gauge(
            FLEET_SHARDS,
            lambda: len(f._shards) if (f := ref_self()) is not None else 0,
            owner=self,
        )
        self.metrics.register_gauge(
            FLEET_SHARDS_RECOVERING,
            lambda: (
                sum(1 for s in f._shards.values() if s.recovering)
                if (f := ref_self()) is not None
                else 0
            ),
            owner=self,
        )
        self._m_routed = self.metrics.counter(FLEET_ROUTED_VOTES_TOTAL)
        self._m_routed_shard = {
            sid: self.metrics.counter(
                f'{FLEET_ROUTED_VOTES_TOTAL}{{shard="{_escape_label(sid)}"}}'
            )
            for sid in shard_ids
        }
        self._m_sweep = self.metrics.histogram(FLEET_SWEEP_SECONDS)

    # ── Construction / membership ──────────────────────────────────────

    def _build_shard(self, shard_id: str, device, index: int) -> FleetShard:
        pool = ShardedPool(
            self._capacity_per_shard, self._voter_capacity, mesh=[device]
        )
        engine = self._engine_cls(
            self._signer_factory(index),
            pool=pool,
            max_sessions_per_scope=self._max_sessions,
            verify_cache=self._verify_cache,
            health_monitor=HealthMonitor(),
        )
        # SLO plane: decisions this shard's engine makes land in the
        # process SLO engine's per-shard sliding windows under this label
        # (hashgraph_slo_decision_p99_seconds{shard="..."}).
        engine._slo_shard = shard_id
        wal_dir = None
        if self._wal_root is not None:
            from ..wal import DurableEngine

            wal_dir = os.path.join(self._wal_root, shard_id)
            engine = DurableEngine(
                engine, wal_dir, fsync_policy=self._fsync_policy
            )
        return FleetShard(shard_id, device, engine, wal_dir, index=index)

    @property
    def shard_ids(self) -> list:
        return self.placement.shard_ids

    @property
    def n_shards(self) -> int:
        return len(self._shards)

    def shard(self, shard_id: str) -> FleetShard:
        return self._shards[shard_id]

    def add_shard(self, shard_id: "str | None" = None, device=None) -> str:
        """Elastic scale-out: new scopes that rendezvous-hash to the new
        shard land there; every existing scope's owner is unchanged
        (pins + the rendezvous invariant)."""
        with self._lock:
            index = self._next_index
            self._next_index += 1
            if shard_id is None:
                shard_id = f"shard-{index}"
            device = (
                self._devices[index % len(self._devices)]
                if device is None
                else resolve_device(device)
            )
            shard = self._build_shard(shard_id, device, index)
            self.placement.add_shard(shard_id)  # validates uniqueness
            self._shards[shard_id] = shard
            self._m_routed_shard[shard_id] = self.metrics.counter(
                f'{FLEET_ROUTED_VOTES_TOTAL}{{shard="{_escape_label(shard_id)}"}}'
            )
            return shard_id

    def remove_shard(
        self, shard_id: str, force: bool = False, allow_empty: bool = False
    ) -> None:
        """Elastic scale-in. Refuses while the shard still owns pinned
        (live) scopes unless ``force`` — draining live scopes is the
        embedder's job (delete or snapshot-migrate them first).
        ``allow_empty`` permits removing the LAST shard: a federation
        host whose final shard migrated away serves nothing until a
        later ``add_shard`` (routes raise on the empty placement)."""
        with self._lock:
            pinned = [s for s, sid in self._pins.items() if sid == shard_id]
            if pinned and not force:
                raise ValueError(
                    f"shard {shard_id!r} still owns live scopes "
                    f"{pinned[:4]}...; drain them or pass force=True"
                )
            self.placement.remove_shard(shard_id, allow_empty=allow_empty)
            shard = self._shards.pop(shard_id)
            for s in pinned:
                del self._pins[s]
            _close_engine(shard.engine)

    def close(self) -> None:
        self._executor.shutdown(wait=True)
        for shard in self._shards.values():
            _close_engine(shard.engine)

    def __enter__(self) -> "ConsensusFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ── Routing ────────────────────────────────────────────────────────

    def owner_of(self, scope) -> str:
        with self._lock:
            pinned = self._pins.get(scope)
        return pinned if pinned is not None else self.placement.owner(scope)

    def _unavailable(self, sid: str) -> ShardRecoveringError:
        """The typed unavailability for routes to shard ``sid``:
        migrating shards carry the retry-after hint, everything else is
        the recovery error."""
        shard = self._shards[sid]
        if shard.migrating:
            return ShardMigratingError(sid, shard.migration_retry_after)
        return ShardRecoveringError(sid)

    def _shard_for(self, scope, pin: bool = False) -> FleetShard:
        sid = self.owner_of(scope)
        shard = self._shards[sid]
        if not shard.available:
            raise self._unavailable(sid)
        if pin:
            with self._lock:
                self._pins.setdefault(scope, sid)
        return shard

    def _engine_for(self, scope, pin: bool = False):
        return self._shard_for(scope, pin).engine

    def _live_engine(self, sid: str):
        """The shard's engine read ONCE — dispatch workers run after the
        grouping-time availability check, so a crash_shard landing in
        between must surface as the typed unavailability error, not an
        AttributeError on a None engine."""
        engine = self._shards[sid].engine
        if engine is None:
            raise self._unavailable(sid)
        return engine

    # Control plane — routed scope-granular passthroughs. Mutating entry
    # points pin the scope to its owner so elastic membership changes
    # never split a live scope's sessions across shards.

    def scope(self, scope):
        return self._engine_for(scope, pin=True).scope(scope)

    def set_scope_config(self, scope, config) -> None:
        self._engine_for(scope, pin=True).set_scope_config(scope, config)

    def get_scope_config(self, scope):
        return self._engine_for(scope).get_scope_config(scope)

    def create_proposal(self, scope, request, now, config=None):
        return self._engine_for(scope, pin=True).create_proposal(
            scope, request, now, config
        )

    def create_proposals(self, scope, requests, now, config=None):
        return self._engine_for(scope, pin=True).create_proposals(
            scope, requests, now, config
        )

    def process_incoming_proposal(self, scope, proposal, now, config=None):
        return self._engine_for(scope, pin=True).process_incoming_proposal(
            scope, proposal, now, config
        )

    def process_incoming_vote(self, scope, vote, now) -> None:
        self._engine_for(scope).process_incoming_vote(scope, vote, now)

    def cast_vote(self, scope, proposal_id, choice, now):
        return self._engine_for(scope).cast_vote(scope, proposal_id, choice, now)

    def voter_gid(self, scope, owner: bytes) -> int:
        """Interned voter id ON THE OWNING SHARD (gids are per-engine;
        columnar rows must carry the owner shard's interning)."""
        return self._engine_for(scope).voter_gid(owner)

    def get_proposal(self, scope, proposal_id):
        return self._engine_for(scope).get_proposal(scope, proposal_id)

    def get_consensus_result(self, scope, proposal_id):
        return self._engine_for(scope).get_consensus_result(scope, proposal_id)

    def get_scope_stats(self, scope):
        return self._engine_for(scope).get_scope_stats(scope)

    def explain_decision(self, scope, proposal_id) -> dict:
        return self._engine_for(scope).explain_decision(scope, proposal_id)

    def delete_scope(self, scope) -> None:
        self._engine_for(scope).delete_scope(scope)
        with self._lock:
            self._pins.pop(scope, None)
        self.placement.evict(scope)

    def event_bus_of(self, scope):
        return self._engine_for(scope).event_bus()

    # ── Data plane: the batching router ────────────────────────────────

    def _group_scopes(self, scopes, unavailable_ok: bool):
        """scope list -> {shard_id: [(ordinal, scope), ...]} plus the
        set of ordinals whose shard is unavailable (empty unless
        ``unavailable_ok``; otherwise the route raises)."""
        groups: dict[str, list] = {}
        down: set[int] = set()
        for k, scope in enumerate(scopes):
            sid = self.owner_of(scope)
            if not self._shards[sid].available:
                if not unavailable_ok:
                    raise self._unavailable(sid)
                down.add(k)
                continue
            groups.setdefault(sid, []).append((k, scope))
        return groups, down

    def _note_routed(self, sid: str, rows: int) -> None:
        shard = self._shards[sid]
        shard.votes_routed += rows
        self._m_routed.inc(rows)
        counter = self._m_routed_shard.get(sid)
        if counter is not None:
            counter.inc(rows)

    def ingest_columnar(
        self,
        scope,
        proposal_ids,
        voter_gids,
        values,
        now,
        max_depth: int = 8,
        wire_votes=None,
    ) -> np.ndarray:
        """Single-scope columnar ingest on the owning shard."""
        shard = self._shard_for(scope)  # raises before anything counts
        self._note_routed(shard.shard_id, len(proposal_ids))
        return shard.engine.ingest_columnar(
            scope, proposal_ids, voter_gids, values, now,
            max_depth=max_depth, wire_votes=wire_votes,
        )

    def ingest_columnar_multi(
        self,
        scopes,
        scope_idx,
        proposal_ids,
        voter_gids,
        values,
        now,
        max_depth: int = 8,
        wire_votes=None,
        unavailable_ok: bool = False,
    ) -> np.ndarray:
        """THE fleet throughput path: a mixed-scope columnar batch split
        by owning shard and dispatched to every shard concurrently (one
        ``ingest_columnar_multi`` per shard on the fleet executor — each
        shard's device pipeline runs in parallel), statuses stitched back
        in input order.

        Rows for a recovering shard raise :class:`ShardRecoveringError`
        unless ``unavailable_ok``, in which case they report
        ``SESSION_NOT_FOUND`` (the multihost misroute convention: owned
        elsewhere right now — route again later).
        """
        proposal_ids = np.asarray(proposal_ids, np.int64)
        scope_idx = np.asarray(scope_idx, np.int64)
        voter_gids = np.asarray(voter_gids, np.int64)
        values = np.asarray(values, bool)
        batch = len(proposal_ids)
        statuses = np.full(batch, int(StatusCode.SESSION_NOT_FOUND), np.int32)
        groups, _ = self._group_scopes(scopes, unavailable_ok)
        wire_norm = None
        if wire_votes is not None:
            from ..wire import normalize_wire_votes

            wire_norm = normalize_wire_votes(wire_votes, batch)

        def dispatch(sid: str, members: list):
            ordinals = np.fromiter((k for k, _ in members), np.int64)
            local_of = np.full(len(scopes), -1, np.int64)
            local_of[ordinals] = np.arange(len(members))
            rows = np.nonzero(local_of[scope_idx] >= 0)[0]
            if rows.size == 0:
                return rows, np.empty(0, np.int32)
            sub_wire = None
            if wire_norm is not None:
                blob, offsets = wire_norm
                sub_wire = [
                    bytes(blob[offsets[r] : offsets[r + 1]]) for r in rows
                ]
            engine = self._live_engine(sid)
            self._note_routed(sid, int(rows.size))
            sub = engine.ingest_columnar_multi(
                [scope for _, scope in members],
                local_of[scope_idx[rows]],
                proposal_ids[rows],
                voter_gids[rows],
                values[rows],
                now,
                max_depth=max_depth,
                wire_votes=sub_wire,
            )
            return rows, sub

        futures = [
            self._executor.submit(dispatch, sid, members)
            for sid, members in groups.items()
        ]
        for future in futures:
            rows, sub = future.result()
            statuses[rows] = sub
        return statuses

    def ingest_votes(
        self, items, now, pre_validated: bool = False,
        unavailable_ok: bool = False,
    ) -> np.ndarray:
        """Routed :meth:`TorchConsensusEngine.ingest_votes`: items group by
        their scope's owning shard, shards ingest concurrently, statuses
        return in input order."""
        statuses = np.full(
            len(items), int(StatusCode.SESSION_NOT_FOUND), np.int32
        )
        groups: dict[str, list[int]] = {}
        for k, (scope, _) in enumerate(items):
            sid = self.owner_of(scope)
            if not self._shards[sid].available:
                if not unavailable_ok:
                    raise self._unavailable(sid)
                continue
            groups.setdefault(sid, []).append(k)

        def dispatch(sid: str, idxs: list[int]):
            engine = self._live_engine(sid)
            self._note_routed(sid, len(idxs))
            sub = engine.ingest_votes(
                [items[k] for k in idxs], now, pre_validated=pre_validated
            )
            return idxs, sub

        futures = [
            self._executor.submit(dispatch, sid, idxs)
            for sid, idxs in groups.items()
        ]
        for future in futures:
            idxs, sub = future.result()
            statuses[idxs] = sub
        return statuses

    def ingest_votes_pipelined(
        self, batches, now, pre_validated: bool = False
    ) -> "list[np.ndarray]":
        """Routed pipelined ingest: each shard runs its OWN
        crypto/device double-buffer over its slice of every batch (batch
        cadence preserved per shard, empty slices included), shards run
        concurrently, per-batch statuses stitch back in input order."""
        batches = [list(b) for b in batches]
        results = [
            np.full(len(b), int(StatusCode.SESSION_NOT_FOUND), np.int32)
            for b in batches
        ]
        per_shard: dict[str, list[list[int]]] = {}
        for b, items in enumerate(batches):
            for k, (scope, _) in enumerate(items):
                sid = self.owner_of(scope)
                if not self._shards[sid].available:
                    raise self._unavailable(sid)
                per_shard.setdefault(
                    sid, [[] for _ in batches]
                )[b].append(k)

        def dispatch(sid: str, slices: "list[list[int]]"):
            engine = self._live_engine(sid)
            self._note_routed(sid, sum(len(s) for s in slices))
            sub = engine.ingest_votes_pipelined(
                [[batches[b][k] for k in idxs]
                 for b, idxs in enumerate(slices)],
                now,
                pre_validated=pre_validated,
            )
            return slices, sub

        futures = [
            self._executor.submit(dispatch, sid, slices)
            for sid, slices in per_shard.items()
        ]
        for future in futures:
            slices, sub = future.result()
            for b, (idxs, st) in enumerate(zip(slices, sub)):
                results[b][idxs] = st
        return results

    def deliver_proposals(self, items, now, configs=None) -> "list[int]":
        """Routed gossip delivery: per-shard order preserved, so each
        shard's validated-chain watermark semantics are exactly the
        engine's (a batch equals the same deliveries one by one)."""
        if configs is not None and len(configs) != len(items):
            raise ValueError("configs must supply one entry per item")
        statuses = [int(StatusCode.SESSION_NOT_FOUND)] * len(items)
        groups: dict[str, list[int]] = {}
        for k, (scope, _) in enumerate(items):
            shard = self._shard_for(scope, pin=True)
            groups.setdefault(shard.shard_id, []).append(k)

        def dispatch(sid: str, idxs: list[int]):
            sub = self._live_engine(sid).deliver_proposals(
                [items[k] for k in idxs],
                now,
                configs=(
                    [configs[k] for k in idxs] if configs is not None else None
                ),
            )
            return idxs, sub

        futures = [
            self._executor.submit(dispatch, sid, idxs)
            for sid, idxs in groups.items()
        ]
        for future in futures:
            idxs, sub = future.result()
            for k, code in zip(idxs, sub):
                statuses[k] = int(code)
        return statuses

    def deliver_proposal(self, scope, proposal, now, config=None) -> int:
        return self.deliver_proposals(
            [(scope, proposal)], now,
            configs=[config] if config is not None else None,
        )[0]

    # ── Sweeps / tallies / health ──────────────────────────────────────

    def sweep_timeouts(self, now) -> list:
        """Fleet-wide timeout sweep: every AVAILABLE shard sweeps
        concurrently (a recovering shard's sweep is deferred to its
        recovery replay — its sessions are frozen with it), results
        concatenated. One fleet tally (:meth:`fleet_state_counts`) after
        the sweep gives the global histogram."""
        t0 = time.perf_counter()

        def sweep_one(sid: str):
            engine = self._shards[sid].engine
            # A shard crashed between the availability check and this
            # worker running is simply not swept this pass (its sessions
            # are frozen with it) — same as arriving one check earlier.
            return engine.sweep_timeouts(now) if engine is not None else []

        futures = [
            self._executor.submit(sweep_one, sid)
            for sid, shard in self._shards.items()
            if shard.available
        ]
        swept = [item for future in futures for item in future.result()]
        self._m_sweep.observe(time.perf_counter() - t0)
        return swept

    def _tally(self):
        """The device the fleet tally reduces on (the first shard's), or
        None when there are fewer than two shards (host mirror). Shards
        may share a device: unlike a JAX mesh, the reduction needs no
        device of its own per shard."""
        shards = list(self._shards.values())
        return shards[0].device if len(shards) >= 2 else None

    def fleet_state_counts(self) -> dict[int, int]:
        """Global slot-state histogram across every shard.

        Device path (every shard serving, at least two of them): each
        shard's pool counts its block on its device as an ``int64[5]``
        vector (no host copy), the vectors move to the first shard's
        device and are summed there, and the sum is the one host copy.
        With one shard, or with any shard unavailable, the host mirrors
        are summed instead.
        """
        shards = [s for s in self._shards.values() if s.available]
        # A recovering shard's slots are frozen with it — the tally covers
        # the serving fleet (and a readout mid-recovery must not crash on
        # the crashed shard's dropped engine). The device reduction needs
        # every shard's block, so any unavailable shard routes the readout
        # through the host mirrors.
        target = self._tally() if len(shards) == len(self._shards) else None
        if target is None:
            total = {code: 0 for code in _STATE_CODES}
            for shard in shards:
                for code, count in shard.pool().state_counts().items():
                    total[code] = total.get(code, 0) + count
            return total
        local = [
            shard.pool().device_state_counts().to(target) for shard in shards
        ]
        agg = torch.stack(local).sum(dim=0).cpu().numpy()
        return {code: int(c) for code, c in zip(_STATE_CODES, agg)}

    @staticmethod
    def _recovery_overlay(shard: FleetShard) -> dict:
        """Durability-provenance block for one shard's readouts: how its
        state was (re)built. ``wal_recover`` carries the last local
        replay's corruption counters (nonzero torn_bytes past the tail /
        dropped_segments / decode_errors = acknowledged records replay
        could not reproduce — the operator-visible mid-log-corruption
        signal); ``catch_up`` summarizes the last peer catch-up."""
        out: dict = {}
        stats = shard.recovery_stats
        if stats is not None:
            out["wal_recover"] = {
                "records_applied": stats.records_applied,
                "votes_replayed": stats.votes_replayed,
                "torn_bytes": stats.torn_bytes,
                "dropped_segments": stats.segments_dropped,
                "decode_errors": len(stats.errors),
            }
        report = shard.catchup_report
        if report is not None:
            out["catch_up"] = {
                "watermark": report.watermark,
                "sessions_installed": report.sessions_installed,
                "votes_verified": report.votes_verified,
                "tail_records": report.tail_records,
                "trust_snapshot": report.trust_snapshot,
                "seconds": report.seconds,
            }
        return out

    def occupancy(self) -> dict:
        """Per-shard breakdown: engine occupancy + per-device slot
        occupancy (the MULTICHIP artifact's per-device view), plus the
        shard's recovery provenance (see :meth:`_recovery_overlay`)."""
        out = {}
        for sid, shard in self._shards.items():
            if not shard.available:
                out[sid] = {
                    "recovering": shard.recovering or shard.engine is None,
                    "migrating": shard.migrating,
                    "recovery_error": (
                        repr(shard.recovery_error)
                        if shard.recovery_error is not None
                        else None
                    ),
                }
                continue
            entry = dict(shard.engine.occupancy())
            entry["device"] = str(shard.device)
            entry["votes_routed"] = shard.votes_routed
            entry["per_device_slots_used"] = (
                shard.pool().per_device_occupancy()
            )
            entry.update(self._recovery_overlay(shard))
            out[sid] = entry
        return out

    def occupancy_totals(self) -> dict:
        """Fleet-wide occupancy sum over the per-shard breakdown — the
        shared rollup (:mod:`hashgraph_tpu_torch.parallel.rollup`), so the
        engine's keys (tier counters included) aggregate identically here
        and on the federation adapter."""
        from .rollup import aggregate_occupancy

        return aggregate_occupancy(self.occupancy().values())

    def health_report(self, now=None) -> dict:
        """Per-shard health (each shard carries a private monitor, so one
        noisy shard's evidence never pollutes another's scorecards); each
        serving shard's report also carries its recovery provenance
        (``wal_recover`` corruption counters / ``catch_up`` summary)."""
        out = {}
        for sid, shard in self._shards.items():
            if not shard.available:
                out[sid] = {
                    "recovering": shard.recovering or shard.engine is None,
                    "migrating": shard.migrating,
                    "recovery_error": (
                        repr(shard.recovery_error)
                        if shard.recovery_error is not None
                        else None
                    ),
                }
                continue
            report = dict(shard.health_report(now))
            report.update(self._recovery_overlay(shard))
            out[sid] = report
        return out

    # ── Migration freeze (re-homing onto another host) ─────────────────

    def begin_migration(
        self, shard_id: str, retry_after: float = 1.0
    ) -> None:
        """Freeze a shard for re-homing: the engine stays LIVE so the
        bridge can serve its consistent snapshot + WAL tail to the
        adopting host, but every route raises
        :class:`ShardMigratingError` (with ``retry_after`` as the
        caller's backoff hint) until :meth:`end_migration` aborts or
        ``remove_shard`` retires the shard after the placement flip."""
        shard = self._shards[shard_id]
        if shard.engine is None or shard.recovering:
            raise ValueError(f"shard {shard_id!r} is not serving")
        shard.migration_retry_after = retry_after
        shard.migrating = True
        # Freeze the tier too: pin every scope so no lifecycle sweep can
        # demote/GC state while its snapshot+tail is being adopted (the
        # fleet sweep already skips migrating shards; the pin also covers
        # embedders driving the shard engine's sweep directly).
        engine = getattr(shard.engine, "engine", shard.engine)
        pin = getattr(engine, "pin_scope", None)
        if pin is not None:
            pinned = {scope for scope, _ in engine.session_keys()}
            for scope in pinned:
                pin(scope)
            shard.migration_pinned = pinned

    def end_migration(self, shard_id: str) -> None:
        """Abort a migration freeze: the shard resumes serving locally
        (the placement never flipped, so no state moved)."""
        shard = self._shards[shard_id]
        shard.migrating = False
        engine = getattr(shard.engine, "engine", shard.engine)
        unpin = getattr(engine, "unpin_scope", None)
        if unpin is not None:
            for scope in getattr(shard, "migration_pinned", ()):
                unpin(scope)
            shard.migration_pinned = set()

    def pin_scope(self, scope, shard_id: str) -> None:
        """Pin ``scope`` to ``shard_id`` explicitly. The adopting side
        of a shard migration uses this to mirror the source fleet's
        live-scope pins: the migrated sessions live on the adopted shard
        regardless of where this fleet's own rendezvous would have
        placed them."""
        if shard_id not in self._shards:
            raise ValueError(f"unknown shard {shard_id!r}")
        with self._lock:
            self._pins[scope] = shard_id

    # ── Crash / recovery ───────────────────────────────────────────────

    def crash_shard(self, shard_id: str) -> None:
        """Simulate a shard engine crash: drop the in-memory engine and
        release its WAL (the surviving log is the recovery source). The
        shard routes as unavailable until :meth:`recover_shard` swaps a
        replayed engine back in; every other shard keeps serving."""
        if self._wal_root is None:
            raise ValueError("crash/recovery needs wal_root (nothing to replay)")
        shard = self._shards[shard_id]
        with shard.lock:
            shard.recovering = True
            if shard.engine is not None:
                # Close the writer so the fresh recovery writer can take
                # the directory flock; real crash durability (torn tails,
                # partial fsync) is the WAL suite's coverage.
                shard.engine.close()
            shard.engine = None

    def recover_shard(
        self,
        shard_id: str,
        background: bool = False,
        on_record=None,
    ):
        """Rebuild a crashed shard from its WAL: fresh engine on the same
        device, ``DurableEngine.recover()`` replay (``set_replay_mode``
        gating included), then swap in and resume routing. Only THIS
        shard's traffic waits; the router never blocks other shards on
        the replay (the non-stall contract, tested by
        tests/test_fleet.py::test_recovery_does_not_stall_other_shards).

        ``background=True`` runs the replay on a daemon thread and
        returns it (join for completion). A FAILED background replay
        never resolves silently: the exception is stored as
        ``shard.recovery_error`` (surfaced by :meth:`occupancy` and
        :meth:`health_report`), the shard stays unavailable, and
        ``recover_shard`` may be retried. Foreground mode re-raises.
        ``on_record(lsn, kind)`` forwards to
        :func:`hashgraph_tpu_torch.wal.recovery.replay` for progress
        observation.
        """
        shard = self._shards[shard_id]

        def _recover():
            with shard.lock:
                shard.recovery_error = None
                try:
                    # Rebuild with the shard's CONSTRUCTION index (not
                    # its current dict position — membership changes
                    # reshuffle that): a deterministic signer_factory
                    # then reproduces the pre-crash identity exactly.
                    # Construction failures (held flock, device/signer
                    # errors) are captured too, not just replay failures.
                    fresh = self._build_shard(
                        shard_id, shard.device, shard.index
                    )
                    try:
                        stats = fresh.engine.recover(on_record=on_record)
                    except BaseException:
                        _close_engine(fresh.engine)  # release the dir
                        raise                        # flock for a retry
                except BaseException as exc:
                    shard.recovery_error = exc
                    raise
                shard.engine = fresh.engine
                shard.wal_dir = fresh.wal_dir
                shard.recovery_stats = stats
                shard.recovering = False

        if background:
            def _recover_guarded():
                try:
                    _recover()
                except BaseException:
                    # Already recorded on shard.recovery_error; don't let
                    # the daemon thread spray a traceback as the only
                    # signal. The shard stays unavailable by design.
                    pass

            thread = threading.Thread(
                target=_recover_guarded, name=f"recover-{shard_id}", daemon=True
            )
            thread.start()
            return thread
        _recover()
        return None

    def catch_up_shard(
        self,
        shard_id: str,
        host: str,
        port: int,
        source_peer: int,
        *,
        trust_snapshot: bool = False,
        background: bool = False,
        wipe_local_wal: bool = True,
    ):
        """Rebuild a shard FROM A PEER instead of its local WAL — the
        recovery path for a shard whose log is gone, corrupted, or too
        far behind to matter: a fresh engine on the shard's device
        catches up via :class:`~hashgraph_tpu_torch.sync.CatchUpClient`
        (snapshot install with one batched verify pass, then WAL-tail
        the suffix) from ``source_peer`` on the bridge at
        ``(host, port)``, then swaps in and resumes routing. Like
        :meth:`recover_shard`, only THIS shard's traffic waits.

        ``wipe_local_wal`` (default) clears the shard's local WAL
        directory first: catch-up REPLACES local history, and appending
        post-catch-up traffic after stale pre-crash records would leave
        a log no future replay could interpret. The shard's new local
        WAL then covers only post-catch-up traffic — checkpoint the
        shard once it serves if it must survive its own crash without
        re-syncing (the snapshot install itself is not logged, by the
        ``DurableEngine.load_from_storage`` contract).

        ``trust_snapshot`` skips the snapshot's signature verification
        (operator-trusted sources only). ``background`` mirrors
        :meth:`recover_shard`: failures land on ``shard.recovery_error``
        and the shard stays unavailable for a retry. The installed
        state's provenance is surfaced as ``catch_up`` in
        :meth:`occupancy` / :meth:`health_report`.
        """
        import shutil

        from ..sync import CatchUpClient

        shard = self._shards[shard_id]
        with shard.lock:
            shard.recovering = True
            if shard.engine is not None:
                _close_engine(shard.engine)  # release the WAL flock
                shard.engine = None

        def _catch_up():
            with shard.lock:
                shard.recovery_error = None
                try:
                    if wipe_local_wal and shard.wal_dir is not None:
                        shutil.rmtree(shard.wal_dir, ignore_errors=True)
                    fresh = self._build_shard(
                        shard_id, shard.device, shard.index
                    )
                    try:
                        with CatchUpClient(host, port, source_peer) as client:
                            report = client.catch_up(
                                fresh.engine, trust_snapshot=trust_snapshot
                            )
                    except BaseException:
                        _close_engine(fresh.engine)  # release the dir
                        raise                        # flock for a retry
                except BaseException as exc:
                    shard.recovery_error = exc
                    raise
                shard.engine = fresh.engine
                shard.wal_dir = fresh.wal_dir
                shard.catchup_report = report
                shard.recovery_stats = None  # state is the peer's, not the log's
                shard.recovering = False

        if background:
            def _catch_up_guarded():
                try:
                    _catch_up()
                except BaseException:
                    pass  # recorded on shard.recovery_error, by design

            thread = threading.Thread(
                target=_catch_up_guarded,
                name=f"catchup-{shard_id}",
                daemon=True,
            )
            thread.start()
            return thread
        _catch_up()
        return None
