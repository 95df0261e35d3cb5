"""Federated multi-host fleet: (host, shard) placement, cross-host vote
routing over the gossip fabric, and live shard migration under traffic.

The scaling math for the north-star workload is ``hosts x shards x
per-shard throughput``, and before this module the repo only multiplied
the last two: :class:`~hashgraph_tpu_torch.parallel.fleet.ConsensusFleet` is
single-process, and the gossip fabric moves votes between processes but
replicates rather than partitions. Federation composes the two proven
layers into one topology (the operational template of gossip-based BFT
deployments — Buchman et al., "The latest gossip on BFT consensus"):

- **Placement** is two-level rendezvous hashing with the fleet's
  pin-until-delete elasticity (:class:`FederationPlacement`): HRW over
  the host set picks the owning *host*, HRW over that host's homed
  shards picks the *shard*. Adding or removing a host remaps only that
  host's scopes; scopes with live state are pinned to their shard and
  never split — a pinned scope follows its shard even when the shard is
  re-homed onto another host.
- **A host** runs a :class:`FleetGroup`: the local
  :class:`ConsensusFleet` (one engine per device) fronted by ONE
  bridge peer whose engine is a :class:`FleetEngineAdapter` — the
  single-engine surface the wire expects, routed per scope to the
  owning shard. Coalesced ``OP_VOTE_BATCH`` frames land on the host's
  zero-copy columnar wire ingest, split per shard
  (:func:`hashgraph_tpu_torch.bridge.columnar.pack_rows`) and dispatched
  concurrently.
- **Routing**: votes for a remotely-owned scope ride the gossip fabric
  (``GossipTransport`` + ``VoteCoalescer`` + ``OP_VOTE_BATCH``) to the
  owning host instead of erroring SESSION_NOT_FOUND. Fleet-wide
  ``state_counts`` aggregates via real cross-host collectives where the
  backend supports them (:func:`tally_path` consults
  :func:`~hashgraph_tpu_torch.parallel.multihost.collectives_available`, the
  runtime promotion of what used to be a test skip-guard) and via the
  fabric's ``OP_FLEET_TALLY`` frames where it doesn't.
- **Live shard migration** (:func:`migrate_shard`): freeze the shard
  (routes raise the typed
  :class:`~hashgraph_tpu_torch.parallel.fleet.ShardMigratingError` with a
  retry-after hint — votes back off, they are never dropped), snapshot
  at an exact WAL watermark (``DurableEngine.capture_consistent``
  behind the PR-8 sync wire format), re-home onto the adopting host via
  ``catch_up_shard`` (snapshot install + WAL tailing — Ongaro's
  snapshot-install/log-tail recipe), assert source/destination
  ``state_fingerprint`` equality, flip the placement atomically, replay
  the drained tail, retire the source. All under sustained traffic.

Port of the JAX package's ``parallel/federation.py`` over the port's
fleet, bridge, gossip and sync; the wire is the JAX package's, so hosts
of either package federate. Two differences: :class:`FleetGroup` takes
``devices`` (its fleet's devices: every visible GPU by default, raising
without one), and the collective arm of :func:`tally_path` is an
all-gather over the gloo process group of
:mod:`~hashgraph_tpu_torch.parallel.multihost`, which gloo runs on the
CPU too.
"""

from __future__ import annotations

import threading
import time
import weakref

import numpy as np

from ..errors import StatusCode
from ..obs import (
    FEDERATION_HOSTS,
    FEDERATION_MIGRATION_SECONDS,
    FEDERATION_MIGRATIONS_TOTAL,
    FEDERATION_REMOTE_ROUTED_VOTES_TOTAL,
    flight_recorder,
    slo_engine,
)
from ..obs import registry as default_registry
from .rollup import (
    aggregate_occupancy,
    merge_metric_states,
    merge_slo_states,
)
from .fleet import (
    ConsensusFleet,
    ShardMigratingError,
    _check_shard_ids,
    rendezvous_owner,
)

__all__ = [
    "FederationPlacement",
    "FleetEngineAdapter",
    "FleetGroup",
    "FederationDriver",
    "MigrationError",
    "migrate_shard",
    "tally_path",
    "ShardMigratingError",
]

_OK = int(StatusCode.OK)
_ALREADY = int(StatusCode.ALREADY_REACHED)
_NOT_FOUND = int(StatusCode.SESSION_NOT_FOUND)


class MigrationError(RuntimeError):
    """A shard migration failed integrity checks (the placement was NOT
    flipped; the source still owns the shard)."""


def _retry_hint(exc) -> float:
    """The retry-after seconds a STATUS_SHARD_MIGRATING response
    carries (the message tail); 1.0 when unparseable."""
    try:
        return float(str(exc).rsplit(":", 1)[-1].strip())
    except (ValueError, IndexError):
        return 1.0


def tally_path() -> str:
    """Which mechanism cross-host tallies ride on this process:
    ``"psum"`` when a multi-process group exists AND it runs
    cross-process collectives
    (:func:`~hashgraph_tpu_torch.parallel.multihost.collectives_available`,
    the runtime capability probe), else ``"fabric"`` — summing each
    host's ``OP_FLEET_TALLY`` frame over the gossip fabric."""
    from .multihost import collectives_available, process_count

    if process_count() > 1 and collectives_available():
        return "psum"
    return "fabric"


# ── Two-level placement ────────────────────────────────────────────────


class FederationPlacement:
    """Deterministic (host, shard) assignment over an elastic host set.

    Level 1: rendezvous over the host ids picks the owning host.
    Level 2: rendezvous over the shards *currently homed* on that host
    picks the shard. Both levels use the fleet's keyed-blake2b HRW
    (:func:`~hashgraph_tpu_torch.parallel.fleet.rendezvous_owner`) — stable
    across processes and restarts, and each level remaps minimally under
    membership changes (adding/removing a host perturbs only scopes
    whose level-1 argmax involves it).

    Scopes with live state are **pinned to their shard**
    (pin-until-delete, the fleet's discipline): a pin survives host
    membership changes AND shard re-homing, so a migration moves the
    pinned scopes with their shard and a membership change never splits
    a live scope. Every participant (hosts, drivers) constructing this
    placement from the same membership history computes identical
    assignments — the cross-process contract the restart-stability test
    pins down.

    Thread-safe; :meth:`migrate` flips a shard's home under the same
    lock every :meth:`owner` read takes, so there is NO window in which
    two hosts both own a scope (tested by the concurrent-flip test).
    """

    _CACHE_CAP = 65_536  # the ScopePlacement memo-bound precedent

    def __init__(self, hosts: "dict[str, list[str]]"):
        if not hosts:
            raise ValueError("placement needs at least one host")
        self._hosts: dict[str, list[str]] = {}
        self._home: dict[str, str] = {}
        for host_id, shard_ids in hosts.items():
            shard_ids = list(dict.fromkeys(shard_ids))
            _check_shard_ids([host_id])
            _check_shard_ids(shard_ids)
            for sid in shard_ids:
                if sid in self._home:
                    raise ValueError(f"shard {sid!r} homed on two hosts")
                self._home[sid] = host_id
            self._hosts[host_id] = shard_ids
        self._pins: dict = {}  # scope -> shard_id while the scope lives
        self._migrating: dict[str, float] = {}  # shard -> retry_after
        self._cache: dict = {}
        self._lock = threading.Lock()

    @classmethod
    def uniform(
        cls, host_ids: "list[str]", shards_per_host: int
    ) -> "FederationPlacement":
        """The standard topology: ``shards_per_host`` shards per host,
        named ``<host>:<k>`` — globally unique, and every participant
        that knows (host ids, shard count) reconstructs it identically."""
        return cls(
            {
                host: [f"{host}:{k}" for k in range(shards_per_host)]
                for host in host_ids
            }
        )

    # ── readouts ───────────────────────────────────────────────────────

    @property
    def host_ids(self) -> "list[str]":
        with self._lock:
            return list(self._hosts)

    @property
    def shard_ids(self) -> "list[str]":
        with self._lock:
            return list(self._home)

    def shards_of(self, host_id: str) -> "list[str]":
        with self._lock:
            return list(self._hosts[host_id])

    def host_of(self, shard_id: str) -> str:
        with self._lock:
            return self._home[shard_id]

    def owner(self, scope) -> "tuple[str, str]":
        """The (host, shard) owning ``scope`` — the pin when the scope
        is live, the two-level rendezvous otherwise."""
        with self._lock:
            pinned = self._pins.get(scope)
            if pinned is not None:
                return self._home[pinned], pinned
            owner = self._cache.get(scope)
            if owner is None:
                if len(self._cache) >= self._CACHE_CAP:
                    self._cache.clear()
                # Hosts that currently home no shards (everything
                # migrated away) own nothing — skip them at level 1.
                candidates = [h for h, s in self._hosts.items() if s]
                host = rendezvous_owner(scope, candidates)
                shard = rendezvous_owner(scope, self._hosts[host])
                owner = self._cache[scope] = (host, shard)
            return owner

    def migrating(self, shard_id: str) -> bool:
        with self._lock:
            return shard_id in self._migrating

    def retry_after(self, shard_id: str) -> float:
        with self._lock:
            return self._migrating.get(shard_id, 0.0)

    # ── pins (live scopes never split) ─────────────────────────────────

    def pin(self, scope, shard_id: str) -> None:
        """Pin a live scope to its shard. Taken at the scope's first
        mutating touch — the owning fleet takes the matching local pin on
        the same touch, and both sides computed the same HRW shard, so
        the pins coincide by construction."""
        with self._lock:
            if shard_id not in self._home:
                raise ValueError(f"unknown shard {shard_id!r}")
            self._pins.setdefault(scope, shard_id)

    def release(self, scope) -> None:
        """Release a deleted scope's pin (and memo entry)."""
        with self._lock:
            self._pins.pop(scope, None)
            self._cache.pop(scope, None)

    def pinned(self, scope):
        with self._lock:
            return self._pins.get(scope)

    def pins_of_shard(self, shard_id: str) -> list:
        with self._lock:
            return [s for s, sid in self._pins.items() if sid == shard_id]

    # ── elastic host membership ────────────────────────────────────────

    def add_host(self, host_id: str, shard_ids: "list[str]") -> None:
        """Scale-out: only scopes whose level-1 argmax moves to the new
        host remap (the rendezvous invariant); pinned scopes never move."""
        shard_ids = list(dict.fromkeys(shard_ids))
        _check_shard_ids([host_id])
        _check_shard_ids(shard_ids)
        with self._lock:
            if host_id in self._hosts:
                raise ValueError(f"host {host_id!r} already placed")
            for sid in shard_ids:
                if sid in self._home:
                    raise ValueError(f"shard {sid!r} homed on two hosts")
            self._hosts[host_id] = shard_ids
            for sid in shard_ids:
                self._home[sid] = host_id
            self._cache.clear()

    def remove_host(self, host_id: str, force: bool = False) -> None:
        """Scale-in: only the removed host's scopes remap. Refuses while
        the host still homes shards with pinned (live) scopes unless
        ``force`` — migrate them first (:func:`migrate_shard`)."""
        with self._lock:
            if host_id not in self._hosts:
                raise ValueError(f"host {host_id!r} not placed")
            if len(self._hosts) == 1:
                raise ValueError("cannot remove the last host")
            homed = self._hosts[host_id]
            pinned = [
                s for s, sid in self._pins.items() if sid in set(homed)
            ]
            if pinned and not force:
                raise ValueError(
                    f"host {host_id!r} still owns live scopes "
                    f"{pinned[:4]}...; migrate its shards or pass force=True"
                )
            for sid in homed:
                del self._home[sid]
                self._migrating.pop(sid, None)
            for scope in pinned:
                del self._pins[scope]
            del self._hosts[host_id]
            self._cache.clear()

    # ── migration flip ─────────────────────────────────────────────────

    def begin_migration(self, shard_id: str, retry_after: float = 1.0) -> None:
        """Mark a shard mid-migration. Routing layers consult
        :meth:`migrating` and raise/buffer instead of dispatching; the
        placement itself stays a pure lookup."""
        with self._lock:
            if shard_id not in self._home:
                raise ValueError(f"unknown shard {shard_id!r}")
            self._migrating[shard_id] = retry_after

    def complete_migration(self, shard_id: str, to_host: str) -> None:
        """Atomically re-home ``shard_id`` onto ``to_host`` and lift the
        freeze — one lock, so no reader ever observes dual ownership or
        an ownerless shard."""
        with self._lock:
            if to_host not in self._hosts:
                raise ValueError(f"unknown host {to_host!r}")
            from_host = self._home[shard_id]
            if from_host != to_host:
                self._hosts[from_host].remove(shard_id)
                self._hosts[to_host].append(shard_id)
                self._home[shard_id] = to_host
            self._migrating.pop(shard_id, None)
            self._cache.clear()

    def abort_migration(self, shard_id: str) -> None:
        with self._lock:
            self._migrating.pop(shard_id, None)


# ── The single-engine facade over a fleet ──────────────────────────────


class _MergedReceiver:
    """Round-robin try_recv over the per-shard event receivers — the
    bridge's OP_POLL_EVENTS drains one merged stream."""

    def __init__(self, receivers):
        self._receivers = receivers

    def try_recv(self):
        for receiver in self._receivers:
            item = receiver.try_recv()
            if item is not None:
                return item
        return None


class _MergedEventBus:
    def __init__(self, fleet: ConsensusFleet):
        self._fleet = fleet

    def subscribe(self) -> _MergedReceiver:
        # Snapshot of the shard set at subscribe time (the bridge
        # subscribes once, at peer registration); shards added later
        # surface events through their own engines' buses.
        return _MergedReceiver(
            [
                shard.engine.event_bus().subscribe()
                for shard in self._fleet._shards.values()
                if shard.engine is not None
            ]
        )


class FleetEngineAdapter:
    """One host's :class:`ConsensusFleet` presented as the single-engine
    surface the bridge wire expects: every opcode the federation uses —
    proposal lifecycle, coalesced ``OP_VOTE_BATCH`` (object path AND the
    zero-copy columnar path), ``OP_DELIVER_PROPOSALS``,
    ``OP_STATE_FINGERPRINT``, ``OP_FLEET_TALLY``, health — routes per
    scope to the owning shard through the fleet's batching router.

    Not named ``engine`` anywhere and carrying its own
    ``save_to_storage``: ``sync.state_fingerprint`` digests the UNION of
    the shards' canonical session/config frames (order-insensitive, so
    the per-shard interleaving is irrelevant).

    The adapter deliberately has no ``wire_verify_begin``: the bridge's
    reader-thread prepass is per-engine, and a fleet spans several — the
    per-shard crypto runs inside each shard's own
    ``ingest_wire_columnar`` on the concurrent dispatch instead."""

    def __init__(self, fleet: ConsensusFleet):
        self._fleet = fleet
        self._bus = _MergedEventBus(fleet)

    @property
    def fleet(self) -> ConsensusFleet:
        return self._fleet

    # Identity / infrastructure the bridge touches at registration.

    def signer(self):
        """The host's wire identity: shard 0's signer (proposal_owner on
        bridge-created proposals — any stable per-host identity serves)."""
        first = next(iter(self._fleet._shards.values()))
        return first.engine.signer()

    def event_bus(self):
        return self._bus

    def trace_context_of(self, scope, proposal_id):
        return self._fleet._engine_for(scope).trace_context_of(
            scope, proposal_id
        )

    # Control plane — scope-routed passthroughs (the fleet pins live
    # scopes to their shard on the first mutating touch).

    def create_proposal(self, scope, request, now, config=None):
        return self._fleet.create_proposal(scope, request, now, config)

    def create_proposals(self, scope, requests, now, config=None):
        return self._fleet.create_proposals(scope, requests, now, config)

    def cast_vote(self, scope, proposal_id, choice, now):
        return self._fleet.cast_vote(scope, proposal_id, choice, now)

    def process_incoming_proposal(self, scope, proposal, now, config=None):
        return self._fleet.process_incoming_proposal(
            scope, proposal, now, config
        )

    def process_incoming_vote(self, scope, vote, now) -> None:
        self._fleet.process_incoming_vote(scope, vote, now)

    def handle_consensus_timeout(self, scope, proposal_id, now):
        return self._fleet._engine_for(scope).handle_consensus_timeout(
            scope, proposal_id, now
        )

    def get_consensus_result(self, scope, proposal_id):
        return self._fleet.get_consensus_result(scope, proposal_id)

    def get_proposal(self, scope, proposal_id):
        return self._fleet.get_proposal(scope, proposal_id)

    def get_scope_stats(self, scope):
        return self._fleet.get_scope_stats(scope)

    def get_scope_config(self, scope):
        return self._fleet.get_scope_config(scope)

    def set_scope_config(self, scope, config) -> None:
        self._fleet.set_scope_config(scope, config)

    def delete_scope(self, scope) -> None:
        self._fleet.delete_scope(scope)

    def explain_decision(self, scope, proposal_id) -> dict:
        return self._fleet.explain_decision(scope, proposal_id)

    def voter_gid(self, scope, owner: bytes) -> int:
        return self._fleet.voter_gid(scope, owner)

    def sweep_timeouts(self, now):
        return self._fleet.sweep_timeouts(now)

    # Data plane.

    def ingest_votes(self, items, now, pre_validated: bool = False):
        return self._fleet.ingest_votes(items, now, pre_validated=pre_validated)

    def ingest_votes_pipelined(self, batches, now, pre_validated: bool = False):
        return self._fleet.ingest_votes_pipelined(
            batches, now, pre_validated=pre_validated
        )

    def deliver_proposals(self, items, now, configs=None):
        return self._fleet.deliver_proposals(items, now, configs=configs)

    def deliver_proposal(self, scope, proposal, now, config=None):
        return self._fleet.deliver_proposal(scope, proposal, now, config)

    def ingest_wire_columnar(
        self,
        scopes,
        scope_idx,
        cols,
        data,
        offsets,
        now,
        max_depth: int = 8,
        stage_seconds: "dict | None" = None,
        _prepass=None,
        _buf=None,
    ) -> np.ndarray:
        """The host's zero-copy wire ingest, split per owning shard:
        rows group by the fleet's placement, pack into contiguous
        per-shard column triples (``columnar.pack_rows`` — the same
        vectorized gather the bridge uses per peer), and land
        concurrently on each shard engine's own ``ingest_wire_columnar``
        (full validation, per-shard crypto batch). ``_prepass`` is
        ignored by design — see the class docstring."""
        from ..bridge import columnar as WC

        fleet = self._fleet
        scope_idx = np.asarray(scope_idx, np.int64)
        offsets = np.asarray(offsets, np.int64)
        batch = len(cols)
        statuses = np.full(batch, _NOT_FOUND, np.int32)
        groups, _ = fleet._group_scopes(scopes, unavailable_ok=False)
        stage_parts: "list[dict]" = []

        def dispatch(sid: str, members: list):
            ordinals = np.fromiter(
                (k for k, _ in members), np.int64, len(members)
            )
            local_of = np.full(len(scopes), -1, np.int64)
            local_of[ordinals] = np.arange(len(members))
            rows = np.nonzero(local_of[scope_idx] >= 0)[0]
            if rows.size == 0:
                return rows, np.empty(0, np.int32)
            if len(groups) == 1 and rows.size == batch:
                sub_data, sub_offsets, sub_cols = data, offsets, cols
            else:
                sub_data, sub_offsets, sub_cols = WC.pack_rows(
                    data, offsets, cols, rows
                )
            engine = fleet._live_engine(sid)
            fleet._note_routed(sid, int(rows.size))
            stage: dict = {}
            stage_parts.append(stage)
            sub = engine.ingest_wire_columnar(
                [scope for _, scope in members],
                local_of[scope_idx[rows]],
                sub_cols,
                sub_data,
                sub_offsets,
                now,
                max_depth=max_depth,
                stage_seconds=stage,
            )
            return rows, sub

        futures = [
            fleet._executor.submit(dispatch, sid, members)
            for sid, members in groups.items()
        ]
        for future in futures:
            rows, sub = future.result()
            statuses[rows] = sub
        if stage_seconds is not None:
            for stage in stage_parts:
                for key, value in stage.items():
                    stage_seconds[key] = stage_seconds.get(key, 0.0) + value
        return statuses

    # Tallies / fingerprints / health.

    def fleet_state_counts(self) -> "dict[int, int]":
        return self._fleet.fleet_state_counts()

    def save_to_storage(self, storage) -> int:
        """Union of the shards' canonical dumps (unwrapping durable
        wrappers, whose own save appends a checkpoint mark) — what
        ``sync.state_fingerprint`` digests for the whole host."""
        total = 0
        for shard in self._fleet._shards.values():
            engine = shard.engine
            if engine is None:
                continue
            target = getattr(engine, "engine", engine)
            total += target.save_to_storage(storage)
        return total

    def session_keys(self) -> list:
        return [
            key
            for shard in self._fleet._shards.values()
            if shard.engine is not None
            for key in shard.engine.session_keys()
        ]

    def occupancy(self) -> dict:
        """Aggregate capacity view (the per-shard breakdown lives on
        ``fleet.occupancy()``) — the shared rollup, so engine-level keys
        (tier counters included) can never drift from the fleet's."""
        return aggregate_occupancy(self._fleet.occupancy().values())

    def health_report(self, now=None) -> dict:
        return self._fleet.health_report(now)


# ── One host's stack ───────────────────────────────────────────────────


class _RemoteHost:
    __slots__ = ("host_id", "host", "port", "peer_id")

    def __init__(self, host_id: str, host: str, port: int, peer_id: int):
        self.host_id = host_id
        self.host = host
        self.port = port
        self.peer_id = peer_id


class FleetGroup:
    """One federation host: the local :class:`ConsensusFleet` fronted by
    a bridge server (ONE peer = the :class:`FleetEngineAdapter`), plus a
    gossip-fabric client side that forwards votes for remotely-owned
    scopes to their host.

    ``wal_root`` is REQUIRED: every shard must be durable so the host
    can serve a migrating shard's consistent snapshot + WAL tail to the
    adopting host (the PR-8 sync path ``export_shard`` exposes).

    The group (and any driver) derives its view of the topology from a
    :class:`FederationPlacement`; all participants must construct it
    from the same membership history (``FederationPlacement.uniform``
    from the same host list is the standard way).

    ``devices`` is the fleet's (:class:`ConsensusFleet`): every visible
    GPU by default, raising without one; ``[torch.device("cpu")]`` runs
    the host on the CPU."""

    def __init__(
        self,
        host_id: str,
        signer_factory,
        *,
        placement: FederationPlacement,
        wal_root: str,
        n_shards: "int | None" = None,
        capacity_per_shard: int = 1024,
        voter_capacity: int = 64,
        max_sessions_per_scope: "int | None" = None,
        fsync_policy: str = "batch",
        devices=None,
        port: int = 0,
        wire_columnar: "bool | None" = None,
        request_timeout: float = 30.0,
    ):
        import os

        self.host_id = host_id
        self.placement = placement
        shard_ids = placement.shards_of(host_id)
        if n_shards is not None and n_shards != len(shard_ids):
            raise ValueError(
                f"placement homes {len(shard_ids)} shards on {host_id!r}, "
                f"n_shards says {n_shards}"
            )
        self.fleet = ConsensusFleet(
            signer_factory,
            n_shards=len(shard_ids),
            shard_ids=shard_ids,
            capacity_per_shard=capacity_per_shard,
            voter_capacity=voter_capacity,
            max_sessions_per_scope=max_sessions_per_scope,
            wal_root=os.path.join(wal_root, host_id),
            fsync_policy=fsync_policy,
            devices=devices,
        )
        self.adapter = FleetEngineAdapter(self.fleet)
        self._request_timeout = request_timeout
        self._port = port
        self._wire_columnar = wire_columnar
        self._engine_slot: list = []
        self.server = None
        self.peer_id = 0
        self._transport = None
        self._remote: "dict[str, _RemoteHost]" = {}
        self._merged_sidecar = None
        self._lock = threading.Lock()
        ref_self = weakref.ref(self)
        default_registry.register_gauge(
            FEDERATION_HOSTS,
            lambda: (
                (len(g._remote) + 1) if (g := ref_self()) is not None else 0
            ),
            owner=self,
        )
        self._m_remote_routed = default_registry.counter(
            FEDERATION_REMOTE_ROUTED_VOTES_TOTAL
        )

    # ── lifecycle ──────────────────────────────────────────────────────

    def start(self) -> "tuple[str, int]":
        """Bind the bridge server, register the fleet adapter as its one
        peer, and return the listening address."""
        from ..bridge.server import BridgeServer
        from ..gossip.transport import GossipTransport
        from ..signing.stub import StubConsensusSigner

        self.server = BridgeServer(
            port=self._port,
            engine_factory=self._pop_engine,
            signer_factory=StubConsensusSigner,
            wire_columnar=self._wire_columnar,
            host_label=self.host_id,
        )
        self.server.start()
        self.peer_id = self._register(self.adapter)
        self._transport = GossipTransport()
        return self.server.address

    def _pop_engine(self, signer):
        # engine_factory seam: ADD_PEER on this server always follows a
        # _register() push (the federation server mints no default
        # engines — its peers are the fleet adapter and, transiently,
        # migrating shard engines).
        if not self._engine_slot:
            raise ValueError(
                "federation server peers are registered via FleetGroup"
            )
        return self._engine_slot.pop()

    def _register(self, engine) -> int:
        import hashlib as _hashlib

        from ..bridge import protocol as P

        key = _hashlib.sha256(
            f"federation:{self.host_id}:{len(self._engine_slot)}".encode()
            + str(time.monotonic_ns()).encode()
        ).digest()
        self._engine_slot.append(engine)
        status, out = self.server.dispatch_frame(
            P.OP_ADD_PEER, P.u8(32) + key
        )
        if status != P.STATUS_OK:
            raise RuntimeError(f"peer registration failed: status {status}")
        return P.Cursor(out).u32()

    @property
    def address(self) -> "tuple[str, int]":
        return self.server.address

    def connect(self, host_id: str, host: str, port: int, peer_id: int) -> None:
        """Join a remote host to the fabric (blocking HELLO): votes for
        scopes it owns will ride coalesced OP_VOTE_BATCH frames there."""
        self._transport.connect(host_id, host, port)
        with self._lock:
            self._remote[host_id] = _RemoteHost(host_id, host, port, peer_id)

    def close(self) -> None:
        if self._merged_sidecar is not None:
            self._merged_sidecar.stop()
            self._merged_sidecar = None
        if self._transport is not None:
            self._transport.close()
        if self.server is not None:
            self.server.stop()
        self.fleet.close()

    def __enter__(self) -> "FleetGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ── routing (the federation data plane) ────────────────────────────

    def _route(self, scope) -> "tuple[str, str]":
        host, shard = self.placement.owner(scope)
        if self.placement.migrating(shard):
            raise ShardMigratingError(
                shard, self.placement.retry_after(shard)
            )
        return host, shard

    def owner_of(self, scope) -> "tuple[str, str]":
        return self.placement.owner(scope)

    def ingest_votes(self, items, now, pre_validated: bool = False) -> np.ndarray:
        """The federated :meth:`ConsensusFleet.ingest_votes`: locally
        owned rows land on the local fleet router; remotely owned rows
        ride ONE coalesced ``OP_VOTE_BATCH`` frame per owning host over
        the fabric (instead of erroring SESSION_NOT_FOUND), statuses
        stitched back in input order. Rows for a migrating shard raise
        :class:`ShardMigratingError` — back off ``retry_after`` and
        retry; nothing is dropped."""
        from ..bridge import protocol as P
        from ..bridge.client import BridgeError, parse_status_list
        from ..gossip.transport import ChannelBusy

        statuses = np.full(len(items), _NOT_FOUND, np.int32)
        local: list[int] = []
        remote: "dict[str, list[int]]" = {}
        for k, (scope, _vote) in enumerate(items):
            host, _shard = self._route(scope)
            if host == self.host_id:
                local.append(k)
            else:
                remote.setdefault(host, []).append(k)
        if local:
            sub = self.fleet.ingest_votes([items[k] for k in local], now)
            statuses[local] = sub
        for host, idxs in remote.items():
            info = self._remote.get(host)
            if info is None:
                raise KeyError(
                    f"scope owned by host {host!r} but it is not connected"
                )
            # One frame per (host, call): groups keyed by scope in input
            # order (order within a scope preserved — the chain rule).
            # Grouping REORDERS interleaved scopes' rows, so the frame's
            # flattened row order is recorded and statuses map back
            # through it — never positionally onto ``idxs``.
            grouped: "dict[str, list[tuple[int, bytes]]]" = {}
            for k in idxs:
                scope, vote = items[k]
                grouped.setdefault(scope, []).append((k, vote.encode()))
            frame_rows = [
                k for pairs in grouped.values() for k, _ in pairs
            ]
            payload = P.encode_vote_batch(
                now,
                [
                    (info.peer_id, scope, [blob for _, blob in pairs])
                    for scope, pairs in grouped.items()
                ],
            )
            deadline = time.monotonic() + self._request_timeout
            while True:
                try:
                    future = self._transport.request(
                        host, P.OP_VOTE_BATCH, payload
                    )
                    break
                except ChannelBusy:
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.002)
            try:
                sub = parse_status_list(
                    future.result(self._request_timeout)
                )
            except BridgeError as exc:
                if exc.status == P.STATUS_SHARD_MIGRATING:
                    # The remote froze the shard between our placement
                    # read and the dispatch: surface the same typed
                    # error a local freeze raises.
                    _h, shard = self.placement.owner(items[idxs[0]][0])
                    raise ShardMigratingError(
                        shard, _retry_hint(exc)
                    ) from exc
                raise
            statuses[frame_rows] = np.asarray(sub, np.int32)
            self._m_remote_routed.inc(len(idxs))
        return statuses

    def deliver_proposals(self, items, now) -> "list[int]":
        """Federated anti-entropy delivery: local items through the
        fleet's watermark path, remote items as one
        ``OP_DELIVER_PROPOSALS`` frame per owning host."""
        from ..bridge import protocol as P
        from ..bridge.client import parse_status_list

        statuses = [_NOT_FOUND] * len(items)
        local: list[int] = []
        remote: "dict[str, list[int]]" = {}
        for k, (scope, _proposal) in enumerate(items):
            host, _shard = self._route(scope)
            (local if host == self.host_id else
             remote.setdefault(host, [])).append(k)
        if local:
            sub = self.fleet.deliver_proposals(
                [items[k] for k in local], now
            )
            for k, code in zip(local, sub):
                statuses[k] = int(code)
        for host, idxs in remote.items():
            info = self._remote[host]
            payload = P.encode_deliver_proposals(
                info.peer_id,
                [(items[k][0], items[k][1].encode()) for k in idxs],
                now,
            )
            future = self._transport.request(
                host, P.OP_DELIVER_PROPOSALS, payload
            )
            sub = parse_status_list(future.result(self._request_timeout))
            for k, code in zip(idxs, sub):
                statuses[k] = int(code)
        return statuses

    # ── fleet-wide tallies across hosts ────────────────────────────────

    def federated_state_counts(self) -> "dict[int, int]":
        """The global slot-state histogram across every host: the local
        fleet's ONE-psum tally plus each remote host's, aggregated by
        the path :func:`tally_path` picked — real cross-host collectives
        where the backend implements them, ``OP_FLEET_TALLY`` fabric
        frames where it doesn't (this box)."""
        local = self.fleet.fleet_state_counts()
        if tally_path() == "psum":
            return self._psum_counts(local)
        total = dict(local)
        for host, counts in self._fabric_tallies().items():
            for code, count in counts.items():
                total[code] = total.get(code, 0) + count
        return total

    def _fabric_tallies(self) -> "dict[str, dict[int, int]]":
        from ..bridge import protocol as P

        out: "dict[str, dict[int, int]]" = {}
        with self._lock:
            remote = list(self._remote.values())
        futures = [
            (
                info.host_id,
                self._transport.request(
                    info.host_id, P.OP_FLEET_TALLY, P.u32(info.peer_id)
                ),
            )
            for info in remote
        ]
        for host_id, future in futures:
            out[host_id] = P.parse_fleet_tally(
                future.result(self._request_timeout)
            )
        return out

    @staticmethod
    def _psum_counts(local: "dict[int, int]") -> "dict[int, int]":
        """The collective arm: every process of the group contributes
        its local count vector, one allgather+sum yields the global
        histogram (collective cadence — call on every process)."""
        from .multihost import process_allgather

        codes = sorted(local)
        vec = np.asarray([local[c] for c in codes], np.int64)
        gathered = np.asarray(process_allgather(vec)).reshape(-1, len(codes))
        summed = gathered.sum(axis=0)
        return {code: int(n) for code, n in zip(codes, summed)}

    def state_fingerprint(self) -> str:
        from ..sync.snapshot import state_fingerprint

        return state_fingerprint(self.adapter)

    # ── metric federation (OP_METRICS_PULL frames + merged views) ──────

    def metrics_frame(self) -> dict:
        """This host's ``OP_METRICS_PULL`` frame, locally (no wire hop):
        the raw registry state + SLO state under the host's label — the
        same dict a remote puller would receive."""
        return {
            "host": self.host_id,
            "state": default_registry.export_state(),
            "slo": slo_engine.state(),
        }

    def federated_metric_frames(self) -> "list[dict]":
        """The local frame plus every connected host's, pulled over the
        fabric as single ``OP_METRICS_PULL`` frames."""
        import json

        from ..bridge import protocol as P

        with self._lock:
            remote = list(self._remote.values())
        futures = [
            self._transport.request(info.host_id, P.OP_METRICS_PULL, b"")
            for info in remote
        ]
        frames = [self.metrics_frame()]
        for future in futures:
            frames.append(
                json.loads(
                    future.result(self._request_timeout)
                    .blob()
                    .decode("utf-8")
                )
            )
        return frames

    def federated_metrics(self) -> dict:
        """Fleet-wide registry state: per-host labelled families + bare
        fleet totals, through the ONE shared merge
        (:func:`~hashgraph_tpu_torch.parallel.rollup.merge_metric_states`)."""
        return merge_metric_states(self.federated_metric_frames())

    def federated_metrics_text(self) -> str:
        """The merged frames rendered in Prometheus text format — the
        body a fleet-wide ``/metrics`` scrape serves."""
        from ..obs.prometheus import render_state

        return render_state(self.federated_metrics())

    def federated_slo(self) -> dict:
        """Fleet-wide ``/slo`` view: per-host SLO states plus firing
        alerts/incidents qualified ``host/...``."""
        return merge_slo_states(self.federated_metric_frames())

    def serve_merged_metrics(
        self, host: str = "127.0.0.1", port: int = 0
    ) -> "tuple[str, int]":
        """Start a sidecar whose ``/metrics`` and ``/slo`` serve the
        MERGED fleet view (pulling every connected host per scrape).
        Returns the bound address; stopped by :meth:`close`."""
        from ..obs.http import MetricsSidecar

        self._merged_sidecar = MetricsSidecar(
            default_registry,
            host=host,
            port=port,
            render_fn=self.federated_metrics_text,
            slo_fn=self.federated_slo,
        )
        return self._merged_sidecar.start()

    # ── migration (source + destination halves) ────────────────────────

    def export_shard(
        self, shard_id: str, retry_after: float = 1.0
    ) -> "tuple[int, str]":
        """Source half, step 1: freeze the shard (routes raise the typed
        migrating error carrying ``retry_after`` — on the wire too, as
        the STATUS_SHARD_MIGRATING hint; the engine stays live) and
        register its durable engine as a bridge sync peer. Returns
        ``(peer_id, fingerprint)`` — the adopting host catches up from
        that peer and the orchestrator asserts fingerprint equality
        before flipping."""
        from ..sync.snapshot import state_fingerprint

        self.fleet.begin_migration(shard_id, retry_after)
        engine = self.fleet.shard(shard_id).engine
        if not hasattr(engine, "capture_consistent"):
            self.fleet.end_migration(shard_id)
            raise MigrationError(
                f"shard {shard_id!r} is not durable; migration ships a "
                "WAL-watermarked snapshot"
            )
        peer_id = self._register(engine)
        return peer_id, state_fingerprint(engine)

    def adopt_shard(
        self, shard_id: str, host: str, port: int, source_peer: int
    ) -> dict:
        """Destination half: add the shard to the local fleet, catch it
        up from the source peer (snapshot at the frozen WAL watermark +
        tail, one batched verify), and pin the migrated scopes to the
        adopted shard (they keep living where their sessions are,
        regardless of the local rendezvous). Returns the adoption report
        incl. the installed state's fingerprint."""
        from ..sync.snapshot import state_fingerprint

        self.fleet.add_shard(shard_id)
        try:
            self.fleet.catch_up_shard(shard_id, host, port, source_peer)
        except BaseException:
            self.fleet.remove_shard(shard_id, force=True)
            raise
        engine = self.fleet.shard(shard_id).engine
        keys = engine.session_keys()
        scopes = {scope for scope, _pid in keys}
        for scope in scopes:
            self.fleet.pin_scope(scope, shard_id)
        report = self.fleet.shard(shard_id).catchup_report
        return {
            "sessions": len(keys),
            "scopes": len(scopes),
            "fingerprint": state_fingerprint(engine),
            "votes_verified": (
                report.votes_verified if report is not None else 0
            ),
            "seconds": report.seconds if report is not None else 0.0,
        }

    def retire_shard(self, shard_id: str, peer_id: int) -> None:
        """Source half, final step (after the placement flipped): drop
        the temporary sync peer and remove the shard — its engine closes
        and its WAL flock releases; the state lives on the adopter. A
        host drained of its LAST shard keeps serving the wire (the
        federated placement routes nothing new to it)."""
        self.server.remove_peer(peer_id)
        self.fleet.remove_shard(shard_id, force=True, allow_empty=True)


# ── In-process migration orchestration ─────────────────────────────────


def migrate_shard(
    placement: FederationPlacement,
    groups: "dict[str, FleetGroup]",
    shard_id: str,
    to_host: str,
    *,
    retry_after: float = 1.0,
) -> dict:
    """Re-home ``shard_id`` onto ``to_host`` under traffic: freeze (typed
    retry-after for concurrent routes), snapshot+tail adopt, assert
    source/destination ``state_fingerprint`` equality, atomic placement
    flip, retire the source. Raises :class:`MigrationError` (placement
    unflipped, source unfrozen) on any integrity failure.

    This is the in-process orchestration (both groups in this process —
    tests, smoke topologies). Hosts in separate processes drive the
    same halves over their control channels, with a
    :class:`FederationDriver` buffering the in-window tail."""
    from_host = placement.host_of(shard_id)
    if from_host == to_host:
        raise ValueError(f"shard {shard_id!r} already on {to_host!r}")
    src, dst = groups[from_host], groups[to_host]
    t0 = time.perf_counter()
    flight_recorder.record(
        "federation.migrate_start",
        shard=shard_id, source=from_host, target=to_host,
    )
    placement.begin_migration(shard_id, retry_after)
    peer_id = None
    try:
        peer_id, src_fingerprint = src.export_shard(shard_id, retry_after)
        host, port = src.address
        report = dst.adopt_shard(shard_id, host, port, peer_id)
        if report["fingerprint"] != src_fingerprint:
            dst.fleet.remove_shard(shard_id, force=True)
            raise MigrationError(
                f"shard {shard_id!r} fingerprint mismatch after adopt: "
                f"{src_fingerprint[:16]} != {report['fingerprint'][:16]}"
            )
        placement.complete_migration(shard_id, to_host)
    except BaseException:
        placement.abort_migration(shard_id)
        if peer_id is not None:
            try:
                src.server.remove_peer(peer_id)
            except ValueError:
                pass
        src.fleet.end_migration(shard_id)
        raise
    src.retire_shard(shard_id, peer_id)
    seconds = time.perf_counter() - t0
    default_registry.counter(FEDERATION_MIGRATIONS_TOTAL).inc()
    default_registry.histogram(FEDERATION_MIGRATION_SECONDS).observe(seconds)
    flight_recorder.record(
        "federation.migrate_finish",
        shard=shard_id, source=from_host, target=to_host,
        sessions=report["sessions"], seconds=round(seconds, 4),
    )
    return {
        "shard": shard_id,
        "from": from_host,
        "to": to_host,
        "seconds": round(seconds, 4),
        "sessions": report["sessions"],
        "scopes": report["scopes"],
        "fingerprint": report["fingerprint"],
    }


# ── The fabric-side driver (an embedder with no local fleet) ───────────


class FederationDriver:
    """Routes an embedder's outbound votes across the federation over
    the gossip fabric: per-scope (host, shard) ownership from the shared
    :class:`FederationPlacement`, coalesced pipelined ``OP_VOTE_BATCH``
    frames per owning host, bounded-queue backpressure with deferred
    resend (votes are NEVER dropped: a shed frame re-queues, a vote for
    a migrating shard buffers into that shard's tail and replays after
    the placement flip).

    It is the shape of a stateless front-end tier routing user traffic
    into the federation."""

    def __init__(
        self,
        placement: FederationPlacement,
        *,
        flush_votes: int = 512,
        flush_bytes: int = 512 * 1024,
        flush_interval: float = 0.005,
        request_timeout: float = 60.0,
    ):
        from ..gossip.coalescer import VoteCoalescer
        from ..gossip.transport import GossipTransport

        self.placement = placement
        self._transport = GossipTransport()
        self._coalescer = VoteCoalescer(
            flush_votes=flush_votes,
            flush_bytes=flush_bytes,
            flush_interval=flush_interval,
        )
        self._timeout = request_timeout
        self._hosts: "dict[str, _RemoteHost]" = {}
        self._lock = threading.Lock()
        self._outstanding: list = []
        self._deferred: list = []  # shed frames awaiting a resend
        self._tail: "dict[str, list]" = {}  # shard -> buffered submits
        self._migration_t0: "dict[str, float]" = {}
        self._submitted = 0
        self._acked = 0
        self._rejected = 0
        self._reject_codes: "dict[int, int]" = {}
        ref_self = weakref.ref(self)
        default_registry.register_gauge(
            FEDERATION_HOSTS,
            lambda: len(d._hosts) if (d := ref_self()) is not None else 0,
            owner=self,
        )
        self._m_remote_routed = default_registry.counter(
            FEDERATION_REMOTE_ROUTED_VOTES_TOTAL
        )

    def connect(self, host_id: str, host: str, port: int, peer_id: int) -> None:
        self._transport.connect(host_id, host, port)
        with self._lock:
            self._hosts[host_id] = _RemoteHost(host_id, host, port, peer_id)

    def close(self) -> None:
        self._transport.close()

    def __enter__(self) -> "FederationDriver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ── submission ─────────────────────────────────────────────────────

    def submit(self, scope: str, votes: "list[bytes]", now: int) -> str:
        """Coalesce one scope's signed votes toward the owning host.
        Returns ``"sent"`` (on the wire or windowed) or ``"buffered"``
        (owning shard mid-migration; replays on the flip)."""
        with self._lock:
            self._submitted += len(votes)
        return self._route_votes(scope, votes, now)

    def _route_votes(self, scope: str, votes: "list[bytes]", now: int) -> str:
        """Route without touching the submitted counter (shared by
        submit, tail replay, and failed-frame recovery)."""
        host, shard = self.placement.owner(scope)
        if self.placement.migrating(shard):
            with self._lock:
                self._tail.setdefault(shard, []).append(
                    (scope, list(votes), now)
                )
            # Close the window race: if the flip landed between our
            # migrating check and the append, complete_shard_migration
            # may already have popped (and replayed) the tail — our
            # entry would be orphaned. Re-check after the append: when
            # the freeze is gone, pop whatever is left and re-route it
            # ourselves (the appended votes are the newest, so order
            # per scope still holds).
            if not self.placement.migrating(shard):
                with self._lock:
                    entries = self._tail.pop(shard, None)
                if entries:
                    for late_scope, late_votes, late_now in entries:
                        self._route_votes(late_scope, late_votes, late_now)
            return "buffered"
        info = self._hosts[host]
        for vote in votes:
            ready = self._coalescer.add(host, info.peer_id, scope, vote, now)
            if ready is not None:
                self._send(host, ready[0])
        self._m_remote_routed.inc(len(votes))
        return "sent"

    def _send(self, host: str, payload) -> None:
        from ..bridge import protocol as P

        future = self._transport.try_request(host, P.OP_VOTE_BATCH, payload)
        if future is None:
            with self._lock:  # shed: bounded, deferred — never dropped
                self._deferred.append((host, payload))
            return
        with self._lock:
            self._outstanding.append((future, payload))
            backlog = len(self._outstanding)
        if backlog > 64:
            self._reap()

    def pump(self) -> None:
        """Close due coalescer windows, resend deferred frames, reap
        completed responses — call on the driving loop's cadence."""
        for host in self._coalescer.due():
            ready = self._coalescer.flush(host)
            if ready is not None:
                self._send(host, ready[0])
        self._resend_deferred()
        self._reap()

    def _resend_deferred(self) -> None:
        from ..bridge import protocol as P

        with self._lock:
            deferred, self._deferred = self._deferred, []
        for host, payload in deferred:
            future = self._transport.try_request(
                host, P.OP_VOTE_BATCH, payload
            )
            if future is None:
                with self._lock:
                    self._deferred.append((host, payload))
            else:
                with self._lock:
                    self._outstanding.append((future, payload))

    def _recover_frame(self, payload) -> None:
        """A frame the server refused whole (shard frozen mid-flight,
        connection lost): decode it back to (scope, votes) groups and
        re-route every row under the CURRENT placement — frozen-shard
        scopes buffer into the migration tail, the rest re-coalesce to
        their (possibly new) owner. The refusal is all-or-nothing on the
        server (grouping raises before any shard dispatches), so a
        recovery never double-applies."""
        from ..bridge import protocol as P

        body = payload if isinstance(payload, bytes) else b"".join(payload)
        now, groups = P.decode_vote_batch(P.Cursor(body))
        for _peer_id, scope, votes in groups:
            self._route_votes(scope, list(votes), now)

    def _harvest(self, future, payload, budget: "float | None") -> None:
        from ..bridge.client import (
            BridgeConnectionLost,
            BridgeError,
            parse_status_list,
        )

        try:
            statuses = parse_status_list(
                future.result(budget if budget is not None else 0)
            )
        except (BridgeError, BridgeConnectionLost, TimeoutError, OSError):
            self._recover_frame(payload)
            return
        acked = sum(1 for c in statuses if c in (_OK, _ALREADY))
        with self._lock:
            self._acked += acked
            self._rejected += len(statuses) - acked
            for code in statuses:
                if code not in (_OK, _ALREADY):
                    self._reject_codes[code] = (
                        self._reject_codes.get(code, 0) + 1
                    )

    def _reap(self) -> None:
        with self._lock:
            # ONE done() probe per entry: a future resolving between a
            # "done" pass and a "not done" pass would land in neither
            # list and its frame's tallies would vanish unharvested.
            done: list = []
            remaining: list = []
            for entry in self._outstanding:
                (done if entry[0].done() else remaining).append(entry)
            self._outstanding = remaining
        for future, payload in done:
            self._harvest(future, payload, None)

    def drain(self, timeout: float = 60.0) -> dict:
        """Flush everything (windows, deferred resends) and await every
        in-flight frame; returns cumulative delivery counts since the
        last drain. ``acked == submitted - buffered`` (with zero
        rejected) is the zero-loss criterion."""
        deadline = time.monotonic() + timeout
        while True:
            for host in list(self._hosts):
                ready = self._coalescer.flush(host)
                if ready is not None:
                    self._send(host, ready[0])
            self._resend_deferred()
            with self._lock:
                outstanding, self._outstanding = self._outstanding, []
                idle = not self._deferred and not outstanding
            for future, payload in outstanding:
                self._harvest(
                    future, payload, max(0.0, deadline - time.monotonic())
                )
            with self._lock:
                # Recovery may have re-coalesced rows: loop until no
                # frame is pending anywhere (windows, deferred, wire).
                pending = bool(self._deferred) or bool(self._outstanding)
                pending = pending or any(
                    self._coalescer.pending(h) for h in self._hosts
                )
            if idle and not pending:
                break
            if time.monotonic() >= deadline:
                raise TimeoutError("frames still pending at drain deadline")
            time.sleep(0.002)
        with self._lock:
            buffered = sum(
                len(votes)
                for entries in self._tail.values()
                for _s, votes, _n in entries
            )
            report = {
                "submitted": self._submitted,
                "acked": self._acked,
                "rejected": self._rejected,
                "reject_codes": dict(self._reject_codes),
                "buffered": buffered,
            }
            self._submitted = self._acked = self._rejected = 0
            self._reject_codes = {}
        return report

    # ── fabric readouts ────────────────────────────────────────────────

    def fleet_tally(self) -> "dict[int, int]":
        """Federation-wide state histogram over the fabric (the driver
        has no local fleet, so it always sums OP_FLEET_TALLY frames)."""
        from ..bridge import protocol as P

        with self._lock:
            hosts = list(self._hosts.values())
        futures = [
            (
                info.host_id,
                self._transport.request(
                    info.host_id, P.OP_FLEET_TALLY, P.u32(info.peer_id)
                ),
            )
            for info in hosts
        ]
        total: "dict[int, int]" = {}
        for _hid, future in futures:
            for code, count in P.parse_fleet_tally(
                future.result(self._timeout)
            ).items():
                total[code] = total.get(code, 0) + count
        return total

    def state_fingerprint(self, host_id: str) -> str:
        from ..bridge import protocol as P

        info = self._hosts[host_id]
        future = self._transport.request(
            host_id, P.OP_STATE_FINGERPRINT, P.u32(info.peer_id)
        )
        return future.result(self._timeout).string()

    def pull_metric_frames(self) -> "list[dict]":
        """One ``OP_METRICS_PULL`` frame per connected host (the driver
        has no local fleet, so every frame comes over the fabric)."""
        import json

        from ..bridge import protocol as P

        with self._lock:
            hosts = list(self._hosts)
        futures = [
            self._transport.request(host, P.OP_METRICS_PULL, b"")
            for host in hosts
        ]
        return [
            json.loads(f.result(self._timeout).blob().decode("utf-8"))
            for f in futures
        ]

    def merged_metrics(self) -> dict:
        """Fleet-wide registry state through the ONE shared merge."""
        return merge_metric_states(self.pull_metric_frames())

    def merged_metrics_text(self) -> str:
        from ..obs.prometheus import render_state

        return render_state(self.merged_metrics())

    def merged_slo(self) -> dict:
        return merge_slo_states(self.pull_metric_frames())

    # ── migration window (the driver's half of a live migration) ───────

    def _quiesce_inflight(self, timeout: float) -> None:
        """Resolve every frame that was on the wire (or shed-deferred)
        at call time: each completes normally or refuses typed, and
        refused frames recover — during a migration freeze, straight
        into the shard's tail, in send order. New traffic keeps flowing
        while this waits; frames sent after the snapshot cannot contain
        a frozen scope's votes (submits buffer those)."""
        deadline = time.monotonic() + timeout
        while True:
            self._resend_deferred()
            with self._lock:
                if not self._deferred:
                    break
            if time.monotonic() >= deadline:
                raise TimeoutError("deferred frames could not be resent")
            time.sleep(0.002)
        with self._lock:
            snapshot = [f for f, _p in self._outstanding]
        for future in snapshot:
            try:
                future.result(max(0.0, deadline - time.monotonic()))
            except Exception:
                pass  # _harvest routes the failure (recovery) below
        self._reap()

    def begin_shard_migration(
        self,
        shard_id: str,
        retry_after: float = 1.0,
        quiesce_timeout: float = 30.0,
    ) -> None:
        """Open the migration window and DRAIN the shard's router
        queue, oldest first:

        1. subsequent submits for the shard's scopes buffer into its
           tail (never sent, never dropped);
        2. frames already on the wire resolve — ones the source refuses
           (``STATUS_SHARD_MIGRATING``) recover into the tail;
        3. the shard's votes still waiting in open coalescer windows
           move into the tail behind them.

        The tail therefore holds every unacked vote of the shard's
        scopes in submission order; :meth:`complete_shard_migration`
        replays it to the new owner after the flip."""
        self.placement.begin_migration(shard_id, retry_after)
        with self._lock:
            self._tail.setdefault(shard_id, [])
            self._migration_t0[shard_id] = time.perf_counter()
        flight_recorder.record(
            "federation.migrate_start",
            shard=shard_id, source=self.placement.host_of(shard_id),
        )
        self._quiesce_inflight(quiesce_timeout)

        def owned(scope) -> bool:
            return self.placement.owner(scope)[1] == shard_id

        for host in list(self._hosts):
            for _peer, scope, votes, wnow in self._coalescer.extract(
                host, owned
            ):
                with self._lock:
                    self._tail[shard_id].append((scope, votes, wnow))

    def complete_shard_migration(self, shard_id: str, to_host: str) -> dict:
        """Flip the placement and replay the buffered tail to the new
        owner. Returns {seconds, tail_votes}."""
        self.placement.complete_migration(shard_id, to_host)
        with self._lock:
            entries = self._tail.pop(shard_id, [])
            t0 = self._migration_t0.pop(shard_id, None)
        tail_votes = 0
        for scope, votes, now in entries:
            # Replay without re-counting: the tail was counted as
            # submitted when it buffered.
            self._route_votes(scope, votes, now)
            tail_votes += len(votes)
        seconds = (
            time.perf_counter() - t0 if t0 is not None else 0.0
        )
        default_registry.counter(FEDERATION_MIGRATIONS_TOTAL).inc()
        default_registry.histogram(FEDERATION_MIGRATION_SECONDS).observe(
            seconds
        )
        flight_recorder.record(
            "federation.migrate_finish",
            shard=shard_id, target=to_host,
            tail_votes=tail_votes, seconds=round(seconds, 4),
        )
        return {"seconds": round(seconds, 4), "tail_votes": tail_votes}

    def abort_shard_migration(self, shard_id: str) -> None:
        """Lift the freeze without flipping; the tail replays to the
        ORIGINAL owner."""
        self.placement.abort_migration(shard_id)
        with self._lock:
            entries = self._tail.pop(shard_id, [])
            self._migration_t0.pop(shard_id, None)
        for scope, votes, now in entries:
            self._route_votes(scope, votes, now)
