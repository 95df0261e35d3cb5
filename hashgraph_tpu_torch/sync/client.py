"""CatchUpClient: joiner-side snapshot install + WAL tailing.

The O(suffix) catch-up recipe (ARIES / Raft InstallSnapshot) over the
bridge's sync opcodes:

1. **Manifest** — fetch the source peer's snapshot manifest (watermark
   LSN, chunk count, per-chunk digests).
2. **Chunks** — download each chunk, verifying its SHA-256 against the
   manifest AS IT ARRIVES. Interrupted transfers resume: the
   :class:`CatchUpState` remembers verified chunks, and a fresh client
   handed the same state re-downloads only what is missing (or restarts
   cleanly if the source rebuilt its snapshot in the meantime).
3. **Verify** — decode the snapshot and verify every session's signed
   vote chain in ONE batched pass through the scheme's
   ``verify_batch_submit`` (the persistent native verify pool for
   Ethereum/Ed25519): this is where catch-up beats full replay — replay
   pays per-record crypto at gossip batch sizes, the snapshot pays one
   pool-wide batch. ``trust_snapshot=True`` skips the crypto for
   operator-trusted sources (a replica restored from its own blessed
   backup) — the structural decode still runs.
4. **Install** — load the verified sessions into the joiner in one
   atomic ``load_from_storage`` (nothing is installed unless the whole
   snapshot verified).
5. **Tail** — stream WAL records after the watermark and apply each
   through the engine's live entry points
   (:func:`hashgraph_tpu_torch.wal.recovery.apply_record`): ``KIND_DELIVER``
   records run the validated-chain watermark path, so only the suffix is
   chain-checked; forked or replayed suffixes settle through the
   engine's existing fork handling, never a blind install. LSN
   continuity is enforced — a gap raises :class:`TailGapError` instead
   of replaying around a hole.

The whole catch-up runs under ``set_replay_mode`` (when the engine has
one): the suffix is history, and history must not re-feed the health
scorecards or decision-latency histograms.

Durability note: ``load_from_storage`` is deliberately NOT logged by a
durable joiner (snapshot-shaped state, not traffic — see
``DurableEngine.load_from_storage``), while tailed records ARE logged.
A durable joiner that must survive its own crash after catch-up should
checkpoint to its storage backend once catch-up completes; until then
its local WAL covers only the tailed suffix.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field

from ..bridge import protocol as P
from ..bridge.client import BridgeClient
from ..errors import ConsensusError
from ..obs import (
    SYNC_CATCHUP_SECONDS,
    SYNC_CHUNKS_RECEIVED_TOTAL,
    SYNC_TAIL_RECORDS_TOTAL,
    flight_recorder,
)
from ..obs import registry as default_registry
from ..protocol import compute_vote_hash, validate_vote_chain
from ..storage import InMemoryConsensusStorage
from ..wal.recovery import ReplayStats, apply_record
from .errors import (
    SnapshotDigestError,
    SyncStateError,
    SyncTimeoutError,
    SyncVerificationError,
    TailGapError,
    TailRecordError,
)
from .snapshot import decode_snapshot


def verify_sessions(sessions, scheme) -> int:
    """Verify every session's signed vote chain: per-vote proposal-id
    binding and vote-hash recomputation, per-session hashgraph chain
    linkage (:func:`~hashgraph_tpu_torch.protocol.validate_vote_chain`), ALL
    signatures in one ``verify_batch_submit`` batch — the snapshot's
    crypto cost is one pool-wide pass, not one verify per vote per
    record — and, for sessions claiming a decided outcome, that the
    claimed result is PRODUCIBLE by the decision kernel from the
    verified participants under the shipped config (some admissible
    timing — decide-on-vote or decide-at-timeout — must yield it).
    Returns the number of signatures verified; raises
    :class:`SyncVerificationError` on the first failure (nothing should
    be installed).

    Trust boundary, stated precisely: signatures, hashes, and chain
    structure are cryptographically verified; the per-session scalar
    fields the wire does not sign — config, created_at, columnar tallies
    (the documented columnar trade-off), and the exact decision *timing*
    — are source-asserted, exactly as the reference trusts its own
    persisted sessions (src/storage.rs load semantics). The producibility
    check above caps a hostile source's power at that of an attacker who
    controls message timing and local config, which the BFT model already
    grants; catch up from sources whose gossip you would accept, and the
    health/evidence layer keeps scoring them afterwards."""
    identities: list[bytes] = []
    payloads: list[bytes] = []
    signatures: list[bytes] = []
    refs: list[tuple] = []
    for scope, session in sessions:
        proposal = session.proposal
        for vote in proposal.votes:
            if vote.proposal_id != proposal.proposal_id:
                raise SyncVerificationError(
                    f"snapshot session {scope!r}/{proposal.proposal_id}: "
                    f"embedded vote bound to proposal {vote.proposal_id}"
                )
            if compute_vote_hash(vote) != vote.vote_hash:
                raise SyncVerificationError(
                    f"snapshot session {scope!r}/{proposal.proposal_id}: "
                    f"vote hash mismatch for owner {vote.vote_owner.hex()}"
                )
            identities.append(vote.vote_owner)
            payloads.append(vote.signing_payload())
            signatures.append(vote.signature)
            refs.append((scope, proposal.proposal_id, vote.vote_owner))
        try:
            validate_vote_chain(proposal.votes)
        except ConsensusError as exc:
            raise SyncVerificationError(
                f"snapshot session {scope!r}/{proposal.proposal_id}: "
                f"vote chain invalid ({type(exc).__name__})"
            ) from exc
        if session.state.is_reached:
            claimed = bool(session.state.result)
            if (
                session.decide_now(False) != claimed
                and session.decide_now(True) != claimed
            ):
                raise SyncVerificationError(
                    f"snapshot session {scope!r}/{proposal.proposal_id}: "
                    f"claimed decided result {claimed} is not producible "
                    f"from its verified participants under the shipped "
                    f"config (neither the vote nor the timeout decision "
                    f"path yields it)"
                )
    if identities:
        verdicts = scheme.verify_batch_submit(
            identities, payloads, signatures
        ).collect()
        for verdict, (scope, pid, owner) in zip(verdicts, refs):
            if verdict is not True:
                raise SyncVerificationError(
                    f"snapshot session {scope!r}/{pid}: signature by "
                    f"{owner.hex()} failed verification ({verdict!r})"
                )
    return len(identities)


class CatchUpState:
    """Resumable progress of one catch-up: the manifest being
    transferred, the chunks already received AND digest-verified, whether
    the snapshot was installed into the target engine, and the last WAL
    LSN applied. Hand the same state (and the same engine) to a fresh
    :class:`CatchUpClient` after a connection drop and it continues where
    the old one stopped — mid-download resumes missing chunks,
    post-install resumes the tail."""

    def __init__(self):
        self.manifest: dict | None = None
        self.chunks: dict[int, bytes] = {}
        self.installed = False
        self.applied_lsn = 0


@dataclass
class CatchUpReport:
    """What one catch-up did, for logs/benchmarks."""

    watermark: int = 0
    chunks_fetched: int = 0
    snapshot_bytes: int = 0
    sessions_installed: int = 0
    votes_verified: int = 0
    tail_records: int = 0
    tail_votes: int = 0
    trust_snapshot: bool = False
    resumed: bool = False
    seconds: float = 0.0
    tail_stats: ReplayStats = field(default_factory=ReplayStats)

    @property
    def verified_votes_per_sec(self) -> float:
        total = self.votes_verified + self.tail_votes
        return round(total / self.seconds, 1) if self.seconds else 0.0


class CatchUpClient:
    """One catch-up connection to a source peer's bridge.

    ``state`` (default: fresh) carries resumable progress — see
    :class:`CatchUpState`. The client owns its bridge connection; close it
    (or use as a context manager) when done.

    ``timeout`` is the wall-clock bound on EVERY network operation
    (manifest, chunk, tail request): a source that stalls mid-transfer
    raises the typed :class:`SyncTimeoutError` instead of hanging the
    joiner thread on a silent socket forever — verified progress stays
    in ``state`` for a resume against the same or another source.

    ``bridge`` (advanced) injects the transport: any object with the
    BridgeClient ``sync_manifest``/``sync_chunk``/``wal_tail``/``close``
    surface serves — the deterministic simulator routes catch-up over
    its in-process fabric this way. The client closes whatever bridge it
    holds, injected or not.
    """

    # How many times a stale-snapshot response mid-download triggers a
    # manifest refresh before giving up (a source checkpointing faster
    # than the joiner downloads would otherwise livelock).
    _STALE_RETRIES = 3

    def __init__(
        self,
        host: str,
        port: int,
        source_peer: int,
        *,
        timeout: float = 30.0,
        state: CatchUpState | None = None,
        bridge=None,
    ):
        self._bridge = bridge if bridge is not None else BridgeClient(
            host, port, timeout
        )
        self._timeout = timeout
        self.source_peer = source_peer
        self.state = state if state is not None else CatchUpState()
        self._m_chunks = default_registry.counter(SYNC_CHUNKS_RECEIVED_TOTAL)
        self._m_tail = default_registry.counter(SYNC_TAIL_RECORDS_TOTAL)
        self._m_seconds = default_registry.histogram(SYNC_CATCHUP_SECONDS)

    def _netop(self, operation: str, call):
        """Run one network operation under the typed-timeout contract:
        the socket's wall-clock timeout (set at connect) surfaces as
        :class:`SyncTimeoutError` naming the stalled step, never a raw
        ``socket.timeout`` the joiner's supervisor cannot route."""
        try:
            return call()
        except TimeoutError as exc:  # socket.timeout is a subclass
            raise SyncTimeoutError(operation, self._timeout) from exc

    def close(self) -> None:
        self._bridge.close()

    def __enter__(self) -> "CatchUpClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ── Public entry points ────────────────────────────────────────────

    def catch_up(
        self,
        engine,
        *,
        trust_snapshot: bool = False,
        max_chunk_bytes: int = 0,
        tail_max_bytes: int = 0,
    ) -> CatchUpReport:
        """Snapshot + tail catch-up of ``engine`` from the source peer.
        The engine must be fresh (no tracked sessions) unless resuming a
        state whose snapshot already installed into it. Returns a
        :class:`CatchUpReport`; failures raise the typed
        :mod:`hashgraph_tpu_torch.sync.errors` with nothing partially
        installed."""
        t0 = time.perf_counter()
        report = CatchUpReport(trust_snapshot=trust_snapshot)
        st = self.state
        report.resumed = bool(st.chunks or st.installed)
        try:
            if not st.installed:
                self._guard_fresh(engine)
                self._download_snapshot(report, max_chunk_bytes)
                self._verify_and_install(engine, report, trust_snapshot)
            else:
                report.watermark = st.applied_lsn if st.manifest is None else (
                    st.manifest["watermark"]
                )
            self._tail(engine, report, tail_max_bytes)
        except BaseException as exc:
            flight_recorder.record(
                "sync.failed",
                source_peer=self.source_peer,
                error=repr(exc),
                installed=st.installed,
                applied_lsn=st.applied_lsn,
            )
            raise
        report.seconds = round(time.perf_counter() - t0, 6)
        self._m_seconds.observe(report.seconds)
        flight_recorder.record(
            "sync.catchup",
            source_peer=self.source_peer,
            watermark=report.watermark,
            sessions=report.sessions_installed,
            votes_verified=report.votes_verified,
            tail_records=report.tail_records,
            seconds=report.seconds,
            resumed=report.resumed,
            trust_snapshot=trust_snapshot,
        )
        return report

    def full_replay(self, engine, *, tail_max_bytes: int = 0) -> CatchUpReport:
        """Catch up by streaming and applying the source's ENTIRE WAL —
        no snapshot, per-record validation all the way (the O(history)
        baseline that snapshot+tail is measured against).
        Only possible while the source's log is uncompacted from LSN 1;
        a compacted source raises :class:`TailGapError` — the signal that
        a snapshot is required."""
        t0 = time.perf_counter()
        report = CatchUpReport()
        try:
            self._tail(engine, report, tail_max_bytes)
        except BaseException as exc:
            flight_recorder.record(
                "sync.failed",
                source_peer=self.source_peer,
                error=repr(exc),
                installed=False,
                applied_lsn=self.state.applied_lsn,
            )
            raise
        report.seconds = round(time.perf_counter() - t0, 6)
        self._m_seconds.observe(report.seconds)
        flight_recorder.record(
            "sync.catchup",
            source_peer=self.source_peer,
            watermark=0,
            sessions=0,
            votes_verified=0,
            tail_records=report.tail_records,
            seconds=report.seconds,
            resumed=report.resumed,
            trust_snapshot=False,
        )
        return report

    # ── Steps ──────────────────────────────────────────────────────────

    @staticmethod
    def _guard_fresh(engine) -> None:
        occupancy = getattr(engine, "occupancy", None)
        if occupancy is not None and occupancy().get("live_sessions", 0):
            raise SyncStateError(
                "snapshot install requires a fresh engine (this one "
                "already tracks sessions); build a new engine, or resume "
                "with the CatchUpState that installed into it"
            )

    def _download_snapshot(self, report: CatchUpReport, max_chunk_bytes: int) -> None:
        st = self.state
        for attempt in range(self._STALE_RETRIES + 1):
            manifest = self._netop(
                "manifest request",
                lambda: self._bridge.sync_manifest(
                    self.source_peer, max_chunk_bytes
                ),
            )
            if (
                st.manifest is not None
                and st.manifest["snapshot_id"] != manifest["snapshot_id"]
            ):
                # The source's state moved on and its snapshot was
                # rebuilt: previously downloaded chunks belong to a dead
                # artifact.
                st.chunks.clear()
            st.manifest = manifest
            try:
                for index in range(manifest["chunk_count"]):
                    if index in st.chunks:
                        continue
                    data = self._netop(
                        f"chunk {index} request",
                        lambda: self._bridge.sync_chunk(
                            self.source_peer, manifest["snapshot_id"], index
                        ),
                    )
                    self._check_chunk(manifest, index, data)
                    st.chunks[index] = data
                    report.chunks_fetched += 1
                    self._m_chunks.inc()
                return
            except Exception as exc:
                stale = (
                    getattr(exc, "status", None) == P.STATUS_SYNC_STALE
                )
                if not stale or attempt >= self._STALE_RETRIES:
                    raise
                # Keep st.manifest (the now-dead snapshot's): the next
                # loop's id comparison against the freshly fetched
                # manifest is what clears the dead snapshot's chunks —
                # nulling it here would let them survive into the new
                # transfer and corrupt the reassembled stream.

    @staticmethod
    def _check_chunk(manifest: dict, index: int, data: bytes) -> None:
        last = manifest["chunk_count"] - 1
        expected_len = (
            manifest["chunk_bytes"]
            if index < last
            else manifest["total_bytes"] - manifest["chunk_bytes"] * last
        )
        if len(data) != expected_len:
            raise SnapshotDigestError(
                f"chunk {index}: got {len(data)} bytes, manifest says "
                f"{expected_len}"
            )
        if hashlib.sha256(data).digest() != manifest["digests"][index]:
            raise SnapshotDigestError(
                f"chunk {index}: SHA-256 mismatch against the manifest — "
                "corrupt transfer or hostile source; nothing installed"
            )

    def _verify_and_install(
        self, engine, report: CatchUpReport, trust_snapshot: bool
    ) -> None:
        st = self.state
        manifest = st.manifest
        chunks = (st.chunks[i] for i in range(manifest["chunk_count"]))
        watermark, sessions, configs = decode_snapshot(chunks)
        if watermark != manifest["watermark"]:
            raise SyncVerificationError(
                f"snapshot header watermark {watermark} disagrees with "
                f"the manifest's {manifest['watermark']}"
            )
        if not trust_snapshot:
            report.votes_verified = verify_sessions(
                sessions, type(engine.signer())
            )
        storage = InMemoryConsensusStorage()
        for scope, config in configs:
            storage.set_scope_config(scope, config)
        for scope, session in sessions:
            storage.save_session(scope, session)
        set_mode = getattr(engine, "set_replay_mode", None)
        if set_mode is not None:
            set_mode(True)
        try:
            # Configs first, and EXPLICITLY: load_from_storage only walks
            # scopes that hold sessions, which would drop a configured-
            # but-empty scope from the install (and catch-up must land on
            # the source's exact state, configs included).
            for scope, config in configs:
                engine.set_scope_config(scope, config)
            report.sessions_installed = engine.load_from_storage(storage)
        finally:
            if set_mode is not None:
                set_mode(False)
        report.watermark = watermark
        report.snapshot_bytes = manifest["total_bytes"]
        st.installed = True
        st.applied_lsn = watermark
        st.chunks.clear()  # transferred and installed; free the memory

    def _tail(self, engine, report: CatchUpReport, tail_max_bytes: int) -> None:
        st = self.state
        set_mode = getattr(engine, "set_replay_mode", None)
        if set_mode is not None:
            set_mode(True)
        try:
            while True:
                records, more = self._netop(
                    "tail request",
                    lambda: self._bridge.wal_tail(
                        self.source_peer, st.applied_lsn, tail_max_bytes
                    ),
                )
                for lsn, kind, payload in records:
                    if lsn != st.applied_lsn + 1:
                        raise TailGapError(st.applied_lsn + 1, lsn)
                    before = report.tail_stats.votes_replayed
                    apply_record(
                        engine, kind, payload, report.tail_stats, lsn=lsn
                    )
                    if report.tail_stats.errors:
                        # Local crash replay tolerates decode faults
                        # (surfaced in stats, keep going); a REMOTE
                        # catch-up must not — skipping a record means
                        # silent divergence from the source.
                        raise TailRecordError(
                            f"tail record lsn {lsn} failed to decode: "
                            f"{report.tail_stats.errors[0][1]}"
                        )
                    st.applied_lsn = lsn
                    report.tail_records += 1
                    report.tail_votes += (
                        report.tail_stats.votes_replayed - before
                    )
                    self._m_tail.inc()
                if not more:
                    return
        finally:
            if set_mode is not None:
                set_mode(False)
