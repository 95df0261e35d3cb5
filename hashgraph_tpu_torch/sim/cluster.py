"""SimCluster: N in-process peers (engine + WAL + gossip) on virtual time.

Each :class:`SimPeer` is the full production stack of one node:

- a :class:`~hashgraph_tpu_torch.bridge.BridgeServer` in **embedded** mode —
  same dispatch table, opcodes, and per-peer engine construction as the
  TCP front-end, no sockets — whose engines live on the cluster's
  ``device`` (``"cuda"`` by default: every applied vote goes through the
  ``ingest_scan`` kernel);
- a durable engine (``wal_dir`` per identity): every mutation is WAL-
  logged exactly as in production, so crash-restart scenarios replay a
  REAL log through the REAL ``recover()`` path (the embedded server's
  ``ADD_PEER`` with the peer's key runs recovery, the same code a
  restarted bridge runs);
- a private :class:`~hashgraph_tpu_torch.obs.HealthMonitor` whose scorecards,
  evidence log, and ``convicted_peers()`` readout the accountability
  verdict interrogates;
- a :class:`~hashgraph_tpu_torch.gossip.node.GossipNode` over a
  :class:`~hashgraph_tpu_torch.sim.transport.SimTransport` — sampled fan-out,
  vote coalescing, anti-entropy repair, and far-behind catch-up
  escalation all run the live gossip code, on virtual time.

The cluster is also the **workload driver** (the reference's "app
supplies the network" embedder): it creates sessions over the wire
(``OP_CREATE_PROPOSAL``), ferries proposal bytes (``OP_PROCESS_PROPOSAL``
/ ``OP_DELIVER_PROPOSALS``), has peers vote (``OP_CAST_VOTE``) and fans
the signed votes out through the coalesced ``OP_VOTE_BATCH`` hot path,
fires timeouts (``OP_HANDLE_TIMEOUT``), drains events
(``OP_POLL_EVENTS``), and reads decisions (``OP_GET_RESULT``) and
fingerprints — every public entry point, every byte through the wire
codec. Vote chains stay canonical (each voter is synced over the network
before casting; an unreachable voter simply skips its turn), so honest
peers can only ever hold positional prefixes of one chain — any fork in
the fabric is, by construction, the work of an injected Byzantine actor.
"""

from __future__ import annotations

import os
import shutil

from ..bridge import protocol as P
from ..bridge.server import BridgeServer
from ..obs import HealthMonitor, MetricsRegistry
from ..obs.health import DEFAULT_PHI_THRESHOLD
from ..signing.stub import StubConsensusSigner
from ..sync import CatchUpClient
from ..wire import Proposal, Vote
from .core import SimScheduler, derived_rng, deterministic_ids
from .transport import SimBridgeAdapter, SimNetwork, SimTransport

_OK = P.STATUS_OK


class SimSession:
    """Sim-side bookkeeping of one consensus session: the CANONICAL vote
    chain (the embedder's ferry copy — each accepted vote appends here,
    every honest peer's chain is a positional prefix of it)."""

    __slots__ = ("scope", "pid", "origin", "proposal", "created_tick")

    def __init__(
        self,
        scope: str,
        pid: int,
        origin: "SimPeer",
        proposal: Proposal,
        created_tick: int = 0,
    ):
        self.scope = scope
        self.pid = pid
        self.origin = origin
        self.proposal = proposal
        # Logical tick at creation — the liveness verdict measures each
        # session's decide latency against this.
        self.created_tick = created_tick


class SimPeer:
    """One simulated node. ``start()`` builds the embedded server +
    durable engine + gossip node; ``crash()`` kills it kill-9 style
    (WAL handles abandoned, endpoint down); ``restart()`` brings the
    same identity back through real WAL recovery (or, after
    ``wipe=True``, as a fresh joiner that must catch up)."""

    def __init__(self, cluster: "SimCluster", index: int):
        self.cluster = cluster
        self.index = index
        self.name = f"p{index}"
        self.key = derived_rng(cluster.seed, f"peer-key:{index}").randbytes(32)
        self.wal_dir = os.path.join(cluster.root, self.name)
        self.server: BridgeServer | None = None
        self.node = None
        self.transport: SimTransport | None = None
        self.monitor: HealthMonitor | None = None
        self.peer_id = 0
        self.identity = b""
        self.crashed = False
        self.restarts = 0
        self.last_recovery = None

    # ── lifecycle ──────────────────────────────────────────────────────

    def start(self) -> None:
        from ..gossip.node import GossipNode

        cluster = self.cluster
        self.monitor = HealthMonitor(
            registry=MetricsRegistry(),
            stale_after=cluster.stale_after,
            phi_threshold=cluster.phi_threshold,
        )
        self.server = BridgeServer(
            capacity=cluster.capacity,
            voter_capacity=cluster.voter_capacity,
            wal_dir=self.wal_dir,
            wal_fsync="batch",
            signer_factory=cluster.signer_factory,
            health_monitor=self.monitor,
            wire_columnar=cluster.wire_columnar,
            apply_reactor=cluster.apply_reactor,
            device=cluster.device,
        )
        self.server.start_embedded()
        status, out = self.server.dispatch_frame(
            P.OP_ADD_PEER, P.u8(len(self.key)) + self.key
        )
        if status != _OK:
            raise RuntimeError(f"ADD_PEER failed for {self.name}: {status}")
        cursor = P.Cursor(out)
        self.peer_id = cursor.u32()
        self.identity = cursor.raw(cursor.u8())
        self.last_recovery = self.server.recovery_stats(self.identity)
        self.transport = SimTransport(cluster.network, self.name)
        self.node = GossipNode(
            self.name,
            engine=self.engine,
            transport=self.transport,
            fanout=cluster.fanout,
            seed=derived_rng(
                cluster.seed, f"node:{self.name}:{self.restarts}"
            ).getrandbits(64),
            escalate_sessions=cluster.escalate_sessions,
            catchup_factory=cluster._catchup_factory,
        )
        cluster.network.register(self.name, self.server.dispatch_frame)
        self.crashed = False

    @property
    def engine(self):
        """The peer's engine behind the bridge (a DurableEngine)."""
        return self.server.peer_engine(self.peer_id)

    @property
    def durable(self):
        return self.server.durable_engine(self.identity)

    def crash(self) -> None:
        """kill -9: abandon the WAL (handles + flock released, NO final
        fsync), take the endpoint off the network, discard the process
        state. In-flight frames addressed here fail typed; other peers'
        channels stay up and heal the moment the identity returns."""
        durable = self.durable
        if durable is not None:
            durable.abandon()
        self.cluster.network.mark_down(self.name)
        if self.transport is not None:
            self.transport.close()
        if self.server is not None:
            self.server.stop()
        self.server = None
        self.node = None
        self.transport = None
        self.crashed = True

    def crash_mid_append(
        self, session: "SimSession", *, torn_bytes: int = 7, choice: bool = True
    ) -> None:
        """kill -9 *mid-WAL-append*: arm the writer's crash hook so the
        peer's next mutator (a locally-cast vote) dies after ``torn_bytes``
        of its record hit the disk — the torn tail the recovery scan must
        truncate. The engine had applied the vote (the documented
        crash window for locally-minted data); the restart recovers the
        surviving prefix."""
        from ..wal.writer import SimulatedCrash

        durable = self.durable

        def hook(point: str) -> None:
            if point == "append":
                raise SimulatedCrash(point, torn_bytes=torn_bytes)

        durable.wal.set_crash_hook(hook)
        try:
            durable.cast_vote(
                session.scope, session.pid, choice, self.cluster.now
            )
        except SimulatedCrash:
            pass
        else:
            raise RuntimeError("crash hook did not fire")
        self.crash()

    def restart(self, wipe: bool = False) -> None:
        """Bring the identity back: with its WAL (``ADD_PEER`` replays
        the surviving log through ``recover()``), or — ``wipe=True``, the
        lost-disk case — fresh, relying on the gossip node's catch-up
        escalation to rejoin. Reconnects this node's channels to every
        live peer (the real transport's ReconnectPolicy analogue)."""
        if not self.crashed:
            raise RuntimeError(f"{self.name} is not crashed")
        if wipe:
            shutil.rmtree(self.wal_dir, ignore_errors=True)
        self.restarts += 1
        self.start()
        for other in self.cluster.live_peers():
            if other is not self:
                self.node.add_peer(other.name, other.name, 0, other.peer_id)

    def shutdown(self) -> None:
        """Clean stop (WALs flushed + closed) — end-of-scenario teardown."""
        if self.crashed:
            return
        if self.transport is not None:
            self.transport.close()
        if self.server is not None:
            self.server.stop()
        self.crashed = True

    def note_known_sessions(self) -> None:
        """Sync the gossip node's anti-entropy bookkeeping with the
        engine's live sessions (the embedder wiring ``note_session``
        documents) so repair rounds push everything the peer holds."""
        for scope, pid in self.engine.session_keys():
            self.node.note_session(scope, pid)


class SimCluster:
    """N peers + the network + the workload driver. Use as a context
    manager; every run with the same ``seed`` (and scenario script) is
    byte-identical — ids, signatures, WAL bytes, fingerprints included
    (:class:`~hashgraph_tpu_torch.sim.core.deterministic_ids`), on either
    ``device``: every peer's server builds its engines there (``"cuda"``
    by default, which raises without a GPU; tests pass ``"cpu"``)."""

    def __init__(
        self,
        root: str,
        seed: int,
        n_peers: int = 4,
        *,
        fanout: int | None = None,
        stale_after: float = 10**9,
        phi_threshold: "float | None" = DEFAULT_PHI_THRESHOLD,
        capacity: int = 64,
        voter_capacity: int = 8,
        escalate_sessions: int = 8,
        signer_factory: type = StubConsensusSigner,
        base_delay: int = 1,
        wire_columnar: "bool | None" = None,
        apply_reactor: "bool | None" = None,
        device: str = "cuda",
    ):
        self.root = root
        self.device = device
        self.seed = seed
        self.fanout = fanout
        self.stale_after = stale_after
        # φ-accrual suspicion bar for every peer's HealthMonitor (None =
        # binary-threshold-only watchdog — the liveness A/B baseline arm).
        self.phi_threshold = phi_threshold
        self.capacity = capacity
        self.voter_capacity = voter_capacity
        self.escalate_sessions = escalate_sessions
        self.signer_factory = signer_factory
        # Per-cluster override of the bridge's columnar wire path (None =
        # the server's env-driven default): scenario runs must be pure
        # functions of their arguments, and the columnar-wire scenario
        # pins this True so the env cannot change what it asserts.
        self.wire_columnar = wire_columnar
        # Apply-reactor override, same contract as wire_columnar. In the
        # sim the server stays embedded (never start()ed), so the
        # reactor runs in manual mode: submit + flush inline on the
        # dispatching tick — windows merge deterministically, no threads
        # and no wall-clock deadlines enter the simulation.
        self.apply_reactor = apply_reactor
        self.scheduler = SimScheduler(seed)
        self.network = SimNetwork(self.scheduler, base_delay=base_delay)
        # The CONSENSUS clock: the logical `now` every engine call gets.
        # Deliberately decoupled from the scheduler's event tick and
        # piecewise-constant (advance_clock() moves it at phase
        # boundaries only): per-peer lifecycle fields like a session's
        # created_at are stamped with the embedder-supplied now, so
        # convergence to state-fingerprint EQUALITY requires every peer
        # to learn a session at the same logical tick no matter how late
        # repair delivered it — exactly the no-wall-clock contract the
        # library already imposes on embedders.
        self.clock = 1_000
        self.rng = derived_rng(seed, "workload")
        self._ids = deterministic_ids(seed)
        self._ids.__enter__()
        self.sessions: list[SimSession] = []
        # (scope, pid) -> logical tick at which the session FIRST read
        # decided on any peer (the liveness verdict's decide-latency
        # numerator). Stamped eagerly on the acting peer after each cast
        # / timeout, with a late-discovery sweep (note_decisions) for
        # sessions that decided through repair instead.
        self.decision_ticks: "dict[tuple[str, int], int]" = {}
        self.catchups = 0
        self.peers = [SimPeer(self, i) for i in range(n_peers)]
        try:
            for peer in self.peers:
                peer.start()
            self.wire_full_mesh()
        except BaseException:
            # A constructor failure escapes before the context manager
            # exists: the process-global id-entropy install (and any
            # started peers' WAL handles) must not leak past it.
            self.close()
            raise

    def close(self) -> None:
        for peer in self.peers:
            peer.shutdown()
        self._ids.__exit__(None, None, None)

    def __enter__(self) -> "SimCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ── topology ───────────────────────────────────────────────────────

    def live_peers(self) -> "list[SimPeer]":
        return [p for p in self.peers if not p.crashed]

    def peer(self, index: int) -> SimPeer:
        return self.peers[index]

    def wire_full_mesh(self) -> None:
        for a in self.live_peers():
            for b in self.live_peers():
                if a is not b and a.transport.channel(b.name) is None:
                    a.node.add_peer(b.name, b.name, 0, b.peer_id)

    def _catchup_factory(self, host: str, port: int, peer_id: int):
        """GossipNode escalation seam: a CatchUpClient whose transport is
        the sim fabric (``host`` carries the target's NAME — see
        SimTransport.connect). The live snapshot/digest/tail code runs
        unchanged."""
        self.catchups += 1
        return CatchUpClient(
            host, port, peer_id,
            bridge=SimBridgeAdapter(self.network, host),
        )

    # ── workload: the embedder loop over public entry points ───────────

    @property
    def now(self) -> int:
        return self.clock

    def advance_clock(self, ticks: int) -> None:
        self.clock += int(ticks)

    def run_network(self) -> None:
        self.scheduler.run_until_idle()

    def create_session(
        self,
        origin: SimPeer,
        scope: str,
        *,
        voters: int | None = None,
        rel_expiry: int = 500_000,
        liveness: bool = True,
        payload: bytes = b"chaos",
    ) -> SimSession:
        """OP_CREATE_PROPOSAL on the origin, then ferry the proposal to
        every live peer over the (faultable) network via
        OP_PROCESS_PROPOSAL — peers a partition hides miss it and must be
        repaired by anti-entropy later."""
        now = self.now
        if voters is None:
            voters = len(self.peers)
        status, out = origin.server.dispatch_frame(
            P.OP_CREATE_PROPOSAL,
            P.u32(origin.peer_id)
            + P.string(scope)
            + P.u64(now)
            + P.string(f"chaos-{scope}")
            + P.blob(payload)
            + P.u32(voters)
            + P.u64(rel_expiry)
            + P.u8(1 if liveness else 0),
        )
        if status != _OK:
            raise RuntimeError(f"create_proposal failed: status {status}")
        cursor = P.Cursor(out)
        pid = cursor.u32()
        proposal = Proposal.decode(cursor.blob())
        session = SimSession(scope, pid, origin, proposal, created_tick=now)
        self.sessions.append(session)
        origin.node.note_session(scope, pid)
        wire = proposal.encode()
        for peer in self.live_peers():
            if peer is origin:
                continue
            origin.transport.try_request(
                peer.name,
                P.OP_PROCESS_PROPOSAL,
                P.u32(peer.peer_id) + P.string(scope) + P.u64(now) + P.blob(wire),
            )
        self.run_network()
        return session

    def cast_vote(
        self, session: SimSession, voter: SimPeer, choice: bool
    ) -> "bytes | None":
        """One canonical-chain vote: sync the voter to the canonical
        chain OVER THE NETWORK (an unreachable voter cannot see the
        chain and skips its turn — returns None), OP_CAST_VOTE on the
        voter's engine, append the signed bytes to the canonical chain,
        fan out through the voter's gossip node (coalesced
        OP_VOTE_BATCH, sampled fan-out)."""
        now = self.now
        if voter.crashed:
            return None
        deliver = P.encode_deliver_proposals(
            voter.peer_id,
            [(session.scope, session.proposal.encode())],
            now,
        )
        if voter is session.origin:
            # The canonical chain IS the origin's embedder ledger: feeding
            # it back into the origin's own engine is a local embedder
            # action (no network), and keeps the origin from signing a
            # vote against a stale view when fan-out frames to it were
            # dropped — which would put a broken link into the canonical
            # chain and manufacture an honest "fork".
            voter.server.dispatch_frame(P.OP_DELIVER_PROPOSALS, deliver)
        else:
            if session.origin.crashed:
                return None
            future = session.origin.transport.try_request(
                voter.name, P.OP_DELIVER_PROPOSALS, deliver
            )
            if future is None:
                return None
            try:
                future.result(30)
            except Exception:
                return None  # unreachable this turn; the chain moves on
        status, out = voter.server.dispatch_frame(
            P.OP_CAST_VOTE,
            P.u32(voter.peer_id)
            + P.string(session.scope)
            + P.u32(session.pid)
            + P.u8(1 if choice else 0)
            + P.u64(now),
        )
        if status != _OK:
            return None  # already voted / expired — skip
        vote_bytes = P.Cursor(out).blob()
        vote = Vote.decode(vote_bytes)
        # Post-decision casts return a signed vote WITHOUT applying it
        # (ALREADY_REACHED absorbed — reference semantics). Gossiping
        # such a vote would put an unapplied signature into the fabric
        # (and a retry would mint a CONFLICTING one), so only a cast
        # that actually extended the voter's chain joins the canonical
        # chain and fans out.
        status, out = voter.server.dispatch_frame(
            P.OP_GET_PROPOSAL,
            P.u32(voter.peer_id) + P.string(session.scope) + P.u32(session.pid),
        )
        if status != _OK:
            return None
        applied = Proposal.decode(P.Cursor(out).blob())
        if (
            len(applied.votes) != len(session.proposal.votes) + 1
            or applied.votes[-1].vote_hash != vote.vote_hash
        ):
            return None  # absorbed without applying (decided session)
        session.proposal.votes.append(vote)
        self._record_decision(session, voter)
        voter.node.note_session(session.scope, session.pid)
        voter.node.submit_votes(
            session.scope, session.pid, [vote_bytes], now, local=False
        )
        voter.node.flush_all()
        self.run_network()
        return vote_bytes

    def vote_all(self, session: SimSession, values: "list[bool] | None" = None):
        """Every live peer votes once, in peer order (deterministic)."""
        cast = 0
        for i, peer in enumerate(self.peers):
            if peer.crashed:
                continue
            value = True if values is None else values[i % len(values)]
            if self.cast_vote(session, peer, value) is not None:
                cast += 1
        return cast

    def drain_all(self) -> dict:
        """Flush + await every node's in-flight hot-path frames (virtual
        blocking) and drain bridge events (OP_POLL_EVENTS coverage)."""
        report = {"acked": 0, "rejected": 0, "failed_frames": 0, "events": 0}
        for peer in self.live_peers():
            out = peer.node.drain()
            report["acked"] += out["acked"]
            report["rejected"] += out["rejected"]
            report["failed_frames"] += out["failed_frames"]
            status, payload = peer.server.dispatch_frame(
                P.OP_POLL_EVENTS, P.u32(peer.peer_id)
            )
            if status == _OK:
                report["events"] += P.Cursor(payload).u32()
        return report

    def anti_entropy_round(self, max_sessions: int = 256) -> dict:
        """One repair round from every live peer (shed-dirty scopes
        first, rotation after — the live GossipNode code)."""
        total = {"pushed": 0, "created_or_extended": 0, "failed": 0,
                 "escalated": 0}
        for peer in self.live_peers():
            peer.note_known_sessions()
        for peer in self.live_peers():
            report = peer.node.anti_entropy(
                self.now, max_sessions=max_sessions
            )
            total["pushed"] += report["pushed_sessions"]
            total["created_or_extended"] += report["created_or_extended"]
            total["failed"] += report["failed"]
            if report["escalated"] is not None:
                total["escalated"] += 1
            self.run_network()
        return total

    def fingerprints(self) -> "dict[str, str]":
        """Per-peer state fingerprint via OP_STATE_FINGERPRINT — the
        convergence criterion, read over the wire."""
        out = {}
        for peer in self.live_peers():
            status, payload = peer.server.dispatch_frame(
                P.OP_STATE_FINGERPRINT, P.u32(peer.peer_id)
            )
            if status != _OK:
                raise RuntimeError(f"fingerprint failed on {peer.name}")
            out[peer.name] = P.Cursor(payload).string()
        return out

    def converge(self, max_rounds: int = 8) -> dict:
        """Anti-entropy until all live peers fingerprint-equal (or the
        round cap). Returns {'ok', 'rounds', 'fingerprints'}."""
        rounds = 0
        prints = self.fingerprints()
        while len(set(prints.values())) > 1 and rounds < max_rounds:
            self.anti_entropy_round()
            rounds += 1
            prints = self.fingerprints()
        return {
            "ok": len(set(prints.values())) == 1,
            "rounds": rounds,
            "fingerprints": prints,
        }

    def results(self, session: SimSession) -> "dict[str, object]":
        """OP_GET_RESULT per live peer: True/False decided, None
        undecided, 'failed' consensus-failed, 'missing' unknown."""
        out: dict[str, object] = {}
        for peer in self.live_peers():
            status, payload = peer.server.dispatch_frame(
                P.OP_GET_RESULT,
                P.u32(peer.peer_id)
                + P.string(session.scope)
                + P.u32(session.pid),
            )
            if status != _OK:
                out[peer.name] = "missing"
                continue
            value = P.Cursor(payload).u8()
            out[peer.name] = {
                P.RESULT_UNDECIDED: None,
                P.RESULT_FAILED: "failed",
                P.RESULT_YES: True,
                P.RESULT_NO: False,
            }[value]
        return out

    def fire_timeout(self, session: SimSession) -> dict:
        """OP_HANDLE_TIMEOUT on every live peer (the embedder's timer
        duty) — exercised after reconvergence so peers time out on the
        same view."""
        out = {}
        for peer in self.live_peers():
            status, payload = peer.server.dispatch_frame(
                P.OP_HANDLE_TIMEOUT,
                P.u32(peer.peer_id)
                + P.string(session.scope)
                + P.u32(session.pid)
                + P.u64(self.now),
            )
            out[peer.name] = (
                bool(P.Cursor(payload).u8()) if status == _OK else f"status {status}"
            )
            self._record_decision(session, peer)
        return out

    # ── decision-tick bookkeeping (liveness verdict) ───────────────────

    def _record_decision(self, session: SimSession, peer: SimPeer) -> None:
        """Stamp the logical tick at which ``session`` first reads
        decided on any peer (first stamp wins; read-only OP_GET_RESULT,
        so the extra dispatch cannot perturb the run)."""
        key = (session.scope, session.pid)
        if key in self.decision_ticks or peer.crashed:
            return
        status, payload = peer.server.dispatch_frame(
            P.OP_GET_RESULT,
            P.u32(peer.peer_id)
            + P.string(session.scope)
            + P.u32(session.pid),
        )
        if status != _OK:
            return
        if P.Cursor(payload).u8() in (P.RESULT_YES, P.RESULT_NO):
            self.decision_ticks[key] = self.now

    def note_decisions(self) -> None:
        """Late-discovery sweep: sessions that decided through gossip
        fan-out or anti-entropy repair (no locally-observed cast) get
        stamped at the CURRENT tick — an upper bound on their decide
        latency, which is all the liveness bound needs."""
        for session in self.sessions:
            key = (session.scope, session.pid)
            if key in self.decision_ticks:
                continue
            for peer in self.live_peers():
                self._record_decision(session, peer)
                if key in self.decision_ticks:
                    break
