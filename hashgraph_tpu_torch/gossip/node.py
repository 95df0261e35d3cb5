"""GossipNode: sampled fan-out + anti-entropy over the bridge fabric.

One node owns (optionally) a local consensus engine and a set of remote
peers reached through a :class:`~hashgraph_tpu_torch.gossip.transport.
GossipTransport`. Deliveries follow Baird's gossip-about-gossip shape in
two tiers:

- **hot path**: :meth:`submit_votes` applies locally, then fans each
  vote out to a *sampled* subset of peers (``fanout``) through the
  :class:`~hashgraph_tpu_torch.gossip.coalescer.VoteCoalescer` — coalesced
  columnar frames, pipelined on the wire, bounded queues throughout;
- **repair path**: :meth:`anti_entropy` periodically pushes full
  proposals (their whole retained vote chains) to peers via
  ``OP_DELIVER_PROPOSALS``. The receiving engine's validated-chain
  watermark makes this cheap: an already-known chain settles with ONE
  tail-hash compare and zero crypto, a lagging peer verifies only the
  suffix it was missing, an unknown session is created whole. Scopes
  whose hot-path frames were *shed* (slow peer, queue at cap) are
  pushed first — backpressure degrades to deferred repair, never to
  unbounded buffering or silent loss.

A peer that is TOO far behind for incremental repair — a fresh joiner,
or a node whose whole history was lost — escalates to the state-sync
path: :meth:`anti_entropy` probes a sampled peer's snapshot manifest
and, when the local engine is fresh and the gap exceeds
``escalate_sessions``, runs a full
:class:`~hashgraph_tpu_torch.sync.CatchUpClient` catch-up (snapshot + WAL
tail) instead of absorbing thousands of deliver frames.
"""

from __future__ import annotations

import random
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout

import numpy as np

from ..bridge import columnar as WC
from ..bridge import protocol as P
from ..bridge.reactor import ApplyReactor, reactor_enabled
from ..bridge.client import (
    BridgeConnectionLost,
    BridgeError,
    parse_status_list,
    parse_sync_manifest,
)
from ..errors import ConsensusError, StatusCode
from ..obs import (
    GOSSIP_ANTI_ENTROPY_ROUNDS_TOTAL,
    GOSSIP_ANTI_ENTROPY_SESSIONS_TOTAL,
    GOSSIP_CATCHUP_ESCALATIONS_TOTAL,
    GOSSIP_FRAMES_DEFERRED_TOTAL,
    flight_recorder,
)
from ..obs import registry as default_registry
from ..wire import Vote
from .coalescer import VoteCoalescer
from .transport import ChannelBusy, GossipTransport

_OK = int(StatusCode.OK)
_ALREADY = int(StatusCode.PROPOSAL_ALREADY_EXIST)


class _PeerInfo:
    __slots__ = ("name", "host", "port", "peer_id")

    def __init__(self, name: str, host: str, port: int, peer_id: int):
        self.name = name
        self.host = host
        self.port = port
        self.peer_id = peer_id


class GossipNode:
    """Fan-out + anti-entropy façade over one transport.

    ``engine=None`` builds a pure driver (fan-out only; anti-entropy and
    escalation need a local engine to read proposals from / install
    into). ``fanout=None`` targets every peer; an integer samples that
    many per submit (deterministic under ``seed``). ``flusher=True``
    runs a small background thread that closes coalescer windows on
    ``flush_interval`` expiry — leave it off when a driving loop calls
    :meth:`pump` itself (the benches do)."""

    def __init__(
        self,
        name: str,
        *,
        engine=None,
        transport: GossipTransport | None = None,
        fanout: int | None = None,
        seed: int | None = None,
        flush_votes: int = 256,
        flush_bytes: int = 512 * 1024,
        flush_interval: float = 0.005,
        escalate_sessions: int = 64,
        flusher: bool = False,
        catchup_factory=None,
        shm_ring_bytes: int | None = None,
        apply_reactor: "bool | ApplyReactor | None" = None,
    ):
        self.name = name
        self._engine = engine
        # Escalation seam: ``catchup_factory(host, port, peer_id)`` must
        # return a CatchUpClient-shaped object (catch_up + close). The
        # default dials a real bridge over TCP; the deterministic
        # simulator injects one that rides its in-process fabric instead,
        # so the far-behind escalation path itself stays the live code.
        self._catchup_factory = catchup_factory
        # shm_ring_bytes opts co-located peers into the shared-memory
        # ring lane (loopback endpoints whose server grants
        # FEATURE_SHM_RING); None keeps pure TCP.
        self._transport = (
            transport
            if transport is not None
            else GossipTransport(shm_ring_bytes=shm_ring_bytes)
        )
        self._owns_transport = transport is None
        self._fanout = fanout
        self._rng = random.Random(seed)
        self._coalescer = VoteCoalescer(
            flush_votes=flush_votes,
            flush_bytes=flush_bytes,
            flush_interval=flush_interval,
        )
        self._escalate_sessions = escalate_sessions
        # Local-apply reactor seam: pass the embedding BridgeServer's
        # ApplyReactor instance so this node's local applies merge into
        # the SAME per-engine windows as wire frames; True builds a
        # private (manual-mode) one; None defers to the env default.
        if isinstance(apply_reactor, ApplyReactor):
            self._reactor: "ApplyReactor | None" = apply_reactor
            self._owns_reactor = False
        elif reactor_enabled(apply_reactor):
            self._reactor = ApplyReactor()
            self._owns_reactor = True
        else:
            self._reactor = None
            self._owns_reactor = False
        self._lock = threading.Lock()
        self._peers: dict[str, _PeerInfo] = {}
        # scope -> ordered pid list; peer -> scopes owed a repair push;
        # peer -> rotation cursor into the non-dirty session list, so
        # successive anti-entropy rounds cover EVERY session even when
        # one round's max_sessions can't (the cursor advances by what
        # each round actually pushed).
        self._sessions: dict[str, list[int]] = {}
        self._dirty: dict[str, set[str]] = {}
        self._rotation: dict[str, int] = {}
        # (scope, pid) -> the session's STICKY fan-out sample. Sampling
        # is per SESSION, not per submit call: if consecutive chunks of
        # one session went to different subsets, every peer would hold a
        # different interleaved fragment — and a fragment that is not a
        # positional prefix of the pusher's chain settles as a benign
        # redelivery under the watermark, so anti-entropy could never
        # repair the fabric to byte-identical state. With a sticky
        # sample, a non-sampled peer misses the WHOLE session, which
        # repair creates wholesale.
        self._session_targets: dict[tuple[str, int], list[str]] = {}
        self._tracked = 0  # total (scope, pid) pairs in _sessions
        # In-flight hot-path frames: (peer, meta, future). Reaped
        # opportunistically (pump/_send_frame) so a long-lived node that
        # never calls drain() doesn't accumulate resolved futures; the
        # reaped tallies feed the next drain() report.
        self._outstanding: list = []
        # Serializes reap-and-tally against drain()'s read-and-reset:
        # _reap pops entries under _lock but tallies them outside it, so
        # without this barrier a background pump() could land a frame's
        # acked counts AFTER drain() zeroed the window — the votes would
        # vanish from every report. Held only across already-completed
        # futures (or drain's own bounded waits), never across sends.
        self._reap_lock = threading.Lock()
        self._acked = 0
        self._rejected = 0
        self._failed_frames = 0
        self._deferred_frames = 0
        # peer -> wall deadline of a server-hinted backoff window
        # (STATUS_RETRY_AFTER): until it passes, hot-path frames to that
        # peer defer straight to anti-entropy instead of re-offering
        # load the peer just said it cannot admit.
        self._retry_after: dict[str, float] = {}
        self._m_rounds = default_registry.counter(
            GOSSIP_ANTI_ENTROPY_ROUNDS_TOTAL
        )
        self._m_sessions = default_registry.counter(
            GOSSIP_ANTI_ENTROPY_SESSIONS_TOTAL
        )
        self._m_escalations = default_registry.counter(
            GOSSIP_CATCHUP_ESCALATIONS_TOTAL
        )
        self._m_deferred = default_registry.counter(
            GOSSIP_FRAMES_DEFERRED_TOTAL
        )
        self._running = True
        self._flusher: threading.Thread | None = None
        if flusher:
            self._flusher = threading.Thread(
                target=self._flush_loop, daemon=True,
                name=f"gossip-flusher-{name}",
            )
            self._flusher.start()

    # ── membership ─────────────────────────────────────────────────────

    @property
    def engine(self):
        return self._engine

    @property
    def transport(self) -> GossipTransport:
        return self._transport

    def add_peer(self, name: str, host: str, port: int, peer_id: int) -> None:
        """Connect to a peer's bridge server (blocking HELLO) and join it
        to the fan-out set. ``peer_id`` is the peer's id ON THAT server
        (from its embedder's ADD_PEER)."""
        self._transport.connect(name, host, port)
        with self._lock:
            self._peers[name] = _PeerInfo(name, host, port, peer_id)
            self._dirty.setdefault(name, set())

    def peers(self) -> list[str]:
        with self._lock:
            return list(self._peers)

    # Bookkeeping cap: a pure fan-out driver (engine=None) never runs
    # anti-entropy, so nothing would ever prune its session/sticky-sample
    # maps — bound them and evict oldest-first (the ScopePlacement memo
    # precedent from the fleet). Engine-backed nodes lose only repair
    # coverage for sessions beyond the cap, which the cap makes explicit
    # instead of OOM-implicit.
    _MAX_TRACKED_SESSIONS = 65536

    def note_session(self, scope: str, pid: int) -> None:
        """Register a session for anti-entropy bookkeeping (call for
        locally created proposals; :meth:`submit_votes` calls it for the
        sessions it touches)."""
        with self._lock:
            pids = self._sessions.setdefault(scope, [])
            if pid not in pids:
                pids.append(pid)
                self._tracked += 1
            while self._tracked > self._MAX_TRACKED_SESSIONS:
                oldest_scope = next(iter(self._sessions))
                for old_pid in self._sessions.pop(oldest_scope):
                    self._session_targets.pop((oldest_scope, old_pid), None)
                    self._tracked -= 1
                for dirty in self._dirty.values():
                    dirty.discard(oldest_scope)

    # ── hot path: sampled fan-out through the coalescer ────────────────

    def submit_votes(
        self,
        scope: str,
        pid: int,
        votes: "list[bytes]",
        now: int,
        *,
        local: bool = True,
    ):
        """Deliver signed votes (wire bytes) for one session: apply to
        the local engine (when present and ``local``), then coalesce
        toward the session's sampled ``fanout`` subset of peers — the
        sample is drawn ONCE per (scope, pid) and reused for every
        subsequent chunk, so a peer either receives a session's votes in
        submission order or misses the session entirely (which
        anti-entropy repairs wholesale; interleaved fragments could
        not be). Returns the local ingest statuses (or None for a pure
        driver). Frames that trip a coalescer size threshold go on the
        wire immediately; call :meth:`pump` (or run the background
        flusher) to close trickle windows on the latency bound."""
        self.note_session(scope, pid)
        statuses = None
        if local and self._engine is not None:
            statuses = self._apply_local(scope, votes, now)
        with self._lock:
            names = self._session_targets.get((scope, pid))
            if names is None:
                names = list(self._peers)
                if self._fanout is not None and self._fanout < len(names):
                    names = self._rng.sample(names, self._fanout)
                self._session_targets[(scope, pid)] = names
        for name in names:
            info = self._peers[name]
            for vote in votes:
                ready = self._coalescer.add(name, info.peer_id, scope, vote, now)
                if ready is not None:
                    self._send_frame(name, *ready)
        return statuses

    def _apply_local(self, scope: str, votes: "list[bytes]", now: int):
        """Apply one session's vote blobs to the local engine. With a
        reactor and a columnar-capable engine, canonical rows enqueue as
        ONE columnar frame-entry into the engine's open window — merging
        with whatever wire frames the window already holds — then flush
        the engine's window and wait (this caller needs its statuses
        synchronously). Any non-canonical row falls the whole call back
        to the object path, preserving exact per-row statuses."""
        engine = self._engine
        reactor = self._reactor
        if (
            reactor is not None
            and votes
            and hasattr(engine, "ingest_wire_columnar")
        ):
            offsets = np.zeros(len(votes) + 1, np.int64)
            np.cumsum([len(v) for v in votes], out=offsets[1:])
            data = np.frombuffer(b"".join(votes), np.uint8)
            cols, flags = WC.parse_vote_columns(data, offsets)
            if flags.all():
                handle = reactor.submit(
                    engine,
                    [scope],
                    np.zeros(len(votes), np.int64),
                    cols,
                    data,
                    offsets,
                    now,
                )
                reactor.flush(engine)
                return np.asarray(handle.wait(30.0), np.int32)
        return engine.ingest_votes(
            [(scope, Vote.decode(v)) for v in votes], now
        )

    def pump(self) -> None:
        """Close coalescer windows past their latency bound and reap
        completed hot-path frames."""
        for name in self._coalescer.due():
            ready = self._coalescer.flush(name)
            if ready is not None:
                self._send_frame(name, *ready)
        self._reap()

    def flush_all(self) -> None:
        with self._lock:
            names = list(self._peers)
        for name in names:
            ready = self._coalescer.flush(name)
            if ready is not None:
                self._send_frame(name, *ready)

    def _defer_frame(self, name: str, meta) -> None:
        """Book one hot-path frame as deferred-to-repair (server-hinted
        overload): counted separately from failures, scopes dirty."""
        self._m_deferred.inc()
        with self._lock:
            self._deferred_frames += 1
            dirty = self._dirty.setdefault(name, set())
            for _, scope, _count in meta:
                dirty.add(scope)

    def _send_frame(self, name: str, payload: bytes, meta) -> None:
        with self._lock:
            until = self._retry_after.get(name)
        if until is not None:
            if time.monotonic() < until:
                # The peer's backoff window is still open: don't re-offer
                # load it just shed — anti-entropy repairs these scopes.
                self._defer_frame(name, meta)
                return
            with self._lock:
                self._retry_after.pop(name, None)
        future = self._transport.try_request(name, P.OP_VOTE_BATCH, payload)
        if future is None:
            # Shed under backpressure: the peer owes these scopes an
            # anti-entropy push; memory stays bounded either way.
            with self._lock:
                dirty = self._dirty.setdefault(name, set())
                for _, scope, _count in meta:
                    dirty.add(scope)
            return
        with self._lock:
            self._outstanding.append((name, meta, future))
            backlog = len(self._outstanding)
        if backlog > 64:  # opportunistic trim on the hot path
            self._reap()

    def _harvest(self, name: str, meta, future, budget: float | None) -> None:
        """Tally one completed (or awaited) frame into the cumulative
        counters; failures mark the frame's scopes dirty for repair."""
        try:
            statuses = parse_status_list(
                future.result(budget if budget is not None else 0)
            )
        except BridgeError as exc:
            if exc.status == P.STATUS_RETRY_AFTER:
                # Typed overload shed: nothing was applied. Honor the
                # server-computed hint (bounded — a garbled payload
                # falls back to a short fixed window) and stop offering
                # this peer hot-path load until it passes.
                try:
                    hint = min(5.0, max(0.0, float(exc.message)))
                except (TypeError, ValueError):
                    hint = 0.05
                with self._lock:
                    self._retry_after[name] = time.monotonic() + hint
                self._defer_frame(name, meta)
                return
            with self._lock:
                self._failed_frames += 1
                dirty = self._dirty.setdefault(name, set())
                for _, scope, _count in meta:
                    dirty.add(scope)
            return
        except (BridgeConnectionLost, TimeoutError, _FutureTimeout, OSError):
            with self._lock:
                self._failed_frames += 1
                dirty = self._dirty.setdefault(name, set())
                for _, scope, _count in meta:
                    dirty.add(scope)
            return
        acked = rejected = 0
        for code in statuses:
            if code in (_OK, int(StatusCode.ALREADY_REACHED)):
                acked += 1
            else:
                rejected += 1
        with self._lock:
            self._acked += acked
            self._rejected += rejected

    def _reap(self) -> None:
        """Harvest every already-completed hot-path frame (non-blocking);
        unresolved futures stay outstanding."""
        with self._reap_lock:
            with self._lock:
                # ONE done() probe per entry: futures resolve on the
                # transport's reader thread, so probing once for a
                # "done" list and again for the remainder would drop
                # any frame that completes between the two passes —
                # harvested by neither, its acks vanish from every
                # report.
                done: list = []
                remaining: list = []
                for entry in self._outstanding:
                    (done if entry[2].done() else remaining).append(entry)
                if not done:
                    return
                self._outstanding = remaining
            for name, meta, future in done:
                self._harvest(name, meta, future, None)

    def drain(self, timeout: float = 30.0) -> dict:
        """Flush everything pending and await every in-flight hot-path
        frame. Returns the delivery counts accumulated since the last
        drain (opportunistic reaps included); failed frames (peer died
        mid-flight) mark their scopes dirty for anti-entropy."""
        self.flush_all()
        deadline = time.monotonic() + timeout
        # _reap_lock: a background pump()'s reap may have popped frames
        # it has not tallied yet — taking the lock here waits for those
        # tallies to land before this window is read and reset, so no
        # frame's counts ever fall between two reports. flush_all stays
        # OUTSIDE the lock (its _send_frame path can reap on backlog).
        with self._reap_lock:
            with self._lock:
                outstanding = self._outstanding
                self._outstanding = []
            for name, meta, future in outstanding:
                self._harvest(name, meta, future,
                              max(0.0, deadline - time.monotonic()))
            shed = sum(
                ch["shed_total"] for ch in self._transport.stats().values()
            )
            with self._lock:
                report = {
                    "acked": self._acked,
                    "rejected": self._rejected,
                    "failed_frames": self._failed_frames,
                    "deferred_frames": self._deferred_frames,
                    "shed_total": shed,
                }
                self._acked = self._rejected = self._failed_frames = 0
                self._deferred_frames = 0
        return report

    # ── repair path: anti-entropy + catch-up escalation ────────────────

    def anti_entropy(
        self,
        now: int,
        *,
        peers: "list[str] | None" = None,
        max_sessions: int = 128,
        window: int = 16,
        timeout: float = 30.0,
    ) -> dict:
        """One push round: deliver full proposals (whole retained vote
        chains) to each target peer — shed-dirty scopes first, then a
        rotating slice of all known sessions up to ``max_sessions`` per
        peer. Frames are windowed (``window`` sessions each) and awaited
        one at a time, so repair traffic can never trip its own
        backpressure shed. Requires a local engine.

        If the local engine is FRESH (no live sessions) and a probed
        peer serves state sync with at least ``escalate_sessions``
        sessions, the round escalates to a full snapshot+tail catch-up
        from that peer before pushing anything."""
        if self._engine is None:
            raise RuntimeError("anti-entropy needs a local engine")
        self._m_rounds.inc()
        report: dict = {
            "pushed_sessions": 0, "created_or_extended": 0,
            "redelivered": 0, "rejected": 0, "failed": 0,
            "escalated": None,
        }
        escalation = self._maybe_escalate(report)
        if escalation is not None:
            return report
        with self._lock:
            targets = [
                self._peers[name]
                for name in (peers if peers is not None else list(self._peers))
                if name in self._peers
            ]
        for info in targets:
            self._push_to_peer(info, now, max_sessions, window, timeout, report)
        flight_recorder.record(
            "gossip.anti_entropy", node=self.name,
            pushed=report["pushed_sessions"],
            redelivered=report["redelivered"], failed=report["failed"],
        )
        return report

    def _session_batch(self, name: str, max_sessions: int) -> list[tuple[str, int]]:
        """(scope, pid) batch for one peer: dirty scopes first, then a
        ROTATING slice of everything else — the per-peer cursor advances
        by what each round takes, so rounds eventually cover every
        session even when one round's budget can't. The engine is the
        source of truth for live sessions — evicted pids drop out of the
        bookkeeping in `_push_to_peer`."""
        with self._lock:
            dirty_scopes = self._dirty.get(name, set())
            out: list[tuple[str, int]] = []
            for scope in dirty_scopes:
                for pid in self._sessions.get(scope, ()):
                    out.append((scope, pid))
                    if len(out) >= max_sessions:
                        return out
            rest = [
                (scope, pid)
                for scope in self._sessions
                if scope not in dirty_scopes
                for pid in self._sessions[scope]
            ]
            room = max_sessions - len(out)
            if room > 0 and rest:
                start = self._rotation.get(name, 0) % len(rest)
                take = min(room, len(rest))
                out.extend(rest[(start + i) % len(rest)] for i in range(take))
                self._rotation[name] = (start + take) % len(rest)
        return out

    def _push_to_peer(
        self, info: _PeerInfo, now: int, max_sessions: int, window: int,
        timeout: float, report: dict,
    ) -> None:
        batch = self._session_batch(info.name, max_sessions)
        pushed_scopes: set[str] = set()
        items: list[tuple[str, bytes]] = []
        frames: list[tuple[list[tuple[str, bytes]], set[str]]] = []
        scopes_in_frame: set[str] = set()
        for scope, pid in batch:
            try:
                proposal = self._engine.get_proposal(scope, pid)
            except ConsensusError:
                with self._lock:  # evicted locally: stop tracking it
                    pids = self._sessions.get(scope)
                    if pids and pid in pids:
                        pids.remove(pid)
                        self._tracked -= 1
                    self._session_targets.pop((scope, pid), None)
                continue
            items.append((scope, proposal.encode()))
            scopes_in_frame.add(scope)
            if len(items) >= window:
                frames.append((items, scopes_in_frame))
                items, scopes_in_frame = [], set()
        if items:
            frames.append((items, scopes_in_frame))
        for frame_items, frame_scopes in frames:
            try:
                future = self._transport.request(
                    info.name,
                    P.OP_DELIVER_PROPOSALS,
                    P.encode_deliver_proposals(info.peer_id, frame_items, now),
                )
                statuses = parse_status_list(future.result(timeout))
            except (ChannelBusy, BridgeError, BridgeConnectionLost,
                    TimeoutError, _FutureTimeout, OSError, KeyError):
                report["failed"] += len(frame_items)
                continue  # scopes stay dirty; next round retries
            report["pushed_sessions"] += len(frame_items)
            self._m_sessions.inc(len(frame_items))
            for code in statuses:
                if code == _OK:
                    report["created_or_extended"] += 1
                elif code == _ALREADY:
                    report["redelivered"] += 1
                else:
                    report["rejected"] += 1
            pushed_scopes |= frame_scopes
        with self._lock:
            self._dirty.setdefault(info.name, set()).difference_update(
                pushed_scopes
            )

    def _maybe_escalate(self, report: dict):
        """Fresh local engine + a peer far ahead = snapshot catch-up, not
        thousands of deliver frames. Probes ONE sampled peer's sync
        manifest (undurable peers reject the probe; that just skips
        escalation this round)."""
        occupancy = getattr(self._engine, "occupancy", None)
        if occupancy is None or occupancy().get("live_sessions", 0):
            return None
        with self._lock:
            infos = list(self._peers.values())
        if not infos:
            return None
        info = self._rng.choice(infos)
        try:
            future = self._transport.request(
                info.name, P.OP_SYNC_MANIFEST,
                P.u32(info.peer_id) + P.u32(0),
            )
            manifest = parse_sync_manifest(future.result(30.0))
        except (ChannelBusy, BridgeError, BridgeConnectionLost,
                TimeoutError, _FutureTimeout, OSError, KeyError, ValueError):
            return None  # undurable / unreachable: incremental repair only
        if manifest["session_count"] < self._escalate_sessions:
            return None
        if self._catchup_factory is not None:
            client_factory = self._catchup_factory
        else:
            from ..sync import CatchUpClient

            client_factory = CatchUpClient
        with client_factory(info.host, info.port, info.peer_id) as client:
            catchup = client.catch_up(self._engine)
        self._m_escalations.inc()
        flight_recorder.record(
            "gossip.escalate", node=self.name, source=info.name,
            sessions=catchup.sessions_installed,
            tail_records=catchup.tail_records, seconds=catchup.seconds,
        )
        # The installed sessions join the anti-entropy bookkeeping so
        # this node can serve repair pushes for them too.
        session_keys = getattr(self._engine, "session_keys", None)
        if session_keys is not None:
            for scope, pid in session_keys():
                self.note_session(scope, pid)
        report["escalated"] = {
            "source": info.name,
            "sessions_installed": catchup.sessions_installed,
            "votes_verified": catchup.votes_verified,
            "tail_records": catchup.tail_records,
            "seconds": catchup.seconds,
        }
        return report["escalated"]

    # ── lifecycle ──────────────────────────────────────────────────────

    def _flush_loop(self) -> None:
        while self._running:
            self.pump()
            time.sleep(self._coalescer.flush_interval / 2)

    def close(self) -> None:
        self._running = False
        if self._flusher is not None:
            self._flusher.join(timeout=5)
        if self._owns_reactor and self._reactor is not None:
            self._reactor.stop()
        if self._owns_transport:
            self._transport.close()
