"""The port's gossip fabric on the CPU: negotiation interop, pipelining,
coalescing, backpressure, anti-entropy, and catch-up escalation, over
``hashgraph_tpu_torch`` servers and engines built with ``device="cpu"``.

A twin of ``tests/test_gossip.py`` (every class, same timeouts) and of
``tests/test_network_gossip.py`` (the four service-level convergence
tests, at the end). Covered:
- old-client<->new-server AND new-client<->old-server HELLO interop;
- concurrent pipelined stress (many in-flight correlation ids,
  out-of-order completion, connection drop failing all pending futures
  with a typed error);
- bounded send queues + shed-to-anti-entropy under a stalled peer;
- cross-peer fingerprint convergence through sampled fan-out + repair;
- far-behind-peer escalation to the state-sync CatchUpClient.
"""

import os
import socket
import struct
import threading
import time

import pytest
import torch

from hashgraph_tpu_torch import build_vote
from hashgraph_tpu_torch.bridge import (
    BridgeClient,
    BridgeConnectionLost,
    BridgeError,
    BridgeServer,
    PipelinedBridgeClient,
)
from hashgraph_tpu_torch.bridge import protocol as P
from hashgraph_tpu_torch.errors import StatusCode
from hashgraph_tpu_torch.gossip import (
    ChannelBusy,
    GossipNode,
    GossipTransport,
    VoteCoalescer,
)
from hashgraph_tpu_torch.signing.stub import StubConsensusSigner
from hashgraph_tpu_torch.sync import state_fingerprint
from hashgraph_tpu_torch.wire import Proposal

NOW = 1_700_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def server():
    with BridgeServer(
        capacity=64, voter_capacity=12, signer_factory=StubConsensusSigner,
        device="cpu",
    ) as srv:
        yield srv


def add_stub_peer(srv):
    with BridgeClient(*srv.address) as cl:
        return cl.add_peer(os.urandom(32))[0]


def make_chain(client, peer, scope, n_votes, expected=None):
    """Create a proposal via the bridge and build a chained stub vote
    list against it; returns (pid, proposal_bytes, votes_wire)."""
    signers = [StubConsensusSigner(os.urandom(20)) for _ in range(n_votes)]
    pid, blob = client.create_proposal(
        peer, scope, NOW, "p", b"", expected or (n_votes + 1), 3_600
    )
    proposal = Proposal.decode(blob)
    votes = []
    for signer in signers:
        vote = build_vote(proposal, True, signer, NOW + 1)
        proposal.votes.append(vote)
        votes.append(vote.encode())
    return pid, blob, votes


# ── Wire codecs ────────────────────────────────────────────────────────


class TestWireCodecs:
    def test_encode_frame_layout_unchanged(self):
        """The struct-compiled encoder emits byte-identical frames to the
        original `u32 length | u8 lead | payload` layout."""
        payload = b"\x01\x02payload"
        frame = P.encode_frame(7, payload)
        assert frame == struct.pack("<I", 1 + len(payload)) + b"\x07" + payload
        assert P.encode_frame(0) == struct.pack("<I", 1) + b"\x00"

    def test_tagged_frame_roundtrip(self):
        frame = P.encode_tagged_frame(9, 0xDEADBEEF, b"xy")
        lead, corr, cursor = P.parse_frame(frame[4:], tagged=True)
        assert (lead, corr) == (9, 0xDEADBEEF)
        assert cursor.raw(2) == b"xy" and cursor.done()

    def test_vote_batch_roundtrip_preserves_group_and_vote_order(self):
        groups = [
            (3, "scope-a", [b"v1", b"longer-vote-2", b""]),
            (1, "scope-b", []),
            (3, "scope-c", [b"v3"]),
        ]
        now, back = P.decode_vote_batch(
            P.Cursor(P.encode_vote_batch(42, groups))
        )
        assert now == 42 and back == groups

    def test_cursor_truncation_still_raises_value_error(self):
        cursor = P.Cursor(b"\x01\x02")
        with pytest.raises(ValueError):
            cursor.u32()
        with pytest.raises(ValueError):
            P.Cursor(b"\x05").string()


# ── HELLO negotiation + interop ────────────────────────────────────────


class _FakeOldServer:
    """A minimal pre-HELLO bridge: answers PING in the old framing and
    UNKNOWN_OPCODE for anything else — the exact behavior of a server
    built before feature negotiation existed."""

    def __init__(self):
        self._listener = socket.create_server(("127.0.0.1", 0))
        self.address = self._listener.getsockname()[:2]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        try:
            conn, _ = self._listener.accept()
        except OSError:
            return
        with conn:
            while True:
                try:
                    opcode, _cursor = P.read_frame(conn)
                except (ConnectionError, OSError, ValueError):
                    return
                if opcode == P.OP_PING:
                    conn.sendall(
                        P.encode_frame(P.STATUS_OK, P.u32(P.PROTOCOL_VERSION))
                    )
                else:
                    conn.sendall(P.encode_frame(P.STATUS_UNKNOWN_OPCODE))

    def close(self):
        try:
            self._listener.close()
        except OSError:
            pass


class TestNegotiation:
    def test_old_client_against_new_server(self, server):
        """A client that never sends HELLO gets exactly the old wire."""
        with BridgeClient(*server.address) as cl:
            peer = cl.add_peer(os.urandom(32))[0]
            pid, _ = cl.create_proposal(peer, "old", NOW, "p", b"", 3, 600)
            assert cl.get_result(peer, "old", pid) is None
            assert cl.poll_events(peer) == []

    def test_serial_hello_negotiates_non_pipelined_features(self, server):
        with BridgeClient(*server.address) as cl:
            granted = cl.hello()
            assert granted == P.SUPPORTED_FEATURES & ~P.FEATURE_PIPELINING
            # the connection stays serial and fully usable
            assert cl.ping() == P.PROTOCOL_VERSION
            with pytest.raises(ValueError):
                cl.hello(P.FEATURE_PIPELINING)

    def test_new_client_against_new_server_pipelines(self, server):
        with PipelinedBridgeClient(*server.address) as pc:
            assert pc.pipelined
            assert pc.features == P.SUPPORTED_FEATURES
            assert pc.ping() == P.PROTOCOL_VERSION

    def test_new_client_against_old_server_falls_back_serial(self):
        fake = _FakeOldServer()
        try:
            with PipelinedBridgeClient(*fake.address) as pc:
                assert not pc.pipelined
                assert pc.features == 0
                # Calls still work, one frame at a time.
                assert pc.ping() == P.PROTOCOL_VERSION
                future = pc.submit(P.OP_PING)
                assert future.done()  # serial fallback resolves inline
        finally:
            fake.close()

    def test_transport_against_old_server_falls_back_fifo(self):
        fake = _FakeOldServer()
        try:
            with GossipTransport() as transport:
                channel = transport.connect("old", *fake.address)
                assert not channel.pipelined
                assert channel.max_inflight == 1
                future = transport.request("old", P.OP_PING)
                assert future.result(5).u32() == P.PROTOCOL_VERSION
        finally:
            fake.close()

    def test_serial_and_pipelined_connections_coexist(self, server):
        """Negotiation is per-connection: an upgraded connection never
        changes what a plain client sees on its own socket."""
        with PipelinedBridgeClient(*server.address) as pc:
            with BridgeClient(*server.address) as cl:
                assert pc.pipelined
                assert cl.ping() == P.PROTOCOL_VERSION
                assert pc.ping() == P.PROTOCOL_VERSION


# ── Pipelined stress ───────────────────────────────────────────────────


class TestPipelinedStress:
    def test_many_inflight_correlation_ids(self, server):
        peer = add_stub_peer(server)
        with PipelinedBridgeClient(*server.address) as pc:
            pid, blob, votes = make_chain(pc, peer, "stress", 8)
            futures = [pc.ping_async() for _ in range(100)]
            vote_futures = [
                pc.process_votes_async(peer, "stress", votes[i : i + 2], NOW + 1)
                for i in range(0, len(votes), 2)
            ]
            more_pings = [pc.ping_async() for _ in range(100)]
            assert all(f.result(10) == P.PROTOCOL_VERSION for f in futures)
            assert all(f.result(10) == P.PROTOCOL_VERSION for f in more_pings)
            statuses = [code for f in vote_futures for code in f.result(10)]
            assert all(
                code in (int(StatusCode.OK), int(StatusCode.ALREADY_REACHED))
                for code in statuses
            )

    def test_out_of_order_completion(self, server):
        """A slow mutating opcode must not block a read-only one: the
        ping submitted AFTER the stalled vote frame completes first, and
        correlation matching still routes both results correctly."""
        peer = add_stub_peer(server)
        engine = server.peer_engine(peer)
        release = threading.Event()
        original = engine.ingest_votes  # OP_PROCESS_VOTES lands here

        def stalled(*args, **kwargs):
            release.wait(timeout=60)
            return original(*args, **kwargs)

        engine.ingest_votes = stalled
        try:
            with PipelinedBridgeClient(*server.address) as pc:
                _pid, _blob, votes = make_chain(pc, peer, "ooo", 2)
                vote_future = pc.process_votes_async(peer, "ooo", votes, NOW + 1)
                ping_future = pc.ping_async()
                assert ping_future.result(30) == P.PROTOCOL_VERSION
                assert not vote_future.done()  # still stalled
                release.set()
                assert len(vote_future.result(30)) == len(votes)
        finally:
            engine.ingest_votes = original
            release.set()

    def test_connection_drop_fails_all_pending_futures(self, server):
        peer = add_stub_peer(server)
        engine = server.peer_engine(peer)
        release = threading.Event()
        original = engine.ingest_votes  # OP_PROCESS_VOTES lands here

        def stalled(*args, **kwargs):
            release.wait(timeout=60)
            return original(*args, **kwargs)

        engine.ingest_votes = stalled
        try:
            pc = PipelinedBridgeClient(*server.address)
            _pid, _blob, votes = make_chain(pc, peer, "drop", 2)
            futures = [
                pc.process_votes_async(peer, "drop", votes, NOW + 1)
                for _ in range(3)
            ]
            pc.close()  # connection dies with the frames in flight
            for future in futures:
                with pytest.raises(BridgeConnectionLost):
                    future.result(10)
        finally:
            engine.ingest_votes = original
            release.set()

    def test_submit_after_close_is_typed(self, server):
        pc = PipelinedBridgeClient(*server.address)
        pc.close()
        with pytest.raises(BridgeConnectionLost):
            pc.ping_async().result(5)


# ── New opcodes ────────────────────────────────────────────────────────


class TestVoteBatchOpcode:
    def test_coalesced_frame_lands_on_all_named_peers(self, server):
        peer_a = add_stub_peer(server)
        peer_b = add_stub_peer(server)
        with PipelinedBridgeClient(*server.address) as pc:
            pid, blob, votes = make_chain(pc, peer_a, "vb", 4)
            pc.process_proposal(peer_b, "vb", blob, NOW)
            statuses = pc.vote_batch_async(
                NOW + 1,
                [(peer_a, "vb", votes[:2]),
                 (peer_b, "vb", votes),
                 (peer_a, "vb", votes[2:])],
            ).result(10)
            assert len(statuses) == 8
            assert all(code == int(StatusCode.OK) for code in statuses)
            assert (
                pc.call(P.OP_STATE_FINGERPRINT, P.u32(peer_a)).string()
                == pc.call(P.OP_STATE_FINGERPRINT, P.u32(peer_b)).string()
            )

    def test_bad_rows_do_not_poison_the_frame(self, server):
        peer = add_stub_peer(server)
        with PipelinedBridgeClient(*server.address) as pc:
            _pid, _blob, votes = make_chain(pc, peer, "vb2", 2)
            statuses = pc.vote_batch_async(
                NOW + 1,
                [(peer, "vb2", [votes[0], b"\xff\xffgarbage"]),
                 (9999, "vb2", [votes[1]])],
            ).result(10)
            assert statuses[0] == int(StatusCode.OK)
            assert statuses[1] == P.STATUS_BAD_REQUEST
            assert statuses[2] == P.STATUS_UNKNOWN_PEER


class TestDeliverOpcode:
    def test_create_extend_redeliver_over_the_wire(self, server):
        source = add_stub_peer(server)
        target = add_stub_peer(server)
        with BridgeClient(*server.address) as cl:
            _pid, blob, votes = make_chain(cl, source, "dl", 4)
            cl.process_votes(source, "dl", votes[:2], NOW + 1)
            grown = cl.get_proposal(source, "dl", Proposal.decode(blob).proposal_id)
            # unknown session -> created whole
            assert cl.deliver_proposals(target, [("dl", grown)], NOW) == [
                int(StatusCode.OK)
            ]
            # identical chain -> crypto-free settle
            assert cl.deliver_proposals(target, [("dl", grown)], NOW) == [
                int(StatusCode.PROPOSAL_ALREADY_EXIST)
            ]
            # extension -> suffix applied
            cl.process_votes(source, "dl", votes[2:], NOW + 1)
            pid = Proposal.decode(blob).proposal_id
            extended = cl.get_proposal(source, "dl", pid)
            assert cl.deliver_proposals(target, [("dl", extended)], NOW + 1) == [
                int(StatusCode.OK)
            ]
            assert cl.state_fingerprint(source) == cl.state_fingerprint(target)

    def test_undecodable_item_marks_only_its_row(self, server):
        target = add_stub_peer(server)
        with BridgeClient(*server.address) as cl:
            source = add_stub_peer(server)
            _pid, blob, _votes = make_chain(cl, source, "dlx", 2)
            statuses = cl.deliver_proposals(
                target, [("dlx", b"\x00garbage"), ("dlx", blob)], NOW
            )
            assert statuses == [P.STATUS_BAD_REQUEST, int(StatusCode.OK)]


class TestPollEventsBound:
    def test_bound_and_more_flag(self, server):
        with BridgeClient(*server.address) as cl:
            peers = [cl.add_peer(os.urandom(32))[0] for _ in range(3)]
            for scope in ("e1", "e2"):
                pid, _ = cl.create_proposal(peers[0], scope, NOW, "p", b"", 3, 600)
                cl.cast_vote(peers[0], scope, pid, True, NOW + 1)
                proposal = cl.get_proposal(peers[0], scope, pid)
                for peer in peers[1:]:
                    cl.process_proposal(peer, scope, proposal, NOW + 2)
                for i, voter in enumerate(peers[1:], start=1):
                    vote = cl.cast_vote(voter, scope, pid, True, NOW + 2 + i)
                    for other in peers:
                        if other != voter:
                            cl.process_vote(other, scope, vote, NOW + 3 + i)
            first, more = cl.poll_events(peers[0], max_events=1)
            assert len(first) == 1 and more is True
            rest, more = cl.poll_events(peers[0], max_events=100)
            assert len(rest) >= 1 and more is False
            # unbounded request on the same server: old wire shape
            assert cl.poll_events(peers[0]) == []


# ── Coalescer ──────────────────────────────────────────────────────────


class TestVoteCoalescer:
    def test_flush_votes_threshold_seals_the_window(self):
        coalescer = VoteCoalescer(flush_votes=3, flush_interval=999)
        assert coalescer.add("p", 1, "s", b"v1", NOW) is None
        assert coalescer.add("p", 1, "t", b"v2", NOW + 5) is None
        ready = coalescer.add("p", 1, "s", b"v3", NOW)
        assert ready is not None
        payload, meta = ready
        assert meta == [(1, "s", 2), (1, "t", 1)]
        # The payload is a SEGMENT LIST (send-side zero-copy): the tail
        # segments ARE the caller's vote bytes objects, un-copied, and
        # the joined stream is the canonical encode_vote_batch form.
        assert isinstance(payload, list)
        assert payload[1:] == [b"v1", b"v3", b"v2"]
        now, groups = P.decode_vote_batch(P.Cursor(b"".join(payload)))
        assert now == NOW + 5  # the frame carries the window's max now
        assert groups == [(1, "s", [b"v1", b"v3"]), (1, "t", [b"v2"])]
        assert coalescer.pending("p") == 0

    def test_flush_bytes_threshold(self):
        coalescer = VoteCoalescer(flush_votes=10_000, flush_bytes=8)
        assert coalescer.add("p", 1, "s", b"aaaa", NOW) is None
        assert coalescer.add("p", 1, "s", b"bbbb", NOW) is not None

    def test_interval_due_and_manual_flush(self):
        clock = [0.0]
        coalescer = VoteCoalescer(
            flush_votes=100, flush_interval=0.5, clock=lambda: clock[0]
        )
        coalescer.add("p", 1, "s", b"v", NOW)
        assert coalescer.due() == []
        clock[0] = 1.0
        assert coalescer.due() == ["p"]
        payload, meta = coalescer.flush("p")
        assert meta == [(1, "s", 1)]
        assert coalescer.flush("p") is None

    def test_windows_are_per_peer(self):
        coalescer = VoteCoalescer(flush_votes=2)
        assert coalescer.add("a", 1, "s", b"v", NOW) is None
        assert coalescer.add("b", 2, "s", b"v", NOW) is None
        assert coalescer.add("a", 1, "s", b"v", NOW) is not None
        assert coalescer.pending("b") == 1


# ── Backpressure ───────────────────────────────────────────────────────


class _StalledPeer:
    """Accepts one connection, grants HELLO, then never reads again —
    the pathological slow peer the bounded queues must survive."""

    def __init__(self):
        self._listener = socket.create_server(("127.0.0.1", 0))
        self.address = self._listener.getsockname()[:2]
        self.conn = None
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        try:
            conn, _ = self._listener.accept()
        except OSError:
            return
        self.conn = conn
        try:
            opcode, _cursor = P.read_frame(conn)
            assert opcode == P.OP_HELLO
            conn.sendall(P.encode_frame(
                P.STATUS_OK,
                P.u32(P.PROTOCOL_VERSION) + P.u32(P.SUPPORTED_FEATURES),
            ))
        except (ConnectionError, OSError, ValueError):
            return
        # ... and never reads again.

    def close(self):
        try:
            self._listener.close()
        except OSError:
            pass
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass


class TestBackpressure:
    def test_stalled_peer_sheds_at_the_byte_cap(self):
        stalled = _StalledPeer()
        transport = GossipTransport(
            max_inflight=2, max_queue_bytes=16 * 1024, sndbuf=4096
        )
        try:
            channel = transport.connect("slow", *stalled.address)
            payload = b"x" * 2048
            sheds = 0
            futures = []
            for _ in range(64):
                future = transport.try_request("slow", P.OP_PING, payload)
                if future is None:
                    sheds += 1
                else:
                    futures.append(future)
            assert sheds > 0, "queue never shed under a stalled peer"
            stats = channel.stats()
            assert stats["queue_bytes"] <= 16 * 1024
            assert stats["shed_total"] == sheds
            # The stalled peer dying fails every queued/in-flight future
            # with the typed signal instead of hanging.
            stalled.close()
            for future in futures:
                with pytest.raises((BridgeConnectionLost, BridgeError)):
                    future.result(10)
        finally:
            transport.close()
            stalled.close()

    def test_request_raises_channel_busy_instead_of_shedding(self):
        stalled = _StalledPeer()
        transport = GossipTransport(
            max_inflight=1, max_queue_bytes=4096, sndbuf=4096
        )
        try:
            transport.connect("slow", *stalled.address)
            with pytest.raises(ChannelBusy):
                for _ in range(64):
                    transport.request("slow", P.OP_PING, b"y" * 1024)
        finally:
            transport.close()
            stalled.close()

    def test_frame_bigger_than_byte_cap_sends_when_queue_empty(self, server):
        """The byte cap bounds QUEUED frames; a single frame larger than
        the cap itself is admitted whenever the queue is empty —
        otherwise it could never be sent at all (shed-retry forever)."""
        transport = GossipTransport(max_queue_bytes=1024)
        try:
            transport.connect("p", *server.address)
            future = transport.try_request("p", P.OP_PING, b"z" * 8192)
            assert future is not None, "oversize frame was shed"
            assert future.result(10).u32() == P.PROTOCOL_VERSION
        finally:
            transport.close()

    def test_segment_count_past_iov_max_still_sends(self, server):
        """sendmsg takes at most IOV_MAX iovecs per call; a frame built
        from more segments than that must be written in capped passes,
        not fail the channel with EINVAL."""
        transport = GossipTransport()
        try:
            transport.connect("p", *server.address)
            segments = [b"ab"] * 3000  # > IOV_MAX (1024 on Linux)
            future = transport.try_request("p", P.OP_PING, segments)
            assert future is not None
            assert future.result(10).u32() == P.PROTOCOL_VERSION
        finally:
            transport.close()


# ── GossipNode: fan-out, repair, escalation ────────────────────────────


class TestGossipNode:
    def _mesh(self, n):
        servers, clients, peers = [], [], []
        for _ in range(n):
            srv = BridgeServer(
                capacity=64, voter_capacity=12,
                signer_factory=StubConsensusSigner,
                device="cpu",
            )
            srv.start()
            cl = BridgeClient(*srv.address)
            peers.append(cl.add_peer(os.urandom(32))[0])
            servers.append(srv)
            clients.append(cl)
        return servers, clients, peers

    def _teardown(self, servers, clients):
        for cl in clients:
            cl.close()
        for srv in servers:
            srv.stop()

    def test_reap_single_done_probe_never_drops_a_frame(self):
        """Regression: _reap used to probe ``future.done()`` twice (one
        comprehension for the harvested list, one for the remainder). A
        future resolving on the transport reader thread BETWEEN the two
        probes landed in neither list — the frame vanished unharvested
        and its acks fell out of every drain report. A future whose
        done() flips mid-reap must still be tallied exactly once."""
        from concurrent.futures import Future

        class _FlipFuture(Future):
            """done() lies False on the first probe, True after — the
            narrowest emulation of a frame completing mid-reap."""

            def __init__(self, payload):
                super().__init__()
                self.set_result(payload)
                self._probes = 0

            def done(self):
                self._probes += 1
                return self._probes > 1

        node = GossipNode("driver")
        try:
            response = P.Cursor(
                P.u32(3)
                + bytes([0, 0, int(StatusCode.ALREADY_REACHED)])
            )
            meta = [(1, "scope", 3)]
            node._outstanding.append(
                ("peerX", meta, _FlipFuture(response))
            )
            node._reap()  # the buggy version dropped the entry here
            report = node.drain()
            assert report["acked"] == 3, report
            assert report["failed_frames"] == 0
        finally:
            node.close()

    def test_fanout_delivers_to_every_peer(self):
        servers, clients, peers = self._mesh(2)
        node = GossipNode("driver", fanout=None)
        try:
            for i, srv in enumerate(servers):
                node.add_peer(f"peer{i}", *srv.address, peers[i])
            _pid, blob, votes = make_chain(clients[0], peers[0], "fan", 6)
            clients[1].process_proposal(peers[1], "fan", blob, NOW)
            pid = Proposal.decode(blob).proposal_id
            node.submit_votes("fan", pid, votes, NOW + 1, local=False)
            report = node.drain()
            assert report["acked"] == 12 and report["shed_total"] == 0
            assert (
                clients[0].state_fingerprint(peers[0])
                == clients[1].state_fingerprint(peers[1])
            )
        finally:
            node.close()
            self._teardown(servers, clients)

    def test_sampled_fanout_plus_anti_entropy_converges(self):
        servers, clients, peers = self._mesh(3)
        node = GossipNode(
            "n0", engine=servers[0].peer_engine(peers[0]), fanout=1, seed=7
        )
        try:
            for i in (1, 2):
                node.add_peer(f"peer{i}", *servers[i].address, peers[i])
            _pid, blob, votes = make_chain(clients[0], peers[0], "ae", 6)
            for i in (1, 2):
                clients[i].process_proposal(peers[i], "ae", blob, NOW)
            pid = Proposal.decode(blob).proposal_id
            node.submit_votes("ae", pid, votes, NOW + 1, local=True)
            node.drain()
            report = node.anti_entropy(NOW + 1)
            assert report["pushed_sessions"] >= 1
            fingerprints = {
                cl.state_fingerprint(peer)
                for cl, peer in zip(clients, peers)
            }
            assert len(fingerprints) == 1
            # A second round settles crypto-free as pure redelivery.
            second = node.anti_entropy(NOW + 1)
            assert second["redelivered"] == second["pushed_sessions"]
        finally:
            node.close()
            self._teardown(servers, clients)

    def test_stalled_peer_sheds_then_recovers_via_anti_entropy(self):
        servers, clients, peers = self._mesh(2)
        release = threading.Event()
        engine1 = servers[1].peer_engine(peers[1])
        original = engine1.ingest_votes_pipelined

        def stalled(*args, **kwargs):
            release.wait(timeout=30)
            return original(*args, **kwargs)

        engine1.ingest_votes_pipelined = stalled
        transport = GossipTransport(
            max_inflight=1, max_queue_bytes=2048, sndbuf=4096
        )
        node = GossipNode(
            "n0", engine=servers[0].peer_engine(peers[0]),
            transport=transport, fanout=None, flush_votes=4,
        )
        try:
            node.add_peer("peer1", *servers[1].address, peers[1])
            _pid, blob, votes = make_chain(clients[0], peers[0], "bp", 10)
            clients[1].process_proposal(peers[1], "bp", blob, NOW)
            pid = Proposal.decode(blob).proposal_id
            # Flood while the peer is stalled: the bounded queue sheds.
            node.submit_votes("bp", pid, votes, NOW + 1, local=True)
            node.flush_all()
            channel = transport.channel("peer1")
            assert channel.stats()["queue_bytes"] <= 2048
            release.set()
            report = node.drain()
            if report["shed_total"]:
                # Shed scopes are owed an anti-entropy push; the repair
                # round brings the stalled peer back to identical state.
                repair = node.anti_entropy(NOW + 1)
                assert repair["pushed_sessions"] >= 1
            assert (
                clients[0].state_fingerprint(peers[0])
                == clients[1].state_fingerprint(peers[1])
            )
        finally:
            engine1.ingest_votes_pipelined = original
            release.set()
            node.close()
            transport.close()
            self._teardown(servers, clients)

    def test_fresh_node_escalates_to_catch_up(self, tmp_path):
        """A far-behind (fresh) node with a durable peer far ahead pulls
        a snapshot+tail catch-up instead of absorbing deliver frames."""
        from hashgraph_tpu_torch.engine import TorchConsensusEngine

        server = BridgeServer(
            capacity=64, voter_capacity=12,
            signer_factory=StubConsensusSigner,
            wal_dir=str(tmp_path / "wal"), wal_fsync="off",
            device="cpu",
        )
        server.start()
        client = BridgeClient(*server.address)
        try:
            peer = client.add_peer(os.urandom(32))[0]
            for i in range(3):
                _pid, _blob, votes = make_chain(
                    client, peer, f"hist-{i}", 4
                )
                client.process_votes(peer, f"hist-{i}", votes, NOW + 1)
            joiner = TorchConsensusEngine(
                StubConsensusSigner(b"joiner" + b"\x00" * 14),
                capacity=64, voter_capacity=12,
                device="cpu",
            )
            node = GossipNode(
                "joiner", engine=joiner, escalate_sessions=2, seed=3
            )
            try:
                node.add_peer("source", *server.address, peer)
                report = node.anti_entropy(NOW + 1)
                assert report["escalated"] is not None
                assert report["escalated"]["sessions_installed"] == 3
                assert state_fingerprint(joiner) == client.state_fingerprint(
                    peer
                )
                # The installed sessions joined the bookkeeping: the next
                # round can PUSH them (the source settles redeliveries).
                second = node.anti_entropy(NOW + 1)
                assert second["escalated"] is None
                assert second["pushed_sessions"] == 3
                assert second["redelivered"] == 3
            finally:
                node.close()
        finally:
            client.close()
            server.stop()

    def test_fanout_sample_is_sticky_per_session(self):
        """Chunks of one session must all go to the SAME sampled subset:
        interleaved fragments across different subsets would not be
        positional prefixes of the pusher's chain, so anti-entropy could
        never repair them to byte-identical state. Per-vote submits with
        fanout=1 + one repair round must still converge all peers."""
        servers, clients, peers = self._mesh(3)
        node = GossipNode(
            "sticky", engine=servers[0].peer_engine(peers[0]),
            fanout=1, seed=11, flush_votes=2,
        )
        try:
            for i in (1, 2):
                node.add_peer(f"peer{i}", *servers[i].address, peers[i])
            _pid, blob, votes = make_chain(clients[0], peers[0], "st", 6)
            for i in (1, 2):
                clients[i].process_proposal(peers[i], "st", blob, NOW)
            pid = Proposal.decode(blob).proposal_id
            for vote in votes:  # one submit per vote: worst-case chunking
                node.submit_votes("st", pid, [vote], NOW + 1)
            node.drain()
            assert len(node._session_targets[("st", pid)]) == 1  # one subset
            node.anti_entropy(NOW + 1)
            fingerprints = {
                cl.state_fingerprint(peer)
                for cl, peer in zip(clients, peers)
            }
            assert len(fingerprints) == 1
        finally:
            node.close()
            self._teardown(servers, clients)

    def test_session_bookkeeping_is_bounded(self, monkeypatch):
        """A pure driver never anti-entropy-prunes, so the session /
        sticky-sample maps must evict oldest-first at the cap instead of
        growing with every session ever submitted."""
        node = GossipNode("bounded")
        monkeypatch.setattr(node, "_MAX_TRACKED_SESSIONS", 8)
        try:
            for i in range(20):
                node.note_session(f"s{i}", i)
            assert node._tracked <= 8
            assert len(node._sessions) <= 8
            assert "s0" not in node._sessions  # oldest evicted
            assert "s19" in node._sessions  # newest kept
        finally:
            node.close()

    def test_session_rotation_covers_everything_across_rounds(self):
        """max_sessions smaller than the session count must not starve
        the tail: the per-peer cursor rotates, so successive rounds
        cover every session."""
        node = GossipNode("rot")
        try:
            for i in range(5):
                node.note_session(f"s{i}", 100 + i)
            seen = set()
            for _ in range(3):
                batch = node._session_batch("peer", max_sessions=2)
                assert len(batch) == 2
                seen.update(batch)
            assert seen == {(f"s{i}", 100 + i) for i in range(5)}
        finally:
            node.close()

    def test_outstanding_frames_are_reaped_without_drain(self):
        """A long-lived node that only pumps must not accumulate
        resolved futures; the tallies still reach the next drain()."""
        servers, clients, peers = self._mesh(1)
        node = GossipNode("reaper", fanout=None, flush_votes=2)
        try:
            node.add_peer("peer0", *servers[0].address, peers[0])
            _pid, blob, votes = make_chain(clients[0], peers[0], "reap", 10)
            pid = Proposal.decode(blob).proposal_id
            for vote in votes:
                node.submit_votes("reap", pid, [vote], NOW + 1, local=False)
            deadline = time.monotonic() + 10
            while node._outstanding and time.monotonic() < deadline:
                node.pump()
                time.sleep(0.02)
            assert not node._outstanding  # reaped, not hoarded
            report = node.drain()
            assert report["acked"] == 10  # reaped tallies not lost
        finally:
            node.close()
            self._teardown(servers, clients)

    def test_undurable_peer_skips_escalation(self):
        servers, clients, peers = self._mesh(1)
        from hashgraph_tpu_torch.engine import TorchConsensusEngine

        joiner = TorchConsensusEngine(
            StubConsensusSigner(b"j" * 20), capacity=16, voter_capacity=8,
            device="cpu",
        )
        node = GossipNode("joiner", engine=joiner, escalate_sessions=1)
        try:
            node.add_peer("source", *servers[0].address, peers[0])
            report = node.anti_entropy(NOW)
            assert report["escalated"] is None  # probe rejected, no crash
        finally:
            node.close()
            self._teardown(servers, clients)


class TestReconnectPolicy:
    """Opt-in bounded jittered auto-reconnect: a dropped
    channel heals — fresh socket, fresh HELLO — while in-flight requests
    still fail typed. Without the policy, dead channels stay dead (the
    pre-existing contract, unchanged)."""

    def test_policy_delay_is_bounded_and_jittered(self):
        from hashgraph_tpu_torch.bridge.client import ReconnectPolicy

        policy = ReconnectPolicy(
            max_attempts=5, base_delay=0.1, max_delay=0.4, jitter=0.5
        )
        for attempt in range(10):
            d = policy.delay(attempt)
            assert 0 <= d <= 0.4
        with pytest.raises(ValueError):
            ReconnectPolicy(max_attempts=0)
        with pytest.raises(ValueError):
            ReconnectPolicy(jitter=1.5)

    def test_gossip_transport_reconnects_after_server_restart(self):
        from hashgraph_tpu_torch.bridge.client import ReconnectPolicy
        from hashgraph_tpu_torch.gossip.transport import GossipTransport

        first = BridgeServer(capacity=8, voter_capacity=4, device="cpu")
        host, port = first.start()
        transport = GossipTransport(
            reconnect=ReconnectPolicy(
                max_attempts=40, base_delay=0.02, max_delay=0.05
            )
        )
        try:
            transport.connect("peer", host, port)
            assert transport.request("peer", P.OP_PING).result(5)
            first.stop()
            # The restarted server binds the SAME port (the crash-restart
            # shape); the transport's backoff loop re-dials + re-HELLOs.
            with BridgeServer(capacity=8, voter_capacity=4, port=port, device="cpu"):
                deadline = time.monotonic() + 10
                healed = False
                while time.monotonic() < deadline:
                    channel = transport.channel("peer")
                    if channel is not None and channel.alive:
                        try:
                            transport.request("peer", P.OP_PING).result(5)
                            healed = True
                            break
                        except (BridgeError, ConnectionError, TimeoutError):
                            pass
                    time.sleep(0.02)
                assert healed, "channel did not heal after restart"
        finally:
            transport.close()
            first.stop()

    def test_pipelined_client_reconnects_after_server_restart(self):
        from hashgraph_tpu_torch.bridge.client import (
            PipelinedBridgeClient,
            ReconnectPolicy,
        )

        first = BridgeServer(capacity=8, voter_capacity=4, device="cpu")
        host, port = first.start()
        client = PipelinedBridgeClient(
            host, port,
            reconnect=ReconnectPolicy(
                max_attempts=40, base_delay=0.02, max_delay=0.05
            ),
        )
        try:
            assert client.pipelined
            assert client.ping() == P.PROTOCOL_VERSION
            first.stop()
            with BridgeServer(capacity=8, voter_capacity=4, port=port, device="cpu"):
                deadline = time.monotonic() + 10
                healed = False
                while time.monotonic() < deadline:
                    try:
                        if client.ping() == P.PROTOCOL_VERSION:
                            healed = True
                            break
                    except (ConnectionError, BridgeError, TimeoutError):
                        pass
                    time.sleep(0.02)
                assert healed, "client did not heal after restart"
        finally:
            client.close()
            first.stop()

    def test_without_policy_channel_stays_dead(self):
        from hashgraph_tpu_torch.gossip.transport import GossipTransport

        server = BridgeServer(capacity=8, voter_capacity=4, device="cpu")
        host, port = server.start()
        transport = GossipTransport()  # no reconnect: the old contract
        try:
            transport.connect("peer", host, port)
            transport.request("peer", P.OP_PING).result(5)
            server.stop()
            deadline = time.monotonic() + 2
            while time.monotonic() < deadline:
                channel = transport.channel("peer")
                if channel is not None and not channel.alive:
                    break
                try:
                    transport.request("peer", P.OP_PING).result(0.2)
                except Exception:
                    pass
                time.sleep(0.02)
            channel = transport.channel("peer")
            assert channel is not None and not channel.alive
            time.sleep(0.3)  # a reconnector would have re-dialed by now
            assert not transport.channel("peer").alive
        finally:
            transport.close()


# ── Simulated multi-peer convergence over the port's service ──────────
# Twin of tests/test_network_gossip.py (reference:
# tests/network_gossip_tests.rs): independent services per peer,
# messages hand-ferried as wire bytes.

NET_SCOPE = "gossip_scope"


def make_service():
    """A fresh peer: in-memory storage, broadcast bus, random stub key."""
    from hashgraph_tpu_torch import (
        BroadcastEventBus,
        ConsensusService,
        InMemoryConsensusStorage,
    )

    return ConsensusService(
        InMemoryConsensusStorage(),
        BroadcastEventBus(),
        StubConsensusSigner(os.urandom(20)),
        10,
    )


def sibling_service(service):
    """Another peer's view: same storage + bus, its own signer."""
    from hashgraph_tpu_torch import ConsensusService

    return ConsensusService(
        service.storage(),
        service.event_bus(),
        StubConsensusSigner(os.urandom(20)),
    )


def create_on(service, n, liveness=True):
    from hashgraph_tpu_torch import ConsensusConfig, CreateProposalRequest

    request = CreateProposalRequest(
        name="Gossip",
        payload=b"",
        proposal_owner=service.signer().identity(),
        expected_voters_count=n,
        expiration_timestamp=120,
        liveness_criteria_yes=liveness,
    )
    return service.create_proposal_with_config(
        NET_SCOPE, request, ConsensusConfig.gossipsub(), NOW
    )


def ferry_proposal(src_proposal, dst_service):
    """Serialize and deliver a proposal as the network would."""
    dst_service.process_incoming_proposal(
        NET_SCOPE, Proposal.decode(src_proposal.encode()), NOW
    )


def ferry_vote(vote, dst_service):
    from hashgraph_tpu_torch import Vote

    dst_service.process_incoming_vote(
        NET_SCOPE, Vote.decode(vote.encode()), NOW
    )


def test_two_peer_unanimous_yes():
    """reference: tests/network_gossip_tests.rs:21-76"""
    alice = make_service()
    bob = make_service()  # separate storage: a genuinely remote peer

    proposal = create_on(alice, 2)
    vote_a = alice.cast_vote(NET_SCOPE, proposal.proposal_id, True, NOW)

    # Bob receives the updated proposal (with Alice's vote embedded).
    ferry_proposal(
        alice.storage().get_proposal(NET_SCOPE, proposal.proposal_id), bob
    )
    vote_b = bob.cast_vote(NET_SCOPE, proposal.proposal_id, True, NOW)

    # Alice receives Bob's vote.
    ferry_vote(vote_b, alice)

    pid = proposal.proposal_id
    assert alice.storage().get_consensus_result(NET_SCOPE, pid) is True
    assert bob.storage().get_consensus_result(NET_SCOPE, pid) is True
    assert vote_a.vote_owner != vote_b.vote_owner


def test_three_peer_out_of_order_delivery():
    """reference: tests/network_gossip_tests.rs:81-152 — votes arrive in
    different orders at different peers, all converge."""
    alice, bob, carol = make_service(), make_service(), make_service()

    proposal = create_on(alice, 3)
    raw = alice.storage().get_proposal(NET_SCOPE, proposal.proposal_id)
    ferry_proposal(raw, bob)
    ferry_proposal(raw, carol)

    vote_a = alice.cast_vote(NET_SCOPE, proposal.proposal_id, True, NOW)
    vote_b = bob.cast_vote(NET_SCOPE, proposal.proposal_id, True, NOW)

    # Carol gets B then A; Alice gets B; Bob gets A.
    ferry_vote(vote_b, carol)
    ferry_vote(vote_a, carol)
    ferry_vote(vote_b, alice)
    ferry_vote(vote_a, bob)

    for peer in (alice, bob, carol):
        assert peer.storage().get_consensus_result(
            NET_SCOPE, proposal.proposal_id
        ) is True


def test_multi_peer_timeout_converges_to_failed():
    """reference: tests/network_gossip_tests.rs:159-254 — insufficient
    votes + liveness=False tie -> every peer's timeout lands on Failed."""
    from hashgraph_tpu_torch.errors import (
        DuplicateVote,
        InsufficientVotesAtTimeout,
    )

    peers = [make_service() for _ in range(3)]
    proposal = create_on(peers[0], 4, liveness=False)
    raw = peers[0].storage().get_proposal(NET_SCOPE, proposal.proposal_id)
    for p in peers[1:]:
        ferry_proposal(raw, p)

    # Two YES votes gossiped everywhere; 2 silent-as-NO -> weighted tie.
    v0 = peers[0].cast_vote(NET_SCOPE, proposal.proposal_id, True, NOW)
    v1 = peers[1].cast_vote(NET_SCOPE, proposal.proposal_id, True, NOW)
    for vote in (v0, v1):
        for p in peers:
            try:
                ferry_vote(vote, p)
            except DuplicateVote:
                pass  # the casting peer already holds its own vote

    for p in peers:
        with pytest.raises(InsufficientVotesAtTimeout):
            p.handle_consensus_timeout(
                NET_SCOPE, proposal.proposal_id, NOW + 60
            )


def test_tie_resolved_yes_by_liveness_everywhere():
    """reference: tests/network_gossip_tests.rs:259-377"""
    shared = make_service()
    peers = [shared] + [sibling_service(shared) for _ in range(3)]

    proposal = create_on(peers[0], 4, liveness=True)
    for i, choice in enumerate([True, True, False, False]):
        peers[i].cast_vote(NET_SCOPE, proposal.proposal_id, choice, NOW)

    # 2-2 with everyone voted: tie broken YES by liveness.
    assert shared.storage().get_consensus_result(
        NET_SCOPE, proposal.proposal_id
    ) is True
