"""The port's embedder bridge: the README 3-voter quick-start from outside
Python, served by ``hashgraph_tpu_torch.bridge.BridgeServer`` on the CPU.

A twin of ``tests/test_bridge.py`` over the port's server and client.
Covered here:

- the full quick-start through the Python reference client,
- the same scenario through the compiled C client (native/bridge_client.c),
  proving a non-Python process can create proposals, vote, ferry wire bytes
  and receive events,
- error-path parity: wire statuses mirror StatusCode, bridge-level statuses
  cover unknown peers/opcodes, tampered votes are rejected with the same
  error the in-process engine raises.
"""

import shutil
import socket
import struct
import subprocess

import pytest

import torch

from hashgraph_tpu_torch.bridge import BridgeClient, BridgeError, BridgeServer
from hashgraph_tpu_torch.bridge import protocol as P
from hashgraph_tpu_torch.errors import ConsensusFailed, StatusCode
from hashgraph_tpu_torch.wire import Vote

NOW = 1_700_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def server():
    with BridgeServer(capacity=64, voter_capacity=8, device="cpu") as srv:
        yield srv


@pytest.fixture()
def client(server):
    with BridgeClient(*server.address) as cl:
        yield cl


def run_quickstart(cl: BridgeClient, scope: str):
    """3 voters, gossipsub defaults, unanimous YES; returns (peers, pid)."""
    peers = [cl.add_peer()[0] for _ in range(3)]
    pid, _ = cl.create_proposal(peers[0], scope, NOW, "upgrade", b"ship", 3, 600)
    cl.cast_vote(peers[0], scope, pid, True, NOW + 1)
    proposal = cl.get_proposal(peers[0], scope, pid)
    for peer in peers[1:]:
        cl.process_proposal(peer, scope, proposal, NOW + 2)
    for i, voter in enumerate(peers[1:], start=1):
        vote = cl.cast_vote(voter, scope, pid, True, NOW + 2 + i)
        for other in peers:
            if other != voter:
                cl.process_vote(other, scope, vote, NOW + 3 + i)
    return peers, pid


class TestPythonClient:
    def test_quickstart_reaches_consensus_on_all_peers(self, client):
        peers, pid = run_quickstart(client, "qs")
        for peer in peers:
            assert client.get_result(peer, "qs", pid) is True
            events = client.poll_events(peer)
            assert any(
                e.kind == P.EVENT_REACHED and e.proposal_id == pid and e.result
                for e in events
            )

    def test_stats_and_identities(self, client):
        peer, identity = client.add_peer()
        assert len(identity) == 20  # Ethereum address
        pid, _ = client.create_proposal(peer, "st", NOW, "p", b"", 3, 600)
        assert client.get_stats(peer, "st") == (1, 1, 0, 0)
        assert client.get_result(peer, "st", pid) is None

    def test_explicit_key_yields_deterministic_identity(self, client):
        key = (7).to_bytes(32, "big")
        _, identity = client.add_peer(key)
        from hashgraph_tpu_torch.signing.ethereum import EthereumConsensusSigner

        assert identity == EthereumConsensusSigner(key).identity()

    def test_duplicate_vote_maps_to_wire_status(self, client):
        peer, _ = client.add_peer()
        pid, _ = client.create_proposal(peer, "dup", NOW, "p", b"", 3, 600)
        client.cast_vote(peer, "dup", pid, True, NOW + 1)
        with pytest.raises(BridgeError) as exc:
            client.cast_vote(peer, "dup", pid, True, NOW + 2)
        assert exc.value.status == int(StatusCode.USER_ALREADY_VOTED)

    def test_timeout_without_quorum_fails_session(self, client):
        # n=2 runs the unanimity rule (reference: src/utils.rs:239-244):
        # zero votes at timeout is undecidable regardless of liveness, so the
        # session fails and the wire carries INSUFFICIENT_VOTES_AT_TIMEOUT.
        peer, _ = client.add_peer()
        pid, _ = client.create_proposal(peer, "to", NOW, "p", b"", 2, 600)
        with pytest.raises(BridgeError) as exc:
            client.handle_timeout(peer, "to", pid, NOW + 700)
        assert exc.value.status == int(StatusCode.INSUFFICIENT_VOTES_AT_TIMEOUT)
        with pytest.raises(ConsensusFailed):
            client.get_result(peer, "to", pid)
        events = client.poll_events(peer)
        assert any(e.kind == P.EVENT_FAILED and e.proposal_id == pid for e in events)

    def test_tampered_vote_rejected_like_in_process(self, client):
        alice, _ = client.add_peer()
        bob, _ = client.add_peer()
        pid, _ = client.create_proposal(alice, "tam", NOW, "p", b"", 3, 600)
        proposal = client.get_proposal(alice, "tam", pid)
        client.process_proposal(bob, "tam", proposal, NOW + 1)
        vote_bytes = client.cast_vote(bob, "tam", pid, False, NOW + 2)
        vote = Vote.decode(vote_bytes)
        vote.vote = True  # flip the choice without re-signing
        with pytest.raises(BridgeError) as exc:
            client.process_vote(alice, "tam", vote.encode(), NOW + 3)
        assert exc.value.status == int(StatusCode.INVALID_VOTE_HASH)

    def test_tampered_vote_error_equals_the_in_process_engine(self, client):
        """The wire status of every tampering equals the code the port's
        engine raises in process on the same bytes."""
        from hashgraph_tpu_torch.engine import TorchConsensusEngine
        from hashgraph_tpu_torch.errors import ConsensusError
        from hashgraph_tpu_torch.signing.ethereum import EthereumConsensusSigner
        from hashgraph_tpu_torch.wire import Proposal

        alice, _ = client.add_peer()
        bob, _ = client.add_peer()
        pid, _ = client.create_proposal(alice, "tam2", NOW, "p", b"", 3, 600)
        proposal = client.get_proposal(alice, "tam2", pid)
        client.process_proposal(bob, "tam2", proposal, NOW + 1)
        good = Vote.decode(client.cast_vote(bob, "tam2", pid, False, NOW + 2))
        flipped = Vote.decode(good.encode())
        flipped.vote = True
        bad_sig = Vote.decode(good.encode())
        bad_sig.signature = bytes(len(good.signature))
        wrong_pid = Vote.decode(good.encode())
        wrong_pid.proposal_id = pid + 1
        for tampered in (flipped, bad_sig, wrong_pid):
            engine = TorchConsensusEngine(
                EthereumConsensusSigner.random(), capacity=4, voter_capacity=8,
                device="cpu",
            )
            engine.process_incoming_proposal("tam2", Proposal.decode(proposal), NOW + 1)
            with pytest.raises(ConsensusError) as local:
                engine.process_incoming_vote("tam2", tampered, NOW + 3)
            with pytest.raises(BridgeError) as wire:
                client.process_vote(alice, "tam2", tampered.encode(), NOW + 3)
            assert wire.value.status == int(local.value.code)

    def test_batch_vote_delivery(self, client):
        """OP_PROCESS_VOTES: one frame carries the whole vote batch; the
        per-vote status list mirrors in-process ingest_votes (mixed
        accept / duplicate / unknown-session codes in batch order)."""
        alice, _ = client.add_peer()
        bob, _ = client.add_peer()
        pid, _ = client.create_proposal(alice, "bat", NOW, "p", b"", 4, 600)
        proposal = client.get_proposal(alice, "bat", pid)
        client.process_proposal(bob, "bat", proposal, NOW + 1)
        v_bob = client.cast_vote(bob, "bat", pid, True, NOW + 2)
        unknown = Vote.decode(v_bob)
        unknown.proposal_id = 999_999_999
        statuses = client.process_votes(
            alice,
            "bat",
            [v_bob, v_bob, unknown.encode(), b"\xff\xff garbage"],
            NOW + 3,
        )
        assert statuses == [
            int(StatusCode.OK),
            int(StatusCode.DUPLICATE_VOTE),
            int(StatusCode.SESSION_NOT_FOUND),
            P.STATUS_BAD_REQUEST,  # undecodable blob: per-vote, not fatal
        ]

    def test_unknown_peer_and_session(self, client):
        with pytest.raises(BridgeError) as exc:
            client.get_result(999_999, "x", 1)
        assert exc.value.status == P.STATUS_UNKNOWN_PEER
        peer, _ = client.add_peer()
        with pytest.raises(BridgeError) as exc:
            client.get_result(peer, "x", 12345)
        assert exc.value.status == int(StatusCode.SESSION_NOT_FOUND)

    def test_unknown_opcode_and_truncated_frame(self, server):
        host, port = server.address
        with socket.create_connection((host, port), timeout=10) as sock:
            sock.sendall(P.encode_frame(137, b""))
            status, _ = P.read_frame(sock)
            assert status == P.STATUS_UNKNOWN_OPCODE
        with socket.create_connection((host, port), timeout=10) as sock:
            # CREATE_PROPOSAL with a truncated payload: bad request, then the
            # server keeps serving new connections.
            sock.sendall(P.encode_frame(P.OP_CREATE_PROPOSAL, struct.pack("<I", 1)))
            status, _ = P.read_frame(sock)
            assert status == P.STATUS_BAD_REQUEST
        with BridgeClient(host, port) as cl:
            assert cl.ping() == P.PROTOCOL_VERSION


class TestTraceContextOnTheWire:
    def test_create_response_carries_bound_context(self, client):
        pid, _ = client.create_proposal(client.add_peer()[0], "tr1", NOW, "p", b"", 3, 600)
        ctx = client.last_trace_context
        assert ctx is not None
        assert len(ctx.trace_id) == 16 and len(ctx.span_id) == 8

    def test_context_propagates_across_peers(self, client):
        alice, _ = client.add_peer()
        bob, _ = client.add_peer()
        pid, proposal = client.create_proposal(alice, "tr2", NOW, "p", b"", 3, 600)
        ctx = client.last_trace_context
        client.process_proposal(bob, "tr2", proposal, NOW + 1, trace=ctx)
        vote = client.cast_vote(bob, "tr2", pid, True, NOW + 2)
        bob_ctx = client.last_trace_context
        # Same trace on both peers, different span identities.
        assert bob_ctx.trace_id == ctx.trace_id
        assert bob_ctx.span_id != ctx.span_id
        client.process_vote(alice, "tr2", vote, NOW + 3, trace=ctx)

    def test_old_wire_client_interoperates(self, server):
        """A seed-protocol embedder: frames WITHOUT trace suffixes, and
        response tails ignored. Must decode identically and decide."""
        host, port = server.address
        with socket.create_connection((host, port), timeout=10) as sock:
            def call(opcode, payload):
                sock.sendall(P.encode_frame(opcode, payload))
                status, cursor = P.read_frame(sock)
                assert status == P.STATUS_OK, status
                return cursor

            peer = call(P.OP_ADD_PEER, P.u8(0)).u32()
            # CREATE_PROPOSAL exactly as the seed client encoded it.
            cursor = call(
                P.OP_CREATE_PROPOSAL,
                P.u32(peer) + P.string("old") + P.u64(NOW) + P.string("p")
                + P.blob(b"") + P.u32(1) + P.u64(600) + P.u8(1),
            )
            pid = cursor.u32()
            cursor.blob()
            assert not cursor.done()  # new server appended a suffix...
            # ...which an old client simply never reads. Keep going:
            call(
                P.OP_CAST_VOTE,
                P.u32(peer) + P.string("old") + P.u32(pid) + P.u8(1) + P.u64(NOW + 1),
            )
            result = call(
                P.OP_GET_RESULT, P.u32(peer) + P.string("old") + P.u32(pid)
            ).u8()
            assert result == P.RESULT_YES

    def test_short_or_unknown_suffix_tails_are_tolerated(self, server):
        """Trailing bytes that are not a well-formed version-0 suffix —
        short fragments, future versions — are consumed and ignored, the
        same tolerance the pre-suffix server gave all trailing bytes."""
        host, port = server.address
        with socket.create_connection((host, port), timeout=10) as sock:
            def call(opcode, payload):
                sock.sendall(P.encode_frame(opcode, payload))
                status, cursor = P.read_frame(sock)
                return status, cursor

            status, cursor = call(P.OP_ADD_PEER, P.u8(0))
            assert status == P.STATUS_OK
            peer = cursor.u32()
            base = (
                P.u32(peer) + P.string("tail") + P.u64(NOW) + P.string("p")
                + P.blob(b"") + P.u32(3) + P.u64(600) + P.u8(1)
            )
            for tail in (b"\x07\x07\x07", P.u8(9) + b"z" * 25):
                status, _ = call(P.OP_CREATE_PROPOSAL, base + tail)
                assert status == P.STATUS_OK, (tail, status)

    def test_suffixed_and_bare_frames_decode_identically(self, client):
        """The same PROCESS_PROPOSAL bytes land the same session state
        whether or not the optional suffix is present."""
        alice, _ = client.add_peer()
        peers = [client.add_peer()[0] for _ in range(2)]
        pid, proposal = client.create_proposal(alice, "tr3", NOW, "p", b"", 3, 600)
        ctx = client.last_trace_context
        client.process_proposal(peers[0], "tr3", proposal, NOW + 1, trace=ctx)
        client.process_proposal(peers[1], "tr3", proposal, NOW + 1)  # bare
        assert client.get_stats(peers[0], "tr3") == client.get_stats(peers[1], "tr3")


class TestExplainOpcode:
    def test_explain_decided_proposal(self, client):
        peers, pid = run_quickstart(client, "expl")
        verdict = client.explain(peers[0], "expl", pid)
        assert verdict["status"] == "reached" and verdict["result"] is True
        quorum = verdict["quorum"]
        assert quorum["expected_voters"] == 3
        assert quorum["required_votes"] == 2  # div_ceil(2*3, 3)
        assert quorum["rule"] == "div_ceil(2n, 3)"
        # Quorum hits at 2 of 3 — the last vote arrives post-decision
        # (ALREADY_REACHED) and is not part of the accepted chain.
        assert quorum["yes"] >= quorum["required_votes"] and quorum["reached"]
        assert quorum["recomputed_result"] is True
        assert len(verdict["vote_chain"]) == quorum["total"]
        assert len(verdict["contributions"]) == quorum["total"]
        assert verdict["timeline"]["outcome"] == "yes"
        assert verdict["trace"] is not None

    def test_explain_unknown_session_maps_status(self, client):
        peer, _ = client.add_peer()
        with pytest.raises(BridgeError) as exc:
            client.explain(peer, "expl", 987654)
        assert exc.value.status == int(StatusCode.SESSION_NOT_FOUND)


class TestConcurrentClients:
    def test_parallel_connections_share_peers_safely(self, server):
        """Many connections driving the same peer concurrently: the engine's
        lock must serialize mutations so exactly the expected vote set lands
        (reference concurrency contract, tests/concurrency_tests.rs)."""
        import threading

        host, port = server.address
        with BridgeClient(host, port) as setup:
            alice, _ = setup.add_peer()
            pid, _ = setup.create_proposal(alice, "cc", NOW, "p", b"", 32, 600)
            proposal = setup.get_proposal(alice, "cc", pid)
            # 8 remote voters, one engine-backed peer each, pre-built votes.
            voters = [setup.add_peer()[0] for _ in range(8)]
            votes = []
            for voter in voters:
                setup.process_proposal(voter, "cc", proposal, NOW + 1)
                votes.append(setup.cast_vote(voter, "cc", pid, True, NOW + 2))

        statuses: dict[int, list[int]] = {}
        errors: list[Exception] = []

        def deliver(i: int, vote: bytes) -> None:
            try:
                with BridgeClient(host, port) as cl:
                    # Each thread its own connection; two deliveries per
                    # vote so duplicates race against first-writers.
                    statuses[i] = cl.process_votes(
                        alice, "cc", [vote, vote], NOW + 3
                    )
            except Exception as exc:  # pragma: no cover
                errors.append(exc)

        threads = [
            threading.Thread(target=deliver, args=(i, v))
            for i, v in enumerate(votes)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors
        flat = [s for pair in statuses.values() for s in pair]
        # Exactly one success per voter; the duplicate copy is rejected
        # (or arrives after decision as ALREADY_REACHED).
        ok = flat.count(int(StatusCode.OK)) + flat.count(28)
        dup = flat.count(int(StatusCode.DUPLICATE_VOTE))
        assert ok == 8 and dup == 8, flat
        with BridgeClient(host, port) as check:
            assert check.get_stats(alice, "cc") == (1, 1, 0, 0)


class TestBridgeOverFactoryEngine:
    def test_quickstart_on_factory_engine(self):
        """engine_factory swaps the backing engine (here one with its own
        capacity and no admission cache); the device argument is not
        consulted for it."""
        from hashgraph_tpu_torch.engine import TorchConsensusEngine

        built = []

        def factory(signer):
            engine = TorchConsensusEngine(
                signer, capacity=4, voter_capacity=8, device="cpu",
                verify_cache=None,
            )
            built.append(engine)
            return engine

        with BridgeServer(engine_factory=factory) as server:
            with BridgeClient(*server.address) as client:
                peers, pid = run_quickstart(client, "fac")
                for peer in peers:
                    assert client.get_result(peer, "fac", pid) is True
                    assert server.peer_engine(peer) in built
                    events = client.poll_events(peer)
                    assert any(
                        e.kind == P.EVENT_REACHED and e.result for e in events
                    )
        assert len(built) == 3


class TestDeviceArgument:
    def test_default_device_is_cuda(self):
        """Without a GPU the default server refuses to start rather than
        move to the CPU; with one, its engines hold their pools there."""
        if torch.cuda.is_available():
            server = BridgeServer(capacity=4, voter_capacity=4)
            server.start_embedded()
            try:
                status, _ = server.dispatch_frame(P.OP_ADD_PEER, P.u8(0))
                assert status == P.STATUS_OK
                assert server.peer_engine(1).pool().device.type == "cuda"
            finally:
                server.stop()
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                BridgeServer(capacity=4, voter_capacity=4)

    def test_cpu_engines_on_request(self):
        server = BridgeServer(capacity=4, voter_capacity=4, device="cpu")
        server.start_embedded()
        try:
            status, payload = server.dispatch_frame(P.OP_ADD_PEER, P.u8(0))
            assert status == P.STATUS_OK
            peer = P.Cursor(payload).u32()
            assert server.peer_engine(peer).pool().device.type == "cpu"
        finally:
            server.stop()


class TestCClient:
    def test_c_quickstart_end_to_end(self, server, tmp_path):
        """Compile the C embedder and let it run the whole scenario."""
        cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("g++")
        if cc is None:
            pytest.skip("no C compiler available")
        binary = tmp_path / "bridge_demo"
        compile_proc = subprocess.run(
            [cc, "-O2", "-o", str(binary), "native/bridge_client.c"],
            capture_output=True,
            text=True,
            timeout=120,
        )
        assert compile_proc.returncode == 0, compile_proc.stderr
        host, port = server.address
        proc = subprocess.run(
            [str(binary), host, str(port)],
            capture_output=True,
            text=True,
            timeout=120,
        )
        assert proc.returncode == 0, (proc.stdout, proc.stderr)
        assert "QUICKSTART PASS" in proc.stdout
        for name in ("alice", "bob", "carol"):
            assert f"{name}: consensus YES" in proc.stdout
