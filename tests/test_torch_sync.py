"""The port's state sync end to end on the CPU: snapshot format, batched
chain verification, bridge sync opcodes, CatchUpClient (install + tail +
resume) and adversarial sources, over ``hashgraph_tpu_torch`` servers and
engines built with ``device="cpu"``.

A twin of ``tests/test_sync.py`` without its two fleet tests
(``test_catch_up_shard_recovers_from_peer`` and
``test_recover_shard_surfaces_wal_recover_stats``): the port has no
``ConsensusFleet`` yet. Stub signers keep the suite fast; the
cross-package catch-up with real signatures is
``tests/test_torch_sync_wire.py``.
"""

import hashlib
import os

import pytest
import torch

from hashgraph_tpu_torch import (
    ConsensusState,
    CreateProposalRequest,
    StatusCode,
    StubConsensusSigner,
    build_vote,
)
from hashgraph_tpu_torch.bridge import protocol as P
from hashgraph_tpu_torch.bridge.client import BridgeClient, BridgeError
from hashgraph_tpu_torch.bridge.server import BridgeServer
from hashgraph_tpu_torch.engine import TorchConsensusEngine
from hashgraph_tpu_torch.obs import flight_recorder, registry
from hashgraph_tpu_torch.storage import InMemoryConsensusStorage
from hashgraph_tpu_torch.sync import (
    CatchUpClient,
    SnapshotDecodeError,
    SnapshotDigestError,
    SyncStateError,
    SyncVerificationError,
    TailGapError,
    TailRecordError,
    build_snapshot,
    decode_snapshot,
    state_fingerprint,
    verify_sessions,
)
from hashgraph_tpu_torch.sync.snapshot import (
    ITEM_END,
    ITEM_HEADER,
    ITEM_SESSION,
    MAGIC,
    SnapshotManifest,
    _u32,
    _u64,
    encode_frame,
    encode_session_item,
)
from hashgraph_tpu_torch.wal import DurableEngine
from hashgraph_tpu_torch.wal.recovery import read_tail

NOW = 1_700_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fresh_engine(identity: bytes = b"self-peer-identity--") -> TorchConsensusEngine:
    return TorchConsensusEngine(
        StubConsensusSigner(identity), capacity=64, voter_capacity=8,
        device="cpu",
    )


def request(name="p", voters=5, expiry=10_000):
    return CreateProposalRequest(
        name=name, payload=b"x", proposal_owner=b"owner",
        expected_voters_count=voters, expiration_timestamp=expiry,
        liveness_criteria_yes=True,
    )


def grow_history(engine, scope="s", proposals=4, voters=3, now=NOW):
    """Create proposals and vote on them with distinct remote signers."""
    signers = [StubConsensusSigner(os.urandom(20)) for _ in range(voters)]
    out = engine.create_proposals(scope, [request(f"p{i}") for i in range(proposals)], now)
    for p in out:
        for s in signers:
            vote = build_vote(engine.get_proposal(scope, p.proposal_id), True, s, now + 1)
            engine.ingest_votes([(scope, vote)], now + 1, pre_validated=True)
    return out


# ── Snapshot format ────────────────────────────────────────────────────


def test_snapshot_round_trip_fingerprint_equality(tmp_path):
    durable = DurableEngine(fresh_engine(), str(tmp_path / "wal"))
    grow_history(durable, proposals=5, voters=2)
    durable.scope("cfg-scope").with_threshold(0.75).initialize()
    path = str(tmp_path / "snap.bin")
    manifest = build_snapshot(durable, path, chunk_bytes=256)
    assert manifest.watermark == durable.wal.last_lsn
    assert manifest.session_count == 5
    assert manifest.chunk_count == -(-manifest.total_bytes // 256)
    data = open(path, "rb").read()
    assert len(data) == manifest.total_bytes
    for i, digest in enumerate(manifest.digests):
        chunk = data[i * 256 : (i + 1) * 256]
        assert hashlib.sha256(chunk).digest() == digest
    watermark, sessions, configs = decode_snapshot(
        data[i : i + 256] for i in range(0, len(data), 256)
    )
    assert watermark == manifest.watermark
    assert len(sessions) == 5 and len(configs) == 1
    joiner = fresh_engine()
    storage = InMemoryConsensusStorage()
    for scope, config in configs:
        # Configs set explicitly too: load_from_storage only walks scopes
        # holding sessions, and "cfg-scope" has none (the CatchUpClient
        # install does the same).
        storage.set_scope_config(scope, config)
        joiner.set_scope_config(scope, config)
    for scope, session in sessions:
        storage.save_session(scope, session)
    joiner.load_from_storage(storage)
    assert state_fingerprint(joiner) == state_fingerprint(durable)
    durable.close()


def test_snapshot_preserves_tallies_and_states(tmp_path):
    """Columnar tallies and terminal states survive the round trip —
    state a chain replay could NOT reconstruct (the reason install is
    load_from_storage, not re-delivery)."""
    import numpy as np

    engine = fresh_engine()
    (p,) = engine.create_proposals("s", [request(voters=4)], NOW)
    gid = engine.voter_gid(b"columnar-voter-xxxxx")
    vote = build_vote(p, True, StubConsensusSigner(b"columnar-voter-xxxxx"), NOW + 1)
    statuses = engine.ingest_columnar(
        "s", np.asarray([p.proposal_id]), np.asarray([gid]),
        np.asarray([True]), NOW + 1, wire_votes=[vote.encode()],
    )
    assert int(statuses[0]) == int(StatusCode.OK)
    durable = DurableEngine(fresh_engine(), str(tmp_path / "wal"))
    # Bare (non-durable) engines snapshot too, at watermark 0.
    path = str(tmp_path / "snap.bin")
    manifest = build_snapshot(engine, path)
    assert manifest.watermark == 0
    _, sessions, _ = decode_snapshot([open(path, "rb").read()])
    joiner = fresh_engine()
    storage = InMemoryConsensusStorage()
    for scope, session in sessions:
        storage.save_session(scope, session)
    joiner.load_from_storage(storage)
    assert state_fingerprint(joiner) == state_fingerprint(engine)
    durable.close()


def test_snapshot_decode_rejects_corruption(tmp_path):
    durable = DurableEngine(fresh_engine(), str(tmp_path / "wal"))
    grow_history(durable, proposals=2, voters=2)
    path = str(tmp_path / "snap.bin")
    build_snapshot(durable, path)
    durable.close()
    data = bytearray(open(path, "rb").read())

    with pytest.raises(SnapshotDecodeError, match="CRC"):
        flipped = bytearray(data)
        flipped[len(flipped) // 2] ^= 0xFF
        decode_snapshot([bytes(flipped)])
    with pytest.raises(SnapshotDecodeError, match="incomplete frame"):
        decode_snapshot([bytes(data[:-3])])
    with pytest.raises(SnapshotDecodeError, match="magic"):
        bad = encode_frame(ITEM_HEADER, b"NOTMAGIC" + _u32(1) + _u64(0))
        decode_snapshot([bad + bytes(data[len(bad) :])])
    with pytest.raises(SnapshotDecodeError, match="trailer"):
        # Drop the END frame entirely: count check can't pass.
        end = encode_frame(ITEM_END, _u32(2) + _u32(0))
        assert data.endswith(end)
        decode_snapshot([bytes(data[: -len(end)])])
    with pytest.raises(SnapshotDecodeError, match="claims"):
        end = encode_frame(ITEM_END, _u32(2) + _u32(0))
        wrong_end = encode_frame(ITEM_END, _u32(7) + _u32(0))
        decode_snapshot([bytes(data[: -len(end)]) + wrong_end])


# ── Batched snapshot verification ──────────────────────────────────────


def _snapshot_sessions(tmp_path, proposals=3, voters=3):
    durable = DurableEngine(fresh_engine(), str(tmp_path / "wal-v"))
    grow_history(durable, proposals=proposals, voters=voters)
    path = str(tmp_path / "verify.bin")
    build_snapshot(durable, path)
    durable.close()
    _, sessions, _ = decode_snapshot([open(path, "rb").read()])
    return sessions


def test_verify_sessions_accepts_valid_chains(tmp_path):
    sessions = _snapshot_sessions(tmp_path)
    assert verify_sessions(sessions, StubConsensusSigner) == 9


def test_verify_sessions_rejects_tampering(tmp_path):
    sessions = _snapshot_sessions(tmp_path)

    forged = [(s, sess.clone()) for s, sess in sessions]
    victim = forged[0][1].proposal.votes[0]
    victim.signature = bytes(32)
    with pytest.raises(SyncVerificationError, match="signature"):
        verify_sessions(forged, StubConsensusSigner)

    forged = [(s, sess.clone()) for s, sess in sessions]
    forged[1][1].proposal.votes[-1].vote_hash = bytes(32)
    with pytest.raises(SyncVerificationError, match="hash mismatch"):
        verify_sessions(forged, StubConsensusSigner)

    forged = [(s, sess.clone()) for s, sess in sessions]
    forged[2][1].proposal.votes[0].proposal_id ^= 1
    with pytest.raises(SyncVerificationError, match="bound to proposal"):
        verify_sessions(forged, StubConsensusSigner)

    forged = [(s, sess.clone()) for s, sess in sessions]
    chain = forged[0][1].proposal.votes
    chain[0], chain[1] = chain[1], chain[0]  # break received_hash linkage
    with pytest.raises(SyncVerificationError, match="chain invalid"):
        verify_sessions(forged, StubConsensusSigner)


def test_verify_sessions_rejects_unproducible_decided_state(tmp_path):
    """The lifecycle state byte is unsigned, but a claimed decided result
    must at least be PRODUCIBLE by the decision kernel from the verified
    participants: these sessions hold 3 unanimous-yes votes of 5 expected
    (undecided on the vote path, yes-only via the liveness timeout path),
    so a snapshot claiming they decided False is a forgery no admissible
    timing could have produced."""
    sessions = _snapshot_sessions(tmp_path)
    assert sessions[0][1].state.is_active
    forged = [(s, sess.clone()) for s, sess in sessions]
    forged[0][1].state = ConsensusState.reached(False)
    with pytest.raises(SyncVerificationError, match="producible"):
        verify_sessions(forged, StubConsensusSigner)


# ── WAL tail serving ───────────────────────────────────────────────────


def test_read_tail_budget_and_resume(tmp_path):
    durable = DurableEngine(
        fresh_engine(), str(tmp_path / "wal"), segment_bytes=512
    )
    grow_history(durable, proposals=4, voters=3)
    last = durable.wal.last_lsn
    all_records, more = read_tail(str(tmp_path / "wal"), 0, 1 << 20)
    assert not more
    assert [lsn for lsn, _, _ in all_records] == list(range(1, last + 1))
    # Tiny budget: page through, records concatenate identically.
    paged = []
    after = 0
    for _ in range(10_000):
        page, more = read_tail(str(tmp_path / "wal"), after, 64)
        paged.extend(page)
        if not page:
            break
        after = page[-1][0]
        if not more and after == last:
            break
    assert paged == all_records
    # after_lsn skips the prefix exactly.
    suffix, _ = read_tail(str(tmp_path / "wal"), last - 2, 1 << 20)
    assert [lsn for lsn, _, _ in suffix] == [last - 1, last]
    durable.close()


def test_capture_consistent_watermark_matches_state(tmp_path):
    durable = DurableEngine(fresh_engine(), str(tmp_path / "wal"))
    grow_history(durable, proposals=2, voters=2)
    seen = {}

    def capture(inner, watermark):
        seen["watermark"] = watermark
        return "done"

    assert durable.capture_consistent(capture) == "done"
    assert seen["watermark"] == durable.wal.last_lsn
    durable.close()


# ── Bridge + CatchUpClient end to end ──────────────────────────────────


@pytest.fixture
def sync_server(tmp_path):
    server = BridgeServer(
        capacity=64,
        voter_capacity=8,
        wal_dir=str(tmp_path / "server-wal"),
        wal_fsync="off",
        signer_factory=StubConsensusSigner,
        device="cpu",
    )
    with server:
        host, port = server.address
        with BridgeClient(host, port) as client:
            peer, identity = client.add_peer(os.urandom(32))
            voters = [client.add_peer(os.urandom(32))[0] for _ in range(3)]
            for p in range(3):
                pid, blob = client.create_proposal(
                    peer, "sync", NOW, f"p{p}", b"payload", 4, 3_600
                )
                for vp in voters:
                    client.process_proposal(vp, "sync", blob, NOW)
                    vote = client.cast_vote(vp, "sync", pid, True, NOW + 1)
                    client.process_vote(peer, "sync", vote, NOW + 1)
            yield {
                "server": server,
                "host": host,
                "port": port,
                "client": client,
                "peer": peer,
                "voters": voters,
                "source": server.durable_engine(identity),
            }


def test_catch_up_reaches_source_state(sync_server):
    env = sync_server
    src_fp = state_fingerprint(env["source"])
    joiner = fresh_engine(b"joiner-one-identity-")
    chunks_before = registry.counter(
        "hashgraph_sync_chunks_received_total"
    ).value
    with CatchUpClient(env["host"], env["port"], env["peer"]) as cu:
        report = cu.catch_up(joiner, max_chunk_bytes=512)
    assert report.sessions_installed == 3
    assert report.votes_verified == 9
    assert state_fingerprint(joiner) == src_fp
    assert (
        registry.counter("hashgraph_sync_chunks_received_total").value
        > chunks_before
    )
    kinds = [kind for _, kind, _ in flight_recorder.events()]
    assert "sync.catchup" in kinds


def test_full_replay_matches_snapshot_install(sync_server):
    env = sync_server
    src_fp = state_fingerprint(env["source"])
    replayer = fresh_engine(b"joiner-two-identity-")
    with CatchUpClient(env["host"], env["port"], env["peer"]) as cu:
        report = cu.full_replay(replayer)
    assert report.tail_records > 0
    assert state_fingerprint(replayer) == src_fp


def test_catch_up_then_tail_resume_after_new_traffic(sync_server):
    env = sync_server
    joiner = fresh_engine(b"joiner-res-identity-")
    cu = CatchUpClient(env["host"], env["port"], env["peer"])
    cu.catch_up(joiner)
    cu.close()
    # Source moves on (new proposal + votes); resume tails ONLY the new
    # records — no chunk re-download, no re-install.
    client, peer = env["client"], env["peer"]
    pid, blob = client.create_proposal(peer, "sync", NOW + 2, "late", b"z", 4, 3_600)
    vp = env["voters"][0]
    client.process_proposal(vp, "sync", blob, NOW + 2)
    vote = client.cast_vote(vp, "sync", pid, True, NOW + 3)
    client.process_vote(peer, "sync", vote, NOW + 3)
    with CatchUpClient(
        env["host"], env["port"], env["peer"], state=cu.state
    ) as cu2:
        report = cu2.catch_up(joiner)
    assert report.resumed
    assert report.chunks_fetched == 0 and report.sessions_installed == 0
    assert report.tail_records > 0
    assert state_fingerprint(joiner) == state_fingerprint(env["source"])


def test_interrupted_chunk_download_resumes(sync_server):
    env = sync_server
    joiner = fresh_engine(b"joiner-int-identity-")
    cu = CatchUpClient(env["host"], env["port"], env["peer"])
    manifest = cu._bridge.sync_manifest(env["peer"], 256)
    assert manifest["chunk_count"] > 1
    cu.state.manifest = manifest
    cu.state.chunks[0] = cu._bridge.sync_chunk(
        env["peer"], manifest["snapshot_id"], 0
    )
    cu.close()  # connection drops mid-transfer
    with CatchUpClient(
        env["host"], env["port"], env["peer"], state=cu.state
    ) as cu2:
        report = cu2.catch_up(joiner, max_chunk_bytes=256)
    assert report.resumed
    assert report.chunks_fetched == manifest["chunk_count"] - 1
    assert state_fingerprint(joiner) == state_fingerprint(env["source"])


def test_corrupted_chunk_is_typed_error_with_no_partial_install(sync_server):
    env = sync_server
    joiner = fresh_engine(b"joiner-cor-identity-")
    cu = CatchUpClient(env["host"], env["port"], env["peer"])
    real_chunk = cu._bridge.sync_chunk

    def corrupt(peer, snapshot_id, index):
        data = bytearray(real_chunk(peer, snapshot_id, index))
        data[0] ^= 0xFF
        return bytes(data)

    cu._bridge.sync_chunk = corrupt
    with pytest.raises(SnapshotDigestError):
        cu.catch_up(joiner)
    cu.close()
    assert joiner.occupancy()["live_sessions"] == 0  # nothing installed


def test_hostile_snapshot_verification_and_trust_escape_hatch(sync_server):
    """A source serving validly-framed but badly-signed sessions: verify
    refuses (typed, no install); trust_snapshot installs anyway."""
    env = sync_server
    server, peer = env["server"], env["peer"]
    with CatchUpClient(env["host"], env["port"], peer) as cu0:
        cu0._bridge.sync_manifest(peer, 0)  # populate the server's cache
    cached_manifest, path = server._sync_cache[peer]
    _, sessions, configs = decode_snapshot([open(path, "rb").read()])
    sessions[0][1].proposal.votes[0].signature = bytes(32)  # forge
    frames = [encode_frame(ITEM_HEADER, MAGIC + _u32(1) + _u64(cached_manifest.watermark))]
    frames.extend(
        encode_frame(ITEM_SESSION, encode_session_item(s, sess))
        for s, sess in sessions
    )
    frames.append(encode_frame(ITEM_END, _u32(len(sessions)) + _u32(0)))
    hostile = b"".join(frames)
    with open(path, "wb") as fh:
        fh.write(hostile)
    server._sync_cache[peer] = (
        SnapshotManifest(
            snapshot_id=cached_manifest.snapshot_id,
            watermark=cached_manifest.watermark,
            total_bytes=len(hostile),
            chunk_bytes=cached_manifest.chunk_bytes,
            session_count=len(sessions),
            config_count=0,
            digests=(hashlib.sha256(hostile).digest(),),
        ),
        path,
    )
    joiner = fresh_engine(b"joiner-bad-identity-")
    with CatchUpClient(env["host"], env["port"], peer) as cu:
        with pytest.raises(SyncVerificationError, match="signature"):
            cu.catch_up(joiner)
    assert joiner.occupancy()["live_sessions"] == 0
    # Operator-trusted source: same bytes install without crypto.
    trusting = fresh_engine(b"joiner-tru-identity-")
    with CatchUpClient(env["host"], env["port"], peer) as cu:
        report = cu.catch_up(trusting, trust_snapshot=True)
    assert report.votes_verified == 0
    assert report.sessions_installed == len(sessions)
    assert trusting.occupancy()["live_sessions"] == len(sessions)


def test_watermark_tail_disagreement_is_typed_error(sync_server):
    """A snapshot whose watermark the served tail no longer reaches back
    to (source compacted past it) must fail typed, not apply a gap."""
    env = sync_server
    joiner = fresh_engine(b"joiner-gap-identity-")
    cu = CatchUpClient(env["host"], env["port"], env["peer"])
    cu.catch_up(joiner)
    cu.close()
    source = env["source"]
    # Source moves on AND checkpoints+compacts: the joiner's resume
    # position predates the surviving log.
    client, peer = env["client"], env["peer"]
    pid, blob = client.create_proposal(peer, "sync", NOW + 5, "post", b"z", 4, 3_600)
    source.checkpoint(InMemoryConsensusStorage(), compact=True)
    stale = fresh_engine(b"joiner-stl-identity-")
    with CatchUpClient(
        env["host"], env["port"], env["peer"], state=cu.state
    ) as cu2:
        with pytest.raises(TailGapError):
            cu2.catch_up(joiner)
    # Full replay of a compacted source is impossible for the same
    # reason — the typed error is the "you need a snapshot" signal.
    with CatchUpClient(env["host"], env["port"], env["peer"]) as cu3:
        with pytest.raises(TailGapError):
            cu3.full_replay(stale)


def test_forked_tail_suffix_settles_via_fork_path(sync_server):
    """A tail carrying a forked chain redelivery must settle through the
    engine's existing fork handling (PROPOSAL_ALREADY_EXIST, nothing
    installed over the accepted chain), landing the joiner on the
    source's exact state."""
    env = sync_server
    source = env["source"]
    joiner = fresh_engine(b"joiner-frk-identity-")
    cu = CatchUpClient(env["host"], env["port"], env["peer"])
    cu.catch_up(joiner)
    # A forked redelivery reaches the SOURCE after the snapshot: same
    # prefix, divergent last vote by a different signer. The source logs
    # it (log-before-apply) and settles it as a redelivery; the tail
    # must make the joiner do exactly the same.
    reached = source.get_reached_proposals("sync")
    any_pid = reached[0][0].proposal_id
    base = source.export_session("sync", any_pid).proposal
    forked = base.clone()
    outsider = StubConsensusSigner(b"forking-outsider-xxx")
    alt = build_vote(forked, False, outsider, NOW + 1)
    forked.votes[-1] = alt  # divergent tail at the last position
    status = source.deliver_proposal("sync", forked, NOW + 2)
    assert status == int(StatusCode.PROPOSAL_ALREADY_EXIST)
    report = cu.catch_up(joiner)  # resumes: tails the fork record
    cu.close()
    assert report.tail_records >= 1
    assert state_fingerprint(joiner) == state_fingerprint(source)
    # The accepted chain is untouched on both sides.
    assert [
        v.vote_owner for v in joiner.export_session("sync", any_pid).proposal.votes
    ] == [v.vote_owner for v in base.votes]


def test_stale_retry_mid_download_restarts_cleanly(sync_server):
    """The source rebuilds its snapshot while a joiner is mid-download:
    the STALE retry must discard the dead artifact's chunks (they belong
    to different bytes/geometry) and converge on the fresh one."""
    env = sync_server
    joiner = fresh_engine(b"joiner-str-identity-")
    cu = CatchUpClient(env["host"], env["port"], env["peer"])
    real_chunk = cu._bridge.sync_chunk
    fired = {}

    def chunk_then_rebuild(peer, snapshot_id, index):
        data = real_chunk(peer, snapshot_id, index)
        if not fired:
            fired["x"] = True
            env["source"].sweep_timeouts(NOW + 3)  # watermark moves...
            env["client"].sync_manifest(peer)  # ...and a rebuild lands
        return data

    cu._bridge.sync_chunk = chunk_then_rebuild
    report = cu.catch_up(joiner, max_chunk_bytes=256)
    cu.close()
    assert report.sessions_installed == 3
    assert state_fingerprint(joiner) == state_fingerprint(env["source"])


def test_tail_decode_fault_is_typed_error(sync_server):
    """A served tail record whose payload cannot decode must fail the
    catch-up typed (local crash replay tolerates and reports it; a remote
    joiner silently skipping a record would diverge from the source)."""
    env = sync_server
    joiner = fresh_engine(b"joiner-tde-identity-")
    cu = CatchUpClient(env["host"], env["port"], env["peer"])
    real_tail = cu._bridge.wal_tail

    def garbage_tail(peer, after_lsn, max_bytes):
        records, more = real_tail(peer, after_lsn, max_bytes)
        return (
            [(lsn, kind, b"\xff\xfe garbage") for lsn, kind, _ in records],
            more,
        )

    cu._bridge.wal_tail = garbage_tail
    with pytest.raises(TailRecordError):
        cu.full_replay(joiner)
    cu.close()


def test_catch_up_requires_fresh_engine(sync_server):
    env = sync_server
    busy = fresh_engine(b"joiner-bsy-identity-")
    grow_history(busy, proposals=1, voters=1)
    with CatchUpClient(env["host"], env["port"], env["peer"]) as cu:
        with pytest.raises(SyncStateError):
            cu.catch_up(busy)


def test_stale_snapshot_chunk_status(sync_server):
    env = sync_server
    client = env["client"]
    manifest = client.sync_manifest(env["peer"])
    # Move the watermark and force a rebuild: the old snapshot_id dies.
    env["source"].sweep_timeouts(NOW + 2)
    rebuilt = client.sync_manifest(env["peer"])
    assert rebuilt["snapshot_id"] != manifest["snapshot_id"]
    with pytest.raises(BridgeError) as excinfo:
        client.sync_chunk(env["peer"], manifest["snapshot_id"], 0)
    assert excinfo.value.status == P.STATUS_SYNC_STALE


def test_sync_opcodes_reject_undurable_peer():
    server = BridgeServer(capacity=16, voter_capacity=8, device="cpu")  # no wal_dir
    with server:
        host, port = server.address
        with BridgeClient(host, port) as client:
            peer, _ = client.add_peer()
            with pytest.raises(BridgeError) as excinfo:
                client.sync_manifest(peer)
            assert excinfo.value.status == P.STATUS_BAD_REQUEST
            with pytest.raises(BridgeError):
                client.wal_tail(peer, 0)


class TestSyncTimeouts:
    """Wall-clock timeouts on catch-up network operations: a
    stalled source raises the typed SyncTimeoutError instead of hanging
    the joiner thread; verified progress survives in the CatchUpState."""

    def test_stalled_source_socket_times_out_typed(self):
        import socket as _socket
        import threading

        from hashgraph_tpu_torch.sync import SyncTimeoutError

        listener = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        listener.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        listener.bind(("127.0.0.1", 0))
        listener.listen(1)
        host, port = listener.getsockname()[:2]
        held: list = []

        def accept_and_stall():
            conn, _ = listener.accept()
            held.append(conn)  # read the request, answer NOTHING

        thread = threading.Thread(target=accept_and_stall, daemon=True)
        thread.start()
        engine = fresh_engine(b"stalled-joiner------")
        client = CatchUpClient(host, port, 1, timeout=0.3)
        try:
            with pytest.raises(SyncTimeoutError) as excinfo:
                client.catch_up(engine)
            assert excinfo.value.operation == "manifest request"
            assert excinfo.value.timeout == 0.3
        finally:
            client.close()
            for conn in held:
                conn.close()
            listener.close()

    def test_timeout_during_chunk_names_the_operation(self):
        from hashgraph_tpu_torch.sync import SyncTimeoutError

        class StallingBridge:
            def __init__(self):
                self.manifest_calls = 0

            def sync_manifest(self, peer, max_chunk_bytes=0):
                self.manifest_calls += 1
                return {
                    "snapshot_id": 1, "watermark": 5, "total_bytes": 64,
                    "chunk_bytes": 64, "session_count": 1,
                    "config_count": 0, "chunk_count": 1,
                    "digests": [b"\x00" * 32],
                }

            def sync_chunk(self, peer, snapshot_id, index):
                raise TimeoutError("recv timed out")

            def wal_tail(self, peer, after_lsn, max_bytes=0):
                raise AssertionError("never reached")

            def close(self):
                pass

        engine = fresh_engine(b"chunk-stall-joiner--")
        client = CatchUpClient(
            "ignored", 0, 1, timeout=0.5, bridge=StallingBridge()
        )
        with pytest.raises(SyncTimeoutError) as excinfo:
            client.catch_up(engine)
        assert "chunk 0" in excinfo.value.operation
        # Progress stays resumable: the manifest survived into the state.
        assert client.state.manifest is not None
        client.close()
