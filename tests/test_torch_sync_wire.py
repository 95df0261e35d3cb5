"""Cross-package gates for the port's catch-up client, with exact
equality throughout:

- a port ``CatchUpClient`` catches a fresh port engine up from a durable
  JAX server: the snapshot lands on the JAX source's ``state_fingerprint``,
  a second ``catch_up`` after more traffic tails only the new records onto
  the new fingerprint, and ``full_replay`` into another fresh engine lands
  there too;
- a JAX client does the same from a durable port server (both sources take
  the same traffic, and their fingerprints are equal too);
- ``verify_sessions`` gives the same count, or the same error type and
  message, in both packages on the same Ed25519-signed snapshot, valid and
  tampered five ways; the port's device signer (its batch pipeline on the
  CPU) gives the port's host answers.

The JAX side never runs in this process: ``python
tests/test_torch_sync_wire.py --reference MODE ...`` runs it on the JAX CPU
backend (``serve`` keeps a durable JAX server up and takes its steps from
stdin; ``catchup`` runs a JAX joiner; ``verify`` checks a snapshot file).
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import random
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
NOW = 1_700_000_000
PORT_PKG = "hashgraph_tpu_torch"
REF_PKG = "hashgraph_tpu"
KEY = b"\x15" * 32
SCOPES = ("g", "p")  # the second on the P2P preset
SESSIONS = 6  # half a scope
VOTERS = 24  # expected voters; 16 votes a session stay within the P2P round cap
FIRST, LATER = 12, 4  # votes a session before the snapshot, then in the tail
TAMPERS = ("none", "signature", "hash", "bound", "chain", "unproducible")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _subprocess_env() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def reference_proc(*args):
    return subprocess.Popen([sys.executable, __file__, "--reference", *map(str, args)],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                            cwd=str(REPO), env=_subprocess_env())


def read_json(proc) -> dict:
    line = proc.stdout.readline()
    assert line, "the JAX side ended early"
    return json.loads(line)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ── sources of both packages ───────────────────────────────────────────


def chains(pkg: str, seed: int = 21):
    """Proposals (half a scope) and their stub-signed chains of
    ``FIRST + LATER`` votes, built with seeded ids: the same bytes in both
    packages."""
    wire, proto = _mod(pkg, "wire"), _mod(pkg, "protocol")
    stub = _mod(pkg, "signing.stub").StubConsensusSigner
    rng = random.Random(seed)
    signers = [stub(b"voter-%d" % i) for i in range(VOTERS)]
    proto.set_id_entropy(lambda: rng.getrandbits(128))
    try:
        out = []
        for k in range(SESSIONS):
            proposal = wire.Proposal(
                name=f"c{k}", payload=b"", proposal_id=rng.getrandbits(32),
                proposal_owner=b"owner", expected_voters_count=VOTERS, timestamp=NOW,
                expiration_timestamp=NOW + 3600, liveness_criteria_yes=k % 2 == 0)
            shadow = wire.Proposal.decode(proposal.encode())
            for j in range(FIRST + LATER):
                shadow.votes.append(proto.build_vote(shadow, rng.random() < 0.7, signers[j],
                                                     NOW + 1))
            out.append((SCOPES[k * 2 // SESSIONS], proposal.encode(),
                        [v.encode() for v in shadow.votes]))
        return out
    finally:
        proto.set_id_entropy(None)


def durable_source(pkg: str, wal_dir: str):
    """A started durable server of ``pkg`` with one keyed peer, the P2P
    scope initialised and the first votes of every chain taken."""
    bridge = _mod(pkg, "bridge")
    options = dict(capacity=64, voter_capacity=VOTERS, wal_dir=wal_dir, wal_fsync="off",
                   signer_factory=_mod(pkg, "signing.stub").StubConsensusSigner)
    if pkg == PORT_PKG:
        options["device"] = "cpu"
    server = bridge.BridgeServer(**options)
    server.start()
    with bridge.BridgeClient(*server.address) as client:
        peer = client.add_peer(KEY)[0]
    server.peer_engine(peer).scope(SCOPES[1]).p2p_preset().initialize()
    feed(pkg, server, peer, 0, FIRST, proposals=True)
    return server, peer


def feed(pkg, server, peer, lo, hi, proposals=False):
    """Votes ``lo:hi`` of every chain (and the proposals first) through the
    server's own client."""
    with _mod(pkg, "bridge").BridgeClient(*server.address) as client:
        for scope, blob, votes in chains(pkg):
            if proposals:
                client.process_proposal(peer, scope, blob, NOW)
            client.process_votes(peer, scope, votes[lo:hi], NOW + 1)


def fingerprint(pkg, server, peer) -> str:
    with _mod(pkg, "bridge").BridgeClient(*server.address) as client:
        return client.state_fingerprint(peer)


def stop_server(pkg: str, server) -> None:
    if pkg == REF_PKG:
        # The JAX server's stop() waits for its accept loop, which only a
        # listener shutdown wakes at once.
        with contextlib.suppress(OSError):
            server._listener.shutdown(socket.SHUT_RDWR)
    server.stop()


def joiner(pkg: str, identity: bytes):
    stub = _mod(pkg, "signing.stub").StubConsensusSigner(identity)
    if pkg == PORT_PKG:
        return _mod(pkg, "engine").TorchConsensusEngine(stub, capacity=64, voter_capacity=VOTERS,
                                                        device="cpu")
    return _mod(pkg, "engine").TpuConsensusEngine(stub, capacity=64, voter_capacity=VOTERS)


def catch_up_steps(pkg: str, host: str, port: int, peer: int, between) -> dict:
    """A ``pkg`` joiner: snapshot catch-up, then ``between()`` (the source
    takes more votes), a second ``catch_up`` on the same client (the tail
    only), then ``full_replay`` into a fresh engine."""
    sync = _mod(pkg, "sync")
    engine = joiner(pkg, b"joiner-one-identity-")
    with sync.CatchUpClient(host, port, peer) as client:
        first = client.catch_up(engine)
        at_snapshot = sync.state_fingerprint(engine)
        between(at_snapshot)
        second = client.catch_up(engine)
    replayed = joiner(pkg, b"joiner-two-identity-")
    with sync.CatchUpClient(host, port, peer) as client:
        replay = client.full_replay(replayed)
    return {
        "snapshot": at_snapshot, "sessions": first.sessions_installed,
        "verified": first.votes_verified, "first_tail": first.tail_records,
        "resumed": second.resumed, "tail": second.tail_records,
        "tail_votes": second.tail_votes, "after_tail": sync.state_fingerprint(engine),
        "replay_records": replay.tail_records, "replayed": sync.state_fingerprint(replayed),
    }


def test_port_client_catches_up_from_a_jax_server(tmp_path):
    proc = reference_proc("serve", tmp_path / "jax-wal")
    try:
        ready = read_json(proc)
        fingerprints = [ready["fingerprint"]]

        def between(_):
            proc.stdin.write("MORE\n")
            proc.stdin.flush()
            fingerprints.append(read_json(proc)["fingerprint"])

        out = catch_up_steps(PORT_PKG, "127.0.0.1", ready["port"], ready["peer"], between)
    finally:
        proc.stdin.close()
        proc.wait(timeout=60)
    assert proc.returncode == 0
    before, after = fingerprints
    assert out["snapshot"] == before != after
    assert out["sessions"] == SESSIONS and out["verified"] == SESSIONS * FIRST
    assert out["resumed"] and out["tail"] > 0 and out["tail_votes"] == SESSIONS * LATER
    assert out["after_tail"] == after and out["replayed"] == after
    assert out["replay_records"] > out["tail"]
    # The port source fed alike lands on the same fingerprints.
    server, peer = durable_source(PORT_PKG, str(tmp_path / "port-wal"))
    try:
        assert fingerprint(PORT_PKG, server, peer) == before
        feed(PORT_PKG, server, peer, FIRST, FIRST + LATER)
        assert fingerprint(PORT_PKG, server, peer) == after
    finally:
        stop_server(PORT_PKG, server)


def test_jax_client_catches_up_from_a_port_server(tmp_path):
    server, peer = durable_source(PORT_PKG, str(tmp_path / "port-wal"))
    try:
        before = fingerprint(PORT_PKG, server, peer)
        proc = reference_proc("catchup", server.address[1], peer)
        try:
            at_snapshot = read_json(proc)["snapshot"]
            feed(PORT_PKG, server, peer, FIRST, FIRST + LATER)
            after = fingerprint(PORT_PKG, server, peer)
            proc.stdin.write("GO\n")
            proc.stdin.flush()
            out = read_json(proc)
        finally:
            proc.stdin.close()
            proc.wait(timeout=60)
    finally:
        stop_server(PORT_PKG, server)
    assert proc.returncode == 0
    assert at_snapshot == out["snapshot"] == before != after
    assert out["sessions"] == SESSIONS and out["verified"] == SESSIONS * FIRST
    assert out["resumed"] and out["tail"] > 0 and out["tail_votes"] == SESSIONS * LATER
    assert out["after_tail"] == after and out["replayed"] == after


# ── verify_sessions on the same snapshot ───────────────────────────────


def signed_snapshot(path: str) -> None:
    """A port engine's snapshot: 4 proposals of 5 expected voters, each
    with 3 YES votes from Ed25519 keys (undecided), written to ``path``."""
    from hashgraph_tpu_torch import (
        CreateProposalRequest,
        Ed25519ConsensusSigner,
        StubConsensusSigner,
        TorchConsensusEngine,
        build_vote,
        protocol,
    )
    from hashgraph_tpu_torch.sync import build_snapshot

    rng = random.Random(4)
    keys = [Ed25519ConsensusSigner(rng.randbytes(32)) for _ in range(3)]
    protocol.set_id_entropy(lambda: rng.getrandbits(128))
    try:
        engine = TorchConsensusEngine(StubConsensusSigner(b"snapshot-source-peer"), capacity=16,
                                      voter_capacity=8, device="cpu")
        requests = [CreateProposalRequest(
            name=f"v{i}", payload=b"x", proposal_owner=b"owner", expected_voters_count=5,
            expiration_timestamp=10_000, liveness_criteria_yes=True) for i in range(4)]
        for proposal in engine.create_proposals("s", requests, NOW):
            for key in keys:
                vote = build_vote(engine.get_proposal("s", proposal.proposal_id), True, key,
                                  NOW + 1)
                engine.ingest_votes([("s", vote)], NOW + 1, pre_validated=True)
    finally:
        protocol.set_id_entropy(None)
    build_snapshot(engine, path)


def verify_outcomes(pkg: str, path: str, scheme=None) -> dict:
    """``verify_sessions`` on the snapshot, as decoded and tampered each of
    ``TAMPERS`` ways: the count verified, or the error's type and message."""
    sync = _mod(pkg, "sync")
    session_mod = _mod(pkg, "session")
    scheme = scheme or _mod(pkg, "signing").Ed25519ConsensusSigner
    _, sessions, _ = sync.decode_snapshot([Path(path).read_bytes()])
    out = {}
    for tamper in TAMPERS:
        forged = [(scope, session.clone()) for scope, session in sessions]
        if tamper == "signature":
            vote = forged[0][1].proposal.votes[1]
            vote.signature = vote.signature[:7] + bytes([vote.signature[7] ^ 1]) + vote.signature[8:]
        elif tamper == "hash":
            forged[1][1].proposal.votes[-1].vote_hash = bytes(32)
        elif tamper == "bound":
            forged[2][1].proposal.votes[0].proposal_id ^= 1
        elif tamper == "chain":
            votes = forged[3][1].proposal.votes
            votes[0], votes[1] = votes[1], votes[0]
        elif tamper == "unproducible":
            forged[0][1].state = session_mod.ConsensusState.reached(False)
        try:
            out[tamper] = sync.verify_sessions(forged, scheme)
        except sync.SyncVerificationError as exc:
            out[tamper] = [type(exc).__name__, str(exc)]
    return out


def test_verify_sessions_answers_alike(tmp_path):
    from hashgraph_tpu_torch.signing import Ed25519DeviceConsensusSigner

    class CpuSigner(Ed25519DeviceConsensusSigner):
        device = "cpu"

    path = str(tmp_path / "signed.bin")
    signed_snapshot(path)
    ours = verify_outcomes(PORT_PKG, path)
    assert ours["none"] == 12
    assert all(isinstance(ours[t], list) for t in TAMPERS[1:])
    assert verify_outcomes(PORT_PKG, path, CpuSigner) == ours
    proc = reference_proc("verify", path)
    try:
        theirs = read_json(proc)
    finally:
        proc.stdin.close()
        proc.wait(timeout=120)
    assert theirs == ours


def _serve_main(wal_dir: str) -> None:
    server, peer = durable_source(REF_PKG, wal_dir)
    print(json.dumps({"port": server.address[1], "peer": peer,
                      "fingerprint": fingerprint(REF_PKG, server, peer)}), flush=True)
    for line in sys.stdin:
        if line.strip() != "MORE":
            break
        feed(REF_PKG, server, peer, FIRST, FIRST + LATER)
        print(json.dumps({"fingerprint": fingerprint(REF_PKG, server, peer)}), flush=True)
    stop_server(REF_PKG, server)


def _catchup_main(port: int, peer: int) -> None:
    def between(at_snapshot):
        print(json.dumps({"snapshot": at_snapshot}), flush=True)
        assert sys.stdin.readline().strip() == "GO"

    print(json.dumps(catch_up_steps(REF_PKG, "127.0.0.1", port, peer, between)), flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    mode, args = sys.argv[2], sys.argv[3:]
    if mode == "serve":
        _serve_main(args[0])
    elif mode == "catchup":
        _catchup_main(int(args[0]), int(args[1]))
    elif mode == "verify":
        print(json.dumps(verify_outcomes(REF_PKG, args[0])), flush=True)
