"""Cross-package gates for the port's gossip fabric, with exact equality
throughout:

- ``VoteCoalescer``: the same seeded sequence of ``add``, ``flush``,
  ``due`` and ``extract`` calls seals byte-identical ``OP_VOTE_BATCH``
  frames (and equal metadata) in both packages, at 3 seeds;
- the sticky sampled fan-out: for the same seed and peer order, a
  ``GossipNode`` of either package draws the same sample for every session;
- a port ``GossipNode`` fans the same chains out to a JAX server and a port
  server: equal delivery counts, equal per-row statuses of a mixed frame,
  equal results and state fingerprints;
- a JAX ``GossipNode`` owning a JAX engine drives port servers with
  ``fanout=2`` plus anti-entropy, and every port server lands on the
  fingerprint of its twin in an all-JAX fabric driven alike (sessions
  failed at the P2P round cap included: anti-entropy carries a chain, not
  a failure, in both packages; pinned below).

The JAX side never runs in this process: ``python
tests/test_torch_gossip_wire.py --reference MODE ...`` runs it on the JAX
CPU backend and prints JSON (``serve`` keeps a JAX server up until its
stdin closes).
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
SEEDS = [5, 17, 29]
PORT_PKG = "hashgraph_tpu_torch"
REF_PKG = "hashgraph_tpu"
KEY = b"\x14" * 32
SCOPES = ("g", "p")  # the second on the P2P preset
FABRIC_SESSIONS = 8  # half a scope
VOTERS = 64
CHUNK = 16


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _subprocess_env() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def reference(*args, timeout=300):
    proc = subprocess.run([sys.executable, __file__, "--reference", *map(str, args)],
                          capture_output=True, text=True, timeout=timeout, cwd=str(REPO),
                          env=_subprocess_env())
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ── the coalescer ──────────────────────────────────────────────────────


def coalescer_frames(pkg: str, seed: int) -> list:
    """Every frame a coalescer seals over a seeded call sequence, as hex
    bytes with its metadata, plus what ``due`` and ``extract`` return."""
    coalescer = _mod(pkg, "gossip.coalescer")
    rng = random.Random(seed)
    clock = [0.0]
    c = coalescer.VoteCoalescer(flush_votes=rng.randint(4, 24),
                                flush_bytes=rng.randint(1500, 6000),
                                flush_interval=0.5, clock=lambda: clock[0])
    peers = [("a", 1), ("b", 2), ("c", 3)]
    scopes = ["s0", "s1", "s2", "s3"]

    def frame(ready):
        payload, meta = ready
        return ["frame", b"".join(bytes(seg) for seg in payload).hex(),
                [list(m) for m in meta]]

    out = []
    now = NOW
    for _ in range(400):
        r = rng.random()
        name, peer_id = rng.choice(peers)
        if r < 0.85:
            now += rng.randint(0, 2)
            ready = c.add(name, peer_id, rng.choice(scopes),
                          rng.randbytes(rng.randint(120, 260)), now)
            if ready is not None:
                out.append(frame(ready))
        elif r < 0.93:
            ready = c.flush(name)
            out.append(frame(ready) if ready is not None else ["empty", name])
        elif r < 0.97:
            clock[0] += rng.random() * 0.4
            out.append(["due", c.due(), c.pending(name)])
        else:
            scope = rng.choice(scopes)
            out.append(["extract", [[pid, sc, [v.hex() for v in votes], at]
                                    for pid, sc, votes, at in c.extract(
                                        name, lambda s, scope=scope: s == scope)]])
    for name, _ in peers:
        ready = c.flush(name)
        if ready is not None:
            out.append(frame(ready))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_coalescer_frames_are_byte_identical(seed):
    ours = coalescer_frames(PORT_PKG, seed)
    assert sum(1 for entry in ours if entry[0] == "frame") > 20
    assert ours == reference("coalescer", seed)


# ── the sticky fan-out sample ──────────────────────────────────────────


class _QuietTransport:
    """A transport that connects nowhere and sheds every frame: enough
    for a node to draw its samples."""

    def connect(self, name, host, port):
        pass

    def try_request(self, name, opcode, payload=b""):
        return None

    def stats(self):
        return {}

    def close(self):
        pass


def fanout_samples(pkg: str, seed: int) -> dict:
    node = _mod(pkg, "gossip.node").GossipNode(
        "sampler", transport=_QuietTransport(), fanout=2, seed=seed, flush_votes=10**9)
    try:
        for i in range(6):
            node.add_peer(f"peer{i}", "127.0.0.1", 1, i + 1)
        for k in range(40):
            for _ in range(2):  # a second chunk must reuse the sample
                node.submit_votes(f"s{k % 3}", 1000 + k, [b"vote"], NOW, local=False)
        return {f"{scope}/{pid}": names for (scope, pid), names in node._session_targets.items()}
    finally:
        node.close()


@pytest.mark.parametrize("seed", SEEDS)
def test_sticky_fanout_sample_is_equal(seed):
    ours = fanout_samples(PORT_PKG, seed)
    assert len(ours) == 40 and all(len(names) == 2 for names in ours.values())
    assert len({tuple(names) for names in ours.values()}) > 1
    assert ours == reference("fanout", seed)


# ── fabrics of both packages ───────────────────────────────────────────


def make_server(pkg: str):
    """A started server of ``pkg`` (stub signers) with one keyed peer and
    ``SCOPES[1]`` on the P2P preset; returns (server, peer id)."""
    bridge = _mod(pkg, "bridge")
    options = dict(capacity=64, voter_capacity=VOTERS,
                   signer_factory=_mod(pkg, "signing.stub").StubConsensusSigner)
    if pkg == PORT_PKG:
        options["device"] = "cpu"
    server = bridge.BridgeServer(**options)
    server.start()
    with bridge.BridgeClient(*server.address) as client:
        peer = client.add_peer(KEY)[0]
    server.peer_engine(peer).scope(SCOPES[1]).p2p_preset().initialize()
    return server, peer


def stop_server(pkg: str, server) -> None:
    if pkg == REF_PKG:
        # The JAX server's stop() waits for its accept loop, which only a
        # listener shutdown wakes at once.
        with contextlib.suppress(OSError):
            server._listener.shutdown(socket.SHUT_RDWR)
    server.stop()


def traffic(pkg: str, seed: int):
    """Proposals (half a scope) and their chains of 64 stub-signed votes,
    60% YES, built with seeded ids: the same bytes in both packages."""
    wire, proto = _mod(pkg, "wire"), _mod(pkg, "protocol")
    stub = _mod(pkg, "signing.stub").StubConsensusSigner
    rng = random.Random(seed)
    signers = [stub(b"voter-%d" % i) for i in range(VOTERS)]
    proto.set_id_entropy(lambda: rng.getrandbits(128))
    try:
        sessions = []
        for k in range(FABRIC_SESSIONS):
            proposal = wire.Proposal(
                name=f"f{k}", payload=b"", proposal_id=rng.getrandbits(32),
                proposal_owner=b"owner", expected_voters_count=VOTERS, timestamp=NOW,
                expiration_timestamp=NOW + 3600, liveness_criteria_yes=k % 4 < 2)
            shadow = wire.Proposal.decode(proposal.encode())
            chain = []
            for j in range(VOTERS):
                vote = proto.build_vote(shadow, rng.random() < 0.6, signers[j], NOW + 1)
                shadow.votes.append(vote)
                chain.append(vote.encode())
            sessions.append((SCOPES[k * 2 // FABRIC_SESSIONS], proposal.encode(), chain))
        return sessions
    finally:
        proto.set_id_entropy(None)


def deliver_proposals(pkg, address, peer, sessions):
    with _mod(pkg, "bridge").BridgeClient(*address) as client:
        for scope, blob, _ in sessions:
            client.process_proposal(peer, scope, blob, NOW)


def fingerprint(pkg, address, peer) -> str:
    with _mod(pkg, "bridge").BridgeClient(*address) as client:
        return client.state_fingerprint(peer)


def drive(pkg, node, sessions, local):
    """Every chain in chunks of 16, wave by wave, then a drain."""
    for w in range(VOTERS // CHUNK):
        for scope, blob, chain in sessions:
            node.submit_votes(scope, pid_of(pkg, blob), chain[w * CHUNK:(w + 1) * CHUNK],
                              NOW + 1, local=local)
    return node.drain()


def pid_of(pkg: str, blob: bytes) -> int:
    return _mod(pkg, "wire").Proposal.decode(blob).proposal_id


def mixed_frame(pkg: str, sessions, peer):
    """An OP_VOTE_BATCH payload redelivering the first chunk of every
    chain (duplicates and refused rows), a vote with a damaged hash and a
    vote for an unknown proposal: statuses of every kind but OK."""
    P, wire = _mod(pkg, "bridge.protocol"), _mod(pkg, "wire")
    groups = {}
    for scope, _, chain in sessions:
        groups.setdefault(scope, []).extend(chain[:4])
    damaged = wire.Vote.decode(sessions[0][2][5])
    damaged.vote_hash = bytes(32)
    orphan = wire.Vote.decode(sessions[1][2][0])
    orphan.proposal_id ^= 0x5A5A
    groups[SCOPES[0]] += [damaged.encode(), orphan.encode()]
    return P.encode_vote_batch(NOW + 2, [(peer, scope, rows) for scope, rows in groups.items()])


def test_port_node_fans_out_to_a_jax_and_a_port_server():
    from hashgraph_tpu_torch.bridge import protocol as P
    from hashgraph_tpu_torch.bridge.client import parse_status_list
    from hashgraph_tpu_torch.gossip import GossipNode

    sessions = traffic(PORT_PKG, 3)
    proc = subprocess.Popen([sys.executable, __file__, "--reference", "serve"],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                            cwd=str(REPO), env=_subprocess_env())
    port_server, port_peer = make_server(PORT_PKG)
    node = GossipNode("port-driver", fanout=None, flush_votes=64)
    try:
        line = proc.stdout.readline()
        assert line.startswith("PORT "), line
        _, jax_port, jax_peer = line.split()
        jax_address, jax_peer = ("127.0.0.1", int(jax_port)), int(jax_peer)
        deliver_proposals(PORT_PKG, jax_address, jax_peer, sessions)
        deliver_proposals(PORT_PKG, port_server.address, port_peer, sessions)
        node.add_peer("jax", *jax_address, jax_peer)
        node.add_peer("port", *port_server.address, port_peer)
        report = drive(PORT_PKG, node, sessions, local=False)
        assert report["failed_frames"] == 0 and report["shed_total"] == 0
        assert report["acked"] + report["rejected"] == 2 * FABRIC_SESSIONS * VOTERS
        assert report["rejected"] % 2 == 0 and report["acked"] % 2 == 0
        statuses = {}
        for name, peer in (("jax", jax_peer), ("port", port_peer)):
            future = node.transport.request(name, P.OP_VOTE_BATCH,
                                            mixed_frame(PORT_PKG, sessions, peer))
            statuses[name] = parse_status_list(future.result(30))
        assert statuses["jax"] == statuses["port"]
        assert len(set(statuses["port"])) >= 3
        assert fingerprint(PORT_PKG, jax_address, jax_peer) == fingerprint(
            PORT_PKG, port_server.address, port_peer)
        results = {}
        for name, address, peer in (("jax", jax_address, jax_peer),
                                    ("port", port_server.address, port_peer)):
            with _mod(PORT_PKG, "bridge").BridgeClient(*address) as client:
                results[name] = [client.get_result(peer, scope, pid_of(PORT_PKG, blob))
                                 for scope, blob, _ in sessions[:FABRIC_SESSIONS // 2]]
        assert results["jax"] == results["port"]
    finally:
        node.close()
        stop_server(PORT_PKG, port_server)
        proc.stdin.close()
        proc.wait(timeout=60)


def fabric(pkg: str, peers_pkg: str, addresses=None) -> dict:
    """A ``GossipNode`` of ``pkg`` owning a ``pkg`` server's engine fans the
    traffic out with ``fanout=2`` to three servers (of ``peers_pkg``,
    started here, or the running ones at ``addresses``), then runs
    anti-entropy until a round repairs nothing. Returns every server's
    fingerprint (the node's own first)."""
    gossip = _mod(pkg, "gossip")
    sessions = traffic(pkg, 11)
    own, own_peer = make_server(pkg)
    started = []
    if addresses is None:
        started = [make_server(peers_pkg) for _ in range(3)]
        addresses = [(srv.address, peer) for srv, peer in started]
    node = gossip.GossipNode("fabric", engine=own.peer_engine(own_peer), fanout=2, seed=14)
    try:
        for address, peer in [(own.address, own_peer)] + addresses:
            deliver_proposals(pkg, address, peer, sessions)
        for i, (address, peer) in enumerate(addresses):
            node.add_peer(f"peer{i}", *address, peer)
        drive(pkg, node, sessions, local=True)
        rounds = []
        while len(rounds) < 6:
            rounds.append(node.anti_entropy(NOW + 1, max_sessions=64)["created_or_extended"])
            if not rounds[-1]:
                break
        prints = [fingerprint(pkg, address, peer)
                  for address, peer in [(own.address, own_peer)] + addresses]
        return {"fingerprints": prints, "rounds": rounds}
    finally:
        node.close()
        stop_server(pkg, own)
        for srv, _ in started:
            stop_server(peers_pkg, srv)


def test_jax_node_drives_port_servers_like_a_jax_fabric():
    servers = [make_server(PORT_PKG) for _ in range(3)]
    try:
        addresses = ";".join(f"{srv.address[0]}:{srv.address[1]}:{peer}" for srv, peer in servers)
        out = reference("fabric", addresses, timeout=600)
    finally:
        for srv, _ in servers:
            stop_server(PORT_PKG, srv)
    mixed, jax_only = out["mixed"], out["jax"]
    assert mixed["rounds"] == jax_only["rounds"] and mixed["rounds"][0] > 0
    assert mixed["fingerprints"] == jax_only["fingerprints"]
    # The all-port fabric lands on the same fingerprints too.
    assert fabric(PORT_PKG, PORT_PKG) == jax_only


# ── pinned: anti-entropy carries a chain, not a round-cap failure ──────


def round_cap_repair(pkg: str) -> dict:
    """The smallest input: a P2P proposal of 5 voters takes YES, NO, YES,
    NO, YES on a node's own engine (the fifth vote passes the round cap and
    fails the session), then one anti-entropy round pushes the session to a
    peer that holds the proposal alone."""
    gossip, wire, proto = _mod(pkg, "gossip"), _mod(pkg, "wire"), _mod(pkg, "protocol")
    stub = _mod(pkg, "signing.stub").StubConsensusSigner
    own, own_peer = make_server(pkg)
    other, other_peer = make_server(pkg)
    rng = random.Random(1)
    proto.set_id_entropy(lambda: rng.getrandbits(128))
    node = gossip.GossipNode("pinned", engine=own.peer_engine(own_peer), fanout=None)
    try:
        proposal = wire.Proposal(
            name="cap", payload=b"", proposal_id=77, proposal_owner=b"owner",
            expected_voters_count=5, timestamp=NOW, expiration_timestamp=NOW + 3600,
            liveness_criteria_yes=True)
        shadow = wire.Proposal.decode(proposal.encode())
        chain = []
        for j, value in enumerate((True, False, True, False, True)):
            vote = proto.build_vote(shadow, value, stub(b"v%d" % j), NOW + 1)
            shadow.votes.append(vote)
            chain.append(vote.encode())
        for address, peer in ((own.address, own_peer), (other.address, other_peer)):
            deliver_proposals(pkg, address, peer, [(SCOPES[1], proposal.encode(), chain)])
        node.add_peer("other", *other.address, other_peer)
        statuses = [int(s) for s in node._apply_local(SCOPES[1], chain, NOW + 1)]
        node.note_session(SCOPES[1], 77)
        pushed = node.anti_entropy(NOW + 1)["created_or_extended"]
        states = []
        for engine in (own.peer_engine(own_peer), other.peer_engine(other_peer)):
            session = engine.export_session(SCOPES[1], 77)
            states.append([session.state.kind.value, len(session.proposal.votes),
                           session.proposal.encode().hex()])
        return {"statuses": statuses, "pushed": pushed, "states": states}
    finally:
        proto.set_id_entropy(None)
        node.close()
        stop_server(pkg, own)
        stop_server(pkg, other)


def test_pinned_fault_anti_entropy_cannot_carry_a_round_cap_failure():
    """The JAX package's ``GossipNode._push_to_peer`` delivers a session's
    proposal with its retained chain, and a session failed at the P2P round
    cap keeps only its accepted votes: a peer repaired from it holds the
    same chain ACTIVE while the source holds it FAILED, and no later round
    changes that. So a sampled fabric with round-cap failures never reaches
    fingerprint equality. The port keeps the reference's behaviour; both
    packages are held to it, the JAX one in a subprocess."""
    from hashgraph_tpu_torch.errors import StatusCode

    ours = round_cap_repair(PORT_PKG)
    assert ours["statuses"][-1] == int(StatusCode.MAX_ROUNDS_EXCEEDED)
    (own_state, own_len, own_chain), (other_state, other_len, other_chain) = ours["states"]
    assert (own_state, other_state) == ("failed", "active")
    assert own_len == other_len == 4 and own_chain == other_chain and ours["pushed"] == 1
    assert ours == reference("round-cap")


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    mode, args = sys.argv[2], sys.argv[3:]
    if mode == "coalescer":
        print(json.dumps(coalescer_frames(REF_PKG, int(args[0]))))
    elif mode == "fanout":
        print(json.dumps(fanout_samples(REF_PKG, int(args[0]))))
    elif mode == "round-cap":
        print(json.dumps(round_cap_repair(REF_PKG)))
    elif mode == "serve":
        srv, peer = make_server(REF_PKG)
        print("PORT", srv.address[1], peer, flush=True)
        sys.stdin.read()
        stop_server(REF_PKG, srv)
    elif mode == "fabric":
        addresses = []
        for item in args[0].split(";"):
            host, port, peer = item.split(":")
            addresses.append(((host, int(port)), int(peer)))
        print(json.dumps({"mixed": fabric(REF_PKG, PORT_PKG, addresses),
                          "jax": fabric(REF_PKG, REF_PKG)}))
