"""Cross-package gates for the port's bridge: the port's ``BridgeServer``
answers the JAX package's wire byte for byte, and the clients of either
package are interchangeable against the other package's server.

- **The scripted conversation.** One raw TCP connection drives a port
  server (``device="cpu"``) through a conversation built from each
  server reply: keyed ``ADD_PEER``, proposals with and without trace
  suffixes, scalar and batch votes, ``OP_VOTE_BATCH`` frames (canonical,
  multi-peer, with bad rows, with a non-canonical row that takes the
  object path, malformed), timeouts, ``DELIVER_PROPOSALS``, events
  (bounded and not), results, stats, explain, fingerprints, fleet
  tallies and the error statuses. The recorded request bytes are then
  replayed to a JAX server, and to a port server with the apply reactor
  on. Every reply frame must be byte-identical, except those of
  ``OP_HEALTH``, ``GET_METRICS``, ``OP_METRICS_PULL`` and ``OP_PROFILE``,
  which carry wall times or process-wide counts: for them the JSON keys
  and the clock-free fields are compared. ``OP_EXPLAIN`` replies are
  compared byte for byte as JSON but for the two wall-clock latencies of
  their timeline, whose presence is kept. Servers of both packages mint
  proposal, vote and trace ids from the same seed (``set_id_entropy`` and
  the trace module's id generator).
- **Clients.** The JAX client, in a subprocess, runs the quick-start and
  a pipelined ``OP_VOTE_BATCH`` against the port server; the port client
  runs the same scenario against a JAX server; the two summaries must be
  equal. A JAX ``GossipNode`` with ``shm_ring_bytes`` set, in a
  subprocess, lands a vote batch on the port server over the shm lane.
- **Twins** of ``tests/test_wire_columnar.py``'s ``TestServerPathParity``
  (columnar against object path, embedded) and
  ``TestShmTransportEndToEnd``, on the port alone; the rings are attached
  by hand through the port's ``ShmRing`` where the JAX test used a
  ``GossipNode`` or a ``GossipTransport``.

The JAX side never runs in this process: its servers and clients run in
``python tests/test_torch_bridge_wire.py --reference-server`` (serving one
seeded server at a time on request from stdin) and ``--reference-client
SCENARIO ...``, on the JAX CPU backend.
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
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
NOW = 1_700_000_000
SEEDS = [5, 17, 29]
PORT_PKG = "hashgraph_tpu_torch"
REF_PKG = "hashgraph_tpu"


def _mods(pkg: str):
    """The bridge-facing modules of one package, imported lazily (the JAX
    package is imported only in the subprocess)."""
    names = {
        "P": "bridge.protocol",
        "server": "bridge.server",
        "client": "bridge.client",
        "proto": "protocol",
        "trace": "obs.trace",
        "signing": "signing",
        "wire": "wire",
        "snapshot": "sync.snapshot",
    }
    return type("Mods", (), {
        k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()
    })


@contextlib.contextmanager
def seeded_server(pkg: str, seed: int, **kwargs):
    """A started ``BridgeServer`` of ``pkg`` with stub-signed peers whose
    proposal, vote and trace ids come from ``seed``: servers of both
    packages given the same requests mint the same ids."""
    m = _mods(pkg)
    ids = random.Random(seed)
    saved = m.trace._ID_RNG.getstate()
    m.trace._ID_RNG.seed(seed)
    m.proto.set_id_entropy(lambda: ids.getrandbits(128))
    options = dict(capacity=64, voter_capacity=16,
                   signer_factory=m.signing.StubConsensusSigner)
    options.update(kwargs)
    if pkg == PORT_PKG:
        options["device"] = "cpu"
    server = m.server.BridgeServer(**options)
    server.start()
    try:
        yield server
    finally:
        server.stop()
        m.proto.set_id_entropy(None)
        m.trace._ID_RNG.setstate(saved)


@contextlib.contextmanager
def entropy(proto, rng: random.Random):
    """Swap the id source for client-side building between server calls."""
    saved = proto._id_entropy
    proto.set_id_entropy(lambda: rng.getrandbits(128))
    try:
        yield
    finally:
        proto.set_id_entropy(saved)


# ── the JAX side, in a subprocess ──────────────────────────────────────


def _subprocess_env() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    return env


class ReferenceServers:
    """A JAX interpreter that serves one seeded JAX ``BridgeServer`` at a
    time: ``serve(seed)`` stops the previous one and returns the new
    one's address."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, __file__, "--reference-server"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=str(REPO), env=_subprocess_env(),
        )

    def serve(self, seed: int) -> tuple[str, int]:
        self.proc.stdin.write(f"SERVE {seed}\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        assert line.startswith("PORT "), line
        return "127.0.0.1", int(line.split()[1])

    def close(self) -> None:
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=30)
        except Exception:  # pragma: no cover - last-resort cleanup
            self.proc.kill()


@pytest.fixture(scope="module")
def reference_servers():
    servers = ReferenceServers()
    yield servers
    servers.close()


def reference_client(*args, timeout=300) -> dict:
    proc = subprocess.run(
        [sys.executable, __file__, "--reference-client", *map(str, args)],
        capture_output=True, text=True, timeout=timeout, cwd=str(REPO),
        env=_subprocess_env(),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ── the scripted conversation ──────────────────────────────────────────


class Wire:
    """One plain (untagged) TCP connection that records every exchange."""

    def __init__(self, P, address):
        self.P = P
        self.sock = socket.create_connection(address, timeout=120)
        self.log: list[tuple[int, bytes, int, bytes]] = []

    def call(self, opcode: int, payload: bytes = b"") -> tuple[int, bytes]:
        P = self.P
        self.sock.sendall(P.encode_frame(opcode, payload))
        status, cursor = P.read_frame(self.sock)
        body = cursor.raw(cursor.remaining())
        self.log.append((opcode, payload, status, body))
        return status, body

    def ok(self, opcode: int, payload: bytes = b""):
        status, body = self.call(opcode, payload)
        assert status == self.P.STATUS_OK, (opcode, status, body[:120])
        return self.P.Cursor(body)

    def close(self) -> None:
        self.sock.close()


def _chain(m, proposal, signers, values, now):
    out = []
    for signer, value in zip(signers, values):
        vote = m.proto.build_vote(proposal, value, signer, now)
        proposal.votes.append(vote)
        out.append(vote.encode())
    return out


def conversation(wire: Wire, seed: int) -> None:
    """Drive one server through the scripted conversation, each request
    built from the replies before it (port modules build the client-side
    votes and proposals, with ids of their own seed)."""
    m = _mods(PORT_PKG)
    P, Proposal, Vote = m.P, m.wire.Proposal, m.wire.Vote
    Stub = m.signing.StubConsensusSigner
    rng = random.Random(seed)
    crng = random.Random(seed + 7919)
    call, ok = wire.call, wire.ok

    def create(peer, scope, n, liveness=True, now=NOW, suffix=b""):
        c = ok(P.OP_CREATE_PROPOSAL, P.u32(peer) + P.string(scope) + P.u64(now)
               + P.string(f"p-{scope}") + P.blob(crng.randbytes(8)) + P.u32(n)
               + P.u64(600) + P.u8(liveness) + suffix)
        return c.u32(), c.blob()

    ok(P.OP_PING)
    ok(P.OP_HELLO, P.u32(P.PROTOCOL_VERSION) + P.u32(
        P.FEATURE_VOTE_BATCH | P.FEATURE_DELIVER | P.FEATURE_EVENT_BOUND))
    peers = [ok(P.OP_ADD_PEER, P.u8(32) + crng.randbytes(32)).u32() for _ in range(3)]
    A, B, C = peers
    call(P.OP_ADD_PEER, P.u8(5) + b"short")

    # 1. The quick-start: A proposes (with a trace suffix), B and C vote.
    s1 = f"qs-{seed}"
    ctx = m.trace.TraceContext.from_wire(crng.randbytes(P.TRACE_WIRE_BYTES))
    p1, _ = create(A, s1, rng.randint(3, 5), suffix=P.encode_trace_context(ctx))
    ok(P.OP_CAST_VOTE, P.u32(A) + P.string(s1) + P.u32(p1) + P.u8(1) + P.u64(NOW + 1))
    blob1 = ok(P.OP_GET_PROPOSAL, P.u32(A) + P.string(s1) + P.u32(p1)).blob()
    for peer in (B, C):
        ok(P.OP_PROCESS_PROPOSAL, P.u32(peer) + P.string(s1) + P.u64(NOW + 2)
           + P.blob(blob1) + P.encode_trace_context(ctx))
    for i, voter in enumerate((B, C)):
        vote = ok(P.OP_CAST_VOTE, P.u32(voter) + P.string(s1) + P.u32(p1)
                  + P.u8(rng.random() < 0.8) + P.u64(NOW + 3 + i)).blob()
        for other in peers:
            if other != voter:
                call(P.OP_PROCESS_VOTE, P.u32(other) + P.string(s1)
                     + P.u64(NOW + 4 + i) + P.blob(vote))
    call(P.OP_CAST_VOTE, P.u32(A) + P.string(s1) + P.u32(p1) + P.u8(1) + P.u64(NOW + 9))
    for peer in peers:
        call(P.OP_GET_RESULT, P.u32(peer) + P.string(s1) + P.u32(p1))
    call(P.OP_POLL_EVENTS, P.u32(A))
    call(P.OP_POLL_EVENTS, P.u32(B) + P.u32(1))
    call(P.OP_POLL_EVENTS, P.u32(B) + P.u32(1))

    # 2. OP_PROCESS_VOTES with a duplicate, an unknown session and junk.
    s2 = f"batch-{seed}"
    p2, blob2 = create(A, s2, rng.randint(6, 10), liveness=rng.random() < 0.5)
    proposal2 = Proposal.decode(blob2)
    with entropy(m.proto, crng):
        rows2 = _chain(m, proposal2, [Stub(crng.randbytes(20)) for _ in range(4)],
                       [rng.random() < 0.7 for _ in range(4)], NOW + 5)
    unknown = Vote.decode(rows2[0])
    unknown.proposal_id = (p2 + 1) & 0xFFFFFFFF
    batch = [rows2[0], rows2[0], unknown.encode(), b"\xff\xff junk"] + rows2[1:]
    call(P.OP_PROCESS_VOTES, P.u32(A) + P.string(s2) + P.u64(NOW + 6)
         + P.u32(len(batch)) + b"".join(P.blob(v) for v in batch)
         + P.encode_trace_context(ctx))

    # 3. OP_VOTE_BATCH: a peer's proposal from outside, multi-peer and
    #    single-peer canonical frames, bad rows on both paths, malformed.
    s3 = f"wire-{seed}"
    proposal3 = Proposal(
        name="wire", payload=b"w", proposal_id=crng.randint(1, 2**32 - 1),
        proposal_owner=b"\x11" * 20, expected_voters_count=rng.randint(12, 16),
        timestamp=NOW, expiration_timestamp=NOW + 3_600,
        liveness_criteria_yes=True,
    )
    for peer in (A, B):
        ok(P.OP_PROCESS_PROPOSAL, P.u32(peer) + P.string(s3) + P.u64(NOW)
           + P.blob(proposal3.encode()))
    with entropy(m.proto, crng):
        rows3 = _chain(m, proposal3, [Stub(crng.randbytes(20)) for _ in range(9)],
                       [rng.random() < 0.6 for _ in range(9)], NOW + 1)
    vb = P.OP_VOTE_BATCH
    call(vb, P.encode_vote_batch(NOW + 1, [(A, s3, rows3[:3]), (B, s3, rows3[:3])]))
    call(vb, P.encode_vote_batch(NOW + 1, [(A, s3, rows3[3:6])]))
    flipped = bytearray(rows3[6])
    flipped[-1] ^= 0xFF
    call(vb, P.encode_vote_batch(NOW + 2, [(B, s3, [bytes(flipped), rows3[1], rows3[7]])]))
    call(vb, P.encode_vote_batch(NOW + 2, [(A, s3, [
        bytes(flipped), rows3[0], rows3[7][:9], crng.randbytes(40), rows3[7]])]))
    call(vb, P.encode_vote_batch(NOW + 2, [(999, s3, rows3[:1]), (A, "nope", rows3[:1])]))
    good = P.encode_vote_batch(NOW + 2, [(A, s3, rows3[8:])])
    call(vb, good[:6])
    call(vb, good[:-1])
    call(vb, good)

    # 4. Timeouts: liveness-decided or failed, and undecidable.
    s4 = f"timeout-{seed}"
    p4, _ = create(C, s4, 4, liveness=rng.random() < 0.5)
    ok(P.OP_CAST_VOTE, P.u32(C) + P.string(s4) + P.u32(p4) + P.u8(1) + P.u64(NOW + 1))
    call(P.OP_HANDLE_TIMEOUT, P.u32(C) + P.string(s4) + P.u32(p4) + P.u64(NOW + 700))
    p5, _ = create(C, s4, 2)
    call(P.OP_HANDLE_TIMEOUT, P.u32(C) + P.string(s4) + P.u32(p5) + P.u64(NOW + 700)
         + P.encode_trace_context(ctx))
    for pid in (p4, p5):
        call(P.OP_GET_RESULT, P.u32(C) + P.string(s4) + P.u32(pid))
    call(P.OP_POLL_EVENTS, P.u32(C) + P.u32(100))

    # 5. Anti-entropy delivery: new, redelivered, extended, junk.
    part = Proposal.decode(proposal3.encode())
    part.votes = part.votes[:5]
    items = [(s3, part.encode()), (s2, proposal2.encode())]
    call(P.OP_DELIVER_PROPOSALS, P.encode_deliver_proposals(C, items, NOW + 3))
    call(P.OP_DELIVER_PROPOSALS, P.encode_deliver_proposals(C, items, NOW + 3))
    call(P.OP_DELIVER_PROPOSALS, P.encode_deliver_proposals(
        C, [(s3, proposal3.encode()), (s3, b"\x01junk")], NOW + 4))

    # 6. Reads: results, proposals, stats, explain, fingerprints, tallies.
    for peer in peers:
        for scope, pid in ((s1, p1), (s2, p2), (s3, proposal3.proposal_id)):
            call(P.OP_GET_RESULT, P.u32(peer) + P.string(scope) + P.u32(pid))
            call(P.OP_GET_PROPOSAL, P.u32(peer) + P.string(scope) + P.u32(pid))
            call(P.OP_EXPLAIN, P.u32(peer) + P.string(scope) + P.u32(pid))
        for scope in (s1, s2, s3, s4, "none"):
            call(P.OP_GET_STATS, P.u32(peer) + P.string(scope))
        call(P.OP_STATE_FINGERPRINT, P.u32(peer))
        call(P.OP_FLEET_TALLY, P.u32(peer))
        call(P.OP_POLL_EVENTS, P.u32(peer))
    call(P.OP_SYNC_MANIFEST, P.u32(A) + P.u32(0))

    # 7. Bridge-level errors.
    call(P.OP_GET_RESULT, P.u32(999_999) + P.string(s1) + P.u32(p1))
    call(137)
    call(P.OP_CREATE_PROPOSAL, P.u32(A))
    call(P.OP_EXPLAIN, P.u32(A) + P.string(s1) + P.u32(p1 ^ 0x5A5A))

    # 8. The clock-bearing replies (compared by keys and clock-free fields).
    call(P.OP_HEALTH, P.u32(A) + P.u64(NOW + 10))
    call(P.OP_HEALTH, P.u32(B) + P.u64(0))
    call(P.OP_GET_METRICS)
    call(P.OP_METRICS_PULL)
    call(P.OP_PROFILE)
    ok(P.OP_PING)


def replay(P, address, log) -> list[tuple[int, bytes]]:
    wire = Wire(P, address)
    try:
        return [wire.call(opcode, payload) for opcode, payload, _, _ in log]
    finally:
        wire.close()


def _keys(value):
    """The shape of a JSON value: dict keys (recursively), list lengths
    left out."""
    if isinstance(value, dict):
        return {k: _keys(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_keys(v) for v in value[:1]]
    return type(value).__name__


# The explain timeline's two latencies are wall-clock durations
# (``time.monotonic`` between creation, first vote and decision): masked,
# their presence kept.
_WALL_LATENCIES = ("first_vote_latency_s", "decision_latency_s")


def _explain_masked(P, body: bytes) -> str:
    verdict = json.loads(P.Cursor(body).blob())
    timeline = verdict.get("timeline") or {}
    for key in _WALL_LATENCIES:
        if timeline.get(key) is not None:
            timeline[key] = "wall"
    return json.dumps(verdict)


def assert_clock_bearing_equal(P, opcode, ours, theirs):
    """The four clock-bearing replies: same status; health snapshots equal
    as JSON; the metrics text serves every family the JAX server does but
    its ``hashgraph_jax_*`` ones; the metrics and profile pulls have the
    same keys (their values are process-wide counts and wall times)."""
    assert ours[0] == theirs[0] == P.STATUS_OK, (opcode, ours[0], theirs[0])
    a, b = P.Cursor(ours[1]).blob(), P.Cursor(theirs[1]).blob()
    if opcode == P.OP_GET_METRICS:
        def families(text):
            return {line.split()[2] for line in text.decode().splitlines()
                    if line.startswith("# TYPE ")}

        reference = {f for f in families(b) if not f.startswith("hashgraph_jax_")}
        assert len(reference) > 20 and reference <= families(a), reference - families(a)
        return
    ja, jb = json.loads(a), json.loads(b)
    if opcode == P.OP_HEALTH:
        assert ja == jb
        return
    assert ja.keys() == jb.keys()
    if opcode == P.OP_PROFILE:
        # Sample roles depend on which profilers this process ran before.
        ours_p, theirs_p = ja["profile"], jb["profile"]
        assert ours_p.keys() == theirs_p.keys()
        assert _keys(ours_p["stages"]) == _keys(theirs_p["stages"])
        assert _keys(ours_p["device"]) == _keys(theirs_p["device"])
    else:
        assert ja["state"].keys() == jb["state"].keys()
        # The SLO engine is process-wide: this process's holds every
        # scope its other tests made, the reference's only this file's.
        ours_scopes, theirs_scopes = ja["slo"].pop("scopes"), jb["slo"].pop("scopes")
        assert _keys(ja["slo"]) == _keys(jb["slo"])
        assert theirs_scopes and theirs_scopes.keys() <= ours_scopes.keys()
        for scope, entry in theirs_scopes.items():
            assert _keys(ours_scopes[scope]) == _keys(entry), scope


def assert_replies_equal(P, log, replies, label):
    clock = {P.OP_HEALTH, P.OP_GET_METRICS, P.OP_METRICS_PULL, P.OP_PROFILE}
    assert len(replies) == len(log)
    for i, ((opcode, _payload, status, body), theirs) in enumerate(zip(log, replies)):
        if opcode in clock:
            assert_clock_bearing_equal(P, opcode, (status, body), theirs)
            continue
        if opcode == P.OP_EXPLAIN and status == theirs[0] == P.STATUS_OK:
            assert _explain_masked(P, body) == _explain_masked(P, theirs[1]), (
                f"{label}: explain reply {i} differs")
            continue
        assert (status, body) == theirs, (
            f"{label}: reply {i} (opcode {opcode}) differs: "
            f"{(status, body[:200])} != {(theirs[0], theirs[1][:200])}"
        )


@pytest.mark.parametrize("seed", SEEDS)
def test_conversation_replies_are_byte_identical(seed, reference_servers):
    P = _mods(PORT_PKG).P
    with seeded_server(PORT_PKG, seed) as server:
        wire = Wire(P, server.address)
        try:
            conversation(wire, seed)
        finally:
            wire.close()
    log = wire.log
    statuses = {status for _, _, status, _ in log}
    # The conversation reaches the success and the error contracts.
    assert {P.STATUS_OK, P.STATUS_BAD_REQUEST, P.STATUS_UNKNOWN_PEER,
            P.STATUS_UNKNOWN_OPCODE} <= statuses, statuses
    assert len(statuses) >= 7, statuses
    assert_replies_equal(P, log, replay(P, reference_servers.serve(seed), log), "JAX server")
    with seeded_server(PORT_PKG, seed, apply_reactor=True) as server:
        assert server.reactor is not None
        assert_replies_equal(P, log, replay(P, server.address, log), "reactor on")


# ── clients against the other package's server ────────────────────────


def client_scenario(pkg: str, host: str, port: int, seed: int) -> dict:
    """The quick-start through ``BridgeClient`` (keyed peers), then a
    pipelined ``OP_VOTE_BATCH`` through ``PipelinedBridgeClient``; returns
    what the server answered."""
    m = _mods(pkg)
    P = m.P
    rng = random.Random(seed)
    out: dict = {}
    with m.client.BridgeClient(host, port) as cl:
        peers = [cl.add_peer(rng.randbytes(32)) for _ in range(3)]
        out["identities"] = [identity.hex() for _, identity in peers]
        peers = [peer for peer, _ in peers]
        pid, blob = cl.create_proposal(peers[0], "qs", NOW, "upgrade", b"ship", 3, 600)
        out["proposal"] = blob.hex()
        cl.cast_vote(peers[0], "qs", pid, True, NOW + 1)
        proposal = cl.get_proposal(peers[0], "qs", pid)
        for peer in peers[1:]:
            cl.process_proposal(peer, "qs", proposal, NOW + 2)
        votes = []
        for i, voter in enumerate(peers[1:], start=1):
            vote = cl.cast_vote(voter, "qs", pid, True, NOW + 2 + i)
            votes.append(vote.hex())
            for other in peers:
                if other != voter:
                    try:
                        cl.process_vote(other, "qs", vote, NOW + 3 + i)
                    except m.client.BridgeError as exc:
                        votes.append(exc.status)
        out["votes"] = votes
        out["results"] = [cl.get_result(peer, "qs", pid) for peer in peers]
        out["events"] = [
            [(e.kind, e.proposal_id, e.result, e.timestamp) for e in cl.poll_events(peer)]
            for peer in peers
        ]
        out["explain_status"] = cl.explain(peers[0], "qs", pid)["status"]
        out["fingerprints"] = [cl.state_fingerprint(peer) for peer in peers]
        out["tally"] = sorted(cl.fleet_tally(peers[0]).items())
    with m.client.PipelinedBridgeClient(host, port) as pc:
        out["features"] = pc.features
        peer, _ = pc.add_peer(rng.randbytes(32))
        pid, blob = pc.create_proposal(peer, "pipe", NOW, "batch", b"", 20, 600)
        proposal = m.wire.Proposal.decode(blob)
        ids = random.Random(seed + 1)
        with entropy(m.proto, ids):
            rows = _chain(m, proposal, [m.signing.StubConsensusSigner(bytes([i]) * 20)
                                        for i in range(1, 17)], [True] * 16, NOW + 1)
        futures = [pc.vote_batch_async(NOW + 1, [(peer, "pipe", rows[i:i + 4])])
                   for i in range(0, 16, 4)]
        futures.append(pc.ping_async())
        out["batch"] = [f.result(60) for f in futures]
    with m.client.BridgeClient(host, port) as cl:
        out["batch_fingerprint"] = cl.state_fingerprint(peer)
    return out


def test_port_client_against_jax_server_equals_jax_client_against_port_server(
    reference_servers,
):
    seed = 41
    address = reference_servers.serve(seed)
    ours = client_scenario(PORT_PKG, *address, seed)
    with seeded_server(PORT_PKG, seed) as server:
        theirs = reference_client("scenario", *server.address, seed)
    ours = json.loads(json.dumps(ours))
    assert ours == theirs
    P = _mods(PORT_PKG).P
    assert ours["results"] == [True, True, True]
    assert all(any(e[0] == P.EVENT_REACHED and e[2] for e in ev) for ev in ours["events"])
    assert ours["features"] == P.SUPPORTED_FEATURES
    assert ours["batch"][-1] == P.PROTOCOL_VERSION
    assert set(sum(ours["batch"][:-1], [])) <= {0, 28}


def test_jax_gossip_node_lands_a_vote_batch_over_the_shm_lane():
    m = _mods(PORT_PKG)
    if not importlib.import_module(f"{PORT_PKG}.gossip.shm").shm_available():
        pytest.skip("shared memory unavailable")
    from hashgraph_tpu_torch.obs import SHM_RINGS_ATTACHED_TOTAL, registry

    with seeded_server(PORT_PKG, 3) as server:
        before = registry.counter(SHM_RINGS_ATTACHED_TOTAL).value
        with m.client.BridgeClient(*server.address) as client:
            peer, _ = client.add_peer(b"\x33" * 32)
            pid, blob = client.create_proposal(peer, "s", NOW, "p", b"x", 17, 3_600)
            report = reference_client("gossip", *server.address, peer, pid, blob.hex())
            assert report["shm"] is True
            assert report["acked"] == 16 and report["failed_frames"] == 0
            assert client.get_stats(peer, "s") == (1, 0, 0, 1)
            assert client.get_result(peer, "s", pid) is True
        assert registry.counter(SHM_RINGS_ATTACHED_TOTAL).value == before + 1


# ── twin: columnar against object path on the port ─────────────────────


class _Harness:
    """Two embedded port servers fed IDENTICAL frames: wire_columnar on
    and off. Every dispatch asserts byte-identical responses."""

    def __init__(self):
        m = _mods(PORT_PKG)
        self.m, P = m, m.P
        self.servers = [
            m.server.BridgeServer(
                signer_factory=m.signing.StubConsensusSigner, capacity=64,
                voter_capacity=24, wire_columnar=columnar, device="cpu",
            )
            for columnar in (True, False)
        ]
        for server in self.servers:
            server.start_embedded()
        status, body = self.both_raw(P.OP_ADD_PEER, P.u8(32) + b"\x11" * 32)
        assert status == P.STATUS_OK
        self.peer_ids = [P.Cursor(body).u32()]

    def both_raw(self, opcode, payload):
        sc, oc = (server.dispatch_frame(opcode, payload) for server in self.servers)
        assert sc == oc, f"parity break on opcode {opcode}: {sc} != {oc}"
        return sc

    def deliver_proposal(self, scope, proposal):
        P = self.m.P
        status, _ = self.both_raw(
            P.OP_PROCESS_PROPOSAL,
            P.u32(self.peer_ids[0]) + P.string(scope) + P.u64(NOW)
            + P.blob(proposal.encode()),
        )
        assert status == P.STATUS_OK

    def fingerprints_equal(self) -> bool:
        fp = self.m.snapshot.state_fingerprint
        a, b = (fp(server.peer_engine(self.peer_ids[0])) for server in self.servers)
        return a == b

    def stop(self):
        for server in self.servers:
            server.stop()


@pytest.fixture(scope="module")
def harness():
    h = _Harness()
    yield h
    h.stop()


def _proposal(m, tag: str, voters: int = 20):
    return m.wire.Proposal(
        name=f"p-{tag}", payload=b"x",
        proposal_id=int.from_bytes(tag.encode()[:3].ljust(3, b"\0"), "big") + 1,
        proposal_owner=b"\x11" * 20, expected_voters_count=voters,
        timestamp=NOW, expiration_timestamp=NOW + 3_600,
        liveness_criteria_yes=True,
    )


def _signed(m, proposal, signers, value=True):
    return _chain(m, proposal, signers, [value] * len(signers), NOW + 1)


def _batch(h, scope, rows, now=NOW + 1):
    P = h.m.P
    return h.both_raw(P.OP_VOTE_BATCH, P.encode_vote_batch(now, [(h.peer_ids[0], scope, rows)]))


def _codes(P, body):
    c = P.Cursor(body)
    return list(c.raw(c.u32()))


class TestServerPathParity:
    def test_valid_chain_and_decision(self, harness):
        m = harness.m
        proposal = _proposal(m, "valid", voters=5)
        harness.deliver_proposal("valid", proposal)
        rows = _signed(m, proposal, [m.signing.StubConsensusSigner(bytes([i]) * 20)
                                     for i in range(1, 7)])
        status, body = _batch(harness, "valid", rows)
        assert status == m.P.STATUS_OK
        assert len(_codes(m.P, body)) == 6
        assert harness.fingerprints_equal()

    def test_mixed_bad_rows_duplicates_and_junk(self, harness):
        m = harness.m
        proposal = _proposal(m, "mixed")
        harness.deliver_proposal("mixed", proposal)
        rows = _signed(m, proposal, [m.signing.StubConsensusSigner(bytes([40 + i]) * 20)
                                     for i in range(6)])
        _batch(harness, "mixed", rows[:4])
        flipped = bytearray(rows[4])
        flipped[-1] ^= 0xFF
        follow_up = [bytes(flipped), rows[0], rows[4][:9], os.urandom(40), rows[5]]
        status, body = _batch(harness, "mixed", follow_up)
        assert status == m.P.STATUS_OK
        assert harness.fingerprints_equal()

    def test_cross_frame_dangling_guard_stays_armed(self, harness):
        m = harness.m
        P, SC = m.P, importlib.import_module(f"{PORT_PKG}.errors").StatusCode
        proposal = _proposal(m, "dangle")
        harness.deliver_proposal("dangle", proposal)
        rows = _signed(m, proposal, [m.signing.StubConsensusSigner(bytes([80 + i]) * 20)
                                     for i in range(9)])
        _batch(harness, "dangle", rows[:3])
        status, body = _batch(harness, "dangle", rows[6:])
        assert _codes(P, body) == [int(SC.RECEIVED_HASH_MISMATCH)] * 3
        assert harness.fingerprints_equal()
        status, body = harness.both_raw(
            P.OP_DELIVER_PROPOSALS,
            P.encode_deliver_proposals(harness.peer_ids[0], [("dangle", proposal.encode())], NOW + 1),
        )
        assert status == P.STATUS_OK
        assert _codes(P, body) == [int(SC.OK)]
        assert harness.fingerprints_equal()

    def test_empty_owner_hash_signature_precedence(self, harness):
        m = harness.m
        P, SC = m.P, importlib.import_module(f"{PORT_PKG}.errors").StatusCode
        Stub = m.signing.StubConsensusSigner
        proposal = _proposal(m, "empties")
        harness.deliver_proposal("empties", proposal)
        base = m.proto.build_vote(proposal, True, Stub(b"\x60" * 20), NOW + 1)
        variants = []
        for field, value in (("vote_owner", b""), ("vote_hash", b""),
                             ("signature", b""), ("vote_hash", b"\x01" * 32)):
            vote = base.clone()
            setattr(vote, field, value)
            variants.append(vote)
        variants.append(m.proto.build_vote(proposal, True, Stub(b"\x61" * 20), NOW + 1))
        status, body = _batch(harness, "empties", [v.encode() for v in variants], now=NOW + 10_000)
        assert _codes(P, body)[:4] == [
            int(SC.EMPTY_VOTE_OWNER), int(SC.EMPTY_VOTE_HASH),
            int(SC.EMPTY_SIGNATURE), int(SC.INVALID_VOTE_HASH),
        ]
        assert harness.fingerprints_equal()

    def test_unknown_scope_and_unknown_peer(self, harness):
        m = harness.m
        P, SC = m.P, importlib.import_module(f"{PORT_PKG}.errors").StatusCode
        vote = m.wire.Vote(
            vote_id=1, vote_owner=b"\x01" * 20, proposal_id=7, timestamp=NOW,
            vote=True, parent_hash=b"p" * 32, received_hash=b"r" * 32,
            vote_hash=b"h" * 32, signature=b"s" * 65,
        )
        status, body = _batch(harness, "never-created", [vote.encode()])
        assert _codes(P, body) == [int(SC.SESSION_NOT_FOUND)]
        status, body = harness.both_raw(
            P.OP_VOTE_BATCH, P.encode_vote_batch(NOW, [(999, "s", [vote.encode()])]))
        assert _codes(P, body) == [P.STATUS_UNKNOWN_PEER]

    def test_malformed_frames_report_identical_errors(self, harness):
        P = harness.m.P
        good = P.encode_vote_batch(NOW, [(harness.peer_ids[0], "s", [b"x"])])
        for payload in (
            b"",
            good[:6],
            good[:-1],
            P.u64(NOW) + P.u32(2) + P.u32(1) + P.string("s") + P.u32(50),
            P.u64(NOW) + P.u32(1) + P.u32(1) + P.string("s") + P.u32(0x7FFFFFFF),
        ):
            assert harness.both_raw(P.OP_VOTE_BATCH, payload)[0] == P.STATUS_BAD_REQUEST


# ── twin: the shm lane end to end, rings attached by hand ──────────────


class HandShm:
    """A pipelined connection whose frames ride two ``ShmRing``s this
    test creates and attaches with ``OP_SHM_ATTACH`` (what the JAX
    package's gossip transport does)."""

    def __init__(self, server, ring_bytes: int = 1 << 16, attach: bool = True,
                 names: "tuple[str, str] | None" = None):
        m = _mods(PORT_PKG)
        self.P = P = m.P
        shm = importlib.import_module(f"{PORT_PKG}.gossip.shm")
        self.sock = socket.create_connection(server.address, timeout=30)
        self.sock.sendall(P.encode_frame(
            P.OP_HELLO, P.u32(P.PROTOCOL_VERSION) + P.u32(P.SUPPORTED_FEATURES)))
        status, cursor = P.read_frame(self.sock)
        assert status == P.STATUS_OK
        cursor.u32()
        assert cursor.u32() == P.SUPPORTED_FEATURES
        self.corr = 1
        self.c2s = self.s2c = None
        self.buf = bytearray()
        if not attach:
            return
        self.c2s, self.s2c = shm.ShmRing.create(ring_bytes), shm.ShmRing.create(ring_bytes)
        c2s, s2c = names or (self.c2s.name, self.s2c.name)
        self.status, _ = self.tcp(P.OP_SHM_ATTACH, P.u32(ring_bytes) + P.string(c2s) + P.string(s2c))

    def _next(self) -> int:
        self.corr += 1
        return self.corr

    def tcp(self, opcode, payload=b""):
        corr = self._next()
        self.sock.sendall(self.P.encode_tagged_frame(opcode, corr, payload))
        status, rcorr, cursor = self.P.read_tagged_frame(self.sock)
        assert rcorr == corr
        return status, cursor

    def ring_send(self, opcode, payload=b"") -> int:
        corr = self._next()
        frame = self.P.encode_tagged_frame(opcode, corr, payload)
        assert self.c2s.try_write([frame], len(frame))
        return corr

    def ring_recv(self, timeout: float = 30.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            frames = self.P.split_frames(self.buf, min_len=5)
            if frames:
                assert not self.buf
                return self.P.parse_frame(frames[0], tagged=True)
            chunk = self.s2c.read_available()
            if chunk is None:
                time.sleep(0.0005)
            else:
                self.buf += chunk
        raise TimeoutError("no response on the shm ring")

    def ring_call(self, opcode, payload=b""):
        corr = self.ring_send(opcode, payload)
        status, rcorr, cursor = self.ring_recv()
        assert rcorr == corr
        return status, cursor

    def close(self):
        self.sock.close()
        for ring in (self.c2s, self.s2c):
            if ring is not None:
                ring.close()


def _shm_or_skip():
    if not importlib.import_module(f"{PORT_PKG}.gossip.shm").shm_available():
        pytest.skip("shared memory unavailable")


@contextlib.contextmanager
def _stub_server(**kwargs):
    m = _mods(PORT_PKG)
    options = dict(signer_factory=m.signing.StubConsensusSigner, capacity=32,
                   voter_capacity=20, device="cpu")
    options.update(kwargs)
    server = m.server.BridgeServer(**options)
    server.start()
    try:
        yield server
    finally:
        server.stop()


class TestShmTransportEndToEnd:
    def test_vote_batch_over_shm_ring(self):
        _shm_or_skip()
        m = _mods(PORT_PKG)
        P = m.P
        with _stub_server() as server:
            with m.client.BridgeClient(*server.address) as client:
                peer, _ = client.add_peer(b"\x33" * 32)
                pid, blob = client.create_proposal(peer, "s", NOW, "p", b"x", 17, 3_600)
                proposal = m.wire.Proposal.decode(blob)
                rows = _signed(m, proposal, [m.signing.StubConsensusSigner(os.urandom(20))
                                             for _ in range(16)])
                lane = HandShm(server, ring_bytes=1 << 20)
                try:
                    assert lane.status == P.STATUS_OK
                    status, cursor = lane.ring_call(
                        P.OP_VOTE_BATCH, P.encode_vote_batch(NOW + 1, [(peer, "s", rows)]))
                    assert status == P.STATUS_OK
                    codes = list(cursor.raw(cursor.u32()))
                    assert len(codes) == 16 and set(codes) <= {0, 28}
                finally:
                    lane.close()
                assert client.get_stats(peer, "s") == (1, 0, 0, 1)
                assert client.get_result(peer, "s", pid) is True

    def test_attach_refused_keeps_tcp_lane(self):
        _shm_or_skip()
        P = _mods(PORT_PKG).P
        with _stub_server(capacity=8, voter_capacity=4) as server:
            lane = HandShm(server, names=("/no-such-ring-a", "/no-such-ring-b"))
            try:
                assert lane.status == P.STATUS_BAD_REQUEST
                status, cursor = lane.tcp(P.OP_PING)
                assert status == P.STATUS_OK and cursor.u32() == P.PROTOCOL_VERSION
            finally:
                lane.close()

    def test_closed_ring_raises_valueerror(self):
        _shm_or_skip()
        shm = importlib.import_module(f"{PORT_PKG}.gossip.shm")
        ring = shm.ShmRing.create(64)
        ring.close()
        with pytest.raises(ValueError):
            ring.read_available()
        with pytest.raises(ValueError):
            ring.try_write([b"x"], 1)

    def test_oversize_frame_rides_tcp_lane(self):
        """A frame the ring can never hold goes on the TCP control lane of
        the same connection and is answered there; the ring stays live."""
        _shm_or_skip()
        P = _mods(PORT_PKG).P
        with _stub_server(capacity=8, voter_capacity=4) as server:
            lane = HandShm(server, ring_bytes=4096)
            try:
                big = b"z" * (lane.c2s.capacity + 4096)
                assert not lane.c2s.try_write([big], len(big))
                status, cursor = lane.tcp(P.OP_PING, big)
                assert status == P.STATUS_OK and cursor.u32() == P.PROTOCOL_VERSION
                status, cursor = lane.ring_call(P.OP_PING)
                assert status == P.STATUS_OK and cursor.u32() == P.PROTOCOL_VERSION
            finally:
                lane.close()

    def test_corrupt_c2s_stream_kills_connection(self):
        """Garbage in the request ring kills the whole connection: the
        server shuts the TCP lane down."""
        _shm_or_skip()
        P = _mods(PORT_PKG).P
        with _stub_server(capacity=8, voter_capacity=4) as server:
            lane = HandShm(server, ring_bytes=4096)
            try:
                assert lane.c2s.try_write([b"\x00" * 4], 4)
                with pytest.raises((ConnectionError, OSError)):
                    P.read_tagged_frame(lane.sock)
            finally:
                lane.close()

    def test_corrupt_s2c_stream_is_detected_by_the_reader(self):
        """Garbage in the response ring is a framing loss the reader
        detects (the split raises), never a silent hang."""
        _shm_or_skip()
        P = _mods(PORT_PKG).P
        with _stub_server(capacity=8, voter_capacity=4) as server:
            lane = HandShm(server, ring_bytes=4096)
            try:
                assert lane.s2c.try_write([b"\x00" * 4], 4)
                with pytest.raises(ValueError):
                    lane.ring_recv(timeout=5)
            finally:
                lane.close()

    def test_oversize_response_rides_tcp_lane(self):
        """A response larger than the response ring comes back on the TCP
        lane with the request's correlation id."""
        _shm_or_skip()
        P = _mods(PORT_PKG).P
        with _stub_server(capacity=8, voter_capacity=4) as server:
            lane = HandShm(server, ring_bytes=2048)
            try:
                corr = lane.ring_send(P.OP_GET_METRICS)
                status, rcorr, cursor = P.read_tagged_frame(lane.sock)
                assert (status, rcorr) == (P.STATUS_OK, corr)
                text = cursor.blob()
                assert len(text) > lane.s2c.capacity and b"hashgraph" in text
                status, cursor = lane.ring_call(P.OP_PING)
                assert status == P.STATUS_OK and cursor.u32() == P.PROTOCOL_VERSION
            finally:
                lane.close()

    def test_mutating_frames_share_one_serial_lane_across_lanes(self):
        """Mutating frames from the ring and from TCP of one connection
        run on its one serial lane: a vote chain split across both lanes
        (each frame sent after the previous answered) applies in order."""
        _shm_or_skip()
        m = _mods(PORT_PKG)
        P = m.P
        with _stub_server() as server:
            with m.client.BridgeClient(*server.address) as client:
                peer, _ = client.add_peer(b"\x44" * 32)
                pid, blob = client.create_proposal(peer, "s", NOW, "p", b"x", 20, 3_600)
                proposal = m.wire.Proposal.decode(blob)
                rows = _signed(m, proposal, [m.signing.StubConsensusSigner(bytes([i]) * 20)
                                             for i in range(1, 10)])
                lane = HandShm(server)
                try:
                    for k in range(3):
                        payload = P.encode_vote_batch(NOW + 1, [(peer, "s", rows[3 * k:3 * k + 3])])
                        send = lane.ring_call if k % 2 == 0 else lane.tcp
                        status, cursor = send(P.OP_VOTE_BATCH, payload)
                        assert status == P.STATUS_OK
                        assert list(cursor.raw(cursor.u32())) == [0, 0, 0]
                finally:
                    lane.close()
                assert len(server.peer_engine(peer).get_proposal("s", pid).votes) == 9


# ── a failed launch on a worker thread answers STATUS_INTERNAL ─────────


@pytest.mark.parametrize("where", ["apply", "prepass"])
@pytest.mark.parametrize("reactor", [False, True])
def test_kernel_failure_on_a_worker_thread_answers_internal(where, reactor):
    """A launch that fails (``_build.launched`` raises on a non-zero
    ``cudaError``) in the serial lane's apply, in the reactor's flusher
    or in the reader thread's signature prepass comes back as the wire's
    STATUS_INTERNAL on that frame, and the connection keeps serving."""
    m = _mods(PORT_PKG)
    P = m.P
    engine_mod = importlib.import_module(f"{PORT_PKG}.engine")

    class FailingEngine(engine_mod.TorchConsensusEngine):
        def ingest_wire_columnar(self, *args, **kwargs):
            if where == "apply":
                raise RuntimeError("ingest_scan: kernel launch failed (cudaError 700)")
            return super().ingest_wire_columnar(*args, **kwargs)

        def wire_verify_begin(self, *args, **kwargs):
            if where == "prepass":
                raise RuntimeError("fe_mul: kernel launch failed (cudaError 700)")
            return super().wire_verify_begin(*args, **kwargs)

    def factory(signer):
        return FailingEngine(signer, capacity=8, voter_capacity=20, device="cpu")

    with _stub_server(engine_factory=factory, apply_reactor=reactor) as server:
        with m.client.PipelinedBridgeClient(*server.address) as pc:
            peer, _ = pc.add_peer(b"\x55" * 32)
            pid, blob = pc.create_proposal(peer, "s", NOW, "p", b"", 20, 600)
            rows = _signed(m, m.wire.Proposal.decode(blob),
                           [m.signing.StubConsensusSigner(bytes([i]) * 20) for i in (1, 2)])
            future = pc.vote_batch_async(NOW + 1, [(peer, "s", rows)])
            with pytest.raises(m.client.BridgeError) as exc:
                future.result(30)
            assert exc.value.status == P.STATUS_INTERNAL
            assert "cudaError 700" in str(exc.value)
            assert pc.ping() == P.PROTOCOL_VERSION


# ── the JAX side's entry points ────────────────────────────────────────


def _reference_server_main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    current = server = None

    def stop():
        # The JAX server's stop() waits for its accept loop, which only a
        # listener shutdown wakes at once.
        with contextlib.suppress(OSError):
            server._listener.shutdown(socket.SHUT_RDWR)
        current.__exit__(None, None, None)

    for line in sys.stdin:
        if current is not None:
            stop()
            current = None
        words = line.split()
        if not words or words[0] != "SERVE":
            break
        current = seeded_server(REF_PKG, int(words[1]))
        server = current.__enter__()
        print("PORT", server.address[1], flush=True)
    if current is not None:
        stop()


def _reference_client_main(args) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    scenario, host, port = args[0], args[1], int(args[2])
    if scenario == "scenario":
        print(json.dumps(client_scenario(REF_PKG, host, port, int(args[3]))))
        return
    assert scenario == "gossip"
    from hashgraph_tpu.gossip import GossipNode

    m = _mods(REF_PKG)
    peer, pid = int(args[3]), int(args[4])
    proposal = m.wire.Proposal.decode(bytes.fromhex(args[5]))
    rows = _chain(m, proposal, [m.signing.StubConsensusSigner(os.urandom(20))
                                for _ in range(16)], [True] * 16, NOW + 1)
    node = GossipNode("shm-driver", fanout=None, flush_votes=64, shm_ring_bytes=1 << 20)
    try:
        node.add_peer("p0", host, port, peer)
        shm = node.transport.channel("p0").shm_tx is not None
        node.submit_votes("s", pid, rows, NOW + 1, local=False)
        report = node.drain()
    finally:
        node.close()
    print(json.dumps({"shm": shm, "acked": report["acked"],
                      "failed_frames": report["failed_frames"]}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference-server"]:
        _reference_server_main()
    elif sys.argv[1:2] == ["--reference-client"]:
        _reference_client_main(sys.argv[2:])
