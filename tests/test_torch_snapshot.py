"""The port's snapshot codec (``hashgraph_tpu_torch.sync.snapshot``) against
the JAX package's.

- Session items: a seeded trace builds sessions of every kind the tier
  holds — pooled (vote-free, signed votes, columnar tallies, both), served
  on the host (wider than ``voter_capacity``), and retaining wire bytes —
  in every state (active, reached yes and no, failed). Each session's
  ``encode_session_item`` of its export, its tier item after
  ``demote_session`` and after a batched demotion by ``lifecycle_sweep``
  (the field-direct route), and the engine's ``state_fingerprint`` before
  demotion, in the tier and after every session was paged back in, must
  equal the JAX package's bytes and digests. The JAX side runs in a
  subprocess (``python tests/test_torch_snapshot.py --reference``), so this
  process leaves the JAX package's process-wide registries as it found
  them; both sides mint the same ids from seeded entropy.
- Twins of ``tests/test_sync.py``'s snapshot format tests on the port: a
  round trip through ``build_snapshot`` and ``decode_snapshot`` to an equal
  fingerprint, tallies and terminal states preserved, and corruption
  rejected with ``SnapshotDecodeError``.

Tolerance everywhere: exact.
"""

import hashlib
import importlib
import json
import os
import sys

import numpy as np
import pytest
from test_torch_wire_columnar import port_api, reference_api, reference_run, seeded

from hashgraph_tpu_torch import (
    CreateProposalRequest,
    InMemoryConsensusStorage,
    StatusCode,
    StubConsensusSigner,
    TorchConsensusEngine,
    build_vote,
)
from hashgraph_tpu_torch.sync import (
    SnapshotDecodeError,
    build_snapshot,
    decode_snapshot,
    state_fingerprint,
)
from hashgraph_tpu_torch.sync.snapshot import (
    ITEM_END,
    ITEM_HEADER,
    _u32,
    _u64,
    encode_frame,
)
from hashgraph_tpu_torch.wal import DurableEngine

NOW = 1_700_000_000


# ── Session items across packages ─────────────────────────────────────


def item_trace(api):
    """The seeded trace (see the module docstring). Returns, per created
    session in creation order, its export item and tier items (hex), and
    the fingerprints at each stage."""
    pkg = api.pkg
    snap = importlib.import_module(api.pkg.__name__ + ".sync.snapshot")
    signers = [pkg.StubConsensusSigner(b"voter-%02d" % i) for i in range(6)]
    with seeded(api, 777):
        engine = api.make_engine(pkg.StubConsensusSigner(b"node"), 16, 4)
        engine.set_scope_config("s", pkg.ScopeConfig(demote_after=1.0))

        def req(i, voters, live=True, expiry=50):
            return pkg.CreateProposalRequest(
                name=f"n{i}", payload=bytes([i]) * 3, proposal_owner=b"o",
                expected_voters_count=voters, expiration_timestamp=expiry,
                liveness_criteria_yes=live)

        # 0-5 pooled; 6-8 wider than the lanes (on the host); 9-10 retain wire.
        shapes = [(3, True), (3, True), (2, False), (3, False), (4, True), (3, True),
                  (6, True), (6, True), (6, True), (4, True), (4, False)]
        made = engine.create_proposals("s", [req(i, n, live) for i, (n, live) in
                                             enumerate(shapes)], NOW)
        pids = [p.proposal_id for p in made]

        def chain_votes(k, who, choice, t):
            chain = engine.get_proposal("s", pids[k])
            out = []
            for s in who:
                vote = pkg.build_vote(chain, choice, s, t)
                chain.votes.append(vote)
                out.append(("s", vote))
            return out

        # Signed votes: 1 reached yes, 2 one NO of two (fails at timeout), 7
        # reached yes on the host.
        engine.ingest_votes(chain_votes(1, signers[:3], True, NOW + 1)
                            + chain_votes(2, signers[:1], False, NOW + 1)
                            + chain_votes(7, signers[:5], True, NOW + 1), NOW + 1)
        gids = [engine.voter_gid(s.identity()) for s in signers]
        # Tallies: 3 reached no, 4 two tallies then a signed vote, 6 on the
        # host, 8 three NO of six (fails at timeout: a tie short of quorum).
        rows = [(3, 0, False), (3, 1, False), (3, 2, False), (4, 0, True), (4, 1, False),
                (6, 0, True), (6, 1, True), (8, 0, False), (8, 1, False), (8, 2, False)]
        engine.ingest_columnar("s", np.array([pids[k] for k, _, _ in rows], np.int64),
                               np.array([gids[v] for _, v, _ in rows], np.int64),
                               np.array([c for _, _, c in rows]), NOW + 2)
        engine.ingest_votes(chain_votes(4, signers[2:3], True, NOW + 3), NOW + 3)
        # Wire retention: 9 two rows (active), 10 three rows (reached no).
        wire_rows = [(9, 0, True), (9, 1, True), (10, 0, False), (10, 1, False), (10, 2, False)]
        chains = {k: engine.get_proposal("s", pids[k]) for k in (9, 10)}
        wire = []
        for k, v, c in wire_rows:
            vote = pkg.build_vote(chains[k], c, signers[v], NOW + 4)
            chains[k].votes.append(vote)
            wire.append(vote.encode())
        engine.ingest_columnar("s", np.array([pids[k] for k, _, _ in wire_rows], np.int64),
                               np.array([gids[v] for _, v, _ in wire_rows], np.int64),
                               np.array([c for _, _, c in wire_rows]), NOW + 4,
                               wire_votes=wire)
        for k in (2, 8):
            try:
                engine.handle_consensus_timeout("s", pids[k], NOW + 60)
            except pkg.ConsensusError:
                pass
        states = [_result(engine, pid) for pid in pids]
        export = [snap.encode_session_item("s", engine.export_session("s", pid)).hex()
                  for pid in pids]
        fps = [snap.state_fingerprint(engine)]
        for pid in pids[::2]:  # one at a time
            engine.demote_session("s", pid)
        one = {pid: engine._tier["s"][pid].item.hex() for pid in pids[::2]}
        fps.append(snap.state_fingerprint(engine))
        for pid in pids[::2]:
            _result(engine, pid)  # pages it back in
        swept = engine.lifecycle_sweep(NOW + 100)  # all of them in one call
        batch = [engine._tier["s"][pid].item.hex() for pid in pids]
        fps.append(snap.state_fingerprint(engine))
        for pid in pids:
            _result(engine, pid)
        fps.append(snap.state_fingerprint(engine))
        occ = engine.occupancy()
    return {"states": states, "export": export, "one": [one[p] for p in pids[::2]],
            "batch": batch, "swept": swept, "fingerprints": fps,
            "occupancy": [occ["live_sessions"], occ["host_spilled"], occ["tier_demotions_total"],
                          occ["tier_promotions_total"]]}


def _result(engine, pid):
    try:
        return engine.get_consensus_result("s", pid)
    except Exception as exc:  # the exception type is the result compared
        return type(exc).__name__


@pytest.fixture(scope="module")
def reference():
    return reference_run(__file__)


@pytest.fixture(scope="module")
def port():
    return json.loads(json.dumps(item_trace(port_api())))


def test_trace_covers_every_kind_and_state(port):
    assert port["states"] == [None, True, "ConsensusFailed", False, True, None,
                              None, True, "ConsensusFailed", None, False]
    assert port["swept"] == {"demoted": 11, "gc_live": 0, "gc_tier": 0}
    # Sessions that carry tallies (3, 4) and those wider than the lanes
    # (6-8) come back on the host.
    assert port["occupancy"][1] == 5


@pytest.mark.parametrize("key", ["export", "one", "batch"])
def test_session_items_equal_reference(port, reference, key):
    assert port[key] == reference[key]


def test_tier_items_are_the_export_items(port):
    assert port["batch"] == port["export"]
    assert port["one"] == port["export"][::2]


def test_fingerprints_equal_reference(port, reference):
    """The same digest live, in the tier and paged back in, in both
    packages."""
    assert len(set(port["fingerprints"])) == 1
    assert port["fingerprints"] == reference["fingerprints"]
    assert port["occupancy"] == reference["occupancy"]


# ── Twins of tests/test_sync.py's snapshot format tests ───────────────


def fresh_engine(identity: bytes = b"self-peer-identity--") -> TorchConsensusEngine:
    return TorchConsensusEngine(StubConsensusSigner(identity), 64, 8, device="cpu")


def request(name="p", voters=5, expiry=10_000):
    return CreateProposalRequest(
        name=name, payload=b"x", proposal_owner=b"owner", expected_voters_count=voters,
        expiration_timestamp=expiry, liveness_criteria_yes=True,
    )


def grow_history(engine, scope="s", proposals=4, voters=3, now=NOW):
    signers = [StubConsensusSigner(os.urandom(20)) for _ in range(voters)]
    out = engine.create_proposals(scope, [request(f"p{i}") for i in range(proposals)], now)
    for p in out:
        for s in signers:
            vote = build_vote(engine.get_proposal(scope, p.proposal_id), True, s, now + 1)
            engine.ingest_votes([(scope, vote)], now + 1, pre_validated=True)
    return out


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
        assert hashlib.sha256(data[i * 256:(i + 1) * 256]).digest() == digest
    watermark, sessions, configs = decode_snapshot(
        data[i:i + 256] for i in range(0, len(data), 256)
    )
    assert watermark == manifest.watermark
    assert len(sessions) == 5 and len(configs) == 1
    joiner = fresh_engine()
    storage = InMemoryConsensusStorage()
    for scope, config in configs:
        storage.set_scope_config(scope, config)
        joiner.set_scope_config(scope, config)
    for scope, session in sessions:
        storage.save_session(scope, session)
    joiner.load_from_storage(storage)
    assert state_fingerprint(joiner) == state_fingerprint(durable)
    durable.close()


def test_snapshot_preserves_tallies_and_states(tmp_path):
    engine = fresh_engine()
    (p,) = engine.create_proposals("s", [request(voters=4)], NOW)
    gid = engine.voter_gid(b"columnar-voter-xxxxx")
    vote = build_vote(p, True, StubConsensusSigner(b"columnar-voter-xxxxx"), NOW + 1)
    statuses = engine.ingest_columnar(
        "s", np.asarray([p.proposal_id]), np.asarray([gid]), np.asarray([True]), NOW + 1,
        wire_votes=[vote.encode()],
    )
    assert int(statuses[0]) == int(StatusCode.OK)
    path = str(tmp_path / "snap.bin")
    assert build_snapshot(engine, path).watermark == 0  # a bare engine: watermark 0
    _, sessions, _ = decode_snapshot([open(path, "rb").read()])
    joiner = fresh_engine()
    storage = InMemoryConsensusStorage()
    for scope, session in sessions:
        storage.save_session(scope, session)
    joiner.load_from_storage(storage)
    assert state_fingerprint(joiner) == state_fingerprint(engine)


def test_snapshot_of_a_tiered_engine_equals_the_untiered(tmp_path):
    """A snapshot reads demoted sessions through the tier: its bytes equal
    those of the same engine with every session live."""
    engine = fresh_engine()
    made = grow_history(engine, proposals=4, voters=2)
    build_snapshot(engine, str(tmp_path / "live.bin"))
    for p in made[1:]:
        engine.demote_session("s", p.proposal_id)
    build_snapshot(engine, str(tmp_path / "tiered.bin"))
    _, live, _ = decode_snapshot([open(tmp_path / "live.bin", "rb").read()])
    _, tiered, _ = decode_snapshot([open(tmp_path / "tiered.bin", "rb").read()])
    key = lambda item: item[1].proposal.proposal_id  # noqa: E731
    assert [s.proposal.encode() for _, s in sorted(live, key=key)] == [
        s.proposal.encode() for _, s in sorted(tiered, key=key)]
    assert engine.occupancy()["tier_sessions"] == 3


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
        decode_snapshot([bad + bytes(data[len(bad):])])
    end = encode_frame(ITEM_END, _u32(2) + _u32(0))
    assert data.endswith(end)
    with pytest.raises(SnapshotDecodeError, match="trailer"):
        decode_snapshot([bytes(data[:-len(end)])])
    with pytest.raises(SnapshotDecodeError, match="claims"):
        decode_snapshot([bytes(data[:-len(end)]) + encode_frame(ITEM_END, _u32(7) + _u32(0))])


if __name__ == "__main__" and sys.argv[1] == "--reference":
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(item_trace(reference_api())))
