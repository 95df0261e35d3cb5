"""Parity: checkpoint and restore (``export_session``, ``save_to_storage``,
``load_from_storage``) of the port's engine against the JAX package's.

The three cases of ``tests/test_engine_checkpoint.py`` (a round trip that
keeps results, configs and in-flight sessions going, a failed session
with no votes, an idempotent load), a session whose wire bytes were
retained (it exports signed votes, not tallies, and re-gossips its chain
after a load), a columnar session without retention (tallies), and
sessions served on the host, are played on both packages over
``InMemoryConsensusStorage``. The JAX engine runs in a subprocess
(``python tests/test_torch_checkpoint.py --reference``). Every logged
step, the storage snapshots and the restored pools' arrays must be equal
(tolerance: exact).
"""

import json
import sys

import numpy as np
import pytest
from test_torch_wire_columnar import (
    NOW,
    call,
    one_torch_thread,
    parse,
    pool_state,
    port_api,
    reference_api,
    reference_run,
    request,
    seeded,
    snapshot,
)


def restored(api, engine, capacity=16, voter_capacity=8):
    """A fresh engine loaded from ``engine``'s snapshot, with the counts."""
    storage = api.pkg.InMemoryConsensusStorage()
    saved = engine.save_to_storage(storage)
    fresh = api.make_engine(engine.signer(), capacity, voter_capacity)
    return fresh, [saved, fresh.load_from_storage(storage)]


def scenario_roundtrip(api):
    """``test_roundtrip_preserves_everything``: a decided session, an
    in-flight one (P2P scope) and an empty one survive save and load,
    and the in-flight one goes on counting votes and rounds."""
    pkg = api.pkg
    log = []
    with seeded(api, 11):
        me = pkg.StubConsensusSigner(b"me")
        engine = api.make_engine(me, 16, 8)
        engine.scope("beta").with_network_type(pkg.NetworkType.P2P).initialize()
        pid1 = engine.create_proposal("alpha", request(api, 1, 3), NOW).proposal_id
        engine.cast_vote("alpha", pid1, True, NOW)
        v = pkg.build_vote(engine.get_proposal("alpha", pid1), True,
                           pkg.StubConsensusSigner(b"peer-1"), NOW)
        engine.process_incoming_vote("alpha", v, NOW)
        pid2 = engine.create_proposal("beta", request(api, 2, 5), NOW + 1).proposal_id
        engine.cast_vote("beta", pid2, False, NOW + 1)
        engine.create_proposal("alpha", request(api, 3, 4), NOW + 2)
        back, counts = restored(api, engine)
        log.append(counts)
        log.append([call(back.get_consensus_result, "alpha", pid1),
                    call(back.get_consensus_result, "beta", pid2),
                    back.get_scope_config("beta").network_type == pkg.NetworkType.P2P])
        for k in range(2):
            vote = pkg.build_vote(back.get_proposal("beta", pid2), False,
                                  pkg.StubConsensusSigner(b"late-%d" % k), NOW + 2)
            log.append(call(back.process_incoming_vote, "beta", vote, NOW + 2))
        session = back.export_session("beta", pid2)
        log.append([len(session.votes), session.proposal.round])
        log.append(call(back.cast_vote, "beta", pid2, True, NOW + 3))
        stats = back.get_scope_stats("alpha")
        log.append([stats.total_sessions, stats.consensus_reached, stats.active_sessions])
        log.append(snapshot(api, engine))
        log.append(snapshot(api, back))
        log.append(pool_state(api, back))
    return log


def scenario_failed_without_votes(api):
    """``test_restore_failed_session_without_votes``."""
    pkg = api.pkg
    with seeded(api, 12):
        engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 8, 8)
        pid = engine.create_proposal("s", request(api, 0, 4, expiry=50, live=False),
                                     NOW).proposal_id
        log = [call(engine.handle_consensus_timeout, "s", pid, NOW + 60)]
        back, counts = restored(api, engine, 8, 8)
        log += [counts, call(back.get_consensus_result, "s", pid), snapshot(api, back),
                pool_state(api, back)]
    return log


def scenario_idempotent_load(api):
    """``test_idempotent_load``."""
    pkg = api.pkg
    with seeded(api, 13):
        engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 8, 8)
        engine.create_proposal("s", request(api, 0, 3), NOW)
        storage = pkg.InMemoryConsensusStorage()
        engine.save_to_storage(storage)
        back = api.make_engine(engine.signer(), 8, 8)
        log = [back.load_from_storage(storage), back.load_from_storage(storage),
               back.get_scope_stats("s").total_sessions, sorted(back.session_keys())]
    return log


def wire_fed(api, engine, scope, pid, signers, now, skip=()):
    """Chained votes by ``signers`` on one session, through the wire path
    (the rows at ``skip`` are damaged and rejected)."""
    pkg = api.pkg
    prop = engine.get_proposal(scope, pid)
    rows = []
    for k, signer in enumerate(signers):
        vote = pkg.build_vote(prop, k % 3 != 1, signer, now)
        if k in skip:
            vote.signature = bytes(32)
        else:
            prop.votes.append(vote)
        rows.append(vote.encode())
    data, offsets, cols = parse(api, rows)
    return engine.ingest_wire_columnar(
        [scope], np.zeros(len(rows), np.int64), cols, data, offsets, now).tolist()


def scenario_retained_wire(api):
    """Sessions fed through the wire path and through scalar votes export
    signed votes in arrival order (no tallies); after a load the chain
    re-gossips and the local peer's vote links onto its tail. A columnar
    session without retention exports tallies. A session wider than the
    lanes (host-spilled) keeps its retained votes too."""
    pkg = api.pkg
    log = []
    with seeded(api, 14):
        engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 16, 8)
        pooled, spilled, plain = (
            engine.create_proposal("w", request(api, i, n), NOW).proposal_id
            for i, n in ((0, 8), (1, 12), (2, 6))
        )
        peers = [pkg.StubConsensusSigner(b"peer-%d" % k) for k in range(10)]
        log.append(wire_fed(api, engine, "w", pooled, peers[:3], NOW + 1, skip=(1,)))
        vote = pkg.build_vote(engine.get_proposal("w", pooled), True, peers[5], NOW + 2)
        log.append(call(engine.process_incoming_vote, "w", vote, NOW + 2))
        log.append(wire_fed(api, engine, "w", pooled, peers[6:8], NOW + 3))
        log.append(wire_fed(api, engine, "w", spilled, peers[:4], NOW + 1))
        gids = np.array([engine.voter_gid(p.identity()) for p in peers[:3]])
        log.append(engine.ingest_columnar("w", np.full(3, plain), gids,
                                          np.array([True, False, True]), NOW + 1).tolist())
        for pid in (pooled, spilled, plain):
            s = engine.export_session("w", pid)
            log.append([[v.vote_hash.hex() for v in s.proposal.votes],
                        sorted(k.hex() for k in s.votes),
                        sorted([k.hex(), v] for k, v in s.tallies.items())])
        back, counts = restored(api, engine)
        log.append(counts)
        log.append(snapshot(api, engine) == snapshot(api, back))
        log.append(snapshot(api, back))
        log.append(call(back.cast_vote, "w", pooled, True, NOW + 4))
        log.append([v.vote_hash.hex() for v in back.get_proposal("w", pooled).votes])
        log.append([call(back.get_consensus_result, "w", p) for p in (pooled, spilled, plain)])
        log.append(back.occupancy()["host_spilled"])
        log.append(pool_state(api, back))
    return log


SCENARIOS = {
    "roundtrip": scenario_roundtrip,
    "failed_without_votes": scenario_failed_without_votes,
    "idempotent_load": scenario_idempotent_load,
    "retained_wire": scenario_retained_wire,
}


def run_all(api):
    return {name: fn(api) for name, fn in SCENARIOS.items()}


@pytest.fixture(scope="module")
def reference():
    return reference_run(__file__)


@pytest.fixture(scope="module")
def port():
    with one_torch_thread():
        return json.loads(json.dumps(run_all(port_api())))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_checkpoint_matches_reference(reference, port, name):
    ref_log, port_log = reference[name], port[name]
    assert len(port_log) == len(ref_log)
    for i, (a, b) in enumerate(zip(port_log, ref_log)):
        assert a == b, f"{name} step {i}"


def test_roundtrip_keeps_everything(port):
    """The JAX package's own assertions on the round trip, on the port."""
    log = port["roundtrip"]
    assert log[0] == [3, 3]
    assert log[1] == [True, None, True]
    assert log[2] is None and log[3] is None  # two more votes accepted
    assert log[4] == [3, 4]  # three signed votes; P2P round 1 + 3
    assert log[5] == ["raised", "UserAlreadyVoted"]
    assert log[6] == [2, 1, 1]


def test_failed_and_idempotent(port):
    assert port["failed_without_votes"][:3] == [False, [1, 1], False]
    assert port["idempotent_load"][:3] == [1, 0, 1]


def test_retained_wire_exports_signed_votes(port):
    """Retained rows export as signed votes in arrival order (wire, scalar,
    wire), tallies only for the columnar session without bytes, and a
    load reproduces the snapshot."""
    log = port["retained_wire"]
    pooled, spilled, plain = log[5], log[6], log[7]
    assert len(pooled[0]) == 5 and len(pooled[1]) == 5 and pooled[2] == []
    assert len(spilled[0]) == 4 and spilled[2] == []
    assert plain[0] == [] and plain[1] == [] and len(plain[2]) == 3
    assert log[8] == [3, 3] and log[9] is True
    assert log[12][:5] == pooled[0]  # the reloaded chain, then the local vote
    assert len(log[12]) == 6


def test_save_reads_pooled_rows_in_one_gather(monkeypatch):
    """``save_to_storage`` reads every pooled session's row back with one
    ``read_slots`` gather, and exports what ``export_session`` exports."""
    api = port_api()
    pkg = api.pkg
    with one_torch_thread(), seeded(api, 15):
        engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 16, 8)
        pids = [p.proposal_id for p in engine.create_proposals(
            "s", [request(api, i, 4) for i in range(5)], NOW)]
        gids = np.array([engine.voter_gid(bytes([k])) for k in range(3)])
        engine.ingest_columnar("s", np.repeat(pids, 3), np.tile(gids, 5),
                               np.ones(15, bool), NOW + 1)
        calls = []
        read_slots = engine.pool().read_slots
        monkeypatch.setattr(engine.pool(), "read_slots",
                            lambda slots: calls.append(list(slots)) or read_slots(slots))
        storage = pkg.InMemoryConsensusStorage()
        assert engine.save_to_storage(storage) == 5
        assert len(calls) == 1 and len(calls[0]) == 5
        for pid in pids:
            a, b = storage.get_session("s", pid), engine.export_session("s", pid)
            assert a.tallies == b.tallies and a.state == b.state


def test_torch_backed_storage_round_trip():
    """The port's pool-backed storage takes a snapshot as the in-memory
    one does: loading either gives the same engine snapshot."""
    api = port_api()
    pkg = api.pkg
    with one_torch_thread():
        log = scenario_retained_wire(api)
        with seeded(api, 14):
            engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 16, 8)
            engine.create_proposal("w", request(api, 0, 8), NOW)
            peers = [pkg.StubConsensusSigner(b"peer-%d" % k) for k in range(3)]
            pid = engine.session_keys()[0][1]
            wire_fed(api, engine, "w", pid, peers, NOW + 1)
        outs = []
        for storage in (pkg.InMemoryConsensusStorage(), pkg.TorchBackedStorage(device="cpu")):
            engine.save_to_storage(storage)
            fresh = api.make_engine(engine.signer(), 16, 8)
            assert fresh.load_from_storage(storage) == 1
            outs.append(snapshot(api, fresh))
        assert outs[0] == outs[1] == snapshot(api, engine)
        assert log[9] is True


if __name__ == "__main__" and sys.argv[1:] == ["--reference"]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(run_all(reference_api())))
