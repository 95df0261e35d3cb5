"""The port's write-ahead log (``hashgraph_tpu_torch.wal``) against the JAX
package's, and the cases of ``tests/test_wal.py`` that need no session
tiering.

Byte-identical logs: the same seeded traces drive a ``DurableEngine`` over
the port's ``TorchConsensusEngine(device="cpu")`` here and one over the JAX
package's ``TpuConsensusEngine`` in a subprocess (``python
tests/test_torch_wal.py --reference REF_DIR PORT_DIR``): every mutator and
record kind the port can write (scope configs set, initialized and
updated; proposals created, multi-scope, from peers, ingested and
delivered; votes cast, from peers, batched, pipelined; columnar,
multi-scope columnar and wire-columnar rows with some rejected; timeouts;
sweeps; scope deletes; snapshot marks), record splitting at a small
``record_budget``, and segment rotation at a small ``segment_bytes``. Each
call's result, the segment files (names and bytes) and the live engines'
``save_to_storage`` snapshots must be equal, and each package recovers the
other's log to that snapshot (tolerance: exact). The subprocess writes its
own log and recovers the port's.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
from test_torch_wire_columnar import (
    NOW,
    Recorder,
    call,
    make_votes,
    one_torch_thread,
    pack,
    parse,
    port_api,
    reference_api,
    reference_run,
    request,
    seeded,
    snapshot,
)


def counting_tracer():
    """An enabled tracer of the port's own, for one writer's counts."""
    from hashgraph_tpu_torch.tracing import Tracer

    return Tracer(enabled=True)


# ── The traces, played on both packages ───────────────────────────────


def peer_chain(api, peer, scope, pid, signers, now, choice=True):
    """``peer``'s proposal after each of ``signers`` voted on it."""
    pkg = api.pkg
    for signer in signers:
        vote = pkg.build_vote(peer.get_proposal(scope, pid), choice, signer, now)
        peer.ingest_votes([(scope, vote)], now, pre_validated=True)
    return pkg.Proposal.decode(peer.get_proposal(scope, pid).encode())


def chained(api, proposal, signers, now):
    """Chain-linked votes by ``signers`` on a copy of ``proposal``."""
    ferry = proposal.clone()
    out = []
    for k, signer in enumerate(signers):
        vote = api.pkg.build_vote(ferry, k % 3 != 2, signer, now)
        ferry.votes.append(vote)
        out.append(vote)
    return out


def scenario_mutators(api, wal_dir, seed, **wal_kwargs):
    """Every mutator of the durable wrapper, over str, bytes and int scopes,
    with rejections along the way."""
    pkg = api.pkg
    log = []
    with seeded(api, seed):
        rng = np.random.default_rng(seed)
        durable = api.wal.DurableEngine(
            api.make_engine(pkg.StubConsensusSigner(b"me"), 24, 8, max_sessions=6),
            wal_dir, fsync_policy="off", **wal_kwargs)
        rec = Recorder(durable.engine)
        peers = [pkg.StubConsensusSigner(b"peer-%d" % k) for k in range(12)]
        durable.scope("p2p").with_network_type(pkg.NetworkType.P2P).initialize()
        durable.scope("p2p").with_threshold(0.75).update()
        durable.set_scope_config(b"raw", pkg.ScopeConfig(
            network_type=pkg.NetworkType.P2P, default_consensus_threshold=0.9,
            default_timeout=30.0, default_liveness_criteria_yes=False,
            max_rounds_override=4))
        p = durable.create_proposal("p2p", request(api, 0, 5), NOW)
        rec.created("p2p", [p])
        rec.created("gs", durable.create_proposals(
            "gs", [request(api, i, int(rng.integers(3, 9))) for i in range(1, 5)], NOW))
        for scope, props in zip((b"raw", 7), durable.create_proposals_multi(
                [(b"raw", [request(api, 10, 4), request(api, 11, 12)]),
                 (7, [request(api, 12, 3, expiry=30)])], NOW,
                pkg.ConsensusConfig.p2p())):
            rec.created(scope, props)
        keys = list(rec.keys)
        # Votes: cast, from a peer, batched (validated and not), pipelined.
        log.append(call(durable.cast_vote, "p2p", p.proposal_id, True, NOW + 1))
        log.append(call(durable.cast_vote, "p2p", p.proposal_id, True, NOW + 1))
        vote = pkg.build_vote(durable.get_proposal("p2p", p.proposal_id), False, peers[0],
                              NOW + 1)
        log.append(call(durable.process_incoming_vote, "p2p", vote, NOW + 1))
        log.append(call(durable.process_incoming_vote, "p2p", vote, NOW + 1))
        items = []
        for scope, pid in keys[1:4]:
            items += [(scope, v) for v in chained(api, durable.get_proposal(scope, pid),
                                                  peers[1:5], NOW + 2)]
        items[3][1].signature = bytes(32)
        log.append(call(durable.ingest_votes, items, NOW + 2))
        scope, pid = keys[4]
        votes = chained(api, durable.get_proposal(scope, pid), peers[5:8], NOW + 2)
        log.append(call(durable.ingest_votes, [(scope, v) for v in votes], NOW + 2, True))
        batches = [[(s, v) for v in chained(api, durable.get_proposal(s, q), peers[8:10],
                                            NOW + 3)] for s, q in keys[5:7]]
        log.append(call(durable.ingest_votes_pipelined, batches, NOW + 3))
        # Columnar with retained bytes: a stale pid column entry and a gid
        # never interned are rejected live and never logged.
        scope, pid = keys[2]
        votes = chained(api, durable.get_proposal(scope, pid), peers[9:12], NOW + 4)
        gids = np.array([durable.voter_gid(v.vote_owner) for v in votes])
        gids[2] = 1 << 40
        pids = np.full(3, pid)
        pids[1] = 999_999
        log.append(call(durable.ingest_columnar, scope, pids, gids,
                        np.array([v.vote for v in votes]), NOW + 4,
                        wire_votes=[v.encode() for v in votes]))
        rows, sidx, pid_col, gid_col, vals = [], [], [], [], []
        for scope, pid in keys[5:8]:
            for v in chained(api, durable.get_proposal(scope, pid), peers[:3], NOW + 4):
                rows.append(v.encode())
                sidx.append([b"raw", 7].index(scope))
                pid_col.append(pid)
                gid_col.append(durable.voter_gid(v.vote_owner))
                vals.append(v.vote)
        data, offsets = pack(rows)
        log.append(call(durable.ingest_columnar_multi, [b"raw", 7], np.array(sidx),
                        np.array(pid_col), np.array(gid_col), np.array(vals), NOW + 4,
                        wire_votes=(data, offsets)))
        scopes = ["p2p", "gs", b"raw", 7]
        wire_rows, wire_sidx = make_votes(api, durable.engine, rec, rng, peers, NOW + 5, 24,
                                          [], scopes=scopes)
        data, offsets, cols = parse(api, wire_rows)
        log.append(call(durable.ingest_wire_columnar, scopes, np.array(wire_sidx), cols,
                        data, offsets, NOW + 5))
        # Proposals from a peer: one carrying votes, a batch, then
        # watermark extensions through deliver_proposal(s).
        peer = api.make_engine(peers[0], 8, 8)
        made = peer.create_proposals("gs", [request(api, 20 + i, 6) for i in range(3)], NOW)
        ids = [q.proposal_id for q in made]
        first = peer_chain(api, peer, "gs", ids[0], peers[1:3], NOW + 1)
        log.append(call(durable.process_incoming_proposal, "gs", first, NOW + 6))
        rest = [peer_chain(api, peer, "gs", q, peers[3:5], NOW + 1) for q in ids[1:]]
        log.append(call(durable.ingest_proposals, [("gs", q) for q in rest + [first]],
                        NOW + 6))
        grown = [peer_chain(api, peer, "gs", q, peers[6:8], NOW + 2) for q in ids]
        log.append(call(durable.deliver_proposals, [("gs", q) for q in grown], NOW + 7))
        log.append(call(durable.deliver_proposal, "gs",
                        peer_chain(api, peer, "gs", ids[0], peers[8:9], NOW + 3), NOW + 7))
        log.append(call(durable.handle_consensus_timeout, 7, keys[7][1], NOW + 40))
        log.append(call(durable.handle_consensus_timeout, "gs", 12345, NOW + 40))
        log.append(call(durable.save_to_storage, pkg.InMemoryConsensusStorage()))
        log.append(sorted([rec.index.get((s, q), -1), r]
                          for s, q, r in durable.sweep_timeouts(NOW + 60)))
        log.append(call(durable.create_proposal, "gs", request(api, 30, 4, expiry=500),
                        NOW + 61))  # past the per-scope cap: evicts
        log.append(call(durable.delete_scope, 7))
        log.append(call(durable.delete_scopes, [b"raw", "none"]))
        log.append(call(durable.checkpoint, pkg.InMemoryConsensusStorage(), compact=False))
        log.append(rec.events())
        log.append(snapshot(api, durable.engine))
        durable.close()
    return log


def scenario_split(api, wal_dir, seed):
    """The mutators at a 300-byte record budget: proposal, vote, columnar
    and wire batches split across records."""
    return scenario_mutators(api, wal_dir, seed, record_budget=300)


def scenario_rotation(api, wal_dir, seed):
    """The mutators over 512-byte segments: the writer rotates often."""
    return scenario_mutators(api, wal_dir, seed, segment_bytes=512)


SCENARIOS = {
    "mutators-0": lambda api, d: scenario_mutators(api, d, 0),
    "mutators-1": lambda api, d: scenario_mutators(api, d, 1),
    "split": lambda api, d: scenario_split(api, d, 2),
    "rotation": lambda api, d: scenario_rotation(api, d, 3),
}


def round_cap_loss(api, wal_dir):
    """The smallest input of the columnar logs' lost failure: a P2P
    proposal of five voters takes YES, NO, YES, NO, YES in one
    ``ingest_columnar`` call with its rows' bytes; the fifth exceeds the
    round cap (MAX_ROUNDS_EXCEEDED) and fails the session. The record holds
    the four accepted rows only, so recovery leaves the session active."""
    pkg = api.pkg
    with seeded(api, 9):
        durable = api.wal.DurableEngine(api.make_engine(pkg.StubConsensusSigner(b"me"), 8, 8),
                                        wal_dir, fsync_policy="off")
        durable.scope("p").p2p_preset().initialize()
        p = durable.create_proposal("p", request(api, 0, 5), NOW)
        ferry, votes = p.clone(), []
        for k in range(5):
            votes.append(pkg.build_vote(ferry, k % 2 == 0, pkg.StubConsensusSigner(bytes([k + 1])),
                                        NOW + 1))
            ferry.votes.append(votes[-1])
        gids = np.array([durable.voter_gid(v.vote_owner) for v in votes])
        statuses = durable.ingest_columnar("p", np.full(5, p.proposal_id), gids,
                                           np.array([v.vote for v in votes]), NOW + 1,
                                           wire_votes=[v.encode() for v in votes]).tolist()
        live = call(durable.get_consensus_result, "p", p.proposal_id)
        durable.close()
        fresh = api.make_engine(pkg.StubConsensusSigner(b"me"), 8, 8)
        api.wal.replay(wal_dir, fresh)
        return [statuses, live, call(fresh.get_consensus_result, "p", p.proposal_id),
                fresh.get_proposal("p", p.proposal_id).votes == votes[:4]]


def recover_into(api, wal_dir):
    """A fresh engine recovered from ``wal_dir`` through the durable
    wrapper; its snapshot and the replay's counts."""
    fresh = api.make_engine(api.pkg.StubConsensusSigner(b"me"), 24, 8, max_sessions=6)
    durable = api.wal.DurableEngine(fresh, wal_dir, fsync_policy="off")
    try:
        stats = durable.recover()
    finally:
        durable.close()
    return [snapshot(api, fresh), stats.records_applied, stats.errors]


def run_all(api, out_dir, other_dir):
    out = {"round_cap": round_cap_loss(api, os.path.join(out_dir, "round_cap"))}
    for name, fn in SCENARIOS.items():
        out[name] = {"log": fn(api, os.path.join(out_dir, name))}
        if other_dir is not None:
            out[name]["recovered_other"] = recover_into(api, os.path.join(other_dir, name))
    return out


def files(path):
    return {name: (Path(path) / name).read_bytes()
            for name in sorted(os.listdir(path)) if name.endswith(".seg")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' logs and results: the port writes first, the
    subprocess writes its own and recovers the port's, then the port
    recovers the subprocess's."""
    base = tmp_path_factory.mktemp("wal")
    port_dir, ref_dir = base / "port", base / "reference"
    api = port_api()
    with one_torch_thread():
        port = json.loads(json.dumps(run_all(api, str(port_dir), None)))
        reference = reference_run(__file__, ref_dir, port_dir)
        for name in SCENARIOS:
            port[name]["recovered_other"] = json.loads(json.dumps(
                recover_into(api, str(ref_dir / name))))
    return port, reference, port_dir, ref_dir


def test_round_cap_failure_lost_as_in_reference(runs):
    """Columnar records log accepted rows only, so a session that a
    rejected row failed (MAX_ROUNDS_EXCEEDED) is active after recovery, in
    the JAX package as in the port (ROADMAP queue 3). Pinned so that a
    change to either side shows."""
    from hashgraph_tpu_torch.errors import StatusCode

    port, reference, _, _ = runs
    assert port["round_cap"] == reference["round_cap"] == [
        [int(StatusCode.OK)] * 4 + [int(StatusCode.MAX_ROUNDS_EXCEEDED)],
        ["raised", "ConsensusFailed"], None, True]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_calls_match_reference(runs, name):
    port, reference, _, _ = runs
    a, b = port[name]["log"], reference[name]["log"]
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x == y, f"{name} step {i}"


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_segment_files_byte_identical(runs, name):
    _, _, port_dir, ref_dir = runs
    mine, theirs = files(port_dir / name), files(ref_dir / name)
    assert list(mine) == list(theirs)
    for seg in mine:
        assert mine[seg] == theirs[seg], seg


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_recovers_reference_log(runs, name):
    port, reference, _, _ = runs
    snap, applied, errors = port[name]["recovered_other"]
    assert errors == [] and applied > 20
    assert snap == reference[name]["log"][-1] == port[name]["log"][-1]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_reference_recovers_port_log(runs, name):
    port, reference, _, _ = runs
    snap, applied, errors = reference[name]["recovered_other"]
    assert errors == [] and applied > 20
    assert snap == port[name]["log"][-1]


def test_traces_write_every_record_kind(runs):
    """Every kind the port can write, and the splits and rotations the
    small budgets force."""
    from hashgraph_tpu_torch.wal import format as F
    from hashgraph_tpu_torch.wal.recovery import scan

    _, _, port_dir, _ = runs
    kinds = {}
    for name in SCENARIOS:
        kinds[name] = [kind for _, kind, _ in scan(str(port_dir / name)).records]
    assert set(kinds["mutators-0"]) == set(F.KIND_NAMES) - {F.KIND_LIFECYCLE, F.KIND_GC}
    for kind in (F.KIND_PROPOSALS, F.KIND_VOTES, F.KIND_COLUMNAR, F.KIND_WIRE_COLUMNAR):
        assert kinds["split"].count(kind) > kinds["mutators-0"].count(kind), F.KIND_NAMES[kind]
    assert len(files(port_dir / "rotation")) > 3
    assert len(files(port_dir / "mutators-0")) == 3  # two snapshot marks rotate twice


# ── tests/test_wal.py cases that need no tiering, on the port ─────────


def _api():
    return port_api()


def _engine(api, capacity=16, voter_capacity=8):
    import os as _os

    # The per-scope cap at the reference service's default, as there.
    return api.make_engine(api.pkg.StubConsensusSigner(_os.urandom(20)), capacity,
                           voter_capacity, max_sessions=10)


class TestFormat:
    def test_record_roundtrip(self):
        from hashgraph_tpu_torch.wal import format as F

        frame = F.encode_record(7, F.KIND_SWEEP, F.encode_sweep(NOW))
        records, end = F.scan_buffer(frame)
        assert records == [(7, F.KIND_SWEEP, F.encode_sweep(NOW))]
        assert end == len(frame)

    def test_scan_stops_at_corrupt_crc(self):
        from hashgraph_tpu_torch.wal import format as F

        good = F.encode_record(1, F.KIND_SWEEP, F.encode_sweep(1))
        bad = bytearray(F.encode_record(2, F.KIND_SWEEP, F.encode_sweep(2)))
        bad[-1] ^= 0xFF
        records, end = F.scan_buffer(good + bytes(bad))
        assert [lsn for lsn, _, _ in records] == [1] and end == len(good)

    def test_scan_stops_at_short_frame(self):
        from hashgraph_tpu_torch.wal import format as F

        good = F.encode_record(1, F.KIND_SWEEP, F.encode_sweep(1))
        torn = F.encode_record(2, F.KIND_SWEEP, F.encode_sweep(2))[:-3]
        records, end = F.scan_buffer(good + torn)
        assert len(records) == 1 and end == len(good)

    def test_scope_roundtrip(self):
        from hashgraph_tpu_torch.wal import format as F

        for scope in ["alpha", b"\x00\xffraw", 0, 123456789, -5, True]:
            decoded = F.decode_scope(F.Reader(F.encode_scope(scope)))
            assert decoded == (int(scope) if isinstance(scope, bool) else scope)
        with pytest.raises(TypeError):
            F.encode_scope(("tuple", "scope"))

    def test_config_roundtrips(self):
        import hashgraph_tpu_torch as pkg
        from hashgraph_tpu_torch.wal import format as F

        config = pkg.ScopeConfig(
            network_type=pkg.NetworkType.P2P, default_consensus_threshold=0.9,
            default_timeout=30.0, default_liveness_criteria_yes=False,
            max_rounds_override=7, timeout_min=1.0, timeout_max=9.0)
        assert F.decode_scope_config(F.Reader(F.encode_scope_config(config))) == config
        config.max_rounds_override = None
        assert F.decode_scope_config(
            F.Reader(F.encode_scope_config(config))).max_rounds_override is None
        cc = pkg.ConsensusConfig(consensus_threshold=0.75, consensus_timeout=12.5,
                                 max_rounds=9, use_gossipsub_rounds=False,
                                 liveness_criteria=False)
        assert F.decode_consensus_config(F.Reader(F.encode_consensus_config(cc))) == cc

    def test_encodings_match_reference(self):
        """The codecs write the JAX package's bytes for the same values."""
        import hashgraph_tpu as ref
        import hashgraph_tpu_torch as pkg
        from hashgraph_tpu.wal import format as RF
        from hashgraph_tpu_torch.wal import format as F

        def encoded(mod, codec):
            return [
                *(codec.encode_scope(s) for s in ["alpha", b"\x00\xffraw", 0, -5, True]),
                codec.encode_scope_config(mod.ScopeConfig(
                    network_type=mod.NetworkType.P2P, default_consensus_threshold=0.8,
                    default_timeout=20.0, max_rounds_override=3, demote_after=5.0,
                    timeout_min=1.0, timeout_max=2.0)),
                codec.encode_consensus_config(mod.ConsensusConfig.p2p()),
                codec.encode_timeout("s", (1 << 32) + 5, NOW),
                codec.encode_gc([("s", 5), (b"b", 6)]),
            ]

        assert encoded(pkg, F) == encoded(ref, RF)

    def test_segment_names_sort(self):
        from hashgraph_tpu_torch.wal.segment import base_lsn_of, segment_name

        assert base_lsn_of(segment_name(42)) == 42
        assert base_lsn_of("not-a-segment.txt") is None
        assert segment_name(9) < segment_name(10) < segment_name(100)


class TestWriter:
    def test_append_scan_roundtrip(self, tmp_path):
        from hashgraph_tpu_torch.wal import WalWriter, scan
        from hashgraph_tpu_torch.wal import format as F

        with WalWriter(tmp_path, fsync_policy="off") as wal:
            lsns = [wal.append(F.KIND_SWEEP, F.encode_sweep(NOW + i)) for i in range(5)]
        assert lsns == [1, 2, 3, 4, 5]
        result = scan(str(tmp_path))
        assert [lsn for lsn, _, _ in result.records] == lsns
        assert not result.torn and result.last_lsn == 5

    def test_reopen_continues_lsns(self, tmp_path):
        from hashgraph_tpu_torch.wal import WalWriter
        from hashgraph_tpu_torch.wal import format as F

        with WalWriter(tmp_path, fsync_policy="off") as wal:
            wal.append(F.KIND_SWEEP, F.encode_sweep(1))
        with WalWriter(tmp_path, fsync_policy="off") as wal:
            assert wal.last_lsn == 1
            assert wal.append(F.KIND_SWEEP, F.encode_sweep(2)) == 2

    def test_second_writer_rejected_while_first_live(self, tmp_path):
        from hashgraph_tpu_torch.wal import WalWriter
        from hashgraph_tpu_torch.wal import format as F

        with WalWriter(tmp_path, fsync_policy="off") as wal:
            wal.append(F.KIND_SWEEP, F.encode_sweep(1))
            with pytest.raises(ValueError, match="locked"):
                WalWriter(tmp_path, fsync_policy="off")
        with WalWriter(tmp_path, fsync_policy="off") as wal:
            assert wal.last_lsn == 1

    def test_rotation_and_cross_segment_scan(self, tmp_path):
        from hashgraph_tpu_torch.wal import WalWriter, scan
        from hashgraph_tpu_torch.wal import format as F
        from hashgraph_tpu_torch.wal.segment import list_segments

        tr = counting_tracer()
        with WalWriter(tmp_path, fsync_policy="off", segment_bytes=64, tracer=tr) as wal:
            for i in range(20):
                wal.append(F.KIND_SWEEP, F.encode_sweep(i))
            assert tr.counters()["wal.rotate"] == len(list_segments(str(tmp_path))) - 1
        assert len(list_segments(str(tmp_path))) > 1
        assert [lsn for lsn, _, _ in scan(str(tmp_path)).records] == list(range(1, 21))

    def test_torn_tail_repaired_on_open(self, tmp_path):
        from hashgraph_tpu_torch.wal import WalWriter, scan
        from hashgraph_tpu_torch.wal import format as F
        from hashgraph_tpu_torch.wal.segment import list_segments

        with WalWriter(tmp_path, fsync_policy="off") as wal:
            for i in range(3):
                wal.append(F.KIND_SWEEP, F.encode_sweep(i))
        (path,) = [p for _, p in list_segments(str(tmp_path))]
        garbage = b"\x99\x07garbage-torn-tail"
        with open(path, "ab") as fh:
            fh.write(garbage)
        pre = scan(str(tmp_path))
        assert pre.torn and len(pre.records) == 3
        tr = counting_tracer()
        with WalWriter(tmp_path, fsync_policy="off", tracer=tr) as wal:
            assert tr.counters()["wal.repair.truncated_bytes"] == len(garbage)
            assert wal.last_lsn == 3
            wal.append(F.KIND_SWEEP, F.encode_sweep(99))
        post = scan(str(tmp_path))
        assert not post.torn
        assert [lsn for lsn, _, _ in post.records] == [1, 2, 3, 4]

    def test_fsync_policies(self, tmp_path):
        from hashgraph_tpu_torch.wal import WalWriter
        from hashgraph_tpu_torch.wal import format as F

        counts = {}
        for policy, kwargs, n in (("always", {}, 4), ("batch", {"fsync_interval": 3}, 7),
                                  ("off", {}, 7)):
            tr = counting_tracer()
            with WalWriter(tmp_path / policy, fsync_policy=policy, tracer=tr, **kwargs) as wal:
                for i in range(n):
                    wal.append(F.KIND_SWEEP, F.encode_sweep(i))
            counts[policy] = tr.counters()["wal.fsync"]
        assert counts["always"] >= 4  # one a record, and the close
        assert counts["batch"] == 3  # lsn 3, lsn 6, close
        assert counts["off"] == 1  # close only
        with pytest.raises(ValueError):
            WalWriter(tmp_path / "bad", fsync_policy="sometimes")

    def test_append_counters(self, tmp_path):
        from hashgraph_tpu_torch.obs import WAL_SEGMENT_BYTES, WAL_SEGMENT_COUNT, registry
        from hashgraph_tpu_torch.wal import WalWriter
        from hashgraph_tpu_torch.wal import format as F

        # The footprint gauges sum every live writer: read this one's share
        # as the change it makes.
        before = registry.snapshot()["gauges"]
        tr = counting_tracer()
        with WalWriter(tmp_path, fsync_policy="off", tracer=tr) as wal:
            wal.append(F.KIND_SWEEP, F.encode_sweep(0))
            gauges = registry.snapshot()["gauges"]
        counts = tr.counters()
        segment_bytes = gauges[WAL_SEGMENT_BYTES] - before.get(WAL_SEGMENT_BYTES, 0)
        assert counts["wal.append_records"] == 1
        assert counts["wal.append_bytes"] == segment_bytes > 0
        assert gauges[WAL_SEGMENT_COUNT] - before.get(WAL_SEGMENT_COUNT, 0) == 1

    def test_compaction_drops_only_covered_sealed_segments(self, tmp_path):
        from hashgraph_tpu_torch.wal import WalWriter, scan
        from hashgraph_tpu_torch.wal import format as F
        from hashgraph_tpu_torch.wal.segment import list_segments

        tr = counting_tracer()
        with WalWriter(tmp_path, fsync_policy="off", segment_bytes=64, tracer=tr) as wal:
            for i in range(20):
                wal.append(F.KIND_SWEEP, F.encode_sweep(i))
            segments = list_segments(str(tmp_path))
            assert len(segments) >= 3
            removed = wal.compact(segments[-1][0] - 1)
            assert removed == len(segments) - 1
            assert tr.counters()["wal.compact.segments"] == removed
            assert [b for b, _ in list_segments(str(tmp_path))] == [segments[-1][0]]
            assert [lsn for lsn, _, _ in scan(str(tmp_path)).records] == list(
                range(segments[-1][0], 21))


class TestDurableEngine:
    def make(self, tmp_path, **wal_kwargs):
        api = _api()
        wal_kwargs.setdefault("fsync_policy", "off")
        return api, api.wal.DurableEngine(_engine(api), tmp_path, **wal_kwargs)

    def test_one_record_per_mutator(self, tmp_path):
        from hashgraph_tpu_torch.wal import format as F
        from hashgraph_tpu_torch.wal import scan

        api, durable = self.make(tmp_path)
        durable.scope("s").with_network_type(api.pkg.NetworkType.P2P).initialize()
        pid = durable.create_proposal("s", request(api, 0, 3), NOW).proposal_id
        durable.cast_vote("s", pid, True, NOW)
        kinds = [kind for _, kind, _ in scan(str(tmp_path)).records]
        assert kinds == [F.KIND_SCOPE_CONFIG, F.KIND_PROPOSALS, F.KIND_VOTES]

    def test_reads_do_not_log(self, tmp_path):
        from hashgraph_tpu_torch.wal import scan

        api, durable = self.make(tmp_path)
        pid = durable.create_proposal("s", request(api, 0, 3), NOW).proposal_id
        before = len(scan(str(tmp_path)).records)
        durable.get_proposal("s", pid)
        durable.get_scope_stats("s")
        durable.get_consensus_result("s", pid)
        durable.export_session("s", pid)
        assert len(scan(str(tmp_path)).records) == before

    def test_rejected_call_still_replays_identically(self, tmp_path):
        from hashgraph_tpu_torch import UserAlreadyVoted
        from hashgraph_tpu_torch.wal import replay

        api, durable = self.make(tmp_path)
        pid = durable.create_proposal("s", request(api, 0, 3), NOW).proposal_id
        durable.cast_vote("s", pid, True, NOW)
        with pytest.raises(UserAlreadyVoted):
            durable.cast_vote("s", pid, True, NOW)
        fresh = _engine(api)
        replay(str(tmp_path), fresh)
        assert len(fresh.export_session("s", pid).votes) == 1

    def test_columnar_requires_wire_votes(self, tmp_path):
        api, durable = self.make(tmp_path)
        with pytest.raises(ValueError, match="wire_votes"):
            durable.ingest_columnar("s", np.zeros(1, np.int64), np.zeros(1, np.int64),
                                    np.zeros(1, bool), NOW)

    def test_columnar_rejected_rows_never_logged(self, tmp_path):
        from hashgraph_tpu_torch.errors import StatusCode
        from hashgraph_tpu_torch.wal import replay

        api, durable = self.make(tmp_path)
        proposal = durable.create_proposal("s", request(api, 0, 4), NOW)
        votes = chained(api, proposal, [api.pkg.StubConsensusSigner(os.urandom(20))
                                        for _ in range(2)], NOW + 1)
        gids = np.array([durable.voter_gid(v.vote_owner) for v in votes])
        pids = np.full(2, proposal.proposal_id, np.int64)
        pids[1] = 999_999
        st = durable.ingest_columnar("s", pids, gids, np.array([v.vote for v in votes]),
                                     NOW + 10, wire_votes=[v.encode() for v in votes])
        assert st[0] == int(StatusCode.OK) and st[1] != int(StatusCode.OK)
        fresh = _engine(api)
        assert replay(str(tmp_path), fresh).votes_replayed == 1
        assert len(fresh.export_session("s", proposal.proposal_id).votes) == len(
            durable.export_session("s", proposal.proposal_id).votes)

    def test_delete_scope_replays(self, tmp_path):
        from hashgraph_tpu_torch.wal import replay

        api, durable = self.make(tmp_path)
        durable.create_proposal("gone", request(api, 0, 3), NOW)
        durable.create_proposal("kept", request(api, 1, 3), NOW)
        durable.delete_scope("gone")
        fresh = _engine(api)
        replay(str(tmp_path), fresh)
        assert fresh.get_scope_stats("gone").total_sessions == 0
        assert fresh.get_scope_stats("kept").total_sessions == 1

    def test_checkpoint_compacts_everything_covered(self, tmp_path):
        from hashgraph_tpu_torch.wal import format as F
        from hashgraph_tpu_torch.wal import scan
        from hashgraph_tpu_torch.wal.segment import list_segments

        from hashgraph_tpu_torch.obs import (
            WAL_CHECKPOINTS_TOTAL,
            WAL_RECOVER_SECONDS,
            flight_recorder,
            registry,
        )

        api = _api()
        tr = counting_tracer()
        durable = api.wal.DurableEngine(_engine(api), api.wal.WalWriter(
            tmp_path, fsync_policy="off", segment_bytes=256, tracer=tr))
        for i in range(12):
            durable.create_proposal("s", request(api, i, 3), NOW + i)
        assert len(list_segments(str(tmp_path))) > 1
        storage = api.pkg.InMemoryConsensusStorage()
        checkpoints = registry.counter(WAL_CHECKPOINTS_TOTAL).value
        assert durable.checkpoint(storage) == 10  # the per-scope LRU cap
        assert len(list_segments(str(tmp_path))) == 1
        assert [kind for _, kind, _ in scan(str(tmp_path)).records] == [F.KIND_SNAPSHOT]
        expected = durable.get_scope_stats("s").total_sessions
        assert registry.counter(WAL_CHECKPOINTS_TOTAL).value - checkpoints == 1
        assert tr.counters()["wal.compact.segments"] >= 1
        notes = [(kind, attrs) for _, kind, attrs in flight_recorder.events()
                 if kind.startswith("wal.")]
        assert notes[-1] == ("wal.checkpoint", {"sessions": 10})
        durable.close()
        recoveries = registry.histogram(WAL_RECOVER_SECONDS).count
        recovered = api.wal.DurableEngine(_engine(api), tmp_path, fsync_policy="off")
        assert recovered.recover(storage).records_applied == 0
        assert recovered.get_scope_stats("s").total_sessions == expected
        assert registry.histogram(WAL_RECOVER_SECONDS).count - recoveries == 1
        notes = [kind for _, kind, _ in flight_recorder.events() if kind.startswith("wal.")]
        assert notes[-1] == "wal.recover"
        recovered.close()

    def test_timeout_and_sweep_replay(self, tmp_path):
        from hashgraph_tpu_torch.wal import replay

        api, durable = self.make(tmp_path)
        pid = durable.create_proposal("s", request(api, 0, 4, expiry=50, live=False),
                                      NOW).proposal_id
        assert durable.handle_consensus_timeout("s", pid, NOW + 60) is False
        pid2 = durable.create_proposal("s", request(api, 1, 4, expiry=50), NOW).proposal_id
        assert [(s, p) for s, p, _ in durable.sweep_timeouts(NOW + 120)] == [("s", pid2)]
        fresh = _engine(api)
        replay(str(tmp_path), fresh)
        assert fresh.get_consensus_result("s", pid) is False
        assert fresh.get_consensus_result("s", pid2) is True

    def test_lifecycle_sweep_fails_before_logging(self, tmp_path):
        """The durable ``lifecycle_sweep`` logs KIND_LIFECYCLE, applies,
        and logs the sessions it collected as KIND_GC; a recovery replays
        both to the live engine's fingerprint. An engine without the tier
        still fails before anything is logged, so no record a recovery
        could not apply reaches the log."""
        from hashgraph_tpu_torch.sync import state_fingerprint
        from hashgraph_tpu_torch.wal import format as F
        from hashgraph_tpu_torch.wal import scan

        api, durable = self.make(tmp_path / "tiered")
        durable.scope("s").with_evict_decided_after(5.0).initialize()
        decided = durable.create_proposal("s", request(api, 0, 1), NOW).proposal_id
        durable.cast_vote("s", decided, True, NOW + 1)
        kept = durable.create_proposal("s", request(api, 1, 3), NOW + 2).proposal_id
        assert durable.lifecycle_sweep(NOW + 50) == {"demoted": 0, "gc_live": 1, "gc_tier": 0}
        kinds = [kind for _, kind, _ in scan(str(tmp_path / "tiered")).records]
        assert kinds[-2:] == [F.KIND_LIFECYCLE, F.KIND_GC]
        assert set(durable.session_keys()) == {("s", kept)}
        live = state_fingerprint(durable)
        durable.close()
        recovered = api.wal.DurableEngine(_engine(api), tmp_path / "tiered", fsync_policy="off")
        assert recovered.recover().records_applied == len(kinds)
        assert state_fingerprint(recovered) == live
        recovered.close()

        bare = _engine(api)
        bare.lifecycle_sweep = None  # an engine without the tier
        untiered = api.wal.DurableEngine(bare, tmp_path / "bare", fsync_policy="off")
        untiered.create_proposal("s", request(api, 0, 3), NOW)
        with pytest.raises(api.wal.UnsupportedRecord, match="lifecycle"):
            untiered.lifecycle_sweep(NOW + 1)
        assert len(scan(str(tmp_path / "bare")).records) == 1
        untiered.close()


class TestRecordBudget:
    def make(self, tmp_path, **kwargs):
        api = _api()
        kwargs.setdefault("fsync_policy", "off")
        return api, api.wal.DurableEngine(_engine(api), tmp_path, **kwargs)

    def test_oversize_append_rejected_before_ack(self, tmp_path, monkeypatch):
        from hashgraph_tpu_torch.wal import WalWriter, scan
        from hashgraph_tpu_torch.wal import format as F

        monkeypatch.setattr(F, "MAX_RECORD", 1024)
        with WalWriter(tmp_path, fsync_policy="off") as wal:
            wal.append(F.KIND_SWEEP, F.encode_sweep(1))
            with pytest.raises(ValueError, match="MAX_RECORD"):
                wal.append(F.KIND_VOTES, b"x" * 2048)
            wal.append(F.KIND_SWEEP, F.encode_sweep(2))
        result = scan(str(tmp_path))
        assert [lsn for lsn, _, _ in result.records] == [1, 2] and not result.torn

    def test_vote_batch_splits_across_records(self, tmp_path):
        from hashgraph_tpu_torch.wal import format as F
        from hashgraph_tpu_torch.wal import replay, scan

        api, durable = self.make(tmp_path / "live", record_budget=200)
        proposal = durable.create_proposal("s", request(api, 0, 6), NOW)
        votes = chained(api, proposal, [api.pkg.StubConsensusSigner(os.urandom(20))
                                        for _ in range(4)], NOW + 1)
        durable.ingest_votes([("s", v) for v in votes], NOW + 10)
        records = scan(str(tmp_path / "live")).records
        assert len([r for r in records if r[1] == F.KIND_VOTES]) > 1
        assert [lsn for lsn, _, _ in records] == list(range(1, len(records) + 1))
        fresh = _engine(api)
        stats = replay(str(tmp_path / "live"), fresh)
        assert stats.errors == [] and stats.votes_replayed == 4
        assert len(fresh.export_session("s", proposal.proposal_id).votes) == len(
            durable.export_session("s", proposal.proposal_id).votes)

    def test_unloggable_create_rejected_before_apply(self, tmp_path, monkeypatch):
        from hashgraph_tpu_torch.wal import format as F
        from hashgraph_tpu_torch.wal import scan

        monkeypatch.setattr(F, "MAX_RECORD", 2048)
        api, durable = self.make(tmp_path, record_budget=2048)
        big = api.pkg.CreateProposalRequest(
            name="big", payload=b"x" * 4096, proposal_owner=b"o", expected_voters_count=3,
            expiration_timestamp=1000, liveness_criteria_yes=True)
        with pytest.raises(ValueError, match="too large to log"):
            durable.create_proposal("s", big, NOW)
        assert durable.get_scope_stats("s").total_sessions == 0
        assert scan(str(tmp_path)).records == []

    def test_timeout_pid_not_masked(self):
        from hashgraph_tpu_torch.wal import format as F

        assert F.decode_timeout(F.encode_timeout("s", (1 << 32) + 5, NOW))[1] == (1 << 32) + 5

    def test_mid_log_corruption_reported_in_replay_stats(self, tmp_path):
        from hashgraph_tpu_torch.wal import WalWriter, replay
        from hashgraph_tpu_torch.wal import format as F
        from hashgraph_tpu_torch.wal.segment import list_segments

        with WalWriter(tmp_path, fsync_policy="off", segment_bytes=64) as wal:
            for i in range(12):
                wal.append(F.KIND_SWEEP, F.encode_sweep(i))
        segments = list_segments(str(tmp_path))
        assert len(segments) >= 3
        with open(segments[1][1], "r+b") as fh:
            fh.seek(2)
            fh.write(b"\xff\xff")
        stats = replay(str(tmp_path), _engine(_api()))
        assert stats.torn and stats.torn_path == segments[1][1]
        assert stats.segments_dropped == len(segments) - 2

    @pytest.mark.parametrize("wire_path", [False, True])
    def test_columnar_batch_splits_and_replays(self, tmp_path, wire_path):
        from hashgraph_tpu_torch.wal import format as F
        from hashgraph_tpu_torch.wal import replay, scan

        api, durable = self.make(tmp_path / "live", record_budget=200)
        proposal = durable.create_proposal("s", request(api, 0, 4), NOW)
        votes = chained(api, proposal, [api.pkg.StubConsensusSigner(os.urandom(20))
                                        for _ in range(3)], NOW + 1)
        if wire_path:
            data, offsets, cols = parse(api, [v.encode() for v in votes])
            durable.ingest_wire_columnar(["s"], np.zeros(3, np.int64), cols, data, offsets,
                                         NOW + 10)
            kind = F.KIND_WIRE_COLUMNAR
        else:
            gids = np.array([durable.voter_gid(v.vote_owner) for v in votes])
            durable.ingest_columnar("s", np.full(3, proposal.proposal_id, np.int64), gids,
                                    np.array([v.vote for v in votes]), NOW + 10,
                                    wire_votes=[v.encode() for v in votes])
            kind = F.KIND_COLUMNAR
        records = scan(str(tmp_path / "live")).records
        assert len([r for r in records if r[1] == kind]) > 1
        fresh = _engine(api)
        stats = replay(str(tmp_path / "live"), fresh)
        assert stats.errors == [] and stats.votes_replayed == 3
        assert fresh.get_consensus_result("s", proposal.proposal_id) == \
            durable.get_consensus_result("s", proposal.proposal_id)
        assert fresh.get_proposal("s", proposal.proposal_id).votes == \
            durable.get_proposal("s", proposal.proposal_id).votes


if __name__ == "__main__" and sys.argv[1] == "--reference":
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(run_all(reference_api(), sys.argv[2], sys.argv[3])))
