"""Parity: the port's ``ConsensusFleet`` against the JAX package's.

Three parts, on the CPU:

1. Twins of the 15 tests of ``tests/test_fleet.py`` — routing, the fleet
   tally, per-shard WAL crash/recovery isolation, elastic membership —
   on ``devices=[cpu] * 8`` (the JAX suite's eight virtual CPU devices).
   ``test_distinct_devices_per_shard`` becomes a test that each shard's
   pool sits on its round-robin entry. Beside them, the two fleet tests
   of ``tests/test_sync.py`` (``catch_up_shard`` from a peer, the
   ``wal_recover`` readout).
2. Cross-package traces: one seeded trace (``create_proposals``,
   ``ingest_columnar_multi`` with wire votes, ``ingest_votes``,
   ``deliver_proposals``, a sweep, ``add_shard`` with pinned scopes,
   ``delete_scope``, ``crash_shard`` with ``recover_shard`` under a
   ``wal_root``) through a JAX fleet of 4 shards over the 8 virtual CPU
   devices, in a subprocess (``python tests/test_torch_fleet.py
   --reference``), and a port fleet of 4 shards on ``[cpu] * 4``, at
   seeds 0–4. Owners, statuses, events, results, stats,
   ``fleet_state_counts``, ``occupancy()`` and each shard's
   ``state_fingerprint`` must be equal. Masked: each occupancy entry's
   ``device`` (a JAX device's name against a torch device's); the trace
   has no wall-clock field.
3. No silent CPU: ``ConsensusFleet()`` raises without a GPU.

Tolerance: exact.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hashgraph_tpu_torch import (
    CreateProposalRequest,
    ScopeConfigBuilder,
    StatusCode,
    StubConsensusSigner,
    build_vote,
)
from hashgraph_tpu_torch.parallel import ConsensusFleet, ShardRecoveringError

NOW = 1_700_000_000
REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def signer_factory(k: int):
    return StubConsensusSigner(bytes([k + 1]) * 20)


def make_fleet(n_shards=4, wal_root=None, **kw):
    kw.setdefault("capacity_per_shard", 32)
    kw.setdefault("voter_capacity", 8)
    kw.setdefault("devices", [CPU] * 8)
    return ConsensusFleet(
        signer_factory, n_shards=n_shards, wal_root=wal_root, **kw
    )


def request(n=4, expiry=10_000, liveness=True):
    return CreateProposalRequest(
        name="p", payload=b"", proposal_owner=b"o",
        expected_voters_count=n, expiration_timestamp=expiry,
        liveness_criteria_yes=liveness,
    )


def scopes_covering_all_shards(fleet, per_shard=1, prefix="s"):
    """Deterministically probe scope names until every shard owns
    ``per_shard`` of them; returns {shard_id: [scopes]}."""
    got = {sid: [] for sid in fleet.shard_ids}
    i = 0
    while any(len(v) < per_shard for v in got.values()):
        scope = f"{prefix}{i}"
        i += 1
        sid = fleet.owner_of(scope)
        if len(got[sid]) < per_shard:
            got[sid].append(scope)
    return got


@pytest.fixture
def fleet():
    f = make_fleet()
    yield f
    f.close()


# ── Routing ────────────────────────────────────────────────────────────


def test_distinct_devices_per_shard(fleet):
    """Each shard's pool is one block on its round-robin entry of the
    fleet's devices (the JAX suite's distinct virtual devices are eight
    entries of the CPU here)."""
    devices = [fleet.shard(sid).device for sid in fleet.shard_ids]
    assert devices == [CPU] * 4
    entries = [CPU, torch.device("cpu", 0), torch.device("cpu", 1)]
    mixed = make_fleet(n_shards=5, devices=entries)
    try:
        for k, sid in enumerate(mixed.shard_ids):
            shard = mixed.shard(sid)
            assert shard.device == entries[k % 3]
            assert shard.pool().mesh == [shard.device]
            assert shard.pool().n_devices == 1
            assert shard.pool()._blocks[0]._state.device.type == "cpu"
        added = mixed.add_shard()  # construction index 5
        assert mixed.shard(added).device == entries[5 % 3]
    finally:
        mixed.close()


def test_columnar_multi_routes_and_stitches(fleet):
    by_shard = scopes_covering_all_shards(fleet, per_shard=2)
    scopes = [s for group in by_shard.values() for s in group]
    for s in scopes:
        fleet.set_scope_config(
            s, ScopeConfigBuilder().gossipsub_preset().build()
        )
    pids = {
        s: [p.proposal_id for p in fleet.create_proposals(s, [request()] * 3, NOW)]
        for s in scopes
    }
    owners = [bytes([9 + i]) * 20 for i in range(3)]
    sidx, cpids, cgids, cvals = [], [], [], []
    for k, s in enumerate(scopes):
        gids = [fleet.voter_gid(s, o) for o in owners]
        for pid in pids[s]:
            for g in gids:
                sidx.append(k)
                cpids.append(pid)
                cgids.append(g)
                cvals.append(True)
    # Shuffle rows so every shard's rows interleave — the router must
    # stitch statuses back into input order.
    rng = np.random.default_rng(5)
    order = rng.permutation(len(cpids))
    st = fleet.ingest_columnar_multi(
        scopes,
        np.array(sidx)[order],
        np.array(cpids)[order],
        np.array(cgids)[order],
        np.array(cvals, bool)[order],
        NOW,
    )
    assert (st == int(StatusCode.OK)).all()
    # 3 YES on n=4 at gossip default threshold (2/3): every session decided.
    for s in scopes:
        stats = fleet.get_scope_stats(s)
        assert stats.consensus_reached == 3, (s, stats.__dict__)
    # Unknown pid rows report SESSION_NOT_FOUND in place.
    st2 = fleet.ingest_columnar_multi(
        scopes,
        np.zeros(1, np.int64),
        np.array([999_999], np.int64),
        np.zeros(1, np.int64),
        np.ones(1, bool),
        NOW,
    )
    assert st2.tolist() == [int(StatusCode.SESSION_NOT_FOUND)]


def test_single_scope_entry_points_route_to_owner(fleet):
    scope = "solo"
    sid = fleet.owner_of(scope)
    fleet.scope(scope).with_threshold(1.0).initialize()
    created = fleet.create_proposal(scope, request(n=2), NOW)
    # The session must live on the owning shard's engine, nowhere else.
    owner_engine = fleet.shard(sid).engine
    assert owner_engine.get_scope_stats(scope).total_sessions == 1
    for other in fleet.shard_ids:
        if other != sid:
            assert (
                fleet.shard(other).engine.get_scope_stats(scope).total_sessions
                == 0
            )
    st = fleet.ingest_columnar(
        scope,
        np.array([created.proposal_id], np.int64),
        np.array([fleet.voter_gid(scope, b"v" * 20)], np.int64),
        np.ones(1, bool),
        NOW,
    )
    assert st.tolist() == [int(StatusCode.OK)]
    assert fleet.get_consensus_result(scope, created.proposal_id) is None


def test_ingest_votes_and_pipelined_route(fleet):
    by_shard = scopes_covering_all_shards(fleet, prefix="v")
    scopes = [g[0] for g in by_shard.values()]
    ferries = {}
    for s in scopes:
        fleet.scope(s).with_threshold(1.0).initialize()
        p = fleet.create_proposal(s, request(n=6), NOW)
        ferries[s] = fleet.get_proposal(s, p.proposal_id)
    signers = [StubConsensusSigner(bytes([40 + i]) * 20) for i in range(4)]

    def batch_for(round_idx):
        items = []
        for s in scopes:
            ferry = ferries[s]
            v = build_vote(ferry, True, signers[round_idx], NOW + 1)
            ferry.votes.append(v)
            items.append((s, v))
        return items

    st = fleet.ingest_votes(batch_for(0), NOW + 2, pre_validated=True)
    assert (st == int(StatusCode.OK)).all()
    batches = [batch_for(1), batch_for(2), batch_for(3)]
    results = fleet.ingest_votes_pipelined(batches, NOW + 3, pre_validated=True)
    assert len(results) == 3
    for st in results:
        assert (st == int(StatusCode.OK)).all()


def test_deliver_proposals_watermark_per_shard(fleet):
    """Growing-chain redelivery through the router: each shard's
    validated-chain watermark behaves exactly like the engine's."""
    by_shard = scopes_covering_all_shards(fleet, prefix="d")
    scopes = [g[0] for g in by_shard.values()][:2]
    for s in scopes:
        fleet.scope(s).with_threshold(1.0).initialize()
    bases = {s: fleet.create_proposal(s, request(n=8), NOW) for s in scopes}
    signers = [StubConsensusSigner(bytes([60 + i]) * 20) for i in range(3)]
    chains = {}
    for s in scopes:
        chain = bases[s].clone()
        for k, signer in enumerate(signers):
            chain.votes.append(build_vote(chain, bool(k % 2), signer, NOW + 1 + k))
        chains[s] = chain
    for length in range(1, len(signers) + 1):
        items = []
        for s in scopes:
            grown = chains[s].clone()
            grown.votes = [v.clone() for v in chains[s].votes[:length]]
            items.append((s, grown))
        codes = fleet.deliver_proposals(items, NOW + 50)
        assert codes == [int(StatusCode.OK)] * len(items), (length, codes)
    # Full redelivery settles crypto-free as ALREADY_EXIST on every shard.
    codes = fleet.deliver_proposals(
        [(s, chains[s].clone()) for s in scopes], NOW + 50
    )
    assert codes == [int(StatusCode.PROPOSAL_ALREADY_EXIST)] * len(scopes)


# ── Fleet tally / breakdown ────────────────────────────────────────────


def test_fleet_state_counts_psum_matches_host_mirrors(fleet):
    from hashgraph_tpu_torch.ops.decide import STATE_ACTIVE, STATE_FREE

    by_shard = scopes_covering_all_shards(fleet, prefix="t")
    total = 0
    for group in by_shard.values():
        s = group[0]
        fleet.scope(s).with_threshold(1.0).initialize()
        fleet.create_proposals(s, [request(n=4)] * 2, NOW)
        total += 2
    # Device reduction engaged (shards sharing a device included) and
    # equal to the host sum.
    assert fleet._tally() == CPU
    counts = fleet.fleet_state_counts()
    host = {}
    for sid in fleet.shard_ids:
        for code, c in fleet.shard(sid).pool().state_counts().items():
            host[code] = host.get(code, 0) + c
    for code, c in host.items():
        assert counts.get(code, 0) == c, (code, counts, host)
    assert counts[STATE_ACTIVE] == total
    assert counts[STATE_FREE] == 32 * 4 - total


def test_occupancy_and_health_breakdown(fleet):
    by_shard = scopes_covering_all_shards(fleet, prefix="o")
    for group in by_shard.values():
        s = group[0]
        fleet.scope(s).with_threshold(1.0).initialize()
        fleet.create_proposal(s, request(), NOW)
    occ = fleet.occupancy()
    assert set(occ) == set(fleet.shard_ids)
    for sid, entry in occ.items():
        assert entry["live_sessions"] == 1
        assert entry["device_slots_used"] == 1
        assert entry["capacity"] == 32
        assert sum(entry["per_device_slots_used"]) == 1
    health = fleet.health_report(NOW)
    assert set(health) == set(fleet.shard_ids)
    for rep in health.values():
        assert "peers" in rep and "alerts" in rep


# ── Elastic membership ─────────────────────────────────────────────────


def test_pinned_scopes_survive_add_shard(fleet):
    by_shard = scopes_covering_all_shards(fleet, per_shard=2, prefix="e")
    live = {}
    for group in by_shard.values():
        s = group[0]
        fleet.scope(s).with_threshold(1.0).initialize()
        p = fleet.create_proposal(s, request(), NOW)
        live[s] = (fleet.owner_of(s), p.proposal_id)
    new_sid = fleet.add_shard()
    assert new_sid in fleet.shard_ids and fleet.n_shards == 5
    # Every LIVE scope still routes to the shard holding its sessions.
    for s, (sid, pid) in live.items():
        assert fleet.owner_of(s) == sid
        assert fleet.get_proposal(s, pid).proposal_id == pid
    # New scopes can land on the new shard (rendezvous steals ~1/5).
    stolen = [
        f"fresh{i}" for i in range(100)
        if fleet.owner_of(f"fresh{i}") == new_sid
    ]
    assert stolen, "new shard never wins placement"
    s = stolen[0]
    fleet.scope(s).with_threshold(1.0).initialize()
    p = fleet.create_proposal(s, request(), NOW)
    assert (
        fleet.shard(new_sid).engine.get_scope_stats(s).total_sessions == 1
    )
    # Removing a shard with live pinned scopes is refused without force.
    pinned_sid = next(iter(live.values()))[0]
    with pytest.raises(ValueError, match="live scopes"):
        fleet.remove_shard(pinned_sid)
    # delete_scope releases the pin; a drained shard removes cleanly.
    fleet.delete_scope(s)
    fleet.remove_shard(new_sid)
    assert fleet.n_shards == 4


# ── Crash / recovery isolation ─────────────────────────────────────────


def _build_wal_traffic(fleet, scope, n_votes=4):
    fleet.scope(scope).with_threshold(1.0).initialize()
    p = fleet.create_proposal(scope, request(n=n_votes + 2), NOW)
    ferry = fleet.get_proposal(scope, p.proposal_id)
    items = []
    for i in range(n_votes):
        v = build_vote(
            ferry, True, StubConsensusSigner(bytes([80 + i]) * 20), NOW + 1 + i
        )
        ferry.votes.append(v)
        items.append((scope, v))
    st = fleet.ingest_votes(items, NOW + 10, pre_validated=True)
    assert (st == int(StatusCode.OK)).all()
    return p.proposal_id


def test_recovery_does_not_stall_other_shards(tmp_path):
    """THE isolation contract: killing + WAL-replaying one shard's engine
    must not stall ingest on the other shards. The replay is held
    mid-record via the on_record hook while the test drives real traffic
    through every other shard and asserts it completes."""
    fleet = make_fleet(n_shards=3, wal_root=str(tmp_path))
    try:
        by_shard = scopes_covering_all_shards(fleet, prefix="r")
        victim_sid = fleet.shard_ids[0]
        victim_scope = by_shard[victim_sid][0]
        victim_pid = _build_wal_traffic(fleet, victim_scope)
        survivors = {
            sid: group[0]
            for sid, group in by_shard.items()
            if sid != victim_sid
        }
        ferries = {}
        for s in survivors.values():
            fleet.scope(s).with_threshold(1.0).initialize()
            p = fleet.create_proposal(s, request(n=8), NOW)
            ferries[s] = fleet.get_proposal(s, p.proposal_id)

        fleet.crash_shard(victim_sid)
        gate, release = threading.Event(), threading.Event()

        def on_record(lsn, kind):
            gate.set()
            assert release.wait(timeout=60), "test released the replay late"

        thread = fleet.recover_shard(
            victim_sid, background=True, on_record=on_record
        )
        try:
            assert gate.wait(timeout=60), "replay never reached a record"
            # Replay is BLOCKED mid-record. Other shards must serve, both
            # scalar and columnar:
            items = []
            for s, ferry in ferries.items():
                v = build_vote(
                    ferry, True, StubConsensusSigner(b"x" * 20), NOW + 20
                )
                ferry.votes.append(v)
                items.append((s, v))
            st = fleet.ingest_votes(items, NOW + 21, pre_validated=True)
            assert (st == int(StatusCode.OK)).all()
            # The recovering shard's scopes fail fast (no deadlock/stall)...
            with pytest.raises(ShardRecoveringError):
                fleet.get_scope_stats(victim_scope)
            # ...and batch routers either raise or mark rows NOT_FOUND.
            some_scope = next(iter(survivors.values()))
            with pytest.raises(ShardRecoveringError):
                fleet.ingest_columnar_multi(
                    [victim_scope, some_scope],
                    np.zeros(1, np.int64),
                    np.array([victim_pid], np.int64),
                    np.zeros(1, np.int64),
                    np.ones(1, bool),
                    NOW + 22,
                )
            st = fleet.ingest_columnar_multi(
                [victim_scope],
                np.zeros(1, np.int64),
                np.array([victim_pid], np.int64),
                np.zeros(1, np.int64),
                np.ones(1, bool),
                NOW + 22,
                unavailable_ok=True,
            )
            assert st.tolist() == [int(StatusCode.SESSION_NOT_FOUND)]
            # Fleet-wide readouts must keep working mid-recovery (host
            # fallback over the SERVING shards — no crash on the crashed
            # shard's dropped engine).
            counts = fleet.fleet_state_counts()
            assert sum(counts.values()) == 32 * 2  # two serving shards
            assert fleet.occupancy()[victim_sid]["recovering"] is True
        finally:
            release.set()
        thread.join(timeout=120)
        assert not thread.is_alive()
        # Recovered shard serves again with its pre-crash state intact.
        assert fleet.shard(victim_sid).available
        stats = fleet.get_scope_stats(victim_scope)
        assert stats.total_sessions == 1
        assert len(fleet.get_proposal(victim_scope, victim_pid).votes) == 4
    finally:
        fleet.close()


def test_recover_foreground_roundtrip(tmp_path):
    fleet = make_fleet(n_shards=2, wal_root=str(tmp_path))
    try:
        scope = scopes_covering_all_shards(fleet, prefix="f")[
            fleet.shard_ids[1]
        ][0]
        pid = _build_wal_traffic(fleet, scope, n_votes=3)
        before = fleet.get_scope_stats(scope).__dict__
        fleet.crash_shard(fleet.shard_ids[1])
        assert not fleet.shard(fleet.shard_ids[1]).available
        fleet.recover_shard(fleet.shard_ids[1])
        assert fleet.get_scope_stats(scope).__dict__ == before
        # Post-recovery the shard takes NEW traffic (watermark replay
        # left the chain extendable).
        ferry = fleet.get_proposal(scope, pid)
        v = build_vote(ferry, True, StubConsensusSigner(b"y" * 20), NOW + 30)
        st = fleet.ingest_votes([(scope, v)], NOW + 31, pre_validated=True)
        assert st.tolist() == [int(StatusCode.OK)]
    finally:
        fleet.close()


def test_close_releases_every_shard_wal(tmp_path):
    """fleet.close() must actually close each DurableEngine (flush +
    release the directory flock) — regression for the dead
    ``callable(wal)`` guard (``wal`` is a property returning a WalWriter,
    never callable): a new writer on the same directory must succeed
    immediately after close."""
    from hashgraph_tpu_torch.wal import WalWriter

    fleet = make_fleet(n_shards=2, wal_root=str(tmp_path))
    scope = scopes_covering_all_shards(fleet, prefix="c")[fleet.shard_ids[0]][0]
    _build_wal_traffic(fleet, scope, n_votes=2)
    wal_dirs = [fleet.shard(sid).wal_dir for sid in fleet.shard_ids]
    fleet.close()
    for wal_dir in wal_dirs:
        with WalWriter(wal_dir) as wal:  # would raise on a held flock
            assert wal.directory == wal_dir


def test_delete_scope_evicts_placement_memo(fleet):
    scope = "churny"
    fleet.scope(scope).with_threshold(1.0).initialize()
    assert scope in fleet.placement._cache
    fleet.delete_scope(scope)
    assert scope not in fleet.placement._cache


def test_crash_without_wal_root_is_rejected(fleet):
    with pytest.raises(ValueError, match="wal_root"):
        fleet.crash_shard(fleet.shard_ids[0])


def test_recovery_rebuilds_pre_crash_identity_after_membership_change(
    tmp_path,
):
    """The recovery signer index is the shard's CONSTRUCTION index, not
    its current dict position: removing an earlier shard must not make a
    later shard recover with someone else's identity."""
    fleet = make_fleet(n_shards=3, wal_root=str(tmp_path))
    try:
        victim = fleet.shard_ids[2]
        identity_before = fleet.shard(victim).engine.signer().identity()
        assert identity_before == signer_factory(2).identity()
        fleet.remove_shard(fleet.shard_ids[0])  # reshuffles dict positions
        fleet.crash_shard(victim)
        fleet.recover_shard(victim)
        assert (
            fleet.shard(victim).engine.signer().identity() == identity_before
        )
        # add_shard after a removal mints a FRESH index (never reuses 0).
        new_sid = fleet.add_shard()
        new_identity = fleet.shard(new_sid).engine.signer().identity()
        taken = {
            fleet.shard(sid).engine.signer().identity()
            for sid in fleet.shard_ids
            if sid != new_sid
        }
        assert new_identity not in taken
    finally:
        fleet.close()


def test_failed_background_recovery_is_surfaced_and_retryable(tmp_path):
    fleet = make_fleet(n_shards=2, wal_root=str(tmp_path))
    try:
        victim = fleet.shard_ids[0]
        scope = scopes_covering_all_shards(fleet, prefix="fb")[victim][0]
        _build_wal_traffic(fleet, scope, n_votes=2)
        fleet.crash_shard(victim)

        def exploding(lsn, kind):
            raise RuntimeError("disk went away")

        thread = fleet.recover_shard(
            victim, background=True, on_record=exploding
        )
        thread.join(timeout=60)
        assert not thread.is_alive()
        shard = fleet.shard(victim)
        assert not shard.available  # still down, not half-recovered
        assert isinstance(shard.recovery_error, RuntimeError)
        assert "disk went away" in fleet.occupancy()[victim]["recovery_error"]
        assert (
            "disk went away" in fleet.health_report(NOW)[victim]["recovery_error"]
        )
        # Retry without the fault: recovers cleanly, error cleared.
        fleet.recover_shard(victim)
        assert shard.available and shard.recovery_error is None
        assert fleet.get_scope_stats(scope).total_sessions == 1
    finally:
        fleet.close()


# ── Twins of the fleet tests of tests/test_sync.py ────────────────────


def _sync_request():
    return CreateProposalRequest(
        name="p", payload=b"x", proposal_owner=b"owner",
        expected_voters_count=5, expiration_timestamp=10_000,
        liveness_criteria_yes=True,
    )


def test_catch_up_shard_recovers_from_peer(tmp_path):
    from hashgraph_tpu_torch.bridge.client import BridgeClient
    from hashgraph_tpu_torch.bridge.server import BridgeServer
    from hashgraph_tpu_torch.engine import TorchConsensusEngine
    from hashgraph_tpu_torch.sync import state_fingerprint

    fleet = ConsensusFleet(
        signer_factory, n_shards=2, devices=[CPU],
        capacity_per_shard=32, voter_capacity=8,
        wal_root=str(tmp_path / "fleet-wal"),
    )
    server = BridgeServer(
        capacity=64, voter_capacity=8,
        wal_dir=str(tmp_path / "peer-wal"), wal_fsync="off",
        signer_factory=StubConsensusSigner, device="cpu",
    )
    try:
        with server:
            host, port = server.address
            with BridgeClient(host, port) as client:
                src_peer, identity = client.add_peer(os.urandom(32))
                source = server.durable_engine(identity)
                # Identical traffic to the fleet shard and the source
                # peer: the peer is the replica catch-up later syncs from.
                scope = next(
                    f"s{i}" for i in range(1000)
                    if fleet.owner_of(f"s{i}") == fleet.shard_ids[0]
                )
                scratch = TorchConsensusEngine(
                    StubConsensusSigner(b"scratch-identity-xxx"), capacity=64,
                    voter_capacity=8, device="cpu",
                )
                (minted,) = scratch.create_proposals(scope, [_sync_request()], NOW)
                signers = [StubConsensusSigner(os.urandom(20)) for _ in range(3)]
                chain = minted.clone()
                for s in signers:
                    chain.votes.append(build_vote(chain, True, s, NOW + 1))
                assert fleet.deliver_proposal(scope, chain, NOW) == int(
                    StatusCode.OK
                )
                assert source.deliver_proposal(scope, chain, NOW) == int(
                    StatusCode.OK
                )
                victim = fleet.shard_ids[0]
                fleet.crash_shard(victim)
                fleet.catch_up_shard(victim, host, port, src_peer)
                shard = fleet.shard(victim)
                assert shard.available
                assert state_fingerprint(shard.engine) == state_fingerprint(
                    source
                )
                occ = fleet.occupancy()[victim]
                assert occ["catch_up"]["sessions_installed"] == 1
                assert occ["catch_up"]["votes_verified"] == 3
                health = fleet.health_report(NOW + 2)[victim]
                assert health["catch_up"]["sessions_installed"] == 1
                # The recovered shard serves immediately.
                late = build_vote(
                    fleet.get_proposal(scope, chain.proposal_id),
                    True,
                    StubConsensusSigner(os.urandom(20)),
                    NOW + 2,
                )
                statuses = fleet.ingest_votes([(scope, late)], NOW + 2)
                assert int(statuses[0]) in (
                    int(StatusCode.OK), int(StatusCode.ALREADY_REACHED)
                )
    finally:
        fleet.close()


def test_recover_shard_surfaces_wal_recover_stats(tmp_path):
    fleet = ConsensusFleet(
        signer_factory, n_shards=2, devices=[CPU],
        capacity_per_shard=32, voter_capacity=8,
        wal_root=str(tmp_path / "fleet-wal"),
    )
    try:
        scope = next(
            f"r{i}" for i in range(1000)
            if fleet.owner_of(f"r{i}") == fleet.shard_ids[1]
        )
        fleet.create_proposals(scope, [_sync_request()], NOW)
        victim = fleet.shard_ids[1]
        fleet.crash_shard(victim)
        # A clean log still surfaces the stats block with zero corruption
        # counters — the operator contract is "the numbers are in the
        # readout".
        fleet.recover_shard(victim)
        occ = fleet.occupancy()[victim]
        assert "wal_recover" in occ
        assert occ["wal_recover"]["records_applied"] >= 1
        assert occ["wal_recover"]["torn_bytes"] == 0
        assert occ["wal_recover"]["dropped_segments"] == 0
        assert occ["wal_recover"]["decode_errors"] == 0
        health = fleet.health_report(NOW)[victim]
        assert health["wal_recover"] == occ["wal_recover"]
    finally:
        fleet.close()


# ── No silent CPU ──────────────────────────────────────────────────────


def test_fleet_without_gpu_raises(tmp_path):
    """The fleet, an added shard and a federation host take the card by
    default and raise without one: the CPU is only ever asked for."""
    from hashgraph_tpu_torch.parallel import FederationPlacement, FleetGroup

    if torch.cuda.is_available():
        pytest.skip("needs a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConsensusFleet(signer_factory)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConsensusFleet(signer_factory, devices=["cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConsensusFleet(signer_factory, n_shards=2, devices=[CPU]).add_shard(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetGroup("h0", signer_factory, placement=FederationPlacement.uniform(["h0"], 1),
                   wal_root=str(tmp_path))


# ── Cross-package traces ───────────────────────────────────────────────

TRACE_SEEDS = (0, 1, 2, 3, 4)


def port_api():
    import hashgraph_tpu_torch as pkg
    from hashgraph_tpu_torch import protocol
    from hashgraph_tpu_torch.parallel import ConsensusFleet as Fleet
    from hashgraph_tpu_torch.sync import state_fingerprint

    def make(**kw):
        return Fleet(lambda k: pkg.StubConsensusSigner(bytes([k + 1]) * 20),
                     devices=[CPU] * 4, **kw)

    return SimpleNamespace(pkg=pkg, protocol=protocol, make_fleet=make,
                           fingerprint=state_fingerprint)


def reference_api():
    import jax

    import hashgraph_tpu as pkg
    from hashgraph_tpu import protocol
    from hashgraph_tpu.parallel import ConsensusFleet as Fleet
    from hashgraph_tpu.sync import state_fingerprint

    assert len(jax.devices()) == 8

    def make(**kw):
        # Default devices: the eight virtual CPU devices, one a shard.
        return Fleet(lambda k: pkg.StubConsensusSigner(bytes([k + 1]) * 20), **kw)

    return SimpleNamespace(pkg=pkg, protocol=protocol, make_fleet=make,
                           fingerprint=state_fingerprint)


class _Seeded:
    """Seeded proposal and vote ids (``protocol.set_id_entropy``) and batch
    id draws (``os.urandom``), so both packages mint the same ids."""

    def __init__(self, api, seed):
        import random

        self.api, self.ids = api, random.Random(seed)
        self.draws = random.Random(seed + 1_000_003)

    def __enter__(self):
        self.saved = os.urandom
        self.api.protocol.set_id_entropy(lambda: self.ids.getrandbits(128))
        os.urandom = self.draws.randbytes

    def __exit__(self, *exc):
        os.urandom = self.saved
        self.api.protocol.set_id_entropy(None)


def _plain(value):
    """JSON-able form of trace values (numpy ints, tuples, dict keys)."""
    if isinstance(value, dict):
        return {str(k): _plain(v) for k, v in sorted(value.items(), key=lambda kv: str(kv[0]))}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, bytes):
        return value.hex()
    return value


def fleet_trace(api, seed, wal_root):
    """One seeded trace through a 4-shard fleet; returns its log."""
    pkg = api.pkg
    rng = np.random.default_rng(seed)
    log = {}
    with _Seeded(api, seed):
        fleet = api.make_fleet(n_shards=4, capacity_per_shard=40, voter_capacity=8,
                               wal_root=wal_root, fsync_policy="off")
        try:
            _trace_body(api, pkg, fleet, rng, seed, log)
        finally:
            fleet.close()
    return _plain(log)


def _trace_body(api, pkg, fleet, rng, seed, log):
    rx = {}

    def subscribe(sid):
        rx[sid] = fleet.shard(sid).engine.event_bus().subscribe()

    def drain():
        out = {}
        for sid, receiver in rx.items():
            events = []
            while (item := receiver.try_recv()) is not None:
                scope, ev = item
                events.append([scope, type(ev).__name__, ev.proposal_id,
                               getattr(ev, "result", None), ev.timestamp])
            out[sid] = events
        return out

    for sid in fleet.shard_ids:
        subscribe(sid)
    scopes = [f"fleet-{seed}-{i}" for i in range(10)]
    log["owners"] = {s: fleet.owner_of(s) for s in scopes}
    for i, s in enumerate(scopes):
        if i % 3 == 0:
            fleet.scope(s).p2p_preset().initialize()
        elif i % 3 == 1:
            fleet.scope(s).with_threshold(1.0).initialize()
    signers = [pkg.StubConsensusSigner(bytes([100 + i]) * 20) for i in range(8)]
    pids, ferries = {}, {}
    for i, s in enumerate(scopes):
        reqs = [
            pkg.CreateProposalRequest(
                name=f"p{k}", payload=bytes([k]), proposal_owner=b"o" * 20,
                expected_voters_count=int(rng.integers(3, 9)),
                expiration_timestamp=int(rng.choice([40, 10_000])),
                liveness_criteria_yes=bool(rng.random() < 0.5),
            )
            for k in range(int(rng.integers(2, 5)))
        ]
        created = fleet.create_proposals(s, reqs, NOW)
        pids[s] = [p.proposal_id for p in created]
        for p in created:
            ferries[(s, p.proposal_id)] = fleet.get_proposal(s, p.proposal_id)

    def next_vote(s, pid, value, signer, now):
        ferry = ferries[(s, pid)]
        vote = pkg.build_vote(ferry, value, signer, now)
        ferry.votes.append(vote)
        return vote

    # Columnar rows with their wire votes (the shards are durable), shuffled
    # across scopes, plus an unknown session.
    rows = []
    for k, s in enumerate(scopes):
        for pid in pids[s]:
            for j in rng.permutation(8)[: int(rng.integers(1, 5))]:
                signer = signers[int(j)]
                vote = next_vote(s, pid, bool(rng.random() < 0.7), signer, NOW + 1)
                rows.append((k, pid, fleet.voter_gid(s, signer.identity()), vote.vote,
                             vote.encode()))
    rows.append((0, 999_999, 0, True, rows[0][4]))
    cols = list(zip(*rows))
    log["columnar"] = fleet.ingest_columnar_multi(
        scopes, np.array(cols[0]), np.array(cols[1]), np.array(cols[2]),
        np.array(cols[3], bool), NOW + 1, wire_votes=list(cols[4]),
    )
    log["events_columnar"] = drain()
    # Object votes: chained, one tampered after hashing; validated, then
    # pre-validated and pipelined.
    items = []
    for _ in range(30):
        s = scopes[int(rng.integers(0, len(scopes)))]
        pid = pids[s][int(rng.integers(0, len(pids[s])))]
        vote = next_vote(s, pid, bool(rng.random() < 0.6),
                         signers[int(rng.integers(0, 8))], NOW + 2)
        items.append((s, vote))
    bad = pkg.build_vote(ferries[(scopes[1], pids[scopes[1]][0])], True, signers[0], NOW + 2)
    bad.received_hash = b"\x01" * 32
    items.insert(7, (scopes[1], bad))
    log["votes"] = fleet.ingest_votes(items, NOW + 2)
    log["votes_pipelined"] = fleet.ingest_votes_pipelined(
        [[(s, next_vote(s, pids[s][-1], True, signers[7], NOW + 3))] for s in scopes[:4]],
        NOW + 3, pre_validated=True,
    )
    log["events_votes"] = drain()
    # Gossip delivery: grown chains of proposals minted on the fleet.
    delivered = []
    for s in scopes[:5]:
        chain = fleet.get_proposal(s, pids[s][0]).clone()
        for j in range(2):
            chain.votes.append(pkg.build_vote(chain, bool(j % 2), signers[j], NOW + 4))
        delivered.append((s, chain))
    log["deliver"] = fleet.deliver_proposals(delivered, NOW + 5)
    log["redeliver"] = fleet.deliver_proposals(
        [(s, c.clone()) for s, c in delivered], NOW + 5)
    # Sweep past the short expiries.
    log["swept"] = [list(x) for x in fleet.sweep_timeouts(NOW + 100)]
    log["events_sweep"] = drain()
    # Elastic membership: live scopes stay pinned, fresh ones may move.
    added = fleet.add_shard()
    subscribe(added)
    log["added"] = added
    log["owners_after_add"] = {s: fleet.owner_of(s) for s in scopes}
    fresh = [f"fresh-{seed}-{i}" for i in range(12)]
    log["fresh_owners"] = {s: fleet.owner_of(s) for s in fresh}
    for s in fresh[:6]:
        fleet.scope(s).with_threshold(1.0).initialize()
        (p,) = fleet.create_proposals(s, [pkg.CreateProposalRequest(
            name="f", payload=b"", proposal_owner=b"o" * 20, expected_voters_count=2,
            expiration_timestamp=10_000, liveness_criteria_yes=True)], NOW + 100)
        pids[s] = [p.proposal_id]
        ferries[(s, p.proposal_id)] = fleet.get_proposal(s, p.proposal_id)
    log["fresh_votes"] = fleet.ingest_votes(
        [(s, next_vote(s, pids[s][0], True, signers[j], NOW + 101))
         for j in range(2) for s in fresh[:6]], NOW + 101)
    deleted = scopes[2]
    fleet.delete_scope(deleted)
    log["owner_after_delete"] = fleet.owner_of(deleted)
    # Crash the shard that owns the most live scopes and replay its log.
    live = [s for s in scopes + fresh[:6] if s != deleted]
    by_shard = {}
    for s in live:
        by_shard.setdefault(fleet.owner_of(s), []).append(s)
    victim = max(sorted(by_shard), key=lambda sid: len(by_shard[sid]))
    before = api.fingerprint(fleet.shard(victim).engine)
    log["events_before_crash"] = drain()
    fleet.crash_shard(victim)
    log["recovering_occupancy"] = fleet.occupancy()[victim]
    log["counts_mid_recovery"] = fleet.fleet_state_counts()
    fleet.recover_shard(victim)
    subscribe(victim)
    log["victim"] = victim
    log["fingerprint_kept"] = api.fingerprint(fleet.shard(victim).engine) == before
    s = by_shard[victim][0]
    log["after_recovery"] = fleet.ingest_votes(
        [(s, next_vote(s, pids[s][0], True, signers[6], NOW + 102))], NOW + 102)
    log["events_after"] = drain()
    results = {}
    for s in live:
        stats = fleet.get_scope_stats(s)
        results[s] = {
            "results": [_result(fleet, s, pid) for pid in pids[s]],
            "stats": [stats.total_sessions, stats.active_sessions,
                      stats.failed_sessions, stats.consensus_reached],
        }
    log["results"] = results
    log["counts"] = fleet.fleet_state_counts()
    occupancy = fleet.occupancy()
    for entry in occupancy.values():
        entry.pop("device", None)
    log["occupancy"] = occupancy
    log["totals"] = fleet.occupancy_totals()
    log["fingerprints"] = {sid: api.fingerprint(fleet.shard(sid).engine)
                           for sid in fleet.shard_ids}


def _result(fleet, scope, pid):
    """A session's consensus result, or the name of the exception that
    reading it raised."""
    try:
        return fleet.get_consensus_result(scope, pid)
    except Exception as exc:  # the exception type is the result compared
        return type(exc).__name__


def run_traces(api, root):
    out = {}
    for seed in TRACE_SEEDS:
        path = os.path.join(root, f"seed-{seed}")
        out[str(seed)] = fleet_trace(api, seed, path)
    return out


@pytest.fixture(scope="module")
def reference_traces(tmp_path_factory):
    """The JAX fleet's traces, from a fresh interpreter with eight virtual
    CPU devices."""
    root = tmp_path_factory.mktemp("fleet-reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run(
        [sys.executable, __file__, "--reference", str(root)],
        capture_output=True, text=True, timeout=600, cwd=str(REPO), env=env,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_traces(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet-port")
    return json.loads(json.dumps(run_traces(port_api(), str(root))))


@pytest.mark.parametrize("seed", TRACE_SEEDS)
def test_fleet_trace_matches_reference(reference_traces, port_traces, seed):
    ref, port = reference_traces[str(seed)], port_traces[str(seed)]
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert port[key] == ref[key], f"seed {seed}: {key}"


def test_fleet_traces_exercise_the_paths(port_traces):
    """The traces reach what they are meant to: decisions, timeouts,
    rejections, pinned owners across add_shard, a recovered shard equal to
    its pre-crash self, scopes on the added shard."""
    flat = json.dumps(port_traces)
    for needle in ("ConsensusReached", "ConsensusFailed"):
        assert needle in flat, needle
    codes = set()
    for trace in port_traces.values():
        assert trace["owners_after_add"] == trace["owners"]
        assert trace["fingerprint_kept"] is True
        assert trace["recovering_occupancy"]["recovering"] is True
        assert trace["swept"]
        codes.update(trace["columnar"] + trace["votes"] + trace["deliver"])
    assert any(t["added"] in t["fresh_owners"].values() for t in port_traces.values())
    for code in ("OK", "SESSION_NOT_FOUND", "INVALID_VOTE_HASH"):
        assert int(getattr(StatusCode, code)) in codes, code


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(run_traces(reference_api(), sys.argv[2])))
