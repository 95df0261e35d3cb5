"""Parity: sessions the pool cannot hold, served on the host.

TorchConsensusEngine(device="cpu") against the JAX package's
TpuConsensusEngine(verify_cache=None) where a proposal is wider than
``voter_capacity`` or the pool has no free slot: both keep such a session
as a scalar ConsensusSession under a negative synthetic slot and serve it
through every entry point. The JAX engine runs in a subprocess (``python
tests/test_torch_spill.py --reference``), as in ``tests/test_torch_engine.py``,
so the JAX package's process-wide state is left as it was. Statuses,
exceptions, consensus results, events (in emission order), scope stats and
``occupancy()``'s spill counts must be equal (tolerance: exact).

``load_session_rows`` is held against the JAX package's on one session
loaded into both pools (in process, as ``tests/test_torch_pool.py`` runs
the JAX pool).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from test_torch_engine import (
    NOW,
    Recorder,
    call,
    call_ok,
    port_api,
    reference_api,
    request,
    results,
)

REPO = Path(__file__).resolve().parent.parent


def occupancy(engine):
    occ = engine.occupancy()
    return [occ["live_sessions"], occ["device_slots_used"], occ["host_spilled"],
            occ["capacity"], occ["voter_capacity"]]


def incoming(api, engine, scope, pid, owner, choice, now):
    """process_incoming_vote of a vote by ``owner`` chained onto the
    session's accepted votes (or what get_proposal raised)."""
    prop = call(engine.get_proposal, scope, pid)
    if isinstance(prop, list):
        return prop
    vote = api.pkg.build_vote(prop, choice, api.pkg.StubConsensusSigner(owner), now)
    return call(engine.process_incoming_vote, scope, vote, now)


def scenario_wide_proposal(api, seed):
    """The smallest input of a proposal wider than the lane grid: capacity
    8, voter_capacity 4, one proposal of 5 expected voters, then its five
    votes (the fourth decides it, the fifth arrives after the decision)."""
    engine = api.make_engine(api.pkg.StubConsensusSigner(b"me"), 8, 4)
    rec = Recorder(engine)
    log = []
    p = call(engine.create_proposal, "s", request(api, 0, 5), NOW)
    if isinstance(p, list):  # raised
        return [p]
    rec.created("s", [p])
    log.append(occupancy(engine))
    pid = rec.pids[("s", 0)]
    for k in range(5):
        log.append(incoming(api, engine, "s", pid, bytes([1 + k]), k != 2, NOW + 1 + k))
    log.append(rec.events())
    log.append(results(api, engine, rec, "s"))
    return log


def scenario_full_pool(api, seed):
    """The smallest input of a full pool: capacity 1, two 3-voter proposals
    in two scopes; the second is served on the host. Both take votes."""
    engine = api.make_engine(api.pkg.StubConsensusSigner(b"me"), 1, 4)
    rec = Recorder(engine)
    log = []
    for scope in ("a", "b"):
        p = call(engine.create_proposal, scope, request(api, 0, 3), NOW)
        if isinstance(p, list):
            return log + [p]
        rec.created(scope, [p])
        log.append(occupancy(engine))
    for scope in ("a", "b"):
        pid = rec.pids[(scope, 0)]
        log.append(call_ok(engine.cast_vote, scope, pid, True, NOW + 1))
        log.append(call_ok(engine.cast_vote, scope, pid, True, NOW + 1))  # twice
        log.append(incoming(api, engine, scope, pid, b"x", scope == "a", NOW + 2))
        log.append(incoming(api, engine, scope, pid, b"y", True, NOW + 3))
    log.append(rec.events())
    for scope in ("a", "b"):
        log.append(results(api, engine, rec, scope))
    return log


def scenario_scalar(api, seed):
    """create_proposal past the lane grid and past the last free slot, then
    cast_vote and process_incoming_vote with the scalar path's rejections
    on pooled and spilled sessions alike."""
    rng = np.random.default_rng(seed)
    pkg = api.pkg
    engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 4, 6)
    rec = Recorder(engine)
    engine.scope("p2p").p2p_preset().initialize()
    log = []
    for scope in ("gs", "p2p"):
        for i in range(5):
            n = int(rng.integers(1, 10))
            p = engine.create_proposal(scope, request(api, i, n, live=bool(i % 2)), NOW)
            rec.created(scope, [p])
        log.append(occupancy(engine))
    for scope in ("gs", "p2p"):
        for step in range(40):
            k = int(rng.integers(0, 5))
            pid = rec.pids[(scope, k)]
            now = NOW + 1 + step
            action = rng.random()
            if action < 0.15:
                log.append(call_ok(engine.cast_vote, scope, pid, bool(rng.random() < 0.6), now))
                continue
            signer = pkg.StubConsensusSigner(bytes([1 + int(rng.integers(0, 10))]))
            prop = engine.get_proposal(scope, pid)
            vote = pkg.build_vote(prop, bool(rng.random() < 0.6), signer, now)
            if action < 0.22:
                vote.signature = bytes(32)  # bad signature
            elif action < 0.27:
                vote.received_hash = b"\x01" * 32  # dangling link
            elif action < 0.3:
                now = NOW + 1000  # after expiry
            log.append(call(engine.process_incoming_vote, scope, vote, now))
        log.append(rec.events())
        log.append(results(api, engine, rec, scope))
    log.append(occupancy(engine))
    return log


def scenario_batch(api, seed):
    """create_proposals whose first fit leaves some proposals unplaced, then
    ingest_votes batches mixing pooled and spilled sessions across two
    scopes, validated and pre-validated, with chained votes and bad
    signatures inside one batch."""
    rng = np.random.default_rng(seed)
    pkg = api.pkg
    engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 6, 8)
    rec = Recorder(engine)
    engine.scope("p2p").p2p_preset().initialize()
    log = []
    for scope in ("gs", "p2p"):
        rec.created(scope, engine.create_proposals(
            scope, [request(api, i, int(rng.integers(2, 13)), live=bool(i % 3))
                    for i in range(8)], NOW))
        log.append(occupancy(engine))
    signers = [pkg.StubConsensusSigner(bytes([1 + i])) for i in range(12)]
    for wave in range(4):
        items = []
        shadow = {}
        for _ in range(40):
            scope = "gs" if rng.random() < 0.5 else "p2p"
            k = int(rng.integers(0, 8))
            if (scope, k) not in shadow:
                shadow[(scope, k)] = engine.get_proposal(scope, rec.pids[(scope, k)])
            prop = shadow[(scope, k)]
            signer = signers[int(rng.integers(0, 12))]
            vote = pkg.build_vote(prop, bool(rng.random() < 0.55), signer, NOW + 2 + wave)
            if rng.random() < 0.08:
                vote.signature = bytes(32)
            prop.votes.append(vote)
            items.append((scope, vote))
        log.append(call(engine.ingest_votes, items, NOW + 2 + wave, wave % 2 == 1))
        log.append(rec.events())
    for scope in ("gs", "p2p"):
        log.append(results(api, engine, rec, scope))
    log.append(occupancy(engine))
    return log


def scenario_columnar(api, seed):
    """ingest_columnar over pooled and spilled sessions in the same calls:
    tally-only host rows beside scan segments, unknown proposals and gids,
    redelivery; then object-path votes on a tallied spilled session."""
    rng = np.random.default_rng(seed)
    pkg = api.pkg
    engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 16, 16, max_sessions=24)
    rec = Recorder(engine)
    engine.scope("p2p").p2p_preset().initialize()
    log = []
    for scope in ("gs", "p2p"):
        rec.created(scope, engine.create_proposals(
            scope, [request(api, i, int(rng.integers(1, 30)), live=bool(i % 2))
                    for i in range(20)], NOW))
    log.append(occupancy(engine))
    gids = np.array([engine.voter_gid(bytes([9, i])) for i in range(32)])
    waves = []
    for scope in ("gs", "p2p"):
        pids = np.array([rec.pids[(scope, k)] for k in range(20)])
        for w in range(3):
            rows = []
            for k in range(20):
                voters = rng.permutation(32)[: int(rng.integers(0, 14))]
                rows.extend((pids[k], gids[v], bool(rng.random() < 0.6)) for v in voters)
            rows.append((987654321, gids[0], True))  # unknown proposal
            rows.append((pids[-1], 1 << 40, True))  # gid never interned
            order = rng.permutation(len(rows)) if w else np.arange(len(rows))
            cols = [np.array([rows[i][c] for i in order]) for c in range(3)]
            waves.append((scope, cols))
            log.append(call(engine.ingest_columnar, scope, *cols, NOW + 3 + w,
                            int(rng.choice([2, 4, 8]))))
            log.append(rec.events())
    scope, cols = waves[1]
    log.append(call(engine.ingest_columnar, scope, *cols, NOW + 9))  # redelivery
    log.append(rec.events())
    for scope in ("gs", "p2p"):
        for k in (17, 18, 19):  # batch tail: spilled by the pool's first fit
            pid = rec.pids[(scope, k)]
            log.append(incoming(api, engine, scope, pid, bytes([9, 3]), True, NOW + 10))
            log.append(incoming(api, engine, scope, pid, bytes([8, k]), False, NOW + 10))
            log.append(call_ok(engine.cast_vote, scope, pid, True, NOW + 10))
        log.append(rec.events())
    for scope in ("gs", "p2p"):
        log.append(results(api, engine, rec, scope))
    log.append(occupancy(engine))
    return log


def scenario_timeouts(api, seed):
    """Spilled and pooled sessions past expiry: handle_consensus_timeout and
    sweep_timeouts under both liveness settings, a late vote, and a second
    sweep over what the first left failed."""
    rng = np.random.default_rng(seed)
    pkg = api.pkg
    engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 8, 8)
    rec = Recorder(engine)
    engine.scope("p2p").p2p_preset().initialize()
    log = []
    for scope in ("gs", "p2p"):
        rec.created(scope, engine.create_proposals(
            scope, [request(api, i, int(rng.integers(1, 13)), expiry=int(rng.choice([10, 50])),
                            live=bool(i % 2)) for i in range(12)], NOW))
        gids = np.array([engine.voter_gid(bytes([5, i])) for i in range(12)])
        pids, vg, vals = [], [], []
        for k in range(12):
            for v in rng.permutation(12)[: int(rng.integers(0, 6))]:
                pids.append(rec.pids[(scope, k)])
                vg.append(gids[v])
                vals.append(bool(rng.random() < 0.5))
        log.append(call(engine.ingest_columnar, scope, np.array(pids), np.array(vg),
                        np.array(vals), NOW + 1))
        log.append(call(engine.ingest_columnar, scope, np.array(pids[-1:]),
                        np.array(vg[:1]), np.array([True]), NOW + 20))  # may be expired
    log.append(occupancy(engine))
    log.append(rec.events())
    for scope in ("gs", "p2p"):
        for k in (9, 10, 11):  # spilled by the pool's first fit
            log.append(call(engine.handle_consensus_timeout, scope,
                            rec.pids[(scope, k)], NOW + 20))
        log.append(rec.events())
    log.append(sorted(
        [s, rec.index[(s, pid)], r] for s, pid, r in engine.sweep_timeouts(NOW + 20)
    ))
    log.append(rec.events())
    for scope in ("gs", "p2p"):
        for k in (0, 9):
            log.append(call(engine.handle_consensus_timeout, scope,
                            rec.pids[(scope, k)], NOW + 60))
        log.append(rec.events())
    log.append(sorted(
        [s, rec.index[(s, pid)], r] for s, pid, r in engine.sweep_timeouts(NOW + 60)
    ))
    log.append(rec.events())
    for scope in ("gs", "p2p"):
        log.append(results(api, engine, rec, scope))
    return log


def scenario_lru(api, seed):
    """Per-scope LRU eviction with spilled sessions among the incumbents:
    evicting a spilled session releases no pool slot, evicting a pooled one
    lets the next proposal take the device again."""
    rng = np.random.default_rng(seed)
    pkg = api.pkg
    engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 3, 4, max_sessions=4)
    rec = Recorder(engine)
    log = []
    rec.created("s", engine.create_proposals("s", [request(api, i, 3) for i in range(2)], NOW))
    log.append(occupancy(engine))
    for i, n in enumerate([6, 3, 3, int(rng.integers(2, 7)), 3, int(rng.integers(2, 7))]):
        p = engine.create_proposal("s", request(api, 10 + i, n), NOW + 1 + i // 2)
        rec.created("s", [p])
        log.append(occupancy(engine))
        log.append(results(api, engine, rec, "s"))
    rec.created("t", engine.create_proposals("t", [request(api, 20 + i, int(rng.integers(2, 7)))
                                                   for i in range(3)], NOW + 5))
    log.append(occupancy(engine))
    for scope, count in (("s", 8), ("t", 3)):
        for k in range(count):
            log.append(call_ok(engine.cast_vote, scope, rec.pids[(scope, k)], True, NOW + 6))
            log.append(incoming(api, engine, scope, rec.pids[(scope, k)], b"o", True, NOW + 6))
    log.append(rec.events())
    for scope in ("s", "t"):
        log.append(results(api, engine, rec, scope))
    log.append(occupancy(engine))
    return log


SCENARIOS = {
    "scalar": scenario_scalar,
    "batch": scenario_batch,
    "columnar": scenario_columnar,
    "timeouts": scenario_timeouts,
    "lru": scenario_lru,
}
SEEDS = (0, 1, 2)
SMALLEST = {"wide_proposal": scenario_wide_proposal, "full_pool": scenario_full_pool}


def run_all(api):
    out = {f"{name}-{seed}": fn(api, seed) for name, fn in SCENARIOS.items()
           for seed in SEEDS}
    out.update({name: fn(api, 0) for name, fn in SMALLEST.items()})
    return out


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's results, computed in a fresh interpreter."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(REPO / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    proc = subprocess.run(
        [sys.executable, __file__, "--reference"],
        capture_output=True, text=True, timeout=600, cwd=str(REPO), env=env,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield json.loads(json.dumps(run_all(port_api())))
    finally:
        torch.set_num_threads(prev)


def assert_logs_equal(key, port_log, ref_log):
    assert len(port_log) == len(ref_log), key
    for i, (a, b) in enumerate(zip(port_log, ref_log)):
        assert a == b, f"{key} step {i}"


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_spill_matches_reference(reference, port, name, seed):
    key = f"{name}-{seed}"
    assert_logs_equal(key, port[key], reference[key])


def test_smallest_wide_proposal_is_served(reference, port):
    """Capacity 8, voter_capacity 4, one 5-voter proposal: accepted, served
    on the host (one spilled session, no device slot) and decided."""
    log = port["wide_proposal"]
    assert log[0] == [1, 0, 1, 8, 4]
    assert log[-1]["results"] == [True]
    assert_logs_equal("wide_proposal", log, reference["wide_proposal"])


def test_smallest_full_pool_is_served(reference, port):
    """Capacity 1, two 3-voter proposals in two scopes: the second is
    accepted and served on the host beside the pooled first."""
    log = port["full_pool"]
    assert log[:2] == [[1, 1, 0, 1, 4], [2, 1, 1, 1, 4]]
    assert_logs_equal("full_pool", log, reference["full_pool"])


def test_traces_reach_the_spill_paths(port):
    """The traces spill for both reasons, route every entry point to the
    host substrate and reach its outcomes."""
    flat = json.dumps(port)
    for needle in ("ConsensusReached", "ConsensusFailedEvent",
                   "InsufficientVotesAtTimeout", "DuplicateVote", "UserAlreadyVoted",
                   "InvalidVoteSignature", "SessionNotFound"):
        assert needle in flat, needle
    spilled = [entry[2] for log in port.values() for entry in log
               if isinstance(entry, list) and len(entry) == 5
               and all(isinstance(x, int) for x in entry)]
    assert max(spilled) >= 5


# ── load_session_rows ─────────────────────────────────────────────────


def _session(pkg, n_votes, n_tallies, now):
    """A session with ``n_votes`` votes and ``n_tallies`` columnar tallies,
    made by the same calls on either package."""
    prop = pkg.CreateProposalRequest(
        name="rows", payload=b"r", proposal_owner=b"o", expected_voters_count=64,
        expiration_timestamp=100, liveness_criteria_yes=True,
    ).into_proposal(now, pid=77)
    session = pkg.ConsensusSession._new(prop, pkg.ConsensusConfig.gossipsub(), now)
    for k in range(n_votes):
        vote = pkg.build_vote(session.proposal, k % 3 != 0,
                              pkg.StubConsensusSigner(bytes([1, k])), now)
        session.add_vote(vote, now)
    for k in range(n_tallies):
        session.add_tally(bytes([2, k]), k % 2 == 0, now)
    return session


@pytest.mark.parametrize("n_votes,n_tallies", [(0, 0), (3, 0), (0, 4), (3, 2), (5, 3)])
def test_load_session_rows_matches_reference(n_votes, n_tallies):
    import hashgraph_tpu as ref_pkg
    import hashgraph_tpu_torch as port_pkg
    from hashgraph_tpu.engine.pool import ProposalPool as RefPool
    from hashgraph_tpu.engine.session_sync import allocate_slot as ref_allocate
    from hashgraph_tpu.engine.session_sync import load_session_rows as ref_load
    from hashgraph_tpu_torch.engine.pool import ProposalPool
    from hashgraph_tpu_torch.engine.session_sync import allocate_slot, load_session_rows
    from test_torch_pool import assert_pools_equal

    v_cap = 8
    ref_pool, port_pool = RefPool(4, v_cap), ProposalPool(4, v_cap, device="cpu")
    outcomes = []
    for pkg, pool, alloc, load in ((ref_pkg, ref_pool, ref_allocate, ref_load),
                                   (port_pkg, port_pool, allocate_slot, load_session_rows)):
        session = _session(pkg, n_votes, n_tallies, NOW)
        prop = session.proposal.clone()
        prop.expected_voters_count = v_cap  # the slot's row is v_cap wide
        slot = alloc(pool, ("s", 77), prop, session.config, NOW)
        outcomes.append((slot, load(pool, slot, session)))
    assert outcomes[0] == outcomes[1] and outcomes[0][1] is True
    assert_pools_equal(ref_pool, port_pool)
    row = port_pool.read_slot(outcomes[0][0])
    assert int(row["tot"]) == n_votes + n_tallies
    assert int(row["vote_mask"].sum()) == n_votes + n_tallies


def test_load_session_rows_refuses_too_many_voters():
    import hashgraph_tpu as ref_pkg
    import hashgraph_tpu_torch as port_pkg
    from hashgraph_tpu.engine.pool import ProposalPool as RefPool
    from hashgraph_tpu.engine.session_sync import allocate_slot as ref_allocate
    from hashgraph_tpu.engine.session_sync import load_session_rows as ref_load
    from hashgraph_tpu_torch.engine.pool import ProposalPool
    from hashgraph_tpu_torch.engine.session_sync import allocate_slot, load_session_rows
    from test_torch_pool import assert_pools_equal

    v_cap = 4
    ref_pool, port_pool = RefPool(2, v_cap), ProposalPool(2, v_cap, device="cpu")
    for pkg, pool, alloc, load in ((ref_pkg, ref_pool, ref_allocate, ref_load),
                                   (port_pkg, port_pool, allocate_slot, load_session_rows)):
        session = _session(pkg, 3, 2, NOW)
        prop = session.proposal.clone()
        prop.expected_voters_count = v_cap
        slot = alloc(pool, ("s", 77), prop, session.config, NOW)
        assert load(pool, slot, session) is False
    assert_pools_equal(ref_pool, port_pool)
    assert int(port_pool.read_slot(slot)["tot"]) == 0


if __name__ == "__main__" and sys.argv[1:] == ["--reference"]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(run_all(reference_api())))
