"""Parity: TorchConsensusEngine(device="cpu") against the JAX package's
TpuConsensusEngine(verify_cache=None) on the same scalar, batch, columnar
and timeout traces, signed with StubConsensusSigner.

The JAX engine runs in a subprocess (``python tests/test_torch_engine.py
--reference``), so this test process leaves the JAX package's process-wide
state (metrics registry, health monitor, SLO engine, flight recorder)
exactly as it found it. Both sides run the same scenario code; proposal ids
are random per engine, so results are keyed by creation order. Statuses,
exceptions, consensus results, events (in emission order) and scope stats
must be equal (tolerance: exact).
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

NOW = 1_700_000_000
REPO = Path(__file__).resolve().parent.parent


def port_api():
    import hashgraph_tpu_torch as pkg
    from hashgraph_tpu_torch.events import BroadcastEventBus

    def make_engine(signer, capacity, voter_capacity, max_sessions=10_000):
        return pkg.TorchConsensusEngine(
            signer, capacity, voter_capacity,
            event_bus=BroadcastEventBus(max_queued_events=1_000_000),
            max_sessions_per_scope=max_sessions, device="cpu",
        )

    return SimpleNamespace(pkg=pkg, make_engine=make_engine)


def reference_api():
    import hashgraph_tpu as pkg
    from hashgraph_tpu.engine import TpuConsensusEngine
    from hashgraph_tpu.events import BroadcastEventBus
    from hashgraph_tpu.obs.health import HealthMonitor

    def make_engine(signer, capacity, voter_capacity, max_sessions=10_000):
        return TpuConsensusEngine(
            signer,
            event_bus=BroadcastEventBus(max_queued_events=1_000_000),
            capacity=capacity, voter_capacity=voter_capacity,
            max_sessions_per_scope=max_sessions, verify_cache=None,
            health_monitor=HealthMonitor(),
        )

    return SimpleNamespace(pkg=pkg, make_engine=make_engine)


class Recorder:
    """Maps proposal ids to creation indices and drains events."""

    def __init__(self, engine):
        self.engine = engine
        self.rx = engine.event_bus().subscribe()
        self.index = {}  # (scope, pid) -> creation index
        self.pids = {}  # (scope, creation index) -> pid

    def created(self, scope, proposals):
        for p in proposals:
            k = len([1 for s, _ in self.index if s == scope])
            self.index[(scope, p.proposal_id)] = k
            self.pids[(scope, k)] = p.proposal_id

    def events(self):
        out = []
        while (item := self.rx.try_recv()) is not None:
            scope, ev = item
            out.append([scope, type(ev).__name__,
                        self.index.get((scope, ev.proposal_id), -1),
                        getattr(ev, "result", None), ev.timestamp])
        return out


def call(fn, *args):
    """Result of a call, or the name of the exception it raised."""
    try:
        out = fn(*args)
    except Exception as exc:  # the exception type is the result compared
        return ["raised", type(exc).__name__]
    if isinstance(out, np.ndarray):
        return out.tolist()
    return out


def call_ok(fn, *args):
    """``"ok"``, or the name of the exception the call raised."""
    out = call(fn, *args)
    return out if isinstance(out, list) and out[:1] == ["raised"] else "ok"


def results(api, engine, rec, scope):
    out = []
    for k in range(sum(1 for s, _ in rec.index if s == scope)):
        out.append(call(engine.get_consensus_result, scope, rec.pids[(scope, k)]))
    stats = engine.get_scope_stats(scope)
    return dict(
        results=out,
        stats=[stats.total_sessions, stats.active_sessions,
               stats.failed_sessions, stats.consensus_reached],
        active=len(engine.get_active_proposals(scope)),
        reached=sorted(
            [rec.index[(scope, p.proposal_id)], r]
            for p, r in engine.get_reached_proposals(scope)
        ),
    )


def request(api, i, n, expiry=100, live=True):
    return api.pkg.CreateProposalRequest(
        name=f"p{i}", payload=bytes([i % 251]), proposal_owner=b"owner",
        expected_voters_count=n, expiration_timestamp=expiry,
        liveness_criteria_yes=live,
    )


def scenario_scalar(api, seed):
    """create_proposal, cast_vote and process_incoming_vote, with the
    rejections the scalar path produces."""
    rng = np.random.default_rng(seed)
    pkg = api.pkg
    me = pkg.StubConsensusSigner(b"me")
    engine = api.make_engine(me, 64, 16)
    rec = Recorder(engine)
    engine.scope("p2p").p2p_preset().initialize()
    log = []
    for scope in ("gs", "p2p"):
        for i in range(6):
            n = int(rng.integers(1, 8))
            p = engine.create_proposal(scope, request(api, i, n, live=bool(i % 2)), NOW)
            rec.created(scope, [p])
        for step in range(40):
            k = int(rng.integers(0, 6))
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
                vote.proposal_id = 12345  # unknown session
            elif action < 0.33:
                now = NOW + 1000  # after expiry
            log.append(call(engine.process_incoming_vote, scope, vote, now))
        log.append(rec.events())
        log.append(results(api, engine, rec, scope))
    return log


def scenario_batch(api, seed):
    """ingest_votes batches across two scopes, validated and pre-validated,
    with chained votes inside one batch."""
    rng = np.random.default_rng(seed)
    pkg = api.pkg
    engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 64, 16)
    rec = Recorder(engine)
    engine.scope("p2p").p2p_preset().initialize()
    for scope in ("gs", "p2p"):
        rec.created(scope, engine.create_proposals(
            scope, [request(api, i, int(rng.integers(2, 12)), live=bool(i % 3))
                    for i in range(8)], NOW))
    signers = [pkg.StubConsensusSigner(bytes([1 + i])) for i in range(12)]
    log = []
    for wave in range(4):
        items = []
        shadow = {}  # (scope, k) -> proposal copy with this batch's votes
        for _ in range(40):
            scope = "gs" if rng.random() < 0.5 else "p2p"
            k = int(rng.integers(0, 8))
            if (scope, k) not in shadow:
                shadow[(scope, k)] = engine.get_proposal(scope, rec.pids[(scope, k)])
            prop = shadow[(scope, k)]
            signer = signers[int(rng.integers(0, 12))]
            vote = pkg.build_vote(prop, bool(rng.random() < 0.55), signer, NOW + 2 + wave)
            prop.votes.append(vote)  # next vote of the batch chains onto it
            items.append((scope, vote))
        log.append(call(engine.ingest_votes, items, NOW + 2 + wave, wave % 2 == 1))
        log.append(rec.events())
    for scope in ("gs", "p2p"):
        log.append(results(api, engine, rec, scope))
    return log


def scenario_columnar(api, seed):
    """ingest_columnar: a fresh wave, scan waves in max_depth segments,
    redelivery, unknown proposals, out-of-range and stale gids."""
    rng = np.random.default_rng(seed)
    pkg = api.pkg
    engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 96, 32, max_sessions=24)
    rec = Recorder(engine)
    engine.scope("p2p").p2p_preset().initialize()
    log = []
    for scope in ("gs", "p2p"):
        rec.created(scope, engine.create_proposals(
            scope, [request(api, i, int(rng.integers(1, 30)), live=bool(i % 2))
                    for i in range(20)], NOW))
    gids = np.array([engine.voter_gid(bytes([9, i])) for i in range(32)])
    waves = []
    for scope in ("gs", "p2p"):
        pids = np.array([rec.pids[(scope, k)] for k in range(20)])
        for w in range(3):
            rows = []
            for k in range(20):
                voters = rng.permutation(32)[: int(rng.integers(0, 12))]
                rows.extend((pids[k], gids[v], bool(rng.random() < 0.6)) for v in voters)
            rows.append((987654321, gids[0], True))  # unknown proposal
            rows.append((pids[0], 1 << 40, True))  # gid never interned
            order = rng.permutation(len(rows)) if w else np.arange(len(rows))
            cols = [np.array([rows[i][c] for i in order]) for c in range(3)]
            waves.append((scope, cols))
            log.append(call(engine.ingest_columnar, scope, *cols, NOW + 3 + w,
                            int(rng.choice([2, 4, 8]))))
            log.append(rec.events())
    scope, cols = waves[1]
    log.append(call(engine.ingest_columnar, scope, *cols, NOW + 9))  # redelivery
    log.append(rec.events())
    # Per-scope cap eviction frees slots; a stale gid then rejects.
    rec.created("gs", [engine.create_proposal("gs", request(api, 99, 3), NOW + 10)
                       for _ in range(6)])
    log.append(call(engine.ingest_columnar, "gs",
                    np.array([rec.pids[("gs", 20)]] * 3), gids[:3], np.ones(3, bool),
                    NOW + 11))
    log.append(rec.events())
    for scope in ("gs", "p2p"):
        log.append(results(api, engine, rec, scope))
    return log


def scenario_timeouts(api, seed):
    """Silent peers under both liveness settings, swept after expiry; one
    vote arrives after expiry; explicit per-session timeouts."""
    rng = np.random.default_rng(seed)
    pkg = api.pkg
    engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 64, 16)
    rec = Recorder(engine)
    engine.scope("p2p").p2p_preset().initialize()
    log = []
    for scope in ("gs", "p2p"):
        rec.created(scope, engine.create_proposals(
            scope, [request(api, i, int(rng.integers(1, 10)), expiry=int(rng.choice([10, 50])),
                            live=bool(i % 2)) for i in range(12)], NOW))
        gids = np.array([engine.voter_gid(bytes([5, i])) for i in range(10)])
        pids, vg, vals = [], [], []
        for k in range(12):
            for v in rng.permutation(10)[: int(rng.integers(0, 5))]:
                pids.append(rec.pids[(scope, k)])
                vg.append(gids[v])
                vals.append(bool(rng.random() < 0.5))
        log.append(call(engine.ingest_columnar, scope, np.array(pids), np.array(vg),
                        np.array(vals), NOW + 1))
        log.append(call(engine.ingest_columnar, scope, np.array(pids[:1]),
                        np.array(vg[-1:]), np.array([True]), NOW + 20))  # may be expired
    log.append(rec.events())
    log.append(sorted(
        [s, rec.index[(s, pid)], r] for s, pid, r in engine.sweep_timeouts(NOW + 20)
    ))
    log.append(rec.events())
    for scope in ("gs", "p2p"):
        for k in (0, 1, 2):
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


def scenario_scope_cap(api, seed):
    """Per-scope LRU eviction: scalar and batch creation at and past the
    cap, then votes to evicted and surviving sessions."""
    pkg = api.pkg
    engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 32, 8, max_sessions=5)
    rec = Recorder(engine)
    log = []
    rec.created("s", engine.create_proposals("s", [request(api, i, 3) for i in range(3)], NOW))
    for i in range(4):
        p = engine.create_proposal("s", request(api, 10 + i, 3), NOW + (i % 2))
        rec.created("s", [p])
        log.append(results(api, engine, rec, "s"))  # who survived this one
    rec.created("s", engine.create_proposals("s", [request(api, 20 + i, 3) for i in range(3)],
                                             NOW + 5))
    log.append(results(api, engine, rec, "s"))
    for k in range(10):
        log.append(call_ok(engine.cast_vote, "s", rec.pids[("s", k)], True, NOW + 6))
    log.append(rec.events())
    log.append(results(api, engine, rec, "s"))
    occupancy = engine.occupancy()
    log.append([occupancy["live_sessions"], occupancy["capacity"]])
    return log


SCENARIOS = {
    "scalar": scenario_scalar,
    "batch": scenario_batch,
    "columnar": scenario_columnar,
    "timeouts": scenario_timeouts,
    "scope_cap": scenario_scope_cap,
}
SEEDS = (0, 1)


def run_all(api):
    return {f"{name}-{seed}": fn(api, seed) for name, fn in SCENARIOS.items()
            for seed in SEEDS}


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's results, computed in a fresh interpreter."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
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


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_matches_reference(reference, port, name, seed):
    key = f"{name}-{seed}"
    ref_log, port_log = reference[key], port[key]
    assert len(port_log) == len(ref_log)
    for i, (a, b) in enumerate(zip(port_log, ref_log)):
        assert a == b, f"{key} step {i}"


def test_scenarios_exercise_the_paths(port):
    """The traces reach what they are meant to: decisions, rejections of
    several kinds, failures and timeouts."""
    flat = json.dumps(port)
    for needle in ("ConsensusReached", "ConsensusFailedEvent",
                   "InsufficientVotesAtTimeout", "DuplicateVote",
                   "InvalidVoteSignature", "SessionNotFound"):
        assert needle in flat, needle
    codes = set()
    for key, log in port.items():
        if key.startswith(("batch", "columnar", "timeouts")):
            for entry in log:
                if isinstance(entry, list) and entry and all(isinstance(x, int) for x in entry):
                    codes.update(entry)
    from hashgraph_tpu_torch.errors import StatusCode

    for code in ("OK", "ALREADY_REACHED", "DUPLICATE_VOTE", "SESSION_NOT_FOUND",
                 "EMPTY_VOTE_OWNER", "PROPOSAL_EXPIRED"):
        assert int(getattr(StatusCode, code)) in codes, code


if __name__ == "__main__" and sys.argv[1:] == ["--reference"]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(run_all(reference_api())))
