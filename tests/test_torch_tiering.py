"""Session tiering of the port: demote, page in, garbage-collect.

Three parts, all on ``TorchConsensusEngine(device="cpu")``:

1. Twins of ``tests/test_tiering.py``: each surface that pages a demoted
   session back in, the reads that go through the tier without promoting,
   the TTL policies of ``lifecycle_sweep`` (also as the end of
   ``sweep_timeouts``), pinned scopes, the per-scope cap counting demoted
   sessions, and the tier's keys in ``occupancy()``. Left out here: the
   JAX suite's metric-family test and the ``explain_decision`` half of its
   read test; the twin of its fleet-rollup test
   (``test_shared_rollup_carries_tier_keys``) is in
   ``tests/test_torch_rollup.py``.
2. ``run_identity_script``: a random create/vote/timeout/sweep script
   through a tiered engine (demotions sprinkled in) and an untiered twin,
   at the JAX suite's 12 seeds; statuses, results, stats, session keys and
   ``state_fingerprint`` must be equal (the JAX suite also compares health
   scorecards, which the port does not keep).
3. The same 12 scripts, and a policy scenario (TTL demotion and GC over
   columnar, wire-retaining and host-spilled sessions, a pinned scope, the
   per-scope cap), played on both packages under seeded ids: every logged
   status, result, stat, occupancy count and fingerprint must be equal.
   The JAX side runs in a subprocess (``python tests/test_torch_tiering.py
   --reference``), so this process leaves the JAX package's process-wide
   registries as it found them.

Tolerance everywhere: exact.
"""

import importlib
import random
import sys

import numpy as np
import pytest
from test_torch_wire_columnar import (
    port_api,
    reference_api,
    reference_run,
    seeded,
)

from hashgraph_tpu_torch import (
    CreateProposalRequest,
    ScopeConfig,
    SessionNotFound,
    StubConsensusSigner,
    TorchConsensusEngine,
    build_vote,
)
from hashgraph_tpu_torch.errors import ProposalAlreadyExist, StatusCode
from hashgraph_tpu_torch.sync import state_fingerprint
from hashgraph_tpu_torch.sync.snapshot import encode_session_item

NOW = 1_700_000_000
SIGNERS = [StubConsensusSigner(bytes([i + 1]) * 20) for i in range(4)]


def _engine(**kw) -> TorchConsensusEngine:
    kw.setdefault("capacity", 64)
    kw.setdefault("voter_capacity", 8)
    return TorchConsensusEngine(StubConsensusSigner(b"\x42" * 20), device="cpu", **kw)


def _request(n=3, name="prop", exp=50):
    return CreateProposalRequest(
        name=name, payload=b"payload", proposal_owner=b"owner",
        expected_voters_count=n, expiration_timestamp=exp, liveness_criteria_yes=True,
    )


def _author_proposal(n=3, name="prop", exp=50, now=NOW):
    """A proposal with a real pid, minted on a throwaway engine, so twins
    take identical bytes."""
    return _engine().create_proposal("author", _request(n, name, exp), now)


def _decide(engine, scope, proposal):
    """Drive a proposal to YES with chained signed votes."""
    votes, chain = [], proposal.clone()
    for i in range(proposal.expected_voters_count):
        vote = build_vote(chain, True, SIGNERS[i], NOW + 1)
        chain.votes.append(vote)
        votes.append(vote)
    statuses = engine.ingest_votes([(scope, v) for v in votes], NOW + 1)
    assert all(s in (int(StatusCode.OK), int(StatusCode.ALREADY_REACHED)) for s in statuses)
    return votes


# ── 1. Twins of tests/test_tiering.py ─────────────────────────────────


class TestDemotePromote:
    def test_fingerprint_invariant_across_demote_promote(self):
        engine = _engine()
        proposal = _author_proposal()
        engine.process_incoming_proposal("s", proposal.clone(), NOW)
        _decide(engine, "s", proposal)
        fp0 = state_fingerprint(engine)
        assert engine.demote_session("s", proposal.proposal_id) is True
        assert engine.demote_session("s", proposal.proposal_id) is False
        assert state_fingerprint(engine) == fp0
        assert engine.get_consensus_result("s", proposal.proposal_id) is True
        assert engine.occupancy()["tier_sessions"] == 0
        assert state_fingerprint(engine) == fp0

    def test_demoted_item_bytes_equal_snapshot_codec(self):
        engine = _engine()
        proposal = _author_proposal()
        engine.process_incoming_proposal("s", proposal.clone(), NOW)
        _decide(engine, "s", proposal)
        expected = encode_session_item("s", engine.export_session("s", proposal.proposal_id))
        engine.demote_session("s", proposal.proposal_id)
        assert engine._tier["s"][proposal.proposal_id].item == expected

    def test_columnar_tally_session_roundtrip(self):
        """A session decided by columnar tallies demotes field-direct and
        comes back (on the host: it carries tallies)."""
        engine = _engine()
        proposal = _author_proposal(n=2)
        engine.process_incoming_proposal("s", proposal.clone(), NOW)
        gids = np.array([engine.voter_gid(s.identity()) for s in SIGNERS[:2]], np.int64)
        pid = proposal.proposal_id
        statuses = engine.ingest_columnar(
            "s", np.array([pid, pid], np.int64), gids, np.array([True, True]), NOW + 1
        )
        assert list(statuses) == [0, 0]
        fp0 = state_fingerprint(engine)
        engine.demote_session("s", pid)
        assert state_fingerprint(engine) == fp0
        session = engine.export_session("s", pid)  # promotes
        assert session.state.is_reached and session.state.result is True
        assert len(session.tallies) == 2
        assert state_fingerprint(engine) == fp0

    def test_host_spilled_session_demotes(self):
        engine = _engine(voter_capacity=2)
        proposal = _author_proposal(n=3)  # 3 voters > 2 lanes: served on the host
        engine.process_incoming_proposal("s", proposal.clone(), NOW)
        assert engine.occupancy()["host_spilled"] == 1
        fp0 = state_fingerprint(engine)
        engine.demote_session("s", proposal.proposal_id)
        assert engine.occupancy()["host_spilled"] == 0
        assert state_fingerprint(engine) == fp0
        assert engine.get_consensus_result("s", proposal.proposal_id) is None
        assert engine.occupancy()["host_spilled"] == 1

    def test_unknown_session_raises(self):
        with pytest.raises(SessionNotFound):
            _engine().demote_session("s", 12345)


class TestDemandPaging:
    def _demoted_active(self, engine, n=3, exp=50):
        proposal = _author_proposal(n=n, exp=exp)
        engine.process_incoming_proposal("s", proposal.clone(), NOW)
        engine.demote_session("s", proposal.proposal_id)
        return proposal

    def test_late_vote_promotes_and_applies(self):
        engine = _engine()
        proposal = self._demoted_active(engine)
        vote = build_vote(proposal, True, SIGNERS[0], NOW + 1)
        assert list(engine.ingest_votes([("s", vote)], NOW + 1)) == [int(StatusCode.OK)]
        assert engine.occupancy()["tier_sessions"] == 0
        assert engine.occupancy()["tier_promotions_total"] == 1

    def test_columnar_late_vote_promotes(self):
        engine = _engine()
        proposal = self._demoted_active(engine, n=2)
        gid = engine.voter_gid(SIGNERS[0].identity())
        statuses = engine.ingest_columnar(
            "s", np.array([proposal.proposal_id], np.int64), np.array([gid], np.int64),
            np.array([True]), NOW + 1,
        )
        assert list(statuses) == [int(StatusCode.OK)]
        assert engine.occupancy()["tier_sessions"] == 0

    def test_proposal_reads_promote(self):
        """The ``get_proposal`` half of the JAX suite's
        ``test_explain_and_proposal_reads_promote``."""
        engine = _engine()
        proposal = self._demoted_active(engine)
        assert engine.get_proposal("s", proposal.proposal_id).proposal_id == proposal.proposal_id
        assert engine.occupancy()["tier_sessions"] == 0

    def test_deliver_extension_promotes(self):
        engine = _engine()
        proposal = self._demoted_active(engine)
        extended = proposal.clone()
        extended.votes.append(build_vote(extended, True, SIGNERS[0], NOW + 1))
        assert engine.deliver_proposal("s", extended, NOW + 1) == int(StatusCode.OK)
        assert len(engine.export_session("s", proposal.proposal_id).votes) == 1

    def test_strict_redelivery_rejects_without_promoting(self):
        engine = _engine()
        proposal = self._demoted_active(engine)
        with pytest.raises(ProposalAlreadyExist):
            engine.process_incoming_proposal("s", proposal.clone(), NOW + 1)
        statuses = engine.ingest_proposals([("s", proposal.clone())], NOW + 1)
        assert statuses == [int(StatusCode.PROPOSAL_ALREADY_EXIST)]
        assert engine.occupancy()["tier_sessions"] == 1

    def test_timeout_on_demoted_session(self):
        engine = _engine()
        proposal = self._demoted_active(engine)
        engine.ingest_votes([("s", build_vote(proposal, True, SIGNERS[0], NOW + 1))], NOW + 1)
        engine.demote_session("s", proposal.proposal_id)
        assert engine.handle_consensus_timeout("s", proposal.proposal_id, NOW + 100) is True

    def test_sweep_fires_timeouts_for_demoted_sessions(self):
        engine = _engine()
        proposal = self._demoted_active(engine, exp=10)
        engine.ingest_votes([("s", build_vote(proposal, True, SIGNERS[0], NOW + 1))], NOW + 1)
        engine.demote_session("s", proposal.proposal_id)
        assert ("s", proposal.proposal_id, True) in engine.sweep_timeouts(NOW + 11)

    def test_enumeration_reads_through_without_promoting(self):
        engine = _engine()
        active = self._demoted_active(engine, n=3)
        decided = _author_proposal(n=2, name="decided")
        engine.process_incoming_proposal("s", decided.clone(), NOW)
        _decide(engine, "s", decided)
        engine.demote_session("s", decided.proposal_id)
        stats = engine.get_scope_stats("s")
        assert (stats.total_sessions, stats.active_sessions, stats.consensus_reached) == (2, 1, 1)
        assert [p.proposal_id for p in engine.get_active_proposals("s")] == [active.proposal_id]
        assert [(p.proposal_id, r) for p, r in engine.get_reached_proposals("s")] == [
            (decided.proposal_id, True)
        ]
        assert set(engine.session_keys()) == {("s", active.proposal_id),
                                              ("s", decided.proposal_id)}
        assert engine.occupancy()["tier_sessions"] == 2


class TestLifecyclePolicy:
    def _tiered_scope(self, engine, demote=5.0, evict=None):
        engine.set_scope_config("s", ScopeConfig(demote_after=demote, evict_decided_after=evict))

    def _decided(self, engine, name):
        proposal = _author_proposal(n=2, name=name)
        engine.process_incoming_proposal("s", proposal.clone(), NOW)
        _decide(engine, "s", proposal)
        return proposal

    def test_ttl_demotes_idle_then_gc(self):
        engine = _engine()
        self._tiered_scope(engine, demote=5.0, evict=20.0)
        proposal = self._decided(engine, "x")
        assert engine.lifecycle_sweep(NOW + 3) == {"demoted": 0, "gc_live": 0, "gc_tier": 0}
        assert engine.lifecycle_sweep(NOW + 7)["demoted"] == 1
        assert engine.occupancy()["tier_sessions"] == 1
        assert engine.lifecycle_sweep(NOW + 30)["gc_tier"] == 1
        assert engine.occupancy()["tier_sessions"] == 0
        with pytest.raises(SessionNotFound):
            engine.get_consensus_result("s", proposal.proposal_id)

    def test_gc_live_without_demotion_window(self):
        engine = _engine()
        self._tiered_scope(engine, demote=None, evict=5.0)
        self._decided(engine, "y")
        assert engine.lifecycle_sweep(NOW + 10)["gc_live"] == 1
        assert engine.occupancy()["tier_gc_total"] == 1

    def test_active_sessions_never_gc(self):
        engine = _engine()
        self._tiered_scope(engine, demote=2.0, evict=4.0)
        proposal = _author_proposal(n=3, name="z", exp=1000)
        engine.process_incoming_proposal("s", proposal.clone(), NOW)
        engine.lifecycle_sweep(NOW + 100)
        occ = engine.occupancy()
        assert occ["tier_sessions"] == 1 and occ["tier_gc_total"] == 0

    def test_pinned_scope_excluded(self):
        engine = _engine()
        self._tiered_scope(engine, demote=1.0, evict=2.0)
        self._decided(engine, "pin")
        engine.pin_scope("s")
        assert engine.lifecycle_sweep(NOW + 100) == {"demoted": 0, "gc_live": 0, "gc_tier": 0}
        engine.unpin_scope("s")
        assert engine.lifecycle_sweep(NOW + 100)["gc_live"] == 1

    def test_sweep_timeouts_runs_lifecycle(self):
        engine = _engine()
        self._tiered_scope(engine, demote=5.0)
        self._decided(engine, "sw")
        engine.sweep_timeouts(NOW + 7)
        assert engine.occupancy()["tier_sessions"] == 1

    def test_promotion_preserves_idle_clock(self):
        """Demoted, paged in, and demoted again at the TTL point it would
        have had without the round trip."""
        engine = _engine()
        self._tiered_scope(engine, demote=10.0)
        proposal = self._decided(engine, "clock")  # last activity NOW + 1
        engine.lifecycle_sweep(NOW + 12)
        assert engine.occupancy()["tier_sessions"] == 1
        assert engine.get_consensus_result("s", proposal.proposal_id) is True
        assert engine.lifecycle_sweep(NOW + 13)["demoted"] == 1

    def test_promotion_keeps_the_gc_clock(self):
        """A session decided at NOW + 10, demoted and paged back in, is
        not collected at NOW + 25 under a 20 s TTL: its idle clock is the
        decision's, not its creation's."""
        engine = _engine()
        self._tiered_scope(engine, demote=5.0, evict=20.0)
        proposal = _author_proposal(n=2, name="gc-clock")
        engine.process_incoming_proposal("s", proposal.clone(), NOW)
        chain = proposal.clone()
        for signer in SIGNERS[:2]:
            vote = build_vote(chain, True, signer, NOW + 10)
            chain.votes.append(vote)
            engine.ingest_votes([("s", vote)], NOW + 10)
        assert engine.lifecycle_sweep(NOW + 16)["demoted"] == 1
        assert engine.get_consensus_result("s", proposal.proposal_id) is True
        assert engine.lifecycle_sweep(NOW + 25) == {"demoted": 1, "gc_live": 0, "gc_tier": 0}
        assert engine.lifecycle_sweep(NOW + 31)["gc_tier"] == 1

    def test_sweep_is_inert_in_replay_mode(self):
        """Recovery applies the logged GC outcome instead of re-deriving
        the TTLs: under ``set_replay_mode`` the sweep does nothing."""
        engine = _engine()
        self._tiered_scope(engine, demote=1.0, evict=2.0)
        self._decided(engine, "replay")
        engine.set_replay_mode(True)
        assert engine.lifecycle_sweep(NOW + 100) == {"demoted": 0, "gc_live": 0, "gc_tier": 0}
        engine.set_replay_mode(False)
        assert engine.lifecycle_sweep(NOW + 100)["gc_live"] == 1


class TestCapEquivalence:
    def test_demoted_sessions_count_against_the_scope_cap(self):
        tiered = _engine(max_sessions_per_scope=3)
        plain = _engine(max_sessions_per_scope=3)
        proposals = [_author_proposal(n=2, name=f"c{i}") for i in range(5)]
        for k, proposal in enumerate(proposals):
            for engine in (tiered, plain):
                engine.process_incoming_proposal("s", proposal.clone(), NOW + k)
            if k == 1:
                tiered.demote_session("s", proposals[0].proposal_id)
        assert state_fingerprint(tiered) == state_fingerprint(plain)
        assert set(tiered.session_keys()) == set(plain.session_keys())
        assert len(tiered.session_keys()) == 3

    def test_batch_creation_counts_demoted_sessions(self):
        """``create_proposals`` counts demoted sessions against the cap,
        and its id draw avoids their ids."""
        tiered = _engine(max_sessions_per_scope=3)
        plain = _engine(max_sessions_per_scope=3)
        for engine in (tiered, plain):
            engine.create_proposals("s", [_request(name="a"), _request(name="b")], NOW)
        tiered.demote_session("s", tiered.session_keys()[0][1])
        for k, engine in enumerate((tiered, plain)):
            made = engine.create_proposals("s", [_request(name="c"), _request(name="d")], NOW + 1)
            assert len(made) == 2
            assert len(engine.session_keys()) == 3
        assert tiered.get_scope_stats("s").total_sessions == 3


class TestAccounting:
    def test_occupancy_tier_counters(self):
        engine = _engine()
        proposal = _author_proposal(n=2)
        engine.process_incoming_proposal("s", proposal.clone(), NOW)
        _decide(engine, "s", proposal)
        engine.demote_session("s", proposal.proposal_id)
        occ = engine.occupancy()
        assert occ["tier_sessions"] == 1 and occ["tier_bytes"] > 0
        assert (occ["tier_demotions_total"], occ["tier_promotions_total"]) == (1, 0)
        engine.get_consensus_result("s", proposal.proposal_id)
        occ = engine.occupancy()
        assert (occ["tier_sessions"], occ["tier_bytes"]) == (0, 0)
        assert occ["tier_promotions_total"] == 1

    def test_gc_sessions_drops_live_and_demoted(self):
        engine = _engine()
        a, b = (_author_proposal(n=2, name=n) for n in ("a", "b"))
        for p in (a, b):
            engine.process_incoming_proposal("s", p.clone(), NOW)
        engine.demote_session("s", b.proposal_id)
        keys = [("s", a.proposal_id), ("s", b.proposal_id), ("s", 1), ("t", a.proposal_id)]
        assert engine.gc_sessions(keys) == 2
        assert engine.gc_sessions(keys) == 0  # idempotent
        occ = engine.occupancy()
        assert (occ["live_sessions"], occ["tier_sessions"], occ["tier_gc_total"]) == (0, 0, 2)
        # The demoted active session left the sweep's side map too.
        assert engine._tier_active == {}

    def test_delete_scope_drops_the_tier(self):
        engine = _engine()
        proposal = _author_proposal(n=2)
        engine.process_incoming_proposal("s", proposal.clone(), NOW)
        engine.demote_session("s", proposal.proposal_id)
        engine.pin_scope("s")
        engine.delete_scope("s")
        occ = engine.occupancy()
        assert (occ["tier_sessions"], occ["tier_bytes"]) == (0, 0)
        assert engine.session_keys() == [] and engine._pinned_scopes == set()


# ── 2./3. Identity scripts and the policy scenario ────────────────────


def _sync(api):
    return importlib.import_module(api.pkg.__name__ + ".sync")


def _raised(fn, *args):
    try:
        return [fn(*args), None]
    except Exception as exc:  # the exception type is the result compared
        return [None, type(exc).__name__]


def play_identity_script(api, script):
    """``script`` through a tiered engine and an untiered twin of one
    package: their statuses, results, stats, keys and fingerprints must
    agree (asserted here). Returns the log of what the untiered twin
    answered and the terminal fingerprint, for the cross-package compare."""
    pkg, fingerprint = api.pkg, _sync(api).state_fingerprint
    signers = [pkg.StubConsensusSigner(bytes([i + 1]) * 20) for i in range(4)]
    author = api.make_engine(pkg.StubConsensusSigner(b"\x42" * 20), 64, 8)

    def engine():
        return api.make_engine(pkg.StubConsensusSigner(b"\x42" * 20), 64, 8, max_sessions=5)

    tiered, plain = engine(), engine()
    sessions, log, clock, n_created = [], [], NOW, 0
    for op in script:
        kind = op[0]
        if kind == "create":
            proposal = author.create_proposal("author", pkg.CreateProposalRequest(
                name=f"p{n_created}", payload=b"payload", proposal_owner=b"owner",
                expected_voters_count=op[1], expiration_timestamp=50,
                liveness_criteria_yes=True), clock)
            n_created += 1
            outs = [_raised(e.process_incoming_proposal, "s", proposal.clone(), clock)[1]
                    for e in (tiered, plain)]
            assert outs[0] == outs[1]
            log.append(outs[1])
            if outs[1] is None:
                sessions.append((proposal.proposal_id, proposal.clone()))
        elif kind == "vote" and sessions:
            pid, chain = sessions[op[1] % len(sessions)]
            vote = pkg.build_vote(chain, op[3], signers[op[2]], clock)
            st = [e.ingest_votes([("s", vote)], clock).tolist() for e in (tiered, plain)]
            assert st[0] == st[1]
            log.append(st[1])
            if st[1][0] == int(api.StatusCode.OK):
                chain.votes.append(vote.clone())
        elif kind == "timeout" and sessions:
            pid = sessions[op[1] % len(sessions)][0]
            outs = [_raised(e.handle_consensus_timeout, "s", pid, clock) for e in (tiered, plain)]
            assert outs[0] == outs[1]
            log.append(outs[1])
        elif kind == "sweep":
            clock += op[1]
            swept = [sorted(e.sweep_timeouts(clock)) for e in (tiered, plain)]
            assert swept[0] == swept[1]
            log.append([list(t) for t in swept[1]])
        elif kind in ("demote", "demote_all") and sessions:
            picks = [sessions[op[1] % len(sessions)]] if kind == "demote" else sessions
            for pid, _ in picks:
                try:
                    tiered.demote_session("s", pid)
                except pkg.SessionNotFound:
                    pass  # evicted on both twins by the scope cap
    view = []
    for e in (tiered, plain):
        stats = e.get_scope_stats("s")
        results = [_raised(e.get_consensus_result, "s", pid) for pid, _ in sessions]
        view.append([fingerprint(e), sorted(e.session_keys()), [
            stats.total_sessions, stats.active_sessions, stats.failed_sessions,
            stats.consensus_reached], results])
    assert view[0] == view[1]
    return [log, view[1]]


def _random_script(rng, n_ops):
    """The JAX suite's op mix (tests/test_tiering.py::_random_script)."""
    ops = []
    for _ in range(n_ops):
        roll = rng.random()
        if roll < 0.25:
            ops.append(("create", rng.randint(1, 4)))
        elif roll < 0.55:
            ops.append(("vote", rng.randrange(8), rng.randrange(4), rng.random() < 0.6))
        elif roll < 0.65:
            ops.append(("timeout", rng.randrange(8)))
        elif roll < 0.78:
            ops.append(("sweep", rng.randint(1, 30)))
        elif roll < 0.92:
            ops.append(("demote", rng.randrange(8)))
        else:
            ops.append(("demote_all",))
    return ops


SEEDS = range(12)


def seeded_script(seed):
    rng = random.Random(1000 + seed)
    return _random_script(rng, rng.randint(5, 20))


def policy_scenario(api):
    """TTL demotion and GC through ``sweep_timeouts`` and standalone
    ``lifecycle_sweep`` over pooled columnar, wire-retaining, signed-vote
    and host-spilled sessions, with a pinned scope, late columnar votes
    and reads that page sessions in, and a capped scope. Returns a log of
    every answer, with ``occupancy()`` and the fingerprint after each
    step."""
    pkg, fingerprint = api.pkg, _sync(api).state_fingerprint
    signers = [pkg.StubConsensusSigner(b"voter-%02d" % i) for i in range(6)]
    log = []
    with seeded(api, 4242):
        engine = api.make_engine(pkg.StubConsensusSigner(b"node"), 12, 4, max_sessions=8)
        for scope in ("t", "pinned"):
            engine.set_scope_config(scope, pkg.ScopeConfig(demote_after=10.0,
                                                           evict_decided_after=40.0))
        reqs = [pkg.CreateProposalRequest(
            name=f"q{i}", payload=bytes([i]), proposal_owner=b"o",
            expected_voters_count=3 if i < 6 else 5, expiration_timestamp=30 + 10 * (i % 3),
            liveness_criteria_yes=i % 2 == 0) for i in range(8)]
        made = engine.create_proposals("t", reqs, NOW)  # 2 of 5 voters: on the host
        pinned = engine.create_proposals("pinned", reqs[:2], NOW)
        pids = [p.proposal_id for p in made]
        gids = [engine.voter_gid(s.identity()) for s in signers]

        def step(label, value):
            log.append([label, value, engine.occupancy(), fingerprint(engine)])

        # Columnar tallies on 0-1, signed votes on 2-3, wire-retained on 4-5,
        # host tallies on 6-7.
        rows = [0, 0, 1, 6, 6, 7]
        st = engine.ingest_columnar("t", np.array([pids[i] for i in rows], np.int64),
                                    np.array([gids[0], gids[1], gids[0], gids[0], gids[1],
                                              gids[2]], np.int64),
                                    np.array([True, True, False, True, True, True]), NOW + 1)
        step("columnar", st.tolist())
        votes = []
        for i in (2, 3):
            chain = engine.get_proposal("t", pids[i])
            for s in signers[:2 if i == 2 else 1]:
                vote = pkg.build_vote(chain, True, s, NOW + 2)
                chain.votes.append(vote)
                votes.append(("t", vote))
        step("votes", engine.ingest_votes(votes, NOW + 2).tolist())
        wire = []
        for i in (4, 5):
            vote = pkg.build_vote(engine.get_proposal("t", pids[i]), i == 4, signers[3], NOW + 3)
            wire.append(vote.encode())
        st = engine.ingest_columnar("t", np.array(pids[4:6], np.int64),
                                    np.array([gids[3], gids[3]], np.int64),
                                    np.array([True, False]), NOW + 3, wire_votes=wire)
        step("wire", st.tolist())
        engine.pin_scope("pinned")
        step("sweep 15", [list(t) for t in sorted(engine.sweep_timeouts(NOW + 15))])
        gids = [engine.voter_gid(s.identity()) for s in signers]  # demotion freed them
        st = engine.ingest_columnar("t", np.array([pids[0], pids[2], pids[7], pids[4]], np.int64),
                                    np.array([gids[2], gids[4], gids[3], gids[4]], np.int64),
                                    np.array([True, False, True, True]), NOW + 16)
        step("late columnar", st.tolist())
        step("reads", [_raised(engine.get_consensus_result, "t", pids[i])
                       for i in (1, 3, 5)])
        step("proposal read", engine.get_proposal("t", pids[6]).encode().hex())
        step("lifecycle 28", engine.lifecycle_sweep(NOW + 28))
        step("sweep 45", [list(t) for t in sorted(engine.sweep_timeouts(NOW + 45))])
        engine.unpin_scope("pinned")
        step("lifecycle 70", engine.lifecycle_sweep(NOW + 70))
        extra = engine.create_proposals("t", [pkg.CreateProposalRequest(
            name=f"r{i}", payload=b"", proposal_owner=b"o", expected_voters_count=2,
            expiration_timestamp=500, liveness_criteria_yes=True) for i in range(7)], NOW + 71)
        step("capped create", [p.proposal_id for p in extra])
        step("stats", [[s.total_sessions, s.active_sessions, s.failed_sessions,
                        s.consensus_reached] for s in map(engine.get_scope_stats, ("t", "pinned"))])
        step("keys", sorted(engine.session_keys(), key=repr))
        step("gc", engine.gc_sessions([("t", p.proposal_id) for p in extra[:3]]
                                      + [("pinned", pinned[0].proposal_id)]))
        step("sweep 600", [list(t) for t in sorted(engine.sweep_timeouts(NOW + 600))])
    return log


def reference_logs():
    api = reference_api()
    scripts = []
    for seed in SEEDS:
        with seeded(api, 9000 + seed):
            scripts.append(play_identity_script(api, seeded_script(seed)))
    return {"scripts": scripts, "policy": policy_scenario(api)}


@pytest.fixture(scope="module")
def reference():
    return reference_run(__file__)


def run_identity_script(script):
    """The tiered-vs-untiered identity check on the port alone (shared
    with tests/test_torch_property_tiering.py)."""
    return play_identity_script(port_api(), script)


@pytest.mark.parametrize("seed", SEEDS)
def test_tiered_untiered_decision_identity_seeded(seed):
    run_identity_script(seeded_script(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_identity_script_matches_reference(reference, seed):
    """The script's answers and terminal fingerprint equal the JAX
    package's (seeded ids: both packages mint the same proposals and
    votes)."""
    api = port_api()
    with seeded(api, 9000 + seed):
        port = play_identity_script(api, seeded_script(seed))
    assert _json(port) == reference["scripts"][seed]


def test_policy_scenario_matches_reference(reference):
    log = policy_scenario(port_api())
    assert [entry[0] for entry in log] == [entry[0] for entry in reference["policy"]]
    for mine, theirs in zip(_json(log), reference["policy"]):
        assert mine == theirs, mine[0]
    # The scenario went through every tier route.
    final = {entry[0]: entry for entry in log}
    assert final["sweep 15"][2]["tier_demotions_total"] > 0
    assert final["late columnar"][2]["tier_promotions_total"] > 0
    assert final["sweep 600"][2]["tier_gc_total"] > 0


def _json(value):
    import json

    return json.loads(json.dumps(value, default=_plain))


def _plain(value):
    if isinstance(value, bytes):
        return value.hex()
    if isinstance(value, (np.integer, np.bool_)):
        return int(value)
    raise TypeError(type(value))


if __name__ == "__main__" and sys.argv[1] == "--reference":
    import json

    import jax

    jax.config.update("jax_platforms", "cpu")
    logs = reference_logs()
    print(json.dumps(_json(logs)))
