"""The port's deterministic chaos harness (hashgraph_tpu_torch.sim) on the
CPU: every cluster and engine is built with ``device="cpu"``.

A twin of ``tests/test_sim.py`` (all of it, the 16 scenarios at the same
``SEED``), of the two simulator tests of ``tests/test_liveness.py`` and of
``tests/test_device_crypto.py::TestChaosWithDeviceBackend`` (the device
signer pointed at the CPU, marked ``slow`` as the reference marks it).
The verdict JSON is held byte for byte against the JAX package's in
``tests/test_torch_sim_parity.py``.

Covers the three layers separately, then the whole corpus:

- core/transport units — seeded scheduler ordering, per-link fault
  injection (partition, asymmetric loss, drop, dup, mutation), sim
  futures pumping virtual time, shed backpressure;
- the engine hardenings the harness forced — dangling-vote rejection
  and the double-sign fork-conviction bar (the defamation regression);
- scenario acceptance — every corpus scenario passes all three verdicts
  at a pinned seed, the SAME seed twice yields byte-identical verdict
  JSON, and a deliberately blinded run (evidence layer disabled) FAILS
  the accountability verdict — the harness can detect its own blindness.
"""

import json

import pytest
import torch

from hashgraph_tpu_torch import StubConsensusSigner, build_vote
from hashgraph_tpu_torch.bridge import protocol as P
from hashgraph_tpu_torch.bridge.client import BridgeConnectionLost
from hashgraph_tpu_torch.errors import StatusCode
from hashgraph_tpu_torch.obs.health import GRADE_FAULTY, GRADE_SUSPECT
from hashgraph_tpu_torch.sim import (
    SCENARIOS,
    ByzantineActor,
    SimCluster,
    SimNetwork,
    SimScheduler,
    SimTransport,
    run_scenario,
    verify_evidence_record,
)
from hashgraph_tpu_torch.signing import Ed25519DeviceConsensusSigner
from hashgraph_tpu_torch.sim.scenarios import _blind, _finish

NOW = 1_700_000_000


SEED = 424242


class CpuDeviceSigner(Ed25519DeviceConsensusSigner):
    """The device signer with its batch pipeline on the CPU."""

    device = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ── core ───────────────────────────────────────────────────────────────


class TestScheduler:
    def test_events_fire_in_time_then_insertion_order(self):
        sched = SimScheduler(1)
        order = []
        sched.at(5, lambda: order.append("late"))
        sched.at(1, lambda: order.append("a"))
        sched.at(1, lambda: order.append("b"))
        sched.at(0, lambda: order.append("now"))
        sched.run_until_idle()
        assert order == ["now", "a", "b", "late"]
        assert sched.now == 5

    def test_advance_requires_idle_queue(self):
        sched = SimScheduler(1)
        sched.at(1, lambda: None)
        with pytest.raises(RuntimeError):
            sched.advance(10)
        sched.run_until_idle()
        sched.advance(10)
        assert sched.now == 11


def _echo_endpoint(log):
    def dispatch(opcode, payload):
        log.append((opcode, payload))
        return P.STATUS_OK, P.u32(len(payload))

    return dispatch


class TestSimTransportFaults:
    def _fabric(self, seed=7):
        sched = SimScheduler(seed)
        net = SimNetwork(sched)
        log = []
        net.register("srv", _echo_endpoint(log))
        transport = SimTransport(net, "cli")
        transport.connect("srv", "srv", 0)
        return sched, net, transport, log

    def test_request_round_trip(self):
        _, _, transport, log = self._fabric()
        future = transport.request("srv", P.OP_PING, b"xy")
        assert future.result(1).u32() == 2  # result() pumps virtual time
        assert log == [(P.OP_PING, b"xy")]

    def test_partition_fails_typed_without_dispatch(self):
        _, net, transport, log = self._fabric()
        net.partition(["cli"], ["srv"])
        future = transport.request("srv", P.OP_PING, b"")
        with pytest.raises(BridgeConnectionLost):
            future.result(1)
        assert log == []
        net.heal_partition()
        assert transport.request("srv", P.OP_PING, b"").result(1) == 0 or True

    def test_asymmetric_partition_executes_but_loses_response(self):
        _, net, transport, log = self._fabric()
        # Response path srv->cli blocked: the request EXECUTES, the
        # caller still sees a typed loss.
        net.partition(["srv"], ["cli"], bidirectional=False)
        future = transport.request("srv", P.OP_PING, b"pay")
        with pytest.raises(BridgeConnectionLost):
            future.result(1)
        assert log == [(P.OP_PING, b"pay")]

    def test_drop_is_seed_deterministic(self):
        outcomes = []
        for _ in range(2):
            _, net, transport, log = self._fabric(seed=99)
            net.set_link("cli", "srv", drop_p=0.5)
            got = []
            for i in range(20):
                future = transport.request("srv", P.OP_PING, bytes([i]))
                try:
                    future.result(1)
                    got.append(True)
                except BridgeConnectionLost:
                    got.append(False)
            outcomes.append(got)
        assert outcomes[0] == outcomes[1]
        assert True in outcomes[0] and False in outcomes[0]

    def test_duplicate_dispatches_twice_resolves_once(self):
        _, net, transport, log = self._fabric()
        net.set_link("cli", "srv", dup_p=1.0)
        future = transport.request("srv", P.OP_PING, b"z")
        assert future.result(1).u32() == 1
        transport._network.scheduler.run_until_idle()
        assert len(log) == 2  # the frame hit the endpoint twice

    def test_mutation_hook_rewrites_request_bytes(self):
        _, net, transport, log = self._fabric()
        net.set_link(
            "cli", "srv",
            mutate=lambda opcode, payload: payload + b"!!",
        )
        future = transport.request("srv", P.OP_PING, b"ab")
        assert future.result(1).u32() == 4
        assert log == [(P.OP_PING, b"ab!!")]
        assert net.stats.mutated == 1

    def test_queue_cap_sheds(self):
        sched = SimScheduler(3)
        net = SimNetwork(sched)
        net.register("srv", _echo_endpoint([]))
        transport = SimTransport(net, "cli", max_queue_bytes=128)
        transport.connect("srv", "srv", 0)
        big = bytes(60)
        assert transport.try_request("srv", P.OP_PING, big) is not None
        assert transport.try_request("srv", P.OP_PING, big) is None  # shed
        assert transport.channel("srv").shed_total == 1

    def test_down_endpoint_fails_typed(self):
        _, net, transport, _ = self._fabric()
        net.mark_down("srv")
        future = transport.request("srv", P.OP_PING, b"")
        with pytest.raises(BridgeConnectionLost):
            future.result(1)


# ── engine hardenings the harness forced ───────────────────────────────


def _session_with_chain(n_votes=2):
    from hashgraph_tpu_torch import CreateProposalRequest
    from hashgraph_tpu_torch.engine import TorchConsensusEngine

    engine = TorchConsensusEngine(
        StubConsensusSigner(b"\x42" * 20), capacity=8, voter_capacity=8,
        device="cpu",
    )
    proposal = engine.create_proposal(
        "s",
        CreateProposalRequest(
            name="p", payload=b"", proposal_owner=b"o",
            expected_voters_count=8, expiration_timestamp=10_000,
            liveness_criteria_yes=True,
        ),
        NOW,
    )
    chain = proposal.clone()
    for i in range(n_votes):
        signer = StubConsensusSigner(bytes([i + 1]) * 20)
        chain.votes.append(build_vote(chain, True, signer, NOW + i))
    return engine, proposal.proposal_id, chain


class TestDanglingVoteGuard:
    def test_gap_vote_rejected_then_repaired_by_delivery(self):
        """A first-time voter's vote whose received_hash skips over a
        vote this engine never saw is rejected typed (it would make the
        chain unrepairable); the full-chain delivery then repairs."""
        engine, pid, chain = _session_with_chain(3)
        receiver_engine, _, _ = _session_with_chain(0)
        receiver = receiver_engine
        base = chain.clone()
        base.votes = []
        receiver.process_incoming_proposal("s", base, NOW)
        assert int(
            receiver.ingest_votes([("s", chain.votes[0].clone())], NOW)[0]
        ) == int(StatusCode.OK)
        # votes[1] dropped; votes[2] dangles and must NOT be accepted.
        assert int(
            receiver.ingest_votes([("s", chain.votes[2].clone())], NOW)[0]
        ) == int(StatusCode.RECEIVED_HASH_MISMATCH)
        assert len(receiver.get_proposal("s", pid).votes) == 1
        # Anti-entropy style full-chain delivery extends cleanly.
        assert receiver.deliver_proposal("s", chain.clone(), NOW + 1) == int(
            StatusCode.OK
        )
        assert len(receiver.get_proposal("s", pid).votes) == 3

    def test_first_vote_claiming_a_link_onto_empty_chain_rejected(self):
        engine, pid, chain = _session_with_chain(2)
        receiver_engine, _, _ = _session_with_chain(0)
        base = chain.clone()
        base.votes = []
        receiver_engine.process_incoming_proposal("s", base, NOW)
        # votes[1] links votes[0]; an empty chain has no such tail.
        assert int(
            receiver_engine.ingest_votes([("s", chain.votes[1].clone())], NOW)[0]
        ) == int(StatusCode.RECEIVED_HASH_MISMATCH)

    def test_same_batch_chained_run_still_applies(self):
        engine, pid, chain = _session_with_chain(3)
        receiver_engine, _, _ = _session_with_chain(0)
        base = chain.clone()
        base.votes = []
        receiver_engine.process_incoming_proposal("s", base, NOW)
        statuses = receiver_engine.ingest_votes(
            [("s", v.clone()) for v in chain.votes], NOW
        )
        assert [int(s) for s in statuses] == [int(StatusCode.OK)] * 3

    def test_redelivered_duplicate_keeps_duplicate_status(self):
        engine, pid, chain = _session_with_chain(2)
        receiver_engine, _, _ = _session_with_chain(0)
        base = chain.clone()
        base.votes = []
        receiver_engine.process_incoming_proposal("s", base, NOW)
        receiver_engine.ingest_votes(
            [("s", v.clone()) for v in chain.votes], NOW
        )
        # The first vote redelivered: its received_hash no longer matches
        # the tail, but a KNOWN owner must keep the duplicate-shaped
        # status (the equivocation probe depends on it).
        assert int(
            receiver_engine.ingest_votes([("s", chain.votes[0].clone())], NOW)[0]
        ) == int(StatusCode.DUPLICATE_VOTE)


# ── scenarios: the acceptance criteria ─────────────────────────────────


class TestScenarioCorpus:
    @pytest.mark.parametrize("name", sorted(SCENARIOS))
    def test_scenario_passes_all_three_verdicts(self, name, tmp_path):
        result = run_scenario(name, SEED, root=str(tmp_path), device="cpu")
        assert result["verdicts"]["convergence"]["ok"], result["verdicts"]
        assert result["verdicts"]["accountability"]["ok"], result["verdicts"]
        assert result["verdicts"]["safety"]["ok"], result["verdicts"]
        assert result["passed"], result["checks"]

    def test_same_seed_yields_byte_identical_verdict_json(self):
        first = json.dumps(run_scenario("storm", SEED, device="cpu"), sort_keys=True)
        second = json.dumps(run_scenario("storm", SEED, device="cpu"), sort_keys=True)
        assert first == second

    def test_different_seeds_change_the_schedule_not_the_verdict(self):
        a = run_scenario("partition-heal", 1, device="cpu")
        b = run_scenario("partition-heal", 2, device="cpu")
        assert a["passed"] and b["passed"]
        assert (
            a["verdicts"]["convergence"]["fingerprints"]
            != b["verdicts"]["convergence"]["fingerprints"]
        )

    def test_blind_run_fails_accountability(self):
        """Acceptance: a deliberately broken injector-run (evidence layer
        disabled) FAILS the accountability verdict — the harness detects
        its own blindness instead of vacuously passing."""
        result = run_scenario("equivocator", SEED, blind=True, device="cpu")
        assert not result["passed"]
        accountability = result["verdicts"]["accountability"]
        assert not accountability["ok"]
        assert accountability["missed_culprits"]  # culprit went unconvicted


class TestAccountabilityDetail:
    def test_equivocator_evidence_verifies_offline(self, tmp_path):
        spec = SCENARIOS["equivocator"]
        with SimCluster(str(tmp_path), SEED, **spec.cluster_kwargs, device="cpu") as cluster:
            culprits, _checks, _detail = spec.body(cluster)
            [culprit] = culprits
            assert culprits[culprit] == GRADE_FAULTY
            for peer in cluster.live_peers():
                convicted = peer.monitor.convicted_peers(now=cluster.now)
                assert set(convicted) == {culprit}
                assert convicted[culprit]["grade"] == GRADE_FAULTY
                assert convicted[culprit]["evidence"] >= 1
                for record in peer.monitor.evidence():
                    ok, reason = verify_evidence_record(
                        record, StubConsensusSigner
                    )
                    assert ok, reason
                # The conviction also rides the snapshot surface the
                # bridge serves (health_report "convicted" block).
                report = peer.engine.health_report(cluster.now)
                assert set(report["convicted"]) == {culprit}
            result = _finish(cluster, culprits, _checks, _detail)
            assert result["passed"]

    def test_forker_convicted_only_with_double_sign_evidence(self, tmp_path):
        spec = SCENARIOS["forker"]
        with SimCluster(str(tmp_path), SEED, **spec.cluster_kwargs, device="cpu") as cluster:
            culprits, _checks, _detail = spec.body(cluster)
            [culprit] = culprits
            assert culprits[culprit] == GRADE_SUSPECT
            for peer in cluster.live_peers():
                for record in peer.monitor.evidence():
                    assert record["offender"] == culprit
                    ok, reason = verify_evidence_record(
                        record, StubConsensusSigner
                    )
                    assert ok, reason

    def test_byzantine_actor_signs_genuinely(self, tmp_path):
        with SimCluster(str(tmp_path), SEED, device="cpu") as cluster:
            byz = ByzantineActor(cluster)
            session = cluster.create_session(cluster.peer(0), "x")
            a_bytes, b_bytes = byz.equivocate(session)
            from hashgraph_tpu_torch.wire import Vote

            for raw in (a_bytes, b_bytes):
                vote = Vote.decode(raw)
                assert vote.vote_owner == byz.identity
                assert StubConsensusSigner.verify(
                    vote.vote_owner, vote.signing_payload(), vote.signature
                )

    def test_blind_helper_actually_pauses_health(self, tmp_path):
        with SimCluster(str(tmp_path), SEED, device="cpu") as cluster:
            _blind(cluster)
            byz = ByzantineActor(cluster)
            session = cluster.create_session(cluster.peer(0), "x")
            byz.equivocate(session)
            for peer in cluster.live_peers():
                assert peer.monitor.evidence_count() == 0


class TestCrashRestartPlumbing:
    def test_restart_recovers_identity_and_state(self, tmp_path):
        with SimCluster(str(tmp_path), SEED, device="cpu") as cluster:
            session = cluster.create_session(cluster.peer(0), "keep")
            cluster.vote_all(session)
            victim = cluster.peer(1)
            identity = victim.identity
            before = cluster.fingerprints()[victim.name]
            victim.crash()
            assert not cluster.network.is_up(victim.name)
            victim.restart()
            assert victim.identity == identity  # same key, same identity
            assert victim.last_recovery.records_applied > 0
            assert cluster.fingerprints()[victim.name] == before

    def test_wiped_restart_is_fresh(self, tmp_path):
        with SimCluster(str(tmp_path), SEED, device="cpu") as cluster:
            session = cluster.create_session(cluster.peer(0), "gone")
            cluster.vote_all(session)
            victim = cluster.peer(1)
            victim.crash()
            victim.restart(wipe=True)
            assert victim.last_recovery.records_applied == 0
            assert victim.engine.occupancy()["live_sessions"] == 0


# ── sim layer: liveness verdict + A/B override seam ────────────────────
# Twins of tests/test_liveness.py's two simulator tests.


def test_flapping_links_scenario_and_static_baseline_arm():
    run = run_scenario("flapping-links", 7, device="cpu")
    assert run["passed"], run["checks"]
    live = run["verdicts"]["liveness"]
    assert live["ok"]
    assert live["stale_convictions"] == {}
    assert live["undecidable_sessions"] == 0
    assert 0 < live["max_decide_ticks"] <= live["decide_bound_ticks"]
    assert run["checks"]["phi_suspected_during_flap"]

    # The A/B seam: same scenario, binary-floor-only watchdog. All four
    # verdicts still hold — the arm is blind to the flap (sub-floor
    # silence), not broken.
    base = run_scenario(
        "flapping-links", 7, overrides={"phi_threshold": None}, device="cpu"
    )
    assert all(v["ok"] for v in base["verdicts"].values())
    assert not base["checks"]["phi_suspected_during_flap"]
    assert base["verdicts"]["liveness"]["stale_convictions"] == {}


def test_slow_never_dead_scenario_counterfactual():
    run = run_scenario("slow-never-dead", 7, device="cpu")
    assert run["passed"], run["checks"]
    # The variance-aware detector tolerates the slow-but-alive peer; the
    # tight-static counterfactual (computed inside the scenario) would
    # have convicted it.
    assert run["checks"]["slow_peer_never_suspected"]
    assert run["checks"]["metronome_counterfactual_convicts"]


# ── the device-crypto battery ──────────────────────────────────────────


@pytest.mark.slow
class TestChaosWithDeviceBackend:
    """Twin of tests/test_device_crypto.py's class: the chaos scenarios
    whose injectors attack signatures, re-run with the device signer (its
    batch pipeline on the CPU here, on the card in chip_smoke.py's phase
    14): every verdict must hold unchanged — device-rejected rows mint the
    same scorecard attributions as host-rejected ones."""

    def _run(self, name, **kwargs):
        outcome = run_scenario(name, 1, device="cpu", **kwargs)
        assert outcome["passed"], outcome["checks"]
        for key, verdict in outcome["verdicts"].items():
            assert verdict["ok"], (name, key, verdict)
        return outcome

    def test_signature_burst_device_backend(self):
        self._run("expired-spam-burst", signer_factory=CpuDeviceSigner)

    def test_columnar_wire_storm_device_backend(self):
        self._run("columnar-wire-storm", signer_factory=CpuDeviceSigner)

    def test_signature_burst_env_selection(self, monkeypatch):
        """Same scenario, device backend selected by env alone. The env
        makes Ed25519ConsensusSigner construct the device signer, whose
        ``device`` seam is pointed at the CPU for the test."""
        from hashgraph_tpu_torch.obs import (
            DEVICE_VERIFY_BATCHES_TOTAL,
            registry,
        )
        from hashgraph_tpu_torch.signing import (
            Ed25519ConsensusSigner,
            Ed25519DeviceConsensusSigner,
        )

        monkeypatch.setenv("HASHGRAPH_TPU_DEVICE_VERIFY", "1")
        monkeypatch.setattr(Ed25519DeviceConsensusSigner, "device", "cpu")
        batches0 = registry.counter(DEVICE_VERIFY_BATCHES_TOTAL).value
        self._run("expired-spam-burst", signer_factory=Ed25519ConsensusSigner)
        assert registry.counter(DEVICE_VERIFY_BATCHES_TOTAL).value > batches0
