"""The port's ``ConsensusService`` against the JAX package's.

The cases of ``tests/test_service.py``, ``tests/test_tpu_backed_service.py``
and the threaded ones of ``tests/test_concurrency.py`` run as scenarios
written once and played on both packages, over the in-memory storage and
over the pool-backed one (the port's ``TorchBackedStorage(device="cpu")``
against the JAX package's ``TpuBackedStorage``), with seeded proposal ids
and deterministic stub signers. Each scenario asserts the case itself and
returns what it observed (return values or exception names, events, stats,
device states); the port's observations must equal the JAX package's, and
every pool the scenario built must equal its JAX twin array for array.

The differential plays ``chip_smoke.py``'s phase-9 backlog at 4 scopes x 11
proposals x 8 voters plus one host-only proposal, with stub and Ethereum
signers, through the JAX service over both JAX storages and the port's over
both twins: outcomes, events, stats, results and ``device_state_of`` must be
equal, and the port's pool equal to the JAX pool (tolerance: exact). None of
the JAX package's service, storage or pool modules touches its process-wide
observability state, so the JAX side runs in this process.
"""

import sys
import threading
from pathlib import Path

import pytest
import torch

from test_torch_pool import assert_pools_equal
from test_torch_storage import PORT, REF, outcome, seeded_ids

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

NOW = 1_700_000_000
SCOPE = "service_scope"
EXPIRATION = 120
BACKENDS = ("in_memory", "pool")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class World:
    """One package's side of a scenario: storages of the chosen backend,
    deterministic stub signers, services and their events."""

    def __init__(self, pkg, backend, sizes):
        self.pkg, self.ht, self.backend, self.sizes = pkg, pkg.ht, backend, sizes
        self.storages, self.receivers, self.count = [], [], 0

    def storage(self):
        made = make_storage(self.pkg, self.backend, **self.sizes)
        self.storages.append(made)
        return made

    def signer(self):
        self.count += 1
        return self.ht.StubConsensusSigner(b"peer-%015d" % self.count)

    def service(self, max_sessions=10, storage=None, bus=None):
        storage = storage if storage is not None else self.storage()
        bus = bus if bus is not None else self.ht.BroadcastEventBus()
        self.receivers.append(bus.subscribe())
        return self.ht.ConsensusService(storage, bus, self.signer(), max_sessions)

    def sibling(self, service):
        return self.ht.ConsensusService(service.storage(), service.event_bus(), self.signer())

    def events(self, k=0):
        out = []
        while (item := self.receivers[k].try_recv()) is not None:
            scope, ev = item
            out.append((scope, type(ev).__name__, ev.proposal_id,
                        getattr(ev, "result", None), ev.timestamp))
        return out

    def create(self, service, scope=SCOPE, n=3, config=None, liveness=True, now=NOW,
               expiration=EXPIRATION):
        request = self.ht.CreateProposalRequest(
            name="Service Test", payload=b"payload", proposal_owner=service.signer().identity(),
            expected_voters_count=n, expiration_timestamp=expiration,
            liveness_criteria_yes=liveness)
        return service.create_proposal_with_config(
            scope, request, config or self.ht.ConsensusConfig.gossipsub(), now)

    def remote(self, service, pid, choice, scope=SCOPE, signer=None, now=NOW):
        """Build and deliver a vote as from a remote peer."""
        proposal = service.storage().get_proposal(scope, pid)
        vote = self.ht.build_vote(proposal, choice, signer or self.signer(), now)
        return outcome(lambda: service.process_incoming_vote(scope, vote.clone(), now))

    def stats(self, service, scope=SCOPE):
        st = service.get_scope_stats(scope)
        return st.total_sessions, st.active_sessions, st.failed_sessions, st.consensus_reached


def make_storage(pkg, backend, **sizes):
    """A storage of the backend; ``sizes`` size the pool-backed one."""
    return pkg.backends[backend](**sizes) if backend == "pool" else pkg.backends[backend]()


def play(scenario, backend, seed=0, pools=True, **sizes):
    """Run a scenario on both packages: equal observations and, unless
    ``pools`` is False (threads order the slots), equal pools."""
    worlds, observed = {}, {}
    for pkg in (REF, PORT):
        with seeded_ids(pkg, seed):
            world = World(pkg, backend, sizes)
            observed[pkg.name] = scenario(world)
            worlds[pkg.name] = world
    assert observed["port"] == observed["jax"]
    if backend == "pool" and pools:
        for ref_storage, port_storage in zip(worlds["jax"].storages, worlds["port"].storages):
            assert_pools_equal(ref_storage.pool(), port_storage.pool())
    return observed["port"]


def _raises(name, fn):
    got = outcome(fn)
    assert got == name, got
    return got


# ── tests/test_service.py ───────────────────────────────────────────────


def basic_reach_consensus(w):
    service = w.service()
    pid = w.create(service).proposal_id
    vote = service.cast_vote(SCOPE, pid, True, NOW)
    assert vote.vote_owner == service.signer().identity()
    _raises("ConsensusNotReached", lambda: service.storage().get_consensus_result(SCOPE, pid))
    w.remote(service, pid, True)
    assert service.storage().get_consensus_result(SCOPE, pid) is True
    return vote.encode(), w.events()


def basic_cast_and_get_proposal(w):
    service = w.service()
    pid = w.create(service, n=5).proposal_id
    updated = service.cast_vote_and_get_proposal(SCOPE, pid, True, NOW)
    assert len(updated.votes) == 1
    assert updated.votes[0].vote_owner == service.signer().identity()
    return updated.encode()


def basic_multi_scope_isolation(w):
    service = w.service()
    p1, p2 = w.create(service, scope="scope_a"), w.create(service, scope="scope_b")
    storage = service.storage()
    assert storage.get_session("scope_a", p2.proposal_id) is None
    assert storage.get_session("scope_b", p1.proposal_id) is None
    storage.delete_scope("scope_a")
    assert storage.get_session("scope_a", p1.proposal_id) is None
    assert storage.get_session("scope_b", p2.proposal_id) is not None


def basic_incoming_proposal_roundtrip(w):
    origin = w.service()
    pid = w.create(origin, n=5).proposal_id
    origin.cast_vote(SCOPE, pid, True, NOW)
    snapshot = origin.storage().get_proposal(SCOPE, pid)
    receiver = w.service()
    receiver.process_incoming_proposal(SCOPE, snapshot.clone(), NOW)
    stored = receiver.storage().get_proposal(SCOPE, pid)
    assert len(stored.votes) == 1 and stored.round == 2
    return stored.encode()


def events_reached(w):
    service = w.service()
    pid = w.create(service).proposal_id
    w.remote(service, pid, True)
    w.remote(service, pid, True)
    events = w.events()
    assert (SCOPE, "ConsensusReached", pid, True, NOW) in events
    return events


def events_none_until_consensus(w):
    service = w.service()
    pid = w.create(service, n=5).proposal_id
    w.remote(service, pid, True)
    assert w.events() == []


def events_failed_on_timeout(w):
    service = w.service()
    pid = w.create(service, n=4, liveness=True).proposal_id
    for choice in (True, False, False):  # 1 YES, 2 NO, 1 silent-as-YES: a tie
        w.remote(service, pid, choice)
    _raises("InsufficientVotesAtTimeout",
            lambda: service.handle_consensus_timeout(SCOPE, pid, NOW + 60))
    events = w.events()
    assert (SCOPE, "ConsensusFailedEvent", pid, None, NOW + 60) in events
    return events


def timeout_idempotent(w):
    service = w.service()
    pid = w.create(service).proposal_id
    w.remote(service, pid, True)
    w.remote(service, pid, True)
    assert service.handle_consensus_timeout(SCOPE, pid, NOW + 60) is True
    assert service.handle_consensus_timeout(SCOPE, pid, NOW + 61) is True
    return w.events()


def timeout_quorum_gate(w):
    service = w.service()
    pid = w.create(service, n=4, liveness=True).proposal_id
    w.remote(service, pid, True)
    w.remote(service, pid, True)
    _raises("ConsensusNotReached", lambda: service.storage().get_consensus_result(SCOPE, pid))
    assert service.handle_consensus_timeout(SCOPE, pid, NOW + 60) is True


def timeout_no_result(w):
    service = w.service()
    pid = w.create(service, n=4, liveness=False).proposal_id
    w.remote(service, pid, True)
    w.remote(service, pid, True)
    _raises("InsufficientVotesAtTimeout",
            lambda: service.handle_consensus_timeout(SCOPE, pid, NOW + 60))
    _raises("ConsensusFailed", lambda: service.storage().get_consensus_result(SCOPE, pid))


def timeout_liveness_no_majority(w):
    service = w.service()
    pid = w.create(service, n=4, liveness=False).proposal_id
    w.remote(service, pid, True)
    w.remote(service, pid, False)
    assert service.handle_consensus_timeout(SCOPE, pid, NOW + 60) is False


def timeout_zero_votes(w):
    service = w.service()
    yes = w.create(service, n=4, liveness=True).proposal_id
    no = w.create(service, n=4, liveness=False).proposal_id
    assert service.handle_consensus_timeout(SCOPE, yes, NOW + 60) is True
    assert service.handle_consensus_timeout(SCOPE, no, NOW + 60) is False


def timeout_p2p_variant(w):
    service = w.service()
    pid = w.create(service, n=4, config=w.ht.ConsensusConfig.p2p(), liveness=True).proposal_id
    w.remote(service, pid, True)
    assert service.handle_consensus_timeout(SCOPE, pid, NOW + 60) is True


def timeout_unknown_proposal(w):
    service = w.service()
    _raises("SessionNotFound", lambda: service.handle_consensus_timeout(SCOPE, 999, NOW))


def reject_user_already_voted(w):
    service = w.service()
    pid = w.create(service, n=5).proposal_id
    service.cast_vote(SCOPE, pid, True, NOW)
    _raises("UserAlreadyVoted", lambda: service.cast_vote(SCOPE, pid, False, NOW))


def reject_duplicate_incoming_vote(w):
    service = w.service()
    pid = w.create(service, n=5).proposal_id
    voter = w.signer()
    w.remote(service, pid, True, signer=voter)
    assert w.remote(service, pid, False, signer=voter) == "DuplicateVote"


def reject_unknown_proposal_vote(w):
    service = w.service()
    w.create(service, n=5)
    orphan = w.ht.build_vote(w.ht.CreateProposalRequest(
        name="x", payload=b"", proposal_owner=b"o", expected_voters_count=3,
        expiration_timestamp=60, liveness_criteria_yes=True).into_proposal(NOW),
        True, w.signer(), NOW)
    _raises("SessionNotFound", lambda: service.process_incoming_vote(SCOPE, orphan, NOW))


def reject_duplicate_proposal(w):
    service = w.service()
    pid = w.create(service, n=5).proposal_id
    snapshot = service.storage().get_proposal(SCOPE, pid)
    _raises("ProposalAlreadyExist",
            lambda: service.process_incoming_proposal(SCOPE, snapshot, NOW))


def reject_expired(w):
    origin = w.service()
    pid = w.create(origin, expiration=10).proposal_id
    _raises("ProposalExpired", lambda: origin.cast_vote(SCOPE, pid, True, NOW + 11))
    snapshot = origin.storage().get_proposal(SCOPE, pid)
    receiver = w.service()
    _raises("ProposalExpired",
            lambda: receiver.process_incoming_proposal(SCOPE, snapshot, NOW + 11))


def config_scope_used(w):
    service = w.service()
    service.scope(SCOPE).with_network_type(w.ht.NetworkType.P2P).with_threshold(0.75).initialize()
    request = w.ht.CreateProposalRequest(
        name="x", payload=b"", proposal_owner=service.signer().identity(),
        expected_voters_count=4, expiration_timestamp=EXPIRATION, liveness_criteria_yes=True)
    pid = service.create_proposal(SCOPE, request, NOW).proposal_id
    config = service.storage().get_proposal_config(SCOPE, pid)
    assert config.consensus_threshold == 0.75 and not config.use_gossipsub_rounds
    return config.consensus_timeout, config.max_rounds


def config_gossipsub_default(w):
    service = w.service()
    request = w.ht.CreateProposalRequest(
        name="x", payload=b"", proposal_owner=service.signer().identity(),
        expected_voters_count=4, expiration_timestamp=EXPIRATION, liveness_criteria_yes=True)
    pid = service.create_proposal(SCOPE, request, NOW).proposal_id
    config = service.storage().get_proposal_config(SCOPE, pid)
    assert config.use_gossipsub_rounds and config.consensus_threshold == 2.0 / 3.0
    assert config.consensus_timeout == float(EXPIRATION)


def config_override_and_liveness(w):
    service = w.service()
    override = w.ht.ConsensusConfig.gossipsub().with_timeout(7.0)
    pid = w.create(service, config=override).proposal_id
    assert service.storage().get_proposal_config(SCOPE, pid).consensus_timeout == 7.0
    live = w.ht.ConsensusConfig.gossipsub().with_liveness_criteria(True)
    pid = w.create(service, config=live, liveness=False).proposal_id
    assert service.storage().get_proposal_config(SCOPE, pid).liveness_criteria is False


def query_errors(w):
    service = w.service()
    pid = w.create(service).proposal_id
    storage = service.storage()
    assert storage.get_proposal(SCOPE, pid).proposal_id == pid
    for fn in (storage.get_proposal, storage.get_consensus_result, storage.get_proposal_config):
        _raises("SessionNotFound", lambda: fn(SCOPE, 12345678))
    assert storage.get_active_proposals("nope") == []
    assert storage.get_reached_proposals("nope") == {}


def query_active_and_reached(w):
    service = w.service()
    active = w.create(service, n=5).proposal_id
    reached = w.create(service, n=1).proposal_id
    w.remote(service, reached, True)
    ids = {p.proposal_id for p in service.storage().get_active_proposals(SCOPE)}
    assert active in ids and reached not in ids
    assert service.storage().get_reached_proposals(SCOPE) == {reached: True}


def query_stats(w):
    service = w.service()
    w.create(service, n=5)
    p2 = w.create(service, n=1).proposal_id
    w.remote(service, p2, True)
    p3 = w.create(service, n=4, liveness=False).proposal_id
    w.remote(service, p3, True)
    w.remote(service, p3, True)
    _raises("InsufficientVotesAtTimeout",
            lambda: service.handle_consensus_timeout(SCOPE, p3, NOW + 60))
    assert w.stats(service) == (3, 1, 1, 1)
    assert w.stats(service, "unknown_scope") == (0, 0, 0, 0)


def query_delete_scope_lifecycle(w):
    service = w.service()
    service.scope(SCOPE).with_threshold(0.9).initialize()
    pid = w.create(service).proposal_id
    service.storage().delete_scope(SCOPE)
    assert service.storage().get_session(SCOPE, pid) is None
    assert service.storage().get_scope_config(SCOPE) is None
    p2 = w.create(service).proposal_id
    assert service.storage().get_proposal_config(SCOPE, p2).consensus_threshold == 2.0 / 3.0


def eviction_keeps_newest(w):
    service = w.service(max_sessions=3)
    kept = [(w.create(service, now=NOW + i).proposal_id, NOW + i) for i in range(5)]
    surviving = {s.proposal.proposal_id for s in service.storage().list_scope_sessions(SCOPE)}
    assert surviving == {pid for pid, _ in sorted(kept, key=lambda x: -x[1])[:3]}
    return sorted(surviving)


SERVICE_CASES = {f.__name__: f for f in (
    basic_reach_consensus, basic_cast_and_get_proposal, basic_multi_scope_isolation,
    basic_incoming_proposal_roundtrip, events_reached, events_none_until_consensus,
    events_failed_on_timeout, timeout_idempotent, timeout_quorum_gate, timeout_no_result,
    timeout_liveness_no_majority, timeout_zero_votes, timeout_p2p_variant,
    timeout_unknown_proposal, reject_user_already_voted, reject_duplicate_incoming_vote,
    reject_unknown_proposal_vote, reject_duplicate_proposal, reject_expired,
    config_scope_used, config_gossipsub_default, config_override_and_liveness,
    query_errors, query_active_and_reached, query_stats, query_delete_scope_lifecycle,
    eviction_keeps_newest,
)}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(SERVICE_CASES))
def test_service_case(name, backend):
    play(SERVICE_CASES[name], backend)


# ── tests/test_tpu_backed_service.py ────────────────────────────────────


def request(w, n=3, exp=100, liveness=True, name="p"):
    return w.ht.CreateProposalRequest(
        name=name, payload=b"", proposal_owner=b"o", expected_voters_count=n,
        expiration_timestamp=exp, liveness_criteria_yes=liveness)


def backed_quickstart(w):
    service = w.service()
    storage = service.storage()
    pid = service.create_proposal("s", request(w, 3), NOW).proposal_id
    states = [storage.device_state_of("s", pid)]
    service.cast_vote("s", pid, True, NOW)
    states.append(storage.device_state_of("s", pid))
    vote = w.ht.build_vote(storage.get_proposal("s", pid), True, w.signer(), NOW)
    service.process_incoming_vote("s", vote, NOW)
    assert storage.get_consensus_result("s", pid) is True
    states.append(storage.device_state_of("s", pid))
    assert states == [w.pkg.decide.STATE_ACTIVE] * 2 + [w.pkg.decide.STATE_REACHED_YES]
    return states, w.events()


def backed_timeout_paths(w):
    service = w.service()
    storage = service.storage()
    yes = service.create_proposal("s", request(w, 5, liveness=True), NOW).proposal_id
    service.cast_vote("s", yes, True, NOW)
    assert service.handle_consensus_timeout("s", yes, NOW + 200) is True
    service.scope("t").with_threshold(1.0).initialize()
    fail = service.create_proposal("t", request(w, 4, liveness=True), NOW).proposal_id
    for i in range(2):
        vote = w.ht.build_vote(storage.get_proposal("t", fail), i % 2 == 0, w.signer(), NOW)
        service.process_incoming_vote("t", vote, NOW)
    _raises("InsufficientVotesAtTimeout",
            lambda: service.handle_consensus_timeout("t", fail, NOW + 200))
    states = storage.device_state_of("s", yes), storage.device_state_of("t", fail)
    assert states == (w.pkg.decide.STATE_REACHED_YES, w.pkg.decide.STATE_FAILED)
    return states


def backed_p2p_round_cap(w):
    service = w.service()
    storage = service.storage()
    service.scope("s").with_network_type(w.ht.NetworkType.P2P).initialize()
    pid = service.create_proposal("s", request(w, 4, liveness=False), NOW).proposal_id
    voters = [w.signer() for _ in range(4)]
    for voter, choice in zip(voters[:3], [True, False, True]):
        vote = w.ht.build_vote(storage.get_proposal("s", pid), choice, voter, NOW)
        service.process_incoming_vote("s", vote, NOW)
    vote = w.ht.build_vote(storage.get_proposal("s", pid), True, voters[3], NOW)
    _raises("MaxRoundsExceeded", lambda: service.process_incoming_vote("s", vote, NOW))
    assert storage.device_state_of("s", pid) == w.pkg.decide.STATE_FAILED


def backed_eviction_releases_slots(w):
    service = w.service(max_sessions=2)
    for i in range(5):
        service.create_proposal("s", request(w, 3, name=f"p{i}"), NOW + i)
    assert len(service.storage().list_scope_sessions("s")) == 2
    assert service.storage().pool().allocated_slots == 2


BACKED_CASES = {f.__name__: f for f in (
    backed_quickstart, backed_timeout_paths, backed_p2p_round_cap,
    backed_eviction_releases_slots)}


@pytest.mark.parametrize("name", sorted(BACKED_CASES))
def test_pool_backed_service_case(name):
    play(BACKED_CASES[name], "pool", capacity=32, voter_capacity=8)


def test_shared_pool_with_engine_view():
    """Storage and batch engine can share one device pool."""
    from hashgraph_tpu_torch.engine import ProposalPool, TorchBackedStorage

    pool = ProposalPool(16, 8, device="cpu")
    storage = TorchBackedStorage(pool=pool)
    w = World(PORT, "in_memory", {})
    service = w.service(storage=storage)
    pid = service.create_proposal("s", request(w, 3), NOW).proposal_id
    assert pool.allocated_slots == 1
    service.cast_vote("s", pid, True, NOW)
    assert storage.device_state_of("s", pid) == PORT.decide.STATE_ACTIVE


# ── tests/test_concurrency.py, the threaded cases ───────────────────────


def _run_threads(n, target):
    barrier = threading.Barrier(n)
    threads = [threading.Thread(target=target, args=(barrier, i)) for i in range(n)]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)


def concurrent_voters(w):
    """10 distinct voters race on one proposal: all succeed."""
    service = w.service()
    pid = w.create(service, n=30).proposal_id
    peers = [w.sibling(service) for _ in range(10)]
    errors = []

    def vote(barrier, i):
        barrier.wait()
        try:
            peers[i].cast_vote(SCOPE, pid, True, NOW)
        except Exception as exc:  # noqa: BLE001 - a lost vote fails the case
            errors.append(type(exc).__name__)

    _run_threads(10, vote)
    assert errors == []
    votes = service.storage().get_proposal(SCOPE, pid).votes
    assert len(votes) == 10
    return sorted(v.vote_owner for v in votes), w.stats(service)


def concurrent_creation(w):
    """8 threads create proposals at once: 8 distinct sessions."""
    service = w.service(max_sessions=100)
    ids, lock = [], threading.Lock()

    def create(barrier, i):
        req = w.ht.CreateProposalRequest(
            name=f"p{i}", payload=b"", proposal_owner=b"owner-%d" % i,
            expected_voters_count=3, expiration_timestamp=120, liveness_criteria_yes=True)
        barrier.wait()
        made = service.create_proposal(SCOPE, req, NOW)
        with lock:
            ids.append(made.proposal_id)

    _run_threads(8, create)
    assert len(set(ids)) == 8
    assert len(service.storage().list_scope_sessions(SCOPE)) == 8
    return w.stats(service)


def concurrent_same_voter(w):
    """5 threads with one identity race: exactly one success."""
    service = w.service()
    pid = w.create(service, n=30).proposal_id
    racer = w.signer()
    outcomes, lock = [], threading.Lock()
    votes = [w.ht.build_vote(service.storage().get_proposal(SCOPE, pid), True, racer, NOW)
             for _ in range(5)]

    def race(barrier, i):
        barrier.wait()
        got = outcome(lambda: service.process_incoming_vote(SCOPE, votes[i], NOW))
        with lock:
            outcomes.append(got)

    _run_threads(5, race)
    assert outcomes.count(None) == 1 and outcomes.count("DuplicateVote") == 4
    assert len(service.storage().get_proposal(SCOPE, pid).votes) == 1
    return sorted(outcomes, key=str), w.stats(service)


CONCURRENCY_CASES = {f.__name__: f for f in (
    concurrent_voters, concurrent_creation, concurrent_same_voter)}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(CONCURRENCY_CASES))
def test_concurrency_case(name, backend):
    play(CONCURRENCY_CASES[name], backend, pools=False, capacity=128, voter_capacity=32)


# ── The README quick-start and phase 9's backlog ───────────────────────


def test_quickstart_with_ethereum_signers():
    """Three Ethereum-signed peers over one pool-backed storage: decided on
    the second YES, the late NO a no-op, the device row REACHED_YES."""

    def scenario(w):
        storage, bus = w.storage(), w.ht.BroadcastEventBus()
        peers = [w.ht.ConsensusService(storage, bus, w.ht.EthereumConsensusSigner(k))
                 for k in (11, 12, 13)]
        rx = bus.subscribe()
        pid = peers[0].create_proposal("deployments", w.ht.CreateProposalRequest(
            name="ship-v2", payload=b"git:abc123", proposal_owner=peers[0].signer().identity(),
            expected_voters_count=3, expiration_timestamp=60, liveness_criteria_yes=True),
            NOW).proposal_id
        first = peers[0].cast_vote("deployments", pid, True, NOW)
        assert rx.try_recv() is None
        second = peers[1].cast_vote("deployments", pid, True, NOW)
        assert rx.try_recv()[1] == w.ht.ConsensusReached(pid, True, NOW)
        late = w.ht.build_vote(storage.get_proposal("deployments", pid), False,
                               peers[2].signer(), NOW)
        peers[0].process_incoming_vote("deployments", late, NOW)
        assert storage.get_consensus_result("deployments", pid) is True
        assert storage.device_state_of("deployments", pid) == w.pkg.decide.STATE_REACHED_YES
        return first.encode(), second.encode(), late.encode()

    play(scenario, "pool")


PLAN = dict(scopes=4, proposals=11, voters=8, votes=6, wide=1, wide_voters=12,
            wide_votes=9, keys=12)


@pytest.mark.parametrize("scheme", ["stub", "ethereum"])
def test_backlog_differential(scheme):
    """Phase 9's traffic, small: the JAX service over both JAX storages and
    the port's over both twins take the same calls."""
    plan = chip_smoke.backlog_plan(5, **PLAN)
    if scheme == "stub":
        def make_key(pkg, k):
            return pkg.ht.StubConsensusSigner(b"key-%016d" % k)
    else:
        def make_key(pkg, k):
            return pkg.ht.EthereumConsensusSigner(1000 + k)
    keys = [make_key(PORT, k) for k in range(PLAN["keys"])]
    proposals = chip_smoke.backlog_proposals(PORT.ht, plan, 6)
    with seeded_ids(PORT, 7):
        wire = chip_smoke.backlog_votes(
            PORT.ht, plan, proposals, keys,
            lambda jobs: [keys[k].sign(payload) for k, payload in jobs])
    runs = {}
    for pkg in (REF, PORT):
        for backend in BACKENDS:
            storage = make_storage(pkg, backend, capacity=64, voter_capacity=8)
            service = chip_smoke.backlog_service(pkg.ht, storage, make_key(pkg, 99))
            events = service.event_bus().subscribe()
            outcomes, _, pids = chip_smoke.drive_backlog(pkg.ht, service, plan, wire, 6)
            state = chip_smoke.backlog_state(service, plan, pids, events)
            devices = None
            if backend == "pool":
                devices = [storage.device_state_of(plan["scopes"][plan["props"][p][0]]["name"],
                                                   pids[p]) for p in sorted(pids)]
            runs[(pkg.name, backend)] = (outcomes, pids, state, devices, storage)
    want = runs[("jax", "in_memory")][:3]
    for key, run in runs.items():
        assert run[:3] == want, key
    assert runs[("port", "pool")][3] == runs[("jax", "pool")][3]
    assert_pools_equal(runs[("jax", "pool")][4].pool(), runs[("port", "pool")][4].pool())
    # The traffic reached what it is for: accepted votes, evictions,
    # duplicates, late votes, decisions, timeouts and a host-only session.
    outcomes, pids = want[0], want[1]
    seen = {o[2] if o[0] != "create" else "create" for o in outcomes}
    assert {None, "SessionNotFound", "DuplicateVote", "VoteExpired", "create"} <= seen
    assert any(o[0] == "timeout" for o in outcomes)
    devices = runs[("port", "pool")][3]
    wide = [i for i, p in enumerate(sorted(pids)) if plan["props"][p][1] > 8]
    assert wide and all(devices[i] is None for i in wide)
    assert sum(d is not None for d in devices) == 4 * 10 - 1
    # Every pooled row equals the row built from the in-memory session.
    port_pool = runs[("port", "pool")][4]
    memory = runs[("port", "in_memory")][4]
    checked = 0
    for key, name, got, row in chip_smoke.expected_rows(port_pool, memory):
        assert (got == row).all(), (key, name)
        checked += 1
    assert checked == 39 * 10
