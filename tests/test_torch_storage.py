"""The port's storages against the JAX package's.

The storage-contract cases of ``tests/test_storage.py`` run as scenarios
written once and played on both packages: the port's
``InMemoryConsensusStorage`` and ``TorchBackedStorage(device="cpu")``
against the JAX package's ``InMemoryConsensusStorage`` and
``TpuBackedStorage`` on identical seeded sessions. Each scenario asserts
the contract itself and returns what it observed; the port's observations
must equal the JAX package's, and after a pool-backed scenario every device
array and host mirror of the port's pool must equal the JAX pool's
(tolerance: exact).
"""

from types import SimpleNamespace

import pytest
import torch

import hashgraph_tpu as ref_pkg
import hashgraph_tpu_torch as port_pkg
from hashgraph_tpu import protocol as ref_protocol
from hashgraph_tpu.engine import TpuBackedStorage
from hashgraph_tpu.ops import decide as ref_decide
from hashgraph_tpu.session import ConsensusSession as RefSession
from hashgraph_tpu_torch import protocol as port_protocol
from hashgraph_tpu_torch.engine import ProposalPool, TorchBackedStorage
from hashgraph_tpu_torch.ops import decide as port_decide
from hashgraph_tpu_torch.session import ConsensusSession as PortSession

from test_torch_pool import assert_pools_equal

NOW = 1_700_000_000
SCOPE = "storage_scope"
BACKENDS = ("in_memory", "pool")

PORT = SimpleNamespace(
    name="port", ht=port_pkg, protocol=port_protocol, session=PortSession,
    decide=port_decide,
    backends={
        "in_memory": port_pkg.InMemoryConsensusStorage,
        "pool": lambda capacity=32, voter_capacity=8: TorchBackedStorage(
            capacity, voter_capacity, device="cpu"),
    },
)
REF = SimpleNamespace(
    name="jax", ht=ref_pkg, protocol=ref_protocol, session=RefSession,
    decide=ref_decide,
    backends={
        "in_memory": ref_pkg.InMemoryConsensusStorage,
        "pool": lambda capacity=32, voter_capacity=8: TpuBackedStorage(
            capacity, voter_capacity),
    },
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class seeded_ids:
    """Both packages mint the same proposal and vote ids under one seed."""

    def __init__(self, pkg, seed):
        import random

        self.pkg, self.rng = pkg, random.Random(seed)

    def __enter__(self):
        self.pkg.protocol.set_id_entropy(lambda: self.rng.getrandbits(128))
        return self

    def __exit__(self, *exc):
        self.pkg.protocol.set_id_entropy(None)


def outcome(fn):
    """A call's result, or its exception's type name."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - compared across packages
        return type(exc).__name__


def make_session(pkg, n=3, now=NOW, owner=b"o" * 20):
    request = pkg.ht.CreateProposalRequest(
        name="S", payload=b"", proposal_owner=owner, expected_voters_count=n,
        expiration_timestamp=120, liveness_criteria_yes=True,
    )
    return pkg.session._new(request.into_proposal(now), pkg.ht.ConsensusConfig.gossipsub(), now)


def pids(sessions):
    return sorted(s.proposal.proposal_id for s in sessions or [])


def play(scenario, backend, seed=0, **sizes):
    """Run one scenario on both packages; require equal observations and,
    for the pool backend (built with ``sizes``), equal pools."""
    results = {}
    for pkg in (REF, PORT):
        with seeded_ids(pkg, seed):
            storage = pkg.backends[backend](**sizes)
            results[pkg.name] = (scenario(pkg, storage), storage)
    (ref_obs, ref_storage), (port_obs, port_storage) = results["jax"], results["port"]
    assert port_obs == ref_obs
    if backend == "pool":
        assert_pools_equal(ref_storage.pool(), port_storage.pool())
    return port_obs


# ── Session primitives (reference: tests/storage_stream_tests.rs) ───────


def _save_get_remove(pkg, storage):
    session = make_session(pkg)
    pid = session.proposal.proposal_id
    storage.save_session(SCOPE, session)
    assert storage.get_session(SCOPE, pid).proposal.proposal_id == pid
    removed = storage.remove_session(SCOPE, pid)
    assert removed.proposal.proposal_id == pid
    assert storage.get_session(SCOPE, pid) is None
    assert storage.remove_session(SCOPE, pid) is None
    assert storage.remove_session("ghost", 1) is None
    return pid


def _snapshot_not_alias(pkg, storage):
    session = make_session(pkg)
    pid = session.proposal.proposal_id
    storage.save_session(SCOPE, session)
    snapshot = storage.get_session(SCOPE, pid)
    snapshot.proposal.name = "mutated"
    assert storage.get_session(SCOPE, pid).proposal.name == "S"
    return pid


def _list_and_stream(pkg, storage):
    assert storage.list_scope_sessions(SCOPE) is None
    sessions = [make_session(pkg) for _ in range(3)]
    for s in sessions:
        storage.save_session(SCOPE, s)
    assert pids(storage.list_scope_sessions(SCOPE)) == pids(sessions)
    assert len(list(storage.stream_scope_sessions(SCOPE))) == 3
    assert list(storage.stream_scope_sessions("ghost")) == []
    return pids(sessions)


def _replace_scope_sessions(pkg, storage):
    storage.save_session(SCOPE, make_session(pkg))
    replacement = [make_session(pkg), make_session(pkg)]
    storage.replace_scope_sessions(SCOPE, replacement)
    assert pids(storage.list_scope_sessions(SCOPE)) == pids(replacement)
    return pids(replacement)


def _list_scopes(pkg, storage):
    assert storage.list_scopes() is None
    storage.save_session("a", make_session(pkg))
    storage.save_session("b", make_session(pkg))
    return sorted(storage.list_scopes())


def _update_session_not_found(pkg, storage):
    return outcome(lambda: storage.update_session(SCOPE, 42, lambda s: None))


def _mutation_persists_on_error(pkg, storage):
    # The mutator runs on the stored value, so state changes made before an
    # error stick (reference closure semantics; tests/test_storage.py:115).
    session = make_session(pkg)
    pid = session.proposal.proposal_id
    storage.save_session(SCOPE, session)

    def mutator(s):
        s.proposal.name = "touched"
        raise ValueError("boom")

    raised = outcome(lambda: storage.update_session(SCOPE, pid, mutator))
    assert raised == "ValueError"
    assert storage.get_session(SCOPE, pid).proposal.name == "touched"
    return raised


def _empty_update_removes_scope(pkg, storage):
    storage.save_session(SCOPE, make_session(pkg))
    storage.update_scope_sessions(SCOPE, lambda sessions: sessions.clear())
    assert storage.list_scope_sessions(SCOPE) is None
    assert storage.list_scopes() is None


def _append_creates_scope(pkg, storage):
    session = make_session(pkg)
    storage.update_scope_sessions("fresh", lambda sessions: sessions.append(session))
    listed = storage.list_scope_sessions("fresh")
    assert listed is not None and len(listed) == 1
    return pids(listed)


def _remove_last_keeps_empty_scope(pkg, storage):
    session = make_session(pkg)
    storage.save_session(SCOPE, session)
    storage.remove_session(SCOPE, session.proposal.proposal_id)
    assert storage.list_scope_sessions(SCOPE) == []


def _replace_with_empty_keeps_scope(pkg, storage):
    storage.save_session(SCOPE, make_session(pkg))
    storage.replace_scope_sessions(SCOPE, [])
    assert storage.list_scope_sessions(SCOPE) == []


def _overwrite_refreshes_everything(pkg, storage):
    first = make_session(pkg, n=3)
    pid = first.proposal.proposal_id
    storage.save_session(SCOPE, first)
    second = make_session(pkg, n=5)
    second.proposal.proposal_id = pid
    storage.save_session(SCOPE, second)
    assert storage.get_session(SCOPE, pid).proposal.expected_voters_count == 5
    if hasattr(storage, "device_state_of"):
        # The device replica reflects the new session, not the first save.
        assert storage.device_state_of(SCOPE, pid) == pkg.decide.STATE_ACTIVE
        assert int(storage.pool()._n[storage._slots[(SCOPE, pid)]]) == 5
    return pid


SCENARIOS = {
    "save_get_remove": _save_get_remove,
    "snapshot_not_alias": _snapshot_not_alias,
    "list_and_stream": _list_and_stream,
    "replace_scope_sessions": _replace_scope_sessions,
    "list_scopes": _list_scopes,
    "update_session_not_found": _update_session_not_found,
    "mutation_persists_on_error": _mutation_persists_on_error,
    "empty_update_removes_scope": _empty_update_removes_scope,
    "append_creates_scope": _append_creates_scope,
    "remove_last_keeps_empty_scope": _remove_last_keeps_empty_scope,
    "replace_with_empty_keeps_scope": _replace_with_empty_keeps_scope,
    "overwrite_refreshes_everything": _overwrite_refreshes_everything,
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_session_contract(name, backend):
    observed = play(SCENARIOS[name], backend)
    if name == "update_session_not_found":
        assert observed == "SessionNotFound"


# ── Scope configs (reference: tests/storage_stream_tests.rs:184-244) ───


def _config_roundtrip(pkg, storage):
    assert storage.get_scope_config(SCOPE) is None
    config = pkg.ht.ScopeConfig(network_type=pkg.ht.NetworkType.P2P,
                                default_consensus_threshold=0.8)
    storage.set_scope_config(SCOPE, config)
    loaded = storage.get_scope_config(SCOPE)
    assert loaded.network_type == pkg.ht.NetworkType.P2P
    loaded.default_consensus_threshold = 0.1  # a snapshot, not the stored one
    return storage.get_scope_config(SCOPE).default_consensus_threshold


def _invalid_config_rejected(pkg, storage):
    raised = outcome(lambda: storage.set_scope_config(
        SCOPE, pkg.ht.ScopeConfig(default_consensus_threshold=1.5)))
    assert storage.get_scope_config(SCOPE) is None
    return raised


def _update_creates_default_then_validates(pkg, storage):
    def updater(config):
        config.default_consensus_threshold = 0.9

    storage.update_scope_config(SCOPE, updater)
    threshold = storage.get_scope_config(SCOPE).default_consensus_threshold

    def bad_updater(config):
        config.max_rounds_override = 0  # illegal for Gossipsub

    return threshold, outcome(lambda: storage.update_scope_config(SCOPE, bad_updater))


def _delete_scope_clears_everything(pkg, storage):
    storage.save_session(SCOPE, make_session(pkg))
    storage.set_scope_config(SCOPE, pkg.ht.ScopeConfig())
    storage.delete_scope(SCOPE)
    assert storage.list_scope_sessions(SCOPE) is None
    assert storage.get_scope_config(SCOPE) is None


CONFIG_SCENARIOS = {
    "roundtrip": _config_roundtrip,
    "invalid_rejected": _invalid_config_rejected,
    "update_creates_default": _update_creates_default_then_validates,
    "delete_scope": _delete_scope_clears_everything,
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(CONFIG_SCENARIOS))
def test_scope_config_contract(name, backend):
    observed = play(CONFIG_SCENARIOS[name], backend)
    if name == "roundtrip":
        assert observed == 0.8
    elif name == "invalid_rejected":
        assert observed == "InvalidConsensusThreshold"
    elif name == "update_creates_default":
        assert observed == (0.9, "InvalidMaxRounds")


def test_service_over_custom_storage():
    """The service is storage-agnostic: a tracing subclass of the in-memory
    storage works end to end on both packages."""

    def scenario(pkg, _storage):
        class TracingStorage(pkg.ht.InMemoryConsensusStorage):
            def __init__(self):
                super().__init__()
                self.saves = 0

            def save_session(self, scope, session):
                self.saves += 1
                return super().save_session(scope, session)

        storage = TracingStorage()
        service = pkg.ht.ConsensusService(
            storage, pkg.ht.BroadcastEventBus(), pkg.ht.StubConsensusSigner(b"me" * 10))
        request = pkg.ht.CreateProposalRequest(
            name="x", payload=b"", proposal_owner=b"me" * 10, expected_voters_count=1,
            expiration_timestamp=60, liveness_criteria_yes=True)
        proposal = service.create_proposal(SCOPE, request, NOW)
        service.cast_vote(SCOPE, proposal.proposal_id, True, NOW)
        assert storage.saves == 1
        return proposal.proposal_id, storage.get_consensus_result(SCOPE, proposal.proposal_id)

    assert play(scenario, "in_memory")[1] is True


# ── The pool-backed storage alone ───────────────────────────────────────


def _add_voters(pkg, count):
    def mutator(s):
        for i in range(count):
            owner = bytes([50 + i]) * 4
            s.votes[owner] = pkg.ht.Vote(vote_owner=owner, vote=True)

    return mutator


def test_oversized_session_degrades_to_host_only():
    def scenario(pkg, storage):
        big = make_session(pkg, n=3)
        pid = big.proposal.proposal_id
        storage.save_session(SCOPE, big)
        on_device = storage.device_state_of(SCOPE, pid)
        # More distinct voters than the pool has lanes: the session stays
        # queryable (host truth) with no stale device row.
        storage.update_session(SCOPE, pid, _add_voters(pkg, 6))
        assert len(storage.get_session(SCOPE, pid).votes) == 6
        return on_device, storage.device_state_of(SCOPE, pid)

    observed = play(scenario, "pool", capacity=8, voter_capacity=4)
    assert observed == (port_decide.STATE_ACTIVE, None)


def test_full_pool_and_wide_session_are_host_only():
    """A session wider than ``voter_capacity``, or one that finds the pool
    full, is host-only: ``device_state_of`` is None and the slot order of
    the sessions that do fit is the JAX pool's."""

    def scenario(pkg, storage):
        sessions = [make_session(pkg, n=2) for _ in range(3)] + [make_session(pkg, n=9)]
        for s in sessions:
            storage.save_session(SCOPE, s)
        states = [storage.device_state_of(SCOPE, s.proposal.proposal_id) for s in sessions]
        storage.remove_session(SCOPE, sessions[0].proposal.proposal_id)
        storage.update_session(SCOPE, sessions[2].proposal.proposal_id, _add_voters(pkg, 1))
        after = [storage.device_state_of(SCOPE, s.proposal.proposal_id) for s in sessions]
        return states, after, sorted(storage._slots.values())

    states, after, slots = play(scenario, "pool", seed=3, capacity=2, voter_capacity=8)
    assert states == [port_decide.STATE_ACTIVE] * 2 + [None, None]
    assert after == [None, port_decide.STATE_ACTIVE, port_decide.STATE_ACTIVE, None]
    assert slots == [0, 1]


def test_torch_backed_storage_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackedStorage()
    storage = TorchBackedStorage(capacity=4, voter_capacity=2, device="cpu")
    assert storage.pool().device.type == "cpu"
    assert (storage.pool().capacity, storage.pool().voter_capacity) == (4, 2)


def test_shared_pool_takes_the_pool_device():
    pool = ProposalPool(16, 8, device="cpu")
    storage = TorchBackedStorage(pool=pool)
    assert storage.pool() is pool
    session = make_session(PORT)
    storage.save_session(SCOPE, session)
    assert pool.allocated_slots == 1
