"""Parity: the port's sharded pool and engine against the JAX package's.

Twin of ``tests/test_parallel.py``, on the CPU:

- the port's ``ShardedPool`` on ``consensus_mesh(n, device="cpu")`` (n
  blocks of pool tensors on the CPU) against the JAX ``ShardedPool`` on n
  virtual CPU devices, over seeded traces of allocation, scan and fresh
  ingest, snapshot loads, releases and timeouts: slots, statuses,
  transitions, timeout rows, occupancy, global counts and every array;
- a JAX ``ShardedPool`` carried into the port (``sharded_pool_from_numpy``)
  continues the same trace identically;
- the engine on sharded pools: the scenarios of ``tests/test_torch_engine.py``
  plus ``deliver_proposals``, wire-columnar traffic and a pool filled until
  sessions spill, against the JAX engine on a JAX ``ShardedPool`` run in a
  subprocess (``python tests/test_torch_parallel.py --reference``);
- the twins of ``tests/test_parallel.py``'s cases on an 8-entry CPU mesh;
- no silent CPU: the mesh and the pool raise without a GPU.

Tolerance: exact everywhere.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from hashgraph_tpu.ops.decide import required_votes_np
from hashgraph_tpu.parallel import ShardedPool as RefShardedPool
from hashgraph_tpu.parallel import consensus_mesh as ref_consensus_mesh
from hashgraph_tpu_torch.convert import (
    DEVICE_ARRAYS,
    HOST_FIELDS,
    pool_to_numpy,
    sharded_pool_from_numpy,
)
from hashgraph_tpu_torch.ops.decide import (
    STATE_ACTIVE,
    STATE_FREE,
    STATE_REACHED_YES,
)
from hashgraph_tpu_torch.ops.ingest import group_batch
from hashgraph_tpu_torch.parallel import ShardedPool, consensus_mesh

NOW = 1_700_000_000
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))

import test_torch_engine as engine_twin  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def ref_to_numpy(pool) -> tuple[dict, dict]:
    """A JAX pool's global arrays and host mirrors, as convert takes them."""
    arrays = {name: np.asarray(getattr(pool, attr)) for name, (attr, _) in DEVICE_ARRAYS.items()}
    host = {}
    for name, attr in HOST_FIELDS.items():
        value = getattr(pool, attr)
        host[name] = value.copy() if hasattr(value, "copy") else value
    host["meta"] = {s: (m.key, m.expiry, m.created_at) for s, m in pool._meta.items()}
    return arrays, host


def assert_pools_equal(ref_pool, port_pool):
    ra, rh = ref_to_numpy(ref_pool)
    pa, ph = pool_to_numpy(port_pool)
    for name in DEVICE_ARRAYS:
        np.testing.assert_array_equal(pa[name], ra[name], err_msg=name)
    for name in HOST_FIELDS:
        a, b = ph[name], rh[name]
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    assert ph["meta"] == rh["meta"]


def assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for key in a:
            assert_same(a[key], b[key])
    elif isinstance(a, (tuple, list)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def both(ref_pool, port_pool, fn):
    """Run one call on both pools; require equal results."""
    a, b = fn(ref_pool), fn(port_pool)
    assert_same(a, b)
    return a


def allocate(pool, rng, keys, v_cap, expiry_pool=(5, 1000)):
    k = len(keys)
    n = rng.integers(1, v_cap + 1, k)
    gossip = rng.random(k) < 0.5
    req = required_votes_np(n, rng.choice([2 / 3, 0.9, 1.0], k))
    return pool.allocate_batch(
        keys=keys, n=n, req=req, cap=np.where(gossip, 2, req), gossip=gossip,
        liveness=rng.random(k) < 0.5, expiry=NOW + rng.choice(expiry_pool, k),
        created_at=np.full(k, NOW),
    )


def pool_trace(ref_pool, port_pool, seed, v_cap, capacity):
    """One seeded trace on both pools: allocation, scan ingest (single and
    pipelined), a fresh dispatch, loads, releases, timeouts, reads."""
    lanes_hi = min(v_cap, 12)
    live = capacity * 3 // 4
    both(ref_pool, port_pool, lambda q: allocate(
        q, np.random.default_rng(seed), [("s", i) for i in range(live)], v_cap))
    rng = np.random.default_rng(100 + seed)
    occupied = [s for s in range(capacity) if ref_pool.state_of(s) != STATE_FREE]
    for _ in range(3):
        slots = rng.choice(occupied, 50)
        lanes = rng.integers(0, lanes_hi, 50).astype(np.int32)
        vals = rng.random(50) < 0.5
        both(ref_pool, port_pool, lambda q: q.ingest(slots, lanes, vals, NOW + 6))
    batches = [
        (rng.choice(occupied, k), rng.integers(0, lanes_hi, k).astype(np.int32),
         rng.random(k) < 0.5)
        for k in (30, 7)
    ]

    def pipelined(q):
        pendings = [q.ingest_async(s, l, v, NOW + 6) for s, l, v in batches]
        return [(st, tr) for st, tr in q.complete_all(pendings)]

    both(ref_pool, port_pool, pipelined)
    # Release a few, allocate fresh slots, and run one closed-form dispatch.
    gone = [int(s) for s in rng.choice(occupied, 4, replace=False)]
    both(ref_pool, port_pool, lambda q: q.release(gone))
    new = both(ref_pool, port_pool, lambda q: allocate(
        q, np.random.default_rng(seed + 50), [("f", i) for i in range(6)], v_cap))
    f_slots = np.repeat(np.asarray(new, np.int64), 5)
    uniq, row, col, depth = group_batch(f_slots)
    fvals = rng.random(len(f_slots)) < 0.5

    def fresh(q):
        pending = q.ingest_async_grouped(
            uniq, row, col, depth, col.astype(np.int32), fvals, NOW + 6, fresh=True
        )
        return q.complete(pending)

    both(ref_pool, port_pool, fresh)
    # Snapshot loads over live slots.
    load = [int(s) for s in new[:3]]
    rows = dict(
        state=np.full(3, STATE_ACTIVE), yes=rng.integers(0, 3, 3), tot=rng.integers(3, 6, 3),
        mask_rows=rng.random((3, v_cap)) < 0.5, val_rows=rng.random((3, v_cap)) < 0.5,
    )
    both(ref_pool, port_pool, lambda q: q.load_rows(load, **rows))
    both(ref_pool, port_pool, lambda q: q.timeout(list(range(0, capacity, 3))))
    both(ref_pool, port_pool, lambda q: q.read_slots([0, 5, capacity - 1, 3]))
    both(ref_pool, port_pool, lambda q: q.per_device_occupancy())
    both(ref_pool, port_pool, lambda q: q.global_state_counts())
    both(ref_pool, port_pool, lambda q: q.state_counts())
    assert_pools_equal(ref_pool, port_pool)


MESHES = (1, 2, 8)


def _pools(n, v_cap, capacity=32):
    ref = RefShardedPool(capacity // n, v_cap, ref_consensus_mesh(n))
    port = ShardedPool(capacity // n, v_cap, consensus_mesh(n, device="cpu"))
    return ref, port


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("seed", range(5))
def test_sharded_pool_traces_match_reference(seed, n):
    """Seeds 0-4 on meshes of 1, 2 and 8 entries; odd seeds on a
    >64-lane pool (the laneless fresh grid)."""
    v_cap = (8, 100)[seed % 2]
    ref, port = _pools(n, v_cap)
    assert port.n_devices == n and port.local_capacity == 32 // n
    assert_pools_equal(ref, port)
    pool_trace(ref, port, seed, v_cap, 32)
    # The scan ran once per block with rows: never more blocks than the mesh.
    assert 0 < sum(port.scan_dispatches)


@pytest.mark.parametrize("n", (2, 8))
def test_reference_pool_carried_over(n):
    """A JAX ShardedPool's state, carried into the port mid-trace, goes on
    identically (the global arrays split into the port's blocks)."""
    ref, _ = _pools(n, 8, capacity=64)
    rng = np.random.default_rng(7)
    slots = allocate(ref, rng, [("c", i) for i in range(12)], 8)
    ref.ingest(rng.choice(slots, 40), rng.integers(0, 8, 40).astype(np.int32),
               rng.random(40) < 0.5, NOW + 6)
    port = sharded_pool_from_numpy(*ref_to_numpy(ref), consensus_mesh(n, device="cpu"))
    assert port.local_capacity == 64 // n
    assert_pools_equal(ref, port)
    pool_trace(ref, port, 3, 8, 64)


# ── The engine on sharded pools, against the JAX engine ──────────────────


def port_sharded_api(n):
    import hashgraph_tpu_torch as pkg
    from hashgraph_tpu_torch.events import BroadcastEventBus

    def make_engine(signer, capacity, voter_capacity, max_sessions=10_000):
        return pkg.TorchConsensusEngine(
            signer, event_bus=BroadcastEventBus(max_queued_events=1_000_000),
            max_sessions_per_scope=max_sessions,
            pool=ShardedPool(capacity // n, voter_capacity, consensus_mesh(n, device="cpu")),
        )

    return SimpleNamespace(pkg=pkg, make_engine=make_engine)


def reference_sharded_api(n):
    import hashgraph_tpu as pkg
    from hashgraph_tpu.engine import TpuConsensusEngine
    from hashgraph_tpu.events import BroadcastEventBus
    from hashgraph_tpu.obs.health import HealthMonitor

    def make_engine(signer, capacity, voter_capacity, max_sessions=10_000):
        return TpuConsensusEngine(
            signer, event_bus=BroadcastEventBus(max_queued_events=1_000_000),
            max_sessions_per_scope=max_sessions, verify_cache=None,
            health_monitor=HealthMonitor(),
            pool=RefShardedPool(capacity // n, voter_capacity, ref_consensus_mesh(n)),
        )

    return SimpleNamespace(pkg=pkg, make_engine=make_engine)


def scenario_deliver(api, seed):
    """deliver_proposals: unknown proposals, strict extensions, redeliveries
    and forks, across blocks."""
    rng = np.random.default_rng(seed)
    pkg = api.pkg
    engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 32, 8)
    rec = engine_twin.Recorder(engine)
    signers = [pkg.StubConsensusSigner(bytes([1 + i])) for i in range(6)]
    log = []
    props = [
        pkg.Proposal(name=f"d{i}", payload=b"x", proposal_id=5000 + i,
                     proposal_owner=b"o", votes=[], expected_voters_count=int(rng.integers(2, 7)),
                     round=1, timestamp=NOW, expiration_timestamp=NOW + 500,
                     liveness_criteria_yes=bool(i % 2))
        for i in range(10)
    ]
    rec.created("s", props)
    for wave in range(3):
        items = []
        for prop in props:
            grown = prop.clone()
            for _ in range(int(rng.integers(0, 3))):
                signer = signers[int(rng.integers(0, 6))]
                vote = pkg.build_vote(grown, bool(rng.random() < 0.7), signer, NOW + 1 + wave)
                grown.votes.append(vote)
            if rng.random() < 0.8:
                items.append(("s", grown))
            if rng.random() < 0.8:
                prop.votes = grown.votes  # the gossip of the next wave extends it
        log.append(call_list(engine.deliver_proposals, items, NOW + 2 + wave))
        log.append(rec.events())
    log.append(engine_twin.results(api, engine, rec, "s"))
    return log


def call_list(fn, *args):
    out = engine_twin.call(fn, *args)
    return [int(x) for x in out] if isinstance(out, list) and out[:1] != ["raised"] else out


def scenario_wire(api, seed):
    """ingest_wire_columnar over two scopes: valid rows, bad signatures,
    unknown proposals and expired votes."""
    rng = np.random.default_rng(seed)
    pkg = api.pkg
    from_bridge = __import__(pkg.__name__ + ".bridge.columnar", fromlist=["x"])
    engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 32, 8)
    rec = engine_twin.Recorder(engine)
    scopes = ["a", "b"]
    for scope in scopes:
        rec.created(scope, engine.create_proposals(
            scope, [engine_twin.request(api, i, int(rng.integers(2, 7))) for i in range(6)], NOW))
    signers = [pkg.StubConsensusSigner(bytes([30 + i])) for i in range(6)]
    log = []
    for wave in range(3):
        votes, sidx = [], []
        for _ in range(24):
            k = int(rng.integers(0, 2))
            prop = engine.get_proposal(scopes[k], rec.pids[(scopes[k], int(rng.integers(0, 6)))])
            vote = pkg.build_vote(prop, bool(rng.random() < 0.6), signers[int(rng.integers(0, 6))],
                                  NOW + 1 + wave)
            roll = rng.random()
            if roll < 0.1:
                vote.signature = bytes(len(vote.signature))
            elif roll < 0.15:
                vote.proposal_id = 999
            votes.append(vote)
            sidx.append(k)
        rows = [v.encode() for v in votes]
        offsets = np.zeros(len(rows) + 1, np.int64)
        np.cumsum([len(r) for r in rows], out=offsets[1:])
        data = np.frombuffer(b"".join(rows), np.uint8)
        cols, flags = from_bridge.parse_vote_columns(data, offsets)
        assert flags.all()
        log.append(call_list(engine.ingest_wire_columnar, scopes, np.array(sidx),
                             cols, data, offsets, NOW + 2 + wave))
        log.append(rec.events())
    for scope in scopes:
        log.append(engine_twin.results(api, engine, rec, scope))
    return log


def scenario_spill(api, seed):
    """A pool filled until sessions spill to the host: wide sessions and
    sessions past the last free slot, voted through the batch and columnar
    paths, swept and timed out."""
    rng = np.random.default_rng(seed)
    pkg = api.pkg
    engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 16, 4, max_sessions=64)
    rec = engine_twin.Recorder(engine)
    log = []
    rec.created("s", engine.create_proposals(
        "s", [engine_twin.request(api, i, int(rng.integers(2, 7)), expiry=int(rng.choice([20, 500])))
              for i in range(24)], NOW))
    occupancy = engine.occupancy()
    log.append([occupancy["live_sessions"], occupancy["capacity"]])
    gids = np.array([engine.voter_gid(bytes([8, i])) for i in range(8)])
    pids = np.array([rec.pids[("s", k)] for k in range(24)])
    for wave in range(2):
        rows = [(pids[k], gids[v], bool(rng.random() < 0.7))
                for k in range(24) for v in rng.permutation(8)[: int(rng.integers(0, 4))]]
        cols = [np.array([r[c] for r in rows]) for c in range(3)]
        log.append(call_list(engine.ingest_columnar, "s", *cols, NOW + 1 + wave))
        log.append(rec.events())
    signer = pkg.StubConsensusSigner(b"\x77")
    items = [("s", pkg.build_vote(engine.get_proposal("s", int(pid)), True, signer, NOW + 4))
             for pid in pids[::3]]
    log.append(call_list(engine.ingest_votes, items, NOW + 4))
    log.append(rec.events())
    log.append(sorted([s, rec.index[(s, pid)], r] for s, pid, r in engine.sweep_timeouts(NOW + 30)))
    log.append(rec.events())
    log.append(engine_twin.call(engine.handle_consensus_timeout, "s", int(pids[-1]), NOW + 600))
    log.append(rec.events())
    log.append(engine_twin.results(api, engine, rec, "s"))
    return log


SCENARIOS = dict(
    engine_twin.SCENARIOS, deliver=scenario_deliver, wire=scenario_wire, spill=scenario_spill
)
ENGINE_MESH = 8


def run_all(api):
    return {f"{name}-0": fn(api, 0) for name, fn in SCENARIOS.items()}


@pytest.fixture(scope="module")
def reference():
    """The JAX engine on a JAX ShardedPool, in a fresh interpreter."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={ENGINE_MESH}"
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
    return json.loads(json.dumps(run_all(port_sharded_api(ENGINE_MESH))))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_engine_matches_reference(reference, port, name):
    key = f"{name}-0"
    ref_log, port_log = reference[key], port[key]
    assert len(port_log) == len(ref_log)
    for i, (a, b) in enumerate(zip(port_log, ref_log)):
        assert a == b, f"{key} step {i}"


def test_sharded_scenarios_exercise_the_paths(port):
    flat = json.dumps(port)
    for needle in ("ConsensusReached", "ConsensusFailedEvent", "SessionNotFound"):
        assert needle in flat, needle
    # The spill scenario put sessions on the host: more live than slots.
    live, capacity = port["spill-0"][0]
    assert live > capacity


# ── Twins of tests/test_parallel.py ──────────────────────────────────────


@pytest.fixture(scope="module")
def mesh():
    return consensus_mesh(8, device="cpu")


def stub():
    from hashgraph_tpu_torch import StubConsensusSigner

    return StubConsensusSigner(os.urandom(20))


def make_sharded_engine(mesh, per_device=8, voter_capacity=16, **kw):
    from hashgraph_tpu_torch import TorchConsensusEngine

    return TorchConsensusEngine(
        stub(), pool=ShardedPool(per_device, voter_capacity, mesh), **kw
    )


def request(n=3, name="prop", exp=1000, liveness=True):
    from hashgraph_tpu_torch import CreateProposalRequest

    return CreateProposalRequest(
        name=name, payload=b"payload", proposal_owner=b"owner",
        expected_voters_count=n, expiration_timestamp=exp,
        liveness_criteria_yes=liveness,
    )


def _alloc(pool, k):
    return pool.allocate_batch(
        keys=[("s", i) for i in range(k)], n=np.full(k, 3), req=np.full(k, 2),
        cap=np.full(k, 2), gossip=np.ones(k, bool), liveness=np.ones(k, bool),
        expiry=np.full(k, NOW + 100), created_at=np.full(k, NOW),
    )


class TestShardedPoolLayout:
    def test_arrays_are_blocked(self, mesh):
        pool = ShardedPool(8, 16, mesh)
        assert pool.capacity == 64
        assert len(pool._blocks) == 8
        for block, device in zip(pool._blocks, mesh):
            assert block._state.shape == (8,) and block._state.device == device
            assert block._vote_mask.shape == (8, 16)

    def test_round_robin_allocation(self, mesh):
        pool = ShardedPool(4, 8, mesh)
        slots = _alloc(pool, 8)
        assert {s // pool.local_capacity for s in slots} == set(range(8))

    def test_global_state_counts_sum(self, mesh):
        pool = ShardedPool(4, 8, mesh)
        _alloc(pool, 5)
        counts = pool.global_state_counts()
        assert counts[STATE_ACTIVE] == 5
        assert counts[STATE_FREE] == 32 - 5
        # The per-block device counts agree with the host mirror.
        assert counts == {**{k: 0 for k in counts}, **pool.state_counts()}


class TestShardedEngine:
    def test_quickstart_on_mesh(self, mesh):
        from hashgraph_tpu_torch import build_vote

        engine = make_sharded_engine(mesh)
        pid = engine.create_proposal("s", request(3), NOW).proposal_id
        engine.cast_vote("s", pid, True, NOW)
        v = build_vote(engine.get_proposal("s", pid), True, stub(), NOW)
        engine.process_incoming_vote("s", v, NOW)
        assert engine.get_consensus_result("s", pid) is True

    def test_cross_device_batch_ingest(self, mesh):
        """Sessions on all 8 blocks, each decided by two votes."""
        from hashgraph_tpu_torch import StatusCode, build_vote

        engine = make_sharded_engine(mesh, per_device=4)
        pids = [
            engine.create_proposal(f"scope{i}", request(3, name=f"p{i}"), NOW).proposal_id
            for i in range(8)
        ]
        for i, pid in enumerate(pids):
            scope = f"scope{i}"
            for _ in range(2):
                vote = build_vote(engine.get_proposal(scope, pid), True, stub(), NOW)
                st = engine.ingest_votes([(scope, vote)], NOW)
                assert st[0] in (int(StatusCode.OK), int(StatusCode.ALREADY_REACHED))
        for i, pid in enumerate(pids):
            assert engine.get_consensus_result(f"scope{i}", pid) is True
        assert engine.pool().per_device_occupancy() == [1] * 8

    def test_columnar_fresh_dispatch_on_mesh(self, mesh):
        """One columnar batch over fresh sessions on all 8 blocks takes the
        closed-form dispatch (tracer-asserted) and decides every session."""
        from hashgraph_tpu_torch import StatusCode
        from hashgraph_tpu_torch.tracing import Tracer

        engine = make_sharded_engine(mesh, per_device=4, max_sessions_per_scope=32)
        engine.tracer = Tracer(enabled=True)
        proposals = engine.create_proposals("s", [request(4)] * 16, NOW)
        gids = np.array([engine.voter_gid(bytes([i]) * 4) for i in range(1, 4)], np.int64)
        pids = np.repeat(np.array([p.proposal_id for p in proposals], np.int64), 3)
        statuses = engine.ingest_columnar("s", pids, np.tile(gids, 16), np.ones(48, bool), NOW + 1)
        assert (statuses == int(StatusCode.OK)).all(), statuses
        assert engine.tracer.counters().get("engine.fresh_dispatches") == 1
        assert sum(engine.pool().scan_dispatches) == 0
        for p in proposals:
            assert engine.get_consensus_result("s", p.proposal_id) is True

    def test_sharded_timeout_sweep(self, mesh):
        engine = make_sharded_engine(mesh, per_device=4)
        pids = [
            engine.create_proposal("s", request(5, name=f"p{i}", exp=50), NOW + i).proposal_id
            for i in range(8)
        ]
        for pid in pids[:4]:
            engine.cast_vote("s", pid, True, NOW + 10)
        swept = engine.sweep_timeouts(NOW + 100)
        assert len(swept) == 8
        assert all(result is True for _, _, result in swept)
        assert {pid for _, pid, _ in swept} == set(pids)
        assert engine.pool().global_state_counts()[STATE_REACHED_YES] == 8

    @pytest.mark.parametrize("seed", range(2))
    def test_random_trace_parity_on_mesh(self, seed, mesh):
        """Randomized side-by-side trace: sharded engine vs the port's
        scalar service."""
        from hashgraph_tpu_torch import (
            BroadcastEventBus,
            ConsensusError,
            ConsensusService,
            CreateProposalRequest,
            InMemoryConsensusStorage,
            NetworkType,
            SessionNotFound,
            TorchConsensusEngine,
            build_vote,
        )

        rng = np.random.default_rng(seed)
        service = ConsensusService(InMemoryConsensusStorage(), BroadcastEventBus(), stub(), 10)
        engine = TorchConsensusEngine(service.signer(), pool=ShardedPool(8, 16, mesh))
        service_rx = service.event_bus().subscribe()
        engine_rx = engine.event_bus().subscribe()
        voters = [stub() for _ in range(8)]
        scopes = ["alpha", "beta", "gamma"]
        for scope in scopes:
            if rng.random() < 0.5:
                service.scope(scope).with_network_type(NetworkType.P2P).initialize()
                engine.scope(scope).with_network_type(NetworkType.P2P).initialize()
        pids: list[tuple[str, int]] = []
        for step in range(50):
            now = NOW + step
            action = rng.random()
            if action < 0.25 or not pids:
                scope = scopes[int(rng.integers(len(scopes)))]
                proposal = CreateProposalRequest(
                    name=f"p{step}", payload=b"x", proposal_owner=b"o",
                    expected_voters_count=int(rng.integers(2, 8)),
                    expiration_timestamp=int(rng.choice([30, 1000])),
                    liveness_criteria_yes=bool(rng.random() < 0.5),
                ).into_proposal(now)
                s_exc = e_exc = None
                try:
                    service.process_incoming_proposal(scope, proposal.clone(), now)
                except ConsensusError as exc:
                    s_exc = type(exc)
                try:
                    engine.process_incoming_proposal(scope, proposal.clone(), now)
                except ConsensusError as exc:
                    e_exc = type(exc)
                assert s_exc == e_exc
                if s_exc is None:
                    pids.append((scope, proposal.proposal_id))
            elif action < 0.85:
                scope, pid = pids[int(rng.integers(len(pids)))]
                signer = voters[int(rng.integers(len(voters)))]
                choice = bool(rng.random() < 0.6)
                s_exc = e_exc = None
                vote = None
                try:
                    vote = build_vote(service.storage().get_proposal(scope, pid), choice, signer, now)
                except ConsensusError as exc:
                    s_exc = type(exc)
                if vote is not None:
                    try:
                        service.process_incoming_vote(scope, vote.clone(), now)
                    except ConsensusError as exc:
                        s_exc = type(exc)
                    try:
                        engine.process_incoming_vote(scope, vote.clone(), now)
                    except ConsensusError as exc:
                        e_exc = type(exc)
                    assert s_exc == e_exc, f"step {step}: {s_exc} vs {e_exc}"
            else:
                scope, pid = pids[int(rng.integers(len(pids)))]
                s_res = e_res = s_exc = e_exc = None
                try:
                    s_res = service.handle_consensus_timeout(scope, pid, now)
                except ConsensusError as exc:
                    s_exc = type(exc)
                try:
                    e_res = engine.handle_consensus_timeout(scope, pid, now)
                except ConsensusError as exc:
                    e_exc = type(exc)
                assert (s_res, s_exc) == (e_res, e_exc)
        for scope, pid in pids:
            s_session = service.storage().get_session(scope, pid)
            if s_session is None:
                with pytest.raises(SessionNotFound):
                    engine.get_proposal(scope, pid)
                continue
            e_session = engine.export_session(scope, pid)
            assert e_session.state == s_session.state, f"{scope}/{pid}"
            assert set(e_session.votes) == set(s_session.votes)

        def drain(rx):
            out = []
            while (item := rx.try_recv()) is not None:
                out.append(item)
            return out

        assert drain(service_rx) == drain(engine_rx)


# ── No silent CPU ────────────────────────────────────────────────────────


def test_mesh_and_pool_raise_without_gpu():
    """The mesh and the sharded pool default to the visible GPUs; with none
    they refuse instead of moving to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        consensus_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedPool(4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedPool(4, 4, mesh=["cuda", "cuda"])


if __name__ == "__main__" and sys.argv[1:] == ["--reference"]:
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(run_all(reference_sharded_api(ENGINE_MESH))))
