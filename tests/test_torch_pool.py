"""Parity: the port's ProposalPool against the JAX package's.

The JAX pool runs some traffic first; its arrays and host mirrors are
carried into a port pool with ``hashgraph_tpu_torch.convert.pool_from_numpy``
and the same traffic continues on both. Statuses, transitions, timeout
states, row reads, and every device array and host mirror must be equal
(tolerance: exact).
"""

import numpy as np
import pytest
import torch

from hashgraph_tpu.engine.pool import ProposalPool as RefPool
from hashgraph_tpu.ops.decide import required_votes_np
from hashgraph_tpu_torch.convert import (
    DEVICE_ARRAYS,
    HOST_FIELDS,
    pool_from_numpy,
    pool_to_numpy,
)
from hashgraph_tpu_torch.engine.pool import PoolFullError, ProposalPool
from hashgraph_tpu_torch.ops.ingest import group_batch

NOW = 1_700_000_000


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def ref_to_numpy(pool: RefPool) -> tuple[dict, dict]:
    """The JAX pool's state in the form convert.pool_from_numpy takes."""
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


def allocate(pool, rng, keys, v_cap, expiry_pool=(5, 1000)):
    k = len(keys)
    n = rng.integers(1, v_cap + 1, k)
    gossip = rng.random(k) < 0.5
    req = required_votes_np(n, rng.choice([2 / 3, 0.9, 1.0], k))
    return pool.allocate_batch(
        keys=keys,
        n=n,
        req=req,
        cap=np.where(gossip, 2, req),
        gossip=gossip,
        liveness=rng.random(k) < 0.5,
        expiry=NOW + rng.choice(expiry_pool, k),
        created_at=np.full(k, NOW),
    )


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


@pytest.mark.parametrize("v_cap", [8, 100])
@pytest.mark.parametrize("seed", range(3))
def test_pool_continues_reference_traffic(seed, v_cap):
    """Traffic on the JAX pool, carried across, then the same traffic on
    both: scan batches, a fresh batch, lane resolution, timeouts, release."""
    rng = np.random.default_rng(seed)
    p = 48
    ref_pool = RefPool(p, v_cap)
    allocate(ref_pool, rng, [("s", i) for i in range(32)], v_cap)
    for _ in range(2):
        slots = rng.integers(0, 32, 60)
        ref_pool.ingest(slots, rng.integers(0, min(v_cap, 12), 60).astype(np.int32),
                        rng.random(60) < 0.5, NOW + 6)
    port_pool = pool_from_numpy(*ref_to_numpy(ref_pool), device="cpu")
    assert_pools_equal(ref_pool, port_pool)

    for _ in range(3):
        slots = rng.integers(0, 32, 50)
        lanes = rng.integers(0, min(v_cap, 12), 50).astype(np.int32)
        vals = rng.random(50) < 0.5
        both(ref_pool, port_pool, lambda q: q.ingest(slots, lanes, vals, NOW + 6))
    # Owner interning + lane resolution on a batch of gids.
    owners = [bytes([7, i]) for i in range(20)]
    gids = np.array([both(ref_pool, port_pool, lambda q: q.voter_gid(o)) for o in owners])
    new_slots = allocate(ref_pool, np.random.default_rng(seed + 50),
                         [("f", i) for i in range(8)], v_cap)
    assert allocate(port_pool, np.random.default_rng(seed + 50),
                    [("f", i) for i in range(8)], v_cap) == new_slots
    # A fresh (closed-form) dispatch on the new slots.
    f_slots = np.repeat(np.asarray(new_slots, np.int64), 5)
    uniq, row, col, depth = group_batch(f_slots)
    vals = np.random.default_rng(seed + 60).random(len(f_slots)) < 0.5
    lanes = col.astype(np.int32)

    def fresh(q):
        pending = q.ingest_async_grouped(uniq, row, col, depth, lanes, vals, NOW + 6,
                                         fresh=True)
        return q.complete(pending)

    both(ref_pool, port_pool, fresh)
    g_slots = np.asarray(new_slots, np.int64)[np.arange(20) % 8]
    both(ref_pool, port_pool, lambda q: q.lanes_for_batch(g_slots, gids))
    both(ref_pool, port_pool, lambda q: q.gids_live(np.append(gids, [1 << 40, -3])))
    both(ref_pool, port_pool, lambda q: q.timeout(list(range(0, 40, 3))))
    both(ref_pool, port_pool, lambda q: q.read_slots([0, 5, 33, 47]))
    both(ref_pool, port_pool, lambda q: q.read_slot(3))
    both(ref_pool, port_pool, lambda q: q.release([1, 2, 33]))
    both(ref_pool, port_pool, lambda q: q.state_counts())
    assert_pools_equal(ref_pool, port_pool)


@pytest.mark.parametrize("seed", range(2))
def test_pipelined_segments_complete_all(seed):
    """Several in-flight dispatches completed together, in dispatch order."""
    rng = np.random.default_rng(10 + seed)
    ref_pool, port_pool = RefPool(16, 8), ProposalPool(16, 8, device="cpu")
    for q in (ref_pool, port_pool):
        allocate(q, np.random.default_rng(seed), [("s", i) for i in range(16)], 8)
    batches = [
        (rng.integers(0, 16, k), rng.integers(0, 8, k).astype(np.int32), rng.random(k) < 0.5)
        for k in (30, 30, 12)
    ]

    def run(q):
        pendings = [q.ingest_async(s, l, v, NOW + 6) for s, l, v in batches]
        return [(st.tolist(), tr) for st, tr in q.complete_all(pendings)]

    assert run(ref_pool) == run(port_pool)
    assert_pools_equal(ref_pool, port_pool)


def test_completion_order_enforced():
    pool = ProposalPool(4, 4, device="cpu")
    allocate(pool, np.random.default_rng(0), [("s", i) for i in range(4)], 4)
    first = pool.ingest_async(np.array([0]), np.array([0], np.int32), np.array([True]), NOW)
    second = pool.ingest_async(np.array([1]), np.array([0], np.int32), np.array([True]), NOW)
    with pytest.raises(RuntimeError, match="dispatch order"):
        pool.complete(second)
    with pytest.raises(RuntimeError, match="in flight"):
        pool.release([2])
    pool.complete_all([first, second])


def test_pool_full_raises_and_allocates_nothing():
    pool = ProposalPool(2, 4, device="cpu")
    allocate(pool, np.random.default_rng(0), [("s", 0)], 4)
    with pytest.raises(PoolFullError):
        allocate(pool, np.random.default_rng(0), [("s", 1), ("s", 2)], 4)
    assert pool.free_slots == 1


def test_round_trip_through_numpy():
    pool = ProposalPool(8, 4, device="cpu")
    allocate(pool, np.random.default_rng(1), [("s", i) for i in range(6)], 4)
    pool.ingest(np.array([0, 0, 1]), np.array([0, 1, 0], np.int32),
                np.array([True, False, True]), NOW)
    pool.voter_gid(b"x")
    copy = pool_from_numpy(*pool_to_numpy(pool), device="cpu")
    a, ah = pool_to_numpy(pool)
    b, bh = pool_to_numpy(copy)
    for name in DEVICE_ARRAYS:
        np.testing.assert_array_equal(a[name], b[name])
    assert ah["meta"] == bh["meta"] and ah["gid_of"] == bh["gid_of"]


def test_cuda_device_without_gpu_raises():
    """The default device is CUDA; with no GPU the pool refuses instead of
    moving to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ProposalPool(4, 4)


@pytest.mark.parametrize("v_cap", [3, 8, 64])
def test_allocate_and_load_rows_match_reference(v_cap):
    """Several slots allocated and loaded in one call each (the slot
    dispatches send their columns in one copy): every array equal to the
    JAX pool's, including tallies past one byte and odd lane counts."""
    rng = np.random.default_rng(v_cap)
    ref, port = RefPool(16, v_cap), ProposalPool(16, v_cap, device="cpu")
    keys = [("s", i) for i in range(7)]
    slots = both(ref, port, lambda p: allocate(p, np.random.default_rng(3), keys, v_cap))
    k = len(slots)
    rows = dict(
        state=rng.integers(0, 4, k), yes=rng.integers(0, 70_000, k),
        tot=rng.integers(0, 70_000, k), mask_rows=rng.random((k, v_cap)) < 0.5,
        val_rows=rng.random((k, v_cap)) < 0.5,
    )
    for pool in (ref, port):
        pool.load_rows(list(slots[::-1]), **{name: value[::-1] for name, value in rows.items()})
        pool.release([slots[2]])
    assert_pools_equal(ref, port)


@pytest.mark.parametrize("seed", range(4))
def test_deferred_writes_match_reference(seed):
    """Releases, allocations and lane claims made inside
    ``deferred_writes`` (a slot claimed, released and claimed again, and
    claimed then released, in one scope), with a row read and an ingest
    forcing flushes in some seeds: every array and host mirror equal to the
    JAX pool's, which writes at once, and the writes made in one activate
    and one release dispatch a flush. A second scope inside the first
    raises."""
    rng = np.random.default_rng(100 + seed)
    p, v_cap = 12, 8
    ref, port = RefPool(p, v_cap), ProposalPool(p, v_cap, device="cpu")
    calls = {"_dispatch_activate": 0, "_dispatch_release": 0}
    for name in calls:
        def spy(*args, _name=name, _orig=getattr(port, name)):
            calls[_name] += 1
            return _orig(*args)
        setattr(port, name, spy)
    flushes = []
    owners = [bytes([9, i]) for i in range(10)]
    live: list[int] = []
    with port.deferred_writes(lambda slots, forced: flushes.append((slots, forced))):
        with pytest.raises(RuntimeError, match="already open"):
            with port.deferred_writes():
                pass
        for step in range(40):
            op = rng.choice(["alloc", "release", "lanes", "force"], p=[0.4, 0.3, 0.2, 0.1])
            if op == "alloc" and ref.free_slots:
                k = int(rng.integers(1, min(3, ref.free_slots) + 1))
                n = rng.integers(1, v_cap + 1, k)
                thr = rng.choice([2 / 3, 0.9, 1.0], k)
                gossip = rng.random(k) < 0.5
                req = required_votes_np(n, thr)
                args = dict(keys=[("s", seed, step, i) for i in range(k)], n=n,
                            cap=np.where(gossip, 2, req), gossip=gossip,
                            liveness=rng.random(k) < 0.5, expiry=np.full(k, NOW + 50),
                            created_at=np.full(k, NOW))
                slots = ref.allocate_batch(req=req, **args)
                assert port.allocate_batch(req=req, **args) == slots
                live.extend(slots)
            elif op == "release" and live:
                gone = [live.pop(int(rng.integers(len(live))))
                        for _ in range(min(len(live), int(rng.integers(1, 3))))]
                both(ref, port, lambda q: q.release(gone))
            elif op == "lanes" and live:
                slot = live[int(rng.integers(len(live)))]
                for owner in rng.choice(len(owners), 3, replace=False).tolist():
                    both(ref, port, lambda q: q.lane_for(slot, owners[owner]))
            elif op == "force" and live and seed % 2:
                slots = np.asarray(live, np.int64)
                lanes = np.zeros(len(live), np.int32)
                vals = rng.random(len(live)) < 0.5
                ingest = lambda q: q.ingest(slots, lanes, vals, NOW + 1)  # noqa: E731
                read = lambda q: q.read_slots(list(range(p)))  # noqa: E731
                for fn in (ingest, read) if step % 2 else (read, ingest):
                    both(ref, port, fn)
    assert_pools_equal(ref, port)
    forced = [f for f in flushes if f[1]]
    assert len(flushes) - len(forced) <= 1  # the scope's end wrote what was left
    assert calls["_dispatch_activate"] <= len(flushes)
    assert calls["_dispatch_release"] <= len(flushes)
    if seed % 2 == 0:  # nothing forced: one flush of everything, at the end
        assert not forced and len(flushes) == 1
        assert calls["_dispatch_activate"] == 1 and calls["_dispatch_release"] <= 1
