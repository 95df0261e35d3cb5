"""Parity: the port's ingest bodies (hashgraph_tpu_torch.ops.ingest) against
the JAX package's, on identical inputs made with numpy from a seed.

- the plain scan ``ingest_body`` against ``hashgraph_tpu.ops.ingest.
  ingest_body`` and, on int32 grids, against the Pallas kernel run in
  interpret mode (``pallas_ingest_body(..., interpret=True)``);
- ``fresh_ingest_body`` (lane-ful and laneless) against the reference's;
- the host packing helpers against the reference's.

Tolerance: exact equality of every output (statuses, states, tallies,
masks, values). The CUDA kernel itself needs a card; ``chip_smoke.py``
holds it against the plain version there.
"""

import functools
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hashgraph_tpu.ops import ingest as ref
from hashgraph_tpu.ops.decide import STATE_ACTIVE, required_votes_np
from hashgraph_tpu.ops.pallas_ingest import pallas_ingest_body
from hashgraph_tpu_torch import _build
from hashgraph_tpu_torch.errors import StatusCode
from hashgraph_tpu_torch.ops import cuda_ingest
from hashgraph_tpu_torch.ops import ingest as port

NOW = 1_700_000_000
V_CAP = 16
POOL_KEYS = ("state", "yes", "tot", "vote_mask", "vote_val",
             "n", "req", "cap", "gossip", "liveness")
OUT_KEYS = POOL_KEYS[:5] + ("out",)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make_pool(configs, v_cap=V_CAP):
    """Pool arrays from per-slot (n, mode, liveness, threshold, exp_offset)."""
    p = len(configs)
    pool = dict(
        state=np.full(p, STATE_ACTIVE, np.int32),
        yes=np.zeros(p, np.int32),
        tot=np.zeros(p, np.int32),
        vote_mask=np.zeros((p, v_cap), bool),
        vote_val=np.zeros((p, v_cap), bool),
        n=np.zeros(p, np.int32),
        req=np.zeros(p, np.int32),
        cap=np.zeros(p, np.int32),
        gossip=np.zeros(p, bool),
        liveness=np.zeros(p, bool),
        expiry=np.zeros(p, np.int64),
    )
    for i, (n, mode, live, thr, exp_off) in enumerate(configs):
        req = int(required_votes_np(np.array([n]), thr)[0])
        pool["n"][i] = n
        pool["req"][i] = req
        # max_round_limit: gossipsub -> 2 rounds, P2P -> ceil(n*t)
        pool["cap"][i] = 2 if mode == "gossipsub" else req
        pool["gossip"][i] = mode == "gossipsub"
        pool["liveness"][i] = live
        pool["expiry"][i] = NOW + exp_off
    return pool


def random_configs(rng, count):
    return [
        (
            int(rng.integers(1, 13)),
            "gossipsub" if rng.random() < 0.5 else "p2p",
            bool(rng.random() < 0.5),
            float(rng.choice([2 / 3, 0.5, 0.9, 1.0])),
            int(rng.choice([5, 1000])),
        )
        for _ in range(count)
    ]


def pack_trace(pool, trace, now, voter_capacity=None):
    """(slot_pack, grid, row, col) for a flat (slot, voter, value) trace."""
    slots = np.array([s for s, _, _ in trace], np.int64)
    uniq, row, col, depth = port.group_batch(slots)
    s_count = len(uniq)
    voter = np.zeros((s_count, depth), np.int32)
    val = np.zeros((s_count, depth), bool)
    valid = np.zeros((s_count, depth), bool)
    voter[row, col] = [v for _, v, _ in trace]
    val[row, col] = [x for _, _, x in trace]
    valid[row, col] = True
    slot_pack = port.pack_slots(uniq.astype(np.int32), pool["expiry"][uniq] <= now)
    grid = port.pack_grid(voter, val, valid, voter_capacity=voter_capacity)
    return slot_pack, grid, row, col


@functools.cache
def _jitted(body):
    static = [a for a in ("laneless", "block", "interpret")
              if a in inspect.signature(body).parameters]
    return jax.jit(body, static_argnames=static)


def run_ref(body, pool, slot_pack, grid, **kw):
    out = _jitted(body)(*[jnp.asarray(pool[k]) for k in POOL_KEYS],
                        jnp.asarray(slot_pack), jnp.asarray(grid), **kw)
    return dict(zip(OUT_KEYS, map(np.asarray, out)))


def run_port(body, pool, slot_pack, grid, **kw):
    out = body(*[torch.from_numpy(pool[k].copy()) for k in POOL_KEYS],
               torch.from_numpy(slot_pack), port.grid_tensor(grid, "cpu"), **kw)
    return dict(zip(OUT_KEYS, (x.numpy() for x in out)))


def assert_same(a, b):
    for key in OUT_KEYS:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def check_scan(pool, trace, now, voter_capacity=None, pallas=True):
    """Plain scan vs the XLA scan (and the Pallas kernel in interpret mode
    on int32 grids); returns the port's outputs."""
    slot_pack, grid, row, col = pack_trace(pool, trace, now, voter_capacity)
    got = run_port(port.ingest_body, pool, slot_pack, grid)
    assert_same(got, run_ref(ref.ingest_body, pool, slot_pack, grid))
    if pallas and grid.dtype == np.int32:
        assert_same(got, run_ref(pallas_ingest_body, pool, slot_pack, grid,
                                 interpret=True))
    got["statuses"] = got["out"][:, :-1][row, col]
    return got


class TestScanParity:
    def test_consensus_cut_midbatch(self):
        pool = make_pool([(3, "gossipsub", True, 2 / 3, 1000)])
        got = check_scan(pool, [(0, 0, True), (0, 1, True), (0, 2, True)], NOW)
        assert got["statuses"].tolist() == [0, 0, int(StatusCode.ALREADY_REACHED)]
        assert got["tot"][0] == 2

    def test_duplicate_voters(self):
        pool = make_pool([(5, "gossipsub", True, 2 / 3, 1000)])
        got = check_scan(
            pool, [(0, 0, True), (0, 0, False), (0, 1, False), (0, 1, False)], NOW
        )
        assert got["statuses"][1] == int(StatusCode.DUPLICATE_VOTE)

    def test_p2p_round_cap_fails_session_midbatch(self):
        pool = make_pool([(4, "p2p", False, 2 / 3, 1000)])
        got = check_scan(
            pool,
            [(0, 0, True), (0, 1, False), (0, 2, True), (0, 3, True), (0, 4, True)],
            NOW,
        )
        assert got["statuses"][-2:].tolist() == [
            int(StatusCode.MAX_ROUNDS_EXCEEDED), int(StatusCode.SESSION_NOT_ACTIVE)
        ]

    def test_expired_slot(self):
        pool = make_pool([(3, "gossipsub", True, 2 / 3, 10)])
        got = check_scan(pool, [(0, 0, True)], NOW + 10)
        assert got["statuses"][0] == int(StatusCode.PROPOSAL_EXPIRED)

    def test_cap_violation_beats_duplicate(self):
        pool = make_pool([(4, "p2p", False, 2 / 3, 1000)])
        got = check_scan(
            pool, [(0, 0, True), (0, 1, False), (0, 2, True), (0, 0, True)], NOW
        )
        assert got["statuses"][-1] == int(StatusCode.MAX_ROUNDS_EXCEEDED)

    @pytest.mark.parametrize("seed", range(4))
    def test_randomized_traces(self, seed):
        """Random traces in three successive batches, so later batches meet
        decided, failed and partly voted slots."""
        rng = np.random.default_rng(seed)
        pool = make_pool(random_configs(rng, 12))
        for _ in range(3):
            trace = [
                (int(rng.integers(0, 12)), int(rng.integers(0, V_CAP)),
                 bool(rng.random() < 0.5))
                for _ in range(50)
            ]
            got = check_scan(pool, trace, NOW + 6)
            pool.update({k: got[k] for k in POOL_KEYS[:5]})

    def test_pad_rows(self):
        """Pad rows (id == P): no write to the pool; with valid cells too,
        and with row P-1 touched in the same batch."""
        pool = make_pool([(3, "gossipsub", True, 2 / 3, 1000),
                          (5, "p2p", False, 2 / 3, 1000)])
        p = 2
        slot_pack = port.pack_slots(np.array([1, p, 0, p], np.int32),
                                    np.array([False, False, False, True]))
        grid = port.pack_grid(
            np.array([[0, 1, 1], [0, 0, 2], [0, 1, 0], [3, 0, 0]], np.int32),
            np.array([[1, 1, 0], [1, 1, 0], [1, 0, 1], [1, 1, 1]], bool),
            np.array([[1, 1, 1], [1, 1, 1], [1, 1, 0], [1, 0, 0]], bool),
        )
        got = run_port(port.ingest_body, pool, slot_pack, grid)
        assert_same(got, run_ref(ref.ingest_body, pool, slot_pack, grid))
        assert_same(got, run_ref(pallas_ingest_body, pool, slot_pack, grid,
                                 interpret=True))
        assert got["tot"].tolist() == [2, 2]


def fresh_trace(rng, n_slots, lanes_are_cols=False):
    trace = []
    for slot in range(n_slots):
        k = int(rng.integers(0, V_CAP + 1))
        voters = range(k) if lanes_are_cols else rng.permutation(V_CAP)[:k]
        trace.extend((slot, int(v), bool(rng.random() < 0.5)) for v in voters)
    if lanes_are_cols:
        # keep each slot's votes in lane order: lanes == arrival index
        order = np.argsort([s for s, _, _ in trace], kind="stable")
        trace = [trace[i] for i in order]
    else:
        rng.shuffle(trace)
    return trace or [(0, 0, True)]


class TestFreshParity:
    CASES = [
        ([(3, "gossipsub", True, 2 / 3, 1000)],
         [(0, 0, True), (0, 1, True), (0, 2, True)]),
        ([(4, "p2p", False, 2 / 3, 1000)],
         [(0, 0, True), (0, 1, False), (0, 2, True), (0, 3, True), (0, 4, True)]),
        ([(3, "gossipsub", True, 2 / 3, 10)], [(0, 0, True), (0, 1, False)]),
        ([(8, "p2p", True, 0.9, 1000)], [(0, 0, True), (0, 1, False), (0, 2, True)]),
        ([(6, "p2p", False, 1.0, 1000), (2, "gossipsub", True, 2 / 3, 1000)],
         [(0, 0, True), (1, 0, True), (0, 1, True), (1, 1, False),
          (0, 2, False), (0, 3, True), (0, 4, True), (0, 5, True)]),
    ]

    @pytest.mark.parametrize("case", range(len(CASES)))
    def test_targeted_cases(self, case):
        configs, trace = self.CASES[case]
        pool = make_pool(configs)
        slot_pack, grid, _, _ = pack_trace(pool, trace, NOW + 20)
        got = run_port(port.fresh_ingest_body, pool, slot_pack, grid)
        assert_same(got, run_ref(ref.fresh_ingest_body, pool, slot_pack, grid))
        # and the closed form agrees with the scan on its domain
        assert_same(got, run_port(port.ingest_body, pool, slot_pack, grid))

    @pytest.mark.parametrize("seed", range(4))
    def test_randomized(self, seed):
        rng = np.random.default_rng(1000 + seed)
        pool = make_pool(random_configs(rng, 10))
        slot_pack, grid, _, _ = pack_trace(pool, fresh_trace(rng, 10), NOW + 6)
        got = run_port(port.fresh_ingest_body, pool, slot_pack, grid)
        assert_same(got, run_ref(ref.fresh_ingest_body, pool, slot_pack, grid))
        assert_same(got, run_port(port.ingest_body, pool, slot_pack, grid))

    @pytest.mark.parametrize("seed", range(3))
    def test_laneless(self, seed):
        rng = np.random.default_rng(7100 + seed)
        pool = make_pool(random_configs(rng, 8))
        trace = fresh_trace(rng, 8, lanes_are_cols=True)
        slot_pack, _, row, col = pack_trace(pool, trace, NOW + 6)
        grid = np.zeros((len(slot_pack), int(col.max()) + 1), np.uint8)
        grid[row, col] = np.array([x for _, _, x in trace], np.uint8) | 2
        got = run_port(port.fresh_ingest_body, pool, slot_pack, grid, laneless=True)
        assert_same(got, run_ref(ref.fresh_ingest_body, pool, slot_pack, grid,
                                 laneless=True))


@pytest.mark.parametrize("cap_hint", [16, 4096, None])
@pytest.mark.parametrize("seed", range(2))
def test_grid_dtypes(seed, cap_hint):
    """uint8 / uint16 (carried as int16 bits) / int32 grids give the same
    results as the reference on both bodies."""
    rng = np.random.default_rng(4200 + seed)
    pool = make_pool(random_configs(rng, 6))
    trace = fresh_trace(rng, 6)
    slot_pack, grid, _, _ = pack_trace(pool, trace, NOW + 6, voter_capacity=cap_hint)
    assert grid.dtype == (ref.grid_dtype(cap_hint) if cap_hint else np.int32)
    for port_body, ref_body in ((port.ingest_body, ref.ingest_body),
                                (port.fresh_ingest_body, ref.fresh_ingest_body)):
        assert_same(run_port(port_body, pool, slot_pack, grid),
                    run_ref(ref_body, pool, slot_pack, grid))


def test_uint16_grid_travels_as_int16_bits():
    grid = np.array([[0xFFFF, 0x8001, 0x7FFF]], np.uint16)
    cells = port.grid_tensor(grid, "cpu")
    assert cells.dtype == torch.int16
    assert port.grid_layout(cells.dtype) == ref.grid_layout(np.uint16)
    lanes, vals, valid = port._unpack_cells(cells)
    assert lanes.tolist() == [[0x3FFF, 1, 0x3FFF]]
    assert vals.tolist() == [[True, False, True]]
    assert valid.tolist() == [[True, True, False]]


@pytest.mark.parametrize("seed", range(2))
def test_host_helpers_identical(seed):
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, 40, 300)
    for a, b in zip(port.group_batch(slots), ref.group_batch(slots)):
        np.testing.assert_array_equal(a, b)
    ids = rng.integers(0, 1 << 30, 50).astype(np.int32)
    exp = rng.random(50) < 0.5
    packed = port.pack_slots(ids, exp)
    np.testing.assert_array_equal(packed, ref.pack_slots(ids, exp))
    for a, b in zip(port.unpack_slots(packed), ref.unpack_slots(packed)):
        np.testing.assert_array_equal(a, b)
    for cap in (1, 64, 65, 16384, 16385, 65536):
        assert port.grid_dtype(cap) == ref.grid_dtype(cap)
        dt = port.grid_dtype(cap)
        assert port.grid_layout(dt) == ref.grid_layout(dt)
        lanes = rng.integers(0, cap, (7, 5))
        vals = rng.random((7, 5)) < 0.5
        valid = rng.random((7, 5)) < 0.5
        a = port.pack_grid(lanes, vals, valid, voter_capacity=cap)
        b = ref.pack_grid(lanes, vals, valid, voter_capacity=cap)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_scan_dispatch_on_cpu_runs_plain_version_and_counts_nothing():
    rng = np.random.default_rng(5)
    pool = make_pool(random_configs(rng, 8))
    trace = [(int(rng.integers(0, 8)), int(rng.integers(0, V_CAP)), True)
             for _ in range(30)]
    slot_pack, grid, _, _ = pack_trace(pool, trace, NOW + 6)
    before = _build.launches[cuda_ingest.KERNEL]
    pool_t = [torch.from_numpy(pool[k].copy()) for k in POOL_KEYS]
    out = cuda_ingest.ingest_scan(*pool_t, torch.from_numpy(slot_pack),
                                  port.grid_tensor(grid, "cpu"))
    np.testing.assert_array_equal(
        out.numpy(), run_port(port.ingest_body, pool, slot_pack, grid)["out"]
    )
    assert _build.launches[cuda_ingest.KERNEL] == before


def test_scan_dispatch_refuses_other_devices():
    """No fallback: a tensor on neither the CPU nor CUDA raises."""
    pool = make_pool([(3, "gossipsub", True, 2 / 3, 1000)])
    pool_t = [torch.from_numpy(pool[k]).to("meta") for k in POOL_KEYS]
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_ingest.ingest_scan(*pool_t, torch.zeros(1, dtype=torch.int32, device="meta"),
                                torch.zeros((1, 1), dtype=torch.int32, device="meta"))


def test_cuda_source_status_codes_match_enum():
    """The kernel hard-codes status and state codes; they must be the
    Python ones."""
    src = (Path(_build.CSRC) / "ingest_scan.cu").read_text()
    consts = dict(
        (name, int(value))
        for name, value in re.findall(r"constexpr int (k\w+) = (-?\d+);", src)
    )
    assert consts["kPadStatus"] == port.PAD_STATUS
    for const, code in (
        ("kOk", StatusCode.OK),
        ("kDuplicateVote", StatusCode.DUPLICATE_VOTE),
        ("kProposalExpired", StatusCode.PROPOSAL_EXPIRED),
        ("kSessionNotActive", StatusCode.SESSION_NOT_ACTIVE),
        ("kMaxRoundsExceeded", StatusCode.MAX_ROUNDS_EXCEEDED),
        ("kAlreadyReached", StatusCode.ALREADY_REACHED),
    ):
        assert consts[const] == int(code), const
    from hashgraph_tpu_torch.ops import decide

    assert consts["kStateActive"] == decide.STATE_ACTIVE
    assert consts["kStateFailed"] == decide.STATE_FAILED
    assert consts["kStateReachedNo"] == decide.STATE_REACHED_NO
    assert consts["kStateReachedYes"] == decide.STATE_REACHED_YES


# ── the CUDA kernel's row walk, built for the host ─────────────────────

SCAN_HARNESS = r"""
#include "ingest_scan.cu"

template <typename Cell>
static void run(void** t, const void* grid, void* out, int s_count, int depth,
                int p, int v, int lane_mask, int val_bit, int valid_bit,
                int has_pad, int max_vec) {
  int vec = vec_width(reinterpret_cast<uintptr_t>(grid),
                      static_cast<size_t>(depth) * sizeof(Cell));
  while (vec > max_vec) vec /= 2;
  if (vec == 2) vec = 1;
  // The launches' order: pad rows first, then the real rows.
  for (int phase = has_pad ? 1 : 0; phase >= 0; --phase)
    for (int r = 0; r < s_count; ++r)
      (depth <= kShortChunk ? scan_row<Cell, kShortChunk> : scan_row<Cell, kLongChunk>)(
                     r, static_cast<int32_t*>(t[0]), static_cast<int32_t*>(t[1]),
                     static_cast<int32_t*>(t[2]), static_cast<uint8_t*>(t[3]),
                     static_cast<uint8_t*>(t[4]), static_cast<const int32_t*>(t[5]),
                     static_cast<const int32_t*>(t[6]), static_cast<const int32_t*>(t[7]),
                     static_cast<const uint8_t*>(t[8]), static_cast<const uint8_t*>(t[9]),
                     static_cast<const int32_t*>(t[10]), static_cast<const Cell*>(grid),
                     static_cast<int8_t*>(out), depth, p, v,
                     static_cast<uint32_t>(lane_mask), val_bit, valid_bit, vec,
                     phase == 1);
}

extern "C" void h_scan(void** t, const void* grid, void* out, int s_count,
                       int depth, int p, int v, int cell_bytes, int lane_mask,
                       int val_bit, int valid_bit, int has_pad, int max_vec) {
  if (cell_bytes == 1)
    run<uint8_t>(t, grid, out, s_count, depth, p, v, lane_mask, val_bit, valid_bit, has_pad, max_vec);
  else if (cell_bytes == 2)
    run<uint16_t>(t, grid, out, s_count, depth, p, v, lane_mask, val_bit, valid_bit, has_pad, max_vec);
  else
    run<int32_t>(t, grid, out, s_count, depth, p, v, lane_mask, val_bit, valid_bit, has_pad, max_vec);
}
"""


@pytest.fixture(scope="module")
def scan_host(tmp_path_factory):
    """The scan kernel's per-row walk built by a host C++ compiler."""
    import ctypes
    import shutil
    import subprocess

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel's walk")
    tmp = tmp_path_factory.mktemp("scan_host")
    (tmp / "harness.cpp").write_text(SCAN_HARNESS)
    lib_path = tmp / "libscan_host.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(_build.CSRC),
                    "-o", str(lib_path), str(tmp / "harness.cpp")],
                   check=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    lib.h_scan.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
    lib.h_scan.restype = None
    return lib


def kernel_inputs(seed, p, v, s, depth, grid_dtype, pad_share=0.0):
    """Pool arrays and one packed batch: random prior votes, decided and
    failed rows, rows at their round cap, expired rows, repeated lanes
    within a row (near and far apart) and, when ``pad_share`` > 0, pad
    rows (id == P). Lanes stay below V, where the plain scan is defined."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1, v + 1, p).astype(np.int32)
    gossip = rng.random(p) < 0.5
    req = required_votes_np(n, rng.choice([2 / 3, 0.9, 1.0], p)).astype(np.int32)
    cap = np.where(gossip, 2, req).astype(np.int32)
    prior = np.minimum(rng.integers(0, 4, p), n)
    mask = np.arange(v)[None, :] < prior[:, None]
    vals = mask & (rng.random((p, v)) < 0.5)
    tot = prior.astype(np.int32)
    at_cap = (~gossip) & (rng.random(p) < 0.1)
    cap[at_cap] = tot[at_cap]
    pool = dict(
        state=np.array([1, 1, 1, 1, 2, 3, 4], np.int32)[rng.integers(0, 7, p)],
        yes=vals.sum(axis=1).astype(np.int32), tot=tot, vote_mask=mask,
        vote_val=vals, n=n, req=req, cap=cap, gossip=gossip,
        liveness=rng.random(p) < 0.5,
    )
    slots = rng.permutation(p)[:s].astype(np.int32)
    slots[rng.random(s) < pad_share] = p
    lane_mask, val_bit, valid_bit = port.grid_layout(grid_dtype)
    hi = min(v, lane_mask + 1)
    lanes = rng.integers(0, min(hi, 12), (s, depth))  # small range: repeats
    lanes[:, depth // 2:] = rng.integers(0, hi, (s, depth - depth // 2))
    cells = (lanes | ((rng.random((s, depth)) < 0.6).astype(np.int64) << val_bit)
             | ((rng.random((s, depth)) < 0.9).astype(np.int64) << valid_bit))
    slot_pack = port.pack_slots(slots, rng.random(s) < 0.1)
    return pool, slot_pack, cells.astype(grid_dtype)


def run_scan_host(lib, pool, slot_pack, grid, max_vec=16):
    import ctypes

    arrays = [np.ascontiguousarray(pool[k]).copy() for k in POOL_KEYS]
    arrays = [a.view(np.uint8) if a.dtype == bool else a for a in arrays]
    arrays.append(np.ascontiguousarray(slot_pack, np.int32))
    grid = np.ascontiguousarray(grid)
    s, depth = grid.shape
    out = np.zeros((s, depth + 1), np.int8)
    ptrs = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])
    lane_mask, val_bit, valid_bit = port.grid_layout(grid.dtype)
    p, v = pool["vote_mask"].shape
    has_pad = bool(((slot_pack & ((1 << 30) - 1)) >= p).any())
    lib.h_scan(ptrs, grid.ctypes.data, out.ctypes.data, s, depth, p, v,
               grid.dtype.itemsize, lane_mask, val_bit, valid_bit, int(has_pad), max_vec)
    got = {k: (a.view(bool) if pool[k].dtype == bool else a)
           for k, a in zip(POOL_KEYS, arrays)}
    got["out"] = out
    return got


@pytest.mark.parametrize("max_vec", [16, 8, 4, 1])
@pytest.mark.parametrize("depth", [8, 3, 6, 40, 128])
@pytest.mark.parametrize("grid_dtype", [np.uint8, np.uint16, np.int32])
def test_scan_kernel_walk_matches_plain(scan_host, grid_dtype, depth, max_vec):
    """The kernel's row walk (vector cell loads, the mask bytes gathered up
    front, duplicates found against the chunk's own accepts, the write-back
    at each chunk's end) gives the plain scan's statuses and pool, bit for
    bit, on every layout, at depths below, across and many times the
    32-vote chunk, with every vector width the row allows."""
    v = {np.uint8: 48, np.uint16: 300, np.int32: 70}[grid_dtype]
    pool, slot_pack, grid = kernel_inputs(depth * 7 + max_vec, 64, v, 40, depth, grid_dtype)
    want = run_port(port.ingest_body, pool, slot_pack, grid)
    assert_same(run_scan_host(scan_host, pool, slot_pack, grid, max_vec), want)
    statuses = set(want["out"][:, :-1].ravel().tolist())
    assert {0, int(StatusCode.DUPLICATE_VOTE)} <= statuses


@pytest.mark.parametrize("depth", [3, 8, 70])
def test_scan_kernel_walk_pad_rows(scan_host, depth):
    """Pad rows in the batch (the pad launch first), also deeper than one
    chunk, where a pad row finds its earlier chunks' accepts from its own
    statuses; the plain scan's outputs bit for bit."""
    pool, slot_pack, grid = kernel_inputs(900 + depth, 16, 40, 12, depth, np.uint8,
                                          pad_share=0.3)
    assert ((slot_pack & ((1 << 30) - 1)) == 16).any()
    want = run_port(port.ingest_body, pool, slot_pack, grid)
    assert_same(run_scan_host(scan_host, pool, slot_pack, grid), want)
