"""The MSM and inverse-square-root kernels' arithmetic, on the CPU.

A host C++ compiler builds the lane and group routines of ``csrc/ed_msm.cu``
and ``csrc/fe_pow22523.cu`` (everything outside their ``__CUDACC__`` launch
blocks, over the shared ``csrc/fe25519.cuh`` and ``csrc/fe25519_group.cuh``)
into a small library that ctypes loads, and each is held limb for limb
against its plain PyTorch version: ``curve.add``, ``curve.dbl``,
``curve.is_identity``, ``field._mul_plain``, ``msm._windows_plain``,
``msm._reduce_plain``, ``msm._final_plain`` and ``field._pow22523_plain``.
The routines that the kernels run with G threads a point are built for
G = 1 (the one-thread code), 4, 8 and 16; the harness runs a group's
threads as fibers (POSIX ``ucontext``) on one host thread, stepping them in
turn at every ``grp_get`` exchange, so the exact arithmetic of the card's
code runs here. The tree of ``msm_reduce`` is stepped as its blocks run it:
one group's ``tree_pair`` per element, level by level (the host loop
standing in for ``__syncthreads()``), in the wrapper's schedule of passes.
The plain window stage is held against the JAX package's own ``curve.add``
and ``curve.dbl`` composed in the same order; the CPU dispatch of the MSM
and the chain is checked to run the plain versions and launch nothing; and
a kernel's build target is checked to follow the shared header. Inputs are
made from seeds; tolerance: exact equality (integer arithmetic).
"""

import ctypes
import functools
import random
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_crypto import EDGE_A, limbs, msm_cases, pt_limbs

from hashgraph_tpu.crypto_device import curve as ref_curve
from hashgraph_tpu.signing import _ed25519 as ref_py
from hashgraph_tpu_torch import _build, convert
from hashgraph_tpu_torch.crypto_device import cuda_field, cuda_msm, curve, msm
from hashgraph_tpu_torch.crypto_device import field as fe

CSRC = Path(__file__).resolve().parent.parent / "hashgraph_tpu_torch" / "csrc"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


HARNESS = r"""
#include "ed_msm.cu"
#include "fe_pow22523.cu"

// The G threads of a group as fibers (POSIX ucontext) on one host thread,
// stepped in turn: each exchange (grp_get) publishes the caller's value and
// passes control to the next thread; when every thread has published, each
// reads the value it asked for (two slot buffers, so a thread's next publish
// never overwrites a value another thread has still to read).
#include <ucontext.h>

static const int kMain = 16;
static ucontext_t g_ctx[17];
static char g_stacks[16][1 << 17];
static int g_n, g_cur;
static uint32_t g_slot[2][16];
static int g_phase[16];
static void (*g_body)(int);

static void switch_to(int next) {
  const int me = g_cur;
  g_cur = next;
  swapcontext(&g_ctx[me], &g_ctx[next]);
}

int host_grp_rank() { return g_cur; }

uint32_t host_grp_get(uint32_t v, int from) {
  const int me = g_cur, b = g_phase[me];
  g_phase[me] ^= 1;
  g_slot[b][me] = v;
  switch_to(me + 1 < g_n ? me + 1 : 0);
  return g_slot[b][from];
}

// A fiber ends by passing control on, so it never returns from its entry.
static void fiber_main() {
  g_body(g_cur);
  const int me = g_cur;
  switch_to(me + 1 < g_n ? me + 1 : kMain);
}

static void run_group(int n, void (*body)(int)) {
  g_n = n;
  g_body = body;
  for (int r = 0; r < n; ++r) {
    g_phase[r] = 0;
    getcontext(&g_ctx[r]);
    g_ctx[r].uc_stack.ss_sp = g_stacks[r];
    g_ctx[r].uc_stack.ss_size = sizeof g_stacks[r];
    g_ctx[r].uc_link = nullptr;
    makecontext(&g_ctx[r], fiber_main, 0);
  }
  g_cur = 0;
  swapcontext(&g_ctx[kMain], &g_ctx[0]);
}

// Arguments of the group bodies.
static const int64_t *g_p, *g_q;
static const int32_t* g_nib;
static int64_t* g_out;
static uint16_t* g_table;
static const uint16_t* g_q16;
static uint16_t* g_out16;
static int g_windows, g_count, g_i, g_verdict;

template <int G> static void body_add(int) {
  uint32_t a[4][16 / G], b[4][16 / G];
  gpt_load<G>(g_p, a);
  gpt_load<G>(g_q, b);
  ged_add<G>(a, b, a);
  gpt_store<G>(a, g_out);
}
template <int G> static void body_dbl(int) {
  uint32_t a[4][16 / G];
  gpt_load<G>(g_p, a);
  ged_dbl<G>(a, a);
  gpt_store<G>(a, g_out);
}
template <int G> static void body_identity(int r) {
  uint32_t a[4][16 / G];
  gpt_load<G>(g_p, a);
  const int v = ged_is_identity<G>(a) ? 1 : 0;
  if (r == 0) g_verdict = v;
}
template <int G> static void body_mul(int) {  // coordinate 0 of p times that of q
  uint32_t a[4][16 / G], b[4][16 / G];
  gpt_load<G>(g_p, a);
  gpt_load<G>(g_q, b);
  gfe_mul<G>(a[0], b[0], a[0]);
  gfe_sqr<G>(a[1], a[1]);
  gpt_store<G>(a, g_out);
}
template <int G> static void body_carry(int) {  // fe_carry of raw limbs
  uint32_t a[4][16 / G];
  gpt_load<G>(g_p, a);
  for (int c = 0; c < 4; ++c) gfe_carry<G>(a[c]);
  gpt_store<G>(a, g_out);
}
template <int G> static void body_windows(int) {
  msm_group_windows<G>(g_p, g_nib, g_windows, g_table, g_out);
}
template <int G> static void body_pair64(int) { tree_pair<G>(g_p, g_count, g_i, g_out16); }
template <int G> static void body_pair16(int) { tree_pair<G>(g_q16, g_count, g_i, g_out16); }
template <int G> static void body_verdict(int r) {
  const int v = tree_verdict<G>(g_q16, g_out);
  if (r == 0) g_verdict = v;
}
template <int G> static void body_pow(int) { pow22523_group<G>(g_p, g_out); }

typedef void (*Body)(int);
static Body pick(int G, Body b1, Body b2, Body b4, Body b8, Body b16) {
  return G == 1 ? b1 : G == 2 ? b2 : G == 4 ? b4 : G == 8 ? b8 : b16;
}
#define BODIES(name) pick(G, name<1>, name<2>, name<4>, name<8>, name<16>)

extern "C" {
// G == 1 runs the one-thread code of fe25519.cuh (a group of one hands
// every routine to it); 2, 4, 8 and 16 the group routines.
void h_ed_add(int G, const int64_t* p, const int64_t* q, int64_t* out, int n) {
  for (int k = 0; k < n; ++k) {
    g_p = p + k * kPointLimbs; g_q = q + k * kPointLimbs; g_out = out + k * kPointLimbs;
    run_group(G, BODIES(body_add));
  }
}
void h_ed_dbl(int G, const int64_t* p, int64_t* out, int n) {
  for (int k = 0; k < n; ++k) {
    g_p = p + k * kPointLimbs; g_out = out + k * kPointLimbs;
    run_group(G, BODIES(body_dbl));
  }
}
void h_is_identity(int G, const int64_t* p, int32_t* out, int n) {
  for (int k = 0; k < n; ++k) {
    g_p = p + k * kPointLimbs;
    run_group(G, BODIES(body_identity));
    out[k] = g_verdict;
  }
}
void h_mul_sqr(int G, const int64_t* p, const int64_t* q, int64_t* out, int n) {
  for (int k = 0; k < n; ++k) {
    g_p = p + k * kPointLimbs; g_q = q + k * kPointLimbs; g_out = out + k * kPointLimbs;
    run_group(G, BODIES(body_mul));
  }
}
void h_carry(int G, const int64_t* p, int64_t* out, int n) {
  for (int k = 0; k < n; ++k) {
    g_p = p + k * kPointLimbs; g_out = out + k * kPointLimbs;
    run_group(G, BODIES(body_carry));
  }
}
void h_windows(int G, const int64_t* points, const int32_t* nibbles, int lanes,
               int windows, uint16_t* table, int64_t* out) {
  g_windows = windows;
  for (int k = 0; k < lanes; ++k) {
    g_p = points + k * kPointLimbs; g_nib = nibbles + k * windows;
    g_table = table + k * kEntries * kPointLimbs; g_out = out + k * kPointLimbs;
    run_group(G, BODIES(body_windows));
  }
}
int h_group() { return kGroup; }
// One tree level of msm_reduce's block over `count` points: every group's
// tree_pair in turn (the host loop stands in for __syncthreads()), level 0
// from int64 points, later levels from uint16 entries.
void h_tree_level64(int G, const int64_t* q, int count, uint16_t* out) {
  g_p = q; g_count = count;
  for (g_i = 0; g_i < (count + 1) / 2; ++g_i) {
    g_out16 = out + g_i * kPointLimbs;
    run_group(G, BODIES(body_pair64));
  }
}
void h_tree_level16(int G, const uint16_t* q, int count, uint16_t* out) {
  g_q16 = q; g_count = count;
  for (g_i = 0; g_i < (count + 1) / 2; ++g_i) {
    g_out16 = out + g_i * kPointLimbs;
    run_group(G, BODIES(body_pair16));
  }
}
int h_tree_verdict(int G, const uint16_t* root, int64_t* root_out) {
  g_q16 = root; g_out = root_out;
  run_group(G, BODIES(body_verdict));
  return g_verdict;
}
int h_tree_levels(int count) { return tree_levels(count); }
int h_tree_span() { return kTreeSpan; }
int h_tree_group() { return kTreeGroup; }
void h_pow22523(int G, const int64_t* z, int64_t* out, int n) {
  for (int k = 0; k < n; ++k) {
    g_p = z + k * kLimbs; g_out = out + k * kLimbs;
    run_group(G, BODIES(body_pow));
  }
}
int h_pow_group() { return kPowGroup; }
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The kernels' lane routines built by a host C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' arithmetic")
    tmp = tmp_path_factory.mktemp("msm_host")
    (tmp / "harness.cpp").write_text(HARNESS)
    lib_path = tmp / "libmsm_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib_path), str(tmp / "harness.cpp")],
                   check=True, timeout=120)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, args, res in (
        ("h_ed_add", [i32, ptr, ptr, ptr, i32], None),
        ("h_ed_dbl", [i32, ptr, ptr, i32], None),
        ("h_is_identity", [i32, ptr, ptr, i32], None),
        ("h_mul_sqr", [i32, ptr, ptr, ptr, i32], None),
        ("h_carry", [i32, ptr, ptr, i32], None),
        ("h_windows", [i32, ptr, ptr, i32, i32, ptr, ptr], None),
        ("h_group", [], i32),
        ("h_tree_level64", [i32, ptr, i32, ptr], None),
        ("h_tree_level16", [i32, ptr, i32, ptr], None),
        ("h_tree_verdict", [i32, ptr, ptr], i32),
        ("h_tree_levels", [i32], i32),
        ("h_tree_span", [], i32),
        ("h_tree_group", [], i32),
        ("h_pow22523", [i32, ptr, ptr, i32], None),
        ("h_pow_group", [], i32),
    ):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


GROUPS = [4, 8, 16]  # threads per lane the group routines are built for


def host_ed_add(host, p, q, group=1):
    out = np.empty_like(p)
    host.h_ed_add(group, _p(p), _p(q), _p(out), len(p))
    return out


def host_windows(host, points, nibbles, group=None):
    """The window stage as msm_windows runs it, with ``group`` threads a
    lane (default: the kernel's, kGroup)."""
    lanes, windows = nibbles.shape
    table = np.zeros((lanes, 16, 64), np.uint16)
    out = np.empty_like(points)
    host.h_windows(group or host.h_group(), _p(points), _p(nibbles), lanes, windows,
                   _p(table), _p(out))
    return out


def host_tree_block(host, group, q, levels):
    """One block of msm_reduce: ``levels`` levels over the int64 points q,
    each level one group's ``tree_pair`` per element in turn (the host loop
    standing in for ``__syncthreads()``), level 0 from q and later levels
    from the uint16 entries of the level before. Returns the last level's
    element 0, a uint16 entry."""
    count = len(q)
    entries = np.empty(((count + 1) // 2, 64), np.uint16)
    host.h_tree_level64(group, _p(np.ascontiguousarray(q)), count, _p(entries))
    for _ in range(levels - 1):
        count = len(entries)
        nxt = np.empty(((count + 1) // 2, 64), np.uint16)
        host.h_tree_level16(group, _p(entries), count, _p(nxt))
        entries = nxt
    return entries[0]


def host_reduce(host, acc, group=None, span=None):
    """msm_reduce as the wrapper schedules it (``cuda_msm.tree_passes``):
    passes of ``span``-point blocks into int64 partials, then the root
    block and the epilogue. Returns (root, verdict); ``group`` and ``span``
    default to the kernel's kTreeGroup and kTreeSpan."""
    group = group or host.h_tree_group()
    span = span or host.h_tree_span()
    q = np.ascontiguousarray(acc, dtype=np.int64)
    for count in cuda_msm.tree_passes(len(q), span)[:-1]:
        q = np.stack([host_tree_block(host, group, q[b:b + span], span.bit_length() - 1)
                      .astype(np.int64).reshape(4, 16) for b in range(0, count, span)])
    entry = host_tree_block(host, group, q, host.h_tree_levels(len(q)))
    root = np.empty((4, 16), np.int64)
    verdict = host.h_tree_verdict(group, _p(entry), _p(root))
    return root, verdict


def host_msm(host, points, nibbles) -> int:
    return host_reduce(host, host_windows(host, points, nibbles))[1]


def curve_points(seed, n):
    """``n`` multiples of the base point from seeded scalars in extended
    coordinates with Z != 1 (each is a sum of two affine multiples), then
    the identity and the order-4 point (y = 0)."""
    rng = random.Random(seed)
    affine = [ref_py._mul(ref_py._BASE, rng.getrandbits(252)) for _ in range(2 * n)]
    pts = [ref_py._add(affine[2 * i], affine[2 * i + 1]) for i in range(n)]
    pts += [ref_py._IDENTITY, ref_py._decode(bytes(32))]
    return np.stack([pt_limbs(p) for p in pts]).astype(np.int64)


def carried_rows(seed, n):
    """Arbitrary carried limbs (not curve points): the kernel's formulas
    must give the plain version's limbs on any carried input, so random
    rows, all-0xFFFF rows and the field battery's boundary values stress
    every carry path."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 16, (n, 4, 16)).astype(np.int64)
    rows[0] = 0xFFFF
    rows[1, :, :] = limbs(EDGE_A[:4]).astype(np.int64)
    rows[2, :, :] = limbs(EDGE_A[4:8]).astype(np.int64)
    rows[3] = 0
    return rows


def port(arr) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64))


# ── the point formulas ─────────────────────────────────────────────────


@pytest.mark.parametrize("group", [1] + GROUPS)
@pytest.mark.parametrize("kind", ["curve points", "carried limbs"])
def test_ed_add_dbl_is_identity_match_plain(host, kind, group):
    """ed_add, ed_dbl and the identity test of one thread (group 1) and of G
    threads a point (the window loop's and the tree's)."""
    pts = curve_points(1, 6) if kind == "curve points" else carried_rows(2, 12)
    other = np.ascontiguousarray(pts[::-1])
    np.testing.assert_array_equal(host_ed_add(host, pts, other, group),
                                  curve.add(port(pts), port(other)).numpy())
    np.testing.assert_array_equal(host_ed_add(host, pts, pts, group),
                                  curve.add(port(pts), port(pts)).numpy())
    dbl = np.empty_like(pts)
    host.h_ed_dbl(group, _p(pts), _p(dbl), len(pts))
    np.testing.assert_array_equal(dbl, curve.dbl(port(pts)).numpy())
    ident = np.empty(len(pts), np.int32)
    host.h_is_identity(group, _p(pts), _p(ident), len(pts))
    np.testing.assert_array_equal(ident.astype(bool), curve.is_identity(port(pts)).numpy())
    if kind == "curve points":
        assert ident.tolist() == [0] * 6 + [1, 0]


def identity_rows(seed):
    """Carried points on either side of the identity test's limb equality:
    X in {0, p, 2p} with Y - Z in {0, p} (identities whose limbs are not
    the identity's), then X or Y - Z one off those values (not identities),
    with random Z and T."""
    rng = random.Random(seed)
    p = fe.P
    rows = []
    for x in (0, p, 2 * p, 1, p - 1, p + 1, 2 * p + 1, 2**256 - 1):
        for dy in (0, p, 1, p - 1):
            z = rng.randrange(p)
            rows.append([x, z + dy, z, rng.getrandbits(256)])
    return np.stack([limbs(r) for r in rows]).astype(np.int64)


@pytest.mark.parametrize("group", [1] + GROUPS)
def test_group_identity_test_matches_plain(host, group):
    """The identity test (the tree's epilogue) against curve.is_identity on
    the identity, the order-4 point, random multiples of B, carried rows,
    and identities in limbs other than the identity's."""
    pts = np.concatenate([curve_points(5, 6), carried_rows(6, 8), identity_rows(7)])
    ident = np.empty(len(pts), np.int32)
    host.h_is_identity(group, _p(pts), _p(ident), len(pts))
    want = curve.is_identity(port(pts)).numpy()
    np.testing.assert_array_equal(ident.astype(bool), want)
    assert ident[6] == 1 and ident[7] == 0  # the identity; the order-4 point
    assert int(want[14:].sum()) == 6  # X in {0, p, 2p}, Y - Z in {0, p}


# ── the window loop, the tree and the verdict ──────────────────────────


def window_inputs(seed, lanes=8):
    pts = curve_points(seed, lanes - 2)
    rng = np.random.default_rng(seed)
    nib = rng.integers(0, 16, (lanes, msm.WINDOWS)).astype(np.int32)
    nib[0] = 0
    nib[1] = 15
    return pts, nib


@pytest.mark.parametrize("group", GROUPS)
def test_window_loop_matches_plain(host, group):
    pts, nib = window_inputs(3)
    got = host_windows(host, pts, nib, group)
    np.testing.assert_array_equal(got, msm._windows_plain(port(pts), torch.from_numpy(nib)).numpy())
    assert got.max() < 1 << 16 and got.min() >= 0
    # the all-0 row leaves the identity's limbs (0 : 1 : 1 : 0 up to scale)
    assert fe.limbs_to_int(got[0, 0]) % fe.P == 0


def ripple_rows(seed, n):
    """Raw limbs at the carry's input bounds (below 2^27), built so that the
    exact passes meet long 0xFFFF ripples: rows of 0xFFFF limbs with a
    carry arriving at limb 0, at a group boundary and from the top fold,
    plus random columns."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 27, (n, 4, 16)).astype(np.int64)
    rows[0] = 0xFFFF
    rows[0, :, 0] = 0x10000  # a carry out of limb 0 into fifteen 0xFFFF limbs
    rows[1] = 0xFFFF
    rows[1, 0, 15] = 0x1FFFF  # the top fold re-enters limb 0 through ripples
    rows[1, 1, 3] = rows[1, 2, 7] = rows[1, 3, 11] = 0x10000  # group boundaries
    rows[2] = (1 << 27) - 1
    rows[3] = 0
    rows[3, :, ::2] = 0xFFFF
    rows[3, :, 1::2] = 0xFFFF + 0x40
    return rows


def second_pass_carries(limbs) -> bool:
    """Whether field.carry's second exact pass changes this row: two
    carry-save passes and one exact pass in Python ints, then limb 0."""
    t = [int(x) for x in limbs]
    for _ in range(2):
        c = [x >> 16 for x in t]
        t = [x & 0xFFFF for x in t]
        t = [t[0] + 38 * c[15]] + [t[i] + c[i - 1] for i in range(1, 16)]
    c = 0
    for i in range(16):
        t[i], c = (t[i] + c) & 0xFFFF, (t[i] + c) >> 16
    return t[0] + 38 * c >= 1 << 16


@pytest.mark.parametrize("group", GROUPS)
def test_group_carry_lookahead_matches_ripple(host, group):
    """The group's carry (carry-save passes by one exchange, the exact passes
    by a carry lookahead across the group) gives the one-thread ripple's
    limbs, on 0xFFFF ripples crossing every group boundary."""
    rows = ripple_rows(41 + group, 24)
    want = np.empty_like(rows)
    host.h_carry(1, _p(rows), _p(want), len(rows))
    got = np.empty_like(rows)
    host.h_carry(group, _p(rows), _p(got), len(rows))
    np.testing.assert_array_equal(got, want)
    assert want.max() < 1 << 16 or want[..., 0].max() < (1 << 16) + 38
    # The group runs its second exact pass only where limb 0 still carries;
    # these rows include such a case.
    assert any(second_pass_carries(row) for row in rows.reshape(-1, 16))


@pytest.mark.parametrize("group", GROUPS)
def test_group_product_matches_plain(host, group):
    """gfe_mul and gfe_sqr of G threads against field._mul_plain on carried
    rows: random, all-0xFFFF and the field battery's boundary values."""
    a, b = carried_rows(50 + group, 16), carried_rows(70 + group, 16)[::-1].copy()
    got = np.empty_like(a)
    host.h_mul_sqr(group, _p(a), _p(b), _p(got), len(a))
    np.testing.assert_array_equal(got[:, 0], fe._mul_plain(port(a[:, 0]), port(b[:, 0])).numpy())
    np.testing.assert_array_equal(got[:, 1], fe._mul_plain(port(a[:, 1]), port(a[:, 1])).numpy())


def tree_input(lanes):
    """Lane accumulators for the tree. Up to 16 lanes: seeded carried rows,
    the last two the identity and the order-4 point from 6 lanes on. Past
    16: consecutive multiples Q, Q + B, ... (extended coordinates, Z != 1)
    then their negations, each behind its own point, so the sum is the
    identity and the verdict 1 (0 at an odd count, whose middle lane is B
    alone)."""
    if lanes <= 16:
        acc = carried_rows(10 + lanes, max(lanes, 4))[:lanes].copy()
        if lanes >= 6:
            acc[-2:] = curve_points(lanes, 0)  # identity and order-4 lanes
        return acc
    pts = [ref_py._mul(ref_py._BASE, random.Random(lanes).getrandbits(252))]
    while len(pts) < lanes // 2:
        pts.append(ref_py._add(pts[-1], ref_py._BASE))
    neg = [((-x) % fe.P, y, z, (-t) % fe.P) for x, y, z, t in pts]
    mid = [ref_py._BASE] if lanes % 2 else []
    return np.stack([pt_limbs(q) for q in pts + mid + neg[::-1]]).astype(np.int64)


@functools.cache
def plain_tree(lanes):
    """The input, _reduce_plain's root and _final_plain's verdict."""
    acc = tree_input(lanes)
    root = msm._reduce_plain(port(acc))
    return acc, root.numpy(), int(msm._final_plain(root))


@pytest.mark.parametrize("lanes", [1, 5, 6, 8, 16])
def test_tree_matches_plain(host, lanes):
    """msm_reduce's tree and verdict at the kernel's kTreeGroup and
    kTreeSpan."""
    acc, want_root, want_verdict = plain_tree(lanes)
    root, verdict = host_reduce(host, acc)
    np.testing.assert_array_equal(root, want_root)
    assert verdict == want_verdict
    assert len(msm.reduce_levels(lanes)) == max(1, int(np.ceil(np.log2(max(lanes, 2)))))


TREE_SPAN = int(re.search(r"^constexpr int kTreeSpan = (\d+);$",
                          (CSRC / "ed_msm.cu").read_text(), re.M).group(1))
TREE_LANES = [1, 5, 6, 8, 16, TREE_SPAN - 1, TREE_SPAN, TREE_SPAN + 1, 2 * TREE_SPAN + 1, 1000]


@pytest.mark.parametrize("lanes", TREE_LANES)
@pytest.mark.parametrize("group", [1] + GROUPS)
def test_tree_at_every_group_matches_plain(host, group, lanes):
    """Root limbs and verdict at every group size the tree builds for, at
    lane counts below, at and across the block's span and its odd folds."""
    acc, want_root, want_verdict = plain_tree(lanes)
    root, verdict = host_reduce(host, acc, group)
    np.testing.assert_array_equal(root, want_root)
    assert verdict == want_verdict
    if lanes > 16:
        assert want_verdict == (lanes % 2 == 0)


@pytest.mark.parametrize("span", [2, 4, 8])
def test_tree_schedule_over_small_spans(host, span):
    """The wrapper's schedule of passes (cuda_msm.tree_passes) is the global
    tree at any power-of-two span: with spans far below the kernel's, 100
    and 77 lanes take three to seven launches."""
    for lanes in (100, 77):
        acc, want_root, want_verdict = plain_tree(lanes)
        passes = cuda_msm.tree_passes(lanes, span)
        assert passes[0] == lanes and passes[-1] <= span
        assert len(passes) == max(1, int(np.ceil(np.log(lanes) / np.log(span) - 1e-9)))
        root, verdict = host_reduce(host, acc, 1, span)
        np.testing.assert_array_equal(root, want_root)
        assert verdict == want_verdict
    root, verdict = host_reduce(host, plain_tree(16)[0], 4, span)
    np.testing.assert_array_equal(root, plain_tree(16)[1])


def test_tree_levels_match_reduce_levels(host):
    for lanes in range(1, 600):
        assert host.h_tree_levels(lanes) == len(msm.reduce_levels(lanes))
    assert cuda_msm.tree_passes(16_384, TREE_SPAN) == [16_384, 16_384 // TREE_SPAN]
    assert cuda_msm.tree_passes(TREE_SPAN, TREE_SPAN) == [TREE_SPAN]
    assert host.h_tree_span() == TREE_SPAN


@pytest.mark.parametrize("case", range(5))
def test_final_verdict_on_msm_cases(host, case):
    pts, nib, want = msm_cases()[case]
    pts = pts.astype(np.int64)
    assert host_msm(host, pts, nib) == int(want)
    root, _ = host_reduce(host, host_windows(host, pts, nib))
    assert int(msm._final_plain(port(root))) == int(want)


def pow_rows(n_random=24):
    rng = random.Random(0x22523)
    vals = [rng.getrandbits(256) for _ in range(n_random)] + EDGE_A + [2, 2**255 - 1]
    return vals, limbs(vals).astype(np.int64)


def test_pow22523_matches_plain(host):
    """The chain at the kernel's kPowGroup threads a lane."""
    vals, z = pow_rows()
    out = np.empty_like(z)
    host.h_pow22523(host.h_pow_group(), _p(z), _p(out), len(z))
    np.testing.assert_array_equal(out, fe._pow22523_plain(port(z)).numpy())
    for i, v in enumerate(vals):
        assert fe.limbs_to_int(out[i]) % fe.P == pow(v % fe.P, (fe.P - 5) // 8, fe.P)


@pytest.mark.parametrize("group", [1, 2] + GROUPS)
def test_pow22523_at_every_group_matches_plain(host, group):
    """The chain at every group size the kernel builds for (1: one thread,
    its squarings of 136 products), on the edge rows and a few random
    ones."""
    _, z = pow_rows(6)
    out = np.empty_like(z)
    host.h_pow22523(group, _p(z), _p(out), len(z))
    np.testing.assert_array_equal(out, fe._pow22523_plain(port(z)).numpy())


def test_square_of_136_products_matches_plain(host):
    """The one-thread squaring (fe_sqr: 16 squares and 120 cross products
    added twice) against field._mul_plain(a, a), with the one-thread product
    beside it, on random rows, all-0xFFFF rows and the field battery's edge
    values."""
    a = np.concatenate([carried_rows(90, 24), limbs(EDGE_A + EDGE_A[::-1]).astype(np.int64)
                        .reshape(-1, 4, 16)])
    b = carried_rows(91, len(a))
    got = np.empty_like(a)
    host.h_mul_sqr(1, _p(a), _p(b), _p(got), len(a))
    np.testing.assert_array_equal(got[:, 0], fe._mul_plain(port(a[:, 0]), port(b[:, 0])).numpy())
    np.testing.assert_array_equal(got[:, 1], fe._mul_plain(port(a[:, 1]), port(a[:, 1])).numpy())


# ── the plain window stage against the JAX package ─────────────────────


def test_windows_plain_matches_jax_composition():
    """Two windows over 8 lanes: the JAX package's curve.add and curve.dbl
    composed in _windows_plain's order (the table, then per window four
    doublings and the gathered add)."""
    pts, nib = window_inputs(4)
    nib = np.ascontiguousarray(nib[:, :2])
    add, dbl = jax.jit(ref_curve.add), jax.jit(ref_curve.dbl)
    jpts = jnp.asarray(pts.astype(np.uint32))
    ident = ref_curve.identity((len(pts),))
    table, acc = [ident], ident
    for _ in range(15):
        acc = add(acc, jpts)
        table.append(acc)
    table = jnp.stack(table)
    acc = ident
    for w in range(nib.shape[1]):
        acc = dbl(dbl(dbl(dbl(acc))))
        acc = add(acc, table[nib[:, w], jnp.arange(len(pts))])
    got = msm._windows_plain(port(pts), torch.from_numpy(nib))
    np.testing.assert_array_equal(np.asarray(acc).astype(np.int64), got.numpy())


# ── dispatch ───────────────────────────────────────────────────────────


def test_cpu_dispatch_runs_the_plain_versions_and_counts_nothing():
    pts, nib, want = msm_cases()[2]
    points, nibbles = convert.points_from_numpy(pts, device="cpu"), torch.from_numpy(nib)
    before = dict(_build.launches)
    verdict = msm.msm_is_identity(points, nibbles)
    assert verdict.dtype == torch.bool and bool(verdict) is want
    short = nibbles[:, :2]  # two windows keep the stage-by-stage check quick
    root = msm._reduce_plain(msm._windows_plain(points, short))
    assert bool(msm.msm_is_identity(points, short)) is bool(msm._final_plain(root))
    z = port(limbs(EDGE_A))
    assert torch.equal(fe.pow22523(z), fe._pow22523_plain(z))
    assert torch.equal(cuda_field.fe_pow22523(z), fe._pow22523_plain(z))
    assert dict(_build.launches) == before


def test_wrappers_raise_on_a_device_they_cannot_serve():
    """The MSM's kernel wrappers serve CUDA tensors only (msm.msm_is_identity
    runs the plain versions on the CPU), and nothing serves a tensor that is
    on neither the CPU nor a CUDA device: the wrappers raise, they do not
    fall back."""
    before = dict(_build.launches)
    for dev in ("meta", "cpu"):
        pts = torch.zeros((4, 4, 16), dtype=torch.int64, device=dev)
        nib = torch.zeros((4, 64), dtype=torch.int32, device=dev)
        with pytest.raises(ValueError):
            cuda_msm.msm_windows(pts, nib)
        with pytest.raises(ValueError):
            cuda_msm.msm_reduce(pts)
    with pytest.raises(ValueError):
        msm.msm_is_identity(pts.to("meta"), nib.to("meta"))
    with pytest.raises(ValueError):
        cuda_field.fe_pow22523(pts[0].to("meta"))
    assert dict(_build.launches) == before


# ── the build ──────────────────────────────────────────────────────────


def test_build_target_follows_the_shared_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ renames every library built from
    csrc/, so no stale build is loaded; _target only hashes, no nvcc."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    first = _build._target("k")
    assert _build._target("k") == first
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = _build._target("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _build._target("k") not in (first, second)
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert _build._target("k") not in (first, second)
    monkeypatch.undo()
    assert set(_build.sources()) >= {"ed_msm", "fe_mul", "fe_pow22523", "ingest_scan"}
    assert (CSRC / "fe25519.cuh").is_file()
