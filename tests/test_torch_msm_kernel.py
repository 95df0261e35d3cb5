"""The MSM and inverse-square-root kernels' arithmetic, on the CPU.

A host C++ compiler builds the lane routines of ``csrc/ed_msm.cu`` and
``csrc/fe_pow22523.cu`` (everything outside their ``__CUDACC__`` launch
blocks, over the shared ``csrc/fe25519.cuh`` and ``csrc/fe25519_group.cuh``)
into a small library that ctypes loads, and each is held limb for limb
against its plain PyTorch version: ``curve.add``, ``curve.dbl``,
``curve.is_identity``, ``field._mul_plain``, ``msm._windows_plain``,
``msm._reduce_plain``, ``msm._final_plain`` and ``field._pow22523_plain``.
The group routines that the window kernel runs with G threads a lane are
built for G = 4, 8 and 16; the harness runs a group's threads as fibers
(POSIX ``ucontext``) on one host thread, stepping them in turn at every ``grp_get`` exchange, so
the exact arithmetic of the card's code runs here. The plain window stage is held against the JAX
package's own ``curve.add`` and ``curve.dbl`` composed in the same order;
the CPU dispatch of the MSM and the chain is checked to run the plain
versions and launch nothing; and a kernel's build target is checked to
follow the shared header. Inputs are made from seeds; tolerance: exact
equality (integer arithmetic).
"""

import ctypes
import random
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
static int g_windows;

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

typedef void (*Body)(int);
static Body pick(int G, Body b4, Body b8, Body b16) {
  return G == 4 ? b4 : G == 8 ? b8 : b16;
}
#define BODIES(name) pick(G, name<4>, name<8>, name<16>)

extern "C" {
// G == 1 runs the one-thread routines of fe25519.cuh (the tree's and the
// final test's); 4, 8 and 16 the group routines.
void h_ed_add(int G, const int64_t* p, const int64_t* q, int64_t* out, int n) {
  for (int k = 0; k < n; ++k) {
    if (G == 1) {
      uint32_t a[4][kLimbs], b[4][kLimbs];
      pt_load(p + k * kPointLimbs, a);
      pt_load(q + k * kPointLimbs, b);
      ed_add(a, b, a);
      pt_store(a, out + k * kPointLimbs);
      continue;
    }
    g_p = p + k * kPointLimbs; g_q = q + k * kPointLimbs; g_out = out + k * kPointLimbs;
    run_group(G, BODIES(body_add));
  }
}
void h_ed_dbl(int G, const int64_t* p, int64_t* out, int n) {
  for (int k = 0; k < n; ++k) {
    if (G == 1) {
      uint32_t a[4][kLimbs];
      pt_load(p + k * kPointLimbs, a);
      ed_dbl(a, a);
      pt_store(a, out + k * kPointLimbs);
      continue;
    }
    g_p = p + k * kPointLimbs; g_out = out + k * kPointLimbs;
    run_group(G, BODIES(body_dbl));
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
    if (G == 1) {
      for (int c = 0; c < 4; ++c) {
        uint32_t t[kLimbs];
        for (int i = 0; i < kLimbs; ++i) t[i] = static_cast<uint32_t>(p[k * kPointLimbs + c * kLimbs + i]);
        fe_carry(t);
        for (int i = 0; i < kLimbs; ++i) out[k * kPointLimbs + c * kLimbs + i] = t[i];
      }
      continue;
    }
    g_p = p + k * kPointLimbs; g_out = out + k * kPointLimbs;
    run_group(G, BODIES(body_carry));
  }
}
void h_is_identity(const int64_t* p, int32_t* out, int n) {
  for (int k = 0; k < n; ++k) {
    uint32_t a[4][kLimbs];
    pt_load(p + k * kPointLimbs, a);
    out[k] = ed_is_identity(a) ? 1 : 0;
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
void h_reduce_level(const int64_t* q, int n_in, int64_t* out) {
  for (int i = 0; i < (n_in + 1) / 2; ++i) msm_pair(q, n_in, i, out);
}
int h_final(const int64_t* root) { return msm_final_verdict(root); }
int h_group() { return kGroup; }
void h_pow22523(const int64_t* z, int64_t* out, int n) {
  for (int k = 0; k < n; ++k) pow22523_lane(z + k * kLimbs, out + k * kLimbs);
}
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
        ("h_mul_sqr", [i32, ptr, ptr, ptr, i32], None),
        ("h_carry", [i32, ptr, ptr, i32], None),
        ("h_is_identity", [ptr, ptr, i32], None),
        ("h_windows", [i32, ptr, ptr, i32, i32, ptr, ptr], None),
        ("h_group", [], i32),
        ("h_reduce_level", [ptr, i32, ptr], None),
        ("h_final", [ptr], i32),
        ("h_pow22523", [ptr, ptr, i32], None),
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


def host_reduce(host, acc):
    """The wrapper's schedule: one level per entry of msm.reduce_levels,
    each into a fresh buffer."""
    q = acc
    for n_in in msm.reduce_levels(len(acc)):
        out = np.empty(((n_in + 1) // 2, 4, 16), np.int64)
        host.h_reduce_level(_p(np.ascontiguousarray(q[:n_in])), n_in, _p(out))
        q = out
    return q[0]


def host_msm(host, points, nibbles) -> int:
    root = host_reduce(host, host_windows(host, points, nibbles))
    return host.h_final(_p(np.ascontiguousarray(root)))


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
    """ed_add and ed_dbl of one thread (group 1: the tree's and the final
    test's) and of G threads a lane (the window loop's)."""
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
    host.h_is_identity(_p(pts), _p(ident), len(pts))
    np.testing.assert_array_equal(ident.astype(bool), curve.is_identity(port(pts)).numpy())
    if kind == "curve points":
        assert ident.tolist() == [0] * 6 + [1, 0]


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


@pytest.mark.parametrize("lanes", [1, 5, 6, 8, 16])
def test_tree_matches_plain(host, lanes):
    acc = carried_rows(10 + lanes, max(lanes, 4))[:lanes].copy()
    if lanes >= 6:
        acc[-2:] = curve_points(lanes, 0)  # identity and order-4 lanes
    got = host_reduce(host, acc)
    np.testing.assert_array_equal(got, msm._reduce_plain(port(acc)).numpy())
    assert len(msm.reduce_levels(lanes)) == max(1, int(np.ceil(np.log2(max(lanes, 2)))))


@pytest.mark.parametrize("case", range(5))
def test_final_verdict_on_msm_cases(host, case):
    pts, nib, want = msm_cases()[case]
    pts = pts.astype(np.int64)
    assert host_msm(host, pts, nib) == int(want)
    root = host_reduce(host, host_windows(host, pts, nib))
    assert int(msm._final_plain(port(root))) == int(want)


def test_pow22523_matches_plain(host):
    rng = random.Random(0x22523)
    vals = [rng.getrandbits(256) for _ in range(24)] + EDGE_A + [2, 2**255 - 1]
    z = limbs(vals).astype(np.int64)
    out = np.empty_like(z)
    host.h_pow22523(_p(z), _p(out), len(z))
    np.testing.assert_array_equal(out, fe._pow22523_plain(port(z)).numpy())
    for i, v in enumerate(vals):
        assert fe.limbs_to_int(out[i]) % fe.P == pow(v % fe.P, (fe.P - 5) // 8, fe.P)


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
            cuda_msm.msm_reduce(pts, msm.reduce_levels(4))
        with pytest.raises(ValueError):
            cuda_msm.msm_final(pts[0])
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
