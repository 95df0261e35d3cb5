"""Parity: the port's device verifier core (hashgraph_tpu_torch.crypto_device
field, sha512, curve, msm) against the JAX package's, on the CPU.

Inputs are made from seeds (numpy and ``random``) and handed to both;
tolerance: exact equality, limb for limb (integer arithmetic). The JAX
functions called here are pure (no metrics, no global state); the Pallas
field multiply stays off, so the JAX side is its ``_mul_jnp`` definition.
The CUDA kernel's arithmetic is checked too: a host C++ compiler builds the
``__device__`` part of ``csrc/fe_mul.cu`` and it is held against the plain
version.
"""

import hashlib
import random
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgraph_tpu.crypto_device import curve as ref_curve
from hashgraph_tpu.crypto_device import field as ref_fe
from hashgraph_tpu.crypto_device import msm as ref_msm
from hashgraph_tpu.crypto_device import sha512 as ref_sha
from hashgraph_tpu.signing import _ed25519 as ref_py
from hashgraph_tpu_torch import _build, convert
from hashgraph_tpu_torch.crypto_device import cuda_field, curve, msm
from hashgraph_tpu_torch.crypto_device import field as fe
from hashgraph_tpu_torch.crypto_device import sha512 as sh

P = fe.P
L = ref_py.L
CSRC = Path(__file__).resolve().parent.parent / "hashgraph_tpu_torch" / "csrc"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def limbs(vals) -> np.ndarray:
    return np.array(
        [[(v >> (16 * j)) & 0xFFFF for j in range(16)] for v in vals], np.uint32
    )


def port(arr) -> torch.Tensor:
    return convert.field_from_numpy(arr, device="cpu")


def same(jax_out, port_out):
    """Exact equality of a JAX result and a port result."""
    np.testing.assert_array_equal(
        np.asarray(jax_out).astype(np.int64), port_out.numpy().astype(np.int64)
    )


# Boundaries and adversarial carry ripples, as the JAX package's own
# battery uses them: 0, 1, 19, p-1, p, p+1, 2p, 2^256-1, 2^256-2^240 and
# (2^256-2^240)|0xFFFF against 2^256-1.
EDGE_A = [0, 1, 19, P - 1, P, P + 1, 2 * P, 2**256 - 1, 2**256 - 2**240,
          (2**256 - 2**240) | 0xFFFF]
EDGE_B = [2**256 - 1, 2**256 - 1, 2**256 - 1, 1, 0, P, 1, 2**256 - 1, 1,
          2**256 - 1]


def operands(seed, n=40):
    rng = random.Random(seed)
    vals_a = [rng.getrandbits(256) for _ in range(n)] + EDGE_A
    vals_b = [rng.getrandbits(256) for _ in range(n)] + EDGE_B
    return vals_a, vals_b


# ── field ──────────────────────────────────────────────────────────────


@pytest.mark.parametrize("seed", range(3))
def test_mul_plain_matches_mul_jnp(seed):
    vals_a, vals_b = operands(seed)
    a, b = limbs(vals_a), limbs(vals_b)
    got = fe._mul_plain(port(a), port(b))
    same(ref_fe._mul_jnp(jnp.asarray(a), jnp.asarray(b)), got)
    assert bool((got < 1 << 16).all()) and bool((got >= 0).all())
    for i, (x, y) in enumerate(zip(vals_a, vals_b)):
        assert fe.limbs_to_int(got[i]) % P == (x * y) % P


def test_mul_dispatch_on_cpu_runs_the_plain_version_and_counts_nothing():
    vals_a, vals_b = operands(7, 8)
    a, b = port(limbs(vals_a)), port(limbs(vals_b))
    before = dict(_build.launches)
    assert torch.equal(fe.mul(a, b), fe._mul_plain(a, b))
    assert torch.equal(cuda_field.fe_mul(a, b), fe._mul_plain(a, b))
    # broadcasting against a constant, as curve.add multiplies by 2d
    d2 = fe.const(fe.D2, a.shape[:-1])
    same(ref_fe.mul(jnp.asarray(limbs(vals_a)), jnp.asarray(ref_fe.D2)), fe.mul(a, d2))
    assert dict(_build.launches) == before


@pytest.mark.parametrize("op", ["add", "sub"])
@pytest.mark.parametrize("seed", range(2))
def test_add_sub_match(op, seed):
    vals_a, vals_b = operands(100 + seed)
    a, b = limbs(vals_a), limbs(vals_b)
    got = getattr(fe, op)(port(a), port(b))
    same(getattr(ref_fe, op)(jnp.asarray(a), jnp.asarray(b)), got)
    assert bool((got < 1 << 16).all())
    sign = 1 if op == "add" else -1
    for i, (x, y) in enumerate(zip(vals_a, vals_b)):
        assert fe.limbs_to_int(got[i]) % P == (x + sign * y) % P


def ripple_columns(seed) -> np.ndarray:
    """Column sums < 2^27 (what a product leaves) plus crafted ripples:
    runs of 0xFFFF limbs that a carry must cross end to end."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 1 << 27, (64, 16)).astype(np.int64)
    cols[:8] = rng.integers(0, 1 << 17, (8, 16))
    cols[8:24] = 0xFFFF
    for r in range(8, 24):
        cols[r, r - 8] = 0x10000 + r  # generate a carry at limb r-8
    cols[24, :] = 0xFFFF
    cols[24, 15] = 0x1FFFF  # carry out of limb 15 folds into limb 0
    cols[25] = (1 << 27) - 1
    return cols


def carry_seq_ripple(t: np.ndarray) -> np.ndarray:
    """The sequential pass written as the 16-step ripple (the oracle for
    the port's carry-lookahead form)."""
    out = t.copy()
    c = np.zeros(t.shape[:-1], np.int64)
    for i in range(16):
        cur = out[..., i] + c
        out[..., i] = cur & 0xFFFF
        c = cur >> 16
    out[..., 0] += c * 38
    return out


@pytest.mark.parametrize("seed", range(2))
def test_carry_matches(seed):
    cols = ripple_columns(seed)
    got = fe.carry(torch.from_numpy(cols))
    same(ref_fe.carry(jnp.asarray(cols.astype(np.uint32))), got)
    assert bool((got < 1 << 16).all())
    # Each sequential pass on its own, on inputs inside its domain (limbs
    # <= 2^17 - 2): after two carry-save passes, and crafted directly.
    vec2 = fe._carry_vec(fe._carry_vec(torch.from_numpy(cols)))
    assert int(vec2.max()) < (1 << 16) + 40
    crafted = np.full((4, 16), 0xFFFF, np.int64)
    crafted[0, 0] = 0x10000
    crafted[1, 3] = (1 << 17) - 2
    crafted[2, :] = 0
    crafted[3, 7] = 0x1FFFE
    for t in (vec2.numpy(), crafted):
        np.testing.assert_array_equal(fe._carry_seq(torch.from_numpy(t)).numpy(),
                                      carry_seq_ripple(t))


def test_canon_bytes_parity_zero():
    vals = [0, 1, P - 1, P, P + 1, 2 * P, 2 * P + 5, 2**255 - 1, 2**256 - 1,
            2**256 - 2**240, 19, 38]
    a = limbs(vals)
    ja, ta = jnp.asarray(a), port(a)
    same(ref_fe.canon(ja), fe.canon(ta))
    same(ref_fe.to_bytes(ja), fe.to_bytes(ta))
    same(ref_fe.parity(ja), fe.parity(ta))
    same(ref_fe.is_zero(ja), fe.is_zero(ta))
    same(ref_fe.eq(ja, ja[::-1]), fe.eq(ta, ta.flip(0)))
    for i, v in enumerate(vals):
        assert int.from_bytes(fe.to_bytes(ta)[i].numpy().tobytes(), "little") == v % P


def test_is_canonical_fe_matches():
    rng = random.Random(3)
    vals = [P - 1, P, P + 1, 2**255 - 1, 2**255 - 19, 2**255 - 20, 0, 1]
    vals += [rng.getrandbits(255) for _ in range(8)]
    enc = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8) for v in vals])
    got = fe.is_canonical_fe(torch.from_numpy(enc))
    same(ref_fe.is_canonical_fe(jnp.asarray(enc)), got)
    assert got.tolist() == [v < P for v in vals]
    same(ref_fe.from_bytes(jnp.asarray(enc)), fe.from_bytes(torch.from_numpy(enc)))


@pytest.mark.parametrize("fn", ["pow22523", "invert"])
def test_exponentiation_chains_match(fn):
    rng = random.Random(0xCA1)
    vals = [rng.getrandbits(256) for _ in range(8)] + [0, 1, 2, P - 1, P, 2**256 - 1]
    a = limbs(vals)
    got = getattr(fe, fn)(port(a))
    same(jax.jit(getattr(ref_fe, fn))(jnp.asarray(a)), got)
    exp = (P - 5) // 8 if fn == "pow22523" else P - 2
    for i, v in enumerate(vals):
        assert fe.limbs_to_int(got[i]) % P == pow(v % P, exp, P)


def test_convert_round_trip():
    rng = np.random.default_rng(5)
    f = rng.integers(0, 1 << 16, (3, 5, 16)).astype(np.uint32)
    t = convert.field_from_numpy(f, device="cpu")
    assert t.dtype == torch.int64 and t.shape == (3, 5, 16)
    np.testing.assert_array_equal(convert.field_to_numpy(t), f)
    pts = f[:, :4]
    np.testing.assert_array_equal(
        convert.points_to_numpy(convert.points_from_numpy(pts, device="cpu")), pts)
    with pytest.raises(ValueError):
        convert.points_from_numpy(f, device="cpu")
    with pytest.raises(ValueError):
        convert.field_from_numpy(f[..., :8], device="cpu")


HOST_MAIN = r"""
#define __device__
#define __forceinline__ inline
#include "fe_mul.cu"
#include <cstdio>
int main() {
  uint32_t a[16], b[16], o[16];
  for (;;) {
    for (int i = 0; i < 16; ++i) if (scanf("%u", &a[i]) != 1) return 0;
    for (int i = 0; i < 16; ++i) if (scanf("%u", &b[i]) != 1) return 1;
    fe_mul(a, b, o);
    for (int i = 0; i < 16; ++i) printf("%u ", o[i]);
    printf("\n");
  }
}
"""


def test_kernel_arithmetic_compiled_for_the_host_matches_plain(tmp_path):
    """The kernel's __device__ arithmetic (csrc/fe_mul.cu, everything
    outside its __CUDACC__ launch block) built by a host C++ compiler,
    against the plain version on boundary, ripple and random rows."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel's arithmetic")
    (tmp_path / "main.cpp").write_text(HOST_MAIN)
    exe = tmp_path / "fe_mul_host"
    subprocess.run([cxx, "-O1", "-std=c++17", "-I", str(CSRC), "-o", str(exe),
                    str(tmp_path / "main.cpp")], check=True, timeout=120)
    vals_a, vals_b = operands(11, 200)
    a, b = limbs(vals_a).astype(np.int64), limbs(vals_b).astype(np.int64)
    stdin = "\n".join(" ".join(map(str, [*x, *y])) for x, y in zip(a, b))
    proc = subprocess.run([str(exe)], input=stdin, capture_output=True, text=True,
                          timeout=60, check=True)
    got = np.array([[int(v) for v in line.split()] for line in proc.stdout.splitlines()])
    np.testing.assert_array_equal(got, fe._mul_plain(torch.from_numpy(a),
                                                     torch.from_numpy(b)).numpy())


# ── sha512 ─────────────────────────────────────────────────────────────

RAGGED = [0, 3, 111, 112, 127, 128, 129, 239, 240, 255, 256, 300]


@pytest.mark.parametrize("max_blocks", [3, 4])
def test_sha512_matches_jax_and_hashlib(max_blocks):
    rng = np.random.default_rng(max_blocks)
    msgs = [rng.integers(0, 256, n).astype(np.uint8).tobytes() for n in RAGGED]
    msgs = [m for m in msgs if sh.blocks_needed(len(m)) <= max_blocks]
    words = sh.sha512_batch_dispatch(msgs, max_blocks)
    same(ref_sha.sha512_batch_dispatch(msgs, max_blocks), words)
    for m, d in zip(msgs, sh.digest_bytes(words)):
        assert d.tobytes() == hashlib.sha512(m).digest(), len(m)
    assert [sh.blocks_needed(len(m)) for m in msgs] == [
        ref_sha.blocks_needed(len(m)) for m in msgs]
    with pytest.raises(ValueError):
        sh.sha512_batch_dispatch([b"x" * 300], 2)


def test_sha512_constants_match():
    assert sh._K64 == ref_sha._K64 and sh._H64 == ref_sha._H64
    assert sh._K64[0] == 0x428A2F98D728AE22 and sh._H64[7] == 0x5BE0CD19137E2179


# ── curve ──────────────────────────────────────────────────────────────


def encodings(seed):
    """Encodings of random points plus every RFC 8032 5.1.3 class: the
    identity, y=0, y >= p, y = p, p-1 (no root), x=0 with the sign bit,
    small y without a root, and a valid point with its sign bit flipped."""
    rng = random.Random(seed)
    encs = [ref_py._encode(ref_py._mul(ref_py._BASE, rng.getrandbits(252)))
            for _ in range(6)]
    flipped = bytearray(encs[0])
    flipped[31] ^= 0x80
    encs += [
        b"\x01" + b"\x00" * 31,
        bytes(32),
        b"\xff" * 32,
        P.to_bytes(32, "little"),
        (P - 1).to_bytes(32, "little"),
        b"\x02" + b"\x00" * 31,
        bytes(31) + b"\x80",
        b"\x03" + b"\x00" * 30 + b"\x80",
        b"\x01" + b"\x00" * 30 + b"\x80",
        bytes(flipped),
    ]
    return encs


def test_decompress_matches_jax_and_the_twin():
    encs = encodings(9)
    arr = np.frombuffer(b"".join(encs), np.uint8).reshape(-1, 32)
    ref_pts, ref_ok = jax.jit(ref_curve.decompress)(jnp.asarray(arr))
    pts, ok = curve.decompress(torch.from_numpy(arr.copy()))
    same(ref_ok, ok)
    same(ref_pts, pts)
    assert ok.tolist() == [ref_py._decode(e) is not None for e in encs]
    assert not all(ok.tolist()) and any(ok.tolist())
    ident = torch.from_numpy(curve.IDENTITY)
    for i, e in enumerate(encs):
        if not ok[i]:
            assert torch.equal(pts[i], ident)


def pt_limbs(pt) -> np.ndarray:
    return limbs(list(pt))


def test_add_dbl_match_jax():
    rng = random.Random(11)
    host = [ref_py._mul(ref_py._BASE, rng.getrandbits(250)) for _ in range(5)]
    host += [ref_py._IDENTITY]
    arr = np.stack([pt_limbs(p) for p in host])
    rev = arr[::-1].copy()
    same(ref_curve.dbl(jnp.asarray(arr)), curve.dbl(port(arr)))
    same(ref_curve.add(jnp.asarray(arr), jnp.asarray(rev)), curve.add(port(arr), port(rev)))
    same(ref_curve.is_identity(jnp.asarray(arr)), curve.is_identity(port(arr)))
    assert curve.is_identity(port(arr)).tolist() == [False] * 5 + [True]
    same(ref_curve.base_point((2,)), curve.base_point((2,)))
    same(ref_curve.identity((2,)), curve.identity((2,)))


# ── msm ────────────────────────────────────────────────────────────────

LANES = 16  # the lane bucket the JAX package's own battery compiles


def msm_cases():
    """(points, nibbles) pairs at 16 lanes: s*P + (L-s)*P cancels; a
    random combination with B; the same with one nibble flipped; and a
    cancelling pair whose scalars differ by a multiple of the point's
    small-order component."""
    rng = random.Random(13)
    cases = []
    pt = ref_py._mul(ref_py._BASE, rng.getrandbits(250))
    pts = np.broadcast_to(ref_curve.IDENTITY, (LANES, 4, 16)).copy()
    pts[0] = pts[1] = pt_limbs(pt)
    s = rng.getrandbits(251) % L
    nib = np.zeros((LANES, 64), np.int32)
    nib[:2] = ref_msm.scalars_to_nibbles([s, L - s])
    cases.append((pts.copy(), nib.copy(), True))
    bad = nib.copy()
    bad[0, 63] ^= 1
    cases.append((pts.copy(), bad, False))
    # sum k_i * (x_i B) + (-sum k_i x_i) B == O over five lanes plus B
    xs = [rng.getrandbits(250) for _ in range(5)]
    ks = [rng.getrandbits(252) % L for _ in range(5)]
    pts = np.broadcast_to(ref_curve.IDENTITY, (LANES, 4, 16)).copy()
    for i, x in enumerate(xs):
        pts[i] = pt_limbs(ref_py._mul(ref_py._BASE, x))
    pts[5] = ref_curve.BASE_AFFINE
    scal = ks + [(-sum(k * x for k, x in zip(ks, xs))) % L]
    nib = np.zeros((LANES, 64), np.int32)
    nib[:6] = ref_msm.scalars_to_nibbles(scal)
    cases.append((pts.copy(), nib.copy(), True))
    scal[5] = (scal[5] + 1) % L
    nib[:6] = ref_msm.scalars_to_nibbles(scal)
    cases.append((pts, nib, False))
    # a small-order point (y = 0 has order 4) with any scalar vanishes
    # under the cofactor 8
    low = ref_py._decode(bytes(32))
    pts = np.broadcast_to(ref_curve.IDENTITY, (LANES, 4, 16)).copy()
    pts[3] = pt_limbs(low)
    nib = np.zeros((LANES, 64), np.int32)
    nib[3] = ref_msm.scalars_to_nibbles([rng.getrandbits(252) % L])[0]
    cases.append((pts, nib, True))
    return cases


@pytest.fixture(scope="module")
def msm_reference():
    return [bool(ref_msm._msm_is_identity(jnp.asarray(p), jnp.asarray(n)))
            for p, n, _ in msm_cases()]


@pytest.mark.parametrize("case", range(5))
def test_msm_verdict_matches_jax(msm_reference, case):
    pts, nib, want = msm_cases()[case]
    got = msm.msm_accepts(port(pts), torch.from_numpy(nib))
    assert got == msm_reference[case] == want


def test_scalars_to_nibbles_matches():
    rng = random.Random(21)
    scal = [rng.getrandbits(253) % L for _ in range(9)] + [0, L - 1]
    np.testing.assert_array_equal(msm.scalars_to_nibbles(scal),
                                  ref_msm.scalars_to_nibbles(scal))


@pytest.mark.parametrize("lanes", [1, 5, 6])
def test_msm_tree_reduction_pads_odd_lane_counts_with_the_identity(lanes):
    """Lane counts that are not powers of two fold as the JAX package's
    fixed-shape tree does (its partner-less lanes read the identity)."""
    rng = random.Random(lanes)
    xs = [rng.getrandbits(250) for _ in range(lanes)]
    pts = np.stack([pt_limbs(ref_py._mul(ref_py._BASE, x)) for x in xs])
    ks = [rng.getrandbits(252) % L for _ in range(lanes)]
    total = sum(k * x for k, x in zip(ks, xs)) % L
    nib = ref_msm.scalars_to_nibbles(ks)
    assert msm.msm_accepts(port(pts), torch.from_numpy(nib)) is (total == 0)
    ks[-1] = (ks[-1] - total * pow(xs[-1], -1, L)) % L  # now sum k_i x_i == 0
    nib = ref_msm.scalars_to_nibbles(ks)
    assert msm.msm_accepts(port(pts), torch.from_numpy(nib)) is True
