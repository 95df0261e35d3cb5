// GF(2^255-19) arithmetic and edwards25519 point formulas in radix-2^16
// limbs, as __device__ functions shared by every crypto kernel of the port.
//
// Every function here computes what its plain PyTorch counterpart in
// hashgraph_tpu_torch/crypto_device/ computes, limb for limb and not only
// mod p: the same formulas, the same operation order and the same carry
// chain (two carry-save passes, then two exact sequential passes).
// canon, parity and the sign flip of decompression see limbs, so a value
// that is only congruent would change a verdict.
//
//   fe_mul, fe_sqr   field._mul_plain (the product; sqr is mul(a, a),
//                    from 136 limb products: the same column integers)
//   fe_add           field.add: carry(a + b)
//   fe_sub           field.sub: carry(a + (PAD4P - b))
//   fe_canon         field.canon, fe_is_zero field.is_zero
//   ed_add           curve.add (unified add-2008-hwcd-3, a = -1)
//   ed_dbl           curve.dbl (dbl-2008-hwcd, a = -1)
//   ed_is_identity   curve.is_identity
//
// Bounds. Inputs are carried (every limb < 2^16). A 16x16-bit limb product
// is exact in 32 bits; its low half lands in column i+j and its high half
// in column i+j+1, so a column sums at most 32 halves (< 2^21), and the
// 2^256 === 38 (mod p) fold of columns 16-31 keeps every limb below 2^27.
// An add leaves limbs below 2^17 and a sub below 2^18 + 2^16 (the 4p pad's
// limbs reach 2^18 - 4). The carry brings all of these back below 2^16,
// limb 0 included, so every intermediate is exact in uint32 and the
// arithmetic runs on the 32-bit integer units.
//
// A host C++ compiler builds this file too: __device__ and __forceinline__
// are defined away when nvcc is not the compiler, which is how the CPU
// tests hold it against the plain versions (tests/test_torch_msm_kernel.py).

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifndef __CUDACC__
#ifndef __device__
#define __device__
#endif
#ifndef __forceinline__
#define __forceinline__ inline
#endif
#endif

// The one-thread point formulas (what fe25519_group.cuh runs for a group of
// one) are real calls on the card: one copy of each keeps a kernel's code
// small, and inlining them into a loop crashes the CUDA 12.8 front end
// (cicc, exit 139). Their operands pass through the caller's
// stack frame (at most 512 bytes, L1-resident), against some 15,000 integer
// operations a call.
#ifdef __CUDACC__
#define ED_NOINLINE __noinline__
#else
#define ED_NOINLINE inline
#endif

constexpr int kLimbs = 16;
constexpr uint32_t kMask = 0xFFFFu;
constexpr uint32_t kFold = 38u;  // 2^256 mod p

// ── carry ───────────────────────────────────────────────────────────────

// Carry-save pass: every limb sheds its high bits to its neighbour at once.
__device__ __forceinline__ void carry_vec(uint32_t t[kLimbs]) {
  uint32_t c[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    c[i] = t[i] >> 16;
    t[i] &= kMask;
  }
#pragma unroll
  for (int i = 1; i < kLimbs; ++i) t[i] += c[i - 1];
  t[0] += c[kLimbs - 1] * kFold;
}

// Exact sequential pass; limb 0 absorbs 38 * carry_out unmasked.
__device__ __forceinline__ void carry_seq(uint32_t t[kLimbs]) {
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint32_t cur = t[i] + c;
    t[i] = cur & kMask;
    c = cur >> 16;
  }
  t[0] += c * kFold;
}

// field.carry: limbs < 2^27 in, carried limbs out.
__device__ __forceinline__ void fe_carry(uint32_t t[kLimbs]) {
  carry_vec(t);
  carry_vec(t);
  carry_seq(t);
  carry_seq(t);
}

// ── field ───────────────────────────────────────────────────────────────

// The carried product of two carried field elements. out may alias a or b.
__device__ __forceinline__ void fe_mul(const uint32_t a[kLimbs],
                                       const uint32_t b[kLimbs],
                                       uint32_t out[kLimbs]) {
  uint32_t col[2 * kLimbs];
#pragma unroll
  for (int k = 0; k < 2 * kLimbs; ++k) col[k] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
      const uint32_t p = a[i] * b[j];
      col[i + j] += p & kMask;
      col[i + j + 1] += p >> 16;
    }
  }
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) out[k] = col[k] + col[k + kLimbs] * kFold;
  fe_carry(out);
}

// fe_mul(a, a) from 136 limb products: the 16 squares, each alone in its
// two columns, and the 120 cross products a_i * a_j (i < j), whose halves
// are summed in columns of their own and added twice. Each column is the
// integer fe_mul sums, so the limbs are the same. out may alias a.
__device__ __forceinline__ void fe_sqr(const uint32_t a[kLimbs],
                                       uint32_t out[kLimbs]) {
  uint32_t col[2 * kLimbs], cross[2 * kLimbs];
#pragma unroll
  for (int k = 0; k < 2 * kLimbs; ++k) cross[k] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint32_t p = a[i] * a[i];
    col[2 * i] = p & kMask;
    col[2 * i + 1] = p >> 16;
#pragma unroll
    for (int j = i + 1; j < kLimbs; ++j) {
      const uint32_t q = a[i] * a[j];
      cross[i + j] += q & kMask;
      cross[i + j + 1] += q >> 16;
    }
  }
#pragma unroll
  for (int k = 0; k < 2 * kLimbs; ++k) col[k] += 2 * cross[k];
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) out[k] = col[k] + col[k + kLimbs] * kFold;
  fe_carry(out);
}

__device__ __forceinline__ void fe_add(const uint32_t a[kLimbs],
                                       const uint32_t b[kLimbs],
                                       uint32_t out[kLimbs]) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) out[i] = a[i] + b[i];
  fe_carry(out);
}

// Limb i of 4p spread so every limb is >= 2^16 (field.PAD4P).
__device__ __forceinline__ uint32_t pad4p(int i) {
  return i == 0 ? 0x3FFB4u : (i == kLimbs - 1 ? 0x1FFFCu : 0x3FFFCu);
}

// a - b mod p, as a + (4p - b) limb by limb: no limb goes negative.
__device__ __forceinline__ void fe_sub(const uint32_t a[kLimbs],
                                       const uint32_t b[kLimbs],
                                       uint32_t out[kLimbs]) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) out[i] = a[i] + (pad4p(i) - b[i]);
  fe_carry(out);
}

__device__ __forceinline__ void fe_copy(const uint32_t a[kLimbs],
                                        uint32_t out[kLimbs]) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) out[i] = a[i];
}

__device__ __forceinline__ void fe_set_small(uint32_t out[kLimbs], uint32_t v) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) out[i] = i == 0 ? v : 0u;
}

// Limb i of p.
__device__ __forceinline__ uint32_t p_limb(int i) {
  return i == 0 ? 0xFFEDu : (i == kLimbs - 1 ? 0x7FFFu : 0xFFFFu);
}

// field._cond_sub_p: x - p where x >= p, else x, by a borrow chain. Signed
// arithmetic, as the plain version's int64: a borrow is 0 or 1.
__device__ __forceinline__ void fe_cond_sub_p(uint32_t x[kLimbs]) {
  uint32_t diff[kLimbs];
  int32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const int32_t d = static_cast<int32_t>(x[i]) +
                      static_cast<int32_t>(0x10000u - p_limb(i)) - borrow;
    diff[i] = static_cast<uint32_t>(d) & kMask;
    borrow = 1 - (d >> 16);
  }
  if (borrow != 1) fe_copy(diff, x);
}

// Canonical representative in [0, p): a carried value is < 2p + 38.
__device__ __forceinline__ void fe_canon(uint32_t x[kLimbs]) {
  fe_cond_sub_p(x);
  fe_cond_sub_p(x);
}

__device__ __forceinline__ bool fe_is_zero(const uint32_t a[kLimbs]) {
  uint32_t x[kLimbs];
  fe_copy(a, x);
  fe_canon(x);
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) any |= x[i];
  return any == 0;
}

// ── points: extended coordinates (X, Y, Z, T), x = X/Z, y = Y/Z ─────────

// Limb i of 2d (field.D2).
__device__ __forceinline__ uint32_t d2_limb(int i) {
  const uint32_t k[kLimbs] = {
      0xF159u, 0x26B2u, 0x9B94u, 0xEBD6u, 0xB156u, 0x8283u, 0x149Au, 0x00E0u,
      0xD130u, 0xEEF3u, 0x80F2u, 0x198Eu, 0xFCE7u, 0x56DFu, 0xD9DCu, 0x2406u};
  return k[i];
}

__device__ __forceinline__ void ed_identity(uint32_t p[4][kLimbs]) {
  fe_set_small(p[0], 0);
  fe_set_small(p[1], 1);
  fe_set_small(p[2], 1);
  fe_set_small(p[3], 0);
}

// curve.add: out = p + q, the same intermediates in the same order
// (c = (t1 * 2d) * t2). out may alias p or q.
__device__ ED_NOINLINE void ed_add(const uint32_t p[4][kLimbs],
                                   const uint32_t q[4][kLimbs],
                                   uint32_t out[4][kLimbs]) {
  uint32_t a[kLimbs], b[kLimbs], c[kLimbs], d[kLimbs], s[kLimbs], t[kLimbs];
  fe_sub(p[1], p[0], s);
  fe_sub(q[1], q[0], t);
  fe_mul(s, t, a);
  fe_add(p[1], p[0], s);
  fe_add(q[1], q[0], t);
  fe_mul(s, t, b);
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) s[i] = d2_limb(i);
  fe_mul(p[3], s, t);
  fe_mul(t, q[3], c);
  fe_mul(p[2], q[2], s);
  fe_add(s, s, d);
  uint32_t e[kLimbs], f[kLimbs], g[kLimbs], h[kLimbs];
  fe_sub(b, a, e);
  fe_sub(d, c, f);
  fe_add(d, c, g);
  fe_add(b, a, h);
  fe_mul(e, f, out[0]);
  fe_mul(g, h, out[1]);
  fe_mul(f, g, out[2]);
  fe_mul(e, h, out[3]);
}

// curve.dbl: out = 2p, with h = (0 - a) - b. out may alias p.
__device__ ED_NOINLINE void ed_dbl(const uint32_t p[4][kLimbs],
                                   uint32_t out[4][kLimbs]) {
  uint32_t a[kLimbs], b[kLimbs], c[kLimbs], s[kLimbs];
  fe_sqr(p[0], a);
  fe_sqr(p[1], b);
  fe_sqr(p[2], s);
  fe_add(s, s, c);
  uint32_t e[kLimbs], f[kLimbs], g[kLimbs], h[kLimbs];
  fe_add(p[0], p[1], s);
  fe_sqr(s, s);
  fe_sub(s, a, e);
  fe_sub(e, b, e);
  fe_sub(b, a, g);
  fe_sub(g, c, f);
  fe_set_small(s, 0);
  fe_sub(s, a, h);
  fe_sub(h, b, h);
  fe_mul(e, f, out[0]);
  fe_mul(g, h, out[1]);
  fe_mul(f, g, out[2]);
  fe_mul(e, h, out[3]);
}

// curve.is_identity: X == 0 and Y == Z, exactly mod p.
__device__ __forceinline__ bool ed_is_identity(const uint32_t p[4][kLimbs]) {
  uint32_t diff[kLimbs];
  fe_sub(p[1], p[2], diff);
  return fe_is_zero(p[0]) && fe_is_zero(diff);
}
