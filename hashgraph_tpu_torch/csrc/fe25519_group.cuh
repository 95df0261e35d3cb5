// GF(2^255-19) arithmetic and edwards25519 point formulas split across a
// group of G threads (G in {2, 4, 8, 16}) that share one lane: thread t of the
// group owns limbs [t*K, (t+1)*K), K = 16 / G, of every field element.
// G = 1 is the one-thread code of fe25519.cuh: each routine hands a group
// of one to its counterpart there, so a kernel written over G builds at
// every size, one thread a lane included.
//
// Every routine gives the limbs its one-thread counterpart in fe25519.cuh
// gives (and so those of the plain PyTorch versions), limb for limb:
//
//   gfe_mul  the columns of the product as the same exact integers. A
//            thread sums the columns of its own output limbs. Column c's
//            products are a_x * b_y with x + y == c or c + 16, so each
//            thread needs every limb of a (gathered in order) and every limb
//            of b (gathered rotated by t*K, so that y's index is known when
//            the code is compiled). A low half landing in column c + 16
//            folds into limb c with weight 38 (2^256 == 38 mod p); which
//            halves do depends on the thread's rank only block by block, so
//            halves are summed per block of a and each sum is routed by one
//            multiply-add with weight 1 or 38, not a branch per product;
//            high halves of a thread's last column go to the next
//            thread, and those of column 15 (column 16) to thread 0 times
//            38. Every column stays below 2^27, as in fe25519.cuh.
//   gfe_sqr  gfe_mul(a, a): which products of a column are mirror pairs
//            depends on the thread's rank, so the one-thread code's
//            136-product shape would need a branch per product; the group
//            computes all 256.
//   ged_is_identity  curve.is_identity by limb equality: a carried value
//            is below 2^256 < 3p, so it is 0 mod p exactly when its limbs
//            are those of 0, p or 2p; each thread compares its limbs, and
//            the mismatches are ORed across the group.
//   carry    carry_vec is one exchange: each thread's top carry goes to its
//            neighbour, the group's top carry times 38 to thread 0.
//            carry_seq, the exact ripple, is a carry lookahead: each thread
//            ripples its limbs with carry-in 0 and 1, the two carry-outs
//            (0 or 1 at these bounds: every limb <= 2^17 - 2, see
//            crypto_device/field.py::_carry_seq) compose along the group in
//            log2(G) exchanges, and each thread ripples again from its true
//            carry-in: the ripple's limbs exactly. The second exact pass
//            runs only in a group whose limb 0 carries after the first
//            (below it, no limb can start a carry).
//
// Every exchange goes through one primitive, grp_get(value, from_thread):
// on the card __shfl_sync within the group; in a host build a function the
// host harness supplies (tests/test_torch_msm_kernel.py steps the G threads
// of a group in turn, so g++ runs this exact arithmetic at every G).

#pragma once

#include "fe25519.cuh"

#ifdef __CUDACC__
template <int G>
__device__ __forceinline__ int grp_rank() {
  return static_cast<int>(threadIdx.x) & (G - 1);
}

// Where every thread of the warp takes part (the kernel keeps surplus
// groups running rather than returning them) the mask is the constant full
// warp: a mask computed at run time makes the compiler wrap each shuffle in
// a warp-synchronising collective. Inside a branch that groups of one warp
// may take differently (Whole = false) the mask is the group's own lanes.
template <int G, bool Whole = true>
__device__ __forceinline__ uint32_t grp_get(uint32_t v, int from) {
  const uint32_t lanes =
      Whole ? 0xFFFFFFFFu
            : ((1u << G) - 1u) << ((threadIdx.x & 31u) & ~static_cast<uint32_t>(G - 1));
  return __shfl_sync(lanes, v, from, G);
}
#else
int host_grp_rank();
uint32_t host_grp_get(uint32_t v, int from);
template <int G>
inline int grp_rank() {
  return G == 1 ? 0 : host_grp_rank();
}
template <int G, bool Whole = true>
inline uint32_t grp_get(uint32_t v, int from) {
  return host_grp_get(v, from);
}
#endif

// ── carry ───────────────────────────────────────────────────────────────

template <int G>
__device__ __forceinline__ void gcarry_vec(uint32_t t[16 / G]) {
  constexpr int K = 16 / G;
  const int r = grp_rank<G>();
  uint32_t c[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    c[i] = t[i] >> 16;
    t[i] &= kMask;
  }
#pragma unroll
  for (int i = 1; i < K; ++i) t[i] += c[i - 1];
  const uint32_t in = grp_get<G>(c[K - 1], (r + G - 1) & (G - 1));
  t[0] += r == 0 ? in * kFold : in;
}

template <int G, bool Whole = true>
__device__ __forceinline__ void gcarry_seq(uint32_t t[16 / G]) {
  constexpr int K = 16 / G;
  const int r = grp_rank<G>();
  // This thread's carry-out for carry-in 0 (bit 0) and 1 (bit 1).
  uint32_t c0 = 0, c1 = 1;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    c0 = (t[i] + c0) >> 16;
    c1 = (t[i] + c1) >> 16;
  }
  uint32_t f = c0 | (c1 << 1);
  // Inclusive scan: f becomes the carry-out of limb r*K + K - 1 as a
  // function of the carry into limb 0.
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const uint32_t prev = grp_get<G, Whole>(f, (r + G - d) & (G - 1));
    if (r >= d) f = ((f >> (prev & 1u)) & 1u) | (((f >> (prev >> 1)) & 1u) << 1);
  }
  uint32_t c = grp_get<G, Whole>(f & 1u, (r + G - 1) & (G - 1));
  const uint32_t top = grp_get<G, Whole>(f & 1u, G - 1);
  if (r == 0) c = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const uint32_t cur = t[i] + c;
    t[i] = cur & kMask;
    c = cur >> 16;
  }
  if (r == 0) t[0] += top * kFold;
}

template <int G>
__device__ __forceinline__ void gfe_carry(uint32_t t[16 / G]) {
  if constexpr (G == 1) {
    fe_carry(t);
    return;
  }
  gcarry_vec<G>(t);
  gcarry_vec<G>(t);
  gcarry_seq<G>(t);
  // After an exact pass every limb is below 2^16 but limb 0 (38 * the top
  // carry was added to it unmasked), so the second pass changes nothing
  // unless limb 0 carries: one exchange asks thread 0, and the rare group
  // that carries runs the whole pass.
  const uint32_t starts = grp_get<G>(t[0] >> 16, 0);
  if (starts) gcarry_seq<G, false>(t);
}

// ── field ───────────────────────────────────────────────────────────────

// The carried product of two carried field elements; out may alias a or b.
template <int G>
__device__ __forceinline__ void gfe_mul(const uint32_t a[16 / G],
                                        const uint32_t b[16 / G],
                                        uint32_t out[16 / G]) {
  if constexpr (G == 1) {
    fe_mul(a, b, out);
    return;
  }
  constexpr int K = 16 / G;
  const int r = grp_rank<G>();
  uint32_t A[kLimbs], B[kLimbs];
#pragma unroll
  for (int x = 0; x < kLimbs; ++x) A[x] = grp_get<G>(a[x % K], x / K);
  // B[m] = b[(r*K + m) % 16]; the first K are this thread's own.
#pragma unroll
  for (int m = 0; m < kLimbs; ++m)
    B[m] = m < K ? b[m] : grp_get<G>(b[m % K], (r + m / K) & (G - 1));
  // Column r*K + i's product with a_x lands in column + 16 (weight 38)
  // where x > r*K + i: for x = xb*K + xi, where xb > r, or xb == r and
  // xi > i. So the halves are summed per block of a in two parts, xi <= i
  // and xi > i (known when compiled), and each part is weighted once.
  uint32_t acc[K + 1];
#pragma unroll
  for (int i = 0; i <= K; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int xb = 0; xb < G; ++xb) {
      uint32_t lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
#pragma unroll
      for (int xi = 0; xi < K; ++xi) {
        const int x = xb * K + xi;
        const uint32_t p = A[x] * B[(i - x) & (kLimbs - 1)];
        if (xi <= i) {
          lo0 += p & kMask;
          hi0 += p >> 16;
        } else {
          lo1 += p & kMask;
          hi1 += p >> 16;
        }
      }
      const uint32_t w0 = xb > r ? kFold : 1u;
      const uint32_t w1 = xb >= r ? kFold : 1u;
      acc[i] += lo0 * w0 + lo1 * w1;
      acc[i + 1] += hi0 * w0 + hi1 * w1;
    }
  }
  const uint32_t in = grp_get<G>(acc[K], (r + G - 1) & (G - 1));
  acc[0] += r == 0 ? in * kFold : in;
#pragma unroll
  for (int i = 0; i < K; ++i) out[i] = acc[i];
  gfe_carry<G>(out);
}

template <int G>
__device__ __forceinline__ void gfe_sqr(const uint32_t a[16 / G],
                                        uint32_t out[16 / G]) {
  if constexpr (G == 1) {
    fe_sqr(a, out);
    return;
  }
  gfe_mul<G>(a, a, out);
}

template <int G>
__device__ __forceinline__ void gfe_add(const uint32_t a[16 / G],
                                        const uint32_t b[16 / G],
                                        uint32_t out[16 / G]) {
#pragma unroll
  for (int i = 0; i < 16 / G; ++i) out[i] = a[i] + b[i];
  gfe_carry<G>(out);
}

// a - b mod p, as a + (4p - b) limb by limb.
template <int G>
__device__ __forceinline__ void gfe_sub(const uint32_t a[16 / G],
                                        const uint32_t b[16 / G],
                                        uint32_t out[16 / G]) {
  constexpr int K = 16 / G;
  const int r = grp_rank<G>();
#pragma unroll
  for (int i = 0; i < K; ++i) out[i] = a[i] + (pad4p(r * K + i) - b[i]);
  gfe_carry<G>(out);
}

template <int G>
__device__ __forceinline__ void gfe_set_small(uint32_t out[16 / G], uint32_t v) {
  const int r = grp_rank<G>();
#pragma unroll
  for (int i = 0; i < 16 / G; ++i) out[i] = r == 0 && i == 0 ? v : 0u;
}

template <int G>
__device__ __forceinline__ void gfe_copy(const uint32_t a[16 / G], uint32_t out[16 / G]) {
#pragma unroll
  for (int i = 0; i < 16 / G; ++i) out[i] = a[i];
}

// a^(2^k): k squarings, in place.
template <int G>
__device__ __forceinline__ void gfe_pow2k(uint32_t a[16 / G], int k) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) gfe_sqr<G>(a, a);
}

// z^((p-5)/8) = z^(2^252 - 3), the chain of field.pow22523 step for step:
// 251 squarings and 11 products.
template <int G>
__device__ __forceinline__ void gfe_pow22523(const uint32_t z[16 / G], uint32_t out[16 / G]) {
  constexpr int K = 16 / G;
  uint32_t z2[K], z9[K], t[K], z2_5_0[K], z2_10_0[K], z2_50_0[K], z2_x[K];
  gfe_sqr<G>(z, z2);
  gfe_copy<G>(z2, t);
  gfe_pow2k<G>(t, 2);
  gfe_mul<G>(t, z, z9);              // z^9
  gfe_mul<G>(z9, z2, t);             // z^11
  gfe_sqr<G>(t, t);
  gfe_mul<G>(t, z9, z2_5_0);         // z^(2^5 - 1)
  gfe_copy<G>(z2_5_0, t);
  gfe_pow2k<G>(t, 5);
  gfe_mul<G>(t, z2_5_0, z2_10_0);    // z^(2^10 - 1)
  gfe_copy<G>(z2_10_0, t);
  gfe_pow2k<G>(t, 10);
  gfe_mul<G>(t, z2_10_0, z2_x);      // z^(2^20 - 1)
  gfe_copy<G>(z2_x, t);
  gfe_pow2k<G>(t, 20);
  gfe_mul<G>(t, z2_x, t);            // z^(2^40 - 1)
  gfe_pow2k<G>(t, 10);
  gfe_mul<G>(t, z2_10_0, z2_50_0);   // z^(2^50 - 1)
  gfe_copy<G>(z2_50_0, t);
  gfe_pow2k<G>(t, 50);
  gfe_mul<G>(t, z2_50_0, z2_x);      // z^(2^100 - 1)
  gfe_copy<G>(z2_x, t);
  gfe_pow2k<G>(t, 100);
  gfe_mul<G>(t, z2_x, t);            // z^(2^200 - 1)
  gfe_pow2k<G>(t, 50);
  gfe_mul<G>(t, z2_50_0, t);         // z^(2^250 - 1)
  gfe_pow2k<G>(t, 2);
  gfe_mul<G>(t, z, out);             // z^(2^252 - 3)
}

// ── points ──────────────────────────────────────────────────────────────

template <int G>
__device__ __forceinline__ void ged_identity(uint32_t p[4][16 / G]) {
  gfe_set_small<G>(p[0], 0);
  gfe_set_small<G>(p[1], 1);
  gfe_set_small<G>(p[2], 1);
  gfe_set_small<G>(p[3], 0);
}

// curve.add, as ed_add: out = p + q; out may alias p or q.
template <int G>
__device__ __forceinline__ void ged_add(const uint32_t p[4][16 / G],
                                   const uint32_t q[4][16 / G],
                                   uint32_t out[4][16 / G]) {
  if constexpr (G == 1) {
    ed_add(p, q, out);
    return;
  }
  constexpr int K = 16 / G;
  const int r = grp_rank<G>();
  uint32_t a[K], b[K], c[K], d[K], s[K], t[K];
  gfe_sub<G>(p[1], p[0], s);
  gfe_sub<G>(q[1], q[0], t);
  gfe_mul<G>(s, t, a);
  gfe_add<G>(p[1], p[0], s);
  gfe_add<G>(q[1], q[0], t);
  gfe_mul<G>(s, t, b);
#pragma unroll
  for (int i = 0; i < K; ++i) s[i] = d2_limb(r * K + i);
  gfe_mul<G>(p[3], s, t);
  gfe_mul<G>(t, q[3], c);
  gfe_mul<G>(p[2], q[2], s);
  gfe_add<G>(s, s, d);
  uint32_t e[K], f[K], g[K], h[K];
  gfe_sub<G>(b, a, e);
  gfe_sub<G>(d, c, f);
  gfe_add<G>(d, c, g);
  gfe_add<G>(b, a, h);
  gfe_mul<G>(e, f, out[0]);
  gfe_mul<G>(g, h, out[1]);
  gfe_mul<G>(f, g, out[2]);
  gfe_mul<G>(e, h, out[3]);
}

// curve.dbl, as ed_dbl: out = 2p, with h = (0 - a) - b; out may alias p.
template <int G>
__device__ __forceinline__ void ged_dbl(const uint32_t p[4][16 / G],
                                   uint32_t out[4][16 / G]) {
  if constexpr (G == 1) {
    ed_dbl(p, out);
    return;
  }
  constexpr int K = 16 / G;
  uint32_t a[K], b[K], c[K], s[K];
  gfe_sqr<G>(p[0], a);
  gfe_sqr<G>(p[1], b);
  gfe_sqr<G>(p[2], s);
  gfe_add<G>(s, s, c);
  uint32_t e[K], f[K], g[K], h[K];
  gfe_add<G>(p[0], p[1], s);
  gfe_sqr<G>(s, s);
  gfe_sub<G>(s, a, e);
  gfe_sub<G>(e, b, e);
  gfe_sub<G>(b, a, g);
  gfe_sub<G>(g, c, f);
  gfe_set_small<G>(s, 0);
  gfe_sub<G>(s, a, h);
  gfe_sub<G>(h, b, h);
  gfe_mul<G>(e, f, out[0]);
  gfe_mul<G>(g, h, out[1]);
  gfe_mul<G>(f, g, out[2]);
  gfe_mul<G>(e, h, out[3]);
}

// curve.is_identity, as ed_is_identity, on a carried point (every limb
// below 2^16): X == 0 and Y == Z mod p. True on every thread of the group.
template <int G>
__device__ __forceinline__ bool ged_is_identity(const uint32_t p[4][16 / G]) {
  if constexpr (G == 1) return ed_is_identity(p);
  constexpr int K = 16 / G;
  const int r = grp_rank<G>();
  uint32_t diff[K];
  gfe_sub<G>(p[1], p[2], diff);
  // Bits 0-2: X differs from 0, p, 2p; bits 3-5: Y - Z does.
  uint32_t miss = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = r * K + i;
    const uint32_t pj = p_limb(j), p2j = j == 0 ? 0xFFDAu : 0xFFFFu;  // 2p = 2^256 - 38
    miss |= static_cast<uint32_t>(p[0][i] != 0u) | static_cast<uint32_t>(p[0][i] != pj) << 1 |
            static_cast<uint32_t>(p[0][i] != p2j) << 2 | static_cast<uint32_t>(diff[i] != 0u) << 3 |
            static_cast<uint32_t>(diff[i] != pj) << 4 | static_cast<uint32_t>(diff[i] != p2j) << 5;
  }
#pragma unroll
  for (int d = 1; d < G; d <<= 1) miss |= grp_get<G>(miss, r ^ d);
  return (miss & 7u) != 7u && (miss >> 3) != 7u;
}
