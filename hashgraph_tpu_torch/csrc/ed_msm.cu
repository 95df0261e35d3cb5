// The Straus multi-scalar multiply of batch Ed25519 verification as three
// kernels, for Hopper (sm_90a): the window loop, one tree level, and the
// cofactored identity test of the root.
//
// Replaces the TPU kernel hashgraph_tpu/crypto_device/pallas_msm.py::
// _mul_kernel where the JAX MSM (hashgraph_tpu/crypto_device/msm.py:59,
// one jitted program) called it: there XLA fused the point formulas around
// the Pallas product. Here the point formulas of fe25519.cuh run around the
// __device__ fe_mul with every operand in registers, and the stages that
// the JAX program ran as lax.scan and lax.fori_loop run as loops inside the
// kernels. Each kernel gives the limbs of its plain PyTorch version in
// hashgraph_tpu_torch/crypto_device/msm.py:
//
//   msm_windows  _windows_plain: per lane, the 16-entry table (table[0] =
//                identity, table[k] = ed_add(table[k-1], P), so table[1] is
//                identity + P, not P copied), then per window four ed_dbl
//                and one ed_add of the nibble's entry, MSB-first;
//   msm_reduce   one level of _reduce_plain: out[i] = q[2i] + q[2i+1], the
//                last element of an odd count paired with the identity;
//   msm_final    _final_plain: three ed_dbl of the root and ed_is_identity,
//                as an int32 verdict.
//
// Contract. Points are int64 [N, 4, 16] in carried limbs, nibbles int32
// [N, W] in [0, 16) (the kernel masks them to 4 bits and never reads
// outside a lane's table). The wrapper (crypto_device/cuda_msm.py) allocates
// every output and the table scratch; no kernel allocates.
//
// Design. The window loop gives a group of G = kGroup = 4 threads to each
// lane, with fe25519_group.cuh's routines (written for G = 4, 8 or 16):
// thread t of a group holds limbs [t*16/G, (t+1)*16/G) of the accumulator,
// the base point and the selected entry, sums the product columns of its
// own limbs and gets the operand limbs it lacks by shuffles within the
// group. A thread needs about G times fewer registers than a whole lane,
// and at the 16,384 lanes of a 4,096-signature batch the card holds G times
// the warps: with one thread a lane, four warps an SM were too few to hide
// the integer pipeline's latency. The table stays in device memory: 16 entries x 4
// coordinates x 16 limbs, exact in uint16 (carried limbs are < 2^16), 128
// bytes an entry, lane-major ([lane][entry][64 limbs]), 32 MB at 16,384
// lanes, resident in the 50 MB L2 (in uint32 it would take 64 MB). Each
// thread stores and loads only its own limbs of an entry, so a group's
// gather of one entry is one 128-byte line. The tree and the final test
// keep one thread a point (fe25519.cuh). Of 4, 8 and 16 threads a lane, 4
// was the fastest at 16,384 lanes, the larger groups paying more in
// shuffles than they gain in warps (chip_smoke.py phase 6b builds the other
// sizes from a copy of this file and times them; PERF.md keeps the times).
//
// Bound. Per lane the window kernel does 15 + 64 point additions and 256
// doublings, 2,891,416 needed integer instructions (chip_smoke.py counts
// them as MSM_WINDOWS_OPS_PER_LANE), and moves 1,280 bytes (points and
// nibbles in, accumulators out): the operations bound it by three orders of
// magnitude. The shuffles, the carry lookahead and the squarings done as
// full products are what the split adds on top.

#include "fe25519.cuh"
#include "fe25519_group.cuh"

// Threads per lane of the window kernel (the group routines take 4, 8 or
// 16; 4 was the fastest at 16,384 lanes).
constexpr int kGroup = 4;

constexpr int kEntries = 16;              // table entries: 0 * P .. 15 * P
constexpr int kPointLimbs = 4 * kLimbs;   // X, Y, Z, T

__device__ __forceinline__ void pt_load(const int64_t* src,
                                        uint32_t p[4][kLimbs]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < kLimbs; ++i)
      p[c][i] = static_cast<uint32_t>(src[c * kLimbs + i]);
}

__device__ __forceinline__ void pt_store(const uint32_t p[4][kLimbs],
                                         int64_t* dst) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < kLimbs; ++i)
      dst[c * kLimbs + i] = static_cast<int64_t>(p[c][i]);
}

// This thread's limbs of a point: int64 [4][16] in device memory.
template <int G>
__device__ __forceinline__ void gpt_load(const int64_t* src, uint32_t p[4][16 / G]) {
  constexpr int K = 16 / G;
  const int r = grp_rank<G>();
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < K; ++i)
      p[c][i] = static_cast<uint32_t>(src[c * kLimbs + r * K + i]);
}

template <int G>
__device__ __forceinline__ void gpt_store(const uint32_t p[4][16 / G], int64_t* dst) {
  constexpr int K = 16 / G;
  const int r = grp_rank<G>();
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < K; ++i)
      dst[c * kLimbs + r * K + i] = static_cast<int64_t>(p[c][i]);
}

// This thread's limbs of one table entry (64 uint16 limbs): on the card one
// store (or load) of K limbs a coordinate.
template <int G>
__device__ __forceinline__ void gentry_store(const uint32_t p[4][16 / G], uint16_t* entry) {
  constexpr int K = 16 / G;
  uint16_t* d = entry + grp_rank<G>() * K;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#ifdef __CUDA_ARCH__
    if constexpr (K == 4) {
      *reinterpret_cast<uint2*>(d + c * kLimbs) =
          make_uint2((p[c][0] & kMask) | (p[c][1] << 16), (p[c][2] & kMask) | (p[c][3] << 16));
      continue;
    } else if constexpr (K == 2) {
      *reinterpret_cast<uint32_t*>(d + c * kLimbs) = (p[c][0] & kMask) | (p[c][1] << 16);
      continue;
    }
#endif
    for (int i = 0; i < K; ++i) d[c * kLimbs + i] = static_cast<uint16_t>(p[c][i]);
  }
}

template <int G>
__device__ __forceinline__ void gentry_load(const uint16_t* entry, uint32_t p[4][16 / G]) {
  constexpr int K = 16 / G;
  const uint16_t* s = entry + grp_rank<G>() * K;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#ifdef __CUDA_ARCH__
    if constexpr (K == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(s + c * kLimbs);
      p[c][0] = v.x & kMask; p[c][1] = v.x >> 16;
      p[c][2] = v.y & kMask; p[c][3] = v.y >> 16;
      continue;
    } else if constexpr (K == 2) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(s + c * kLimbs);
      p[c][0] = v & kMask; p[c][1] = v >> 16;
      continue;
    }
#endif
    for (int i = 0; i < K; ++i) p[c][i] = s[c * kLimbs + i];
  }
}

// One lane of msm_windows, run by the G threads of a group: the table, then
// the window loop. `table` is the lane's kEntries x kPointLimbs scratch.
template <int G>
__device__ __forceinline__ void msm_group_windows(const int64_t* point,
                                                  const int32_t* nibbles,
                                                  int windows, uint16_t* table,
                                                  int64_t* out) {
  constexpr int K = 16 / G;
  uint32_t base[4][K], acc[4][K];
  gpt_load<G>(point, base);
  ged_identity<G>(acc);
  gentry_store<G>(acc, table);
#pragma unroll 1
  for (int k = 1; k < kEntries; ++k) {
    ged_add<G>(acc, base, acc);
    gentry_store<G>(acc, table + k * kPointLimbs);
  }
  ged_identity<G>(acc);
#pragma unroll 1
  for (int w = 0; w < windows; ++w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) ged_dbl<G>(acc, acc);
    uint32_t sel[4][K];
    gentry_load<G>(table + (nibbles[w] & (kEntries - 1)) * kPointLimbs, sel);
    ged_add<G>(acc, sel, acc);
  }
  if (out != nullptr) gpt_store<G>(acc, out);
}

// Element i of one tree level over n_in points: q[2i] + q[2i+1], or
// q[2i] + identity where 2i + 1 == n_in.
__device__ __forceinline__ void msm_pair(const int64_t* q, int n_in, int i,
                                         int64_t* out) {
  uint32_t l[4][kLimbs], r[4][kLimbs];
  pt_load(q + static_cast<size_t>(2 * i) * kPointLimbs, l);
  if (2 * i + 1 < n_in) {
    pt_load(q + static_cast<size_t>(2 * i + 1) * kPointLimbs, r);
  } else {
    ed_identity(r);
  }
  ed_add(l, r, l);
  pt_store(l, out + static_cast<size_t>(i) * kPointLimbs);
}

// 1 iff 8 * root is the identity.
__device__ __forceinline__ int32_t msm_final_verdict(const int64_t* root) {
  uint32_t p[4][kLimbs];
  pt_load(root, p);
#pragma unroll 1
  for (int i = 0; i < 3; ++i) ed_dbl(p, p);
  return ed_is_identity(p) ? 1 : 0;
}

// The launch code below needs nvcc; a host C++ compiler sees only the
// per-lane routines above (tests/test_torch_msm_kernel.py).
#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kWindowThreads = 128;  // 128 / kGroup lanes a block

// Groups past the last lane run lane lanes-1's arithmetic on a table of
// their own (the table is padded to the grid's groups) and store nothing,
// so every shuffle has the whole warp.
__global__ void __launch_bounds__(kWindowThreads)
msm_windows_kernel(const int64_t* __restrict__ points,
                   const int32_t* __restrict__ nibbles,
                   uint16_t* __restrict__ table, int64_t* __restrict__ out,
                   int lanes, int windows) {
  const int group = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  const size_t at = static_cast<size_t>(group < lanes ? group : lanes - 1);
  msm_group_windows<kGroup>(points + at * kPointLimbs, nibbles + at * windows,
                               windows, table + static_cast<size_t>(group) * kEntries * kPointLimbs,
                               group < lanes ? out + at * kPointLimbs : nullptr);
}

__global__ void __launch_bounds__(kThreads)
msm_reduce_kernel(const int64_t* __restrict__ q, int64_t* __restrict__ out,
                  int n_in) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (n_in + 1) / 2) return;
  msm_pair(q, n_in, i, out);
}

__global__ void msm_final_kernel(const int64_t* __restrict__ root,
                                 int32_t* __restrict__ verdict) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *verdict = msm_final_verdict(root);
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// C interface, loaded with ctypes. Each returns the cudaError_t of its
// launch (0 = success).

// out[n] = the window accumulator of lane n, for n < lanes; table is
// uint16 [hg_msm_table_lanes(lanes), 16, 64] scratch.
extern "C" int hg_msm_windows(const void* points, const void* nibbles,
                              void* table, void* out, int lanes, int windows,
                              void* stream) {
  if (lanes <= 0) return 0;
  const int blocks = (lanes * kGroup + kWindowThreads - 1) / kWindowThreads;
  msm_windows_kernel<<<blocks, kWindowThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(points),
      static_cast<const int32_t*>(nibbles), static_cast<uint16_t*>(table),
      static_cast<int64_t*>(out), lanes, windows);
  return static_cast<int>(cudaGetLastError());
}

// Lanes the window table must hold for `lanes` lanes: every group of the
// launch grid, the surplus ones included.
extern "C" int hg_msm_table_lanes(int lanes) {
  const int blocks = (lanes * kGroup + kWindowThreads - 1) / kWindowThreads;
  return blocks * kWindowThreads / kGroup;
}

// One tree level: out[i] = q[2i] + q[2i+1] for i < ceil(n_in / 2).
extern "C" int hg_msm_reduce(const void* q, void* out, int n_in,
                             void* stream) {
  if (n_in <= 0) return 0;
  msm_reduce_kernel<<<blocks_for((n_in + 1) / 2), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(q), static_cast<int64_t*>(out), n_in);
  return static_cast<int>(cudaGetLastError());
}

// verdict[0] = 1 iff 8 * root is the identity.
extern "C" int hg_msm_final(const void* root, void* verdict, void* stream) {
  msm_final_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(root), static_cast<int32_t*>(verdict));
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__
