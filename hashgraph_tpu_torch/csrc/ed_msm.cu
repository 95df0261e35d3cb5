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
// Design. One thread owns one lane; its accumulator and both operands of
// every point formula live in registers. The only device memory the window
// loop touches is the lane's table: 16 entries x 4 coordinates x 16 limbs.
// Carried limbs are < 2^16, so an entry is exact in uint16: 128 bytes, one
// cache line, stored lane-major ([lane][entry][64 limbs]) so each gather of
// an entry is one line. At the 16,384 lanes of a 4,096-signature batch the
// tables take 32 MB, which stays resident in the 50 MB L2 (in uint32 they
// would take 64 MB and would not). Shared memory cannot hold them: each SM
// carries about 124 lanes, 248 KB of tables against 227 KB a block can use.
//
// Bound. Per lane the window kernel does 15 + 64 point additions and 256
// doublings, about 4.8 M 32-bit integer operations (chip_smoke.py counts
// them as MSM_WINDOWS_OPS_PER_LANE), and moves 1,280 bytes (points and
// nibbles in, accumulators out): the operations bound it by three orders of
// magnitude. A simple kernel first: one thread per lane leaves about four
// warps on an SM at 16,384 lanes, too few to hide the integer pipeline's
// latency; splitting a lane across threads is later work.

#include "fe25519.cuh"

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

// One table entry as 64 uint16 limbs: eight 16-byte stores on the card.
__device__ __forceinline__ void entry_store(const uint32_t p[4][kLimbs],
                                            uint16_t* dst) {
#ifdef __CUDA_ARCH__
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t* l = &p[c][8 * h];
      d[2 * c + h] = make_uint4(
          (l[0] & kMask) | (l[1] << 16), (l[2] & kMask) | (l[3] << 16),
          (l[4] & kMask) | (l[5] << 16), (l[6] & kMask) | (l[7] << 16));
    }
#else
  for (int c = 0; c < 4; ++c)
    for (int i = 0; i < kLimbs; ++i)
      dst[c * kLimbs + i] = static_cast<uint16_t>(p[c][i]);
#endif
}

__device__ __forceinline__ void entry_load(const uint16_t* src,
                                           uint32_t p[4][kLimbs]) {
#ifdef __CUDA_ARCH__
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 v = s[2 * c + h];
      uint32_t* l = &p[c][8 * h];
      l[0] = v.x & kMask; l[1] = v.x >> 16;
      l[2] = v.y & kMask; l[3] = v.y >> 16;
      l[4] = v.z & kMask; l[5] = v.z >> 16;
      l[6] = v.w & kMask; l[7] = v.w >> 16;
    }
#else
  for (int c = 0; c < 4; ++c)
    for (int i = 0; i < kLimbs; ++i) p[c][i] = src[c * kLimbs + i];
#endif
}

// One lane of msm_windows: the table, then the window loop. `table` is the
// lane's kEntries x kPointLimbs scratch.
__device__ __forceinline__ void msm_lane_windows(const int64_t* point,
                                                 const int32_t* nibbles,
                                                 int windows, uint16_t* table,
                                                 int64_t* out) {
  uint32_t base[4][kLimbs], acc[4][kLimbs];
  pt_load(point, base);
  ed_identity(acc);
  entry_store(acc, table);
#pragma unroll 1
  for (int k = 1; k < kEntries; ++k) {
    ed_add(acc, base, acc);
    entry_store(acc, table + k * kPointLimbs);
  }
  ed_identity(acc);
#pragma unroll 1
  for (int w = 0; w < windows; ++w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) ed_dbl(acc, acc);
    uint32_t sel[4][kLimbs];
    entry_load(table + (nibbles[w] & (kEntries - 1)) * kPointLimbs, sel);
    ed_add(acc, sel, acc);
  }
  pt_store(acc, out);
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

__global__ void __launch_bounds__(kThreads)
msm_windows_kernel(const int64_t* __restrict__ points,
                   const int32_t* __restrict__ nibbles,
                   uint16_t* __restrict__ table, int64_t* __restrict__ out,
                   int lanes, int windows) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t at = static_cast<size_t>(lane);
  msm_lane_windows(points + at * kPointLimbs, nibbles + at * windows, windows,
                   table + at * kEntries * kPointLimbs,
                   out + at * kPointLimbs);
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
// uint16 [lanes, 16, 64] scratch.
extern "C" int hg_msm_windows(const void* points, const void* nibbles,
                              void* table, void* out, int lanes, int windows,
                              void* stream) {
  if (lanes <= 0) return 0;
  msm_windows_kernel<<<blocks_for(lanes), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(points),
      static_cast<const int32_t*>(nibbles), static_cast<uint16_t*>(table),
      static_cast<int64_t*>(out), lanes, windows);
  return static_cast<int>(cudaGetLastError());
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
