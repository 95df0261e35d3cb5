// The Straus multi-scalar multiply of batch Ed25519 verification as two
// kernels, for Hopper (sm_90a): the window loop, and the tree reduction of
// the lane accumulators with the cofactored identity test of its root.
//
// Replaces the TPU kernel hashgraph_tpu/crypto_device/pallas_msm.py::
// _mul_kernel where the JAX MSM (hashgraph_tpu/crypto_device/msm.py:59,
// one jitted program) called it: there XLA fused the point formulas around
// the Pallas product. Here the point formulas of fe25519_group.cuh run
// around the field product with every operand in registers, and the stages
// that the JAX program ran as lax.scan and lax.fori_loop run as loops inside
// the kernels. Each kernel gives the limbs of its plain PyTorch version in
// hashgraph_tpu_torch/crypto_device/msm.py:
//
//   msm_windows  _windows_plain: per lane, the 16-entry table (table[0] =
//                identity, table[k] = ed_add(table[k-1], P), so table[1] is
//                identity + P, not P copied), then per window four ed_dbl
//                and one ed_add of the nibble's entry, MSB-first;
//   msm_reduce   _reduce_plain and _final_plain: element i of each tree
//                level is q[2i] + q[2i+1], the last element of an odd count
//                paired with the identity, ceil(log2 n) levels and at least
//                one; then three ed_dbl of the root and the identity test,
//                as an int32 verdict. Point addition is not canonical in
//                extended coordinates, so this pairing is part of the result.
//
// Contract. Points are int64 [N, 4, 16] in carried limbs, nibbles int32
// [N, W] in [0, 16) (the kernel masks them to 4 bits and never reads
// outside a lane's table). The wrapper (crypto_device/cuda_msm.py) allocates
// every output and scratch buffer; no kernel allocates.
//
// The window loop. A group of G = kGroup = 4 threads shares each lane, with
// fe25519_group.cuh's routines: thread t of a group holds limbs [t*16/G,
// (t+1)*16/G) of the accumulator, the base point and the selected entry,
// sums the product columns of its own limbs and gets the operand limbs it
// lacks by shuffles within the group. A thread needs about G times fewer
// registers than a whole lane, and at the 16,384 lanes of a 4,096-signature
// batch the card holds G times the warps: with one thread a lane, four warps
// an SM were too few to hide the integer pipeline's latency. The table stays
// in device memory: 16 entries x 4 coordinates x 16 limbs, exact in uint16
// (carried limbs are < 2^16), 128 bytes an entry, lane-major ([lane][entry]
// [64 limbs]), 32 MB at 16,384 lanes, resident in the 50 MB L2. Each thread
// stores and loads only its own limbs of an entry, so a group's gather of
// one entry is one 128-byte line. Of 4, 8 and 16 threads a lane, 4 was the
// fastest, the larger groups paying more in shuffles than they gain in warps
// (each size built from this file and timed on the H100; PERF.md's findings
// keep the result). Per lane it does 15 + 64 point additions and 256
// doublings; the work any window stage needs is 2,848,752 integer
// instructions a point (portbench/counts/msm_windows.py's PER_POINT: 14
// table additions, 63 windows of 4 doublings, 64 additions), against 1,280
// bytes moved: operations bound it.
//
// The tree. Its time is a chain of ceil(log2 n) + 3 dependent point
// formulas (17 at 16,384 lanes), not bytes (8 MB in) nor operations (0.005
// ms of the card's issue rate), so the design shortens each link and drops
// the launches between links. Each point is split across a group of
// kTreeGroup threads. A block takes kTreeSpan = 2^k consecutive points and
// runs k levels over them itself: level 0 reads the points from device
// memory, each later level reads the one before from shared memory (uint16
// limbs, two buffers), with __syncthreads() between levels. Because the
// span is a power of two, the block's elements at level l are exactly the
// global tree's elements [b * span / 2^l, (b + 1) * span / 2^l), and an odd
// count in the last block pads exactly where the global tree pads. Each
// block writes one partial, and one launch of a single block runs the
// remaining levels over the partials (another pass of spans first, where
// there are more than kTreeSpan of them), then the three doublings and the
// identity test: two launches at 16,384 lanes, one where n <= kTreeSpan.
// Groups with no pair at a level run the last pair's arithmetic and store
// nothing, so the group routines' shuffles have the whole warp; a warp with
// no pair at all skips the level. Of 1, 4, 8 and 16 threads a point, 8 was
// the fastest at 16,384 lanes (16 is held to 64 registers and spills; 4
// does twice the products a thread; one thread a point runs each link at
// the one-thread formulas' latency), each size built from this file and
// timed on the H100.

#include "fe25519.cuh"
#include "fe25519_group.cuh"

// Threads per lane of the window kernel (the group routines take 4, 8 or
// 16; 4 was the fastest at 16,384 lanes).
constexpr int kGroup = 4;

// Threads per point of the tree (fe25519_group.cuh takes 1, 2, 4, 8 or 16) and
// the points one block reduces (a power of two; with 128 a block's partials
// of up to 16,384 lanes fold in one more launch).
constexpr int kTreeGroup = 8;
constexpr int kTreeSpan = 128;
constexpr int kTreeThreads = kTreeSpan / 2 * kTreeGroup < 512 ? kTreeSpan / 2 * kTreeGroup : 512;

constexpr int kEntries = 16;              // table entries: 0 * P .. 15 * P
constexpr int kPointLimbs = 4 * kLimbs;   // X, Y, Z, T

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

// Levels of the tree over `count` points: ceil(log2 count), at least one
// (msm.reduce_levels).
inline __device__ int tree_levels(int count) {
  int levels = 1;
  while ((1 << levels) < count) ++levels;
  return levels;
}

template <int G>
__device__ __forceinline__ void tree_load(const int64_t* q, uint32_t p[4][16 / G]) {
  gpt_load<G>(q, p);
}

template <int G>
__device__ __forceinline__ void tree_load(const uint16_t* q, uint32_t p[4][16 / G]) {
  gentry_load<G>(q, p);
}

// One group's work at one tree level: element i of the next level is
// q[2i] + q[2i+1] of the `count` points q (int64 points in device memory,
// or uint16 entries), or q[2i] + identity where 2i + 1 == count; stored as
// a uint16 entry at out unless out is null (a surplus group).
template <int G, typename T>
__device__ __forceinline__ void tree_pair(const T* q, int count, int i, uint16_t* out) {
  constexpr int K = 16 / G;
  uint32_t l[4][K], r[4][K];
  tree_load<G>(q + static_cast<size_t>(2 * i) * kPointLimbs, l);
  if (2 * i + 1 < count) {
    tree_load<G>(q + static_cast<size_t>(2 * i + 1) * kPointLimbs, r);
  } else {
    ged_identity<G>(r);
  }
  ged_add<G>(l, r, l);
  if (out != nullptr) gentry_store<G>(l, out);
}

// The tree's epilogue on its root (a uint16 entry): the root's limbs go to
// root_out (int64 [4][16]) unless it is null, and the result, on every
// thread of the group, is 1 iff 8 * root is the identity.
template <int G>
__device__ __forceinline__ int32_t tree_verdict(const uint16_t* root, int64_t* root_out) {
  uint32_t p[4][16 / G];
  gentry_load<G>(root, p);
  if (root_out != nullptr) gpt_store<G>(p, root_out);
#pragma unroll 1
  for (int i = 0; i < 3; ++i) ged_dbl<G>(p, p);
  return ged_is_identity<G>(p) ? 1 : 0;
}

// The launch code below needs nvcc; a host C++ compiler sees only the
// per-lane and per-group routines above (tests/test_torch_msm_kernel.py).
#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kWindowThreads = 128;  // 128 / kGroup lanes a block
constexpr int kTreeGroups = kTreeThreads / kTreeGroup;
constexpr int kSpanEntries = kTreeSpan / 2 * kPointLimbs;  // a level's output

constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }
constexpr int kSpanLevels = log2_of(kTreeSpan);  // a block's levels
static_assert(kTreeSpan >= 2 && (1 << kSpanLevels) == kTreeSpan,
              "kTreeSpan must be a power of two");

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

// `levels` levels of the tree over the block's `count` points q: level 0
// from q, each later one from the level before in buf[0] or buf[1]. Returns
// the entry of the last level's element 0.
__device__ __forceinline__ const uint16_t* block_tree(const int64_t* q, int count, int levels,
                                                      uint16_t (*buf)[kSpanEntries]) {
  const int group = threadIdx.x / kTreeGroup;
  const int warp_group = (threadIdx.x & ~31u) / kTreeGroup;  // the warp's first group
  const uint16_t* in = nullptr;
#pragma unroll 1
  for (int l = 0; l < levels; ++l) {
    const int pairs = (count + 1) / 2;
    uint16_t* out = buf[l & 1];
#pragma unroll 1
    for (int base = 0; base + warp_group < pairs; base += kTreeGroups) {
      const int i = base + group;
      const int at = i < pairs ? i : pairs - 1;
      uint16_t* dst = i < pairs ? out + at * kPointLimbs : nullptr;
      if (l == 0) {
        tree_pair<kTreeGroup>(q, count, at, dst);
      } else {
        tree_pair<kTreeGroup>(in, count, at, dst);
      }
    }
    __syncthreads();
    in = out;
    count = pairs;
  }
  return in;
}

// Block b reduces points [b * kTreeSpan, (b + 1) * kTreeSpan) of q over
// log2(kTreeSpan) levels into partial b.
__global__ void __launch_bounds__(kTreeThreads)
msm_tree_span_kernel(const int64_t* __restrict__ q, int64_t* __restrict__ partials,
                     int count) {
  __shared__ __align__(16) uint16_t buf[2][kSpanEntries];
  const int first = blockIdx.x * kTreeSpan;
  const int n = count - first < kTreeSpan ? count - first : kTreeSpan;
  const uint16_t* res = block_tree(q + static_cast<size_t>(first) * kPointLimbs, n,
                                   kSpanLevels, buf);
  if (threadIdx.x < kPointLimbs)
    partials[static_cast<size_t>(blockIdx.x) * kPointLimbs + threadIdx.x] = res[threadIdx.x];
}

// One block: the whole tree over count <= kTreeSpan points, then the
// epilogue, run by every group of warp 0 (group 0 stores the root).
__global__ void __launch_bounds__(kTreeThreads)
msm_tree_root_kernel(const int64_t* __restrict__ q, int count,
                     int64_t* __restrict__ root, int32_t* __restrict__ verdict) {
  __shared__ __align__(16) uint16_t buf[2][kSpanEntries];
  const uint16_t* res = block_tree(q, count, tree_levels(count), buf);
  if (threadIdx.x < 32) {
    const int32_t v = tree_verdict<kTreeGroup>(res, threadIdx.x < kTreeGroup ? root : nullptr);
    if (threadIdx.x == 0) *verdict = v;
  }
}

}  // namespace

// C interface, loaded with ctypes. Each launch returns the cudaError_t of
// its launch (0 = success).

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

// Points one block of the tree reduces.
extern "C" int hg_msm_tree_span() { return kTreeSpan; }

// partials[b] = the tree over points [b * span, (b + 1) * span) of q, for
// b < ceil(count / span): partials is int64 [ceil(count / span), 4, 16].
extern "C" int hg_msm_tree_partials(const void* q, void* partials, int count,
                                    void* stream) {
  if (count <= 0) return 0;
  msm_tree_span_kernel<<<(count + kTreeSpan - 1) / kTreeSpan, kTreeThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(q), static_cast<int64_t*>(partials), count);
  return static_cast<int>(cudaGetLastError());
}

// root = the tree over count <= span points q, verdict[0] = 1 iff 8 * root
// is the identity.
extern "C" int hg_msm_tree_root(const void* q, int count, void* root,
                                void* verdict, void* stream) {
  if (count <= 0 || count > kTreeSpan) return static_cast<int>(cudaErrorInvalidValue);
  msm_tree_root_kernel<<<1, kTreeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(q), count, static_cast<int64_t*>(root),
      static_cast<int32_t*>(verdict));
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__
