// The inverse-square-root exponent z^((p-5)/8) of point decompression as
// one launch, for Hopper (sm_90a).
//
// Replaces, for this chain, the TPU kernel hashgraph_tpu/crypto_device/
// pallas_msm.py::_mul_kernel: the JAX package runs field.pow22523 as 262
// Pallas products inside one jitted decompression. Here a group of
// kPowGroup threads shares each lane and runs fe25519_group.cuh's
// gfe_pow22523 (251 squarings and 11 products) with every operand in
// registers; the plain PyTorch version is hashgraph_tpu_torch/
// crypto_device/field.py::_pow22523_plain, limb for limb.
//
// Contract. int64 [N, 16] in carried limbs in, the same out.
//
// Bound. Per lane 251 squarings and 11 products, 176,140 needed integer
// instructions (chip_smoke.py's POW22523_OPS_PER_LANE: a squaring from 136
// limb products, a product from 256), against 256 bytes moved: operations
// bound it, 0.043 ms at the 8,192 lanes of a 4,096-signature batch. The
// chain is one dependent product after another, so what sets its time is
// how many warps hide each product's latency: with one thread a lane those
// lanes make 256 warps for the H100's 528 schedulers. A group of G threads
// a lane makes G times the warps, each thread holding 16/G limbs of every
// element and getting the operand limbs it lacks by shuffles (the group
// routines of the window kernel); the price is the shuffles, the carry
// across the group and a squaring done as a full product. With G = 1 the
// lane is one thread, whose squaring takes 136 limb products.
// Every size of 1, 2, 4, 8 and 16 was built from this file with kPowGroup
// changed and timed on the H100 (PERF.md's findings keep the result):
// 4 was the fastest at 8,192 lanes, one thread a lane (with the cheaper
// squaring) a close second.
// Blocks of 128 threads; the grid is padded to whole blocks, and the
// surplus groups run the last lane's arithmetic and store nothing, so
// every shuffle has the whole warp.

#include "fe25519.cuh"
#include "fe25519_group.cuh"

// Threads per lane (1, 2, 4, 8 or 16).
constexpr int kPowGroup = 4;

// One lane run by the G threads of a group: each loads and stores its own
// limbs; out null stores nothing.
template <int G>
__device__ __forceinline__ void pow22523_group(const int64_t* z, int64_t* out) {
  constexpr int K = 16 / G;
  const int r = grp_rank<G>();
  uint32_t x[K], y[K];
#pragma unroll
  for (int i = 0; i < K; ++i) x[i] = static_cast<uint32_t>(z[r * K + i]);
  gfe_pow22523<G>(x, y);
  if (out != nullptr) {
#pragma unroll
    for (int i = 0; i < K; ++i) out[r * K + i] = static_cast<int64_t>(y[i]);
  }
}

// The launch code below needs nvcc (tests/test_torch_msm_kernel.py builds
// the group routine above with a host compiler).
#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
fe_pow22523_kernel(const int64_t* __restrict__ z, int64_t* __restrict__ out,
                   int lanes) {
  const int lane = (blockIdx.x * blockDim.x + threadIdx.x) / kPowGroup;
  const size_t at = static_cast<size_t>(lane < lanes ? lane : lanes - 1) * kLimbs;
  pow22523_group<kPowGroup>(z + at, lane < lanes ? out + at : nullptr);
}

}  // namespace

// C interface, loaded with ctypes: out[n] = z[n]^((p-5)/8) for n < lanes.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int hg_fe_pow22523(const void* z, void* out, int lanes,
                              void* stream) {
  if (lanes <= 0) return 0;
  const int blocks = (lanes * kPowGroup + kThreads - 1) / kThreads;
  fe_pow22523_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(z), static_cast<int64_t*>(out), lanes);
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__
