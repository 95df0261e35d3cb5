// The inverse-square-root exponent z^((p-5)/8) of point decompression as
// one launch, for Hopper (sm_90a).
//
// Replaces, for this chain, the TPU kernel hashgraph_tpu/crypto_device/
// pallas_msm.py::_mul_kernel: the JAX package runs field.pow22523 as 262
// Pallas products inside one jitted decompression. Here one thread owns one
// lane and runs fe25519.cuh's fe_pow22523 (251 squarings and 11 products)
// with every operand in registers; the plain PyTorch version is
// hashgraph_tpu_torch/crypto_device/field.py::_pow22523_plain, limb for
// limb.
//
// Contract. int64 [N, 16] in carried limbs in, the same out.
//
// Bound. Per lane 262 products of about 1,510 integer operations each
// (396 K) against 256 bytes moved: operations bound it. At the 8,192 lanes
// of a 4,096-signature batch one thread per lane leaves about two warps on
// an SM, so the chain's dependent products run at the pipeline's latency.

#include "fe25519.cuh"

__device__ __forceinline__ void pow22523_lane(const int64_t* z, int64_t* out) {
  uint32_t x[kLimbs], y[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) x[i] = static_cast<uint32_t>(z[i]);
  fe_pow22523(x, y);
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) out[i] = static_cast<int64_t>(y[i]);
}

// The launch code below needs nvcc (tests/test_torch_msm_kernel.py builds
// the lane routine above with a host compiler).
#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
fe_pow22523_kernel(const int64_t* __restrict__ z, int64_t* __restrict__ out,
                   int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t at = static_cast<size_t>(lane) * kLimbs;
  pow22523_lane(z + at, out + at);
}

}  // namespace

// C interface, loaded with ctypes: out[n] = z[n]^((p-5)/8) for n < lanes.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int hg_fe_pow22523(const void* z, void* out, int lanes,
                              void* stream) {
  if (lanes <= 0) return 0;
  fe_pow22523_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(z), static_cast<int64_t*>(out), lanes);
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__
