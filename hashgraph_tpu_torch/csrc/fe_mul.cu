// GF(2^255-19) field product in radix-2^16 limbs, for Hopper (sm_90a).
//
// Replaces the TPU kernel hashgraph_tpu/crypto_device/pallas_msm.py::
// _mul_kernel (launched by _fe_mul_tl) and computes what
// hashgraph_tpu/crypto_device/field.py::_mul_jnp computes, limb for limb;
// the plain PyTorch version beside it is hashgraph_tpu_torch/crypto_device/
// field.py::_mul_plain.
//
// Contract. Operands are int64 [N, 16], contiguous, little-endian limbs in
// carried form (every limb < 2^16). The output is carried too: every limb
// < 2^16, value < 2^256, not reduced mod p.
//
// Design. One thread owns one lane: both operands' 16 limbs and the 32
// product columns live in registers. Each 16x16-bit limb product is exact in
// 32 bits; its low half lands in column i+j and its high half in column
// i+j+1, so a column sums at most 32 halves (< 2^21), and the 2^256 === 38
// (mod p) fold of columns 16-31 keeps every limb below 2^27. All of that is
// exact in uint32, so the arithmetic runs on the 32-bit integer units and
// only the loads and stores are 64-bit. The carry is field.carry's: two
// carry-save passes, then two sequential passes, each folding 38 times the
// carry out of limb 15 into limb 0. The Pallas kernel's three sequential
// passes are not copied: a three-pass carry is not rigorous against crafted
// 0xFFFF ripples.
//
// Bound. Per lane the kernel reads 256 bytes and writes 128, and does 256
// 32-bit multiplies plus about 1,250 integer adds, masks and shifts for the
// columns, the fold and the carries. At 16,384 lanes that is 6.3 MB
// against 24.7 M integer operations: the bytes bound it, narrowly.
//
// The arithmetic is fe25519.cuh's __device__ fe_mul, which the MSM and the
// inverse-square-root chain run split across a group of threads inside
// their own kernels (fe25519_group.cuh; ed_msm.cu, fe_pow22523.cu). This
// standalone launch serves decompression's products outside the chain.

#include "fe25519.cuh"

// The launch code below needs nvcc; a host C++ compiler sees only the
// header's arithmetic, which is how a CPU test checks it against the plain
// version (tests/test_torch_crypto.py).
#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

__global__ void fe_mul_kernel(const int64_t* __restrict__ a,
                              const int64_t* __restrict__ b,
                              int64_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t base = static_cast<size_t>(lane) * kLimbs;
  uint32_t x[kLimbs], y[kLimbs], z[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    x[i] = static_cast<uint32_t>(a[base + i]);
    y[i] = static_cast<uint32_t>(b[base + i]);
  }
  fe_mul(x, y, z);
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) out[base + i] = static_cast<int64_t>(z[i]);
}

}  // namespace

// C interface, loaded with ctypes: out[n] = a[n] * b[n] for n < lanes.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int hg_fe_mul(const void* a, const void* b, void* out, int lanes,
                         void* stream) {
  if (lanes <= 0) return 0;
  constexpr int kThreads = 128;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  fe_mul_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(a), static_cast<const int64_t*>(b),
      static_cast<int64_t*>(out), lanes);
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__
