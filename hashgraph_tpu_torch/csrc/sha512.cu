// SHA-512 challenge hashes of a device verification batch, for Hopper
// (sm_90a): k_i = SHA-512(R_i || A_i || M_i), one lane a thread.
//
// Replaces no TPU kernel: the JAX package leaves SHA-512 to XLA
// (hashgraph_tpu/crypto_device/sha512.py). The plain PyTorch version beside
// it, hashgraph_tpu_torch/crypto_device/sha512.py::_sha512_blocks, runs the
// 80 rounds a block as separate eager operators over (hi, lo) int64 halves:
// about 27,500 operator calls a batch, each enqueued from the host. On an
// H100 host that was about 480 ms of a 16,384-row signed frame, a third of
// the frame, while the card's share of it was a few milliseconds. This
// launch does the batch's hashes in one call.
//
// Contract. The batch is ragged: message i is data[offsets[i] ..
// offsets[i + 1]), offsets int64[lanes + 1] and data uint8, both in device
// memory. The output is int64[lanes, 16], contiguous: the eight state words
// of each digest as (hi, lo) 32-bit halves, the layout that
// crypto_device/sha512.py::digest_bytes reads and _sha512_blocks writes.
//
// Design. One thread owns one lane: it builds its own padded blocks in
// registers (the 0x80 byte, the zeros and the 128-bit bit length in its own
// final block) and walks only its own block count, so no padded buffer is
// built on the host. The state and the 16-word schedule window are 64-bit
// words in registers; the round constants sit in constant memory, read by
// every thread of a warp at the same index. The arithmetic is sha512.cuh's,
// which the CPU tests build with a host compiler.
//
// Bound. A block is 80 rounds of about 40 32-bit integer instructions
// (three 64-bit rotates and a 64-bit add are two each) and 64 schedule
// steps of about 22, some 4,600 instructions. At 16,384 lanes of 2 blocks
// that is about 1.5e8 instructions, about 4.5 us at the card's 3.35e13
// integer instructions a second, against about 3.3 MB read and 2.1 MB
// written (about 1.6 us at 3.35 TB/s): integer operations bound it.

#include "sha512.cuh"

// The launch code below needs nvcc; a host C++ compiler sees only the
// header's arithmetic.
#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // 256 blocks at 16,384 lanes, past the 132 SMs

__global__ void __launch_bounds__(kThreads)
sha512_kernel(const int64_t* __restrict__ offsets, const uint8_t* __restrict__ data,
              int64_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  sha512_ragged_lane(offsets, data, out, lane);
}

}  // namespace

// C interface, loaded with ctypes: out[i] = the digest halves of message i
// for i < lanes. Returns the cudaError_t of the launch (0 = success).
extern "C" int hg_sha512(const void* offsets, const void* data, void* out, int lanes,
                         void* stream) {
  if (lanes <= 0) return 0;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  sha512_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(offsets), static_cast<const uint8_t*>(data),
      static_cast<int64_t*>(out), lanes);
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__
