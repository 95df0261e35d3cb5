// Arrival-ordered vote scan over touched pool rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel hashgraph_tpu/ops/pallas_ingest.py::
// _ingest_block_kernel (launched by pallas_ingest_rows) and computes what
// hashgraph_tpu/ops/ingest.py::ingest_body computes, bit for bit; the plain
// PyTorch version beside it is hashgraph_tpu_torch/ops/ingest.py::
// ingest_body.
//
// Design. One thread owns one touched row and walks its L votes in arrival
// order: the vote chain of one proposal is a sequential state machine
// (each vote's status depends on the tallies the previous votes left), and
// rows are independent because a dispatch never repeats a slot. The thread
// reads and writes the pool tensors in place by slot id, so the gather and
// scatter that the Pallas wrapper leaves to XLA are fused in, and it indexes
// mask[slot, lane] directly where the Pallas kernel paid an O(V) one-hot per
// vote.
//
// A row's time is its memory latencies, so the walk starts its loads
// together before it starts: the row scalars and the cells (as 16-, 8- or
// 4-byte vectors where the row's alignment allows) at once, then the mask
// byte of every cell's lane, all independent, for up to 32 votes held
// in registers. The walk then runs on those copies; a vote whose lane an
// earlier vote of the same chunk accepted is a duplicate, found against the
// chunk's own accepts. The accepted lanes' mask and value bytes are written
// back at the end of the chunk (every chunk, for the depth of config 2's
// one-row calls), so a row costs about two dependent memory latencies a
// chunk instead of two a vote.
//
// Rows whose id is >= P (the pad sentinel) read row P-1, as the
// reference's clipped gather does, and write nothing back to the pool. They
// run in a launch of their own before the real rows, so that what they read
// is the pool as it was before the dispatch even when slot P-1 is touched;
// the wrapper asks for that launch only when the host says the batch holds
// pad rows (the engine sends none), so a call is one launch.
//
// Bound. The work is a few integer operations per vote; the kernel is bound
// by bytes: the packed grid, the slot ids, one mask and one value byte per
// vote, the row scalars and the int8 output.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
// A host C++ compiler builds the per-row walk too (everything outside the
// __CUDACC__ launch block below), which is how the CPU tests hold it
// against the plain scan (tests/test_torch_ingest.py).
#define __device__
#define __forceinline__ inline
struct uint4 { uint32_t x, y, z, w; };
struct uint2 { uint32_t x, y; };
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return uint4{x, y, z, w};
}
inline uint2 make_uint2(uint32_t x, uint32_t y) { return uint2{x, y}; }
#endif

namespace {

// Slot lifecycle codes (hashgraph_tpu_torch/ops/decide.py).
constexpr int kStateActive = 1;
constexpr int kStateFailed = 2;
constexpr int kStateReachedNo = 3;
constexpr int kStateReachedYes = 4;

// Status codes (hashgraph_tpu_torch/errors.py StatusCode); a CPU test
// checks these against the Python enum.
constexpr int kPadStatus = -1;
constexpr int kOk = 0;
constexpr int kDuplicateVote = 7;
constexpr int kProposalExpired = 13;
constexpr int kSessionNotActive = 19;
constexpr int kMaxRoundsExceeded = 24;
constexpr int kAlreadyReached = 28;

constexpr int32_t kSlotMask = (1 << 30) - 1;
constexpr int kExpiredBit = 30;

// calculate_consensus_result with is_timeout = false
// (hashgraph_tpu_torch/ops/decide.py::decide_kernel).
__device__ __forceinline__ void decide(int yes, int tot, int n, int req,
                                       bool live, bool* decided,
                                       bool* result) {
  if (n <= 2) {
    *decided = tot >= n;
    *result = yes == n;
    return;
  }
  const int no = tot - yes;
  const int silent = n - tot > 0 ? n - tot : 0;
  const int yes_w = yes + (live ? silent : 0);
  const int no_w = no + (live ? 0 : silent);
  const bool yes_win = yes_w >= req && yes_w > no_w;
  const bool no_win = no_w >= req && no_w > yes_w;
  const bool tie = tot == n && yes_w == no_w;
  *decided = tot >= req && (yes_win || no_win || tie);
  *result = yes_win || (!no_win && live);
}

// Votes a thread holds in registers at once: 8 for rows of depth <= 8 (the
// main path's waves), else 32.
constexpr int kShortChunk = 8;
constexpr int kLongChunk = 32;

// Cell l of a chunk held as 32-bit words (l is a compile-time index in the
// unrolled loops below, so the words stay in registers).
template <typename Cell>
__device__ __forceinline__ uint32_t cell_at(const uint32_t* w, int l) {
  constexpr int kPer = 4 / static_cast<int>(sizeof(Cell));
  constexpr uint32_t kBits = 8 * sizeof(Cell);
  if (kPer == 1) return w[l];
  return (w[l / kPer] >> (kBits * (l % kPer))) & ((1u << kBits) - 1u);
}

// The first n cells of a chunk (n <= Chunk) as words, read in vectors of
// up to `vec` bytes. `vec` divides the row's byte length and the grid's
// address, and a chunk starts at the row's start or at a multiple of 32
// bytes, so every vector lies inside the row.
template <typename Cell, int Chunk>
__device__ __forceinline__ void load_chunk(
    const Cell* __restrict__ src, int n, int vec,
    uint32_t (&w)[Chunk * sizeof(Cell) / 4]) {
  constexpr int kWords = Chunk * static_cast<int>(sizeof(Cell)) / 4;
  const int nbytes = n * static_cast<int>(sizeof(Cell));
  if (kWords >= 4 && vec == 16) {
    const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int q = 0; q < kWords / 4; ++q) {
      const uint4 x = 16 * q < nbytes ? v[q] : make_uint4(0, 0, 0, 0);
      w[4 * q] = x.x; w[4 * q + 1] = x.y; w[4 * q + 2] = x.z; w[4 * q + 3] = x.w;
    }
  } else if (kWords >= 2 && vec >= 8) {
    const uint2* v = reinterpret_cast<const uint2*>(src);
#pragma unroll
    for (int q = 0; q < kWords / 2; ++q) {
      const uint2 x = 8 * q < nbytes ? v[q] : make_uint2(0, 0);
      w[2 * q] = x.x; w[2 * q + 1] = x.y;
    }
  } else if (vec >= 4) {
    const uint32_t* v = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int q = 0; q < kWords; ++q) w[q] = 4 * q < nbytes ? v[q] : 0u;
  } else {
    const uint8_t* b = reinterpret_cast<const uint8_t*>(src);
#pragma unroll
    for (int q = 0; q < kWords; ++q) w[q] = 0u;
#pragma unroll
    for (int k = 0; k < 4 * kWords; ++k)
      if (k < nbytes) w[k / 4] |= static_cast<uint32_t>(b[k]) << (8 * (k % 4));
  }
}

// The widest vector (16, 8, 4 or 1 bytes) that divides both a row's byte
// length and the grid's address.
inline int vec_width(uintptr_t grid, size_t row_bytes) {
  const uintptr_t align = grid | static_cast<uintptr_t>(row_bytes);
  return align % 16 == 0 ? 16 : align % 8 == 0 ? 8 : align % 4 == 0 ? 4 : 1;
}

// Row r of the dispatch, in the launch of pad rows (pad_phase) or of real
// rows: the other kind of row returns at once.
template <typename Cell, int Chunk>
__device__ __forceinline__ void scan_row(
    int r, int32_t* __restrict__ state, int32_t* __restrict__ yes,
    int32_t* __restrict__ tot, uint8_t* __restrict__ vote_mask,
    uint8_t* __restrict__ vote_val, const int32_t* __restrict__ n,
    const int32_t* __restrict__ req, const int32_t* __restrict__ cap,
    const uint8_t* __restrict__ gossip, const uint8_t* __restrict__ liveness,
    const int32_t* __restrict__ slot_pack, const Cell* __restrict__ grid,
    int8_t* __restrict__ out, int depth, int p, int v, uint32_t lane_mask,
    int val_bit, int valid_bit, int vec, bool pad_phase) {
  constexpr int kWords = Chunk * static_cast<int>(sizeof(Cell)) / 4;
  const int32_t packed = slot_pack[r];
  const int slot = packed & kSlotMask;
  const bool expired = (packed >> kExpiredBit) & 1;
  const bool pad_row = slot >= p;
  if (pad_row != pad_phase) return;
  const int row = pad_row ? p - 1 : slot;

  int st = state[row];
  int ys = yes[row];
  int tt = tot[row];
  const int rn = n[row];
  const int rreq = req[row];
  const int rcap = cap[row];
  const bool rgossip = gossip[row] != 0;
  const bool rlive = liveness[row] != 0;
  uint8_t* mrow = vote_mask + static_cast<size_t>(row) * v;
  uint8_t* vrow = vote_val + static_cast<size_t>(row) * v;
  const Cell* cells = grid + static_cast<size_t>(r) * depth;
  int8_t* orow = out + static_cast<size_t>(r) * (depth + 1);

  for (int c0 = 0; c0 < depth; c0 += Chunk) {
    const int cnt = depth - c0 < Chunk ? depth - c0 : Chunk;
    uint32_t w[kWords];
    load_chunk<Cell, Chunk>(cells + c0, cnt, vec, w);
    // Every mask byte the chunk needs, as independent loads.
    uint8_t seen[Chunk];
#pragma unroll
    for (int l = 0; l < Chunk; ++l) {
      const uint32_t lane = cell_at<Cell>(w, l) & lane_mask;
      seen[l] = l < cnt && lane < static_cast<uint32_t>(v) ? mrow[lane] : 0;
    }
    uint32_t accepted = 0;  // bit l: vote l of the chunk accepted
    uint64_t lanes_hit = 0;  // bit (lane & 63) of every accepted lane
#pragma unroll
    for (int l = 0; l < Chunk; ++l) {
      if (l < cnt) {
        const uint32_t cell = cell_at<Cell>(w, l);
        const uint32_t lane = cell & lane_mask;
        const bool val = (cell >> val_bit) & 1u;
        const bool valid = (cell >> valid_bit) & 1u;
        const bool in_range = lane < static_cast<uint32_t>(v);

        const bool reached = st == kStateReachedYes || st == kStateReachedNo;
        const bool active = st == kStateActive;
        // Round projection (reference: src/session.rs:306-344).
        const int projected = rgossip ? 2 : tt + 1;
        const bool exceeded = projected > rcap;
        bool dup = in_range && seen[l] != 0;
        if (in_range && !dup && ((lanes_hit >> (lane & 63)) & 1)) {
#pragma unroll
          for (int j = 0; j < l; ++j)
            dup |= ((accepted >> j) & 1) &&
                   (cell_at<Cell>(w, j) & lane_mask) == lane;
        }
        if (pad_row && in_range && !dup) {
          // A pad row never writes the pool, so its accepts of earlier
          // chunks are read back from the statuses it has written (rare:
          // the engine sends no pad rows; this keeps the kernel exact for
          // any input).
          for (int j = 0; j < c0 && !dup; ++j) {
            dup = orow[j] == kOk &&
                  (static_cast<uint32_t>(cells[j]) & lane_mask) == lane;
          }
        }

        const bool ok = valid && active && !expired && !exceeded && !dup;
        int status;
        if (!valid) status = kPadStatus;
        else if (reached) status = kAlreadyReached;
        else if (!active) status = kSessionNotActive;
        else if (expired) status = kProposalExpired;
        else if (exceeded) status = kMaxRoundsExceeded;
        else if (dup) status = kDuplicateVote;
        else status = kOk;
        orow[c0 + l] = static_cast<int8_t>(status);

        // A cap violation fails the session though the vote is rejected.
        if (valid && active && !expired && exceeded) st = kStateFailed;
        if (ok) {
          tt += 1;
          ys += val ? 1 : 0;
          if (in_range) {
            accepted |= 1u << l;
            lanes_hit |= 1ull << (lane & 63);
          }
          bool decided, result;
          decide(ys, tt, rn, rreq, rlive, &decided, &result);
          if (decided) st = result ? kStateReachedYes : kStateReachedNo;
        }
      }
    }
    if (!pad_row && accepted) {
#pragma unroll
      for (int l = 0; l < Chunk; ++l) {
        if ((accepted >> l) & 1) {
          const uint32_t cell = cell_at<Cell>(w, l);
          const uint32_t lane = cell & lane_mask;
          mrow[lane] = 1;
          vrow[lane] = (cell >> val_bit) & 1u;
        }
      }
    }
  }
  orow[depth] = static_cast<int8_t>(st);
  if (!pad_row) {
    state[slot] = st;
    yes[slot] = ys;
    tot[slot] = tt;
  }
}

}  // namespace

// The launch code below needs nvcc; a host C++ compiler sees only the walk
// above (tests/test_torch_ingest.py).
#ifdef __CUDACC__

namespace {

template <typename Cell, int Chunk>
__global__ void ingest_scan_kernel(
    int32_t* __restrict__ state, int32_t* __restrict__ yes,
    int32_t* __restrict__ tot, uint8_t* __restrict__ vote_mask,
    uint8_t* __restrict__ vote_val, const int32_t* __restrict__ n,
    const int32_t* __restrict__ req, const int32_t* __restrict__ cap,
    const uint8_t* __restrict__ gossip, const uint8_t* __restrict__ liveness,
    const int32_t* __restrict__ slot_pack, const Cell* __restrict__ grid,
    int8_t* __restrict__ out, int s_count, int depth, int p, int v,
    uint32_t lane_mask, int val_bit, int valid_bit, int vec, bool pad_phase) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= s_count) return;
  scan_row<Cell, Chunk>(r, state, yes, tot, vote_mask, vote_val, n, req, cap, gossip,
                 liveness, slot_pack, grid, out, depth, p, v, lane_mask,
                 val_bit, valid_bit, vec, pad_phase);
}

template <typename Cell>
int launch(void* state, void* yes, void* tot, void* vote_mask, void* vote_val,
           const void* n, const void* req, const void* cap, const void* gossip,
           const void* liveness, const void* slot_pack, const void* grid,
           void* out, int s_count, int depth, int p, int v, int lane_mask,
           int val_bit, int valid_bit, bool has_pad, int* launched,
           cudaStream_t stream) {
  // One warp a block: the main path's 10,000 rows then spread over every
  // SM (313 blocks) instead of 79 blocks of 128 threads.
  constexpr int kThreads = 32;
  const int blocks = (s_count + kThreads - 1) / kThreads;
  const int vec = vec_width(reinterpret_cast<uintptr_t>(grid),
                            static_cast<size_t>(depth) * sizeof(Cell));
  // Pad rows first (they read the pool as it was), then the real rows.
  auto kernel = depth <= kShortChunk ? ingest_scan_kernel<Cell, kShortChunk>
                                     : ingest_scan_kernel<Cell, kLongChunk>;
  for (int phase = has_pad ? 1 : 0; phase >= 0; --phase) {
    kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<int32_t*>(state), static_cast<int32_t*>(yes),
        static_cast<int32_t*>(tot), static_cast<uint8_t*>(vote_mask),
        static_cast<uint8_t*>(vote_val), static_cast<const int32_t*>(n),
        static_cast<const int32_t*>(req), static_cast<const int32_t*>(cap),
        static_cast<const uint8_t*>(gossip),
        static_cast<const uint8_t*>(liveness),
        static_cast<const int32_t*>(slot_pack),
        static_cast<const Cell*>(grid), static_cast<int8_t*>(out), s_count,
        depth, p, v, static_cast<uint32_t>(lane_mask), val_bit, valid_bit,
        vec, phase == 1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  return 0;
}

}  // namespace

// C interface, loaded with ctypes. cell_bytes selects the packed-grid
// layout: 1 = uint8, 2 = uint16 (sent as int16 bits), 4 = int32. has_pad
// non-zero adds the pad-row launch before the real rows'. Sets *launched
// to the number of kernels launched and returns the cudaError_t of the
// launches (0 = success); s_count == 0 launches nothing.
extern "C" int hg_ingest_scan(void* state, void* yes, void* tot,
                              void* vote_mask, void* vote_val, const void* n,
                              const void* req, const void* cap,
                              const void* gossip, const void* liveness,
                              const void* slot_pack, const void* grid,
                              void* out, int s_count, int depth, int p, int v,
                              int cell_bytes, int lane_mask, int val_bit,
                              int valid_bit, int has_pad, int* launched,
                              void* stream) {
  *launched = 0;
  if (s_count == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pad = has_pad != 0;
  switch (cell_bytes) {
    case 1:
      return launch<uint8_t>(state, yes, tot, vote_mask, vote_val, n, req, cap,
                             gossip, liveness, slot_pack, grid, out, s_count,
                             depth, p, v, lane_mask, val_bit, valid_bit, pad,
                             launched, s);
    case 2:
      return launch<uint16_t>(state, yes, tot, vote_mask, vote_val, n, req,
                              cap, gossip, liveness, slot_pack, grid, out,
                              s_count, depth, p, v, lane_mask, val_bit,
                              valid_bit, pad, launched, s);
    case 4:
      return launch<int32_t>(state, yes, tot, vote_mask, vote_val, n, req, cap,
                             gossip, liveness, slot_pack, grid, out, s_count,
                             depth, p, v, lane_mask, val_bit, valid_bit, pad,
                             launched, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif  // __CUDACC__
