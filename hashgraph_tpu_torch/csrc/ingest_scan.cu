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
// vote. Rows whose id is >= P (the pad sentinel) read row P-1, as the
// reference's clipped gather does, and write nothing back to the pool. They
// run in a launch of their own before the real rows, so that what they read
// is the pool as it was before the dispatch even when slot P-1 is touched.
//
// Bound. The work is a few integer operations per vote; the kernel is bound
// by bytes: the packed grid, the slot ids, one mask and one value byte per
// vote, the row scalars and the int8 output. A simple kernel first: no
// shared-memory staging, TMA or warp cooperation yet.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename Cell>
__global__ void ingest_scan_kernel(
    int32_t* __restrict__ state, int32_t* __restrict__ yes,
    int32_t* __restrict__ tot, uint8_t* __restrict__ vote_mask,
    uint8_t* __restrict__ vote_val, const int32_t* __restrict__ n,
    const int32_t* __restrict__ req, const int32_t* __restrict__ cap,
    const uint8_t* __restrict__ gossip, const uint8_t* __restrict__ liveness,
    const int32_t* __restrict__ slot_pack, const Cell* __restrict__ grid,
    int8_t* __restrict__ out, int s_count, int depth, int p, int v,
    uint32_t lane_mask, int val_bit, int valid_bit, bool pad_phase) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= s_count) return;
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

  for (int l = 0; l < depth; ++l) {
    const uint32_t cell = static_cast<uint32_t>(cells[l]);
    const uint32_t lane = cell & lane_mask;
    const bool val = (cell >> val_bit) & 1u;
    const bool valid = (cell >> valid_bit) & 1u;
    const bool in_range = lane < static_cast<uint32_t>(v);

    const bool reached = st == kStateReachedYes || st == kStateReachedNo;
    const bool active = st == kStateActive;
    // Round projection (reference: src/session.rs:306-344).
    const int projected = rgossip ? 2 : tt + 1;
    const bool exceeded = projected > rcap;
    bool dup = in_range && mrow[lane] != 0;
    if (pad_row && !dup) {
      // A pad row never writes the pool, so its own earlier accepts are
      // read back from the statuses it has written (rare: the engine
      // sends no pad rows; this keeps the kernel exact for any input).
      const Cell* c = cells;
      for (int j = 0; j < l && !dup; ++j) {
        dup = orow[j] == kOk &&
              (static_cast<uint32_t>(c[j]) & lane_mask) == lane;
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
    orow[l] = static_cast<int8_t>(status);

    // A cap violation fails the session though the vote is rejected.
    if (valid && active && !expired && exceeded) st = kStateFailed;
    if (ok) {
      tt += 1;
      ys += val ? 1 : 0;
      if (!pad_row && in_range) {
        mrow[lane] = 1;
        vrow[lane] = val ? 1 : 0;
      }
      bool decided, result;
      decide(ys, tt, rn, rreq, rlive, &decided, &result);
      if (decided) st = result ? kStateReachedYes : kStateReachedNo;
    }
  }
  orow[depth] = static_cast<int8_t>(st);
  if (!pad_row) {
    state[slot] = st;
    yes[slot] = ys;
    tot[slot] = tt;
  }
}

template <typename Cell>
int launch(void* state, void* yes, void* tot, void* vote_mask, void* vote_val,
           const void* n, const void* req, const void* cap, const void* gossip,
           const void* liveness, const void* slot_pack, const void* grid,
           void* out, int s_count, int depth, int p, int v, int lane_mask,
           int val_bit, int valid_bit, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const int blocks = (s_count + kThreads - 1) / kThreads;
  // Pad rows first (they read the pool as it was), then the real rows.
  for (int phase = 1; phase >= 0; --phase) {
    ingest_scan_kernel<Cell><<<blocks, kThreads, 0, stream>>>(
        static_cast<int32_t*>(state), static_cast<int32_t*>(yes),
        static_cast<int32_t*>(tot), static_cast<uint8_t*>(vote_mask),
        static_cast<uint8_t*>(vote_val), static_cast<const int32_t*>(n),
        static_cast<const int32_t*>(req), static_cast<const int32_t*>(cap),
        static_cast<const uint8_t*>(gossip),
        static_cast<const uint8_t*>(liveness),
        static_cast<const int32_t*>(slot_pack),
        static_cast<const Cell*>(grid), static_cast<int8_t*>(out), s_count,
        depth, p, v, static_cast<uint32_t>(lane_mask), val_bit, valid_bit,
        phase == 1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// C interface, loaded with ctypes. cell_bytes selects the packed-grid
// layout: 1 = uint8, 2 = uint16 (sent as int16 bits), 4 = int32. Returns
// the cudaError_t of the launch (0 = success); s_count == 0 launches nothing.
extern "C" int hg_ingest_scan(void* state, void* yes, void* tot,
                              void* vote_mask, void* vote_val, const void* n,
                              const void* req, const void* cap,
                              const void* gossip, const void* liveness,
                              const void* slot_pack, const void* grid,
                              void* out, int s_count, int depth, int p, int v,
                              int cell_bytes, int lane_mask, int val_bit,
                              int valid_bit, void* stream) {
  if (s_count == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cell_bytes) {
    case 1:
      return launch<uint8_t>(state, yes, tot, vote_mask, vote_val, n, req, cap,
                             gossip, liveness, slot_pack, grid, out, s_count,
                             depth, p, v, lane_mask, val_bit, valid_bit, s);
    case 2:
      return launch<uint16_t>(state, yes, tot, vote_mask, vote_val, n, req,
                              cap, gossip, liveness, slot_pack, grid, out,
                              s_count, depth, p, v, lane_mask, val_bit,
                              valid_bit, s);
    case 4:
      return launch<int32_t>(state, yes, tot, vote_mask, vote_val, n, req, cap,
                             gossip, liveness, slot_pack, grid, out, s_count,
                             depth, p, v, lane_mask, val_bit, valid_bit, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
