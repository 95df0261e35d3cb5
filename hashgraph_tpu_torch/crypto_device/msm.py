"""The Straus multi-scalar multiply over signature lanes.

Port of ``hashgraph_tpu/crypto_device/msm.py``. Batch verification reduces
to one curve equation: with fresh 128-bit randomizers z_i, accept the whole
batch iff

    8 * ( S*B + sum_i a_i*A_i + sum_i b_i*R_i ) == identity,

where S = sum z_i s_i (mod L), a_i = -z_i h_i (mod L), b_i = -z_i (mod L).
Negation happens in the scalar group, and the final multiply-by-8 (the
cofactored criterion) clears the small-order component that leaves, so the
device computation has no point negations.

Shape of the computation (Straus, interleaved 4-bit windows):

- every lane builds its 16-entry window table (T_k = T_{k-1} + P): 15
  point adds across all lanes;
- 64 windows, each 4 doublings then one gathered table add per lane
  (every lane's nibble indexes its own table);
- a binary-tree reduction folds the lane accumulators: lane i <- lane 2i +
  lane 2i+1, the lane count halving each step (odd counts padded with the
  identity), ceil(log2 lanes) steps at least one, which gives lane 0 the
  limbs of the JAX package's fixed-shape reduction;
- 3 doublings (the *8) and the projective identity test.

On the card the stages are two hand-written kernels (``csrc/ed_msm.cu``):
the window loop, and the tree with the ×8 and the identity test folded in
(:mod:`.cuda_msm`). The JAX package ran the MSM as one jitted program, and
an eager loop of point formulas would enqueue some 200,000 PyTorch
operator calls. The verdict stays on the device until :func:`msm_accepts`
reads it: one read per batch.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_msm, curve

WINDOWS = 64  # 4-bit windows over 256-bit scalars, MSB first


def scalars_to_nibbles(scalars: "list[int]") -> np.ndarray:
    """Host-side window decomposition: int32[n, 64], most significant
    nibble first (scalars already reduced mod L, so < 2^253)."""
    n = len(scalars)
    buf = np.frombuffer(
        b"".join(s.to_bytes(32, "little") for s in scalars), np.uint8
    ).reshape(n, 32)
    nibbles = np.empty((n, WINDOWS), np.uint8)
    nibbles[:, 0::2] = buf & 0xF        # little-endian nibble order
    nibbles[:, 1::2] = buf >> 4
    return nibbles[:, ::-1].astype(np.int32)  # MSB-first windows


def msm_is_identity(points: torch.Tensor, nibbles: torch.Tensor) -> torch.Tensor:
    """points: int64[Lanes, 4, 16], nibbles: int[Lanes, W] -> bool[] on
    the points' device (True iff 8 * sum_i scalar_i * point_i ==
    identity).

    On CUDA tensors the stages are the kernels of ``csrc/ed_msm.cu``
    (:mod:`.cuda_msm`): one window launch, then the tree and the final test
    in ``len(cuda_msm.tree_passes(...))`` launches (two at 16,384 lanes).
    On CPU tensors they are the plain versions below."""
    if points.device.type == "cpu":
        root = _reduce_plain(_windows_plain(points, nibbles))
        return _final_plain(root) != 0
    if points.device.type != "cuda":
        raise ValueError(f"msm_is_identity: unsupported device {points.device}")
    nibbles = nibbles.to(device=points.device, dtype=torch.int32).contiguous()
    _, verdict = cuda_msm.msm_reduce(cuda_msm.msm_windows(points, nibbles))
    return verdict != 0


def _windows_plain(points: torch.Tensor, nibbles: torch.Tensor) -> torch.Tensor:
    """The plain version of the window stage: per lane, the 16-entry table
    (table[0] = identity, table[k] = table[k-1] + P), then per window (MSB
    first) four doublings and one gathered table add. Returns the lane
    accumulators, int64[Lanes, 4, 16]."""
    lanes, dev = points.shape[0], points.device
    lane_iota = torch.arange(lanes, device=dev)
    ident = curve.identity((lanes,), dev)

    # Local, so the 16 x lanes x 512-byte table is freed when the stage is
    # done.
    table = torch.empty((16, lanes, 4, 16), dtype=torch.int64, device=dev)
    table[0] = ident
    acc = ident
    for k in range(1, 16):
        acc = curve.add(acc, points)
        table[k] = acc

    nib = nibbles.to(device=dev, dtype=torch.int64)
    acc = ident
    for w in range(nib.shape[1]):
        acc = curve.dbl(curve.dbl(curve.dbl(curve.dbl(acc))))
        acc = curve.add(acc, table[nib[:, w], lane_iota])
    return acc


def reduce_levels(lanes: int) -> "list[int]":
    """Point counts entering each level of the tree reduction: ceil(log2
    lanes) levels, at least one, each halving the count (rounded up)."""
    counts = []
    for _ in range((max(lanes, 2) - 1).bit_length()):
        counts.append(lanes)
        lanes = (lanes + 1) // 2
    return counts


def _reduce_plain(acc: torch.Tensor) -> torch.Tensor:
    """The plain version of the tree reduction: lane i <- lane 2i + lane
    2i+1 per level, an odd count padded with the identity. Returns the
    root, int64[4, 16] (the JAX package's fixed-shape tree leaves the same
    limbs in its lane 0)."""
    q = acc
    for _ in reduce_levels(acc.shape[0]):
        if q.shape[0] % 2:
            q = torch.cat([q, curve.identity((1,), q.device)])
        q = curve.add(q[0::2], q[1::2])
    return q[0]


def _final_plain(root: torch.Tensor) -> torch.Tensor:
    """The plain version of the final stage: int32[] 1 iff 8 * root is the
    identity."""
    for _ in range(3):
        root = curve.dbl(root)
    return curve.is_identity(root).to(torch.int32)


def msm_accepts(points, nibbles) -> bool:
    """Host entry: run the MSM and read the verdict."""
    return bool(msm_is_identity(points, nibbles))
