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

The verdict stays on the device until :func:`msm_accepts` reads it: one
read per batch.
"""

from __future__ import annotations

import numpy as np
import torch

from . import curve

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
    """points: int64[Lanes, 4, 16], nibbles: int[Lanes, 64] on the same
    device -> bool[] (True iff 8 * sum_i scalar_i * point_i == identity)."""
    lanes, dev = points.shape[0], points.device
    lane_iota = torch.arange(lanes, device=dev)
    ident = curve.identity((lanes,), dev)

    # Window tables: table[k] = k * P per lane, k = 0..15. Local, so the
    # 16 x lanes x 512-byte table is freed when the batch is done.
    table = torch.empty((16, lanes, 4, 16), dtype=torch.int64, device=dev)
    table[0] = ident
    acc = ident
    for k in range(1, 16):
        acc = curve.add(acc, points)
        table[k] = acc

    nib = nibbles.to(device=dev, dtype=torch.int64)
    acc = ident
    for w in range(WINDOWS):
        acc = curve.dbl(curve.dbl(curve.dbl(curve.dbl(acc))))
        acc = curve.add(acc, table[nib[:, w], lane_iota])
    del table

    q = acc
    steps = max(1, int(np.ceil(np.log2(max(lanes, 2)))))
    for _ in range(steps):
        if q.shape[0] % 2:
            q = torch.cat([q, curve.identity((1,), dev)])
        q = curve.add(q[0::2], q[1::2])
    total = q[:1]
    for _ in range(3):
        total = curve.dbl(total)
    return curve.is_identity(total[0])


def msm_accepts(points, nibbles) -> bool:
    """Host entry: run the MSM and read the verdict."""
    return bool(msm_is_identity(points, nibbles))
