"""edwards25519 point arithmetic and batched decompression over lanes.

Port of ``hashgraph_tpu/crypto_device/curve.py``. Points are extended
twisted-Edwards coordinates stacked as ``int64[..., 4, 16]`` — (X, Y, Z, T)
with x = X/Z, y = Y/Z, T = XY/Z — the coordinates of the host twin
(``signing/_ed25519.py``), computed with the same formulas in the same
order as the JAX package, so the limbs agree exactly. The addition law is
the unified a=-1 formula (complete for d non-square): one code path adds,
doubles and absorbs the identity, so heterogeneous lanes run in lockstep.

Decompression runs every lane's RFC 8032 5.1.3 x-recovery as one
``field.pow22523`` chain. Rejections (y >= p, no square root, x = 0 with the
sign bit set) come back as per-lane flags, never exceptions, and rejected
lanes hold the identity.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field as fe
from .field import LIMBS

_B_Y = (4 * pow(5, fe.P - 2, fe.P)) % fe.P
_B_X = 15112221349535400772501151409588531511454012693041857206046113283949847762202

BASE_AFFINE = np.stack([
    fe._int_to_limbs(_B_X),
    fe._int_to_limbs(_B_Y),
    fe._int_to_limbs(1),
    fe._int_to_limbs((_B_X * _B_Y) % fe.P),
])

IDENTITY = np.stack([
    fe._int_to_limbs(0),
    fe._int_to_limbs(1),
    fe._int_to_limbs(1),
    fe._int_to_limbs(0),
])


def identity(batch_shape=(), device="cpu") -> torch.Tensor:
    return fe.on_device(IDENTITY, device).expand(*batch_shape, 4, LIMBS)


def base_point(batch_shape=(), device="cpu") -> torch.Tensor:
    return fe.on_device(BASE_AFFINE, device).expand(*batch_shape, 4, LIMBS)


def add(p, q):
    """Unified extended addition (add-2008-hwcd-3, a=-1), as the host
    twin's _add: same intermediates, same 2d constant."""
    x1, y1, z1, t1 = p.unbind(-2)
    x2, y2, z2, t2 = q.unbind(-2)
    a = fe.mul(fe.sub(y1, x1), fe.sub(y2, x2))
    b = fe.mul(fe.add(y1, x1), fe.add(y2, x2))
    c = fe.mul(fe.mul(t1, fe.const(fe.D2, t1.shape[:-1], t1.device)), t2)
    zz = fe.mul(z1, z2)
    d = fe.add(zz, zz)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return torch.stack(
        [fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h)], dim=-2
    )


def dbl(p):
    """Dedicated doubling (dbl-2008-hwcd, a=-1): 4 squarings and 4
    products against the unified add's 9 products."""
    x1, y1, z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    a = fe.sqr(x1)
    b = fe.sqr(y1)
    zz = fe.sqr(z1)
    c = fe.add(zz, zz)
    e = fe.sub(fe.sub(fe.sqr(fe.add(x1, y1)), a), b)
    g = fe.sub(b, a)                 # a=-1: D + B with D = -A
    f = fe.sub(g, c)
    h = fe.sub(fe.sub(fe.const(fe.ZERO, a.shape[:-1], a.device), a), b)  # -(A+B)
    return torch.stack(
        [fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h)], dim=-2
    )


def is_identity(p):
    """Projective identity test: X == 0 and Y == Z (exact mod p)."""
    x, y, z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    return fe.is_zero(x) & fe.eq(y, z)


def decompress(enc):
    """RFC 8032 5.1.3 batched point decompression.

    ``enc``: uint8[..., 32] little-endian encodings. Returns ``(points,
    ok)`` where ``ok`` is False for every 5.1.3 rejection: non-canonical y
    (>= p), no square root, or x = 0 with the sign bit set. Rejected lanes
    hold the identity."""
    sign = (enc[..., 31] >> 7).to(torch.int64)
    masked = torch.cat([enc[..., :31], (enc[..., 31] & 0x7F)[..., None]], dim=-1)
    canonical = fe.is_canonical_fe(masked)
    y = fe.from_bytes(masked)
    batch, dev = y.shape[:-1], y.device
    one = fe.const(fe.ONE, batch, dev)
    zero = fe.const(fe.ZERO, batch, dev)
    yy = fe.sqr(y)
    u = fe.sub(yy, one)                                    # y^2 - 1
    v = fe.add(fe.mul(fe.const(fe.D, batch, dev), yy), one)  # d y^2 + 1
    v3 = fe.mul(fe.sqr(v), v)
    v7 = fe.mul(fe.sqr(v3), v)
    x = fe.mul(fe.mul(u, v3), fe.pow22523(fe.mul(u, v7)))
    vxx = fe.mul(v, fe.sqr(x))
    root_ok = fe.eq(vxx, u)
    neg_ok = fe.eq(vxx, fe.sub(zero, u))
    x = torch.where(root_ok[..., None], x, fe.mul(x, fe.const(fe.SQRT_M1, batch, dev)))
    has_root = root_ok | neg_ok
    x = fe.canon(x)
    # x = 0 with the sign bit set is a rejection (no valid negative zero).
    sign_reject = fe.is_zero(x) & (sign == 1)
    flip = (fe.parity(x) != sign)[..., None]
    x = torch.where(flip, fe.sub(zero, x), x)
    ok = canonical & has_root & ~sign_reject
    point = torch.stack([x, y, one.expand_as(x), fe.mul(x, y)], dim=-2)
    return torch.where(ok[..., None, None], point, identity(batch, dev)), ok
