"""Copy of ``hashgraph_tpu/signing/_ed25519.py`` for the PyTorch port, which
imports nothing of the JAX package.

Pure-Python Ed25519 (RFC 8032): the port's signer, its scalar ``verify`` and
the host blame pass behind device batch verification wherever the native
runtime (:mod:`hashgraph_tpu_torch.native`) is absent.

Same key derivation and signatures as the native core and the JAX package,
and the same *cofactored* verification criterion — accept iff
``8·(s·B - h·A - R)`` is the identity — so every verifier of the repo gives
the same verdict on every input (the batch randomized-linear-combination
check is only sound for the cofactored equation, and scalar-vs-batch
verdict equivalence is part of the scheme conformance contract). Decoding
enforces RFC 8032 §5.1.3: non-canonical field encodings (y >= p) and a
non-canonical scalar (s >= L) are rejected.

Python-int arithmetic: correct and slow (a few milliseconds a signature).
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

_B_Y = (4 * pow(5, P - 2, P)) % P
_B_X = 15112221349535400772501151409588531511454012693041857206046113283949847762202
# Extended coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z, T = XY/Z.
_BASE = (_B_X, _B_Y, 1, (_B_X * _B_Y) % P)
_IDENTITY = (0, 1, 1, 0)


def _add(p1, q):
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * (2 * D) % P * t2 % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _dbl(p1):
    return _add(p1, p1)


def _mul(point, k: int):
    acc = _IDENTITY
    while k:
        if k & 1:
            acc = _add(acc, point)
        point = _dbl(point)
        k >>= 1
    return acc


def _neg(p1):
    x, y, z, t = p1
    return ((-x) % P, y, z, (-t) % P)


def _is_identity(p1) -> bool:
    x, y, z, _ = p1
    return x % P == 0 and (y - z) % P == 0


def _encode(p1) -> bytes:
    x, y, z, _ = p1
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def _decode(s: bytes):
    """Decoded point, or None (RFC 8032 §5.1.3 rejections)."""
    if len(s) != 32:
        return None
    val = int.from_bytes(s, "little")
    sign = val >> 255
    y = val & ((1 << 255) - 1)
    if y >= P:
        return None  # non-canonical field encoding
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = u * pow(v, 3, P) % P * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P) % P
    if v * x * x % P == u:
        pass
    elif v * x * x % P == (-u) % P:
        x = x * SQRT_M1 % P
    else:
        return None
    if x == 0 and sign:
        return None
    if (x & 1) != sign:
        x = P - x
    return (x, y, 1, x * y % P)


def _clamp(h: bytes) -> int:
    a = bytearray(h[:32])
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    return int.from_bytes(a, "little")


def public_key(seed: bytes) -> bytes:
    a = _clamp(hashlib.sha512(seed).digest())
    return _encode(_mul(_BASE, a))


def sign(seed: bytes, message: bytes) -> bytes:
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    prefix = h[32:]
    pub = _encode(_mul(_BASE, a))
    r = int.from_bytes(hashlib.sha512(prefix + message).digest(), "little") % L
    r_enc = _encode(_mul(_BASE, r))
    k = int.from_bytes(
        hashlib.sha512(r_enc + pub + message).digest(), "little"
    ) % L
    s = (r + k * a) % L
    return r_enc + int.to_bytes(s, 32, "little")


def verify(pub: bytes, message: bytes, signature: bytes) -> bool:
    if len(signature) != 64:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False  # non-canonical scalar (malleable form)
    a_pt = _decode(pub)
    if a_pt is None:
        return False
    r_pt = _decode(signature[:32])
    if r_pt is None:
        return False
    k = int.from_bytes(
        hashlib.sha512(signature[:32] + pub + message).digest(), "little"
    ) % L
    q = _add(_mul(_BASE, s), _neg(_add(_mul(a_pt, k), r_pt)))
    return _is_identity(_dbl(_dbl(_dbl(q))))
