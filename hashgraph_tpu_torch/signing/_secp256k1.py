"""Copy of ``hashgraph_tpu/signing/_secp256k1.py`` for the PyTorch port, which
imports nothing of the JAX package.

Pure-Python secp256k1 ECDSA with public-key recovery.

Provides deterministic (RFC 6979) signing and recovery-based verification —
the primitive the Ethereum scheme needs (65-byte r||s||v signatures, address
recovery). Jacobian-coordinate arithmetic with a fixed-base window table for
the generator keeps host signing fast enough for tests; bulk verification is
the job of the optional native runtime.
"""

from __future__ import annotations

import hashlib
import hmac

# Curve parameters (SEC 2).
P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

_HALF_N = N // 2

# Points are (X, Y, Z) Jacobian triples; Z == 0 encodes infinity.
_INF = (0, 1, 0)


def _jacobian_double(point):
    x1, y1, z1 = point
    if z1 == 0 or y1 == 0:
        return _INF
    a = (x1 * x1) % P
    b = (y1 * y1) % P
    c = (b * b) % P
    d = (2 * ((x1 + b) * (x1 + b) - a - c)) % P
    e = (3 * a) % P
    f = (e * e) % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = (2 * y1 * z1) % P
    return (x3, y3, z3)


def _jacobian_add(p1, p2):
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    if z1 == 0:
        return p2
    if z2 == 0:
        return p1
    z1z1 = (z1 * z1) % P
    z2z2 = (z2 * z2) % P
    u1 = (x1 * z2z2) % P
    u2 = (x2 * z1z1) % P
    s1 = (y1 * z2 * z2z2) % P
    s2 = (y2 * z1 * z1z1) % P
    if u1 == u2:
        if s1 != s2:
            return _INF
        return _jacobian_double(p1)
    h = (u2 - u1) % P
    i = (4 * h * h) % P
    j = (h * i) % P
    r = (2 * (s2 - s1)) % P
    v = (u1 * i) % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * s1 * j) % P
    z3 = (2 * h * z1 * z2) % P
    return (x3, y3, z3)


def _to_affine(point):
    x, y, z = point
    if z == 0:
        return None
    z_inv = pow(z, P - 2, P)
    z_inv2 = (z_inv * z_inv) % P
    return ((x * z_inv2) % P, (y * z_inv2 * z_inv) % P)


def _jacobian_mul(point, scalar):
    scalar %= N
    if scalar == 0:
        return _INF
    result = _INF
    addend = point
    while scalar:
        if scalar & 1:
            result = _jacobian_add(result, addend)
        addend = _jacobian_double(addend)
        scalar >>= 1
    return result


# Fixed-base 4-bit window table for G: _G_WINDOWS[w][d] = (16^w * d) * G.
_WINDOW_BITS = 4
_NUM_WINDOWS = 64


def _build_g_table():
    table = []
    base = (GX, GY, 1)
    for _ in range(_NUM_WINDOWS):
        row = [_INF]
        acc = _INF
        for _ in range(15):
            acc = _jacobian_add(acc, base)
            row.append(acc)
        table.append(row)
        for _ in range(_WINDOW_BITS):
            base = _jacobian_double(base)
    return table


_G_TABLE = _build_g_table()


def _g_mul(scalar):
    """Fixed-base multiply scalar * G using the precomputed window table."""
    scalar %= N
    result = _INF
    for w in range(_NUM_WINDOWS):
        digit = (scalar >> (w * _WINDOW_BITS)) & 0xF
        if digit:
            result = _jacobian_add(result, _G_TABLE[w][digit])
    return result


def pubkey_from_private(private_key: int) -> tuple[int, int]:
    """Affine public key point for a private scalar."""
    point = _to_affine(_g_mul(private_key))
    if point is None:
        raise ValueError("invalid private key")
    return point


def _rfc6979_k(msg_hash: bytes, private_key: int) -> int:
    """Deterministic nonce per RFC 6979 with HMAC-SHA256."""
    holen = 32
    x = private_key.to_bytes(32, "big")
    h1 = msg_hash
    v = b"\x01" * holen
    k = b"\x00" * holen
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        candidate = int.from_bytes(v, "big")
        if 1 <= candidate < N:
            return candidate
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign_recoverable(msg_hash: bytes, private_key: int) -> tuple[int, int, int]:
    """ECDSA-sign a 32-byte digest; returns (r, s, recovery_id) with low-s."""
    z = int.from_bytes(msg_hash, "big")
    while True:
        k = _rfc6979_k(msg_hash, private_key)
        point = _to_affine(_g_mul(k))
        if point is None:
            continue
        rx, ry = point
        r = rx % N
        if r == 0:
            continue
        s = (pow(k, N - 2, N) * (z + r * private_key)) % N
        if s == 0:
            continue
        recovery_id = (ry & 1) | (2 if rx >= N else 0)
        if s > _HALF_N:
            s = N - s
            recovery_id ^= 1
        return r, s, recovery_id


def recover_pubkey(msg_hash: bytes, r: int, s: int, recovery_id: int) -> tuple[int, int] | None:
    """Recover the affine public key from a recoverable signature, or None."""
    if not (1 <= r < N and 1 <= s < N) or not (0 <= recovery_id <= 3):
        return None
    x = r + (recovery_id >> 1) * N
    if x >= P:
        return None
    # Lift x to a curve point: y^2 = x^3 + 7.
    alpha = (pow(x, 3, P) + 7) % P
    y = pow(alpha, (P + 1) // 4, P)
    if (y * y) % P != alpha:
        return None
    if (y & 1) != (recovery_id & 1):
        y = P - y
    z = int.from_bytes(msg_hash, "big")
    r_inv = pow(r, N - 2, N)
    # Q = r^-1 (s*R - z*G)
    sr = _jacobian_mul((x, y, 1), s)
    zg = _g_mul((-z) % N)
    q = _jacobian_mul(_jacobian_add(sr, zg), r_inv)
    return _to_affine(q)
