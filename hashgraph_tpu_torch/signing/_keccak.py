"""Copy of ``hashgraph_tpu/signing/_keccak.py`` for the PyTorch port, which
imports nothing of the JAX package.

Pure-Python Keccak-256 (the pre-NIST padding Ethereum uses).

Implemented from the Keccak specification; used for Ethereum address
derivation and EIP-191 message hashing. Distinct from SHA3-256 only in the
domain-separation/padding byte (0x01 here vs 0x06 for SHA3).

Host-side only; the TPU path never hashes on device. The optional native
runtime (hashgraph_tpu.native) provides a batched C++ implementation.
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1

_ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# Rotation offsets r[x][y] laid out per lane index (x + 5*y).
_ROTATIONS = (
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
)


def _rotl(value: int, shift: int) -> int:
    if shift == 0:
        return value
    return ((value << shift) | (value >> (64 - shift))) & _MASK64


def _keccak_f1600(lanes: list[int]) -> None:
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [
            lanes[x] ^ lanes[x + 5] ^ lanes[x + 10] ^ lanes[x + 15] ^ lanes[x + 20]
            for x in range(5)
        ]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            dx = d[x]
            for y in range(0, 25, 5):
                lanes[x + y] ^= dx
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                # B[y, 2x+3y] = rot(A[x, y])
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(
                    lanes[x + 5 * y], _ROTATIONS[x + 5 * y]
                )
        # chi
        for y in range(0, 25, 5):
            row = b[y : y + 5]
            for x in range(5):
                lanes[x + y] = row[x] ^ ((~row[(x + 1) % 5]) & row[(x + 2) % 5])
        # iota
        lanes[0] ^= rc


def keccak256(data: bytes) -> bytes:
    """Keccak-256 digest of ``data`` (32 bytes)."""
    rate = 136  # bytes, for 256-bit output
    lanes = [0] * 25

    # Absorb full blocks.
    offset = 0
    length = len(data)
    while length - offset >= rate:
        block = data[offset : offset + rate]
        for i in range(rate // 8):
            lanes[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        _keccak_f1600(lanes)
        offset += rate

    # Pad final block: Keccak pad10*1 with domain byte 0x01.
    block = bytearray(rate)
    tail = data[offset:]
    block[: len(tail)] = tail
    block[len(tail)] ^= 0x01
    block[rate - 1] ^= 0x80
    for i in range(rate // 8):
        lanes[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
    _keccak_f1600(lanes)

    out = bytearray()
    for i in range(4):  # 4 lanes = 32 bytes
        out += lanes[i].to_bytes(8, "little")
    return bytes(out)
