"""GF(2^255-19) arithmetic in radix-2^16 limbs held as ``torch.int64``.

Port of ``hashgraph_tpu/crypto_device/field.py``: the same radix, the same
little-endian limb layout ``[..., 16]`` and the same carry chain, so every
function here returns the JAX package's limbs exactly, not only the same
value mod p (``canon``, ``parity`` and the sign flip of decompression depend
on that).

Limbs are int64 where the JAX package has uint32. torch's uint32 has almost
no kernels, and an int32 product of two 16-bit limbs overflows; int64 holds
every limb product (< 2^32) and every folded column (< 2^27) exactly, so
nothing here relies on wraparound.

The *carried* form (every public op's output) has all limbs < 2^16; the
value may be anywhere in [0, 2^256), and only :func:`canon` reduces it
below p. :func:`mul` takes carried inputs: on CUDA tensors it launches the
hand-written kernel (:mod:`.cuda_field`, ``csrc/fe_mul.cu``), on CPU
tensors it runs the plain version :func:`_mul_plain`; :func:`pow22523`
does the same with its own kernel (``csrc/fe_pow22523.cu``) and
:func:`_pow22523_plain`. Every other op is PyTorch, shape-polymorphic over
leading batch axes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_field

LIMBS = 16
RADIX = 16
MASK = (1 << RADIX) - 1

P = 2**255 - 19
# 2^256 mod p: the fold factor for product columns >= 16 and for the
# carry out of limb 15.
FOLD = 38


def _int_to_limbs(value: int) -> np.ndarray:
    return np.array(
        [(value >> (RADIX * i)) & MASK for i in range(LIMBS)], np.int64
    )


def limbs_to_int(limbs) -> int:
    """Host-side decode of one element (tests / debugging only)."""
    arr = np.asarray(limbs.cpu() if isinstance(limbs, torch.Tensor) else limbs)
    return sum(int(arr[..., i]) << (RADIX * i) for i in range(LIMBS))


P_LIMBS = _int_to_limbs(P)

# Subtraction pad: 4p spread so every limb is >= 2^16 (>= any carried
# limb of the subtrahend), keeping a - b + PAD4P non-negative per limb.
# 4p = 2^257 - 76 = (2^18-76) + sum_{i=1..14} (2^18-4) 2^16i + (2^17-4) 2^240.
PAD4P = np.array([2**18 - 76] + [2**18 - 4] * 14 + [2**17 - 4], np.int64)
assert sum(int(c) << (RADIX * i) for i, c in enumerate(PAD4P)) == 4 * P
assert all(int(c) >= 1 << RADIX for c in PAD4P)

ZERO = _int_to_limbs(0)
ONE = _int_to_limbs(1)
D = _int_to_limbs((-121665 * pow(121666, P - 2, P)) % P)
D2 = _int_to_limbs((2 * ((-121665 * pow(121666, P - 2, P)) % P)) % P)
SQRT_M1 = _int_to_limbs(pow(2, (P - 1) // 4, P))

# Constants already on a device, keyed by (bytes, device): a fresh
# host-to-device copy per call would synchronise the stream.
_ON_DEVICE: "dict[tuple[bytes, str], torch.Tensor]" = {}


def on_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host int64 constant as a tensor on ``device``, copied once."""
    device = torch.device(device)
    key = (arr.tobytes() + str(arr.shape).encode(), str(device))
    t = _ON_DEVICE.get(key)
    if t is None:
        t = _ON_DEVICE[key] = torch.as_tensor(arr, dtype=torch.int64, device=device)
    return t


def const(limbs: np.ndarray, batch_shape=(), device="cpu") -> torch.Tensor:
    """Broadcast a host constant to a batch of lanes (an expanded view)."""
    return on_device(limbs, device).expand(*batch_shape, LIMBS)


def _carry_vec(t):
    """Carry-save pass: every limb sheds its high bits to its neighbour at
    once; the 2^256-weight carry folds to limb 0 as +38c."""
    c = t >> RADIX
    t = t & MASK
    t[..., 1:] += c[..., :-1]
    t[..., 0] += c[..., -1] * FOLD
    return t


def _carry_seq(t):
    """The exact sequential pass (c = 0; for each limb: cur = t + c, limb =
    cur & MASK, c = cur >> 16; then limb 0 += 38 c), computed as carry
    lookahead instead of a 16-step ripple. Holds for limbs <= 2^17 - 2,
    where every carry is 0 or 1: a limb >= 2^16 generates a carry, a limb
    of 0xFFFF passes its incoming carry on, any other limb stops it. So
    the carry out of limb i is the generate bit of the last limb at or
    below i that does not pass on. Two carry-save passes bring any limbs
    < 2^32 (the JAX package's uint32 domain) below 2^16 + 40, inside that
    bound, and the first sequential pass keeps them there."""
    keep = t != MASK
    last = torch.where(keep, on_device(_LIMB_INDEX, t.device), -1).cummax(dim=-1).values
    cout = (t >> RADIX).gather(-1, last.clamp(min=0)) * (last >= 0)
    cin = torch.zeros_like(t)
    cin[..., 1:] = cout[..., :-1]
    out = (t + cin) & MASK
    out[..., 0] += cout[..., -1] * FOLD
    return out


_LIMB_INDEX = np.arange(LIMBS, dtype=np.int64)


def carry(t):
    """Restore the carried invariant (all limbs < 2^16) from column sums
    < 2^27: two carry-save passes, then two sequential passes, as the JAX
    package's ``field.carry`` (whose docstring gives the bound chain; a
    three-pass variant is not rigorous against crafted 0xFFFF ripples)."""
    return _carry_seq(_carry_seq(_carry_vec(_carry_vec(t))))


def add(a, b):
    """a + b (carried inputs -> carried output)."""
    return carry(a + b)


def sub(a, b):
    """a - b mod p via the 4p pad (no negative intermediates: every pad
    limb exceeds any carried limb of b)."""
    return carry(a + (on_device(PAD4P, b.device) - b))


def mul(a, b):
    """Schoolbook 16x16 product with hi/lo column split and the 2^256 === 38
    fold, carried. Carried inputs required. On CUDA tensors the operands
    are broadcast to one contiguous shape and the kernel computes it."""
    if a.device.type == "cuda":
        a, b = (x.contiguous() for x in torch.broadcast_tensors(a, b))
    return cuda_field.fe_mul(a, b)


# Column of each half-product: (i, j)'s low half lands in column i+j, its
# high half in column i+j+1 (lows first, then highs, as _mul_plain lays
# them out). A scatter-add, not the JAX package's 0/1 integer matmul:
# cuBLAS has no int64 GEMM, and the plain version also runs on the card.
_COL_INDEX = np.array(
    [i + j for i in range(LIMBS) for j in range(LIMBS)]
    + [i + j + 1 for i in range(LIMBS) for j in range(LIMBS)],
    np.int64,
)


def _mul_plain(a, b):
    """The plain PyTorch version of the field product: what the JAX
    package's ``field._mul_jnp`` computes, limb for limb."""
    a, b = torch.broadcast_tensors(a, b)
    prod = (a[..., :, None] * b[..., None, :]).reshape(*a.shape[:-1], LIMBS * LIMBS)
    halves = torch.cat([prod & MASK, prod >> RADIX], dim=-1)
    cols = torch.zeros(*a.shape[:-1], 2 * LIMBS, dtype=torch.int64, device=a.device)
    index = on_device(_COL_INDEX, a.device).expand_as(halves)
    cols.scatter_add_(-1, index, halves)
    return carry(cols[..., :LIMBS] + cols[..., LIMBS:] * FOLD)


def sqr(a):
    return mul(a, a)


def pow2k(a, k: int):
    """a^(2^k): k squarings."""
    for _ in range(k):
        a = sqr(a)
    return a


def pow22523(z):
    """z^((p-5)/8) = z^(2^252 - 3): the shared exponent of inverse-sqrt
    decompression (RFC 8032 5.1.3), one chain across every lane. On CUDA
    tensors the whole chain is one kernel launch (``csrc/fe_pow22523.cu``);
    on CPU tensors it is the plain version :func:`_pow22523_plain`."""
    if z.device.type == "cuda":
        z = z.contiguous()
    return cuda_field.fe_pow22523(z)


def _pow22523_plain(z):
    """The plain version of :func:`pow22523`: 251 squarings and 11
    products through :func:`mul`."""
    z2 = sqr(z)
    z9 = mul(pow2k(z2, 2), z)            # z^9
    z11 = mul(z9, z2)                    # z^11
    z2_5_0 = mul(sqr(z11), z9)           # z^(2^5 - 1)
    z2_10_0 = mul(pow2k(z2_5_0, 5), z2_5_0)
    z2_20_0 = mul(pow2k(z2_10_0, 10), z2_10_0)
    z2_40_0 = mul(pow2k(z2_20_0, 20), z2_20_0)
    z2_50_0 = mul(pow2k(z2_40_0, 10), z2_10_0)
    z2_100_0 = mul(pow2k(z2_50_0, 50), z2_50_0)
    z2_200_0 = mul(pow2k(z2_100_0, 100), z2_100_0)
    z2_250_0 = mul(pow2k(z2_200_0, 50), z2_50_0)
    return mul(pow2k(z2_250_0, 2), z)    # z^(2^252 - 3)


def invert(z):
    """z^(p-2) = z^(2^255 - 21) (Fermat). Zero maps to zero."""
    z2 = sqr(z)
    z9 = mul(pow2k(z2, 2), z)
    z11 = mul(z9, z2)
    z2_5_0 = mul(sqr(z11), z9)
    z2_10_0 = mul(pow2k(z2_5_0, 5), z2_5_0)
    z2_20_0 = mul(pow2k(z2_10_0, 10), z2_10_0)
    z2_40_0 = mul(pow2k(z2_20_0, 20), z2_20_0)
    z2_50_0 = mul(pow2k(z2_40_0, 10), z2_10_0)
    z2_100_0 = mul(pow2k(z2_50_0, 50), z2_50_0)
    z2_200_0 = mul(pow2k(z2_100_0, 100), z2_100_0)
    z2_250_0 = mul(pow2k(z2_200_0, 50), z2_50_0)
    return mul(pow2k(z2_250_0, 5), z11)  # z^(2^255 - 21)


def _sub_p_borrow(x):
    """Limbs of x - p (mod 2^256) and the final borrow (1 where x < p),
    by a borrow chain over limbs < 2^16."""
    out = torch.empty_like(x)
    borrow = 0
    for i in range(LIMBS):
        d = x[..., i] + ((1 << RADIX) - int(P_LIMBS[i])) - borrow
        torch.bitwise_and(d, MASK, out=out[..., i])
        borrow = 1 - (d >> RADIX)
    return out, borrow


def _cond_sub_p(x):
    """One conditional subtract of p (carried input)."""
    diff, borrow = _sub_p_borrow(x)
    return torch.where((borrow == 1)[..., None], x, diff)


def canon(x):
    """Canonical representative in [0, p). A carried value is < 2^256 =
    2p + 38, so two conditional subtractions always suffice."""
    return _cond_sub_p(_cond_sub_p(x))


def is_zero(x):
    """Carried input -> bool tensor over batch axes (exact mod-p test)."""
    return (canon(x) == 0).all(dim=-1)


def eq(a, b):
    return is_zero(sub(a, b))


def parity(x):
    """Bit 0 of the canonical representative (the RFC 8032 sign bit)."""
    return canon(x)[..., 0] & 1


def from_bytes(b):
    """uint8[..., 32] little-endian -> carried limbs (top bit included;
    callers mask the sign bit themselves where the encoding demands)."""
    b64 = b.to(torch.int64)
    return b64[..., 0::2] | (b64[..., 1::2] << 8)


def to_bytes(x):
    """Canonical little-endian uint8[..., 32] encoding."""
    c = canon(x)
    pairs = torch.stack([c & 0xFF, (c >> 8) & 0xFF], dim=-1)
    return pairs.reshape(*c.shape[:-1], 32).to(torch.uint8)


def is_canonical_fe(b):
    """RFC 8032 5.1.3 field-encoding check: the 255-bit y (sign bit
    already masked) must be < p."""
    return _sub_p_borrow(from_bytes(b))[1] == 1
