"""SHA-512 over ragged byte rows: the challenge hashes of a device batch.

Port of ``hashgraph_tpu/crypto_device/sha512.py``. The per-signature Ed25519
challenge hash k = SHA-512(R || A || M) of every lane of a batch is taken
by :func:`sha512_batch_dispatch`:

- on a CUDA device, one launch of ``csrc/sha512.cu`` (built at first use by
  :mod:`hashgraph_tpu_torch._build`) on PyTorch's current stream, one lane
  a thread: the messages go over joined end to end with their offsets, in
  one host-to-device copy, and each thread pads its own message. The JAX
  package leaves SHA-512 to XLA, so this kernel replaces no TPU kernel; it
  replaces the eager version below, whose some 27,500 operator calls a
  batch the host enqueued one at a time. A launch adds one to
  ``_build.launches["sha512"]``;
- elsewhere, the plain version :func:`_sha512_blocks`: every lane's
  compression in lockstep as PyTorch operators. Each 64-bit word is an
  (hi, lo) pair of 32-bit halves, as in the JAX package, each half held in
  int64 and masked to 32 bits after every operation, so the digests match
  the JAX package word for word; the adders carry explicitly. Ragged
  batches pad to a shared block count (bucketed by the caller); a lane
  whose message ends early keeps its state through a per-block mask, so
  one loop serves every length in the batch. Block packing happens on the
  host in numpy.

Both return the digest words in one layout, int64[L, 16] of (hi, lo)
halves, which :func:`digest_bytes` reads. Nothing falls back: a CUDA call
whose build or launch fails raises.

Constants are derived, not transcribed: K[t] / H0 are the fractional parts
of cube/square roots of the first primes (FIPS 180-4), computed with
integer Newton roots at import (``csrc/sha512.cuh`` writes them out; the
CPU tests hold it against these).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build

KERNEL = "sha512"
BLOCK = 128  # bytes per SHA-512 block
M32 = 0xFFFFFFFF


def _primes(n: int) -> "list[int]":
    out, c = [], 2
    while len(out) < n:
        if all(c % p for p in out):
            out.append(c)
        c += 1
    return out


def _iroot(x: int, k: int) -> int:
    """Integer floor k-th root (Newton on Python ints)."""
    if x == 0:
        return 0
    r = 1 << ((x.bit_length() + k - 1) // k)
    while True:
        nr = ((k - 1) * r + x // r ** (k - 1)) // k
        if nr >= r:
            return r
        r = nr


def _frac_root_bits(p: int, k: int) -> int:
    """First 64 fractional bits of p^(1/k)."""
    return _iroot(p << (64 * k), k) & ((1 << 64) - 1)


_K64 = [_frac_root_bits(p, 3) for p in _primes(80)]
_H64 = [_frac_root_bits(p, 2) for p in _primes(8)]


def _add64(ah, al, bh, bl):
    lo = al + bl
    return (ah + bh + (lo >> 32)) & M32, lo & M32


def _ror64(h, lo, r: int):
    if r == 32:
        return lo, h
    if r > 32:
        h, lo, r = lo, h, r - 32
    return (
        ((h >> r) | (lo << (32 - r))) & M32,
        ((lo >> r) | (h << (32 - r))) & M32,
    )


def _shr64(h, lo, r: int):
    return h >> r, ((lo >> r) | (h << (32 - r))) & M32


def _sigma(h, lo, r1, r2, r3, shift: bool):
    ah, al = _ror64(h, lo, r1)
    bh, bl = _ror64(h, lo, r2)
    ch, cl = _shr64(h, lo, r3) if shift else _ror64(h, lo, r3)
    return ah ^ bh ^ ch, al ^ bl ^ cl


def _sha512_blocks(words: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """words: int64[L, B, 32] (big-endian 64-bit message words as (hi, lo)
    32-bit halves), nblocks: int64[L] true block counts. Returns int64[L,
    16] digest words (hi, lo interleaved)."""
    lanes, max_blocks, _ = words.shape
    state = [
        (torch.full((lanes,), h >> 32, dtype=torch.int64, device=words.device),
         torch.full((lanes,), h & M32, dtype=torch.int64, device=words.device))
        for h in _H64
    ]
    for b in range(max_blocks):
        # The 16-word schedule window as a list, rolled by one each round.
        win = [(words[:, b, 2 * t], words[:, b, 2 * t + 1]) for t in range(16)]
        (ah, al), (bh, bl), (ch, cl), (dh, dl), (eh, el), (fh, fl), (gh, gl), (hh, hl) = state
        for t in range(80):
            wh, wl = win[0]
            s1h, s1l = _sigma(eh, el, 14, 18, 41, False)
            chh = (eh & fh) ^ ((eh ^ M32) & gh)
            chl = (el & fl) ^ ((el ^ M32) & gl)
            t1h, t1l = _add64(hh, hl, s1h, s1l)
            t1h, t1l = _add64(t1h, t1l, chh, chl)
            t1h, t1l = _add64(t1h, t1l, _K64[t] >> 32, _K64[t] & M32)
            t1h, t1l = _add64(t1h, t1l, wh, wl)
            s0h, s0l = _sigma(ah, al, 28, 34, 39, False)
            majh = (ah & bh) ^ (ah & ch) ^ (bh & ch)
            majl = (al & bl) ^ (al & cl) ^ (bl & cl)
            t2h, t2l = _add64(s0h, s0l, majh, majl)
            hh, hl, gh, gl, fh, fl = gh, gl, fh, fl, eh, el
            eh, el = _add64(dh, dl, t1h, t1l)
            dh, dl, ch, cl, bh, bl = ch, cl, bh, bl, ah, al
            ah, al = _add64(t1h, t1l, t2h, t2l)
            if t < 64:  # words past round 80 are never read
                sg0h, sg0l = _sigma(*win[1], 1, 8, 7, True)
                sg1h, sg1l = _sigma(*win[14], 19, 61, 6, True)
                nh, nl = _add64(*win[0], sg0h, sg0l)
                nh, nl = _add64(nh, nl, *win[9])
                win.append(_add64(nh, nl, sg1h, sg1l))
            win.pop(0)
        # Lanes whose message ended before block b keep their state.
        live = b < nblocks
        regs = ((ah, al), (bh, bl), (ch, cl), (dh, dl), (eh, el), (fh, fl), (gh, gl), (hh, hl))
        state = [
            tuple(torch.where(live, new, old) for new, old in zip(_add64(sh, sl, rh, rl), (sh, sl)))
            for (sh, sl), (rh, rl) in zip(state, regs)
        ]
    return torch.stack([half for pair in state for half in pair], dim=1)


def blocks_needed(length: int) -> int:
    """SHA-512 block count for a message of ``length`` bytes (payload +
    0x80 + 128-bit length field)."""
    return (length + 17 + BLOCK - 1) // BLOCK


def _checked_blocks(lengths: np.ndarray, max_blocks: int) -> np.ndarray:
    """The block count of each message length (:func:`blocks_needed`);
    raises ``ValueError`` if one needs more than ``max_blocks``."""
    nblocks = blocks_needed(lengths)
    if int(nblocks.max()) > max_blocks:
        raise ValueError("max_blocks bucket too small for batch")
    return nblocks


def _packed_words(messages: "list[bytes]", nblocks: np.ndarray, max_blocks: int) -> np.ndarray:
    """The plain path's host packing: every lane padded at its OWN final
    block, as int64[L, max_blocks, 32] big-endian 32-bit halves of the
    message words."""
    lanes = len(messages)
    buf = np.zeros((lanes, max_blocks * BLOCK), np.uint8)
    for i, msg in enumerate(messages):
        n = len(msg)
        end = int(nblocks[i]) * BLOCK  # pad at the lane's OWN final block
        buf[i, :n] = np.frombuffer(msg, np.uint8)
        buf[i, n] = 0x80
        buf[i, end - 16:end] = np.frombuffer((n * 8).to_bytes(16, "big"), np.uint8)
    w32 = buf.reshape(lanes, max_blocks, BLOCK // 4, 4).astype(np.int64)
    return (w32[..., 0] << 24) | (w32[..., 1] << 16) | (w32[..., 2] << 8) | w32[..., 3]


def _lengths(messages: "list[bytes]") -> np.ndarray:
    return np.fromiter(map(len, messages), np.int64, len(messages))


def _ragged(messages: "list[bytes]", lengths: np.ndarray) -> "tuple[np.ndarray, int]":
    """The kernel's input as one host buffer: int64 offsets[L + 1] (message
    i is bytes offsets[i] .. offsets[i + 1] of the data), then the messages
    joined end to end. Returns the buffer and the data's start."""
    head = 8 * (len(messages) + 1)
    data = b"".join(messages)
    host = np.empty(head + len(data), np.uint8)
    offsets = host[:head].view(np.int64)
    offsets[0] = 0
    np.cumsum(lengths, out=offsets[1:])
    host[head:] = np.frombuffer(data, np.uint8)
    return host, head


@functools.cache
def _kernel():
    """The bound C entry point, built at first use and bound once."""
    fn = _build.library(KERNEL).hg_sha512
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sha512_batch_dispatch(messages: "list[bytes]", max_blocks: int, device="cpu"):
    """Enqueue the batch's hashes on ``device``; returns the digest words,
    int64[L, 16], not yet read back (callers overlap other work, then hand
    them to :func:`digest_bytes`). ``max_blocks`` is the caller's bucket
    (>= every message's block count): the plain path pads every lane to it,
    the kernel walks each lane's own count."""
    lengths = _lengths(messages)
    nblocks = _checked_blocks(lengths, max_blocks)
    device = torch.device(device)
    if device.type != "cuda":
        w32 = _packed_words(messages, nblocks, max_blocks)
        return _sha512_blocks(
            torch.from_numpy(w32).to(device), torch.from_numpy(nblocks).to(device)
        )
    kernel = _kernel()
    host, head = _ragged(messages, lengths)
    buf = torch.from_numpy(host).to(device)
    out = torch.empty((len(messages), 16), dtype=torch.int64, device=device)
    _build.launched(KERNEL, kernel(
        buf.data_ptr(), buf.data_ptr() + head, out.data_ptr(), len(messages),
        torch.cuda.current_stream(device).cuda_stream,
    ))
    return out


def digest_bytes(digest_words) -> np.ndarray:
    """Read dispatched digest words back into uint8[L, 64] digests."""
    words = digest_words.cpu().numpy().astype(">u4")  # big-endian halves
    return words.view(np.uint8).reshape(words.shape[0], 64)
