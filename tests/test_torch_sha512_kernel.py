"""The SHA-512 kernel's arithmetic and its wrapper's contract, on the CPU.

A host C++ compiler builds ``csrc/sha512.cuh`` (the per-lane padding,
compression and digest that ``csrc/sha512.cu`` launches one lane a thread)
into a small library that ctypes loads. Each lane is held bit for bit
against ``hashlib.sha512`` and against the plain version, ``sha512.
_sha512_blocks`` through the CPU path of ``sha512_batch_dispatch``; the
padded blocks the kernel builds in registers are held word for word
against the plain path's host packing. Cases: every padding boundary (0,
1, 111, 112, 127, 128, 239, 240 and 256 bytes), the R || A || M lengths of
the benchmark's signed votes, and seeded ragged batches of up to 512 bytes
a message, fed through the same offsets-and-data buffer the CUDA path
copies to the card. The wrapper's contract: CPU tensors take the plain path
and launch nothing, the ``max_blocks`` check raises before either path
starts, and a CUDA call whose build fails raises rather than falling back.
Tolerance: exact equality (integer arithmetic).
"""

import ctypes
import hashlib
import itertools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from hashgraph_tpu_torch import _build
from hashgraph_tpu_torch.crypto_device import sha512 as sh
from hashgraph_tpu_torch.wire import Vote

CSRC = Path(__file__).resolve().parent.parent / "hashgraph_tpu_torch" / "csrc"

HARNESS = r"""
#include "sha512.cuh"

extern "C" {
// The kernel's body, lane by lane, over one offsets-and-data batch.
void h_sha512(const int64_t* offsets, const uint8_t* data, int64_t* out, int lanes) {
  for (int lane = 0; lane < lanes; ++lane) sha512_ragged_lane(offsets, data, out, lane);
}
// The 16 words of block `block` of one padded message.
void h_block_words(const uint8_t* msg, int64_t len, int64_t block, uint64_t* w) {
  sha512_block_words(msg, len, block, w);
}
int64_t h_blocks_needed(int64_t len) { return sha512_blocks_needed(len); }
}
"""

BOUNDARIES = [0, 1, 111, 112, 127, 128, 239, 240, 256]


def signed_cell_lengths() -> "list[int]":
    """R || A || M lengths of the benchmark's signed votes: a 32-byte R and
    A, and the signing payload of a vote with a 32-byte owner and vote
    hash, no parent hash, an empty or a 32-byte received hash, a yes or a
    no, and vote and proposal ids at either end of uint32."""
    lengths = set()
    for vid, pid, value, received in itertools.product(
            [1, 2**32 - 1], [1, 2**32 - 1], [False, True], [b"", bytes(32)]):
        vote = Vote(vote_id=vid, vote_owner=bytes(32), proposal_id=pid,
                    timestamp=1_700_000_000, vote=value, received_hash=received,
                    vote_hash=bytes(32))
        lengths.add(64 + len(vote.signing_payload()))
    return sorted(lengths)


SIGNED = signed_cell_lengths()


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The kernel's lane routines built by a host C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel's arithmetic")
    tmp = tmp_path_factory.mktemp("sha512_host")
    (tmp / "harness.cpp").write_text(HARNESS)
    lib_path = tmp / "libsha512_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib_path), str(tmp / "harness.cpp")],
                   check=True, timeout=120)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for name, args, res in (
        ("h_sha512", [ptr, ptr, ptr, ctypes.c_int], None),
        ("h_block_words", [ptr, i64, i64, ptr], None),
        ("h_blocks_needed", [i64], i64),
    ):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def host_digest_words(host, messages) -> np.ndarray:
    """The kernel's arithmetic over the buffer the CUDA path copies to the
    card: int64[L, 16] digest halves."""
    buf, head = sh._ragged(messages, sh._lengths(messages))
    out = np.empty((len(messages), 16), np.int64)
    host.h_sha512(_p(buf), _p(buf[head:]), _p(out), len(messages))
    return out


def message(seed: int, length: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, length, dtype=np.uint8).tobytes()


def check_batch(host, messages, max_blocks):
    """Every lane of the kernel's arithmetic equals hashlib's digest and the
    plain version's words."""
    words = host_digest_words(host, messages)
    plain = sh.sha512_batch_dispatch(messages, max_blocks, "cpu").numpy()
    np.testing.assert_array_equal(words, plain)
    for m, d in zip(messages, sh.digest_bytes(torch.from_numpy(words))):
        assert d.tobytes() == hashlib.sha512(m).digest(), len(m)


@pytest.mark.parametrize("length", BOUNDARIES)
def test_lane_matches_hashlib_and_plain_at_padding_boundaries(host, length):
    msgs = [message(length, length), b"\xff" * length]
    check_batch(host, msgs, max(sh.blocks_needed(length), 1))


@pytest.mark.parametrize("length", SIGNED)
def test_lane_matches_hashlib_and_plain_at_signed_cell_lengths(host, length):
    msgs = [message(1000 + length + k, length) for k in range(4)]
    check_batch(host, msgs, 2)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ragged_batch_matches_hashlib_and_plain(host, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 513, 64).tolist() + [0, 512]
    msgs = [message(seed * 1000 + i, n) for i, n in enumerate(lengths)]
    check_batch(host, msgs, sh.blocks_needed(512))


@pytest.mark.parametrize("length", BOUNDARIES + SIGNED)
def test_padded_blocks_match_the_plain_packing(host, length):
    """The blocks the kernel builds in registers (payload, 0x80, zeros, the
    128-bit bit length in the lane's own final block) are the plain path's
    packed words, joined into 64-bit words, block for block."""
    msg = message(7 + length, length)
    blocks = sh.blocks_needed(length)
    assert host.h_blocks_needed(length) == blocks
    nblocks = sh._checked_blocks(sh._lengths([msg]), blocks)
    halves = sh._packed_words([msg], nblocks, blocks)[0].astype(np.uint64)
    want = (halves[:, 0::2] << np.uint64(32)) | halves[:, 1::2]
    data = np.frombuffer(msg, np.uint8) if length else np.zeros(1, np.uint8)
    for b in range(blocks):
        w = np.empty(16, np.uint64)
        host.h_block_words(_p(data), length, b, _p(w))
        np.testing.assert_array_equal(w, want[b])


def test_blocks_needed_matches_the_plain_count(host):
    for length in range(0, 600):
        assert host.h_blocks_needed(length) == sh.blocks_needed(length)


def test_ragged_buffer_holds_offsets_then_data():
    msgs = [b"", b"abc", b"x" * 200, b"", b"\x00\x01"]
    buf, head = sh._ragged(msgs, sh._lengths(msgs))
    assert head == 8 * (len(msgs) + 1)
    offsets = buf[:head].view(np.int64)
    assert offsets.tolist() == [0, 0, 3, 203, 203, 205]
    assert buf[head:].tobytes() == b"".join(msgs)


# ── the wrapper's contract ─────────────────────────────────────────────


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing(monkeypatch):
    calls = []
    plain = sh._sha512_blocks

    def spy(words, nblocks):
        calls.append(tuple(words.shape))
        return plain(words, nblocks)

    def no_kernel():
        raise AssertionError("the CPU path built or bound the CUDA kernel")

    monkeypatch.setattr(sh, "_sha512_blocks", spy)
    monkeypatch.setattr(sh, "_kernel", no_kernel)
    before = dict(_build.launches)
    msgs = [message(5, n) for n in (0, 150, 239, 240)]
    words = sh.sha512_batch_dispatch(msgs, 3, torch.device("cpu"))
    assert calls == [(4, 3, 32)]
    assert words.dtype == torch.int64 and tuple(words.shape) == (4, 16)
    for m, d in zip(msgs, sh.digest_bytes(words)):
        assert d.tobytes() == hashlib.sha512(m).digest()
    assert dict(_build.launches) == before


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_max_blocks_check_raises_on_both_paths(monkeypatch, device):
    """A message past the bucket raises before either path starts: no
    packing, no build, no copy, no launch."""

    def no_kernel():
        raise AssertionError("the check came after the kernel's build")

    monkeypatch.setattr(sh, "_kernel", no_kernel)
    before = dict(_build.launches)
    with pytest.raises(ValueError):
        sh.sha512_batch_dispatch([b"ok", b"x" * 300], 2, device)
    assert dict(_build.launches) == before


def test_cuda_call_whose_build_fails_raises_and_does_not_fall_back(monkeypatch):
    def failed_build(name):
        raise _build.BuildError(f"{name}: no compiler")

    def no_plain(*_):
        raise AssertionError("the CUDA path fell back to the plain version")

    sh._kernel.cache_clear()
    monkeypatch.setattr(_build, "library", failed_build)
    monkeypatch.setattr(sh, "_sha512_blocks", no_plain)
    before = dict(_build.launches)
    with pytest.raises(_build.BuildError):
        sh.sha512_batch_dispatch([b"m" * 150] * 8, 2, "cuda")
    assert dict(_build.launches) == before


def test_kernel_source_is_a_port_source():
    assert sh.KERNEL in _build.sources()
    assert (CSRC / "sha512.cuh").is_file()
