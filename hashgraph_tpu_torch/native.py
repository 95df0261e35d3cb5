"""ctypes bindings for the native C++ host runtime (hashing, ECDSA, Ed25519).

Port of the JAX package's ``native`` module, which the port does not
import. It builds the repo's ``native/consensus_native.cpp`` with ``g++`` at
first use through :func:`hashgraph_tpu_torch._build.host_library` into the
port's own ``_build/`` directory (never the JAX package's build output),
named by a hash of the source, the flags and this host's CPU flags, so a
``-march=native`` build is only ever loaded on a host with the same
instruction set. The environment variable ``HASHGRAPH_TPU_TORCH_NATIVE``
names a library to load instead.

Every entry point returns ``None`` when the library cannot be built or
loaded, and its callers then take the pure-Python path, as in the JAX
package. The batch calls release the GIL and fan out over the library's own
persistent worker pool; a process that also loads the JAX package's copy of
the library holds two handles and two pools, shared with nothing.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

from . import _build

ENV = "HASHGRAPH_TPU_TORCH_NATIVE"
SOURCE = Path(__file__).resolve().parent.parent / "native" / "consensus_native.cpp"
# The newest symbol of the library's ABI (v4): a library without it is stale.
_NEWEST_SYMBOL = "hg_parse_vote_columns"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_attempted = False


def _load() -> ctypes.CDLL | None:
    global _lib, _load_attempted
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        path = os.environ.get(ENV)
        if path is None:
            try:
                path = str(_build.host_library(SOURCE))
            except (_build.BuildError, OSError):
                return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        if not hasattr(lib, _NEWEST_SYMBOL):
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.hg_version.restype = ctypes.c_int
        lib.hg_sha256.argtypes = [u8p, ctypes.c_uint64, u8p]
        lib.hg_keccak256.argtypes = [u8p, ctypes.c_uint64, u8p]
        for fn in (lib.hg_sha256_batch, lib.hg_keccak256_batch):
            fn.argtypes = [u8p, u64p, ctypes.c_int64, u8p, ctypes.c_int]
        lib.hg_eth_verify.restype = ctypes.c_int
        lib.hg_eth_verify.argtypes = [u8p, u8p, ctypes.c_uint64, u8p]
        lib.hg_eth_verify_batch.argtypes = [
            u8p, u8p, u64p, u8p, ctypes.c_int64, u8p, ctypes.c_int,
        ]
        lib.hg_eth_sign.restype = ctypes.c_int
        lib.hg_eth_sign.argtypes = [u8p, u8p, ctypes.c_uint64, u8p]
        lib.hg_eth_address.restype = ctypes.c_int
        lib.hg_eth_address.argtypes = [u8p, u8p]
        lib.hg_pid_lookup.argtypes = [
            i64p, i64p, ctypes.c_int64, ctypes.c_int, i64p,
            ctypes.c_int64, u8p, i64p, ctypes.c_int,
        ]
        lib.hg_gids_live.argtypes = [
            i64p, ctypes.c_int64, u8p, i64p,
            ctypes.c_int64, u8p, ctypes.c_int,
        ]
        # Persistent verify pool (v3 ABI).
        lib.hg_pool_configure.restype = ctypes.c_int
        lib.hg_pool_configure.argtypes = [ctypes.c_int]
        lib.hg_pool_size.restype = ctypes.c_int
        lib.hg_pool_queue_depth.restype = ctypes.c_int64
        lib.hg_pool_wait.restype = ctypes.c_int
        lib.hg_pool_wait.argtypes = [ctypes.c_int64]
        lib.hg_eth_verify_batch_submit.restype = ctypes.c_int64
        lib.hg_eth_verify_batch_submit.argtypes = [
            u8p, u8p, u64p, u8p, ctypes.c_int64, u8p,
        ]
        # Ed25519 (v3 ABI).
        lib.hg_ed25519_public.restype = ctypes.c_int
        lib.hg_ed25519_public.argtypes = [u8p, u8p]
        lib.hg_ed25519_sign.restype = ctypes.c_int
        lib.hg_ed25519_sign.argtypes = [u8p, u8p, ctypes.c_uint64, u8p]
        lib.hg_ed25519_verify.restype = ctypes.c_int
        lib.hg_ed25519_verify.argtypes = [u8p, u8p, ctypes.c_uint64, u8p]
        lib.hg_ed25519_verify_batch.argtypes = [
            u8p, u8p, u64p, u8p, ctypes.c_int64, u8p, ctypes.c_int,
        ]
        lib.hg_ed25519_verify_batch_submit.restype = ctypes.c_int64
        lib.hg_ed25519_verify_batch_submit.argtypes = [
            u8p, u8p, u64p, u8p, ctypes.c_int64, u8p,
        ]
        # Columnar wire parse (v4 ABI).
        lib.hg_parse_vote_columns.argtypes = [
            u8p, u64p, ctypes.c_int64, i64p, u8p, ctypes.c_int,
        ]
        lib.hg_vote_hash_columns.argtypes = [
            u8p, i64p, ctypes.c_int64, u8p, ctypes.c_int,
        ]
        if lib.hg_version() < 4:
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _u8(buf) -> ctypes.POINTER(ctypes.c_uint8):
    return ctypes.cast(
        (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf), ctypes.POINTER(ctypes.c_uint8)
    )


def _np_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _joined_u8(items: "list[bytes]") -> np.ndarray:
    """Concatenate byte strings into one uint8 view WITHOUT a second
    copy: ``b"".join`` already materializes a fresh buffer, and the C
    side never writes these, so a read-only ``frombuffer`` view over the
    joined bytes is enough (the array keeps the bytes object alive)."""
    return np.frombuffer(b"".join(items) or b"\x00", np.uint8)


def keccak256(data: bytes) -> bytes | None:
    lib = _load()
    if lib is None:
        return None
    out = np.empty(32, np.uint8)
    lib.hg_keccak256(_u8(data), len(data), _np_u8p(out))
    return out.tobytes()


def pid_lookup(
    table_keys: np.ndarray,
    table_vals: np.ndarray,
    shift: int,
    queries: np.ndarray,
    n_threads: int = 0,
) -> "tuple[np.ndarray, np.ndarray] | None":
    """Fused open-addressing probe (engine._PidLookup layout: power-of-two
    table, Fibonacci bucketing with the given shift, -1 empty sentinel).
    Returns (found bool[B], slots int64[B]; 0 where not found), or None
    when the native runtime is absent. The call releases the GIL."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(table_keys, np.int64)
    vals = np.ascontiguousarray(table_vals, np.int64)
    q = np.ascontiguousarray(queries, np.int64)
    if len(keys) < 2:
        # Defensive only — unreachable from the engine: _PidLookup always
        # builds a table of size >= 2 (n = max(len(pids), 1), size doubles
        # until >= 2n). Kept for direct callers of this binding: a size-1
        # table would make shift == 64, a UB shift width in C — and a
        # sentinel-only table can't match anything anyway.
        return np.zeros(len(q), bool), np.zeros(len(q), np.int64)
    found = np.empty(len(q), np.uint8)
    out = np.empty(len(q), np.int64)
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.hg_pid_lookup(
        keys.ctypes.data_as(i64),
        vals.ctypes.data_as(i64),
        len(keys),
        int(shift),
        q.ctypes.data_as(i64),
        len(q),
        _np_u8p(found),
        out.ctypes.data_as(i64),
        n_threads,
    )
    return found.view(bool), out


def gids_live(
    gids: np.ndarray,
    live: np.ndarray,
    gen: np.ndarray,
    n_threads: int = 0,
) -> "np.ndarray | None":
    """Fused generation-tagged gid liveness check (pool.gids_live layout):
    bool[B], or None when the runtime is absent."""
    lib = _load()
    if lib is None:
        return None
    g = np.ascontiguousarray(gids, np.int64)
    # bool and uint8 share layout: view, don't copy the whole registry.
    lv = (
        live.view(np.uint8)
        if live.dtype == np.bool_ and live.flags.c_contiguous
        else np.ascontiguousarray(live, np.uint8)
    )
    gn = np.ascontiguousarray(gen, np.int64)
    out = np.empty(len(g), np.uint8)
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.hg_gids_live(
        g.ctypes.data_as(i64),
        len(g),
        _np_u8p(lv),
        gn.ctypes.data_as(i64),
        len(gn),
        _np_u8p(out),
        n_threads,
    )
    return out.view(bool)


def sha256_batch(items: list[bytes], n_threads: int = 0) -> np.ndarray | None:
    """[K] digests as uint8[K, 32], or None when the runtime is absent."""
    return _hash_batch(items, n_threads, "hg_sha256_batch")


def keccak256_batch(items: list[bytes], n_threads: int = 0) -> np.ndarray | None:
    return _hash_batch(items, n_threads, "hg_keccak256_batch")


def _hash_batch(items: list[bytes], n_threads: int, fn_name: str) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    data = _joined_u8(items)
    offsets = np.zeros(len(items) + 1, np.uint64)
    np.cumsum([len(b) for b in items], out=offsets[1:])
    out = np.empty((len(items), 32), np.uint8)
    getattr(lib, fn_name)(
        _np_u8p(data),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(items),
        _np_u8p(out),
        n_threads,
    )
    return out


def eth_verify(identity: bytes, payload: bytes, signature: bytes) -> int | None:
    """1 valid, 0 address mismatch, -1 malformed recovery byte, -2 recovery
    failed; None if the native runtime is unavailable."""
    lib = _load()
    if lib is None:
        return None
    return lib.hg_eth_verify(_u8(identity), _u8(payload), len(payload), _u8(signature))


def eth_verify_batch(
    identities: list[bytes],
    payloads: list[bytes],
    signatures: list[bytes],
    n_threads: int = 0,
) -> np.ndarray | None:
    """uint8[K]: 1 valid, 0 address mismatch, 255 malformed recovery byte,
    254 recovery failed; None if unavailable. Caller guarantees 20-byte
    identities and 65-byte signatures."""
    lib = _load()
    if lib is None:
        return None
    k = len(identities)
    ids = _joined_u8(identities)
    sigs = _joined_u8(signatures)
    data = _joined_u8(payloads)
    offsets = np.zeros(k + 1, np.uint64)
    np.cumsum([len(b) for b in payloads], out=offsets[1:])
    out = np.empty(k, np.uint8)
    lib.hg_eth_verify_batch(
        _np_u8p(ids),
        _np_u8p(data),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        _np_u8p(sigs),
        k,
        _np_u8p(out),
        n_threads,
    )
    return out


def eth_sign(private_key: bytes, payload: bytes) -> bytes | None:
    lib = _load()
    if lib is None:
        return None
    out = np.empty(65, np.uint8)
    rc = lib.hg_eth_sign(_u8(private_key), _u8(payload), len(payload), _np_u8p(out))
    return out.tobytes() if rc == 0 else None


def eth_address(private_key: bytes) -> bytes | None:
    lib = _load()
    if lib is None:
        return None
    out = np.empty(20, np.uint8)
    rc = lib.hg_eth_address(_u8(private_key), _np_u8p(out))
    return out.tobytes() if rc == 0 else None


# ── Persistent verify pool ─────────────────────────────────────────────


class VerifyJob:
    """Handle for an in-flight native verify batch.

    The worker pool fills ``out`` in the background with no GIL
    involvement; :meth:`collect` blocks until every chunk completed and
    returns the result codes. The job object keeps every marshalled
    buffer alive until collection — the C side borrows the pointers, so
    the buffers must outlive the workers: a job dropped UNCOLLECTED
    waits for its chunks in ``__del__`` before the buffers can be freed
    (the crypto is already running; the wait is bounded by work that was
    going to happen anyway — never let the GC race a worker's writes).
    """

    __slots__ = ("_lib", "_handle", "out", "_keepalive", "_collected")

    def __init__(self, lib, handle: int, out: np.ndarray, keepalive: tuple):
        self._lib = lib
        self._handle = handle
        self.out = out
        self._keepalive = keepalive
        self._collected = False

    def collect(self) -> np.ndarray:
        """Wait for the batch and return its result codes (uint8[K])."""
        if not self._collected:
            self._lib.hg_pool_wait(self._handle)
            self._collected = True
        return self.out

    def __del__(self):
        try:
            self.collect()
        except Exception:
            pass  # interpreter teardown: the process outlives the pool


def pool_configure(n_threads: int) -> int | None:
    """(Re)size the persistent verify pool (<= 0 restores the hardware
    default). Returns the resulting worker count, or None when the
    native runtime is absent. Call between batches, not mid-flight."""
    lib = _load()
    if lib is None:
        return None
    return lib.hg_pool_configure(n_threads)


def pool_size() -> int | None:
    lib = _load()
    if lib is None:
        return None
    return lib.hg_pool_size()


def pool_queue_depth() -> int | None:
    """Verify-pool tasks queued + running, or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    return lib.hg_pool_queue_depth()


def pool_queue_depth_if_loaded() -> int:
    """Metrics-safe queue depth: 0 unless the runtime is ALREADY loaded.
    Scrape paths use this — naming the gauge must never be the thing
    that compiles or dlopens the native library."""
    lib = _lib
    return int(lib.hg_pool_queue_depth()) if lib is not None else 0


def _submit_batch(lib, fn, fixed_arrays: tuple, payloads: "list[bytes]",
                  count: int) -> VerifyJob:
    data = _joined_u8(payloads)
    offsets = np.zeros(count + 1, np.uint64)
    np.cumsum([len(b) for b in payloads], out=offsets[1:])
    out = np.empty(count, np.uint8)
    handle = fn(
        _np_u8p(fixed_arrays[0]),
        _np_u8p(data),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        _np_u8p(fixed_arrays[1]),
        count,
        _np_u8p(out),
    )
    return VerifyJob(lib, handle, out, (fixed_arrays, data, offsets))


def eth_verify_batch_submit(
    identities: list[bytes],
    payloads: list[bytes],
    signatures: list[bytes],
) -> VerifyJob | None:
    """Async :func:`eth_verify_batch`: returns immediately with a
    :class:`VerifyJob` whose ``collect()`` yields the same uint8 codes
    (1 valid, 0 mismatch, 255 malformed recovery byte, 254 recovery
    failed), or None if the runtime is unavailable. Caller guarantees
    20-byte identities and 65-byte signatures."""
    lib = _load()
    if lib is None:
        return None
    return _submit_batch(
        lib,
        lib.hg_eth_verify_batch_submit,
        (_joined_u8(identities), _joined_u8(signatures)),
        payloads,
        len(identities),
    )


# ── Ed25519 ────────────────────────────────────────────────────────────


def ed25519_public(seed: bytes) -> bytes | None:
    """32-byte public key for a 32-byte seed, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(32, np.uint8)
    lib.hg_ed25519_public(_u8(seed), _np_u8p(out))
    return out.tobytes()


def ed25519_sign(seed: bytes, payload: bytes) -> bytes | None:
    lib = _load()
    if lib is None:
        return None
    out = np.empty(64, np.uint8)
    lib.hg_ed25519_sign(_u8(seed), _u8(payload), len(payload), _np_u8p(out))
    return out.tobytes()


def ed25519_verify(pub: bytes, payload: bytes, signature: bytes) -> int | None:
    """1 valid, 0 invalid (cofactored verification; bad encodings and a
    non-canonical s also report 0); None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    return lib.hg_ed25519_verify(_u8(pub), _u8(payload), len(payload), _u8(signature))


def ed25519_verify_batch(
    pubs: list[bytes],
    payloads: list[bytes],
    signatures: list[bytes],
    n_threads: int = 0,
) -> np.ndarray | None:
    """uint8[K]: 1 valid, 0 invalid; None if unavailable. Caller
    guarantees 32-byte pubs and 64-byte signatures. Chunks verify as one
    randomized linear combination across the worker pool."""
    lib = _load()
    if lib is None:
        return None
    k = len(pubs)
    ids = _joined_u8(pubs)
    sigs = _joined_u8(signatures)
    data = _joined_u8(payloads)
    offsets = np.zeros(k + 1, np.uint64)
    np.cumsum([len(b) for b in payloads], out=offsets[1:])
    out = np.empty(k, np.uint8)
    lib.hg_ed25519_verify_batch(
        _np_u8p(ids),
        _np_u8p(data),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        _np_u8p(sigs),
        k,
        _np_u8p(out),
        n_threads,
    )
    return out


# ── Columnar wire-vote parsing ─────────────────────────────────────────

VOTE_COLS = 16  # int64 columns per parsed vote (see consensus_native.cpp)


def parse_vote_columns(
    data: np.ndarray, offsets: np.ndarray, n_threads: int = 0
) -> "tuple[np.ndarray, np.ndarray] | None":
    """Strict-canonical batched Vote parse straight off the wire buffer:
    returns (cols int64[N, VOTE_COLS], flags uint8[N]) — flag 1 rows are
    canonical and fully columnized, flag 0 rows need the Python object
    decoder. None when the native runtime is absent. GIL-free."""
    lib = _load()
    if lib is None:
        return None
    d = (
        data
        if isinstance(data, np.ndarray) and data.dtype == np.uint8
        and data.flags.c_contiguous
        else np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8))
    )
    offs = np.ascontiguousarray(offsets, np.uint64)
    n = len(offs) - 1
    cols = np.zeros((n, VOTE_COLS), np.int64)
    flags = np.zeros(n, np.uint8)
    lib.hg_parse_vote_columns(
        _np_u8p(d),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n,
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _np_u8p(flags),
        n_threads,
    )
    return cols, flags


def vote_hash_columns(
    data: np.ndarray, cols: np.ndarray, n_threads: int = 0
) -> "np.ndarray | None":
    """Batched ``protocol.compute_vote_hash`` over parsed columns:
    uint8[N, 32] digests, or None when the runtime is absent."""
    lib = _load()
    if lib is None:
        return None
    d = (
        data
        if isinstance(data, np.ndarray) and data.dtype == np.uint8
        and data.flags.c_contiguous
        else np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8))
    )
    c = np.ascontiguousarray(cols, np.int64)
    n = len(c)
    out = np.empty((n, 32), np.uint8)
    lib.hg_vote_hash_columns(
        _np_u8p(d),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        _np_u8p(out),
        n_threads,
    )
    return out


def ed25519_verify_batch_submit(
    pubs: list[bytes],
    payloads: list[bytes],
    signatures: list[bytes],
) -> VerifyJob | None:
    """Async :func:`ed25519_verify_batch` (collect() -> uint8 codes)."""
    lib = _load()
    if lib is None:
        return None
    return _submit_batch(
        lib,
        lib.hg_ed25519_verify_batch_submit,
        (_joined_u8(pubs), _joined_u8(signatures)),
        payloads,
        len(pubs),
    )
