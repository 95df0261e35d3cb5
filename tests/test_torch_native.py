"""The port's native host runtime against the JAX package's and the twins.

``hashgraph_tpu_torch.native`` builds the repo's ``native/consensus_native.cpp``
with g++ into the port's own build directory and loads it beside the JAX
package's copy, so one process holds two handles and two verify pools.
Every entry point is held byte for byte against the JAX package's library
and, where one exists, against the port's pure-Python path: hashes,
RFC 6979 signatures, verdict codes, the pid probe, the gid liveness pass
and the columnar wire parse (tolerance: exact). The pool's and the engine's
native fast paths give the same results with the library forced off. g++
is part of the test environment: a failed build fails these tests.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from hashgraph_tpu import native as ref_native
from hashgraph_tpu.engine.engine import _PidLookup as RefPidLookup
from hashgraph_tpu.engine.pool import ProposalPool as RefPool
from hashgraph_tpu_torch import _build, native
from hashgraph_tpu_torch.engine.engine import _PidLookup
from hashgraph_tpu_torch.engine.pool import ProposalPool
from hashgraph_tpu_torch.signing import _ed25519 as twin
from hashgraph_tpu_torch.signing._keccak import keccak256 as py_keccak256
from hashgraph_tpu_torch.signing._secp256k1 import sign_recoverable
from hashgraph_tpu_torch.signing.ethereum import EthereumConsensusSigner, eip191_hash
from hashgraph_tpu_torch.wire import Vote

P = 2**255 - 19
L = twin.L


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def native_off(monkeypatch):
    """Every wrapper of the port's library returns None, as without it."""
    monkeypatch.setattr(native, "_load", lambda: None)


def _joined(items):
    data = np.frombuffer(b"".join(items), np.uint8)
    offsets = np.zeros(len(items) + 1, np.uint64)
    np.cumsum([len(b) for b in items], out=offsets[1:])
    return data, offsets


# ── The library itself ──────────────────────────────────────────────────


def test_port_library_builds_and_loads_beside_the_reference():
    assert native.available(), "g++ could not build the port's native runtime"
    assert ref_native.available()
    port_lib, ref_lib = native._load(), ref_native._load()
    assert port_lib is not ref_lib
    assert port_lib._handle != ref_lib._handle
    path = _build.host_library(native.SOURCE)
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libconsensus_native-")
    assert port_lib._name == str(path)


def test_host_library_is_named_by_source_flags_and_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    source = tmp_path / "probe.cpp"
    source.write_text('extern "C" int probe() { return 7; }\n')
    first = _build.host_library(source)
    assert first.exists() and _build.cpu_tag()[:4] not in ("", "None")
    assert _build.host_library(source) == first  # cached, not rebuilt
    source.write_text('extern "C" int probe() { return 8; }\n')
    second = _build.host_library(source)
    assert second != first and second.exists()
    assert not list(tmp_path.glob("*.tmp"))
    source.write_text("this is not C++\n")
    with pytest.raises(_build.BuildError):
        _build.host_library(source)
    assert not list(tmp_path.glob("*.tmp"))


def test_missing_override_gives_the_none_path(monkeypatch, tmp_path):
    monkeypatch.setenv(native.ENV, str(tmp_path / "absent.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    assert native.available() is False
    assert native.keccak256(b"abc") is None
    assert native.eth_sign(b"\x01" * 32, b"m") is None
    assert native.ed25519_verify_batch([b"\x00" * 32], [b""], [b"\x00" * 64]) is None
    assert native.gids_live(np.zeros(4, np.int64), np.ones(1, bool),
                            np.zeros(1, np.int64)) is None
    assert native.pool_queue_depth_if_loaded() == 0
    # The scheme takes its pure-Python path and gives the same bytes.
    signer = EthereumConsensusSigner(7)
    sig = signer.sign(b"none path")
    assert sig == ref_native.eth_sign((7).to_bytes(32, "big"), b"none path")
    assert EthereumConsensusSigner.verify(signer.identity(), b"none path", sig)


def test_each_library_keeps_its_own_pool():
    ref_size = ref_native.pool_size()
    try:
        assert native.pool_configure(3) == 3
        assert native.pool_size() == 3
        assert ref_native.pool_size() == ref_size
    finally:
        native.pool_configure(0)
    assert native.pool_queue_depth() == 0


# ── Hashing ─────────────────────────────────────────────────────────────


@pytest.mark.parametrize("length", [0, 1, 31, 32, 135, 136, 137, 500, 1000])
def test_keccak(length):
    data = random.Random(length).randbytes(length)
    want = py_keccak256(data)
    assert native.keccak256(data) == want == ref_native.keccak256(data)


def test_hash_batches():
    rng = random.Random(11)
    items = [rng.randbytes(n) for n in (0, 1, 10, 55, 56, 64, 100, 136, 300, 1000)]
    sha = native.sha256_batch(items, n_threads=3)
    kec = native.keccak256_batch(items)
    np.testing.assert_array_equal(sha, ref_native.sha256_batch(items))
    np.testing.assert_array_equal(kec, ref_native.keccak256_batch(items))
    for item, s, k in zip(items, sha, kec):
        assert s.tobytes() == hashlib.sha256(item).digest()
        assert k.tobytes() == py_keccak256(item)


# ── Ethereum ECDSA ──────────────────────────────────────────────────────


@pytest.mark.parametrize("seed", [1, 2, 0xDEADBEEF, 2**200 + 7, 2**255 + 19])
def test_eth_sign_and_address(seed):
    key = seed.to_bytes(32, "big")
    payload = b"payload-%d" % seed
    r, s, v = sign_recoverable(eip191_hash(payload), seed)
    python_sig = r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([27 + (v & 1)])
    assert native.eth_sign(key, payload) == python_sig == ref_native.eth_sign(key, payload)
    signer = EthereumConsensusSigner(seed)
    assert native.eth_address(key) == signer.identity() == ref_native.eth_address(key)


def _eth_corpus(n=48, seed=5):
    """Signed items plus wrong signers, flipped bytes, bad recovery ids and
    an r of zero: every verdict code."""
    rng = random.Random(seed)
    keys = [rng.getrandbits(255) | 1 for _ in range(n)]
    signers = [EthereumConsensusSigner(k) for k in keys]
    payloads = [rng.randbytes(rng.randrange(0, 90)) for _ in keys]
    sigs = [ref_native.eth_sign(s.private_key_bytes(), p) for s, p in zip(signers, payloads)]
    ids = [s.identity() for s in signers]
    for i in range(0, n, 6):
        ids[i] = ids[(i + 1) % n]  # wrong signer
    for i in range(1, n, 6):
        sigs[i] = bytes([sigs[i][0] ^ 1]) + sigs[i][1:]  # r flipped
    for i in range(2, n, 6):
        sigs[i] = sigs[i][:64] + bytes([29 + i % 3])  # bad recovery id
    for i in range(3, n, 6):
        sigs[i] = b"\x00" * 32 + sigs[i][32:]  # r = 0: recovery fails
    return ids, payloads, sigs


def test_eth_verify_codes():
    ids, payloads, sigs = _eth_corpus()
    batch = native.eth_verify_batch(ids, payloads, sigs, n_threads=2)
    np.testing.assert_array_equal(batch, ref_native.eth_verify_batch(ids, payloads, sigs))
    np.testing.assert_array_equal(
        native.eth_verify_batch_submit(ids, payloads, sigs).collect(), batch)
    scalar = [native.eth_verify(i, p, s) for i, p, s in zip(ids, payloads, sigs)]
    assert scalar == [ref_native.eth_verify(i, p, s) for i, p, s in zip(ids, payloads, sigs)]
    assert {int(c) for c in batch} == {0, 1, 254, 255}
    assert set(scalar) == {0, 1, -1, -2}


def test_eth_verify_agrees_with_pure_python(native_off):
    ids, payloads, sigs = _eth_corpus(n=12, seed=6)
    codes = ref_native.eth_verify_batch(ids, payloads, sigs)
    verdicts = EthereumConsensusSigner.verify_batch(ids, payloads, sigs)
    for code, verdict in zip(codes, verdicts):
        if code in (0, 1):
            assert verdict is bool(code)
        else:
            assert isinstance(verdict, Exception)


# ── Ed25519 ─────────────────────────────────────────────────────────────

# Small-order points (RFC 8032 encodings): the identity, the point of order
# 2, and the two of order 4 (x = sqrt(-1) with either sign bit).
SMALL_ORDER = [
    (1).to_bytes(32, "little"),
    (P - 1).to_bytes(32, "little"),
    (0).to_bytes(32, "little"),
    bytes(31) + b"\x80",
]


def _ed_corpus(n=24, seed=9):
    """Valid signatures and every rejection: s >= L, a flipped scalar,
    non-canonical y (>= p) for A and for R, wrong keys, and small-order A
    and R with s = 0 (accepted under the cofactored criterion)."""
    rng = random.Random(seed)
    seeds = [rng.randbytes(32) for _ in range(n)]
    pubs = [twin.public_key(s) for s in seeds]
    payloads = [rng.randbytes(rng.randrange(0, 120)) for _ in seeds]
    sigs = [twin.sign(s, p) for s, p in zip(seeds, payloads)]
    for i in range(0, n, 8):
        s_int = int.from_bytes(sigs[i][32:], "little")
        sigs[i] = sigs[i][:32] + (s_int + L).to_bytes(32, "little")
    for i in range(1, n, 8):
        s_int = int.from_bytes(sigs[i][32:], "little")
        sigs[i] = sigs[i][:32] + ((s_int + 3) % L).to_bytes(32, "little")
    for i in range(2, n, 8):
        pubs[i] = (P + 1).to_bytes(32, "little")  # y >= p: non-canonical A
    for i in range(3, n, 8):
        sigs[i] = (P + 2).to_bytes(32, "little") + sigs[i][32:]  # non-canonical R
    for i in range(4, n, 8):
        pubs[i] = pubs[(i + 1) % n]
    for k, a in enumerate(SMALL_ORDER):
        for r in SMALL_ORDER[k:k + 2]:
            pubs.append(a)
            payloads.append(b"small order %d" % k)
            sigs.append(r + bytes(32))
    return pubs, payloads, sigs


def test_ed25519_keys_and_signatures():
    rng = random.Random(3)
    for _ in range(8):
        seed, msg = rng.randbytes(32), rng.randbytes(rng.randrange(0, 200))
        pub = twin.public_key(seed)
        assert native.ed25519_public(seed) == pub == ref_native.ed25519_public(seed)
        sig = twin.sign(seed, msg)
        assert native.ed25519_sign(seed, msg) == sig == ref_native.ed25519_sign(seed, msg)


def test_ed25519_verdicts():
    pubs, payloads, sigs = _ed_corpus()
    want = [int(twin.verify(a, m, s)) for a, m, s in zip(pubs, payloads, sigs)]
    assert 0 < sum(want) < len(want)
    assert [native.ed25519_verify(a, m, s) for a, m, s in zip(pubs, payloads, sigs)] == want
    assert [ref_native.ed25519_verify(a, m, s)
            for a, m, s in zip(pubs, payloads, sigs)] == want
    batch = native.ed25519_verify_batch(pubs, payloads, sigs, n_threads=2)
    assert batch.tolist() == want
    assert ref_native.ed25519_verify_batch(pubs, payloads, sigs).tolist() == want
    assert native.ed25519_verify_batch_submit(pubs, payloads, sigs).collect().tolist() == want
    # An all-valid batch (one linear combination) and its submit twin.
    good = [i for i, w in enumerate(want) if w]
    sub = ([pubs[i] for i in good], [payloads[i] for i in good], [sigs[i] for i in good])
    assert native.ed25519_verify_batch(*sub).tolist() == [1] * len(good)


# ── Columnar wire parse ─────────────────────────────────────────────────


def _wire_votes(seed=4, n=40):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        vote = Vote(
            vote_id=rng.getrandbits(32), vote_owner=rng.randbytes(rng.choice((20, 32))),
            proposal_id=rng.getrandbits(32), timestamp=1_700_000_000 + rng.randrange(1000),
            vote=rng.random() < 0.5, parent_hash=rng.randbytes(32) if i % 3 else b"",
            received_hash=rng.randbytes(32) if i % 2 else b"", vote_hash=rng.randbytes(32),
            signature=rng.randbytes(rng.choice((64, 65))),
        )
        data = vote.encode()
        if i % 7 == 6:
            data = data + b"\x78\x01"  # an unknown field: not canonical
        if i % 11 == 10:
            data = data[:-3]  # truncated
        out.append(data)
    return out


def test_parse_and_hash_vote_columns():
    items = _wire_votes()
    data, offsets = _joined(items)
    cols, flags = native.parse_vote_columns(data, offsets, n_threads=2)
    ref_cols, ref_flags = ref_native.parse_vote_columns(data, offsets)
    np.testing.assert_array_equal(cols, ref_cols)
    np.testing.assert_array_equal(flags, ref_flags)
    assert 0 < int(flags.sum()) < len(items)
    ok = flags == 1
    digests = native.vote_hash_columns(data, cols[ok])
    np.testing.assert_array_equal(digests, ref_native.vote_hash_columns(data, ref_cols[ok]))
    from hashgraph_tpu_torch.protocol import compute_vote_hash

    for row, digest in zip(np.nonzero(ok)[0], digests):
        assert digest.tobytes() == compute_vote_hash(Vote.decode(items[row]))


# ── The engine's pid probe and the pool's gid liveness ─────────────────


def _pid_tables(seed):
    rng = np.random.default_rng(seed)
    pids = np.unique(rng.integers(1, 1 << 33, 800))[:700].astype(np.int64)
    rng.shuffle(pids)
    pids[:3] = [0, np.iinfo(np.int64).max, -5]
    slots = rng.permutation(700).astype(np.int64)
    queries = np.concatenate([
        rng.choice(pids, 400), rng.integers(-(1 << 40), 1 << 40, 300), [-1, -1, 0],
    ]).astype(np.int64)
    rng.shuffle(queries)
    return pids, slots, queries


@pytest.mark.parametrize("seed", [0, 1])
def test_pid_lookup_native_equals_numpy(seed, monkeypatch):
    pids, slots, queries = _pid_tables(seed)
    assert len(queries) >= 512
    table, ref_table = _PidLookup(pids, slots), RefPidLookup(pids, slots)
    np.testing.assert_array_equal(table.keys, ref_table.keys)
    found, out = table.lookup(queries)
    ref_found, ref_out = ref_table.lookup(queries)
    monkeypatch.setattr(native, "_load", lambda: None)
    off_found, off_out = table.lookup(queries)
    for f, o in ((ref_found, ref_out), (off_found, off_out)):
        np.testing.assert_array_equal(found, f)
        np.testing.assert_array_equal(out, o)
    assert found[queries == -1].sum() == 0 and 0 < found.sum() < len(queries)
    # Below the threshold the numpy probe runs; the answer is the same.
    np.testing.assert_array_equal(table.lookup(queries[:100])[1], out[:100])


def _churned_pools():
    """A port pool and the JAX pool after the same interning, lane claims
    and releases: freed gids, recycled indices under new generations."""
    pools = (ProposalPool(16, 8, device="cpu"), RefPool(16, 8))
    stale = []
    for pool in pools:
        pool.allocate_batch(
            keys=[("s", i) for i in range(6)], n=np.full(6, 8), req=np.full(6, 6),
            cap=np.full(6, 0), gossip=np.ones(6, bool), liveness=np.ones(6, bool),
            expiry=np.full(6, 100), created_at=np.zeros(6))
        gids = []
        for i in range(6):
            for j in range(8):
                owner = bytes([i, j]) * 10
                gids.append(pool.voter_gid(owner))
                pool.lane_for(i, owner)
        pool.release([1, 3])
        for j in range(8):
            pool.voter_gid(bytes([9, j]) * 10)  # claims recycled indices
        stale.append(gids)
    assert stale[0] == stale[1]
    return pools, np.array(stale[0], np.int64)


def test_gids_live_native_equals_numpy(monkeypatch):
    (pool, ref_pool), held = _churned_pools()
    current = np.array([pool.voter_gid(o) for o in pool._gid_of], np.int64)
    rng = np.random.default_rng(7)
    gids = np.concatenate([
        rng.choice(held, 300), rng.choice(current, 200),
        [-1, -(1 << 40), 1 << 31, (5 << 32) | 3, len(pool._owners) + 4],
        rng.integers(0, 1 << 34, 100),
    ]).astype(np.int64)
    assert len(gids) >= 512
    live = pool.gids_live(gids)
    np.testing.assert_array_equal(live, ref_pool.gids_live(gids))
    monkeypatch.setattr(native, "_load", lambda: None)
    np.testing.assert_array_equal(live, pool.gids_live(gids))
    assert 0 < live.sum() < len(gids)
    # The owners of released slot 1 were freed: their gids are stale.
    assert not pool.gids_live(held[8:16]).any() and pool.gids_live(held[:8]).all()
