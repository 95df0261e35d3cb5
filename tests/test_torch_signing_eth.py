"""The port's ``EthereumConsensusSigner`` against the JAX package's.

The cases of ``tests/test_signing.py`` and ``tests/test_scheme_conformance.py``
run on the port's signer, once through the port's native runtime and once
with it forced off (the pure-Python secp256k1 and Keccak), and every
signature, address and verdict is held equal to the JAX package's signer on
the same seeded keys and payloads (tolerance: exact; a scheme error must be
a scheme error on both sides).
"""

import random

import pytest

from hashgraph_tpu.signing import EthereumConsensusSigner as RefSigner
from hashgraph_tpu_torch import EthereumConsensusSigner as PortSignerRoot
from hashgraph_tpu_torch import native
from hashgraph_tpu_torch.errors import ConsensusSchemeError
from hashgraph_tpu_torch.signing import (
    EthereumConsensusSigner,
    PendingVerdicts,
    StubConsensusSigner,
)
from hashgraph_tpu_torch.signing._keccak import keccak256
from hashgraph_tpu_torch.signing.ethereum import (
    address_from_pubkey,
    eip191_hash,
)
from hashgraph_tpu_torch.signing._secp256k1 import pubkey_from_private


@pytest.fixture(params=["native", "python"])
def mode(request, monkeypatch):
    """Which host path the port's signer takes."""
    if request.param == "python":
        monkeypatch.setattr(native, "_load", lambda: None)
    else:
        assert native.available()
    return request.param


def keys(seed, n):
    rng = random.Random(seed)
    return [rng.getrandbits(255) | 1 for _ in range(n)]


def kind(verdict):
    """A verdict as compared across packages: the bool, or "error"."""
    if isinstance(verdict, Exception):
        assert type(verdict).__name__ == "ConsensusSchemeError", verdict
        return "error"
    return verdict


def verify_kind(cls, identity, payload, sig):
    try:
        return cls.verify(identity, payload, sig)
    except Exception as exc:  # noqa: BLE001 - compared by kind()
        return kind(exc)


def batch(seed, n=6):
    """n signed items from 3 seeded keys, as (port signers, JAX signers,
    identities, payloads, signatures); both packages sign each item and the
    bytes must be equal."""
    ks = keys(seed, 3)
    port = [EthereumConsensusSigner(k) for k in ks]
    ref = [RefSigner(k) for k in ks]
    idents, payloads, sigs = [], [], []
    for i in range(n):
        payload = b"payload-%d" % i
        sig = port[i % 3].sign(payload)
        assert sig == ref[i % 3].sign(payload)
        idents.append(port[i % 3].identity())
        payloads.append(payload)
        sigs.append(sig)
    return idents, payloads, sigs


# ── tests/test_signing.py ───────────────────────────────────────────────


def test_keccak_known_vectors():
    assert keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")
    assert len(keccak256(b"x" * 500)) == 32


def test_known_address(mode):
    signer = EthereumConsensusSigner(1)
    assert signer.identity().hex() == "7e5f4552091a69125d5dfcb7b8c2659029395bdf"
    assert signer.identity() == RefSigner(1).identity()
    assert address_from_pubkey(pubkey_from_private(1)) == signer.identity()


def test_interop_vector(mode):
    pk = bytes.fromhex("4c0883a69102937d6231471b5dbb6204fe5129617082792ae468d01a3f362318")
    msg = b"Some data"
    assert eip191_hash(msg).hex() == (
        "1da44b586eb0729ff70a73c326926f6ed5a25f5b056e7f47fbc6e58d86871655")
    sig = EthereumConsensusSigner(pk).sign(msg)
    assert sig.hex() == (
        "b91467e570a6466aa9e9876cbcd013baba02900b8979d43fe208a4a4f339f5fd"
        "6007e74cd82e037b800186422fc2da167c747ef045e5d18a5f5d4300f8e1a029"
        "1c")
    assert sig == RefSigner(pk).sign(msg)


def test_sign_verify_roundtrip_and_tamper(mode):
    a, b = (EthereumConsensusSigner(k) for k in keys(1, 2))
    sig = a.sign(b"payload")
    assert len(sig) == 65 and sig == RefSigner(a.private_key_bytes()).sign(b"payload")
    cases = [(a.identity(), b"payload", sig), (b.identity(), b"payload", sig),
             (a.identity(), b"payloaX", sig)]
    got = [verify_kind(EthereumConsensusSigner, *c) for c in cases]
    assert got == [True, False, False]
    assert got == [verify_kind(RefSigner, *c) for c in cases]


def test_wrong_lengths_raise(mode):
    signer = EthereumConsensusSigner(keys(2, 1)[0])
    sig = signer.sign(b"p")
    for identity, signature in ((signer.identity(), b"\x00" * 64),
                                (b"\x00" * 19, sig), (signer.identity(), sig[:64] + b"\x63")):
        with pytest.raises(ConsensusSchemeError):
            EthereumConsensusSigner.verify(identity, b"p", signature)
        assert verify_kind(RefSigner, identity, b"p", signature) == "error"


def test_deterministic_signatures_and_bad_keys(mode):
    signer = EthereumConsensusSigner(12345)
    assert signer.sign(b"x") == signer.sign(b"x") == RefSigner(12345).sign(b"x")
    for bad in (0, b"short", 2**256 - 1):
        with pytest.raises(ValueError):
            EthereumConsensusSigner(bad)


def test_random_signer_and_root_export():
    assert PortSignerRoot is EthereumConsensusSigner
    signer = EthereumConsensusSigner.random()
    assert len(signer.identity()) == 20
    assert signer.identity() == RefSigner(signer.private_key_bytes()).identity()


def test_stub_roundtrip():
    s = StubConsensusSigner(b"peer-1")
    sig = s.sign(b"data")
    assert StubConsensusSigner.verify(b"peer-1", b"data", sig)
    assert not StubConsensusSigner.verify(b"peer-2", b"data", sig)
    with pytest.raises(ValueError):
        StubConsensusSigner(b"")


# ── tests/test_scheme_conformance.py, the Ethereum rows ────────────────


def test_scalar_vs_batch_equivalence(mode):
    idents, payloads, sigs = batch(3)
    sigs[1] = bytes([sigs[1][0] ^ 1]) + sigs[1][1:]
    idents[2], idents[3] = idents[3], idents[2]
    sigs[4] = b"short"
    sigs[5] = sigs[5][:64] + bytes([31])
    got = [kind(v) for v in EthereumConsensusSigner.verify_batch(idents, payloads, sigs)]
    assert got == [kind(v) for v in RefSigner.verify_batch(idents, payloads, sigs)]
    assert got == [verify_kind(EthereumConsensusSigner, *c)
                   for c in zip(idents, payloads, sigs)]
    assert got[0] is True and got[1] in (False, "error") and got[4] == got[5] == "error"


def test_submit_collect_matches_batch(mode):
    idents, payloads, sigs = batch(4)
    sigs[0] = bytes([sigs[0][0] ^ 1]) + sigs[0][1:]
    pend = EthereumConsensusSigner.verify_batch_submit(idents, payloads, sigs)
    assert isinstance(pend, PendingVerdicts)
    got = pend.collect()
    want = EthereumConsensusSigner.verify_batch(idents, payloads, sigs)
    assert [kind(v) for v in got] == [kind(v) for v in want]
    assert [kind(v) for v in got] == [
        kind(v) for v in RefSigner.verify_batch_submit(idents, payloads, sigs).collect()]
    assert pend.collect() is got


def test_ragged_inputs_and_empty_batches(mode):
    idents, payloads, sigs = batch(5, n=4)
    out = EthereumConsensusSigner.verify_batch(idents, payloads[:2], sigs)
    assert out == [True, True]
    assert len(EthereumConsensusSigner.verify_batch_submit(
        idents[:3], payloads, sigs).collect()) == 3
    assert EthereumConsensusSigner.verify_batch([], [], []) == []
    assert EthereumConsensusSigner.verify_batch_submit([], [], []).collect() == []


def test_malformed_lengths_are_scheme_errors(mode):
    signer = EthereumConsensusSigner(keys(6, 1)[0])
    sig = signer.sign(b"p")
    args = ([signer.identity(), b"\x01" * 5, signer.identity()], [b"p"] * 3,
            [sig, sig, b"xx"])
    out = [kind(v) for v in EthereumConsensusSigner.verify_batch(*args)]
    assert out == [True, "error", "error"]
    assert out == [kind(v) for v in RefSigner.verify_batch(*args)]


def test_seeded_corpus_equal_to_reference(mode):
    """48 seeded keys: wrong signers, flipped r bytes, bad recovery ids,
    r = 0 — every verdict equal to the JAX signer's, scalar and batch."""
    ks = keys(7, 24)
    rng = random.Random(8)
    idents, payloads, sigs = [], [], []
    for i, k in enumerate(ks):
        port, ref = EthereumConsensusSigner(k), RefSigner(k)
        payload = rng.randbytes(rng.randrange(1, 80))
        sig = port.sign(payload)
        assert sig == ref.sign(payload)
        ident = port.identity()
        if i % 4 == 1:
            ident = EthereumConsensusSigner(ks[(i + 1) % len(ks)]).identity()
        elif i % 4 == 2:
            sig = bytes([sig[0] ^ 0x40]) + sig[1:]
        elif i % 4 == 3:
            sig = b"\x00" * 32 + sig[32:] if i % 8 == 3 else sig[:64] + bytes([30])
        idents.append(ident)
        payloads.append(payload)
        sigs.append(sig)
    got = [kind(v) for v in EthereumConsensusSigner.verify_batch(idents, payloads, sigs)]
    assert got == [kind(v) for v in RefSigner.verify_batch(idents, payloads, sigs)]
    assert got == [verify_kind(RefSigner, *c) for c in zip(idents, payloads, sigs)]
    assert {True, False, "error"} <= set(got)
