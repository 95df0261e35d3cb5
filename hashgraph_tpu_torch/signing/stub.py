"""Copy of ``hashgraph_tpu/signing/stub.py`` for the PyTorch port, which imports
nothing of the JAX package.

Deterministic hash-based stub scheme for tests and benchmarks.

Equivalent in role to the reference's test ``StubSigner``
(reference: tests/custom_scheme_tests.rs:32-72): the "signature" is
SHA-256(identity || payload), so any holder of the identity bytes can produce
it. Proves the service is scheme-agnostic; also used by throughput benchmarks
where ECDSA cost would measure the signer, not the engine.
"""

from __future__ import annotations

import hashlib

from . import ConsensusSignatureScheme


class StubConsensusSigner(ConsensusSignatureScheme):
    def __init__(self, identity: bytes):
        if not identity:
            raise ValueError("stub identity must be non-empty")
        self._identity = bytes(identity)

    def identity(self) -> bytes:
        return self._identity

    def sign(self, payload: bytes) -> bytes:
        return hashlib.sha256(self._identity + payload).digest()

    @classmethod
    def verify(cls, identity: bytes, payload: bytes, signature: bytes) -> bool:
        return hashlib.sha256(bytes(identity) + payload).digest() == signature
