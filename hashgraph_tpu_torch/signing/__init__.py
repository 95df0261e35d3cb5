"""Copy of ``hashgraph_tpu/signing/__init__.py`` for the PyTorch port, which imports
nothing of the JAX package.

Pluggable signature schemes for vote authentication.

Mirrors the reference's scheme abstraction (reference: src/signing.rs:46-74):
a scheme instance carries private state and produces signatures via
``identity()`` / ``sign()``; the scheme *type* verifies incoming signatures via
the class-level ``verify()``. All peers on a network must use the same scheme.

Verification runs on the host (the native runtime,
:mod:`hashgraph_tpu_torch.native`, where it is built, else pure Python),
except the batch verification of :class:`Ed25519DeviceConsensusSigner`,
which runs the whole batch equation on the GPU
(:mod:`hashgraph_tpu_torch.crypto_device`); the vote tally and decision
state live on the device in every case.
"""

from __future__ import annotations

import abc

from ..errors import ConsensusSchemeError

__all__ = [
    "ConsensusSignatureScheme",
    "ConsensusSchemeError",
    "Ed25519ConsensusSigner",
    "Ed25519DeviceConsensusSigner",
    "EthereumConsensusSigner",
    "PendingVerdicts",
    "StubConsensusSigner",
]


class PendingVerdicts:
    """Handle for an in-flight :meth:`~ConsensusSignatureScheme.verify_batch`.

    ``collect()`` blocks until the batch resolves and returns exactly what
    the synchronous call would have: one ``bool | ConsensusSchemeError``
    per item. The default implementation simply defers the synchronous
    batch to collect time; schemes with a native worker pool (Ethereum,
    Ed25519) wrap an async submission instead, so the crypto runs on
    background threads — GIL-free — between submit and collect. Collect
    is idempotent; the first call does the waiting.
    """

    def __init__(self, collect_fn):
        self._collect_fn = collect_fn
        self._result = None

    def collect(self) -> "list[bool | ConsensusSchemeError]":
        if self._collect_fn is not None:
            self._result = self._collect_fn()
            self._collect_fn = None
        return self._result


class ConsensusSignatureScheme(abc.ABC):
    """A signature scheme the consensus service uses to sign and verify votes
    (reference: src/signing.rs:46-74)."""

    @abc.abstractmethod
    def identity(self) -> bytes:
        """Stable identity bytes for this signer (address / public key / id).
        Written into ``Vote.vote_owner`` when casting."""

    @abc.abstractmethod
    def sign(self, payload: bytes) -> bytes:
        """Sign ``payload`` and return raw signature bytes."""

    @classmethod
    @abc.abstractmethod
    def verify(cls, identity: bytes, payload: bytes, signature: bytes) -> bool:
        """Verify ``signature`` over ``payload`` against ``identity``.

        Returns True/False for well-formed inputs; raises
        :class:`ConsensusSchemeError` for malformed ones (wrong lengths etc.).
        """

    @classmethod
    def verify_batch(
        cls,
        identities: list[bytes],
        payloads: list[bytes],
        signatures: list[bytes],
    ) -> list[bool | ConsensusSchemeError]:
        """Bulk verification for the ingest pipeline: one entry per item,
        either the boolean verdict or the scheme error that ``verify`` would
        have raised. Default is a scalar loop; schemes with a native batched
        path (Ethereum) override this."""
        out: list[bool | ConsensusSchemeError] = []
        for identity, payload, signature in zip(identities, payloads, signatures):
            try:
                out.append(cls.verify(identity, payload, signature))
            except ConsensusSchemeError as exc:
                out.append(exc)
        return out

    @classmethod
    def verify_batch_submit(
        cls,
        identities: list[bytes],
        payloads: list[bytes],
        signatures: list[bytes],
    ) -> PendingVerdicts:
        """Asynchronous :meth:`verify_batch` for the pipelined ingest
        path: returns immediately; ``collect()`` yields the identical
        verdict list. The default defers the synchronous batch to
        collect time (observationally identical — verdicts are values,
        never raises), so every scheme is pipeline-compatible; schemes
        backed by the native worker pool override this to start the
        crypto NOW and overlap it with device work."""
        return PendingVerdicts(
            lambda: cls.verify_batch(identities, payloads, signatures)
        )


from .ed25519 import (  # noqa: E402
    Ed25519ConsensusSigner,
    Ed25519DeviceConsensusSigner,
)
from .ethereum import EthereumConsensusSigner  # noqa: E402
from .stub import StubConsensusSigner  # noqa: E402
