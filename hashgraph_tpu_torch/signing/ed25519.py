"""Ed25519 signing scheme, with batch verification on the host or the GPU.

Port of ``hashgraph_tpu/signing/ed25519.py``. Identity is the 32-byte public
key; signatures are 64-byte ``R || S`` over the raw payload (RFC 8032, no
envelope; the payload is already the canonical signed-fields encoding).
Ed25519 verification equations combine algebraically: a random linear
combination verifies a whole batch with one multi-scalar multiply, which
:class:`Ed25519DeviceConsensusSigner` runs on the GPU through
:mod:`hashgraph_tpu_torch.crypto_device`.

Verification is *cofactored* (accept iff ``8·(s·B - h·A - R)`` is the
identity) with RFC 8032 canonical-encoding rejections — the only criterion
under which scalar and batch verdicts provably agree on every input. The host
path is the native runtime (:mod:`hashgraph_tpu_torch.native`: signing,
scalar verification, and batch verification as one randomized linear
combination a chunk across its worker pool), as in the JAX package, and the
pure-Python twin (:mod:`._ed25519`) where the library is absent.
"""

from __future__ import annotations

import os
import secrets

from .. import native
from ..errors import ConsensusSchemeError
from . import ConsensusSignatureScheme, PendingVerdicts
from . import _ed25519 as _py

ED25519_SIGNATURE_LENGTH = 64
ED25519_IDENTITY_LENGTH = 32

# Backend selector for batch verification: instances resolve
# device_verify=None against this env at construction. "1"/"on"/"true"
# constructs the device signer; anything else keeps the host path.
DEVICE_VERIFY_ENV = "HASHGRAPH_TPU_DEVICE_VERIFY"


def _device_verify_default() -> bool:
    return os.environ.get(DEVICE_VERIFY_ENV, "").lower() in ("1", "on", "true")


class Ed25519ConsensusSigner(ConsensusSignatureScheme):
    """Holds a 32-byte seed; identity is the derived public key.

    ``device_verify`` selects the batch-verification backend:

    - ``None`` (default): consult ``HASHGRAPH_TPU_DEVICE_VERIFY``;
    - ``True``: the instance is constructed as
      :class:`Ed25519DeviceConsensusSigner`, whose class-level batch
      verifiers run on the GPU (engines resolve scheme methods through
      ``type(signer)``, so the choice rides the instance into every
      ``verify_batch_submit`` call site);
    - ``False``: the host path even when the env is set.

    Selecting the device signer without a GPU raises: it never quietly
    degrades to the host path. Signing and scalar ``verify`` are host-side
    in every case; the backends differ only in who executes the batch
    equation, never in verdicts.
    """

    def __new__(cls, seed: bytes = b"", device_verify: "bool | None" = None):
        if cls is Ed25519ConsensusSigner:
            enabled = (
                _device_verify_default()
                if device_verify is None
                else bool(device_verify)
            )
            if enabled:
                cls = Ed25519DeviceConsensusSigner
        return super().__new__(cls)

    def __init__(self, seed: bytes, device_verify: "bool | None" = None):
        del device_verify  # consumed by __new__ (class identity carries it)
        if len(seed) != 32:
            raise ValueError("ed25519 seed must be 32 bytes")
        self._seed = bytes(seed)
        pub = native.ed25519_public(self._seed)
        self._public = pub if pub is not None else _py.public_key(self._seed)

    @classmethod
    def random(cls) -> "Ed25519ConsensusSigner":
        return cls(secrets.token_bytes(32))

    def identity(self) -> bytes:
        return self._public

    def private_key_bytes(self) -> bytes:
        """Expose the seed for interop/tests (inner() equivalent)."""
        return self._seed

    def sign(self, payload: bytes) -> bytes:
        signature = native.ed25519_sign(self._seed, payload)
        if signature is not None:
            return signature
        return _py.sign(self._seed, payload)

    @classmethod
    def _check_lengths(cls, identity: bytes, signature: bytes) -> None:
        if len(signature) != ED25519_SIGNATURE_LENGTH:
            raise ConsensusSchemeError.verify(
                f"expected {ED25519_SIGNATURE_LENGTH}-byte signature, "
                f"got {len(signature)}"
            )
        if len(identity) != ED25519_IDENTITY_LENGTH:
            raise ConsensusSchemeError.verify(
                f"expected {ED25519_IDENTITY_LENGTH}-byte public key, "
                f"got {len(identity)}"
            )

    @classmethod
    def verify(cls, identity: bytes, payload: bytes, signature: bytes) -> bool:
        # Wrong lengths are scheme errors (the Ethereum convention);
        # length-valid but undecodable points and non-canonical scalars
        # are False — on the wire they are indistinguishable from forged
        # signatures, and the batch path reports them the same way.
        cls._check_lengths(identity, signature)
        verdict = native.ed25519_verify(
            bytes(identity), payload, bytes(signature)
        )
        if verdict is not None:
            return verdict == 1
        return _py.verify(bytes(identity), payload, bytes(signature))

    @classmethod
    def _precheck(
        cls,
        identities: list[bytes],
        payloads: list[bytes],
        signatures: list[bytes],
    ) -> "tuple[list, list[int]]":
        """Length gauntlet shared by the batch paths: returns (out list
        with scheme errors pre-filled, well-formed row indices). zip()
        truncation keeps the ragged-input contract."""
        out: list = []
        well_formed: list[int] = []
        for i, (identity, _payload, signature) in enumerate(
            zip(identities, payloads, signatures)
        ):
            try:
                cls._check_lengths(identity, signature)
            except ConsensusSchemeError as exc:
                out.append(exc)
                continue
            out.append(False)  # placeholder
            well_formed.append(i)
        return out, well_formed

    @classmethod
    def verify_batch(
        cls,
        identities: list[bytes],
        payloads: list[bytes],
        signatures: list[bytes],
    ) -> list:
        """Native batched verification: chunks verify as ONE randomized
        linear combination (a single multi-scalar multiply) on the
        persistent worker pool; falls back to the twin, item by item,
        without the native runtime."""
        out, well_formed = cls._precheck(identities, payloads, signatures)
        if not well_formed:
            return out
        results = native.ed25519_verify_batch(
            [bytes(identities[i]) for i in well_formed],
            [payloads[i] for i in well_formed],
            [bytes(signatures[i]) for i in well_formed],
        )
        if results is None:
            for i in well_formed:
                out[i] = _py.verify(
                    bytes(identities[i]), payloads[i], bytes(signatures[i])
                )
            return out
        for i, code in zip(well_formed, results):
            out[i] = bool(code == 1)
        return out

    @classmethod
    def verify_batch_submit(
        cls,
        identities: list[bytes],
        payloads: list[bytes],
        signatures: list[bytes],
    ) -> PendingVerdicts:
        """Start the batch on the native pool NOW; collect() fans the
        codes out exactly as :meth:`verify_batch` would. Without the
        native runtime this degrades to the deferred-sync default."""
        out, well_formed = cls._precheck(identities, payloads, signatures)
        job = (
            native.ed25519_verify_batch_submit(
                [bytes(identities[i]) for i in well_formed],
                [payloads[i] for i in well_formed],
                [bytes(signatures[i]) for i in well_formed],
            )
            if well_formed
            else None
        )
        if well_formed and job is None:
            return super().verify_batch_submit(identities, payloads, signatures)

        def _collect():
            if job is not None:
                for i, code in zip(well_formed, job.collect()):
                    out[i] = bool(code == 1)
            return out

        return PendingVerdicts(_collect)


class Ed25519DeviceConsensusSigner(Ed25519ConsensusSigner):
    """Ed25519 with batch verification on the GPU.

    Same wire format, same seed handling, same scalar ``verify``, same
    *cofactored* acceptance criterion — a backend, not a divergence:
    ``verify_batch``/``verify_batch_submit`` run the whole batch equation
    (decompression, SHA-512 challenge hashes, the randomized Straus MSM)
    through :mod:`hashgraph_tpu_torch.crypto_device`, with host blame for
    exact per-item verdicts when the combination fails.

    The class attribute :attr:`device` is the one seam that picks where the
    batch runs: ``"cuda"`` here, so construction raises without a GPU. A
    caller that wants the CPU asks for it with a subclass that sets it
    (``class CpuSigner(Ed25519DeviceConsensusSigner): device = "cpu"``);
    since verification is a classmethod that engines resolve through
    ``type(signer)``, the choice rides the signer into every engine.
    """

    device = "cuda"

    def __init__(self, seed: bytes, device_verify: "bool | None" = None):
        from ..engine.pool import resolve_device

        resolve_device(type(self).device)
        super().__init__(seed)

    @classmethod
    def device_phase_seconds(cls) -> "dict[str, float]":
        """Per-phase seconds of the backend's most recent batch (submit /
        decompress / hash / msm / fallback / total)."""
        from .. import crypto_device

        return crypto_device.last_phase_seconds()

    @classmethod
    def verify_batch(
        cls,
        identities: "list[bytes]",
        payloads: "list[bytes]",
        signatures: "list[bytes]",
    ) -> list:
        return cls.verify_batch_submit(
            identities, payloads, signatures
        ).collect()

    @classmethod
    def verify_batch_submit(
        cls,
        identities: "list[bytes]",
        payloads: "list[bytes]",
        signatures: "list[bytes]",
    ) -> PendingVerdicts:
        """Enqueue decompression + challenge hashing on the device now;
        ``collect()`` finishes the MSM and fans out verdicts (falling back
        to the host twin for per-item blame on batch failure). Scheme
        errors and ragged truncation are handled by the shared precheck,
        byte-compatible with the host path."""
        from .. import crypto_device

        out, well_formed = cls._precheck(identities, payloads, signatures)
        if not well_formed:
            return PendingVerdicts(lambda: out)
        collect_device = crypto_device.verify_batch_begin(
            [bytes(identities[i]) for i in well_formed],
            [payloads[i] for i in well_formed],
            [bytes(signatures[i]) for i in well_formed],
            device=cls.device,
        )

        def _collect():
            for i, verdict in zip(well_formed, collect_device()):
                out[i] = bool(verdict)
            return out

        return PendingVerdicts(_collect)
