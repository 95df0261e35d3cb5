"""Copy of ``hashgraph_tpu/signing/ethereum.py`` for the PyTorch port, which
imports nothing of the JAX package.

ECDSA-secp256k1 signing scheme with Ethereum conventions.

Matches the reference's default scheme (reference: src/signing/ethereum.rs):
identity is the 20-byte Ethereum address, signatures are 65-byte recoverable
``r || s || v`` over the EIP-191 prefixed message, and verification recovers
the address and compares. Implemented on pure-Python secp256k1 + Keccak so the
framework has zero non-baked dependencies; the native runtime accelerates bulk
verification.
"""

from __future__ import annotations

import secrets

from ..errors import ConsensusSchemeError
from .. import native
from . import ConsensusSignatureScheme, PendingVerdicts
from ._keccak import keccak256
from ._secp256k1 import N, pubkey_from_private, recover_pubkey, sign_recoverable

ETHEREUM_SIGNATURE_LENGTH = 65
ETHEREUM_ADDRESS_LENGTH = 20


def eip191_hash(payload: bytes) -> bytes:
    """Keccak-256 of the EIP-191 personal-message envelope.

    The reference signs via alloy's ``sign_message_sync`` which applies the
    same ``"\\x19Ethereum Signed Message:\\n" + len`` prefix
    (reference: src/signing/ethereum.rs:58-64).
    """
    prefix = b"\x19Ethereum Signed Message:\n" + str(len(payload)).encode("ascii")
    return keccak256(prefix + payload)


def address_from_pubkey(pubkey: tuple[int, int]) -> bytes:
    """Last 20 bytes of keccak256(uncompressed public key sans 0x04 prefix)."""
    x, y = pubkey
    return keccak256(x.to_bytes(32, "big") + y.to_bytes(32, "big"))[-20:]


class EthereumConsensusSigner(ConsensusSignatureScheme):
    """Holds a 32-byte private key; identity is the derived 20-byte address."""

    def __init__(self, private_key: bytes | int):
        if isinstance(private_key, bytes):
            if len(private_key) != 32:
                raise ValueError("private key must be 32 bytes")
            private_key = int.from_bytes(private_key, "big")
        if not (1 <= private_key < N):
            raise ValueError("private key out of range for secp256k1")
        self._private_key = private_key
        self._address = address_from_pubkey(pubkey_from_private(private_key))

    @classmethod
    def random(cls) -> "EthereumConsensusSigner":
        """Generate a fresh random signer (PrivateKeySigner::random equivalent)."""
        while True:
            candidate = secrets.randbits(256)
            if 1 <= candidate < N:
                return cls(candidate)

    def identity(self) -> bytes:
        return self._address

    def private_key_bytes(self) -> bytes:
        """Expose key material for interop/tests (inner() equivalent)."""
        return self._private_key.to_bytes(32, "big")

    def sign(self, payload: bytes) -> bytes:
        signature = native.eth_sign(self.private_key_bytes(), payload)
        if signature is not None:
            return signature
        try:
            r, s, v = sign_recoverable(eip191_hash(payload), self._private_key)
        except Exception as exc:  # pragma: no cover - curve math never fails in practice
            raise ConsensusSchemeError.sign(str(exc)) from exc
        return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([27 + (v & 1)])

    @classmethod
    def verify(cls, identity: bytes, payload: bytes, signature: bytes) -> bool:
        # Length checks raise scheme errors, mirroring the reference
        # (reference: src/signing/ethereum.rs:71-82).
        if len(signature) != ETHEREUM_SIGNATURE_LENGTH:
            raise ConsensusSchemeError.verify(
                f"expected {ETHEREUM_SIGNATURE_LENGTH}-byte signature, got {len(signature)}"
            )
        if len(identity) != ETHEREUM_ADDRESS_LENGTH:
            raise ConsensusSchemeError.verify(
                f"expected {ETHEREUM_ADDRESS_LENGTH}-byte address, got {len(identity)}"
            )

        r = int.from_bytes(signature[0:32], "big")
        s = int.from_bytes(signature[32:64], "big")
        v = signature[64]
        if v >= 27:
            v -= 27
        if v > 1:
            raise ConsensusSchemeError.verify(f"invalid recovery id byte: {signature[64]}")

        verdict = native.eth_verify(bytes(identity), payload, signature)
        if verdict is not None:
            if verdict == -2:
                raise ConsensusSchemeError.verify("signature recovery failed")
            return verdict == 1

        pubkey = recover_pubkey(eip191_hash(payload), r, s, v)
        if pubkey is None:
            raise ConsensusSchemeError.verify("signature recovery failed")
        return address_from_pubkey(pubkey) == bytes(identity)

    @classmethod
    def _precheck(
        cls,
        identities: list[bytes],
        payloads: list[bytes],
        signatures: list[bytes],
    ) -> "tuple[list, list[int]]":
        """Length gauntlet shared by the sync and async batch paths:
        returns (out list with scheme errors pre-filled, well-formed row
        indices). zip() truncation keeps the base-class contract for
        ragged inputs."""
        well_formed: list[int] = []
        out: list[bool | ConsensusSchemeError] = []
        for i, (identity, _payload, signature) in enumerate(
            zip(identities, payloads, signatures)
        ):
            if len(signature) != ETHEREUM_SIGNATURE_LENGTH:
                out.append(
                    ConsensusSchemeError.verify(
                        f"expected {ETHEREUM_SIGNATURE_LENGTH}-byte signature, "
                        f"got {len(signature)}"
                    )
                )
            elif len(identity) != ETHEREUM_ADDRESS_LENGTH:
                out.append(
                    ConsensusSchemeError.verify(
                        f"expected {ETHEREUM_ADDRESS_LENGTH}-byte address, "
                        f"got {len(identity)}"
                    )
                )
            else:
                out.append(False)  # placeholder
                well_formed.append(i)
        return out, well_formed

    @classmethod
    def verify_batch(
        cls,
        identities: list[bytes],
        payloads: list[bytes],
        signatures: list[bytes],
    ) -> list[bool | ConsensusSchemeError]:
        """Native threaded batch verification (GIL released for the whole
        batch); falls back to the scalar loop without the native runtime."""
        out, well_formed = cls._precheck(identities, payloads, signatures)
        if not well_formed:
            return out
        results = native.eth_verify_batch(
            [bytes(identities[i]) for i in well_formed],
            [payloads[i] for i in well_formed],
            [signatures[i] for i in well_formed],
        )
        if results is None:
            for i in well_formed:
                try:
                    out[i] = cls.verify(identities[i], payloads[i], signatures[i])
                except ConsensusSchemeError as exc:
                    out[i] = exc
            return out
        cls._fan_out_codes(out, well_formed, results, signatures)
        return out

    @staticmethod
    def _fan_out_codes(out, well_formed, results, signatures) -> None:
        """Map native result codes onto the verdict list (shared by the
        sync and async batch paths)."""
        for i, code in zip(well_formed, results):
            if code == 1:
                out[i] = True
            elif code == 0:
                out[i] = False
            elif code == 254:
                out[i] = ConsensusSchemeError.verify("signature recovery failed")
            else:
                out[i] = ConsensusSchemeError.verify(
                    f"invalid recovery id byte: {signatures[i][64]}"
                )

    @classmethod
    def verify_batch_submit(
        cls,
        identities: list[bytes],
        payloads: list[bytes],
        signatures: list[bytes],
    ) -> PendingVerdicts:
        """Async :meth:`verify_batch` on the persistent native pool:
        returns immediately, the ECDSA runs GIL-free on worker threads,
        and ``collect()`` fans out the identical verdicts. Degrades to
        the deferred-sync default without the native runtime."""
        out, well_formed = cls._precheck(identities, payloads, signatures)
        job = (
            native.eth_verify_batch_submit(
                [bytes(identities[i]) for i in well_formed],
                [payloads[i] for i in well_formed],
                [signatures[i] for i in well_formed],
            )
            if well_formed
            else None
        )
        if well_formed and job is None:
            return super().verify_batch_submit(identities, payloads, signatures)

        def _collect():
            if job is not None:
                cls._fan_out_codes(out, well_formed, job.collect(), signatures)
            return out

        return PendingVerdicts(_collect)
