"""Copy of ``hashgraph_tpu/wire.py`` for the PyTorch port, which imports
nothing of the JAX package.

Wire data model: ``Proposal`` and ``Vote`` messages with a protobuf codec.

Byte-compatible with the reference schema
(reference: src/protos/messages/v1/consensus.proto:5-29) as encoded by prost:
proto3 semantics, fields emitted in ascending field-number order, and
default-valued scalar fields (0 / false / empty) omitted. The vote signature is
computed over exactly this encoding with the ``signature`` field blanked
(reference: src/utils.rs:93-97, 150-153), so encoding fidelity is
load-bearing for cross-implementation signature verification.

The codec is hand-rolled (no generated code) so the framework controls every
byte; it is a few hundred lines and covers only the two message types the
protocol uses.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["Vote", "Proposal"]


def normalize_wire_votes(wire_votes, count: int) -> "tuple[bytes, np.ndarray]":
    """Normalize a columnar ``wire_votes`` argument — a list of encoded
    Vote bytes, or an already-packed ``(data, offsets)`` pair — to one
    packed blob plus validated int64 row offsets. Shared by the engine's
    columnar ingest (which views the blob as uint8) and the WAL's columnar
    records (which store it verbatim), so the two layers cannot drift on
    what a well-formed batch is."""
    if isinstance(wire_votes, tuple):
        data, offsets = wire_votes
        blob = (
            bytes(data)
            if isinstance(data, (bytes, bytearray, memoryview))
            else np.asarray(data, np.uint8).tobytes()
        )
        offsets = np.asarray(offsets, np.int64)
    else:
        blob = b"".join(wire_votes)
        offsets = np.zeros(len(wire_votes) + 1, np.int64)
        np.cumsum([len(b) for b in wire_votes], out=offsets[1:])
    if len(offsets) != count + 1:
        raise ValueError("wire_votes must supply one entry per batch row")
    if len(offsets) and int(offsets[-1]) > len(blob):
        raise ValueError("wire_votes offsets exceed the packed data")
    if len(offsets) and (int(offsets[0]) < 0 or (np.diff(offsets) < 0).any()):
        raise ValueError(
            "wire_votes offsets must be non-negative and non-decreasing"
        )
    return blob, offsets

_U32_MASK = 0xFFFFFFFF
_U64_MASK = 0xFFFFFFFFFFFFFFFF

# Wire types
_VARINT = 0
_LEN = 2


def _encode_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _encode_tag(out: bytearray, field_number: int, wire_type: int) -> None:
    _encode_varint(out, (field_number << 3) | wire_type)


def _encode_uint_field(out: bytearray, field_number: int, value: int) -> None:
    if value:
        _encode_tag(out, field_number, _VARINT)
        _encode_varint(out, value)


def _encode_bool_field(out: bytearray, field_number: int, value: bool) -> None:
    if value:
        _encode_tag(out, field_number, _VARINT)
        out.append(1)


def _encode_bytes_field(out: bytearray, field_number: int, value: bytes) -> None:
    if value:
        _encode_tag(out, field_number, _LEN)
        _encode_varint(out, len(value))
        out += value


def _decode_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _checked_end(data: bytes, pos: int, length: int) -> int:
    end = pos + length
    if end > len(data):
        raise ValueError("truncated length-delimited field")
    return end


def _skip_field(data: bytes, pos: int, wire_type: int) -> int:
    if wire_type == _VARINT:
        _, pos = _decode_varint(data, pos)
        return pos
    if wire_type == 1:  # fixed64
        return _checked_end(data, pos, 8)
    if wire_type == _LEN:
        length, pos = _decode_varint(data, pos)
        return _checked_end(data, pos, length)
    if wire_type == 5:  # fixed32
        return _checked_end(data, pos, 4)
    raise ValueError(f"unsupported wire type {wire_type}")


@dataclass(slots=True)
class Vote:
    """A single vote in a consensus proposal.

    Field numbers match the reference schema
    (reference: src/protos/messages/v1/consensus.proto:19-29).
    """

    vote_id: int = 0  # field 20, uint32
    vote_owner: bytes = b""  # field 21
    proposal_id: int = 0  # field 22, uint32
    timestamp: int = 0  # field 23, uint64
    vote: bool = False  # field 24
    parent_hash: bytes = b""  # field 25
    received_hash: bytes = b""  # field 26
    vote_hash: bytes = b""  # field 27
    signature: bytes = b""  # field 28

    def _encode_signed_fields(self, out: bytearray) -> None:
        """Fields 20-27 — everything the signature covers. Shared between
        ``encode`` and ``signing_payload`` so the signed bytes can never
        drift from the wire bytes.

        Specialized by hand (precomputed two-byte tags, inlined varints,
        single-append length prefixes): this runs once per vote on the
        validated ingest hot path, and the generic per-field helper
        stack measured ~11µs/vote of pure interpreter dispatch — more
        than the amortized signature verify it feeds. Byte output is
        identical to the generic encoding (asserted by the wire tests).
        """
        vid = self.vote_id & _U32_MASK
        if vid:
            out += b"\xa0\x01"  # tag(20, varint)
            while vid > 0x7F:
                out.append((vid & 0x7F) | 0x80)
                vid >>= 7
            out.append(vid)
        owner = self.vote_owner
        if owner:
            out += b"\xaa\x01"  # tag(21, len)
            n = len(owner)
            if n > 0x7F:
                _encode_varint(out, n)
            else:
                out.append(n)
            out += owner
        pid = self.proposal_id & _U32_MASK
        if pid:
            out += b"\xb0\x01"  # tag(22, varint)
            while pid > 0x7F:
                out.append((pid & 0x7F) | 0x80)
                pid >>= 7
            out.append(pid)
        ts = self.timestamp & _U64_MASK
        if ts:
            out += b"\xb8\x01"  # tag(23, varint)
            while ts > 0x7F:
                out.append((ts & 0x7F) | 0x80)
                ts >>= 7
            out.append(ts)
        if self.vote:
            out += b"\xc0\x01\x01"  # tag(24, varint) + true
        for tag, value in (
            (b"\xca\x01", self.parent_hash),    # 25
            (b"\xd2\x01", self.received_hash),  # 26
            (b"\xda\x01", self.vote_hash),      # 27
        ):
            if value:
                out += tag
                n = len(value)
                if n > 0x7F:
                    _encode_varint(out, n)
                else:
                    out.append(n)
                out += value

    def encode(self) -> bytes:
        out = bytearray()
        self._encode_signed_fields(out)
        _encode_bytes_field(out, 28, self.signature)
        return bytes(out)

    def signing_payload(self) -> bytes:
        """Encoding with the signature field blanked — the bytes that get
        signed (reference: src/utils.rs:93-95, 150-153)."""
        out = bytearray()
        self._encode_signed_fields(out)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "Vote":
        vote = cls()
        pos = 0
        n = len(data)
        while pos < n:
            key, pos = _decode_varint(data, pos)
            field_number, wire_type = key >> 3, key & 7
            if field_number == 20 and wire_type == _VARINT:
                v, pos = _decode_varint(data, pos)
                vote.vote_id = v & _U32_MASK
            elif field_number == 22 and wire_type == _VARINT:
                v, pos = _decode_varint(data, pos)
                vote.proposal_id = v & _U32_MASK
            elif field_number == 23 and wire_type == _VARINT:
                v, pos = _decode_varint(data, pos)
                vote.timestamp = v & _U64_MASK
            elif field_number == 24 and wire_type == _VARINT:
                v, pos = _decode_varint(data, pos)
                vote.vote = bool(v)
            elif wire_type == _LEN and field_number in (21, 25, 26, 27, 28):
                length, pos = _decode_varint(data, pos)
                end = _checked_end(data, pos, length)
                value = data[pos:end]
                pos = end
                if field_number == 21:
                    vote.vote_owner = value
                elif field_number == 25:
                    vote.parent_hash = value
                elif field_number == 26:
                    vote.received_hash = value
                elif field_number == 27:
                    vote.vote_hash = value
                else:
                    vote.signature = value
            else:
                pos = _skip_field(data, pos, wire_type)
        return vote

    def clone(self) -> "Vote":
        # Direct slot copies, not a kwargs __init__: this runs once per vote
        # on every export/retention decode, and the constructor's keyword
        # dispatch is ~2.5x the cost of nine attribute stores.
        new = Vote.__new__(Vote)
        new.vote_id = self.vote_id
        new.vote_owner = self.vote_owner
        new.proposal_id = self.proposal_id
        new.timestamp = self.timestamp
        new.vote = self.vote
        new.parent_hash = self.parent_hash
        new.received_hash = self.received_hash
        new.vote_hash = self.vote_hash
        new.signature = self.signature
        return new


@dataclass(slots=True)
class Proposal:
    """A consensus proposal that needs voting.

    Field numbers match the reference schema
    (reference: src/protos/messages/v1/consensus.proto:5-16).
    """

    name: str = ""  # field 10
    payload: bytes = b""  # field 11
    proposal_id: int = 0  # field 12, uint32
    proposal_owner: bytes = b""  # field 13
    votes: list[Vote] = field(default_factory=list)  # field 14
    expected_voters_count: int = 0  # field 15, uint32
    round: int = 0  # field 16, uint32
    timestamp: int = 0  # field 17, uint64
    expiration_timestamp: int = 0  # field 18, uint64
    liveness_criteria_yes: bool = False  # field 19

    def encode(self) -> bytes:
        out = bytearray()
        if self.name:
            name_bytes = self.name.encode("utf-8")
            _encode_tag(out, 10, _LEN)
            _encode_varint(out, len(name_bytes))
            out += name_bytes
        _encode_bytes_field(out, 11, self.payload)
        _encode_uint_field(out, 12, self.proposal_id & _U32_MASK)
        _encode_bytes_field(out, 13, self.proposal_owner)
        for vote in self.votes:
            encoded = vote.encode()
            _encode_tag(out, 14, _LEN)
            _encode_varint(out, len(encoded))
            out += encoded
        _encode_uint_field(out, 15, self.expected_voters_count & _U32_MASK)
        _encode_uint_field(out, 16, self.round & _U32_MASK)
        _encode_uint_field(out, 17, self.timestamp & _U64_MASK)
        _encode_uint_field(out, 18, self.expiration_timestamp & _U64_MASK)
        _encode_bool_field(out, 19, self.liveness_criteria_yes)
        return bytes(out)

    def encode_split(self) -> tuple[bytes, bytes]:
        """``(head, tail)`` such that ``head + <field 12: proposal_id> +
        tail`` equals :meth:`encode` byte for byte, for a VOTE-FREE
        proposal (field 14 sits between the id and the tail; embedded
        votes make the split ambiguous and raise). Bulk serializers (the
        engine's session-demotion path) cache the two constant parts per
        distinct (name, payload, owner, n, round, timestamps, liveness)
        shape and splice only the id varint per proposal — the canonical
        bytes without re-walking nine fields per item. Parity with
        ``encode`` is pinned by tests/test_wire.py."""
        if self.votes:
            raise ValueError("encode_split requires a vote-free proposal")
        head = bytearray()
        if self.name:
            name_bytes = self.name.encode("utf-8")
            _encode_tag(head, 10, _LEN)
            _encode_varint(head, len(name_bytes))
            head += name_bytes
        _encode_bytes_field(head, 11, self.payload)
        tail = bytearray()
        _encode_bytes_field(tail, 13, self.proposal_owner)
        _encode_uint_field(tail, 15, self.expected_voters_count & _U32_MASK)
        _encode_uint_field(tail, 16, self.round & _U32_MASK)
        _encode_uint_field(tail, 17, self.timestamp & _U64_MASK)
        _encode_uint_field(tail, 18, self.expiration_timestamp & _U64_MASK)
        _encode_bool_field(tail, 19, self.liveness_criteria_yes)
        return bytes(head), bytes(tail)

    @classmethod
    def decode(cls, data: bytes) -> "Proposal":
        proposal = cls()
        pos = 0
        n = len(data)
        while pos < n:
            key, pos = _decode_varint(data, pos)
            field_number, wire_type = key >> 3, key & 7
            if wire_type == _LEN and field_number in (10, 11, 13, 14):
                length, pos = _decode_varint(data, pos)
                end = _checked_end(data, pos, length)
                value = data[pos:end]
                pos = end
                if field_number == 10:
                    proposal.name = value.decode("utf-8")
                elif field_number == 11:
                    proposal.payload = value
                elif field_number == 13:
                    proposal.proposal_owner = value
                else:
                    proposal.votes.append(Vote.decode(value))
            elif field_number == 12 and wire_type == _VARINT:
                v, pos = _decode_varint(data, pos)
                proposal.proposal_id = v & _U32_MASK
            elif field_number == 15 and wire_type == _VARINT:
                v, pos = _decode_varint(data, pos)
                proposal.expected_voters_count = v & _U32_MASK
            elif field_number == 16 and wire_type == _VARINT:
                v, pos = _decode_varint(data, pos)
                proposal.round = v & _U32_MASK
            elif field_number == 17 and wire_type == _VARINT:
                v, pos = _decode_varint(data, pos)
                proposal.timestamp = v & _U64_MASK
            elif field_number == 18 and wire_type == _VARINT:
                v, pos = _decode_varint(data, pos)
                proposal.expiration_timestamp = v & _U64_MASK
            elif field_number == 19 and wire_type == _VARINT:
                v, pos = _decode_varint(data, pos)
                proposal.liveness_criteria_yes = bool(v)
            else:
                pos = _skip_field(data, pos, wire_type)
        return proposal

    def clone(self) -> "Proposal":
        # Direct slot copies (see Vote.clone): batch creation clones every
        # minted proposal on return, so this is on the registration hot path.
        new = Proposal.__new__(Proposal)
        new.name = self.name
        new.payload = self.payload
        new.proposal_id = self.proposal_id
        new.proposal_owner = self.proposal_owner
        new.votes = [v.clone() for v in self.votes]
        new.expected_voters_count = self.expected_voters_count
        new.round = self.round
        new.timestamp = self.timestamp
        new.expiration_timestamp = self.expiration_timestamp
        new.liveness_criteria_yes = self.liveness_criteria_yes
        return new
