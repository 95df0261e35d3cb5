"""Frozen copy of the vote wire format and the vote hash.

Upstream's protobuf schema (vacp2p/hashgraph-like-consensus,
``src/protos/messages/v1/consensus.proto``, message ``Vote``, fields 20-28)
and its vote hash (``src/utils.rs:37-47``): SHA-256 over vote_id (u32 LE),
owner, proposal_id (u32 LE), timestamp (u64 LE), the vote as one byte, the
parent hash and the received hash. The signature covers the encoding of
fields 20-27, which canonical encoding makes a prefix of the wire bytes.

Written from the schema, not imported from the program: the benchmark signs
with it and the reference decodes with it.
"""

from __future__ import annotations

import hashlib

_U32 = 0xFFFFFFFF
_U64 = 0xFFFFFFFFFFFFFFFF


def _varint(value: int) -> bytes:
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def vote_hash(vote_id, owner, proposal_id, timestamp, value, parent, received) -> bytes:
    return hashlib.sha256(
        b"".join((
            (vote_id & _U32).to_bytes(4, "little"),
            owner,
            (proposal_id & _U32).to_bytes(4, "little"),
            (timestamp & _U64).to_bytes(8, "little"),
            b"\x01" if value else b"\x00",
            parent,
            received,
        ))
    ).digest()


def signed_fields(vote_id, owner, proposal_id, timestamp, value, parent, received, vhash) -> bytes:
    """Canonical encoding of fields 20-27: zero and empty fields omitted,
    ascending field numbers, minimal varints."""
    out = bytearray()
    if vote_id & _U32:
        out += b"\xa0\x01" + _varint(vote_id & _U32)
    for tag, field in ((b"\xaa\x01", owner),):
        if field:
            out += tag + _varint(len(field)) + field
    if proposal_id & _U32:
        out += b"\xb0\x01" + _varint(proposal_id & _U32)
    if timestamp & _U64:
        out += b"\xb8\x01" + _varint(timestamp & _U64)
    if value:
        out += b"\xc0\x01\x01"
    for tag, field in ((b"\xca\x01", parent), (b"\xd2\x01", received), (b"\xda\x01", vhash)):
        if field:
            out += tag + _varint(len(field)) + field
    return bytes(out)


def with_signature(payload: bytes, signature: bytes) -> bytes:
    return payload + b"\xe2\x01" + _varint(len(signature)) + signature


def _read_varint(buf: bytes, pos: int) -> "tuple[int, int]":
    value = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


def decode(buf: bytes) -> dict:
    """Decode one vote. Returns its fields, plus ``payload``: the bytes
    before the signature field, which the signature covers."""
    vote = {"vote_id": 0, "owner": b"", "proposal_id": 0, "timestamp": 0,
            "value": False, "parent": b"", "received": b"", "hash": b"",
            "signature": b"", "payload": buf}
    names = {21: "owner", 25: "parent", 26: "received", 27: "hash", 28: "signature"}
    pos = 0
    while pos < len(buf):
        start = pos
        key, pos = _read_varint(buf, pos)
        field, wire_type = key >> 3, key & 7
        if wire_type == 0:
            value, pos = _read_varint(buf, pos)
            if field == 20:
                vote["vote_id"] = value & _U32
            elif field == 22:
                vote["proposal_id"] = value & _U32
            elif field == 23:
                vote["timestamp"] = value & _U64
            elif field == 24:
                vote["value"] = bool(value)
        elif wire_type == 2:
            length, pos = _read_varint(buf, pos)
            if field == 28:
                vote["payload"] = buf[:start]
            if field in names:
                vote[names[field]] = buf[pos:pos + length]
            pos += length
        else:
            raise ValueError(f"unexpected wire type {wire_type}")
    return vote
