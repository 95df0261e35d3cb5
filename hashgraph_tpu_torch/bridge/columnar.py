"""Columnar wire-vote parsing: the zero-copy half of ``OP_VOTE_BATCH``.

The coalesced vote frame already ships a columnar layout — length
columns plus one contiguous vote-bytes region — but the server used to
decode every vote back into a Python ``Vote`` object before dispatch,
paying object construction, per-field attribute stores, and a full
re-encode (``signing_payload``) per vote. This module (a copy of the JAX
package's ``bridge/columnar.py`` over the port's native runtime) keeps the frame
columnar all the way to the engine: one batched parse pass produces
int64 *columns* (ids, timestamps, values, field offsets into the frame
buffer) and a per-row canonicality flag.

**Strict-canonical contract.** The fast path only accepts rows whose
bytes are exactly what the package's own encoder (and the reference's
prost codec) produces: fields 20..28 ascending, each at most once,
minimal varints, zero/empty fields omitted, bool encoded as 1, no
unknown fields, no trailing bytes. Canonical bytes have two load-bearing
properties the columns exploit:

- the *signing payload* (``Vote.signing_payload()``) is a **prefix** of
  the wire bytes (everything before the signature field), so signature
  verification needs no re-encode;
- ``compute_vote_hash``'s input is reconstructible from fixed-width
  fields plus three wire slices, so hashing is one batched native call.

Any row that deviates — malformed *or* merely non-canonical — flags 0,
and the server falls back to the object-path decoder for the whole
frame. That makes fast-path and fallback statuses identical by
construction: the fast path never guesses at bytes the object decoder
would read differently.

Column layout (``int64[N, VOTE_COLS]``, offsets absolute into the data
buffer; absent fields report len 0; ``sign_len`` is the whole row when
the signature field is absent):

    0 vote_id     1 proposal_id  2 timestamp(u64 bits)  3 value
    4 owner_off   5 owner_len    6 parent_off   7 parent_len
    8 recv_off    9 recv_len    10 hash_off    11 hash_len
   12 sig_off    13 sig_len    14 sign_len    15 reserved

``parse_vote_columns`` dispatches to the native runtime
(``hg_parse_vote_columns``, GIL-free, pool-fanned) when present and to
the pure-Python twin below otherwise — same outputs byte for byte, same
fallback discipline as the fused pid probe.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .. import native

# One home on the Python side (native.py mirrors the C++ HG_VOTE_COLS);
# a stale local copy would silently mis-stride rows against the native
# parser's output instead of failing loudly.
VOTE_COLS = native.VOTE_COLS

# Column indices (keep in sync with native/consensus_native.cpp).
COL_VOTE_ID = 0
COL_PID = 1
COL_TS = 2
COL_VALUE = 3
COL_OWNER_OFF, COL_OWNER_LEN = 4, 5
COL_PARENT_OFF, COL_PARENT_LEN = 6, 7
COL_RECV_OFF, COL_RECV_LEN = 8, 9
COL_HASH_OFF, COL_HASH_LEN = 10, 11
COL_SIG_OFF, COL_SIG_LEN = 12, 13
COL_SIGN_LEN = 14

_U32_MAX = 0xFFFFFFFF

# field -> (owner_off column index) for the LEN-typed fields.
_LEN_FIELD_COL = {21: 4, 25: 6, 26: 8, 27: 10, 28: 12}


def _read_varint_canonical(buf, pos: int, end: int):
    """Minimal-encoding varint; returns (value, new_pos) or None when
    malformed / non-minimal / u64-overflowing (all 'not canonical')."""
    value = 0
    shift = 0
    i = pos
    while True:
        if i >= end or i - pos >= 10:
            return None
        b = buf[i]
        if shift == 63 and b & 0x7E:
            return None
        value |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            if i - pos > 1 and b == 0:
                return None  # non-minimal (trailing zero byte)
            return value, i
        shift += 7


def _parse_one(buf, start: int, end: int, col: "list[int]") -> bool:
    """Python twin of the native ``parse_vote_canonical``."""
    col[COL_OWNER_OFF] = col[COL_PARENT_OFF] = col[COL_RECV_OFF] = start
    col[COL_HASH_OFF] = col[COL_SIG_OFF] = start
    col[COL_SIGN_LEN] = end - start
    pos = start
    last_field = 0
    while pos < end:
        tag_start = pos
        got = _read_varint_canonical(buf, pos, end)
        if got is None:
            return False
        key, pos = got
        field, wt = key >> 3, key & 7
        if field <= last_field or field < 20 or field > 28:
            return False
        last_field = field
        if field in (20, 22, 23, 24):
            if wt != 0:
                return False
            got = _read_varint_canonical(buf, pos, end)
            if got is None:
                return False
            value, pos = got
            if value == 0:
                return False  # canonical encoders omit zero fields
            if field in (20, 22) and value > _U32_MAX:
                return False
            if field == 24 and value != 1:
                return False
            if field == 20:
                col[COL_VOTE_ID] = value
            elif field == 22:
                col[COL_PID] = value
            elif field == 23:
                col[COL_TS] = value
            else:
                col[COL_VALUE] = 1
        else:
            if wt != 2:
                return False
            got = _read_varint_canonical(buf, pos, end)
            if got is None:
                return False
            length, pos = got
            if length == 0 or length > end - pos:
                return False
            idx = _LEN_FIELD_COL[field]
            col[idx] = pos
            col[idx + 1] = length
            if field == 28:
                col[COL_SIGN_LEN] = tag_start - start
            pos += length
    return pos == end


def parse_vote_columns_py(
    data, offsets: np.ndarray
) -> "tuple[np.ndarray, np.ndarray]":
    """Pure-Python strict-canonical parse: (cols int64[N, VOTE_COLS],
    flags uint8[N]) — output-identical to the native path."""
    buf = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
    n = len(offsets) - 1
    cols = np.zeros((n, VOTE_COLS), np.int64)
    flags = np.zeros(n, np.uint8)
    col_scratch = [0] * VOTE_COLS
    for i in range(n):
        for k in range(VOTE_COLS):
            col_scratch[k] = 0
        # Timestamps ride as raw u64 bits inside the int64 column (the
        # native side does the same); reinterpret on the way out.
        if _parse_one(buf, int(offsets[i]), int(offsets[i + 1]), col_scratch):
            flags[i] = 1
            ts = col_scratch[COL_TS]
            if ts > 0x7FFFFFFFFFFFFFFF:
                ts -= 1 << 64
            col_scratch[COL_TS] = ts
            cols[i] = col_scratch
    return cols, flags


def parse_vote_columns(
    data, offsets: np.ndarray
) -> "tuple[np.ndarray, np.ndarray]":
    """Batched strict-canonical Vote parse: native runtime when present
    (GIL-free), pure-Python twin otherwise. Same outputs either way."""
    out = native.parse_vote_columns(data, offsets)
    if out is not None:
        return out
    return parse_vote_columns_py(data, offsets)


def pack_rows(
    data: np.ndarray, offsets: np.ndarray, cols: np.ndarray, rows: np.ndarray
) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """Gather ``rows`` (possibly non-contiguous) of a parsed frame into
    one contiguous ``(data, offsets, cols)`` triple, the absolute offset
    columns rebased — vectorized, no per-row Python slicing. One home
    for the bridge server's per-peer packing and the federation
    adapter's per-shard packing."""
    starts = offsets[rows]
    lens = offsets[rows + 1] - starts
    sub_offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(lens, out=sub_offsets[1:])
    total = int(sub_offsets[-1])
    gather = (
        np.arange(total, dtype=np.int64)
        - np.repeat(sub_offsets[:-1], lens)
        + np.repeat(starts, lens)
    )
    sub_data = data[gather]
    sub_cols = cols[rows].copy()
    delta = sub_offsets[:-1] - starts
    for col in (
        COL_OWNER_OFF, COL_PARENT_OFF, COL_RECV_OFF, COL_HASH_OFF,
        COL_SIG_OFF,
    ):
        sub_cols[:, col] += delta
    return sub_data, sub_offsets, sub_cols


def vote_hash_columns(data, cols: np.ndarray) -> np.ndarray:
    """Batched ``compute_vote_hash`` over parsed columns: uint8[N, 32].
    Native when present; the Python twin rebuilds each hash input from
    the same fixed fields + wire slices (no Vote objects)."""
    out = native.vote_hash_columns(data, cols)
    if out is not None:
        return out
    buf = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
    n = len(cols)
    digests = np.empty((n, 32), np.uint8)
    for i in range(n):
        c = cols[i]
        digests[i] = np.frombuffer(
            hashlib.sha256(
                b"".join(
                    (
                        (int(c[COL_VOTE_ID]) & _U32_MAX).to_bytes(4, "little"),
                        buf[c[COL_OWNER_OFF]:c[COL_OWNER_OFF] + c[COL_OWNER_LEN]],
                        (int(c[COL_PID]) & _U32_MAX).to_bytes(4, "little"),
                        (int(c[COL_TS]) & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little"),
                        b"\x01" if c[COL_VALUE] else b"\x00",
                        buf[c[COL_PARENT_OFF]:c[COL_PARENT_OFF] + c[COL_PARENT_LEN]],
                        buf[c[COL_RECV_OFF]:c[COL_RECV_OFF] + c[COL_RECV_LEN]],
                    )
                )
            ).digest(),
            np.uint8,
        )
    return digests
