"""The port's bridge wire codec against the JAX package's, byte for byte.

Both packages must talk to each other, so every opcode, status, feature
bit and ``PROTOCOL_VERSION`` is held equal, and every encoder, decoder and
``Cursor`` reader is run on the same seeded inputs in both modules. The
JAX ``bridge.protocol`` holds no process-wide state, so it is imported in
process.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from hashgraph_tpu.bridge import protocol as JP
from hashgraph_tpu.obs.trace import TraceContext as JTraceContext
from hashgraph_tpu_torch.bridge import protocol as TP
from hashgraph_tpu_torch.obs.trace import TraceContext as TTraceContext

SEEDS = [0, 1, 2]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wire_constants(module) -> dict:
    return {
        name: getattr(module, name)
        for name in dir(module)
        if name.isupper()
        and name.split("_")[0]
        in ("OP", "STATUS", "FEATURE", "RESULT", "EVENT", "PROTOCOL", "MAX",
            "TRACE", "SUPPORTED", "MUTATING")
    }


JAX_CONSTANTS = _wire_constants(JP)


def test_constant_sets_match():
    assert sorted(_wire_constants(TP)) == sorted(JAX_CONSTANTS)
    assert len(JAX_CONSTANTS) > 50


@pytest.mark.parametrize("name", sorted(JAX_CONSTANTS))
def test_constant_equals_the_reference(name):
    assert getattr(TP, name) == JAX_CONSTANTS[name]


def _rng_bytes(rng: random.Random, lo: int, hi: int) -> bytes:
    return bytes(rng.getrandbits(8) for _ in range(rng.randint(lo, hi)))


def _groups(rng: random.Random):
    groups = []
    for _ in range(rng.randint(1, 5)):
        votes = [_rng_bytes(rng, 0, 90) for _ in range(rng.randint(0, 7))]
        scope = "".join(rng.choice("abcxyz-é") for _ in range(rng.randint(0, 9)))
        groups.append((rng.randint(0, 2**32 - 1), scope, votes))
    return groups


@pytest.mark.parametrize("seed", SEEDS)
def test_field_encoders(seed):
    rng = random.Random(seed)
    for _ in range(50):
        v8, v16 = rng.randint(0, 255), rng.randint(0, 2**16 - 1)
        v32, v64 = rng.randint(0, 2**32 - 1), rng.randint(0, 2**64 - 1)
        s = "".join(chr(rng.randint(32, 0x2FF)) for _ in range(rng.randint(0, 20)))
        b = _rng_bytes(rng, 0, 40)
        assert TP.u8(v8) == JP.u8(v8)
        assert TP.u16(v16) == JP.u16(v16)
        assert TP.u32(v32) == JP.u32(v32)
        assert TP.u64(v64) == JP.u64(v64)
        assert TP.string(s) == JP.string(s)
        assert TP.blob(b) == JP.blob(b)
        lead, corr = rng.randint(0, 255), rng.randint(0, 2**32 - 1)
        assert TP.encode_frame(lead, b) == JP.encode_frame(lead, b)
        assert TP.encode_tagged_frame(lead, corr, b) == JP.encode_tagged_frame(
            lead, corr, b
        )
    for module in (TP, JP):
        with pytest.raises(Exception):
            module.u8(256)


@pytest.mark.parametrize("seed", SEEDS)
def test_cursor_readers(seed):
    rng = random.Random(seed)
    ops = []
    parts = []
    for _ in range(60):
        kind = rng.choice(["u8", "u16", "u32", "u64", "string", "blob", "raw"])
        if kind == "string":
            value = "".join(chr(rng.randint(32, 0x7FF)) for _ in range(rng.randint(0, 12)))
            parts.append(JP.string(value))
        elif kind == "blob":
            value = _rng_bytes(rng, 0, 30)
            parts.append(JP.blob(value))
        elif kind == "raw":
            value = _rng_bytes(rng, 0, 10)
            parts.append(value)
        else:
            width = {"u8": 8, "u16": 16, "u32": 32, "u64": 64}[kind]
            value = rng.getrandbits(width)
            parts.append(getattr(JP, kind)(value))
        ops.append((kind, value))
    data = b"".join(parts)
    cursors = (TP.Cursor(data), JP.Cursor(data))
    for kind, value in ops:
        got = []
        for cur in cursors:
            if kind == "raw":
                got.append(cur.raw(len(value)))
            else:
                got.append(getattr(cur, kind)())
            got.append(cur.remaining())
        assert got[0] == got[2] == value
        assert got[1] == got[3]
    assert all(cur.done() for cur in cursors)
    for cur in cursors:
        with pytest.raises(ValueError):
            cur.u32()
        fork = TP.Cursor(data, 3).fork()
        assert fork.remaining() == len(data) - 3


@pytest.mark.parametrize("seed", SEEDS)
def test_trace_context_suffix(seed):
    rng = random.Random(seed)
    raw = bytes(rng.getrandbits(8) for _ in range(TP.TRACE_WIRE_BYTES))
    tctx, jctx = TTraceContext.from_wire(raw), JTraceContext.from_wire(raw)
    assert TP.encode_trace_context(tctx) == JP.encode_trace_context(jctx)
    assert TP.encode_trace_context(None) == JP.encode_trace_context(None) == b""
    tails = [
        TP.encode_trace_context(tctx),
        b"",
        b"\x07\x07\x07",
        JP.u8(9) + b"z" * 25,
        _rng_bytes(rng, 1, 25),
    ]
    for tail in tails:
        data = b"head" + tail
        tc, jc = TP.Cursor(data, 4), JP.Cursor(data, 4)
        tout, jout = TP.read_trace_context(tc), JP.read_trace_context(jc)
        assert (tout is None) == (jout is None)
        if tout is not None:
            assert tout.to_wire() == jout.to_wire()
        assert tc.done() and jc.done()


@pytest.mark.parametrize("seed", SEEDS)
def test_vote_batch_codecs(seed):
    rng = random.Random(seed)
    for _ in range(10):
        now = rng.randint(0, 2**64 - 1)
        groups = _groups(rng)
        frame = TP.encode_vote_batch(now, groups)
        assert frame == JP.encode_vote_batch(now, groups)
        tsegs, tn = TP.encode_vote_batch_segments(now, groups)
        jsegs, jn = JP.encode_vote_batch_segments(now, groups)
        assert tsegs == jsegs and tn == jn == len(frame)
        assert b"".join(tsegs) == frame
        assert TP.decode_vote_batch(TP.Cursor(frame)) == JP.decode_vote_batch(
            JP.Cursor(frame)
        ) == (now, groups)
        trailing = frame + b"\x01\x02"
        tv = TP.decode_vote_batch_views(TP.Cursor(trailing))
        jv = JP.decode_vote_batch_views(JP.Cursor(trailing))
        assert tv.now == jv.now == now
        assert tv.groups == jv.groups
        assert tv.total == jv.total
        np.testing.assert_array_equal(tv.offsets, jv.offsets)
        np.testing.assert_array_equal(tv.data, jv.data)
        assert tv.offsets.dtype == jv.offsets.dtype
        flat = [v for _, _, votes in groups for v in votes]
        assert [
            tv.data[tv.offsets[i]:tv.offsets[i + 1]].tobytes()
            for i in range(tv.total)
        ] == flat
        # Truncated anywhere: both decoders raise ValueError.
        cut = rng.randint(0, len(frame) - 1)
        for module in (TP, JP):
            with pytest.raises(ValueError):
                module.decode_vote_batch_views(module.Cursor(frame[:cut]))


@pytest.mark.parametrize("seed", SEEDS)
def test_deliver_and_fleet_tally(seed):
    rng = random.Random(seed)
    items = [
        ("s%d" % rng.randint(0, 99), _rng_bytes(rng, 0, 60))
        for _ in range(rng.randint(0, 8))
    ]
    peer, now = rng.randint(0, 2**32 - 1), rng.randint(0, 2**64 - 1)
    assert TP.encode_deliver_proposals(peer, items, now) == JP.encode_deliver_proposals(
        peer, items, now
    )
    counts = {rng.randint(0, 9): rng.randint(0, 2**40) for _ in range(rng.randint(0, 6))}
    wire = TP.encode_fleet_tally(counts)
    assert wire == JP.encode_fleet_tally(counts)
    assert TP.parse_fleet_tally(TP.Cursor(wire)) == JP.parse_fleet_tally(
        JP.Cursor(wire)
    ) == counts


@pytest.mark.parametrize("seed", SEEDS)
def test_frame_splitting_and_parsing(seed):
    rng = random.Random(seed)
    bodies = [
        JP.encode_tagged_frame(rng.randint(0, 255), rng.getrandbits(32), _rng_bytes(rng, 0, 50))
        for _ in range(12)
    ]
    stream = b"".join(bodies)
    cut = rng.randint(0, len(stream))
    for tagged in (True, False):
        tbuf, jbuf = bytearray(stream[:cut]), bytearray(stream[:cut])
        tout = TP.split_frames(tbuf, min_len=5)
        jout = JP.split_frames(jbuf, min_len=5)
        assert tout == jout and tbuf == jbuf
        for body in tout:
            tl, tc, tcur = TP.parse_frame(body, tagged)
            jl, jc, jcur = JP.parse_frame(body, tagged)
            assert (tl, tc, tcur.remaining()) == (jl, jc, jcur.remaining())
    for module in (TP, JP):
        with pytest.raises(ValueError):
            module.split_frames(bytearray(JP.u32(2) + b"xx"), min_len=5)
        with pytest.raises(ValueError):
            module.parse_frame(b"\x01\x02", True)
        with pytest.raises(ValueError):
            module.parse_frame(b"", False)


def test_frame_reads_over_a_socket_pair():
    import socket

    a, b = socket.socketpair()
    try:
        a.sendall(JP.encode_frame(7, b"abc") + JP.encode_tagged_frame(9, 77, b"xyz"))
        lead, cur = TP.read_frame(b)
        assert (lead, cur.raw(3)) == (7, b"abc")
        lead, corr, cur = TP.read_tagged_frame(b)
        assert (lead, corr, cur.raw(3)) == (9, 77, b"xyz")
        a.sendall(JP.u32(0))
        with pytest.raises(ValueError):
            TP.read_frame(b)
        a.close()
        with pytest.raises(ConnectionError):
            TP.read_exact(b, 1)
    finally:
        b.close()
