"""The port's distributed tracing (``hashgraph_tpu_torch.obs.trace``) and
tracer (``hashgraph_tpu_torch.tracing``) against the JAX package's.

Module against module, in this process, on private ``TraceStore`` and
``Tracer`` instances (neither package's process-wide store or tracer is
touched). Trace contexts are built from seeded bytes (numpy) and go through
both packages: the 25-byte wire form (the bridge frame suffix's payload)
and the gossip field appended to real ``Proposal``/``Vote`` encodings must
be byte-equal, and each package must decode what the other encoded; the
traceparent text form likewise. Seeded span sets recorded into both stores
must export the same JSON lines and Chrome trace-event documents, and
``merge_traces`` over the same per-peer dumps must write the same document
and summary. The tracers must give equal counters, span statistics and
JSON-lines exports with the wall-clock ``ts`` and measured durations
masked (tolerance: exact for everything else).
"""

import json

import numpy as np
import pytest

import hashgraph_tpu.obs.trace as ref_trace
import hashgraph_tpu.tracing as ref_tracing
import hashgraph_tpu.wire as ref_wire
import hashgraph_tpu_torch.obs.trace as trace
import hashgraph_tpu_torch.tracing as tracing
import hashgraph_tpu_torch.wire as wire

SEEDS = range(5)


def contexts(seed, n=8):
    rng = np.random.default_rng(seed)
    return [
        (rng.bytes(16), rng.bytes(8), int(rng.integers(0, 256)))
        for _ in range(n)
    ]


@pytest.mark.parametrize("seed", SEEDS)
def test_wire_and_traceparent_forms_equal_both_ways(seed):
    assert trace.TRACE_WIRE_BYTES == ref_trace.TRACE_WIRE_BYTES == 25
    assert trace.TRACE_FIELD_NUMBER == ref_trace.TRACE_FIELD_NUMBER
    for tid, sid, flags in contexts(seed):
        ours = trace.TraceContext(tid, sid, flags)
        theirs = ref_trace.TraceContext(tid, sid, flags)
        assert ours.to_wire() == theirs.to_wire()
        assert ours.to_traceparent() == theirs.to_traceparent()
        back = trace.TraceContext.from_wire(theirs.to_wire())
        assert (back.trace_id, back.span_id, back.flags) == (tid, sid, flags)
        back = ref_trace.TraceContext.from_wire(ours.to_wire())
        assert (back.trace_id, back.span_id, back.flags) == (tid, sid, flags)
        back = trace.TraceContext.from_traceparent(theirs.to_traceparent())
        assert (back.trace_id, back.span_id, back.flags) == (tid, sid, flags)
        child = ours.child()
        assert child.trace_id == tid and child.span_id != sid


def test_malformed_contexts_rejected_alike():
    for raw in (b"", b"\x00" * 24, b"\x00" * 26):
        for module in (trace, ref_trace):
            with pytest.raises(ValueError):
                module.TraceContext.from_wire(raw)
    for header in ("", "01-" + "0" * 32 + "-" + "0" * 16 + "-01", "00-ab-cd-01"):
        for module in (trace, ref_trace):
            with pytest.raises(ValueError):
                module.TraceContext.from_traceparent(header)


def _messages(seed):
    """(message class name, encoded bytes) of Votes and Proposals (the
    gossip envelopes)."""
    rng = np.random.default_rng(seed)
    out = []
    for module in (wire,):
        for k in range(3):
            vote = module.Vote(
                vote_id=int(rng.integers(1, 1 << 31)), vote_owner=rng.bytes(20),
                proposal_id=int(rng.integers(1, 1 << 31)), timestamp=1_700_000_000 + k,
                vote=bool(k % 2), parent_hash=rng.bytes(32), received_hash=rng.bytes(32),
                vote_hash=rng.bytes(32), signature=rng.bytes(65),
            )
            proposal = module.Proposal(
                name=f"p{k}", payload=rng.bytes(int(rng.integers(0, 40))),
                proposal_id=int(rng.integers(1, 1 << 31)), proposal_owner=rng.bytes(20),
                votes=[vote] * k, expected_voters_count=int(rng.integers(1, 9)), round=1,
                timestamp=1_700_000_000, expiration_timestamp=1_700_000_100,
                liveness_criteria_yes=True,
            )
            out += [("Vote", vote.encode()), ("Proposal", proposal.encode())]
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_gossip_field_byte_equal_both_ways(seed):
    for (kind, message), (tid, sid, flags) in zip(_messages(seed), contexts(seed)):
        ours = trace.attach_trace(message, trace.TraceContext(tid, sid, flags))
        theirs = ref_trace.attach_trace(message, ref_trace.TraceContext(tid, sid, flags))
        assert ours == theirs
        for module, data in ((trace, theirs), (ref_trace, ours)):
            got = module.extract_trace(data)
            assert (got.trace_id, got.span_id, got.flags) == (tid, sid, flags)
        # The field is unknown to both codecs: the message decodes as before.
        for codec in (wire, ref_wire):
            assert getattr(codec, kind).decode(ours).encode() == message
        assert trace.extract_trace(message) is None


def test_extract_never_raises_on_junk():
    rng = np.random.default_rng(0)
    for n in range(0, 80, 3):
        junk = rng.bytes(n)
        a, b = trace.extract_trace(junk), ref_trace.extract_trace(junk)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.to_wire() == b.to_wire()


def test_ambient_context():
    ctx = trace.TraceContext(b"\x01" * 16, b"\x02" * 8)
    assert trace.current_context() is None
    with trace.use_context(ctx):
        assert trace.current_context() is ctx
        with trace.use_context(None):
            assert trace.current_context() is ctx
    assert trace.current_context() is None
    # The two packages' ambient contexts are their own.
    with trace.use_context(ctx):
        assert ref_trace.current_context() is None


# ── Stores, exports and the merge ─────────────────────────────────────


def fill_store(module, seed, peer):
    """A private store holding seeded spans and instants with fixed wall
    times, over a few traces."""
    rng = np.random.default_rng(seed)
    store = module.TraceStore(capacity=32, peer=peer)
    ctxs = [module.TraceContext(t, s, f) for t, s, f in contexts(seed, 4)]
    for k in range(40):
        ctx = ctxs[int(rng.integers(0, 4))]
        start = 1_700_000_000.0 + k * 0.001 + float(rng.integers(0, 100)) / 1e6
        if rng.integers(0, 3):
            store.record(f"op.{int(rng.integers(0, 3))}", ctx, start,
                         float(rng.integers(0, 5000)) / 1e6, parent=ctx.span_id,
                         attrs={"k": k})
        else:
            store.instant("mark", ctx, start, attrs={"k": k})
    return store


@pytest.mark.parametrize("seed", SEEDS)
def test_store_exports_equal(seed, tmp_path):
    outs = []
    for name, module in (("ref", ref_trace), ("port", trace)):
        store = fill_store(module, seed, "peer:a")
        assert store.dropped == 8  # 40 spans through a 32-span window
        store.export_jsonl(str(tmp_path / f"{name}.jsonl"))
        store.export_chrome(str(tmp_path / f"{name}.json"))
        outs.append([
            (tmp_path / f"{name}.jsonl").read_text(),
            json.loads((tmp_path / f"{name}.json").read_text()),
            module.chrome_trace(store.spans()),
            [s.as_dict() for s in store.spans(trace_id=contexts(seed, 1)[0][0])],
        ])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_traces_equal(seed, tmp_path):
    dumps = []
    for peer in ("peer:a", "peer:b", "peer:c"):
        store = fill_store(trace, seed + len(peer) + ord(peer[-1]), peer)
        path = tmp_path / f"{peer[-1]}.jsonl"
        store.export_jsonl(str(path))
        dumps.append(str(path))
    ours = trace.merge_traces(dumps, str(tmp_path / "ours.json"))
    theirs = ref_trace.merge_traces(dumps, str(tmp_path / "theirs.json"))
    assert {k: v for k, v in ours.items() if k != "out"} == {
        k: v for k, v in theirs.items() if k != "out"}
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "theirs.json").read_text()
    assert ours["peers"] == ["peer:a", "peer:b", "peer:c"] and ours["dropped"] == 24
    loaded = trace.load_spans_jsonl(dumps[0])
    assert [s.as_dict() for s in loaded] == [
        s.as_dict() for s in ref_trace.load_spans_jsonl(dumps[0])]


def test_span_roundtrip_through_dict():
    store = fill_store(trace, 3, "p")
    for span in store.spans():
        again = trace.TraceSpan.from_dict(span.as_dict())
        assert again.as_dict() == span.as_dict()


# ── The tracer ────────────────────────────────────────────────────────


def drive_tracer(module, seed):
    rng = np.random.default_rng(seed)
    tr = module.Tracer(enabled=False)
    tr.count("dropped.while.off", 5)
    tr.enable()
    for k in range(60):
        op = int(rng.integers(0, 4))
        if op == 0:
            tr.count(f"c.{int(rng.integers(0, 3))}", int(rng.integers(0, 9)))
        elif op == 1:
            tr.record_span(f"s.{int(rng.integers(0, 2))}", 100.0 + k,
                           float(rng.integers(1, 1000)) / 1e6, {"k": k})
        elif op == 2:
            with tr.span("ctx", k=k):
                pass
        else:
            tr.event("ev", k=k)
    return tr


@pytest.mark.parametrize("seed", SEEDS)
def test_tracer_readouts_equal(seed, tmp_path):
    ours, theirs = drive_tracer(tracing, seed), drive_tracer(ref_tracing, seed)

    def counts(tr):
        return {k: v for k, v in tr.counters().items() if k != "span.ctx.ns"}

    assert counts(ours) == counts(theirs) and "dropped.while.off" not in counts(ours)
    for name in ("s.0", "s.1"):
        assert ours.span_stats(name) == theirs.span_stats(name)
    lines = []
    for name, tr in (("ours", ours), ("theirs", theirs)):
        path = tmp_path / f"{name}.jsonl"
        tr.export_jsonl(str(path))
        rows = [json.loads(line) for line in path.read_text().splitlines()]
        for row in rows:
            row.pop("ts", None)
            if row.get("name") == "ctx":  # measured, not injected
                row.pop("duration", None)
                row.pop("start", None)
            row.get("values", {}).pop("span.ctx.ns", None)
        lines.append(rows)
    assert lines[0] == lines[1]
    ours.disable()
    ours.count("after", 1)
    assert "after" not in ours.counters()
    ours.reset()
    assert ours.counters() == {}


def test_atomic_write_text(tmp_path):
    path = tmp_path / "out.txt"
    tracing.atomic_write_text(str(path), "one")
    tracing.atomic_write_text(str(path), "two")
    assert path.read_text() == "two"
    assert [p.name for p in tmp_path.iterdir()] == ["out.txt"]


def test_device_profile_on_the_cpu_writes_a_host_trace(tmp_path):
    """Without a GPU the capture is the host's; it still writes a Chrome
    trace that holds the block's operators (on the card the same call must
    record CUDA activity, checked by chip_smoke.py's phase 12)."""
    import torch

    with tracing.device_profile(str(tmp_path)):
        torch.ones(64).add_(1).sum().item()
    doc = json.loads((tmp_path / "device_trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert any(n and "add" in n for n in names)
