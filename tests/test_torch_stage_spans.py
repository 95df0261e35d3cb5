"""The host stages of the port's two hot calls as tracer spans.

``ingest_wire_columnar`` (with ``wire_verify_begin``), ``ingest_proposals``
and ``ingest_columnar_multi`` time their stages through
``obs.stage_span``, the device signature batch its phases
(``crypto_device.backend``). Held here, on the CPU at toy sizes:

- with the tracer off nothing is recorded, and ``stage_seconds`` keeps its
  two keys;
- with it on, each named span is recorded once a call, each sub-span lies
  inside its parent's interval and the sub-spans sum to no more than it;
- a span starts on ``torch.profiler``'s clock: an operator issued inside
  a span falls inside the span's interval in the profile, and
  ``tracing.device_profile`` writes the spans as a track of their own;
- overlapping device batches each keep their own phases;
- ``engine.decided`` carries one non-negative latency a deciding
  transition.
"""

import time

import numpy as np
import pytest
import test_torch_wire_columnar as TW

NOW = TW.NOW
# Clock slack of a sub-span's interval check: a start is read from the
# epoch clock in float seconds (about 0.24 us apart at today's dates), a
# duration from perf_counter.
SLACK = 5e-6

WIRE_SPANS = (
    "engine.wire_verify_begin", "engine.resolve", "engine.wire.crypto", "engine.wire.apply",
    "engine.wire.rules", "engine.wire.guard", "engine.wire.intern", "engine.device_ingest",
    "engine.apply.events", "engine.wire.retain", "engine.wire.chain", "engine.wire.admit_health",
    "engine.verify_batch",
)
VERIFY_SPANS = (
    "verify.submit", "verify.decompress.enqueue", "verify.hash.enqueue", "verify.decompress.wait",
    "verify.hash.wait", "verify.msm.scalars", "verify.msm.nibbles", "verify.msm.device",
)
PROPOSAL_SPANS = ("engine.ingest_proposals", "engine.proposals.admit", "engine.register")
COLUMNAR_SPANS = ("engine.ingest_columnar", "engine.resolve", "engine.device_ingest",
                  "engine.apply.events")
PARENTS = {
    "engine.ingest_proposals": ("engine.proposals.admit", "engine.register"),
    "engine.wire_verify_begin": ("verify.submit", "verify.decompress.enqueue", "verify.hash.enqueue"),
    "engine.wire.crypto": ("engine.verify_batch",),
    "engine.verify_batch": ("verify.decompress.wait", "verify.hash.wait", "verify.msm.scalars",
                            "verify.msm.nibbles", "verify.msm.device", "verify.fallback"),
    "engine.wire.apply": ("engine.wire.rules", "engine.wire.guard", "engine.wire.intern",
                          "engine.device_ingest", "engine.apply.events", "engine.wire.retain",
                          "engine.wire.chain", "engine.wire.admit_health"),
    "engine.ingest_columnar": ("engine.resolve", "engine.device_ingest", "engine.apply.events"),
}


@pytest.fixture
def tracer():
    from hashgraph_tpu_torch.tracing import tracer

    tracer.disable()
    tracer.reset()
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.reset()


def _cpu_device_signer():
    from hashgraph_tpu_torch.signing.ed25519 import Ed25519DeviceConsensusSigner

    class CpuSigner(Ed25519DeviceConsensusSigner):
        device = "cpu"

    return CpuSigner


def _node(signer, proposals=2, voters=3):
    """An engine on the CPU with ``proposals`` sessions of ``voters``
    voters in one scope, registered through ``ingest_proposals``."""
    api = TW.port_api()
    pkg = api.pkg
    engine = api.make_engine(signer, 8, 8)
    props = []
    for i in range(proposals):
        p = pkg.Proposal(
            name=f"p{i}", payload=bytes([i]), proposal_id=1000 + i, proposal_owner=b"owner",
            votes=[], expected_voters_count=voters, round=1, timestamp=NOW,
            expiration_timestamp=NOW + 100, liveness_criteria_yes=True,
        )
        props.append(p)
    statuses = engine.ingest_proposals([("s", p) for p in props], NOW)
    assert statuses == [0] * proposals
    return api, engine, props


def _frame(api, props, signers, late=()):
    """Chained yes votes of ``signers`` on every proposal, then a vote of
    each of ``late`` after them: parsed wire columns of one frame."""
    rows = []
    for p in props:
        chain = p.clone()
        for s in list(signers) + list(late):
            vote = api.pkg.build_vote(chain, True, s, NOW + 1)
            chain.votes.append(vote)
            rows.append(vote.encode())
    return TW.parse(api, rows)


def _wire_call(api, engine, props, signers, late=(), early=False, stage=None):
    data, offsets, cols = _frame(api, props, signers, late)
    pre = engine.wire_verify_begin(data, cols, offsets) if early else None
    if early:
        time.sleep(0.01)
    return engine.ingest_wire_columnar(
        ["s"], np.zeros(len(cols), np.int64), cols, data, offsets, NOW + 1,
        stage_seconds=stage, _prepass=pre)


def _columnar_call(engine, props, voters=2):
    pids = np.repeat([p.proposal_id for p in props], voters)
    gids = np.tile([engine.voter_gid(bytes([k + 1]) * 8) for k in range(voters)], len(props))
    return engine.ingest_columnar_multi(["s"], np.zeros(len(pids), np.int64), pids, gids,
                                        np.ones(len(pids), bool), NOW + 1)


def _stub_signers(api, n):
    return [api.pkg.StubConsensusSigner(bytes([k + 1]) * 8) for k in range(n)]


def _counts(spans):
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


def test_tracer_off_records_nothing_and_stages_keep_their_keys(tracer):
    from hashgraph_tpu_torch.signing.stub import StubConsensusSigner

    with TW.one_torch_thread():
        api, engine, props = _node(StubConsensusSigner(b"me"))
        stage = {}
        statuses = _wire_call(api, engine, props, _stub_signers(api, 2), stage=stage)
        assert (statuses == 0).all()
        _columnar_call(engine, props[:1])
    assert set(stage) == {"crypto", "apply"} and all(v > 0 for v in stage.values())
    assert tracer.spans() == [] and tracer.counters() == {} and tracer.events() == []


def test_each_span_once_a_call_and_inside_its_parent(tracer):
    """A device-verified wire call (early prepass), a proposals call and a
    columnar call, traced: every named span once, sub-spans inside their
    parents' intervals, summing to no more than the parent."""
    from hashgraph_tpu_torch.signing.stub import StubConsensusSigner

    CpuSigner = _cpu_device_signer()
    with TW.one_torch_thread():
        api, engine, props = _node(CpuSigner(bytes(32)))
        tracer.enable()
        _wire_call(api, engine, props, [CpuSigner(bytes([k + 1]) * 32) for k in range(2)], early=True)
        wire = tracer.spans()
        tracer.reset()
        api2, engine2, props2 = _node(StubConsensusSigner(b"me"))
        proposals = tracer.spans()
        tracer.reset()
        _columnar_call(engine2, props2)
        columnar = tracer.spans()
    for spans, names in ((wire, WIRE_SPANS + VERIFY_SPANS), (proposals, PROPOSAL_SPANS),
                         (columnar, COLUMNAR_SPANS)):
        counts = _counts(spans)
        assert {n: counts.get(n) for n in names} == {n: 1 for n in names}
    assert "verify.fallback" not in _counts(wire)
    checked = 0
    for spans in (wire, proposals, columnar):
        for parent in (s for s in spans if s.name in PARENTS):
            kids = [s for s in spans if s.name in PARENTS[parent.name]]
            for k in kids:
                assert k.start >= parent.start - SLACK, (parent.name, k.name)
                assert k.start + k.duration <= parent.start + parent.duration + SLACK, (parent.name, k.name)
            assert sum(k.duration for k in kids) <= parent.duration
            checked += len(kids)
    assert checked >= 20
    # The verify spans are one batch's.
    batches = {s.attrs["batch"] for s in wire if s.name.startswith("verify.")}
    assert len(batches) == 1


def test_span_starts_on_the_profiler_clock(tracer, tmp_path):
    """An operator issued inside a span lies inside the span's interval on
    ``torch.profiler``'s timeline, and ``device_profile`` writes the span
    beside it on the trace's clock."""
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile

    from hashgraph_tpu_torch import tracing
    from hashgraph_tpu_torch.obs import stage_span

    tracer.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name, ctx in (("probe.span", tracer.span("probe.span")),
                          ("probe.stage", stage_span(tracer, "probe.stage"))):
            with ctx:
                time.sleep(0.002)
                torch.ones(64).mul_(3 if name == "probe.span" else 5)
                time.sleep(0.002)
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mul_"]
    assert len(ops) == 2
    for op, name in zip(sorted(ops, key=lambda e: e.start_ns()), ("probe.span", "probe.stage")):
        (span,) = tracer.spans(name)
        assert span.start * 1e9 < op.start_ns()
        assert op.start_ns() + op.duration_ns() < (span.start + span.duration) * 1e9

    tracer.reset()
    with tracing.device_profile(str(tmp_path)):
        with tracer.span("probe.exported", rows=3):
            time.sleep(0.002)
            torch.ones(64).add_(1)
            time.sleep(0.002)
    doc = json.loads((tmp_path / "device_trace.json").read_text())
    (op,) = [e for e in doc["traceEvents"] if e.get("name") == "aten::add_"]
    (span,) = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    assert span["name"] == "probe.exported" and span["args"] == {"rows": 3}
    assert span["ts"] < op["ts"] and op["ts"] + op["dur"] < span["ts"] + span["dur"]
    names = [e for e in doc["traceEvents"] if e.get("ph") == "M" and e.get("tid") == span["tid"]]
    assert names and names[0]["args"]["name"] == tracing.PROGRAM_TRACK


def test_overlapping_batches_keep_their_own_phases(tracer):
    """Batch B begun before batch A is collected, collected first, and
    blamed on the host: each collect holds its own phases,
    ``last_phase_seconds`` answers with the batch collected last, the
    histogram observes both totals, and each batch's spans carry its
    number."""
    from hashgraph_tpu_torch.crypto_device import backend
    from hashgraph_tpu_torch.obs import DEVICE_VERIFY_SECONDS, registry
    from hashgraph_tpu_torch.signing.ed25519 import Ed25519ConsensusSigner

    signers = [Ed25519ConsensusSigner(bytes([k + 1]) * 32) for k in range(3)]
    msgs = [b"vote %d" % k for k in range(3)]
    ids = [s.identity() for s in signers]
    sigs = [s.sign(m) for s, m in zip(signers, msgs)]
    hist = registry.histogram(DEVICE_VERIFY_SECONDS)
    count0, sum0 = hist.count, hist.sum
    tracer.enable()
    with TW.one_torch_thread():
        a = backend.verify_batch_begin(ids[:2], msgs[:2], sigs[:2], device="cpu")
        b = backend.verify_batch_begin(ids, msgs, [sigs[0], sigs[1], sigs[0]], device="cpu")
        assert b() == [True, True, False]
        assert backend.last_phase_seconds() == b.phases
        assert a() == [True, True]
    assert a.phases is not b.phases
    assert backend.last_phase_seconds() == a.phases
    assert a.phases["fallback"] == 0.0 < b.phases["fallback"]
    for p in (a.phases, b.phases):
        parts = sum(v for k, v in p.items() if k != "total")
        assert p["total"] == pytest.approx(parts) and p["msm"] > 0 and p["submit"] > 0
    assert hist.count == count0 + 2
    assert hist.sum == pytest.approx(sum0 + a.phases["total"] + b.phases["total"])
    by_batch = {}
    for s in tracer.spans():
        by_batch.setdefault(s.attrs["batch"], []).append(s.name)
    assert len(by_batch) == 2
    first, second = sorted(by_batch)
    assert sorted(by_batch[first]) == sorted(VERIFY_SPANS)
    assert sorted(by_batch[second]) == sorted(VERIFY_SPANS + ("verify.fallback",))
    (blame,) = tracer.spans("verify.fallback")
    assert blame.attrs["batch"] == second and blame.duration == b.phases["fallback"]


@pytest.mark.parametrize("early", [False, True], ids=["inline", "early"])
def test_decided_latencies_one_a_deciding_transition(tracer, early):
    """Two sessions decide in one frame, and a late vote reaches one of
    them afterwards (one more ``ConsensusReached``, not a decision): one
    event with two non-negative latencies, at least the wait between the
    early prepass and the apply."""
    from hashgraph_tpu_torch.signing.stub import StubConsensusSigner

    with TW.one_torch_thread():
        api, engine, props = _node(StubConsensusSigner(b"me"), proposals=2, voters=3)
        rx = engine.event_bus().subscribe()
        tracer.enable()
        signers = _stub_signers(api, 3)
        statuses = _wire_call(api, engine, props, signers[:2], late=signers[2:], early=early)
        events = []
        while (item := rx.try_recv()) is not None:
            events.append(item[1])
    late = int((statuses == int(api.StatusCode.ALREADY_REACHED)).sum())
    assert late == 2 and len(events) == 4
    (decided,) = tracer.events("engine.decided")
    lat = decided["latencies_s"]
    assert len(lat) == len(events) - late == 2
    assert min(lat) >= (0.01 if early else 0.0)
    (begin,) = tracer.spans("engine.wire_verify_begin")
    assert decided["ts"] >= begin.start
