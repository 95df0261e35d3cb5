"""The readers of the program's own spans, on a toy traced run of each cell
on the CPU: every one returns a number, and the number is its spans'
durations summed over the timed window's calls, over the window's rows
(the decision tail: the 95th percentile of the window's ``engine.decided``
latencies)."""

import numpy as np
import pytest

import portbench_toy as toy
from portbench import harness, run

# The program-span metrics of each cell, with the spans each sums.
READERS = {
    "groups64-signed-device": {
        "engine.resolve_ms_per_kvote": ("engine.resolve",),
        "engine.register_ms_per_kvote.signed": ("engine.register",),
        "engine.wire_guards_ms_per_kvote": (
            "engine.wire.rules", "engine.wire.guard", "engine.wire.chain", "engine.wire.admit_health"),
        "verify.msm_host_ms_per_kvote": ("verify.msm.scalars", "verify.msm.nibbles"),
        "engine.decision_p95_ms": None,
    },
    "groups64-columnar": {
        "engine.register_ms_per_kvote.columnar": ("engine.register",),
        "engine.apply_ms_per_kvote.columnar": ("engine.ingest_columnar",),
    },
}
CELLS = [
    ("groups64-signed-device", "signed_wire", "engine.wire_verify_begin"),
    ("groups64-columnar", "columnar_shallow", "engine.ingest_proposals"),
]


@pytest.mark.parametrize("cell,traffic,opening", CELLS)
def test_program_span_readers_sum_the_windows_spans(cell, traffic, opening):
    from hashgraph_tpu_torch.tracing import tracer

    tr = toy.traffic(traffic)
    tracer.reset()
    try:
        res = run.run(cell, toy.config("groups-64"), tr, 2**33 + 5, 30.0, True, device="cpu",
                      signer_class=toy.cpu_signer() if traffic == "signed_wire" else None)
        spans = tracer.spans()
        events = tracer.events("engine.decided")
    finally:
        tracer.disable()
        tracer.reset()
    assert res["correct"] is True
    got = res["metrics"]
    assert set(READERS[cell]) <= set(got)
    program = {m["name"] for m in harness.benchmark()["per_layer"] if m["source"] == "program_span"
               and cell in m["workloads"] and m["name"] in got}
    assert set(READERS[cell]) <= program
    # The ramp ran untraced, so the tracer holds the profiled calls' and
    # then the window's: the window opens at the opening span of the call
    # after the profiled ones.
    opens = sorted(s.start for s in spans if s.name == opening)
    profiled = int(tr["profile_calls"])
    assert len(opens) > profiled
    since = opens[profiled]
    rows = res["attempted"]
    for name, names in READERS[cell].items():
        value = got[name]["value"]
        assert got[name]["unit"] == "ms" and value > 0
        if names is None:
            lat = [v for e in events if e["ts"] >= since for v in e["latencies_s"]]
            assert lat and min(lat) >= 0
            assert value == pytest.approx(float(np.quantile(lat, 0.95)) * 1e3)
        else:
            total = sum(s.duration for s in spans if s.name in names and s.start >= since)
            assert value == pytest.approx(total * 1e3 / (rows / 1e3))
