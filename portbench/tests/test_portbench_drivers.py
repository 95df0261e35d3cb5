"""Each driver at a toy size on the CPU, called directly: set-up with its
ramp, a window, the node's answers, and the reference agreeing with all of
them."""

import numpy as np
import pytest

import portbench_toy as toy
from portbench import check, harness
from portbench.harness import Ctx, Spans

CELLS = [
    ("groups64-columnar", "groups-64", "columnar_shallow"),
    ("groups64-signed-device", "groups-64", "signed_wire"),
]


@pytest.mark.parametrize("cell,config,traffic", CELLS)
def test_driver_agrees_with_the_reference(cell, config, traffic):
    tr = toy.traffic(traffic)
    ctx = Ctx(name=cell, config=toy.config(config), traffic=tr, seed=2**32 + 17, device="cpu",
              signer_class=toy.cpu_signer() if traffic == "signed_wire" else None)
    driver = harness.load_module(harness.HERE / "drivers" / f"{tr['driver']}.py").Driver(ctx)
    driver.setup()
    assert driver.next_call == driver.sched.ramp_calls
    spans = Spans()
    window = driver.window(60.0, spans)
    assert window["calls"] == driver.sched.calls - driver.sched.ramp_calls  # ran to the end
    assert window["rows"] == sum(r["rows"] for r in spans.calls) > window["ok"] > 0
    assert all("apply" in r["spans"] and "proposals" in r["spans"] for r in spans.calls)
    driver.finish()
    want = driver.reference()
    a = driver.answers
    for c in range(driver.sched.calls):
        assert np.array_equal(a.vote_statuses[c], np.array(want.votes[c]))
        assert list(a.proposal_statuses[c]) == want.proposals[c]
    assert check.events(a.reading().events, want.events) == 0
    assert a.finals == want.finals
    counts, failed = check.compare(a.reading(), want, driver.follow, driver.handed)
    assert check.verdict(counts) and failed == 0
    # The traffic reaches every kind of answer it is built to.
    seen = set(np.concatenate(list(a.vote_statuses.values())).tolist())
    assert {0, 28} <= seen
    assert any(r is True for r in a.finals.values()) or any(e[1] for e in want.events)
    if traffic == "signed_wire":
        # Forged rows are refused, and exactly their frames are blamed.
        assert 5 in seen
        assert a.blames == want.blames
        assert 0 < sum(want.blames.values()) < len(want.blames)
        assert "blame_mismatches" in counts
    else:
        assert want.blames is None and "blame_mismatches" not in counts
