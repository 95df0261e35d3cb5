"""The liveness cell at a toy size on the CPU: its generator, its driver
against the reference, and its two readers of the program's sweep spans."""

import copy

import numpy as np
import pytest

from portbench import check, harness, run, schedule_liveness
from portbench.harness import Ctx, Spans

CELL = "groups64-absent-sweep"
READERS = {
    "engine.sweep_ms_per_kvote.liveness": ("engine.sweep",),
    "engine.sweep_scan_ms_per_kvote.liveness": ("engine.sweep.scan",),
}


def toy(**scale):
    """The cell's files cut to 8 groups of 16 members with a 12 s timeout;
    ``scale`` sets further configuration keys."""
    cfg = copy.deepcopy(harness.load_json(harness.HERE / "configs" / "groups-64-absent.json"))
    cfg.update(scopes=8, sessions_per_scope=3, max_sessions_per_scope=3, voters=16,
               absent_members=[0, 8], timeout_s=12)
    cfg["engine"] = dict(cfg["engine"], capacity=64, voter_capacity=64)
    cfg.update(scale)
    tr = copy.deepcopy(harness.load_json(harness.HERE / "traffic" / "columnar_liveness.json"))
    tr.update(lane_period_s=16, vote_spread_s=[0, 6], late_s=[12, 16], late_share=0.05,
              redelivery_share=0.1, window_calls=40, profile_calls=1)
    return cfg, tr


@pytest.mark.parametrize("scopes", [8, 200])
def test_no_session_is_evicted_before_its_sweep(scopes):
    cfg, tr = toy(scopes=scopes)
    sched = schedule_liveness.build(cfg, tr, 2**35 + 3)
    ages = schedule_liveness.evicted_ages(sched, cfg["max_sessions_per_scope"])
    assert len(ages) and ages.min() > cfg["timeout_s"]
    # Each lane's session goes when the lane's next one arrives.
    assert (ages == tr["lane_period_s"]).all()
    # Every scope's members: the absent never vote, the present each once.
    voted = sched.row_p < sched.preload[0]
    members = sched.p_order[sched.row_p, sched.row_k]
    assert not sched.absent[sched.p_scope[sched.row_p], members].any()
    fresh = voted & ~sched.row_redelivered
    keys = sched.row_p[fresh].astype(np.int64) * cfg["voters"] + members[fresh]
    assert len(np.unique(keys)) == len(keys)


def test_a_period_within_the_timeout_is_refused():
    cfg, tr = toy()
    tr["lane_period_s"] = cfg["timeout_s"]
    with pytest.raises(ValueError):
        schedule_liveness.build(cfg, tr, 5)


def test_driver_agrees_with_the_reference():
    cfg, tr = toy()
    ctx = Ctx(name=CELL, config=cfg, traffic=tr, seed=2**32 + 17, device="cpu")
    driver = harness.load_module(harness.HERE / "drivers" / f"{tr['driver']}.py").Driver(ctx)
    driver.setup()
    spans = Spans()
    window = driver.window(60.0, spans)
    assert window["calls"] == driver.sched.calls - driver.sched.ramp_calls
    assert all("sweep" in r["spans"] for r in spans.calls)
    driver.finish()
    want = driver.reference()
    a = driver.answers
    for c in range(driver.sched.calls):
        assert np.array_equal(a.vote_statuses[c], np.array(want.votes[c], np.int64).reshape(-1))
        assert list(a.proposal_statuses[c]) == want.proposals[c]
    counts, failed = check.compare(a.reading(), want, driver.follow, driver.handed)
    assert check.verdict(counts) and failed == 0
    assert any(r is None for _, r, _ in want.events)  # the sweep failed sessions


def test_readers_sum_the_windows_sweep_spans():
    from hashgraph_tpu_torch.tracing import tracer

    cfg, tr = toy()
    tracer.reset()
    try:
        res = run.run(CELL, cfg, tr, 2**33 + 5, 30.0, True, device="cpu")
        spans = tracer.spans()
    finally:
        tracer.disable()
        tracer.reset()
    assert res["correct"] is True
    got = res["metrics"]
    opens = sorted(s.start for s in spans if s.name == "engine.ingest_proposals")
    since = opens[int(tr["profile_calls"])]
    for name, names in READERS.items():
        total = sum(s.duration for s in spans if s.name in names and s.start >= since)
        assert got[name]["unit"] == "ms" and got[name]["value"] > 0
        assert got[name]["value"] == pytest.approx(total * 1e3 / (res["attempted"] / 1e3))
