"""The port's timeout sweep under the liveness traffic, against the plain
reference's (``portbench/reference/timeouts.py``), on the CPU at a small
size.

Seeded sessions come from the liveness cell's generator
(``portbench/schedule_liveness.py``) at toy scale: groups with members
absent, each proposal with its own liveness criterion, votes that arrive
late, P2P's round cap. Call by call the engine takes the call's proposals
(``ingest_proposals``) and rows (``ingest_columnar_multi``) and then
``sweep_timeouts(now)``; every status, every swept session's outcome, each
session's events and the final results must equal the reference's. The
benchmark's driver at toy size must agree with the reference too, while
the reference with the quorum at ``floor(2n/3)`` or with each proposal's
liveness flipped must not. The sweep's spans and counters are recorded.
"""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from portbench import check, control, harness, schedule  # noqa: E402
from portbench.harness import Ctx, Spans  # noqa: E402
from portbench.node import engine_for, signer  # noqa: E402
from portbench.reference import engine as ref  # noqa: E402
from portbench.reference.timeouts import TimeoutNode  # noqa: E402

DRIVER = harness.HERE / "drivers" / "columnar_liveness.py"
SEED = 2**33 + 23


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def toy(config=None, traffic=None):
    """The cell's configuration and traffic cut to 8 groups of 16 members
    and a 12 s timeout (lanes every 16 s, votes within 6 s, late ones in
    [12, 16)), each updated with the case's own values."""
    cfg = copy.deepcopy(harness.load_json(harness.HERE / "configs" / "groups-64-absent.json"))
    cfg.update(scopes=8, sessions_per_scope=3, max_sessions_per_scope=3, voters=16,
               absent_members=[0, 8], timeout_s=12)
    cfg["engine"] = dict(cfg["engine"], capacity=64, voter_capacity=64)
    tr = copy.deepcopy(harness.load_json(harness.HERE / "traffic" / "columnar_liveness.json"))
    tr.update(lane_period_s=16, vote_spread_s=[0, 6], late_s=[12, 16], late_share=0.05,
              redelivery_share=0.1, window_calls=40, profile_calls=1)
    cfg.update(config or {})
    tr.update(traffic or {})
    return cfg, tr


def driver(cfg, tr, seed=SEED):
    return harness.load_module(DRIVER).Driver(
        Ctx(name="groups64-absent-sweep", config=cfg, traffic=tr, seed=seed, device="cpu"))


# Each case: the configuration's and traffic's changes, the sweep twice a
# call or once, and what the case must reach (status codes of the rows,
# and the sweep's outcomes: True, False, None for failed).
CASES = {
    "absent-above-a-third": (dict(absent_members=[6, 8], liveness_yes_share=1.0), {}, False,
                             {ref.OK}, {True, None}),
    "mixed-liveness": (dict(liveness_yes_share=0.5), dict(yes_share=[0.2, 0.5]), False,
                       {ref.OK, ref.ALREADY_REACHED}, {True, False, None}),
    "late-votes": ({}, dict(late_share=0.4), False,
                   {ref.PROPOSAL_EXPIRED, ref.ALREADY_REACHED, ref.SESSION_NOT_ACTIVE}, {None}),
    "p2p-cap": (dict(modes=["p2p"], absent_members=[0, 1]), dict(yes_share=[0.4, 0.6]), False,
                {ref.MAX_ROUNDS_EXCEEDED, ref.SESSION_NOT_ACTIVE}, set()),
    "second-sweep-no-op": ({}, {}, True, {ref.OK}, {None}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_matches_the_reference(case):
    from hashgraph_tpu_torch.errors import ConsensusFailed

    config, traffic, twice, want_codes, want_outcomes = CASES[case]
    cfg, tr = toy(config, traffic)
    drv = driver(cfg, tr)
    drv.prepare()
    sched = drv.sched
    proposals = drv._proposals()
    engine, rx = engine_for(dict(cfg, liveness_criteria_yes=True), "cpu", signer(tr))
    node = TimeoutNode(sched.proposal_table(), sched.modes, float(cfg["threshold"]),
                       int(cfg["max_sessions_per_scope"]))
    key_to_p = {(int(s), int(pid)): p for p, (s, pid) in enumerate(zip(sched.p_scope, sched.p_pid))}
    scopes = list(range(sched.scopes))
    events, codes, outcomes = [], set(), set()

    def drain():
        while (item := rx.try_recv()) is not None:
            scope, event = item
            events.append((key_to_p[(scope, event.proposal_id)], getattr(event, "result", None),
                           event.timestamp))

    def deliver(call, items):
        now = sched.now(call)
        got = engine.ingest_proposals([(int(sched.p_scope[p]), proposals[p]) for p in items], now)
        assert list(got) == node.deliver(now, items)

    deliver(schedule.PRELOAD_CALL, sched.preload.tolist())
    for c in range(sched.calls):
        now = sched.now(c)
        deliver(c, sched.deliveries[c].tolist())
        scope_idx, pids, voters, values = drv.columns[c]
        gids = np.array([engine.voter_gid(drv.identities[v]) for v in voters.tolist()], np.int64)
        got = engine.ingest_columnar_multi(scopes, scope_idx, pids, gids, values, now)
        want = node.columnar(now, scope_idx.tolist(), pids.tolist(), voters.tolist(), values.tolist())
        assert np.array_equal(np.asarray(got), np.asarray(want, np.int64).reshape(-1)), c
        codes.update(want)
        for again in range(2 if twice else 1):
            swept = sorted((key_to_p[(s, pid)], r) for s, pid, r in engine.sweep_timeouts(now))
            fired = sorted(node.sweep(now))
            assert swept == fired, c
            assert not (again and swept)
            outcomes.update(r for _, r in fired)
        drain()
    assert check.events(events, node.events) == 0
    finals = {}
    for scope, pid in engine.session_keys():
        try:
            finals[key_to_p[(scope, pid)]] = engine.get_consensus_result(scope, pid)
        except ConsensusFailed:
            finals[key_to_p[(scope, pid)]] = "failed"
    assert finals == {p: node.result(p) for p in node.live.values()}
    assert want_codes <= codes and want_outcomes <= outcomes


def _run_window(drv):
    drv.setup()
    assert drv.next_call == drv.sched.ramp_calls
    window = drv.window(60.0, Spans())
    assert window["calls"] == drv.sched.calls - drv.sched.ramp_calls
    drv.finish()
    return window


@pytest.mark.parametrize("seed", [SEED, 2**40 + 9])
def test_driver_agrees_with_the_reference(seed):
    drv = driver(*toy(), seed=seed)
    window = _run_window(drv)
    assert window["rows"] > window["ok"] > 0
    want = drv.reference()
    counts, failed = check.compare(drv.answers.reading(), want, drv.follow, drv.handed)
    assert check.verdict(counts) and failed == 0
    assert all(v == 0 for v in counts.values())
    # The sweep ended sessions in the window, decided and failed.
    window_events = [e for e in want.events if e[2] >= drv.sched.now(drv.sched.ramp_calls)]
    assert {True, False, None} <= {r for _, r, _ in window_events}


@pytest.mark.parametrize("broken", ["quorum-floor", "liveness-flipped"])
def test_a_broken_reference_is_not_correct(broken):
    drv = driver(*toy(), seed=31)
    drv.prepare()
    drv.handed = range(drv.sched.ramp_calls, drv.sched.calls)
    if broken == "quorum-floor":
        counts = control.counts(drv)
    else:
        want = drv.reference()
        drv.sched.p_liveness = ~drv.sched.p_liveness
        counts = check.compare(drv.reference(), want, drv.follow, drv.handed)[0]
    assert not check.verdict(counts)
    assert counts["event_mismatches"] > 0


def test_sweep_spans_and_counters_are_recorded():
    from hashgraph_tpu_torch.tracing import tracer

    drv = driver(*toy())
    tracer.reset()
    tracer.enable()
    try:
        _run_window(drv)
        names = {s.name for s in tracer.spans()}
        counters = tracer.counters()
    finally:
        tracer.disable()
        tracer.reset()
    assert {"engine.sweep", "engine.sweep.scan", "engine.sweep.timeout", "engine.sweep.emit",
            "engine.lifecycle_sweep"} <= names
    fired = counters["engine.timeouts_fired"]
    assert counters["engine.timeout_sweeps"] == drv.sched.calls
    assert counters["engine.timeouts_reached"] > 0 and counters["engine.timeouts_failed"] > 0
    assert counters["engine.timeouts_reached"] + counters["engine.timeouts_failed"] == fired
