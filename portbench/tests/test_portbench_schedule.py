"""The traffic generator: deterministic by seed, chains in order, the
logical clock, and evictions only of finished sessions."""

import numpy as np
import pytest

import portbench_toy as toy
from portbench import schedule
from portbench.reference.engine import SESSION_NOT_FOUND, ReferenceNode

CASES = [("groups-64", "columnar_shallow"), ("groups-64", "signed_wire"),
         ("groups-64", {"votes_per_visit": 4})]


def _traffic(traffic):
    """A traffic file by name, or the shallow one with some parameters
    changed (several chained votes of a proposal a visit)."""
    if isinstance(traffic, str):
        return toy.traffic(traffic)
    return toy.traffic("columnar_shallow", **traffic)


@pytest.mark.parametrize("config,traffic", CASES)
def test_same_seed_same_schedule(config, traffic):
    cfg, tr = toy.config(config), _traffic(traffic)
    a, b = schedule.build(cfg, tr, 2**33 + 5), schedule.build(cfg, tr, 2**33 + 5)
    c = schedule.build(cfg, tr, 2**33 + 6)
    for name in ("p_pid", "p_order", "p_value", "row_p", "row_k", "call_start"):
        assert np.array_equal(getattr(a, name), getattr(b, name))
    assert not np.array_equal(a.p_pid, c.p_pid)


@pytest.mark.parametrize("config,traffic", CASES)
def test_votes_arrive_in_chain_order_once_each(config, traffic):
    cfg, tr = toy.config(config), _traffic(traffic)
    s = schedule.build(cfg, tr, 11)
    fresh = ~s.row_redelivered
    p, k = s.row_p[fresh], s.row_k[fresh]
    order = np.lexsort((np.arange(len(p)), p))  # by proposal, arrival order kept
    sp, sk = p[order], k[order]
    start = np.r_[True, sp[1:] != sp[:-1]]
    rank = np.arange(len(sp)) - np.maximum.accumulate(np.where(start, np.arange(len(sp)), 0))
    assert np.array_equal(sk, rank)  # vote k is the k-th to arrive, each once
    # Every member votes at most once a proposal.
    for q in np.unique(p)[:50]:
        members = s.p_order[q, sk[sp == q]]
        assert len(set(members.tolist())) == len(members)


@pytest.mark.parametrize("config,traffic", CASES)
def test_logical_clock_and_deliveries(config, traffic):
    cfg, tr = toy.config(config), _traffic(traffic)
    s = schedule.build(cfg, tr, 12)
    assert s.now(5) == schedule.T0 + 5
    call_of_row = np.repeat(np.arange(s.calls), np.diff(s.call_start))
    # A proposal is delivered in the call of its first vote, and every
    # vote arrives before it expires.
    voted = len(s.p_pid) - len(s.preload)
    first = np.full(voted, s.calls)
    np.minimum.at(first, s.row_p, call_of_row)
    assert np.array_equal(first, s.p_call[:voted])
    assert (call_of_row - s.p_call[s.row_p] < s.timeout_s).all()
    delivered = np.concatenate(s.deliveries)
    assert sorted(delivered.tolist()) == list(range(voted))
    # The preload fills every scope to its cap before the first call.
    assert (s.p_call[s.preload] == schedule.PRELOAD_CALL).all()
    assert np.array_equal(np.bincount(s.p_scope[s.preload], minlength=s.scopes),
                          np.full(s.scopes, cfg["max_sessions_per_scope"]))
    # Redeliveries copy votes of the previous call.
    red = np.nonzero(s.row_redelivered)[0]
    assert bool(len(red)) == (tr["redelivery_share"] > 0)
    assert (s.p_call[s.row_p[red]] < call_of_row[red]).all()


@pytest.mark.parametrize("config,traffic", CASES)
def test_eviction_takes_only_finished_sessions(config, traffic):
    cfg, tr = toy.config(config), _traffic(traffic)
    s = schedule.build(cfg, tr, 13)
    node = ReferenceNode(s.proposal_table(True), s.modes, cfg["threshold"],
                         cfg["max_sessions_per_scope"])
    node.deliver(s.now(schedule.PRELOAD_CALL), s.preload.tolist())
    evicting = []
    for c in range(s.calls):
        held = len(node.live)
        node.deliver(s.now(c), s.deliveries[c].tolist())
        sl = s.rows(c)
        p = s.row_p[sl]
        got = np.array(node.columnar(s.now(c), s.p_scope[p].tolist(), s.p_pid[p].tolist(),
                                     (s.p_order[p, s.row_k[sl]].astype(np.int64)
                                      + s.p_scope[p].astype(np.int64) * s.n).tolist(),
                                     s.p_value[p, s.row_k[sl]].tolist()))
        assert not ((got == SESSION_NOT_FOUND) & ~s.row_redelivered[sl]).any()
        evicting.append(held == len(node.live))
    # Every scope is at its cap throughout: each arrival evicts one session.
    assert all(evicting)


def test_the_ramp_ends_in_the_steady_state():
    cfg, tr = toy.config("groups-64"), toy.traffic("columnar_shallow")
    s = schedule.build(cfg, tr, 14)
    lanes = cfg["scopes"] * cfg["sessions_per_scope"]
    call_of_row = np.repeat(np.arange(s.calls), np.diff(s.call_start))
    first_call_of_lane_entry = s.p_call[: lanes]
    assert first_call_of_lane_entry.max() < s.ramp_calls
    assert s.calls > s.ramp_calls and call_of_row[-1] == s.calls - 1
