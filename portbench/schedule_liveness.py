"""The generator of the liveness traffic: sessions that outlive their
timeout, in groups with members offline, all from the seed.

A configuration fixes the deployment (scopes, live sessions a scope,
voters a session, each scope's mode, the timeout) and, here, the failure:
each scope has a fixed, seeded set of absent members (``absent_members``,
the range of its size), who never vote, and each proposal its own
``liveness_criteria_yes`` (true with probability ``liveness_yes_share``).
A traffic file fixes the parameters read here.

The node keeps ``scopes x sessions_per_scope`` *lanes*. A lane starts a
proposal every ``lane_period_s`` logical seconds, the lanes staggered
evenly over a period; with a period longer than the timeout, the per-scope
cap evicts a lane's previous session only after its timeout has passed,
so every session that is still ACTIVE at its expiry is left to the
caller's timeout sweep. Each present member votes once, chained in arrival
order: its vote arrives a seeded whole second in ``vote_spread_s`` after
the proposal, or, for ``late_share`` of the votes, in ``late_s`` (at or
after the expiry, before the eviction). A proposal's yes votes are
``yes_share`` of its present members. Within a call the sessions' rows are
interleaved, each session's in its order; each call also redelivers
``redelivery_share`` of the previous call's rows at seeded places.

Before the first call every scope is filled to its cap with proposals
that nobody votes on (the preload, delivered at ``T0 - 1``): the lanes'
first proposals evict them, and those still live at their expiry are
swept. The calls until every lane's first proposal has been evicted are
the ramp, run in set-up.

Time is logical, as in :mod:`portbench.schedule`: call ``c`` happens at
``T0 + c`` seconds. The result is a :class:`portbench.schedule.Schedule`
with each proposal's liveness beside it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.schedule import PRELOAD_CALL, T0, Schedule, _rng, _unique_pids


@dataclass
class LivenessSchedule(Schedule):
    p_liveness: np.ndarray      # bool[P]: the proposal's liveness_criteria_yes
    absent: np.ndarray          # bool[scopes, n]: members that never vote

    def proposal_table(self) -> list:
        """``(scope, pid, timestamp, expiration, n, liveness)`` a proposal,
        each with its own liveness."""
        ts = (T0 + self.p_call).tolist()
        return [
            (s, pid, t, t + self.timeout_s, self.n, lv) for s, pid, t, lv in
            zip(self.p_scope.tolist(), self.p_pid.tolist(), ts, self.p_liveness.tolist())
        ]

    def expiring(self, calls: range) -> int:
        """Sessions of the lanes whose expiry falls in ``calls``: live then,
        since the cap evicts a session only after its expiry."""
        due = self.p_call[: self.preload[0]].astype(np.int64) + self.timeout_s
        return int(((due >= calls.start) & (due < calls.stop)).sum())


def build(config: dict, traffic: dict, seed: int) -> LivenessSchedule:
    n = int(config["voters"])
    scopes = int(config["scopes"])
    per_scope = int(config["sessions_per_scope"])
    cap = int(config["max_sessions_per_scope"])
    modes = [config["modes"][s % len(config["modes"])] for s in range(scopes)]
    timeout = int(config["timeout_s"])
    period = int(traffic["lane_period_s"])
    spread_lo, spread_hi = (int(v) for v in traffic["vote_spread_s"])
    late_lo, late_hi = (int(v) for v in traffic["late_s"])
    if period <= timeout or late_hi > period or spread_hi > timeout:
        raise ValueError("a lane's period must outlast the timeout and every vote")
    lanes = scopes * per_scope

    # The failure: each scope's absent members, fixed for the run.
    frng = _rng(seed, 10)
    lo, hi = config["absent_members"]
    absent_count = frng.integers(int(lo), int(hi) + 1, scopes)
    absent = np.argsort(frng.random((scopes, n)), axis=1) < absent_count[:, None]

    # Lanes, staggered evenly over a period; the ramp ends when every
    # lane's first proposal has been evicted by its second.
    rng = _rng(seed, 11)
    start = (rng.permutation(lanes) * period) // lanes
    ramp_calls = int(start.max()) + period + 1
    calls = ramp_calls + int(traffic["window_calls"])
    generations = (calls - 1 - start) // period + 1
    lane = np.repeat(np.arange(lanes), generations)
    gen = np.arange(len(lane)) - np.repeat(np.cumsum(generations) - generations, generations)
    created = start[lane] + gen * period
    # Proposals in order of delivery: by call, seeded within a call.
    order = np.lexsort((rng.random(len(lane)), created))
    p_call = created[order].astype(np.int32)
    p_scope = (lane[order] // per_scope).astype(np.int32)
    proposals = len(p_call)

    # Votes: the present members in arrival order, each at its second.
    vrng = _rng(seed, 12)
    off = absent[p_scope]                                  # [P, n]
    present = n - absent_count[p_scope]                    # [P]
    # Present members first (seeded order), the absent after them.
    p_order = np.argsort(vrng.random((proposals, n)) + off, axis=1).astype(
        np.int16 if n <= 32767 else np.int32)
    k = np.arange(n)[None, :]
    voting = k < present[:, None]
    late = vrng.random((proposals, n)) < float(traffic["late_share"])
    delay = np.where(late, vrng.integers(late_lo, late_hi, (proposals, n)),
                     vrng.integers(spread_lo, spread_hi, (proposals, n)))
    # The k-th vote of the chain arrives at the k-th earliest second.
    delay = np.sort(np.where(voting, delay, np.iinfo(np.int64).max), axis=1)
    y_lo, y_hi = traffic["yes_share"]
    yes_count = np.rint(vrng.uniform(y_lo, y_hi, proposals) * present).astype(np.int64)
    rank = np.argsort(np.argsort(np.where(voting, vrng.random((proposals, n)), 2.0), axis=1), axis=1)
    p_value = rank < yes_count[:, None]

    # Rows of the calls made: (proposal, vote index, call).
    arrive = np.where(voting, p_call[:, None].astype(np.int64) + np.where(voting, delay, 0), calls)
    rp, rk = np.nonzero(arrive < calls)  # by proposal, then chain order
    rc = arrive[rp, rk]
    # Interleave within a call: each row a seeded instant of its second,
    # a session's instants handed to its rows in their chain order.
    session = rc * proposals + rp
    base = np.argsort(session, kind="stable")
    rp, rk, rc, session = rp[base], rk[base], rc[base], session[base]
    u = vrng.random(len(rp))
    u = u[np.argsort(session + u)]
    inter = np.argsort(rc + u)
    rp, rk, rc = rp[inter], rk[inter], rc[inter]
    bounds = np.searchsorted(rc, np.arange(calls + 1))

    # The preload: cap proposals a scope, after the voted ones.
    preload = np.arange(proposals, proposals + scopes * cap)
    lrng = _rng(seed, 13)
    p_liveness = lrng.random(proposals + scopes * cap) < float(config["liveness_yes_share"])
    p_scope = np.concatenate([p_scope, np.repeat(np.arange(scopes, dtype=np.int32), cap)])
    p_call = np.concatenate([p_call, np.full(scopes * cap, PRELOAD_CALL, np.int32)])
    p_order = np.concatenate([p_order, np.zeros((scopes * cap, n), p_order.dtype)])
    p_value = np.concatenate([p_value, np.zeros((scopes * cap, n), bool)])
    p_pid = _unique_pids(lrng, p_scope)

    # Redeliveries: copies of the previous call's fresh rows.
    share = float(traffic.get("redelivery_share", 0.0))
    crng = _rng(seed, 14)
    out_p, out_k, out_red, starts = [], [], [], [0]
    for c in range(calls):
        cp, ck = rp[bounds[c]:bounds[c + 1]], rk[bounds[c]:bounds[c + 1]]
        red = np.zeros(len(cp), bool)
        prev = slice(bounds[c - 1], bounds[c]) if c else slice(0, 0)
        count = int(round(share * (prev.stop - prev.start)))
        if count:
            pick = crng.choice(prev.stop - prev.start, count, replace=False)
            at = np.sort(crng.integers(0, len(cp) + 1, count))
            cp = np.insert(cp, at, rp[prev][pick])
            ck = np.insert(ck, at, rk[prev][pick])
            red = np.insert(red, at, True)
        out_p.append(cp)
        out_k.append(ck)
        out_red.append(red)
        starts.append(starts[-1] + len(cp))
    delivered = p_call[:proposals]
    cuts = np.searchsorted(delivered, np.arange(calls + 1))
    sched = LivenessSchedule(
        n=n, scopes=scopes, modes=modes, ramp_calls=ramp_calls,
        p_scope=p_scope, p_pid=p_pid, p_call=p_call, p_order=p_order, p_value=p_value,
        call_start=np.array(starts, np.int64),
        row_p=np.concatenate(out_p).astype(np.int32),
        row_k=np.concatenate(out_k).astype(np.int32),
        row_redelivered=np.concatenate(out_red),
        deliveries=[np.arange(cuts[c], cuts[c + 1], dtype=np.int64) for c in range(calls)],
        timeout_s=timeout, preload=preload,
        p_liveness=p_liveness, absent=absent,
    )
    # A session is evicted only after the sweep at its expiry.
    if (evicted_ages(sched, cap) <= timeout).any():
        raise AssertionError("a session is evicted before its timeout has been swept")
    return sched


def evicted_ages(sched: Schedule, cap: int) -> np.ndarray:
    """The age in seconds of every voted session when the per-scope cap
    evicts it (the oldest of its scope goes; among equally old ones the
    one registered last)."""
    first_preload = int(sched.preload[0])
    sessions: "dict[int, list]" = {}
    ages = []
    order = [(PRELOAD_CALL, sched.preload)] + list(enumerate(sched.deliveries))
    for call, items in order:
        for p in items.tolist():
            live = sessions.setdefault(int(sched.p_scope[p]), [])
            live.append((call, p))
            if len(live) > cap:
                last = 0
                while last + 1 < len(live) and live[last + 1][0] == live[0][0]:
                    last += 1
                born, gone = live.pop(last)
                if gone < first_preload:
                    ages.append(call - born)
    return np.asarray(ages, np.int64)
