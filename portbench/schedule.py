"""The one traffic generator: who proposes what, and which votes arrive in
which call, all from the seed.

A configuration fixes the deployment (scopes, live sessions a scope, voters
a session, each scope's mode); a traffic file fixes the parameters read
here. The node keeps ``scopes x sessions_per_scope`` *lanes*, each a
sequence of proposals one after another. Visits go round the lanes in one
seeded order; a visit to a lane delivers its proposal's next
``votes_per_visit`` chained votes. A proposal's votes take ``V = voters /
votes_per_visit`` visits; the lane then rests ``gap`` rounds, so that its
next proposal arrives in a later call than its last vote, and the
per-scope cap evicts only sessions whose votes have all arrived. Lanes
start at staggered rounds, so that in the steady state every age of
session is present in equal numbers; the calls until then are the ramp,
run in set-up.

Votes are cut into calls of ``rows_per_call`` rows. Each call also
redelivers ``redelivery_share`` of its rows: copies of votes of the
previous call, at seeded places. The rows of one call alternate between
proposals (each proposal's own order kept). A proposal is delivered at the
start of the call that holds its first vote.

Before the first call every scope is filled to its cap with proposals
that nobody votes on (the preload, delivered at ``T0 - 1``), so that from
the first call on every arrival evicts the oldest session of its scope, as
in a node that has run for a while: first the preload, then finished
sessions.

Time is logical: call ``c`` happens at ``T0 + c`` seconds, so the work is
the same whatever the speed. A proposal's timestamp is its call's time and
it expires ``timeout_s`` later; a vote's timestamp is its call's time.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

T0 = 1_700_000_000
PRELOAD_CALL = -1  # the preload's logical call: T0 - 1


@dataclass
class Schedule:
    n: int                      # voters a session
    scopes: int
    modes: "list[str]"          # by scope
    ramp_calls: int             # calls before the steady state
    # Proposals, in order of delivery.
    p_scope: np.ndarray         # int32[P]
    p_pid: np.ndarray           # int64[P] (u32 values)
    p_call: np.ndarray          # int32[P] call of delivery
    p_order: np.ndarray         # int16/int32[P, n]: member voting k-th
    p_value: np.ndarray         # bool[P, n]: the k-th vote's value
    # Calls: rows as (proposal, vote index), redeliveries flagged.
    call_start: np.ndarray      # int64[C + 1] into the row arrays
    row_p: np.ndarray           # int32[rows]
    row_k: np.ndarray           # int32[rows]
    row_redelivered: np.ndarray  # bool[rows]
    deliveries: "list[np.ndarray]"  # per call: proposal indices, in order
    timeout_s: int
    preload: np.ndarray         # proposals delivered before call 0, at PRELOAD_CALL

    @property
    def calls(self) -> int:
        return len(self.call_start) - 1

    def now(self, call: int) -> int:
        return T0 + call

    def rows(self, call: int) -> slice:
        return slice(int(self.call_start[call]), int(self.call_start[call + 1]))

    def proposal_table(self, liveness_yes: bool) -> list:
        """``(scope, pid, timestamp, expiration, n, liveness)`` a proposal,
        as the reference takes them."""
        ts = (T0 + self.p_call).tolist()
        return [
            (s, pid, t, t + self.timeout_s, self.n, liveness_yes)
            for s, pid, t in zip(self.p_scope.tolist(), self.p_pid.tolist(), ts)
        ]


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), stream]))


def build(config: dict, traffic: dict, seed: int) -> Schedule:
    n = int(config["voters"])
    scopes = int(config["scopes"])
    per_scope = int(config["sessions_per_scope"])
    modes = [config["modes"][s % len(config["modes"])] for s in range(scopes)]
    rows_per_call = int(traffic["rows_per_call"])
    vpv = int(traffic["votes_per_visit"])
    if n % vpv:
        raise ValueError("votes_per_visit must divide the voters a session")
    redeliver = int(round(float(traffic.get("redelivery_share", 0.0)) * rows_per_call))
    fresh_per_call = rows_per_call - redeliver
    window_calls = int(traffic["window_calls"])
    timeout = int(config["timeout_s"])
    lanes = scopes * per_scope
    visits = n // vpv

    rng = _rng(seed, 0)
    visit_order = rng.permutation(lanes)  # lane visited at each place of a round
    # The rest between a lane's proposals: enough rounds that its next
    # proposal's first vote lies at least a call after its last one.
    gap = 1
    while (gap + 1) * lanes * vpv * visits / (visits + gap) < 1.1 * rows_per_call:
        gap += 1
    period = visits + gap
    # Staggered entry: the lanes' first rounds spread evenly over a period.
    start = (rng.permutation(lanes) * period) // lanes

    # Rounds, laid out as [round, place]; a place is active when its lane is
    # voting. Enough rounds to reach the steady state and fill the calls.
    per_round = lanes * vpv * visits / period
    need = period * lanes * vpv + (window_calls + 2) * fresh_per_call
    rounds = int(math.ceil(need / per_round)) + period + 2
    lane_at = visit_order[None, :]
    age = np.arange(rounds)[:, None] - start[lane_at]  # rounds since the lane's entry
    active = (age >= 0) & (age % period < visits)
    generation = np.where(age >= 0, age // period, -1)
    visit = age % period
    rr, jj = np.nonzero(active)  # in row order
    lane_of = visit_order[jj]
    gen_of = generation[rr, jj]
    visit_of = visit[rr, jj]

    # Number proposals by their first visit, which is the order of their
    # first vote.
    first = visit_of == 0
    key_lane, key_gen = lane_of[first], gen_of[first]
    proposals = len(key_lane)
    index = np.full((lanes, int(gen_of.max()) + 1), -1, np.int64)
    index[key_lane, key_gen] = np.arange(proposals)
    # Visits before a lane's first proposal (none: entry starts a proposal)
    visit_p = index[lane_of, gen_of]
    if (visit_p < 0).any():
        raise AssertionError("a visit without a proposal")

    # Fresh rows: vpv votes a visit.
    row_p = np.repeat(visit_p, vpv).astype(np.int32)
    row_k = (np.repeat(visit_of, vpv) * vpv + np.tile(np.arange(vpv), len(visit_p))).astype(np.int32)
    # The ramp ends where the last lane has entered.
    steady_row = int(np.searchsorted(rr, period) * vpv)
    ramp_calls = steady_row // fresh_per_call + 1
    calls = min(ramp_calls + window_calls, len(row_p) // fresh_per_call)
    row_p = row_p[: calls * fresh_per_call]
    row_k = row_k[: calls * fresh_per_call]
    fresh_call = np.arange(len(row_p)) // fresh_per_call

    used = np.unique(row_p)
    if len(used) != int(row_p.max()) + 1:
        raise AssertionError("proposals are not numbered by their first vote")
    proposals = len(used)
    p_lane = key_lane[:proposals]
    p_scope = (p_lane // per_scope).astype(np.int32)
    first_row = np.full(proposals, len(row_p), np.int64)
    np.minimum.at(first_row, row_p, np.arange(len(row_p)))
    last_row = np.zeros(proposals, np.int64)
    np.maximum.at(last_row, row_p, np.arange(len(row_p)))
    p_call = (first_row // fresh_per_call).astype(np.int32)
    # Every vote of a proposal, up to the end of the generated calls, before
    # it expires: only votes in the calls made count.
    if (fresh_call[last_row] - p_call >= timeout).any():
        raise ValueError("a proposal's votes outlast its timeout: fewer live sessions or larger calls")
    # The lane's next proposal arrives after its last vote's call.
    order_in_lane = np.lexsort((first_row, p_lane))
    same_lane = p_lane[order_in_lane][1:] == p_lane[order_in_lane][:-1]
    prev_last = fresh_call[last_row[order_in_lane][:-1]][same_lane]
    next_call = p_call[order_in_lane][1:][same_lane]
    if (next_call <= prev_last).any():
        raise AssertionError("a lane's next proposal arrives with its previous one's votes")

    # Per-proposal content.
    prng = _rng(seed, 1)
    lo, hi = traffic["yes_share"]
    yes_count = np.rint(prng.uniform(lo, hi, proposals) * n).astype(np.int64)
    order_dtype = np.int16 if n <= 32767 else np.int32
    base = np.broadcast_to(np.arange(n, dtype=order_dtype), (proposals, n))
    p_order = prng.permuted(base, axis=1)
    p_value = prng.permuted(base, axis=1) < yes_count[:, None]

    # The preload: cap proposals a scope, after the voted ones.
    cap = int(config["max_sessions_per_scope"])
    preload = np.arange(proposals, proposals + scopes * cap)
    p_scope = np.concatenate([p_scope, np.repeat(np.arange(scopes, dtype=np.int32), cap)])
    p_call = np.concatenate([p_call, np.full(scopes * cap, PRELOAD_CALL, np.int32)])
    p_order = np.concatenate([p_order, np.zeros((scopes * cap, n), p_order.dtype)])
    p_value = np.concatenate([p_value, np.zeros((scopes * cap, n), bool)])
    p_pid = _unique_pids(prng, p_scope)

    # Calls: interleave, then redeliveries.
    crng = _rng(seed, 2)
    out_p, out_k, out_red, starts = [], [], [], [0]
    for c in range(calls):
        sl = slice(c * fresh_per_call, (c + 1) * fresh_per_call)
        cp, ck = row_p[sl], row_k[sl]
        if vpv > 1:
            # Rank of each row within its proposal's rows of this call,
            # then rows by rank, proposals in order of appearance.
            by_p = np.argsort(cp, kind="stable")
            sp = cp[by_p]
            head = np.ones(len(sp), bool)
            head[1:] = sp[1:] != sp[:-1]
            group_start = np.maximum.accumulate(np.where(head, np.arange(len(sp)), 0))
            rank = np.empty(len(sp), np.int64)
            rank[by_p] = np.arange(len(sp)) - group_start
            appear = np.empty(len(sp), np.int64)
            appear[by_p] = np.minimum.reduceat(by_p, np.nonzero(head)[0])[np.cumsum(head) - 1]
            o = np.lexsort((appear, rank))
            cp, ck = cp[o], ck[o]
        red = np.zeros(len(cp), bool)
        if c > 0 and redeliver:
            prev = slice(c * fresh_per_call - fresh_per_call, c * fresh_per_call)
            pick = crng.choice(fresh_per_call, redeliver, replace=False)
            at = np.sort(crng.integers(0, len(cp) + 1, redeliver))
            cp = np.insert(cp, at, row_p[prev][pick])
            ck = np.insert(ck, at, row_k[prev][pick])
            red = np.insert(red, at, True)
        out_p.append(cp)
        out_k.append(ck)
        out_red.append(red)
        starts.append(starts[-1] + len(cp))
    # Delivery order within a call: the proposal whose first vote comes
    # last registers first, so that among sessions of one age the
    # per-scope cap evicts the one that finished first.
    deliveries = [[] for _ in range(calls)]
    for p in np.argsort(-first_row, kind="stable").tolist():
        deliveries[int(p_call[p])].append(p)
    return Schedule(
        n=n, scopes=scopes, modes=modes,
        ramp_calls=ramp_calls, p_scope=p_scope, p_pid=p_pid, p_call=p_call,
        p_order=p_order, p_value=p_value,
        call_start=np.array(starts, np.int64),
        row_p=np.concatenate(out_p).astype(np.int32),
        row_k=np.concatenate(out_k).astype(np.int32),
        row_redelivered=np.concatenate(out_red),
        deliveries=[np.array(d, np.int64) for d in deliveries],
        timeout_s=timeout,
        preload=preload,
    )


def followed(sched: Schedule, seed: int, share: float) -> np.ndarray:
    """The sessions whose answers a run checks: a share of them, drawn from
    the seed (every one at share 1)."""
    if share >= 1.0:
        return np.ones(len(sched.p_pid), bool)
    return _rng(seed, 4).random(len(sched.p_pid)) < share


def _unique_pids(rng: np.random.Generator, p_scope: np.ndarray) -> np.ndarray:
    """Nonzero u32 proposal ids, distinct within a scope over the run."""
    pids = rng.integers(1, 2**32, len(p_scope), dtype=np.int64)
    while True:
        key = (p_scope.astype(np.int64) << 32) | pids
        _, first = np.unique(key, return_index=True)
        dup = np.ones(len(key), bool)
        dup[first] = False
        if not dup.any():
            return pids
        pids[dup] = rng.integers(1, 2**32, int(dup.sum()), dtype=np.int64)
