"""Pre-validated votes in groups with members offline, and the app's
timer: the columnar path with a timeout sweep after every call.

One call is one logical second, as a node whose app fires its timer once
a second sees it: the call's proposals through ``ingest_proposals`` (each
with its own liveness criterion), its rows through
``ingest_columnar_multi``, then ``sweep_timeouts(now)``, which decides
every session still ACTIVE at its expiry, then the drain. The inputs come
from :mod:`portbench.schedule_liveness`; everything else is the columnar
driver's. The reference sweeps at the same clock
(:mod:`portbench.reference.timeouts`).
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from portbench import schedule, schedule_liveness
from portbench.check import Reading
from portbench.drivers import columnar
from portbench.harness import Spans, log, log_calls, warm_profiler
from portbench.node import Answers, engine_for, signer
from portbench.reference.engine import OK
from portbench.reference.timeouts import TimeoutNode


class Driver(columnar.Driver):
    def prepare(self) -> None:
        """The inputs alone: the schedule and every call's columns."""
        ctx = self.ctx
        t0 = time.perf_counter()
        self.sched = sched = schedule_liveness.build(ctx.config, ctx.traffic, ctx.seed)
        self.follow = schedule.followed(sched, ctx.seed, float(ctx.traffic.get("check_share", 1.0)))
        tag = (ctx.seed & (2**128 - 1)).to_bytes(16, "little")
        self.identities = [
            hashlib.sha256(b"portbench/identity" + tag + s.to_bytes(4, "little")
                           + m.to_bytes(4, "little")).digest()
            for s in range(sched.scopes) for m in range(sched.n)
        ]
        voter = sched.p_scope[sched.row_p].astype(np.int64) * sched.n + sched.p_order[sched.row_p, sched.row_k]
        self.columns = []
        for c in range(sched.calls):
            sl = sched.rows(c)
            p = sched.row_p[sl]
            self.columns.append((
                sched.p_scope[p].astype(np.int64), sched.p_pid[p],
                voter[sl], sched.p_value[p, sched.row_k[sl]],
            ))
        log(f"[setup] schedule and columns {time.perf_counter() - t0:.3f} s; "
            f"{sched.calls} calls, {len(sched.row_p)} rows, {int(sched.absent.sum())} members absent")

    def setup(self) -> None:
        ctx = self.ctx
        self.prepare()
        t1 = time.perf_counter()
        self.proposals = self._proposals()
        # The scopes' default liveness is upstream's; every proposal
        # carries its own, which the engine takes.
        self.engine, self.rx = engine_for(dict(ctx.config, liveness_criteria_yes=True), ctx.device,
                                          signer(ctx.traffic, ctx.signer_class))
        self.scopes = list(range(self.sched.scopes))
        self.answers = Answers(self.sched)
        self.gid_of = np.full(len(self.identities), -1, np.int64)
        t2 = time.perf_counter()
        self._preload()
        ramp = Spans()
        self.next_call = self._run(0, self.sched.ramp_calls, None, ramp)
        log_calls("ramp", ramp.calls)
        if ctx.trace:
            warm_profiler()
        log(f"[setup] engine {t2 - t1:.3f} s, ramp {time.perf_counter() - t2:.3f} s "
            f"({self.sched.ramp_calls} calls)")

    def _proposals(self) -> list:
        """Every proposal as a peer would send it: no votes yet, round 1,
        its call's time, expiring ``timeout_s`` later, its own liveness."""
        from hashgraph_tpu_torch.wire import Proposal

        sched = self.sched
        owner = b"\x00" * 32
        return [
            Proposal(name=f"proposal-{p}", payload=p.to_bytes(8, "little"), proposal_id=pid,
                     proposal_owner=owner, votes=[], expected_voters_count=sched.n, round=1,
                     timestamp=schedule.T0 + call, expiration_timestamp=schedule.T0 + call + sched.timeout_s,
                     liveness_criteria_yes=live)
            for p, (pid, call, live) in enumerate(zip(
                sched.p_pid.tolist(), sched.p_call.tolist(), sched.p_liveness.tolist()))
        ]

    def _run(self, first: int, end: int, deadline, spans: Spans) -> int:
        """Calls from ``first`` on, up to ``end`` or, with a ``deadline``,
        the first call begun after it. Returns the call after the last."""
        engine, sched, answers = self.engine, self.sched, self.answers
        c = first
        while True:
            call_range = spans.call()
            call_range.__enter__()
            scope_idx, pids, voters, values = self.columns[c]
            record = spans.new_call(call=c, rows=len(pids))
            now = sched.now(c)
            with spans.span(record, "proposals"):
                items = [(int(sched.p_scope[p]), self.proposals[p]) for p in sched.deliveries[c].tolist()]
                answers.proposal_statuses[c] = np.asarray(engine.ingest_proposals(items, now), np.int32)
            with spans.span(record, "intern"):
                gids = self._gids(voters)
            with spans.span(record, "apply"):
                statuses = engine.ingest_columnar_multi(self.scopes, scope_idx, pids, gids, values, now)
            record["ok"] = int((statuses == OK).sum())
            answers.vote_statuses[c] = statuses
            with spans.span(record, "sweep"):
                swept = engine.sweep_timeouts(now)
            record["fired"] = len(swept)
            record["yes"] = sum(1 for *_, result in swept if result is True)
            record["failed"] = sum(1 for *_, result in swept if result is None)
            with spans.span(record, "drain"):
                answers.drain(self.rx)
            call_range.__exit__(None, None, None)
            c += 1
            if not (c < end and (deadline is None or time.perf_counter() < deadline)):
                return c

    def window(self, seconds: float, spans: Spans, profile_calls: int = 0) -> dict:
        result = super().window(seconds, spans, profile_calls)
        calls = spans.calls
        if calls:
            fired = sum(r["fired"] for r in calls)
            yes = sum(r["yes"] for r in calls)
            failed = sum(r["failed"] for r in calls)
            sweep_s = sum(r["spans"]["sweep"] for r in calls)
            call_s = sum(sum(r["spans"].values()) for r in calls)
            expiring = self.sched.expiring(range(calls[0]["call"], calls[-1]["call"] + 1))
            log(f"[sweep] {len(calls)} sweeps: fired {fired} ({fired / len(calls):.2f} a sweep), "
                f"decided YES {yes}, NO {fired - yes - failed}, failed {failed}; {expiring} sessions "
                f"reached their expiry, {fired / max(expiring, 1):.4f} of them ended by the sweep; "
                f"the sweep {sweep_s / call_s:.4f} of the calls' time")
        counters = self.engine.tracer.counters() if self.ctx.trace else {}
        timeouts = {k: v for k, v in sorted(counters.items()) if k.startswith("engine.timeout")}
        if timeouts:
            log(f"[sweep] counters (profiled and timed calls) {timeouts}")
        return result

    def reference(self, quorum_floor: bool = False) -> Reading:
        """The reference over every call the run handed to the node, the
        sweep after each call's votes, for the sessions of ``self.follow``;
        other rows stay open (``None``)."""
        sched, ctx = self.sched, self.ctx
        node = TimeoutNode(sched.proposal_table(), sched.modes, float(ctx.config["threshold"]),
                           int(ctx.config["max_sessions_per_scope"]), quorum_floor=quorum_floor)
        votes, proposals = {}, {}
        proposals[schedule.PRELOAD_CALL] = node.deliver(
            sched.now(schedule.PRELOAD_CALL), sched.preload.tolist())
        for c in range(0, self.handed.stop):
            now = sched.now(c)
            proposals[c] = node.deliver(now, sched.deliveries[c].tolist())
            scope_idx, pids, voters, values = self.columns[c]
            rows = np.nonzero(self.follow[sched.row_p[sched.rows(c)]])[0]
            statuses: list = [None] * len(pids)
            if len(rows):
                got = node.columnar_resolved(
                    now, node.lookup(scope_idx[rows], pids[rows]).tolist(),
                    voters[rows].tolist(), values[rows].tolist())
                for i, status in zip(rows.tolist(), got):
                    statuses[i] = status
            votes[c] = statuses
            node.sweep(now)
        return Reading(votes, proposals, node.events, {p: node.result(p) for p in node.live.values()})
