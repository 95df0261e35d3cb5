"""Pre-validated votes as columns: the throughput path that the bridge,
gossip, WAL replay and the fleet ride on.

A call hands one call's rows of the schedule as dense columns (scope
indices, proposal ids, interned voter ids, values) to
``ingest_columnar_multi``, after delivering the call's proposals through
``ingest_proposals``. Voter ids are interned again every call
(``voter_gid``, a dict hit), as a caller whose voters come and go must:
an id whose last session was evicted is freed. Events are taken off the
bus after each call.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from portbench import schedule
from portbench.check import Reading
from portbench.harness import DeviceProfile, Spans, log, log_calls, warm_profiler
from portbench.node import Answers, engine_for, proposals_of, signer
from portbench.reference.engine import OK, ReferenceNode


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx

    def prepare(self) -> None:
        """The inputs alone: the schedule and every call's columns."""
        ctx = self.ctx
        t0 = time.perf_counter()
        self.sched = sched = schedule.build(ctx.config, ctx.traffic, ctx.seed)
        self.follow = schedule.followed(sched, ctx.seed, float(ctx.traffic.get("check_share", 1.0)))
        # A voter is its scope's member; its identity comes from the seed.
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
        log(f"[setup] schedule and columns {time.perf_counter() - t0:.3f} s")

    def setup(self) -> None:
        ctx = self.ctx
        self.prepare()
        t1 = time.perf_counter()
        self.proposals = proposals_of(self.sched, ctx.config)
        self.engine, self.rx = engine_for(ctx.config, ctx.device, signer(ctx.traffic, ctx.signer_class))
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

    def _preload(self) -> None:
        """Fill every scope to its cap before the first call."""
        sched = self.sched
        items = [(int(sched.p_scope[p]), self.proposals[p]) for p in sched.preload.tolist()]
        self.answers.proposal_statuses[schedule.PRELOAD_CALL] = np.asarray(
            self.engine.ingest_proposals(items, sched.now(schedule.PRELOAD_CALL)), np.int32)

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
            with spans.span(record, "drain"):
                answers.drain(self.rx)
            call_range.__exit__(None, None, None)
            c += 1
            if not (c < end and (deadline is None or time.perf_counter() < deadline)):
                return c

    def _gids(self, voters: np.ndarray) -> np.ndarray:
        """The call's voter ids: those the node still holds, and the rest
        interned again (an id is freed when its voter's last session goes)."""
        gids = self.gid_of[voters]
        stale = ~self.engine.pool().gids_live(gids)
        if stale.any():
            ids = self.identities
            for v in np.unique(voters[stale]).tolist():
                self.gid_of[v] = self.engine.voter_gid(ids[v])
            gids = self.gid_of[voters]
        return gids

    def window(self, seconds: float, spans: Spans, profile_calls: int = 0) -> dict:
        """``seconds`` of calls, timed. With ``profile_calls``, that many
        calls run first under the device profiler, outside the timing."""
        first = self.next_call
        self.profile = None
        if profile_calls:
            with DeviceProfile() as prof:
                self.next_call = self._run(first, min(first + profile_calls, self.sched.calls),
                                           None, Spans(profiled=True))
            self.profile = dict(prof.summary(), calls=list(range(first, self.next_call)))
        start = time.perf_counter()
        end = self._run(self.next_call, self.sched.calls, start + seconds, spans)
        elapsed = time.perf_counter() - start
        if end >= self.sched.calls:
            log(f"[window] the schedule ran out at call {end}: the window is {elapsed:.3f} s")
        self.handed = range(first, end)
        return {"seconds": elapsed, "calls": end - self.next_call,
                "rows": sum(r["rows"] for r in spans.calls),
                "ok": sum(r["ok"] for r in spans.calls)}

    def end_to_end(self, result: dict) -> dict:
        return {"votes_per_s": result["ok"] / result["seconds"]}

    def finish(self) -> None:
        self.answers.read_finals(self.engine)
        self.engine = self.rx = None

    def reference(self, quorum_floor: bool = False) -> Reading:
        """The reference over every call the run handed to the node, for the
        sessions of ``self.follow``; other rows stay open (``None``)."""
        sched, ctx = self.sched, self.ctx
        node = ReferenceNode(sched.proposal_table(bool(ctx.config["liveness_criteria_yes"])),
                             sched.modes, float(ctx.config["threshold"]),
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
            # A voter is named by its index: its identity is a function of it.
            got = node.columnar_resolved(
                now, node.lookup(scope_idx[rows], pids[rows]).tolist(),
                voters[rows].tolist(), values[rows].tolist())
            for i, status in zip(rows.tolist(), got):
                statuses[i] = status
            votes[c] = statuses
        return Reading(votes, proposals, node.events, {p: node.result(p) for p in node.live.values()})
