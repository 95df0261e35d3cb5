"""Signed wire votes, verified on the node: ``OP_VOTE_BATCH`` rows in frames.

Every vote is Ed25519-signed in set-up (``portbench.corpus``); a frame is
the encoded rows of one call, end to end. The window loop is the bridge's:
``bridge.columnar.parse_vote_columns``, then
``TorchConsensusEngine.wire_verify_begin``, then
``ingest_wire_columnar(..., _prepass=...)``, closed, with frame k+1's
verification begun before frame k applies. A call's proposals are
delivered through ``ingest_proposals`` between frame k-1's apply and frame
k's. Events are taken off the bus after each apply; a session's first one
is its decision, timed from the start of its frame's ``wire_verify_begin``.

One frame in ``forged_every`` carries ``forged_per_frame`` forged rows:
redeliveries, of sessions the reference follows, whose signature's S is
raised by one (mod L). R and A stay on the curve, so only the batch's
linear combination can refuse them: a device verifier that accepts every
batch passes them (their statuses differ), and one that refuses every
batch blames every frame on the host (the blames differ). No forged row is
sent twice, so the engine's verdict cache never answers one.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import corpus, schedule
from portbench.harness import DeviceProfile, Spans, log, log_calls, warm_profiler
from portbench.node import Answers, engine_for, proposals_of, signer
from portbench.check import Reading
from portbench.reference.engine import OK, ReferenceNode


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx

    # ── set-up ─────────────────────────────────────────────────────────

    def prepare(self) -> None:
        """The inputs alone: the schedule and every frame, signed."""
        ctx = self.ctx
        t0 = time.perf_counter()
        self.sched = schedule.build(ctx.config, ctx.traffic, ctx.seed)
        self.follow = schedule.followed(self.sched, ctx.seed, float(ctx.traffic.get("check_share", 1.0)))
        t1 = time.perf_counter()
        self._sign()
        forged = self._forge()
        log(f"[setup] schedule {t1 - t0:.3f} s, signing {time.perf_counter() - t1:.3f} s "
            f"({int((~self.sched.row_redelivered).sum())} votes, {forged} forged)")

    def setup(self) -> None:
        ctx = self.ctx
        self.prepare()
        t2 = time.perf_counter()
        self.proposals = proposals_of(self.sched, ctx.config)
        self.engine, self.rx = engine_for(ctx.config, ctx.device, signer(ctx.traffic, ctx.signer_class))
        self.scopes = list(range(self.sched.scopes))
        self.answers = Answers(self.sched)
        t3 = time.perf_counter()
        # The ramp: the calls before the steady state, run as the window
        # runs them; they also build and warm every kernel the window uses.
        self._preload()
        ramp = Spans()
        self.next_call = self._run(0, self.sched.ramp_calls, None, ramp, timed=False)
        log_calls("ramp", ramp.calls)
        if ctx.trace:
            warm_profiler()
        log(f"[setup] engine {t3 - t2:.3f} s, ramp {time.perf_counter() - t3:.3f} s "
            f"({self.sched.ramp_calls} calls)")

    def _sign(self) -> None:
        sched = self.sched
        calls = sched.calls
        fresh = ~sched.row_redelivered
        call_of_row = np.repeat(np.arange(calls), np.diff(sched.call_start))
        p_idx, k_idx = sched.row_p[fresh], sched.row_k[fresh]
        sent = np.zeros(len(sched.p_pid), np.int64)
        np.maximum.at(sent, p_idx, k_idx + 1)
        vote_time = np.zeros((len(sched.p_pid), sched.n), np.int64)
        vote_time[p_idx, k_idx] = schedule.T0 + call_of_row[fresh]
        vote_ids = schedule._rng(self.ctx.seed, 3).integers(1, 2**32, vote_time.shape, dtype=np.int64)
        # Tasks by scope, so that a worker derives a scope's keys once.
        by_scope = np.argsort(sched.p_scope, kind="stable")
        tasks, items = [], []
        per_task = max(1, int(sent.sum()) // (corpus.worker_count() * 6) + 1)
        votes = 0
        for p in by_scope.tolist():
            m = int(sent[p])
            if m == 0:
                continue
            items.append((p, int(sched.p_scope[p]), int(sched.p_pid[p]),
                          sched.p_order[p, :m].tolist(), sched.p_value[p, :m].tolist(),
                          vote_ids[p, :m].tolist(), vote_time[p, :m].tolist()))
            votes += m
            if votes >= per_task:
                tasks.append((self.ctx.seed, items))
                items, votes = [], 0
        if items:
            tasks.append((self.ctx.seed, items))
        done = corpus.run_tasks(corpus.sign_task, tasks)
        off = np.zeros((len(sched.p_pid), sched.n), np.int64)
        length = np.zeros((len(sched.p_pid), sched.n), np.int64)
        blobs, base = [], 0
        for ps, blob, lens in done:
            blobs.append(blob)
            starts = base + np.concatenate([[0], np.cumsum(lens)[:-1]])
            at = 0
            for p in ps.tolist():
                m = int(sent[p])
                off[p, :m] = starts[at:at + m]
                length[p, :m] = lens[at:at + m]
                at += m
            base += len(blob)
        data = np.frombuffer(b"".join(blobs), np.uint8)
        # One frame a call: its rows' bytes end to end.
        self.frames = []
        for c in range(calls):
            sl = sched.rows(c)
            p, k = sched.row_p[sl], sched.row_k[sl]
            starts, lens = off[p, k], length[p, k]
            offsets = np.zeros(len(p) + 1, np.int64)
            np.cumsum(lens, out=offsets[1:])
            gather = (np.arange(int(offsets[-1]), dtype=np.int64)
                      - np.repeat(offsets[:-1], lens) + np.repeat(starts, lens))
            self.frames.append((data[gather], offsets, sched.p_scope[p].astype(np.int64)))

    def _forge(self) -> int:
        """Raise S by one in a few redelivered rows of followed sessions, in
        one frame of every ``forged_every``. Returns how many."""
        every = int(self.ctx.traffic.get("forged_every", 0))
        if not every:
            return 0
        per = int(self.ctx.traffic.get("forged_per_frame", 1))
        sched, rng, forged = self.sched, schedule._rng(self.ctx.seed, 5), 0
        for c in range(every - 1, sched.calls, every):
            sl = sched.rows(c)
            rows = np.nonzero(sched.row_redelivered[sl] & self.follow[sched.row_p[sl]])[0]
            data, offsets, _ = self.frames[c]
            for i in rng.choice(rows, min(per, len(rows)), replace=False).tolist():
                end = int(offsets[i + 1])  # the signature's 64 bytes end the row
                s = int.from_bytes(data[end - 32:end].tobytes(), "little")
                data[end - 32:end] = np.frombuffer(((s + 1) % corpus.L).to_bytes(32, "little"), np.uint8)
                forged += 1
        return forged

    # ── the loop ───────────────────────────────────────────────────────

    def _begin(self, c: int, record: dict, spans: Spans):
        from hashgraph_tpu_torch.bridge.columnar import parse_vote_columns

        data, offsets, _ = self.frames[c]
        with spans.span(record, "parse"):
            cols, flags = parse_vote_columns(data, offsets)
        if not flags.all():
            raise RuntimeError("a frame row is not canonical")
        handed = time.perf_counter()
        with spans.span(record, "verify_begin"):
            pre = self.engine.wire_verify_begin(data, cols, offsets)
        return cols, pre, handed

    def _preload(self) -> None:
        """Fill every scope to its cap before the first call."""
        sched = self.sched
        items = [(int(sched.p_scope[p]), self.proposals[p]) for p in sched.preload.tolist()]
        self.answers.proposal_statuses[schedule.PRELOAD_CALL] = np.asarray(
            self.engine.ingest_proposals(items, sched.now(schedule.PRELOAD_CALL)), np.int32)

    def _run(self, first: int, end: int, deadline, spans: Spans, timed: bool) -> int:
        """Calls from ``first`` on, up to ``end`` or, with a ``deadline``,
        the first call begun after it. Returns the call after the last."""
        from hashgraph_tpu_torch.crypto_device.backend import last_phase_seconds
        from hashgraph_tpu_torch.obs import DEVICE_VERIFY_FALLBACKS_TOTAL, registry

        engine, sched, answers = self.engine, self.sched, self.answers
        blamed = registry.counter(DEVICE_VERIFY_FALLBACKS_TOTAL)
        record = spans.new_call(call=first, rows=sched.rows(first).stop - sched.rows(first).start)
        pending = self._begin(first, record, spans)
        c = first
        while True:
            call_range = spans.call()
            call_range.__enter__()
            now = sched.now(c)
            with spans.span(record, "proposals"):
                items = [(int(sched.p_scope[p]), self.proposals[p]) for p in sched.deliveries[c].tolist()]
                answers.proposal_statuses[c] = np.asarray(engine.ingest_proposals(items, now), np.int32)
            more = c + 1 < end and (deadline is None or time.perf_counter() < deadline)
            following = None
            if more:
                nxt = spans.new_call(call=c + 1, rows=sched.rows(c + 1).stop - sched.rows(c + 1).start)
                following = self._begin(c + 1, record, spans)
            cols, pre, handed = pending
            data, offsets, scope_idx = self.frames[c]
            stages: dict = {}
            blames = blamed.value
            with spans.span(record, "apply"):
                statuses = engine.ingest_wire_columnar(
                    self.scopes, scope_idx, cols, data, offsets, now,
                    stage_seconds=stages, _prepass=pre)
            answers.blames[c] = blamed.value - blames
            record["stages"] = stages
            record["phases"] = last_phase_seconds()
            record["ok"] = int((statuses == OK).sum())
            answers.vote_statuses[c] = statuses
            with spans.span(record, "drain"):
                answers.drain(self.rx, handed if timed else None)
            call_range.__exit__(None, None, None)
            if not more:
                return c + 1
            c, pending, record = c + 1, following, nxt

    def window(self, seconds: float, spans: Spans, profile_calls: int = 0) -> dict:
        """``seconds`` of calls, timed. With ``profile_calls``, that many
        calls run first under the device profiler, outside the timing."""
        first = self.next_call
        self.profile = None
        if profile_calls:
            with DeviceProfile() as prof:
                self.next_call = self._run(first, min(first + profile_calls, self.sched.calls),
                                           None, Spans(profiled=True), timed=False)
            self.profile = dict(prof.summary(), calls=list(range(first, self.next_call)))
        start = time.perf_counter()
        end = self._run(self.next_call, self.sched.calls, start + seconds, spans, timed=True)
        elapsed = time.perf_counter() - start
        if end >= self.sched.calls:
            log(f"[window] the corpus ran out at call {end}: the window is {elapsed:.3f} s")
        self.handed = range(first, end)
        return {"seconds": elapsed, "calls": end - self.next_call,
                "rows": sum(r["rows"] for r in spans.calls),
                "ok": sum(r["ok"] for r in spans.calls)}

    def end_to_end(self, result: dict) -> dict:
        from portbench.harness import quantile

        lat = self.answers.latencies_s
        return {
            "verified_votes_per_s": result["ok"] / result["seconds"],
            "decision_p95_ms": quantile(lat, 0.95) * 1e3 if lat else None,
            "decisions": len(lat),
        }

    def finish(self) -> None:
        """Read what the node holds at the end, then let it go."""
        self.answers.read_finals(self.engine)
        self.engine = self.rx = None

    # ── the reference ──────────────────────────────────────────────────

    def reference(self, quorum_floor: bool = False) -> Reading:
        """The reference over every call the run handed to the node, for the
        sessions of ``self.follow``: each of their rows decoded, hashed and
        its signature checked in worker processes, then the rules row by
        row. Other rows stay open (``None``). With device verification, a
        frame's batch is blamed on the host exactly when it holds a row with
        a good hash and a bad signature (every such row is followed)."""
        sched, ctx = self.sched, self.ctx
        calls = range(0, self.handed.stop)
        tasks, where = [], []
        for c in calls:
            data, offsets, _ = self.frames[c]
            rows = np.nonzero(self.follow[sched.row_p[sched.rows(c)]])[0]
            for lo in range(0, len(rows), 4096):
                pick = rows[lo:lo + 4096]
                lens = offsets[pick + 1] - offsets[pick]
                sub = np.zeros(len(pick) + 1, np.int64)
                np.cumsum(lens, out=sub[1:])
                gather = (np.arange(int(sub[-1]), dtype=np.int64)
                          - np.repeat(sub[:-1], lens) + np.repeat(offsets[pick], lens))
                tasks.append((data[gather].tobytes(), sub.tolist()))
                where.append((c, pick))
        read = corpus.run_tasks(corpus.check_task, tasks)
        node = ReferenceNode(sched.proposal_table(bool(ctx.config["liveness_criteria_yes"])),
                             sched.modes, float(ctx.config["threshold"]),
                             int(ctx.config["max_sessions_per_scope"]), quorum_floor=quorum_floor)
        votes, proposals, blames = {}, {}, {}
        proposals[schedule.PRELOAD_CALL] = node.deliver(
            sched.now(schedule.PRELOAD_CALL), sched.preload.tolist())
        parts: "dict[int, list]" = {}
        for (c, pick), got in zip(where, read):
            parts.setdefault(c, []).append((pick, got))
        for c in calls:
            now = sched.now(c)
            proposals[c] = node.deliver(now, sched.deliveries[c].tolist())
            scope_idx = self.frames[c][2]
            rows, at = [], []
            blames[c] = int(any((got["hash_ok"] & ~got["sig_ok"]).any() for _, got in parts.get(c, [])))
            for pick, got in parts.get(c, []):
                owners, hashes = got["owner"].tobytes(), got["hash"].tobytes()
                recv = got["received"].tobytes()
                rlen = got["received_len"].tolist()
                for j, (i, pid, ts, value, h_ok, s_ok) in enumerate(zip(
                        pick.tolist(), got["proposal_id"].tolist(), got["timestamp"].tolist(),
                        got["value"].tolist(), got["hash_ok"].tolist(), got["sig_ok"].tolist())):
                    rows.append({
                        "scope": int(scope_idx[i]), "proposal_id": pid, "timestamp": ts,
                        "value": value, "owner": owners[32 * j:32 * j + 32],
                        "received": recv[32 * j:32 * j + 32] if rlen[j] else b"",
                        "hash": hashes[32 * j:32 * j + 32], "hash_ok": h_ok, "sig_ok": s_ok,
                    })
                    at.append(i)
            statuses: list = [None] * (len(self.frames[c][1]) - 1)
            for i, status in zip(at, node.wire(now, rows)):
                statuses[i] = status
            votes[c] = statuses
        return Reading(votes, proposals, node.events,
                       {p: node.result(p) for p in node.live.values()},
                       blames if ctx.traffic.get("device_verify") else None)
