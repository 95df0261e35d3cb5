"""Crash recovery of the port's write-ahead log.

The cases of ``tests/test_wal_recovery.py`` that need no session tiering,
on ``TorchConsensusEngine(device="cpu")``: a log torn at a random byte
recovers to the engine that saw the surviving prefix of calls (also
through a snapshot and compaction), the two-phase compaction, and a
simulated ``kill -9`` at every crash point of the writer
(``crash_hook``), which must recover to a state the live engine held at
some call boundary. The engines' ``save_to_storage`` snapshots stand in
for the JAX package's state fingerprint (tolerance: exact).

A real crash: a child process logs with ``fsync_policy="always"``, takes
``checkpoint(compact=False)``, keeps the snapshot and watermark in a file,
takes more traffic and ends with ``os._exit`` after its last
acknowledged call. The parent recovers the log with and without the
snapshot to the child's last state, and the JAX package, in a subprocess
(``python tests/test_torch_wal_recovery.py --reference OUT_DIR CHILD_DIR``),
recovers the same log to the same snapshot.

The tier's records: the same subprocess writes a tiered JAX log
(``lifecycle_sweep`` and its garbage collection, ``KIND_LIFECYCLE`` and
``KIND_GC``), which the port recovers to the JAX engine's
``state_fingerprint``; the port replays both kinds from its own logs, and
an engine without the tier's entry points raises ``UnsupportedRecord``
there instead of skipping the records.
"""

import json
import os
import pickle
import random
import subprocess
import sys

import numpy as np
import pytest
from test_torch_wire_columnar import (
    NOW,
    REPO,
    one_torch_thread,
    port_api,
    reference_api,
    reference_run,
    snapshot,
)

SCOPES = ["s0", "s1", "s2"]


def _request(api, rng):
    return api.pkg.CreateProposalRequest(
        name=f"p{rng.randrange(1 << 30)}",
        payload=rng.randbytes(rng.randrange(0, 12)),
        proposal_owner=b"owner",
        expected_voters_count=rng.randint(2, 5),
        expiration_timestamp=rng.randint(5, 60),
        liveness_criteria_yes=rng.random() < 0.5,
    )


def _fresh_engine(api, identity: bytes):
    return api.make_engine(api.pkg.StubConsensusSigner(identity), 32, 8, max_sessions=10)


def _run_workload(api, durable, rng, n_ops, t0=NOW):
    """A random mix of mutators; returns (ops, pids) where ops[k] mirrors
    the k-th record the call sequence logged (a call that raised before
    logging appends no op, as the wrapper appends no record)."""
    pkg = api.pkg
    ops, pids, remote = [], [], {}
    t = t0
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.30 or not pids:
            scope = rng.choice(SCOPES)
            proposal = durable.create_proposal(scope, _request(api, rng), t)
            ops.append(("proposal", scope, proposal.clone(), t))
            pids.append((scope, proposal.proposal_id))
            remote[(scope, proposal.proposal_id)] = []
        elif r < 0.70:
            scope, pid = rng.choice(pids)
            try:
                proposal = durable.get_proposal(scope, pid)
            except pkg.SessionNotFound:
                continue  # evicted by the per-scope cap; reads log nothing
            used = remote[(scope, pid)]
            if used and rng.random() < 0.3:
                signer = rng.choice(used)  # a voter voting again
            else:
                signer = pkg.StubConsensusSigner(rng.randbytes(20))
                used.append(signer)
            vote = pkg.build_vote(proposal, rng.random() < 0.5, signer, t)
            ops.append(("votes", scope, vote.clone(), t, False))
            try:
                durable.process_incoming_vote(scope, vote, t)
            except pkg.ConsensusError:
                pass  # logged before the apply; replay rejects it again
        elif r < 0.85:
            scope, pid = rng.choice(pids)
            try:
                vote = durable.cast_vote(scope, pid, rng.random() < 0.5, t)
            except pkg.ConsensusError:
                continue  # raised before logging: no record, no op
            ops.append(("votes", scope, vote.clone(), t, True))
        elif r < 0.92:
            scope, pid = rng.choice(pids)
            ops.append(("timeout", scope, pid, t))
            try:
                durable.handle_consensus_timeout(scope, pid, t)
            except pkg.ConsensusError:
                pass
        else:
            ops.append(("sweep", t))
            durable.sweep_timeouts(t)
        t += rng.randint(0, 3)
    return ops, pids


def _apply_op(api, engine, op):
    kind = op[0]
    if kind == "proposal":
        _, scope, proposal, now = op
        engine.ingest_proposals([(scope, proposal.clone())], now)
    elif kind == "votes":
        _, scope, vote, now, pre_validated = op
        engine.ingest_votes([(scope, vote.clone())], now, pre_validated=pre_validated)
    elif kind == "timeout":
        _, scope, pid, now = op
        try:
            engine.handle_consensus_timeout(scope, pid, now)
        except api.pkg.ConsensusError:
            pass
    elif kind == "sweep":
        engine.sweep_timeouts(op[1])
    elif kind == "config":
        engine.set_scope_config(op[1], op[2])


def _observable(api, engine, pids):
    """Per-scope stats, and per session its result, round, vote chain
    length, signed votes and tallies."""
    pkg = api.pkg
    out = {}
    for scope in SCOPES:
        st = engine.get_scope_stats(scope)
        out[("stats", scope)] = (st.total_sessions, st.active_sessions,
                                 st.failed_sessions, st.consensus_reached)
    for scope, pid in pids:
        try:
            result = engine.get_consensus_result(scope, pid)
        except pkg.ConsensusFailed:
            result = "failed"
        except pkg.SessionNotFound:
            out[("session", scope, pid)] = "missing"
            continue
        session = engine.export_session(scope, pid)
        out[("session", scope, pid)] = (
            result, session.proposal.round, len(session.proposal.votes),
            tuple(sorted((o.hex(), v.vote) for o, v in session.votes.items())),
            tuple(sorted((o.hex(), val) for o, val in session.tallies.items())),
        )
    return out


def _copy_truncated(api, src: str, dst: str, cut: int) -> None:
    """The first ``cut`` bytes of a WAL directory's segment stream."""
    os.makedirs(dst, exist_ok=True)
    consumed = 0
    for _base, path in api.wal.segment.list_segments(src):
        size = os.path.getsize(path)
        if cut <= consumed:
            break
        with open(path, "rb") as fh:
            data = fh.read(min(size, cut - consumed))
        with open(os.path.join(dst, os.path.basename(path)), "wb") as fh:
            fh.write(data)
        consumed += size


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with one_torch_thread():
        yield


class TestTornTailRecovery:
    @pytest.mark.parametrize("seed", range(6))
    def test_randomized_torn_tail_equivalence(self, tmp_path, seed):
        api = port_api()
        wal = api.wal
        rng = random.Random(0xC0FFEE + seed)
        identity = rng.randbytes(20)
        live = wal.DurableEngine(_fresh_engine(api, identity), tmp_path / "wal",
                                 fsync_policy="off", segment_bytes=1024)
        config = api.pkg.ScopeConfig(network_type=api.pkg.NetworkType.P2P)
        live.set_scope_config("s1", config)
        ops = [("config", "s1", config)]
        more, pids = _run_workload(api, live, rng, n_ops=30)
        ops.extend(more)
        live.close()
        src = str(tmp_path / "wal")
        total = sum(os.path.getsize(p) for _, p in wal.segment.list_segments(src))
        assert len(wal.scan(src).records) == len(ops)  # one record a call
        cut = rng.randrange(0, total + 1)
        dst = str(tmp_path / "cut")
        _copy_truncated(api, src, dst, cut)
        surviving = wal.scan(dst)
        k = len(surviving.records)
        assert [lsn for lsn, _, _ in surviving.records] == list(range(1, k + 1))
        recovered = _fresh_engine(api, identity)
        stats = wal.replay(dst, recovered)
        assert stats.errors == [] and stats.records_applied == k
        mirror = _fresh_engine(api, identity)
        for op in ops[:k]:
            _apply_op(api, mirror, op)
        assert _observable(api, recovered, pids) == _observable(api, mirror, pids)
        # Continued behavior: every recorded vote gets the same status.
        items = [(op[1], op[2]) for op in ops if op[0] == "votes"]
        if items:
            got = [e.ingest_votes([(s, v.clone()) for s, v in items], NOW + 1000)
                   for e in (recovered, mirror)]
            assert np.array_equal(*got)


class TestSnapshotCompactionRecovery:
    @pytest.mark.parametrize("seed", range(3))
    def test_torn_tail_after_checkpoint(self, tmp_path, seed):
        api = port_api()
        wal = api.wal
        rng = random.Random(0xBEEF + seed)
        identity = rng.randbytes(20)
        live = wal.DurableEngine(_fresh_engine(api, identity), tmp_path / "wal",
                                 fsync_policy="off", segment_bytes=512)
        ops, pids = _run_workload(api, live, rng, n_ops=20)
        src = str(tmp_path / "wal")
        assert len(wal.segment.list_segments(src)) > 1
        storage = api.pkg.InMemoryConsensusStorage()
        live.checkpoint(storage)
        ops.append(("mark",))
        assert len(wal.segment.list_segments(src)) == 1
        assert wal.scan(src).watermark == len(ops) - 1
        more, more_pids = _run_workload(api, live, rng, n_ops=15, t0=NOW + 100)
        ops.extend(more)
        pids = pids + [p for p in more_pids if p not in pids]
        live.close()
        total = sum(os.path.getsize(p) for _, p in wal.segment.list_segments(src))
        dst = str(tmp_path / "cut")
        _copy_truncated(api, src, dst, rng.randrange(0, total + 1))
        recovered = wal.DurableEngine(_fresh_engine(api, identity), dst, fsync_policy="off")
        recovered.recover(storage)
        surviving = wal.scan(dst)
        mirror = _fresh_engine(api, identity)
        mirror.load_from_storage(storage)
        for lsn, _, _ in surviving.records:
            if lsn > surviving.watermark:
                _apply_op(api, mirror, ops[lsn - 1])
        assert _observable(api, recovered.engine, pids) == _observable(api, mirror, pids)
        recovered.checkpoint(api.pkg.InMemoryConsensusStorage())
        assert len(wal.segment.list_segments(dst)) == 1
        recovered.close()


class TestTwoPhaseCompaction:
    def test_compact_requires_a_checkpoint(self, tmp_path):
        api = port_api()
        durable = api.wal.DurableEngine(_fresh_engine(api, b"cmp"), str(tmp_path),
                                        fsync_policy="off")
        durable.create_proposal("s0", _request(api, random.Random(1)), NOW)
        with pytest.raises(ValueError, match="no checkpoint"):
            durable.compact()
        durable.close()

    def test_compact_drops_exactly_the_covered_segments(self, tmp_path):
        api = port_api()
        list_segments = api.wal.segment.list_segments
        durable = api.wal.DurableEngine(_fresh_engine(api, b"cmp"), str(tmp_path),
                                        fsync_policy="off")
        _run_workload(api, durable, random.Random(7), 20)
        durable.checkpoint(api.pkg.InMemoryConsensusStorage(), compact=False)
        assert len(list_segments(str(tmp_path))) == 2
        assert durable.compact() == 1
        assert len(list_segments(str(tmp_path))) == 1
        assert durable.compact() == 0
        durable.close()

    def test_crash_between_phases_replays_to_parity(self, tmp_path):
        api = port_api()
        rng = random.Random(11)
        identity = b"two-phase-crash-node"
        durable = api.wal.DurableEngine(_fresh_engine(api, identity), str(tmp_path / "a"),
                                        fsync_policy="off")
        ops, pids = _run_workload(api, durable, rng, 24)
        storage = api.pkg.InMemoryConsensusStorage()
        durable.checkpoint(storage, compact=False)
        watermark = durable.last_checkpoint_watermark
        more, more_pids = _run_workload(api, durable, rng, 8, t0=NOW + 100)
        pids += [p for p in more_pids if p not in pids]
        durable.close()  # the crash, before compact()
        for after_lsn in (watermark, max(0, watermark - 3)):
            recovered = api.wal.DurableEngine(_fresh_engine(api, identity),
                                              str(tmp_path / "a"), fsync_policy="off")
            assert not recovered.recover(storage, after_lsn=after_lsn).errors
            mirror = _fresh_engine(api, identity)
            for op in ops + more:
                _apply_op(api, mirror, op)
            assert _observable(api, recovered.engine, pids) == _observable(api, mirror, pids)
            recovered.close()


def _fingerprint(api, engine):
    return json.dumps(snapshot(api, engine))


def _crash_trial(api, root, point, occurrence, torn_bytes, seed=0xD1E):
    """Run a workload until the writer's ``point`` fires for the
    ``occurrence``-th time and crashes; recover into a fresh engine.
    Returns the recovered fingerprint, or None if the point never fired."""
    rng = random.Random(seed + occurrence)
    identity = b"crash-matrix-node\x00\x00\x00"
    fired = [0]

    def hook(p):
        if p == point:
            fired[0] += 1
            if fired[0] == occurrence:
                raise api.wal.SimulatedCrash(p, torn_bytes=torn_bytes)

    live = api.wal.DurableEngine(_fresh_engine(api, identity), root,
                                 fsync_policy="always", segment_bytes=600, crash_hook=hook)
    candidates = [_fingerprint(api, live.engine)]
    try:
        for _ in range(40):
            _run_workload(api, live, rng, n_ops=1)
            candidates.append(_fingerprint(api, live.engine))
    except api.wal.SimulatedCrash:
        # A locally minted call can crash between its apply and its
        # append: that half-call state is a legal landing too.
        candidates.append(_fingerprint(api, live.engine))
    else:
        live.close()
        return None
    recovered = api.wal.DurableEngine(_fresh_engine(api, identity), root, fsync_policy="off")
    stats = recovered.recover()
    assert stats.errors == [], f"{point}@{occurrence}"
    fingerprint = _fingerprint(api, recovered.engine)
    assert fingerprint in candidates, (
        f"crash at {point}@{occurrence} torn={torn_bytes}: the recovered state is "
        "no call-boundary state of the live engine")
    recovered.close()
    return fingerprint


class TestCrashPointMatrix:
    @pytest.mark.parametrize("point", ["append", "append.flushed", "fsync", "fsync.done",
                                       "rotate", "rotate.done"])
    def test_every_crash_point_recovers_to_a_prefix(self, tmp_path, point):
        api = port_api()
        assert point in api.wal.CRASH_POINTS
        ran = 0
        for occurrence in (1, 3):
            for torn in (0, 9) if point == "append" else (0,):
                root = tmp_path / f"{occurrence}-{torn}"
                if _crash_trial(api, str(root), point, occurrence, torn) is not None:
                    ran += 1
        assert ran >= 1  # the point fired

    def test_torn_append_leaves_a_detectable_tail(self, tmp_path):
        api = port_api()

        def hook(p):
            if p == "append":
                hook.count += 1
                if hook.count == 4:
                    raise api.wal.SimulatedCrash(p, torn_bytes=11)

        hook.count = 0
        identity = b"torn-tail-node\x00\x00\x00\x00\x00\x00"
        live = api.wal.DurableEngine(_fresh_engine(api, identity), str(tmp_path),
                                     fsync_policy="off", crash_hook=hook)
        rng = random.Random(5)
        with pytest.raises(api.wal.SimulatedCrash):
            for _ in range(10):
                _run_workload(api, live, rng, n_ops=1)
        surviving = api.wal.scan(str(tmp_path))
        assert surviving.torn and surviving.torn_bytes == 11
        from hashgraph_tpu_torch.tracing import Tracer

        tr = Tracer(enabled=True)
        recovered = api.wal.DurableEngine(
            _fresh_engine(api, identity),
            api.wal.WalWriter(str(tmp_path), fsync_policy="off", tracer=tr),
        )
        assert recovered.recover().records_applied == len(surviving.records)
        assert tr.counters()["wal.repair.truncated_bytes"] == 11
        recovered.close()


# ── The tier's record kinds ───────────────────────────────────────────


@pytest.mark.parametrize("kind", ["lifecycle", "gc"])
def test_recovery_raises_on_tier_records(tmp_path, kind):
    """On an engine without ``lifecycle_sweep`` and ``gc_sessions``, a
    ``KIND_LIFECYCLE`` or ``KIND_GC`` record stops recovery with
    ``UnsupportedRecord``; the records before it were applied, none after
    it was skipped to."""
    api = port_api()
    F = api.wal.format
    durable = api.wal.DurableEngine(_fresh_engine(api, b"me"), str(tmp_path),
                                    fsync_policy="off")
    durable.create_proposal("s0", _request(api, random.Random(3)), NOW)
    if kind == "lifecycle":
        durable.wal.append(F.KIND_LIFECYCLE, F.encode_lifecycle(NOW + 1))
    else:
        durable.wal.append(F.KIND_GC, F.encode_gc([("s0", 5)]))
    durable.create_proposal("s1", _request(api, random.Random(4)), NOW + 2)
    durable.close()
    fresh = _fresh_engine(api, b"me")
    fresh.lifecycle_sweep = fresh.gc_sessions = None  # an engine without the tier
    recovering = api.wal.DurableEngine(fresh, str(tmp_path), fsync_policy="off")
    with pytest.raises(api.wal.UnsupportedRecord, match=F.KIND_NAMES[getattr(
            F, f"KIND_{kind.upper()}")]):
        recovering.recover()
    recovering.close()
    assert fresh.get_scope_stats("s0").total_sessions == 1
    assert fresh.get_scope_stats("s1").total_sessions == 0
    # Replay mode is lifted even though recovery raised.
    assert fresh._lifecycle_live


@pytest.mark.parametrize("kind", ["lifecycle", "gc"])
def test_recovery_replays_tier_records(tmp_path, kind):
    """The port engine replays the tier's records: a standalone
    ``lifecycle_sweep`` (``KIND_LIFECYCLE`` then ``KIND_GC``) or a
    ``sweep_timeouts`` whose lifecycle half collected sessions (``KIND_SWEEP``
    then ``KIND_GC``) recovers to the live engine's fingerprint, with the
    collected sessions gone and the demoted ones back."""
    api = port_api()
    F = api.wal.format
    from hashgraph_tpu_torch.sync import state_fingerprint as fingerprint
    rng = random.Random(5)
    durable = api.wal.DurableEngine(_fresh_engine(api, b"me"), str(tmp_path),
                                    fsync_policy="off")
    durable.scope("s0").with_demote_after(20.0).with_evict_decided_after(5.0).initialize()
    pids = []
    for k in range(4):
        request = _request(api, rng)
        request.expiration_timestamp = 200
        pids.append(durable.create_proposal("s0", request, NOW + k).proposal_id)
    for pid in pids[:2]:
        voters = durable.get_proposal("s0", pid).expected_voters_count
        for v in range(voters):
            proposal = durable.get_proposal("s0", pid)
            vote = api.pkg.build_vote(proposal, True, api.pkg.StubConsensusSigner(bytes([v]) * 20),
                                      NOW + 5)
            durable.process_incoming_vote("s0", vote, NOW + 5)
    sweep = durable.lifecycle_sweep if kind == "lifecycle" else durable.sweep_timeouts
    sweep(NOW + 30)
    kinds = [k for _, k, _ in api.wal.scan(str(tmp_path)).records]
    want = F.KIND_LIFECYCLE if kind == "lifecycle" else F.KIND_SWEEP
    assert kinds[-2:] == [want, F.KIND_GC]
    occ = durable.occupancy()
    assert occ["tier_gc_total"] == 2 and occ["tier_sessions"] == 2  # the idle actives
    live = fingerprint(durable)
    durable.close()
    fresh = _fresh_engine(api, b"me")
    recovering = api.wal.DurableEngine(fresh, str(tmp_path), fsync_policy="off")
    stats = recovering.recover()
    recovering.close()
    assert stats.records_applied == len(kinds) and stats.errors == []
    assert fingerprint(fresh) == live
    assert sorted(p for _, p in fresh.session_keys()) == sorted(pids[2:])
    assert fresh._lifecycle_live


# ── A real crash, and the JAX package's logs ─────────────────────────

CHILD = r"""
import json, os, pickle, random, sys
sys.path[:0] = [{repo!r}, {tests!r}]
import torch
torch.set_num_threads(1)
import test_torch_wal_recovery as T
from test_torch_wire_columnar import port_api, snapshot
api = port_api()
root = sys.argv[1]
rng = random.Random(21)
durable = api.wal.DurableEngine(T._fresh_engine(api, b"child"), os.path.join(root, "wal"),
                                fsync_policy="always", segment_bytes=2048)
T._run_workload(api, durable, rng, 30)
storage = api.pkg.InMemoryConsensusStorage()
durable.checkpoint(storage, compact=False)
with open(os.path.join(root, "snapshot.pickle"), "wb") as fh:
    pickle.dump((T.storage_contents(storage), durable.last_checkpoint_watermark), fh)
    fh.flush()
    os.fsync(fh.fileno())
T._run_workload(api, durable, rng, 20, t0=T.NOW + 100)
with open(os.path.join(root, "live.json"), "w") as fh:
    json.dump(snapshot(api, durable.engine), fh)
os._exit(CRASHED)  # no close, no compact: the crash
""".replace("CRASHED", "41")


def storage_contents(storage):
    """A storage's scopes, configs and sessions, as plain picklable data."""
    return [(scope, storage.get_scope_config(scope), storage.list_scope_sessions(scope))
            for scope in storage.list_scopes() or []]


def storage_from(api, contents):
    storage = api.pkg.InMemoryConsensusStorage()
    for scope, config, sessions in contents:
        if config is not None:
            storage.set_scope_config(scope, config)
        for session in sessions or []:
            storage.save_session(scope, session)
    return storage


def run_child(root):
    script = CHILD.format(repo=str(REPO), tests=str(REPO / "tests"))
    proc = subprocess.run([sys.executable, "-c", script, str(root)], capture_output=True,
                          text=True, timeout=300, cwd=str(REPO))
    assert proc.returncode == 41, proc.stderr[-4000:]


def reference_logs(out_dir, child_dir):
    """In the JAX package: a tiered log (its lifecycle sweep collects a
    decided session, KIND_LIFECYCLE then KIND_GC), and the child's log
    recovered to a snapshot."""
    api = reference_api()
    pkg = api.pkg
    tiered = os.path.join(out_dir, "tiered")
    engine = api.make_engine(pkg.StubConsensusSigner(b"ref"), 8, 8)
    durable = api.wal.DurableEngine(engine, tiered, fsync_policy="off")
    durable.scope("t").with_evict_decided_after(5.0).initialize()
    p = durable.create_proposal("t", pkg.CreateProposalRequest(
        name="t", payload=b"", proposal_owner=b"o", expected_voters_count=1,
        expiration_timestamp=100, liveness_criteria_yes=True), NOW)
    durable.cast_vote("t", p.proposal_id, True, NOW + 1)
    q = durable.create_proposal("t", pkg.CreateProposalRequest(
        name="u", payload=b"", proposal_owner=b"o", expected_voters_count=3,
        expiration_timestamp=100, liveness_criteria_yes=True), NOW + 2)
    durable.engine.demote_session("t", q.proposal_id)
    durable.cast_vote("t", q.proposal_id, True, NOW + 3)  # pages it back in
    durable.lifecycle_sweep(NOW + 50)
    from hashgraph_tpu.sync import state_fingerprint

    live_fingerprint = state_fingerprint(durable)
    durable.close()
    kinds = [kind for _, kind, _ in api.wal.scan(tiered).records]
    fresh = api.make_engine(pkg.StubConsensusSigner(b"child"), 32, 8, max_sessions=10)
    recovering = api.wal.DurableEngine(fresh, os.path.join(child_dir, "wal"),
                                       fsync_policy="off")
    stats = recovering.recover()
    recovering.close()
    return {"tiered_kinds": kinds, "tiered_fingerprint": live_fingerprint,
            "child": [snapshot(api, fresh), stats.errors]}


@pytest.fixture(scope="module")
def crashed(tmp_path_factory):
    root = tmp_path_factory.mktemp("crash")
    run_child(root)
    out = tmp_path_factory.mktemp("reference")
    reference = reference_run(__file__, out, root)
    return root, out, reference


def test_child_crash_recovers_to_last_acknowledged_state(crashed):
    """Recovery from snapshot + tail (at the persisted watermark, and
    over-replaying from before it) and from the whole log all land on the
    child's state after its last acknowledged call."""
    root, _, _ = crashed
    api = port_api()
    live = json.loads((root / "live.json").read_text())
    with open(root / "snapshot.pickle", "rb") as fh:
        contents, watermark = pickle.load(fh)
    storage = storage_from(api, contents)
    results = []
    for source, after in ((storage, watermark), (storage, max(0, watermark - 5)),
                          (None, None)):
        fresh = _fresh_engine(api, b"child")
        durable = api.wal.DurableEngine(fresh, str(root / "wal"), fsync_policy="off")
        stats = durable.recover(source, after_lsn=after)
        durable.close()
        assert stats.errors == [] and not stats.torn
        results.append(json.loads(json.dumps(snapshot(api, fresh))))
    assert results == [live, live, live]
    assert live[0] > 10  # sessions that outlived the crash


def test_reference_recovers_the_child_log(crashed):
    root, _, reference = crashed
    snap, errors = reference["child"]
    assert errors == []
    assert snap == json.loads((root / "live.json").read_text())


def test_port_refuses_the_reference_tiered_log(crashed):
    """The JAX package's tier log (a demoted session paged in by a vote, a
    lifecycle sweep that collects the decided one: KIND_LIFECYCLE and
    KIND_GC) recovers on the port to the JAX engine's fingerprint."""
    _, out, reference = crashed
    api = port_api()
    F = api.wal.format
    kinds = reference["tiered_kinds"]
    assert F.KIND_LIFECYCLE in kinds and F.KIND_GC in kinds
    fresh = api.make_engine(api.pkg.StubConsensusSigner(b"ref"), 8, 8)
    recovering = api.wal.DurableEngine(fresh, str(out / "tiered"), fsync_policy="off")
    stats = recovering.recover()
    recovering.close()
    assert stats.records_applied == len(kinds) and stats.errors == []
    from hashgraph_tpu_torch.sync import state_fingerprint

    assert state_fingerprint(fresh) == reference["tiered_fingerprint"]
    assert fresh.get_scope_stats("t").total_sessions == 1  # the collected one is gone


if __name__ == "__main__" and sys.argv[1] == "--reference":
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(reference_logs(sys.argv[2], sys.argv[3])))
