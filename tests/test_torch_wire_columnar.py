"""Parity: the port's validated wire path and multi-scope entry points
against the JAX package's, and against the port's own object path.

``ingest_wire_columnar`` (inline and with ``wire_verify_begin`` started
early, as a bridge's reader thread starts it), ``ingest_columnar_multi``
with ``wire_votes`` and ``create_proposals_multi`` take seeded traces of
StubConsensusSigner-signed votes encoded as wire bytes and parsed with
``bridge.columnar.parse_vote_columns``: bad hashes and signatures, dangling
links, votes before creation and after expiry, expired proposals, replays,
unknown proposals, four scopes (one an int) and sessions served on the host
(wider than ``voter_capacity``, and past the pool's last free slot). The
JAX engine runs the same traces in a subprocess (``python
tests/test_torch_wire_columnar.py --reference``), so this process leaves
the JAX package's process-wide registries as it found them. Proposal and
vote ids come from seeded entropy on both sides (``protocol.set_id_entropy``
and ``os.urandom`` for the batch id draw), so both engines see the same
bytes. Statuses, events (in emission order), results, scope stats, the
exported proposals' vote chains and every pool array must be equal
(tolerance: exact).

The port's wire path is also held against its own ``ingest_votes(
pre_validated=False)`` over the same decoded rows (the JAX package's own
oracle for this path): statuses, results, stats and vote chains equal,
events equal session by session (the columnar paths order events per
session, not across sessions).

The helpers here (both packages' API, seeded ids, snapshots, the pool's
state as JSON) are shared with ``test_torch_checkpoint``, ``test_torch_wal``
and ``test_torch_wal_recovery``.
"""

import contextlib
import hashlib
import json
import os
import random
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

NOW = 1_700_000_000
REPO = Path(__file__).resolve().parent.parent


# ── Both packages' surface ────────────────────────────────────────────


def port_api():
    import hashgraph_tpu_torch as pkg
    from hashgraph_tpu_torch import protocol, wal
    from hashgraph_tpu_torch.bridge import columnar
    from hashgraph_tpu_torch.convert import DEVICE_ARRAYS, HOST_FIELDS
    from hashgraph_tpu_torch.errors import StatusCode
    from hashgraph_tpu_torch.events import BroadcastEventBus

    def make_engine(signer, capacity, voter_capacity, max_sessions=10_000,
                    verify_cache="default"):
        return pkg.TorchConsensusEngine(
            signer, capacity, voter_capacity,
            event_bus=BroadcastEventBus(max_queued_events=1_000_000),
            max_sessions_per_scope=max_sessions, device="cpu",
            verify_cache=verify_cache,
        )

    def pool_arrays(pool):
        arrays = {name: getattr(pool, attr).cpu().numpy()
                  for name, (attr, _) in DEVICE_ARRAYS.items()}
        host = {name: getattr(pool, attr) for name, attr in HOST_FIELDS.items()}
        return arrays, host, pool._meta

    return SimpleNamespace(pkg=pkg, protocol=protocol, wal=wal, C=columnar,
                           StatusCode=StatusCode, make_engine=make_engine,
                           pool_arrays=pool_arrays, name="port")


def reference_api():
    import hashgraph_tpu as pkg
    from hashgraph_tpu import protocol, wal
    from hashgraph_tpu.bridge import columnar
    from hashgraph_tpu.engine import TpuConsensusEngine
    from hashgraph_tpu.errors import StatusCode
    from hashgraph_tpu.events import BroadcastEventBus
    from hashgraph_tpu.obs.health import HealthMonitor
    from hashgraph_tpu_torch.convert import DEVICE_ARRAYS, HOST_FIELDS

    def make_engine(signer, capacity, voter_capacity, max_sessions=10_000,
                    verify_cache="default"):
        return TpuConsensusEngine(
            signer,
            event_bus=BroadcastEventBus(max_queued_events=1_000_000),
            capacity=capacity, voter_capacity=voter_capacity,
            max_sessions_per_scope=max_sessions, verify_cache=verify_cache,
            health_monitor=HealthMonitor(),
        )

    def pool_arrays(pool):
        arrays = {name: np.asarray(getattr(pool, attr))
                  for name, (attr, _) in DEVICE_ARRAYS.items()}
        host = {name: getattr(pool, attr) for name, attr in HOST_FIELDS.items()}
        return arrays, host, pool._meta

    return SimpleNamespace(pkg=pkg, protocol=protocol, wal=wal, C=columnar,
                           StatusCode=StatusCode, make_engine=make_engine,
                           pool_arrays=pool_arrays, name="reference")


def canon(value):
    """``value`` as plain JSON: bytes as hex, arrays as int lists, dicts
    as sorted [key, value] pairs."""
    if isinstance(value, (bytes, bytearray)):
        return bytes(value).hex()
    if isinstance(value, np.ndarray):
        return value.astype(np.int64).tolist()
    if isinstance(value, (np.integer, np.bool_)):
        return int(value)
    if isinstance(value, dict):
        return sorted([canon(k), canon(v)] for k, v in value.items())
    if isinstance(value, (list, tuple, set, frozenset)):
        items = [canon(v) for v in value]
        return sorted(items) if isinstance(value, (set, frozenset)) else items
    if hasattr(value, "expiry") and hasattr(value, "created_at"):  # SlotMeta
        return [canon(value.key), int(value.expiry), int(value.created_at)]
    return value


def pool_state(api, engine):
    """Every device array and host mirror of the engine's pool, as JSON."""
    arrays, host, meta = api.pool_arrays(engine.pool())
    return canon({"arrays": arrays, "host": host, "meta": meta})


@contextlib.contextmanager
def seeded(api, seed):
    """Seeded vote/proposal ids (``generate_id``) and batch id draws
    (``os.urandom``), so both packages mint the same bytes."""
    ids = random.Random(seed)
    draws = random.Random(seed + 1_000_003)
    saved = os.urandom
    api.protocol.set_id_entropy(lambda: ids.getrandbits(128))
    os.urandom = draws.randbytes
    try:
        yield
    finally:
        os.urandom = saved
        api.protocol.set_id_entropy(None)


class Recorder:
    """Creation indices of proposals (keyed per scope) and the events
    drained from the engine's bus."""

    def __init__(self, engine):
        self.rx = engine.event_bus().subscribe()
        self.index = {}  # (scope, pid) -> creation index
        self.keys = []  # (scope, pid) in creation order

    def created(self, scope, proposals):
        for p in proposals:
            self.index[(scope, p.proposal_id)] = len(self.keys)
            self.keys.append((scope, p.proposal_id))

    def events(self):
        out = []
        while (item := self.rx.try_recv()) is not None:
            scope, ev = item
            out.append([type(ev).__name__, self.index.get((scope, ev.proposal_id), -1),
                        getattr(ev, "result", None), ev.timestamp])
        return out


def call(fn, *args, **kwargs):
    """Result of a call, or the name of the exception it raised."""
    try:
        out = fn(*args, **kwargs)
    except Exception as exc:  # the exception type is the result compared
        return ["raised", type(exc).__name__]
    if isinstance(out, np.ndarray):
        return out.tolist()
    if isinstance(out, list) and out and all(isinstance(x, np.ndarray) for x in out):
        return [x.tolist() for x in out]
    if hasattr(out, "vote_hash") or hasattr(out, "expected_voters_count"):
        return out.encode().hex()  # a Vote or a Proposal: its wire bytes
    return out


def proposal_of(engine, scope, pid):
    """The session's exported proposal, or the name of what was raised."""
    try:
        return engine.get_proposal(scope, pid)
    except Exception as exc:  # the exception type is the result compared
        return ["raised", type(exc).__name__]


def session_view(api, engine, rec):
    """Per created session: result, round, and the exported chain's vote
    hashes; per scope: stats."""
    out = []
    for scope, pid in rec.keys:
        prop = proposal_of(engine, scope, pid)
        if isinstance(prop, list):
            out.append(prop)
            continue
        out.append([call(engine.get_consensus_result, scope, pid), prop.round,
                    [v.vote_hash.hex() for v in prop.votes]])
    stats = []
    for scope in sorted({s for s, _ in rec.keys}, key=repr):
        st = engine.get_scope_stats(scope)
        stats.append([st.total_sessions, st.active_sessions, st.failed_sessions,
                      st.consensus_reached])
    occ = engine.occupancy()
    return [out, stats, [occ["live_sessions"], occ["device_slots_used"], occ["host_spilled"]]]


def snapshot(api, engine):
    """``save_to_storage`` into a fresh InMemoryConsensusStorage, as JSON:
    per scope its config's WAL encoding and every session's proposal
    bytes, state, signed votes, tallies, created_at and config."""
    storage = api.pkg.InMemoryConsensusStorage()
    count = engine.save_to_storage(storage)
    F = api.wal.format
    out = {}
    for scope in sorted(storage.list_scopes() or [], key=repr):
        config = storage.get_scope_config(scope)
        sessions = []
        for s in storage.list_scope_sessions(scope) or []:
            sessions.append([
                s.proposal.encode().hex(),
                [s.state.is_active, s.state.is_reached, s.state.is_failed,
                 s.state.result if s.state.is_reached else None],
                sorted([k.hex(), v.encode().hex()] for k, v in s.votes.items()),
                sorted([k.hex(), bool(v)] for k, v in s.tallies.items()),
                s.created_at,
                F.encode_consensus_config(s.config).hex(),
            ])
        out[F.encode_scope(scope).hex()] = [
            F.encode_scope_config(config).hex() if config is not None else None,
            sorted(sessions),
        ]
    return [count, out]


def pack(rows):
    """Encoded votes as one frame: (uint8 data, int64 offsets)."""
    offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offsets[1:])
    return np.frombuffer(b"".join(rows), np.uint8), offsets


def parse(api, rows):
    """A frame parsed into columns, with the native parser (the port's
    runtime, and the JAX package's, both build here)."""
    data, offsets = pack(rows)
    cols, flags = api.C.parse_vote_columns(data, offsets)
    assert flags.all()
    return data, offsets, cols


def resign(api, vote, signer):
    vote.vote_hash = api.pkg.compute_vote_hash(vote)
    vote.signature = signer.sign(vote.signing_payload())
    return vote


def request(api, i, n, expiry=100, live=True):
    return api.pkg.CreateProposalRequest(
        name=f"p{i}", payload=bytes([i % 251]), proposal_owner=b"owner",
        expected_voters_count=n, expiration_timestamp=expiry,
        liveness_criteria_yes=live,
    )


# ── The traces ────────────────────────────────────────────────────────

SCOPES = ["gs", "p2p", 7, "wide"]


def make_votes(api, engine, rec, rng, signers, now, count, old_rows, distinct=False,
               scopes=None):
    """``count`` wire rows across the recorded sessions: chained onto this
    frame's shadow of each session (so a frame holds chained runs), with
    damage drawn per row. ``distinct`` keeps each signer to one new vote a
    session a frame. Returns (rows, index into ``scopes`` per row)."""
    pkg = api.pkg
    scopes = SCOPES if scopes is None else scopes
    shadow = {}
    used = set()
    rows, sidx = [], []
    for _ in range(count):
        k = int(rng.integers(0, len(rec.keys)))
        scope, pid = rec.keys[k]
        if k not in shadow:
            prop = proposal_of(engine, scope, pid)
            if isinstance(prop, list):  # evicted or deleted
                continue
            shadow[k] = prop
        prop = shadow[k]
        signer = signers[int(rng.integers(0, len(signers)))]
        action = rng.random()
        if distinct:
            if (k, signer.identity()) in used:
                continue
            used.add((k, signer.identity()))
        ts = now
        if action < 0.03:
            ts = NOW - 50  # before the proposal's creation
        elif action < 0.06:
            ts = NOW + 500  # after its expiry
        vote = pkg.build_vote(prop, bool(rng.random() < 0.6), signer, ts)
        if action < 0.06:
            pass  # out of the session's time window, otherwise valid
        elif action < 0.1:
            vote.signature = bytes(32)  # bad signature
        elif action < 0.14:
            vote.vote_hash = bytes(reversed(vote.vote_hash))  # bad hash
        elif action < 0.18:
            vote.received_hash = b"\x01" * 32  # dangling link, validly signed
            resign(api, vote, signer)
        elif action < 0.2:
            vote.proposal_id = 4_000_000_001  # unknown session
            resign(api, vote, signer)
        elif action < 0.25 and old_rows:
            rows.append(old_rows[int(rng.integers(0, len(old_rows)))][0])
            sidx.append(scopes.index(scope))
            continue  # a replayed earlier row
        elif action >= 0.25:
            prop.votes.append(vote)  # the frame's next vote chains onto it
        rows.append(vote.encode())
        sidx.append(scopes.index(scope))
    return rows, sidx


def scenario_wire(api, seed, oracle=False, distinct=False):
    """Four scopes through create_proposals_multi (oversized and
    pool-overflowing proposals spill to the host), six wire frames
    (alternately with the prepass started before the call), multi-scope
    columnar ingest with wire_votes, scalar votes and a watermark
    extension on wire-fed sessions, more creation mid-run, and a sweep.
    ``oracle`` replaces every wire call with ``ingest_votes`` over the
    decoded rows; ``distinct`` gives a signer at most one new vote a
    session a frame."""
    rng = np.random.default_rng(seed)
    pkg = api.pkg
    log = []
    with seeded(api, seed):
        engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 24, 8)
        rec = Recorder(engine)
        engine.scope("p2p").p2p_preset().initialize()
        made = engine.create_proposals_multi([
            (s, [request(api, i, 16 if s == "wide" else int(rng.integers(2, 9)),
                         expiry=3 if i == 0 else 100, live=bool(i % 2))
                 for i in range(7 if s != "wide" else 2)])
            for s in SCOPES
        ], NOW)
        for s, props in zip(SCOPES, made):
            rec.created(s, props)
        log.append(session_view(api, engine, rec))
        signers = [pkg.StubConsensusSigner(bytes([1 + i])) for i in range(10)]
        old_rows = []
        gids = {}
        for wave in range(6):
            now = NOW + 1 + 2 * wave
            rows, sidx = make_votes(api, engine, rec, rng, signers, now, 36, old_rows,
                                    distinct)
            max_depth = int(rng.choice([2, 8]))
            if oracle:
                items = [(SCOPES[i], pkg.Vote.decode(r)) for r, i in zip(rows, sidx)]
                st = call(engine.ingest_votes, items, now)
            else:
                data, offsets, cols = parse(api, rows)
                if wave % 2:
                    early = engine.wire_verify_begin(data, cols, offsets)
                    st = call(engine.ingest_wire_columnar, SCOPES, np.array(sidx), cols,
                              data, offsets, now, _prepass=early)
                else:
                    st = call(engine.ingest_wire_columnar, SCOPES, np.array(sidx), cols,
                              data, offsets, now, max_depth=max_depth)
            log.append(st)
            old_rows.extend((r, i) for r, i, c in zip(rows, sidx, st) if c == 0)
            log.append(rec.events())
            if wave == 1:
                # Scalar votes onto wire-fed sessions (the wire guard then
                # rebuilds its continuity from the merged chain).
                for k in (1, 8, 15):
                    scope, pid = rec.keys[k]
                    log.append(call(engine.cast_vote, scope, pid, True, now))
                    prop = engine.get_proposal(scope, pid)
                    vote = pkg.build_vote(prop, False, signers[9], now)
                    log.append(call(engine.process_incoming_vote, scope, vote, now))
                log.append(rec.events())
            if wave == 2:
                # Pre-validated multi-scope columnar ingest with the rows'
                # bytes retained, onto fresh proposals made in one call.
                more = engine.create_proposals_multi(
                    [(s, [request(api, 40 + i, 6) for i in range(2)]) for s in SCOPES[:3]],
                    now)
                for s, props in zip(SCOPES[:3], more):
                    rec.created(s, props)
                rows_m, sidx_m, pids_m, gid_m, vals_m = [], [], [], [], []
                for k in range(len(rec.keys) - 6, len(rec.keys)):
                    scope, pid = rec.keys[k]
                    prop = engine.get_proposal(scope, pid)
                    for j in range(4):
                        signer = signers[j]
                        vote = pkg.build_vote(prop, j % 3 != 0, signer, now)
                        prop.votes.append(vote)
                        rows_m.append(vote.encode())
                        sidx_m.append(SCOPES.index(scope))
                        pids_m.append(pid)
                        owner = signer.identity()
                        gid_m.append(gids.setdefault(owner, engine.voter_gid(owner)))
                        vals_m.append(vote.vote)
                order = rng.permutation(len(rows_m))
                log.append(call(
                    engine.ingest_columnar_multi, SCOPES[:3], np.array(sidx_m)[order],
                    np.array(pids_m)[order], np.array(gid_m)[order],
                    np.array(vals_m)[order], now,
                    wire_votes=[rows_m[i] for i in order]))
                log.append(rec.events())
            if wave == 3:
                # A watermark extension of a wire-fed session: its merged
                # chain plus two votes, delivered as a peer's proposal.
                for k in (2, 9):
                    scope, pid = rec.keys[k]
                    prop = engine.get_proposal(scope, pid)
                    for j in (7, 8):
                        prop.votes.append(pkg.build_vote(prop, True, signers[j], now))
                    log.append(call(engine.deliver_proposals,
                                    [(scope, pkg.Proposal.decode(prop.encode()))], now))
                log.append(rec.events())
        log.append(sorted([rec.index[(s, p)], r] for s, p, r in engine.sweep_timeouts(NOW + 200)))
        log.append(rec.events())
        log.append(session_view(api, engine, rec))
        log.append(pool_state(api, engine))
        log.append(hashlib.sha256(b"".join(r for r, _ in old_rows)).hexdigest())
    return log


SEEDS = (0, 1, 2)
TRACES = {
    "wire": dict(),
    "object": dict(oracle=True),
    "wire-distinct": dict(distinct=True),
    "object-distinct": dict(oracle=True, distinct=True),
}


def unguarded_host_slot(api):
    """The smallest input of the reference's wire-guard sentinel: one
    session served on the host (slot -1, the frame's lowest) takes a
    validly signed first vote whose received link names nothing, through
    the wire path and then through ingest_votes."""
    pkg = api.pkg
    out = []
    with seeded(api, 3):
        engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 8, 4)
        p = engine.create_proposal("s", request(api, 0, 5), NOW)  # 5 voters > 4 lanes
        signer = pkg.StubConsensusSigner(b"\x01")
        vote = pkg.build_vote(engine.get_proposal("s", p.proposal_id), True, signer, NOW)
        vote.received_hash = b"\x01" * 32
        resign(api, vote, signer)
        data, offsets, cols = parse(api, [vote.encode()])
        out.append(engine.ingest_wire_columnar(
            ["s"], np.zeros(1, np.int64), cols, data, offsets, NOW + 1).tolist())
        out.append(engine.ingest_votes([("s", pkg.Vote.decode(vote.encode()))], NOW + 1).tolist())
        out.append(engine.occupancy()["host_spilled"])
    return out


def run_all(api):
    out = {f"{name}-{seed}": scenario_wire(api, seed, **kw)
           for name, kw in TRACES.items() for seed in SEEDS}
    out["unguarded_host_slot"] = unguarded_host_slot(api)
    return out


def reference_run(script, *args, timeout=600):
    """Run ``script --reference [args]`` in a fresh interpreter on the JAX
    CPU backend; its last stdout line is JSON."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(REPO / "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    proc = subprocess.run(
        [sys.executable, str(script), "--reference", *map(str, args)],
        capture_output=True, text=True, timeout=timeout, cwd=str(REPO), env=env,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@contextlib.contextmanager
def one_torch_thread():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's logs, computed in a fresh interpreter."""
    return reference_run(__file__)


@pytest.fixture(scope="module")
def port():
    with one_torch_thread():
        return json.loads(json.dumps(run_all(port_api())))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("trace", list(TRACES))
def test_matches_reference(reference, port, trace, seed):
    """Every step of the wire traces, and of the same traces through
    ingest_votes, equal to the JAX engine's."""
    key = f"{trace}-{seed}"
    ref_log, port_log = reference[key], port[key]
    assert len(port_log) == len(ref_log)
    for i, (a, b) in enumerate(zip(port_log, ref_log)):
        assert a == b, f"{key} step {i}"


def _is_events(entry):
    return (isinstance(entry, list) and bool(entry) and isinstance(entry[0], list)
            and bool(entry[0]) and isinstance(entry[0][0], str)
            and entry[0][0].startswith("Consensus"))


def _by_session(events):
    out = {}
    for ev in events:
        out.setdefault(ev[1], []).append(ev)
    return out


def _wire_object_differences(wire_log, obj_log):
    """Steps where a wire trace and its ingest_votes twin differ: events
    compared session by session (the columnar paths order events per
    session), the pool's arrays left out (the object path interns voters
    one by one, so gids and lanes are numbered differently)."""
    assert len(wire_log) == len(obj_log)
    out = []
    for i, (a, b) in enumerate(zip(wire_log, obj_log)):
        if i == len(wire_log) - 2:
            continue
        if _is_events(a) or _is_events(b):
            same = _by_session(a) == _by_session(b)
        else:
            same = a == b
        if not same:
            out.append(i)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_wire_path_matches_object_path(port, seed):
    """With at most one new vote a signer a session a frame, the wire path
    is status-, event-, result- and chain-identical to
    ``ingest_votes(pre_validated=False)`` over the same decoded rows."""
    assert _wire_object_differences(
        port[f"wire-distinct-{seed}"], port[f"object-distinct-{seed}"]) == []


@pytest.mark.parametrize("seed", SEEDS)
def test_wire_object_differences_are_the_references(reference, port, seed):
    """When a signer's new votes repeat within a frame, the reference's
    wire path and its ingest_votes disagree (the object path lets the
    repeat move the in-batch chain tail; ROADMAP queue 3). The port's two
    paths differ at exactly the reference's steps, and each trace equals
    the reference's (test_matches_reference)."""
    port_diff = _wire_object_differences(port[f"wire-{seed}"], port[f"object-{seed}"])
    ref_diff = _wire_object_differences(reference[f"wire-{seed}"], reference[f"object-{seed}"])
    assert port_diff == ref_diff and port_diff


def test_unguarded_host_slot_as_in_reference(reference, port):
    """The reference's wire guard starts from slot -1 as "no slot yet", so
    a first host-spilled session that holds a frame's lowest slot is not
    guarded there: a dangling first vote is accepted (ingest_votes then
    calls its redelivery a duplicate). The port keeps that for parity."""
    from hashgraph_tpu_torch.errors import StatusCode

    assert port["unguarded_host_slot"] == reference["unguarded_host_slot"]
    assert port["unguarded_host_slot"] == [
        [int(StatusCode.OK)], [int(StatusCode.DUPLICATE_VOTE)], 1]


def test_traces_reach_every_status(port):
    """The traces give every status the wire path can give."""
    from hashgraph_tpu_torch.errors import StatusCode

    codes = set()
    for key, log in port.items():
        if not key.startswith("wire"):
            continue
        for entry in log:
            if isinstance(entry, list) and entry and all(isinstance(x, int) for x in entry):
                codes.update(entry)
    for name in ("OK", "ALREADY_REACHED", "DUPLICATE_VOTE", "SESSION_NOT_FOUND",
                 "INVALID_VOTE_SIGNATURE", "INVALID_VOTE_HASH", "RECEIVED_HASH_MISMATCH",
                 "VOTE_EXPIRED", "TIMESTAMP_OLDER_THAN_CREATION_TIME"):
        assert int(getattr(StatusCode, name)) in codes, name
    flat = json.dumps(port)
    assert "ConsensusReached" in flat and "ConsensusFailedEvent" in flat


def test_wire_path_retains_chains_and_spills(port):
    """Wire-fed sessions export their accepted votes, pooled and
    host-spilled sessions alike."""
    for key, log in port.items():
        if not key.startswith("wire"):
            continue
        sessions, _, occupancy = log[-3]
        assert occupancy[2] >= 3  # host-spilled sessions took part
        assert sum(1 for s in sessions if isinstance(s[2], list) and len(s[2]) >= 3) >= 10


def test_wire_prepass_started_early_equals_inline():
    """``wire_verify_begin`` before the call and the inline prepass give
    the same statuses; a damaged row is rejected by the early prepass."""
    api = port_api()
    pkg = api.pkg
    outs = []
    for early in (False, True):
        with one_torch_thread(), seeded(api, 5):
            engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 8, 8)
            p = engine.create_proposal("s", request(api, 0, 5), NOW)
            rows = []
            prop = engine.get_proposal("s", p.proposal_id)
            for k in range(4):
                vote = pkg.build_vote(prop, True, pkg.StubConsensusSigner(bytes([k + 1])), NOW)
                if k == 2:
                    vote.signature = bytes(32)
                else:
                    prop.votes.append(vote)
                rows.append(vote.encode())
            data, offsets, cols = parse(api, rows)
            prepass = engine.wire_verify_begin(data, cols, offsets) if early else None
            outs.append(engine.ingest_wire_columnar(
                ["s"], np.zeros(4, np.int64), cols, data, offsets, NOW + 1,
                _prepass=prepass).tolist())
    assert outs[0] == outs[1]
    assert outs[0][2] == int(api.StatusCode.INVALID_VOTE_SIGNATURE)


def test_columnar_without_wire_votes_is_unchanged():
    """``ingest_columnar`` without ``wire_votes`` retains nothing, and a
    malformed ``wire_votes`` fails the call before anything applies."""
    api = port_api()
    pkg = api.pkg
    with one_torch_thread():
        engine = api.make_engine(pkg.StubConsensusSigner(b"me"), 8, 8)
        p = engine.create_proposal("s", request(api, 0, 5), NOW)
        gids = np.array([engine.voter_gid(bytes([k])) for k in (1, 2)])
        with pytest.raises(ValueError):
            engine.ingest_columnar("s", np.full(2, p.proposal_id), gids, np.ones(2, bool),
                                   NOW + 1, wire_votes=[b"x"])
        assert engine.pool().read_slot(0)["tot"] == 0
        st = engine.ingest_columnar("s", np.full(2, p.proposal_id), gids, np.ones(2, bool),
                                    NOW + 1)
        assert st.tolist() == [0, 0]
        record = engine._records[engine._index[("s", p.proposal_id)]]
        assert record.retained_wire == [] and record.scalar_seqs == []
        assert engine.get_proposal("s", p.proposal_id).votes == []


def test_create_proposals_multi_rejects_a_repeated_scope():
    api = port_api()
    engine = api.make_engine(api.pkg.StubConsensusSigner(b"me"), 8, 8)
    with pytest.raises(ValueError):
        engine.create_proposals_multi([("s", []), ("s", [])], NOW)


if __name__ == "__main__" and sys.argv[1:] == ["--reference"]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(run_all(reference_api())))
