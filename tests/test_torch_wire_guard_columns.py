"""The validated wire path's frame-wide passes against its exact per-row walk.

``TorchConsensusEngine.ingest_wire_columnar`` decides a frame's replay and
expiry rules, dangling-vote guard, chain tracking and admission health with
array passes over the frame (the engine's slot columns, the frame's owner
column), and walks row by row only the sessions the arrays cannot decide.
The walk stays callable: an engine whose slot columns call every session
unguarded (``guard_of`` answers ``_GUARD_WALK``) walks every row and probes
every duplicate-shaped row against the records, and a health monitor whose
``_admit_evicting_locked`` answers None runs the plain admission loop.

Each case feeds two engines the same frames, one on each path, and holds
them equal after every call (tolerance: exact): statuses, events in order,
every record's ``wire_tail`` / ``wire_seen`` / ``wire_sync``, the exported
vote chains, the health monitor's peers (dict order and every card field
with its phi accrual), labelled phi gauges, heartbeats and evidence. The
fast engine's slot columns are held to its records after every call: a
guarded slot's tail is its record's, and its seen filter holds every owner
its record holds. Identities are Ed25519-wide (32 bytes) unless a case says
otherwise; the monitors hold few peers, so admissions evict.
"""

import numpy as np
import pytest
import torch

from hashgraph_tpu_torch import StubConsensusSigner, TorchConsensusEngine, build_vote
from hashgraph_tpu_torch.bridge import columnar as C
from hashgraph_tpu_torch.engine.engine import _GUARD_ON, _GUARD_WALK, _WireSlotColumns
from hashgraph_tpu_torch.errors import StatusCode
from hashgraph_tpu_torch.events import BroadcastEventBus
from hashgraph_tpu_torch.obs import HealthMonitor, MetricsRegistry
from hashgraph_tpu_torch.obs.health import LIVENESS_HEARTBEATS_TOTAL
from hashgraph_tpu_torch.tracing import Tracer
from hashgraph_tpu_torch.wire import Proposal, Vote

NOW = 1_700_000_000
OK = int(StatusCode.OK)
MISMATCH = int(StatusCode.RECEIVED_HASH_MISMATCH)
REACHED = int(StatusCode.ALREADY_REACHED)
BAD_SIGNATURE = int(StatusCode.INVALID_VOTE_SIGNATURE)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def signer(i: int, width: int = 32) -> StubConsensusSigner:
    return StubConsensusSigner(bytes([i % 251 + 1, i // 251 + 1]) * (width // 2) + bytes(width % 2))


def proposal(pid: int, voters: int, expiry: int = 600) -> Proposal:
    return Proposal(
        name=f"p{pid}", payload=b"", proposal_id=pid, proposal_owner=b"o" * 20,
        expected_voters_count=voters, timestamp=NOW, expiration_timestamp=NOW + expiry,
        liveness_criteria_yes=True,
    )


def make_engine(walk: bool, max_peers: int, capacity: int, voter_capacity: int):
    monitor = HealthMonitor(max_peers=max_peers, registry=MetricsRegistry())
    monitor.register_gauges(MetricsRegistry())
    engine = TorchConsensusEngine(
        StubConsensusSigner(b"me"), capacity, voter_capacity, device="cpu",
        verify_cache=None, health_monitor=monitor,
        event_bus=BroadcastEventBus(max_queued_events=1_000_000),
    )
    engine.tracer = Tracer(enabled=True)
    if walk:
        engine._wire_cols.guard_of = lambda slots: np.full(len(slots), _GUARD_WALK, np.int8)
        monitor._admit_evicting_locked = lambda *args: None
    return engine


class Pair:
    """The same calls on a fast engine and a walking one, compared after
    each."""

    def __init__(self, max_peers=6, capacity=24, voter_capacity=8):
        self.fast = make_engine(False, max_peers, capacity, voter_capacity)
        self.walk = make_engine(True, max_peers, capacity, voter_capacity)
        self.rx = {e: e.event_bus().subscribe() for e in (self.fast, self.walk)}
        self.keys = []  # (scope, pid) of every session made

    def both(self, name, *args, **kwargs):
        out = [getattr(e, name)(*args, **kwargs) for e in (self.fast, self.walk)]
        assert np.array_equal(np.asarray(out[0]), np.asarray(out[1])), name
        self.check()
        return out[0]

    def propose(self, scope, props, now=NOW):
        self.keys.extend((scope, p.proposal_id) for p in props)
        return self.both("ingest_proposals", [(scope, Proposal.decode(p.encode())) for p in props], now)

    def wire(self, scopes, rows, now):
        """One ``ingest_wire_columnar`` call over (scope index, vote bytes)
        rows."""
        data = np.frombuffer(b"".join(r for _, r in rows), np.uint8)
        offsets = np.zeros(len(rows) + 1, np.int64)
        np.cumsum([len(r) for _, r in rows], out=offsets[1:])
        cols, flags = C.parse_vote_columns(data, offsets)
        assert flags.all()
        idx = np.array([i for i, _ in rows], np.int64)
        return self.both("ingest_wire_columnar", scopes, idx, cols, data, offsets, now).tolist()

    def chain(self, scope, pid):
        return self.fast.get_proposal(scope, pid)

    def counter(self, name):
        return self.fast.tracer.counters().get(name, 0)

    def check(self):
        events = [self._events(e) for e in (self.fast, self.walk)]
        assert events[0] == events[1]
        assert state(self.fast, self.keys) == state(self.walk, self.keys)
        columns_hold(self.fast)

    def _events(self, engine):
        out = []
        while (item := self.rx[engine].try_recv()) is not None:
            scope, ev = item
            out.append((scope, type(ev).__name__, ev.proposal_id, getattr(ev, "result", None)))
        return out


def state(engine, keys):
    records = {
        slot: (r.wire_tail, None if r.wire_seen is None else sorted(r.wire_seen), r.wire_sync,
               len(r.retained_wire), r.wire_only)
        for slot, r in engine._records.items()
    }
    mon = engine.health
    peers = []
    for key, card in mon._peers.items():
        acc = card.accrual
        peers.append((
            key, card.identity, card.first_seen, card.last_seen, card.votes_admitted,
            card.invalid_signatures, card.expired_gossip, card.equivocations,
            card.timeout_hint, type(card.timeout_hint),
            None if acc is None else (acc.last_heartbeat, list(acc._intervals), acc._sum, acc._sumsq),
        ))
    chains = []
    for scope, pid in keys:
        try:
            chains.append(engine.get_proposal(scope, pid).encode())
        except Exception as exc:  # an evicted session: its exception is compared
            chains.append(type(exc).__name__)
    return [
        records, peers, [e.as_dict() for e in mon._evidence], sorted(mon._phi_labelled),
        mon._registry.counter(LIVENESS_HEARTBEATS_TOTAL).value, chains,
    ]


def columns_hold(engine):
    """Every guarded slot's columns are its record's; its seen filter
    holds every bit its record's owners need."""
    wc = engine._wire_cols
    for slot, record in engine._records.items():
        if slot < 0:
            continue
        if wc.rules[slot]:
            assert int(wc.created[slot]) == record.proposal.timestamp
            assert int(wc.expiry[slot]) == record.proposal.expiration_timestamp
            assert wc.timeout[slot] == record.config.consensus_timeout
        if wc.guard[slot] == _GUARD_ON:
            fresh = _WireSlotColumns(slot + 1)
            fresh.rebuild(record)
            assert fresh.guard[slot] == _GUARD_ON
            assert wc.tail_len[slot] == fresh.tail_len[slot]
            assert np.array_equal(wc.tail[slot], fresh.tail[slot])
            assert np.array_equal(wc.bloom[slot] & fresh.bloom[slot], fresh.bloom[slot])


def vote_on(pair, scope, pid, who, value=True, now=NOW + 1, chain=None):
    """A validly signed vote chained on ``chain`` (the session's exported
    chain by default), appended to it."""
    chain = pair.chain(scope, pid) if chain is None else chain
    vote = build_vote(chain, value, who, now)
    chain.votes.append(vote)
    return vote


def relink(vote, who, received):
    vote.received_hash = received
    vote.vote_hash = __import__("hashgraph_tpu_torch").compute_vote_hash(vote)
    vote.signature = who.sign(vote.signing_payload())
    return vote


# ── designed cases ─────────────────────────────────────────────────────


def case_chain_break(pair):
    """A chain break mid-session: the row after the break names the last
    passing row, the broken one is refused, all without the walk."""
    pair.propose("s", [proposal(1, 8)])
    chain = pair.chain("s", 1)
    v1 = vote_on(pair, "s", 1, signer(1), chain=chain)
    v2 = relink(build_vote(chain, True, signer(2), NOW + 1), signer(2), b"\x07" * 32)
    v3 = vote_on(pair, "s", 1, signer(3), chain=chain)  # names v1
    v4 = vote_on(pair, "s", 1, signer(4), chain=chain)
    st = pair.wire(["s"], [(0, v.encode()) for v in (v1, v2, v3, v4)], NOW + 1)
    assert st == [OK, MISMATCH, OK, OK]
    assert pair.counter("engine.wire.walked_rows") == 0


def case_repeat_after_accept(pair):
    """An owner twice in one frame after its accepted first row."""
    pair.propose("s", [proposal(1, 8)])
    chain = pair.chain("s", 1)
    v1 = vote_on(pair, "s", 1, signer(1), chain=chain)
    again = vote_on(pair, "s", 1, signer(1), value=False, chain=chain)
    v3 = vote_on(pair, "s", 1, signer(2), chain=chain)
    st = pair.wire(["s"], [(0, v.encode()) for v in (v1, again, v3)], NOW + 1)
    assert st[0] == OK and st[1] != OK
    assert pair.counter("engine.wire.walked_rows") == 3


def case_repeat_after_refuse(pair):
    """An owner twice in one frame after its refused first row."""
    pair.propose("s", [proposal(1, 8)])
    chain = pair.chain("s", 1)
    bad = relink(build_vote(chain, True, signer(1), NOW + 1), signer(1), b"\x09" * 32)
    good = vote_on(pair, "s", 1, signer(1), chain=chain)
    st = pair.wire(["s"], [(0, bad.encode()), (0, good.encode())], NOW + 1)
    assert st == [MISMATCH, OK]


def case_redelivery(pair):
    """A redelivered accepted vote: skipped by the guard, refused by the
    apply, no evidence."""
    pair.propose("s", [proposal(1, 8)])
    votes = [vote_on(pair, "s", 1, signer(i)) for i in range(3)]
    pair.wire(["s"], [(0, v.encode()) for v in votes], NOW + 1)
    st = pair.wire(["s"], [(0, votes[1].encode())], NOW + 2)
    assert st[0] != OK
    assert pair.fast.health.evidence_count() == 0


def case_equivocation(pair):
    """After the session decided, an earlier voter signs another vote:
    ALREADY_REACHED, and the pair is kept as evidence."""
    pair.propose("s", [proposal(1, 3)])
    votes = [vote_on(pair, "s", 1, signer(i)) for i in range(2)]
    assert pair.wire(["s"], [(0, v.encode()) for v in votes], NOW + 1) == [OK, OK]
    other = vote_on(pair, "s", 1, signer(0), value=False, now=NOW + 2)
    st = pair.wire(["s"], [(0, other.encode())], NOW + 2)
    assert st == [REACHED]
    assert pair.fast.health.evidence_count() == 1


def case_resync(pair):
    """``ingest_votes`` touches a wire-fed session between frames: the
    next frame resyncs it and the columns follow."""
    pair.propose("s", [proposal(1, 8), proposal(2, 8)])
    rows = [(0, vote_on(pair, "s", pid, signer(i)).encode()) for pid in (1, 2) for i in range(2)]
    pair.wire(["s"], rows, NOW + 1)
    scalar = vote_on(pair, "s", 1, signer(5))
    pair.both("ingest_votes", [("s", Vote.decode(scalar.encode()))], NOW + 1)
    rows = [(0, vote_on(pair, "s", pid, signer(6)).encode()) for pid in (1, 2)]
    st = pair.wire(["s"], rows, NOW + 2)
    assert st == [OK, OK]


def case_columnar_retained(pair):
    """A session retained from pre-validated columnar ingest stays
    permissive: a dangling first vote lands."""
    pair.propose("s", [proposal(1, 8)])
    votes = [vote_on(pair, "s", 1, signer(i)) for i in range(2)]
    gids = [[e.voter_gid(signer(i).identity()) for i in range(2)] for e in (pair.fast, pair.walk)]
    assert gids[0] == gids[1]
    pair.both("ingest_columnar_multi", ["s"], np.zeros(2, np.int64), np.array([1, 1]),
              np.array(gids[0]), np.array([True, True]), NOW + 1,
              wire_votes=[v.encode() for v in votes])
    chain = pair.chain("s", 1)
    dangling = relink(build_vote(chain, True, signer(3), NOW + 2), signer(3), b"\x05" * 32)
    assert pair.wire(["s"], [(0, dangling.encode())], NOW + 2) == [OK]


def case_sentinel(pair):
    """The first host-served session holds slot -1; as the frame's lowest
    slot its dangling first vote goes unguarded (the pinned parity
    fault), beside guarded pooled rows."""
    pair.propose("s", [proposal(1, 12), proposal(2, 4)])  # 12 voters > 8 lanes
    assert pair.fast._index[("s", 1)] == -1
    chain = pair.chain("s", 1)
    dangling = relink(build_vote(chain, True, signer(1), NOW + 1), signer(1), b"\x03" * 32)
    pooled = relink(build_vote(pair.chain("s", 2), True, signer(2), NOW + 1), signer(2), b"\x03" * 32)
    st = pair.wire(["s"], [(0, pooled.encode()), (0, dangling.encode())], NOW + 1)
    assert st == [MISMATCH, OK]


def case_forged(pair):
    """A forged row is refused for its signature, and its claimed signer's
    card says so."""
    pair.propose("s", [proposal(1, 8)])
    chain = pair.chain("s", 1)
    v1 = vote_on(pair, "s", 1, signer(1), chain=chain)
    forged = build_vote(chain, True, signer(2), NOW + 1)
    forged.signature = bytes(32)
    st = pair.wire(["s"], [(0, v1.encode()), (0, forged.encode())], NOW + 1)
    assert st == [OK, BAD_SIGNATURE]
    assert pair.fast.health.scorecard(signer(2).identity())["invalid_signatures"] == 1


def case_narrow_owners(pair):
    """One-byte identities take the array passes too."""
    pair.propose("s", [proposal(1, 8)])
    votes = [vote_on(pair, "s", 1, StubConsensusSigner(bytes([i + 1]))) for i in range(3)]
    assert pair.wire(["s"], [(0, v.encode()) for v in votes], NOW + 1) == [OK] * 3
    assert pair.counter("engine.wire.walked_rows") == 0


def case_mixed_widths(pair):
    """Identities of two widths in one frame give no owner column: every
    row walks, gids are interned by the memo, admissions by the loop."""
    pair.propose("s", [proposal(1, 8)])
    who = [StubConsensusSigner(b"\x01"), signer(2), signer(3)]
    votes = [vote_on(pair, "s", 1, w) for w in who]
    assert pair.wire(["s"], [(0, v.encode()) for v in votes], NOW + 1) == [OK] * 3
    assert pair.counter("engine.wire.walked_rows") == 3


CASES = {
    "chain_break": case_chain_break,
    "repeat_after_accept": case_repeat_after_accept,
    "repeat_after_refuse": case_repeat_after_refuse,
    "redelivery": case_redelivery,
    "equivocation": case_equivocation,
    "resync": case_resync,
    "columnar_retained": case_columnar_retained,
    "sentinel": case_sentinel,
    "forged": case_forged,
    "narrow_owners": case_narrow_owners,
    "mixed_widths": case_mixed_widths,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_equals_the_walk(name):
    CASES[name](Pair())


def test_reactor_merged_frames_keep_the_pinned_fault():
    """Two frames of one chain merged by the reactor into one call: the
    vote after a refused one passes the guard in the merged call and is
    refused in its own frame, on both paths (the JAX package's merge
    fault, pinned in test_torch_apply_reactor)."""
    from test_torch_apply_reactor import merged_frames_statuses

    want = {"separate": [OK, OK, REACHED, MISMATCH], "merged": [OK, OK, REACHED, REACHED]}
    assert merged_frames_statuses("hashgraph_tpu_torch") == want
    saved = _WireSlotColumns.guard_of
    _WireSlotColumns.guard_of = lambda self, slots: np.full(len(slots), _GUARD_WALK, np.int8)
    try:
        assert merged_frames_statuses("hashgraph_tpu_torch") == want
    finally:
        _WireSlotColumns.guard_of = saved


# ── seeded traffic ─────────────────────────────────────────────────────


def run_seeded(seed: int) -> Pair:
    """Frames over pooled and host-served sessions: chained votes (a few in
    a row per session), redeliveries, dangling links, forged signatures,
    votes before creation and after expiry, post-decision votes and
    equivocations, a repeated owner now and then; scalar votes and
    pre-validated columnar retention between frames."""
    rng = np.random.default_rng(seed)
    pair = Pair(max_peers=int(rng.integers(3, 12)))
    scopes = ["a", "b"]
    pid = 100
    for scope in scopes:
        props = []
        for _ in range(6):
            pid += 1
            props.append(proposal(pid, int(rng.choice([3, 5, 8, 10])), expiry=int(rng.choice([5, 600]))))
        pair.propose(scope, props)
    signers = [signer(i) for i in range(16)]
    sent = []
    for wave in range(8):
        now = NOW + 1 + wave
        rows, shadow = [], {}
        for _ in range(int(rng.integers(10, 40))):
            k = int(rng.integers(0, len(pair.keys)))
            scope, p = pair.keys[k]
            if k not in shadow:
                try:
                    shadow[k] = pair.chain(scope, p)
                except Exception:  # evicted
                    continue
            chain = shadow[k]
            who = signers[int(rng.integers(0, len(signers)))]
            action = rng.random()
            if action < 0.08 and sent:
                rows.append(sent[int(rng.integers(0, len(sent)))])
                continue
            ts = NOW - 50 if action < 0.11 else NOW + 900 if action < 0.14 else now
            vote = build_vote(chain, bool(rng.random() < 0.6), who, ts)
            if 0.14 <= action < 0.2:
                relink(vote, who, bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
            elif 0.2 <= action < 0.25:
                vote.signature = bytes(32)
            elif action >= 0.25:
                chain.votes.append(vote)
            rows.append((scopes.index(scope), vote.encode()))
        if not rows:
            continue
        st = pair.wire(scopes, rows, now)
        sent.extend(r for r, s in zip(rows, st) if s == OK)
        if wave == 2:
            scope, p = pair.keys[int(rng.integers(0, len(pair.keys)))]
            try:
                vote = vote_on(pair, scope, p, signers[15], now=now)
                pair.both("ingest_votes", [(scope, Vote.decode(vote.encode()))], now)
            except Exception:  # evicted
                pass
        if wave == 4:
            pid += 1
            pair.propose("b", [proposal(pid, 8)], now)
            votes = [vote_on(pair, "b", pid, signers[i], now=now) for i in range(2)]
            gids = [pair.fast.voter_gid(signers[i].identity()) for i in range(2)]
            assert gids == [pair.walk.voter_gid(signers[i].identity()) for i in range(2)]
            pair.both("ingest_columnar_multi", ["b"], np.zeros(2, np.int64), np.array([pid, pid]),
                      np.array(gids), np.array([True, False]), now,
                      wire_votes=[v.encode() for v in votes])
    return pair


@pytest.mark.parametrize("seed", range(8))
def test_seeded_frames_equal_the_walk(seed):
    pair = run_seeded(seed)
    # The arrays decided most rows, and admissions evicted cards unbuilt.
    walked = pair.counter("engine.wire.walked_rows")
    assert walked < pair.fast.tracer.counters().get("engine.votes_in", 0)
    assert pair.counter("engine.wire.admit_cards_skipped") >= 0
