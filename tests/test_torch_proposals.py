"""Parity: proposal ingest on TorchConsensusEngine(device="cpu") against the
JAX package's TpuConsensusEngine, with ``verify_cache`` None and "default".

The JAX engine runs in a subprocess (``python tests/test_torch_proposals.py
--reference``), as in ``tests/test_torch_engine.py``, so this process leaves
the JAX package's process-wide state (metrics, health, tracer) as it found
it. Both sides run the same scenario code with seeded proposal and vote ids
(``protocol.set_id_entropy``), so every signed byte is the same on both and
results are keyed by proposal id. Proposals cross as encoded wire bytes.
The scenarios cover ``tests/test_redelivery.py::TestDeliverProposals`` and
``tests/test_engine_proposals.py``, sessions decided when they arrive,
sessions served on the host (too wide, pool full), the per-scope cap,
``cast_vote_and_get_proposal``, ``ingest_votes_pipelined`` against
sequential ``ingest_votes``, seeded mixed traces at 16 seeds, and batches
that register in bulk. Statuses, exception types, consensus results, events
(in emission order), scope stats, occupancy and each proposal's vote list
(hashes) and round must be equal (tolerance: exact); the bulk batches also
compare slot numbers and every pool row.

The port's registration in bulk (the slot writes of one ``ingest_proposals``
call made in one activate and one release dispatch) is also held against
the same items delivered one a call, with a sharded pool too, and its
dispatches and tracer counters are counted.
"""

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
CACHES = (None, "default")


def port_api():
    import hashgraph_tpu_torch as pkg
    from hashgraph_tpu_torch import protocol
    from hashgraph_tpu_torch.events import BroadcastEventBus
    from hashgraph_tpu_torch.wire import Proposal

    def make_engine(signer, cache, capacity=32, voter_capacity=16, max_sessions=10_000,
                    pool=None):
        geometry = (None, None) if pool is not None else (capacity, voter_capacity)
        return pkg.TorchConsensusEngine(
            signer, *geometry,
            event_bus=BroadcastEventBus(max_queued_events=1_000_000),
            max_sessions_per_scope=max_sessions, device="cpu", verify_cache=cache,
            pool=pool,
        )

    return SimpleNamespace(pkg=pkg, protocol=protocol, Proposal=Proposal,
                           make_engine=make_engine)


def reference_api():
    import hashgraph_tpu as pkg
    from hashgraph_tpu import protocol
    from hashgraph_tpu.engine import TpuConsensusEngine
    from hashgraph_tpu.events import BroadcastEventBus
    from hashgraph_tpu.obs.health import HealthMonitor
    from hashgraph_tpu.wire import Proposal

    def make_engine(signer, cache, capacity=32, voter_capacity=16, max_sessions=10_000):
        return TpuConsensusEngine(
            signer, event_bus=BroadcastEventBus(max_queued_events=1_000_000),
            capacity=capacity, voter_capacity=voter_capacity,
            max_sessions_per_scope=max_sessions, verify_cache=cache,
            health_monitor=HealthMonitor(),
        )

    return SimpleNamespace(pkg=pkg, protocol=protocol, Proposal=Proposal,
                           make_engine=make_engine)


# ── Shared scenario helpers ───────────────────────────────────────────


def call(fn, *args, **kwargs):
    """Result of a call (a vote as its hash), or ``["raised", exception
    type]``."""
    try:
        out = fn(*args, **kwargs)
    except Exception as exc:  # the exception type is the result compared
        return ["raised", type(exc).__name__]
    if hasattr(out, "vote_hash"):
        return out.vote_hash.hex()
    if isinstance(out, np.ndarray):
        return out.tolist()
    if isinstance(out, list):
        return [int(x) if isinstance(x, (int, np.integer)) else x for x in out]
    return out


class Side:
    """One package's view of a scenario: its engines, signers and events."""

    def __init__(self, api, cache):
        self.api = api
        self.cache = cache
        self.receivers = []

    def signer(self, k):
        return self.api.pkg.StubConsensusSigner(bytes([k % 251 + 1, k // 251]) * 10)

    def engine(self, me=b"\x42" * 20, **kwargs):
        engine = self.api.make_engine(self.api.pkg.StubConsensusSigner(me), self.cache, **kwargs)
        self.receivers.append(engine.event_bus().subscribe())
        return engine

    def events(self, engine_index=-1):
        rx = self.receivers[engine_index]
        out = []
        while (item := rx.try_recv()) is not None:
            scope, ev = item
            out.append([scope, type(ev).__name__, ev.proposal_id,
                        getattr(ev, "result", None), ev.timestamp])
        return out

    def proposal(self, pid, n, expiry=10_000, live=True, name="p"):
        return self.api.pkg.CreateProposalRequest(
            name=name, payload=b"x", proposal_owner=b"o", expected_voters_count=n,
            expiration_timestamp=expiry, liveness_criteria_yes=live,
        ).into_proposal(NOW, pid=pid)

    def grow(self, base, n_votes, first=0, t0=NOW + 1, choices=None):
        """``base`` with ``n_votes`` more chained votes by signers
        ``first``, ``first + 1`` ... (yes unless ``choices`` says)."""
        chain = base.clone()
        for i in range(n_votes):
            choice = True if choices is None else bool(choices[i])
            chain.votes.append(
                self.api.pkg.build_vote(chain, choice, self.signer(first + i), t0 + i))
        return chain

    def wire(self, proposal):
        return self.api.Proposal.decode(proposal.encode())

    def resign(self, vote):
        """Re-hash and re-sign a mutated vote with its owner's stub key."""
        vote.vote_hash = self.api.protocol.compute_vote_hash(vote)
        vote.signature = self.api.pkg.StubConsensusSigner(vote.vote_owner).sign(
            vote.signing_payload())


def grown(chain, k):
    p = chain.clone()
    p.votes = [v.clone() for v in chain.votes[:k]]
    return p


def session_view(engine, scope, pid):
    """Result, vote hashes and round of one session (or what raised)."""
    prop = call(engine.get_proposal, scope, pid)
    if isinstance(prop, list):
        return prop
    return [call(engine.get_consensus_result, scope, pid),
            [v.vote_hash.hex() for v in prop.votes], prop.round]


def snapshot(engine, keys):
    scopes = sorted({s for s, _ in keys})
    stats = []
    for scope in scopes:
        st = engine.get_scope_stats(scope)
        stats.append([scope, st.total_sessions, st.active_sessions, st.failed_sessions,
                      st.consensus_reached, len(engine.get_active_proposals(scope)),
                      sorted([p.proposal_id, r] for p, r in engine.get_reached_proposals(scope))])
    occ = engine.occupancy()
    return dict(
        sessions=[[s, pid, session_view(engine, s, pid)] for s, pid in keys],
        stats=stats,
        occupancy=[occ["live_sessions"], occ["device_slots_used"], occ["host_spilled"]],
    )


class seeded_ids:
    """Seeded vote and proposal ids for the scenario's duration."""

    def __init__(self, api, seed):
        self.api, self.rng = api, random.Random(seed)

    def __enter__(self):
        self.api.protocol.set_id_entropy(lambda: self.rng.getrandbits(128))

    def __exit__(self, *exc):
        self.api.protocol.set_id_entropy(None)


# ── Scenarios ─────────────────────────────────────────────────────────


def scenario_deliver(side, seed):
    """The cases of test_redelivery.py::TestDeliverProposals."""
    log = []
    base = side.proposal(1001 + seed, 12)
    chain = side.grow(base, 6, choices=[i % 2 for i in range(6)])
    pid = chain.proposal_id
    w = side.wire

    r = side.engine()  # unknown pid registers
    log.append(r.deliver_proposals([("s", w(grown(chain, 3)))], NOW + 20))
    log.append(snapshot(r, [("s", pid)]))
    r = side.engine()  # incremental growth along the watermark
    log.append([r.deliver_proposals([("s", w(grown(chain, k)))], NOW + 20)
                for k in range(1, 7)])
    log.append(snapshot(r, [("s", pid)]))
    r = side.engine()  # exact redelivery, then a truncated chain
    log.append([r.deliver_proposal("s", w(grown(chain, 4)), NOW + 20),
                r.deliver_proposal("s", w(grown(chain, 4)), NOW + 21),
                r.deliver_proposal("s", w(grown(chain, 2)), NOW + 21)])
    log.append(snapshot(r, [("s", pid)]))
    r = side.engine()  # an expired extension
    log.append(r.deliver_proposal("s", w(grown(chain, 3)), NOW + 20))
    late = r.get_proposal("s", pid).expiration_timestamp + 1
    log.append(r.deliver_proposals([("s", w(grown(chain, 6)))], late))
    log.append(r.deliver_proposals([("s", w(grown(chain, 6)))], late - 1))  # now == expiry
    log.append(snapshot(r, [("s", pid)]))
    r = side.engine()  # a fork before the watermark
    log.append(r.deliver_proposal("s", w(grown(chain, 4)), NOW + 20))
    fork = grown(chain, 5)
    fork.votes[2] = side.api.pkg.build_vote(base, True, side.signer(90), NOW + 40)
    log.append(r.deliver_proposal("s", w(fork), NOW + 41))
    log.append(snapshot(r, [("s", pid)]))
    r = side.engine()  # a bad signature in the suffix, then the honest chain
    log.append(r.deliver_proposal("s", w(grown(chain, 3)), NOW + 20))
    bad = grown(chain, 5)
    bad.votes[4].signature = b"\x00" * 32
    log.append(r.deliver_proposal("s", w(bad), NOW + 21))
    log.append(snapshot(r, [("s", pid)]))
    log.append(r.deliver_proposal("s", w(grown(chain, 5)), NOW + 22))
    log.append(snapshot(r, [("s", pid)]))
    r = side.engine()  # a bad link in the suffix, re-signed
    log.append(r.deliver_proposal("s", w(grown(chain, 3)), NOW + 20))
    bad = grown(chain, 5)
    bad.votes[4].received_hash = b"\x13" * 32
    side.resign(bad.votes[4])
    log.append(r.deliver_proposal("s", w(bad), NOW + 21))
    bad = grown(chain, 5)
    bad.votes[3].proposal_id ^= 0xFF  # a suffix vote of another proposal
    side.resign(bad.votes[3])
    log.append(r.deliver_proposal("s", w(bad), NOW + 21))
    log.append(snapshot(r, [("s", pid)]))
    # A mixed batch: extension, fresh registration, same-batch redelivery.
    chain_b = side.grow(side.proposal(2001 + seed, 12), 6)
    r = side.engine()
    log.append(r.deliver_proposal("a", w(grown(chain, 2)), NOW + 20))
    log.append(r.deliver_proposals([("a", w(grown(chain, 4))), ("b", w(grown(chain_b, 3))),
                                    ("a", w(grown(chain, 4)))], NOW + 21))
    log.append(snapshot(r, [("a", pid), ("b", chain_b.proposal_id)]))
    r = side.engine()  # a batch equals sequential deliveries
    log.append(r.deliver_proposals([("s", w(grown(chain, 2))), ("s", w(grown(chain, 4)))],
                                   NOW + 20))
    log.append(snapshot(r, [("s", pid)]))
    log.append(call(r.deliver_proposals, [], NOW, configs=[None]))
    # A suffix that crosses quorum decides the session.
    small = side.grow(side.proposal(3001 + seed, 6), 6)
    r = side.engine()
    log.append(r.deliver_proposal("s", w(grown(small, 3)), NOW + 20))
    log.append(r.deliver_proposal("s", w(grown(small, 6)), NOW + 21))
    log.append(snapshot(r, [("s", small.proposal_id)]))
    log.append([side.events(k) for k in range(len(side.receivers))])
    return log


def carried(side, pid, n, votes, seed, mutate=None, expiry=1000):
    rng = np.random.default_rng(seed)
    chain = side.grow(side.proposal(pid, n, expiry=expiry), votes,
                      first=10 * seed, t0=NOW, choices=rng.random(votes) < 0.7)
    if mutate:
        mutate(chain)
    return chain


def scenario_ingest(side, seed):
    """test_engine_proposals.py: a mixed batch through ingest_proposals
    against the same proposals one by one through process_incoming_proposal,
    then an engine that continues after a batch load; per-item configs."""
    pkg = side.api.pkg

    def bad_sig(p):
        p.votes[1].signature = bytes(len(p.votes[1].signature))

    def bad_chain(p):
        p.votes[1].received_hash = b"\x13" * 32

    def bad_pid(p):
        p.votes[0].proposal_id ^= 0xFF

    def bad_parent(p):
        p.votes[2].parent_hash = p.votes[0].vote_hash
        side.resign(p.votes[2])

    base = 100 * seed
    proposals = [
        carried(side, base + 1, 3, 0, 1),
        carried(side, base + 2, 3, 2, 2),  # 2/3 quorum: decided on arrival
        carried(side, base + 3, 5, 2, 3),
        carried(side, base + 4, 3, 2, 4, bad_sig),
        carried(side, base + 5, 3, 2, 5, bad_chain),
        carried(side, base + 6, 3, 1, 6, bad_pid),
        carried(side, base + 7, 6, 4, 7, bad_parent),
        carried(side, base + 8, 6, 4, 8, expiry=5),  # expired at arrival
        carried(side, base + 9, 20, 4, 9),  # wider than the lanes: on the host
    ]
    proposals.append(proposals[0].clone())  # the same pid again
    keys = [("s", p.proposal_id) for p in proposals[:-1]]
    log = []
    scalar = side.engine(voter_capacity=8)
    log.append([call(scalar.process_incoming_proposal, "s", side.wire(p), NOW + 10)
                for p in proposals])
    batch = side.engine(voter_capacity=8)
    log.append(batch.ingest_proposals([("s", side.wire(p)) for p in proposals], NOW + 10))
    log.append(snapshot(scalar, keys))
    log.append(snapshot(batch, keys))
    log.append([side.events(0), side.events(1)])
    # Continues after a batch load.
    engine = side.engine(capacity=8, voter_capacity=8)
    p = carried(side, base + 50, 3, 1, 9)
    log.append(engine.ingest_proposals([("s", side.wire(p))], NOW + 1))
    vote = pkg.build_vote(engine.get_proposal("s", p.proposal_id), True, side.signer(77), NOW + 2)
    log.append(call(engine.process_incoming_vote, "s", vote, NOW + 2))
    log.append(snapshot(engine, [("s", p.proposal_id)]))
    # Per-item configs, and a misaligned list.
    cfg = [pkg.ConsensusConfig.p2p(), None, pkg.ConsensusConfig.gossipsub().with_threshold(0.9)]
    items = [("c", side.wire(carried(side, base + 60 + k, 4, 3, 20 + k))) for k in range(3)]
    log.append(engine.ingest_proposals(items, NOW + 3, configs=cfg))
    log.append(call(engine.ingest_proposals, items, NOW + 3, configs=[None]))
    log.append(snapshot(engine, [("c", p.proposal_id) for _, p in items]))
    log.append(side.events(2))
    return log


def scenario_capacity(side, seed):
    """Decided on arrival, too wide for the lanes, a full pool and the
    per-scope cap, through every proposal entry point; then extensions,
    votes, casts and timeouts on the sessions they made."""
    pkg = side.api.pkg
    log = []
    engine = side.engine(capacity=3, voter_capacity=8)
    a = side.grow(side.proposal(11 + seed, 6), 5)  # decided when it arrives
    b = side.grow(side.proposal(12 + seed, 12), 3)  # wider than the lanes
    c = side.grow(side.proposal(13 + seed, 4), 2)
    d = side.proposal(14 + seed, 4, expiry=60)
    e = side.grow(side.proposal(15 + seed, 5, live=False), 3)  # past the free slots
    keys = [("s", p.proposal_id) for p in (a, b, c, d, e)]
    log.append(engine.ingest_proposals([("s", side.wire(p)) for p in (a, b, c, d, e)], NOW + 5))
    log.append(side.events())  # the decided one's event came before its row
    log.append(snapshot(engine, keys))
    ext = [side.grow(p, 2, first=40 + k, t0=NOW + 10) for k, p in enumerate((a, b, c, d, e))]
    log.append(engine.deliver_proposals([("s", side.wire(p)) for p in ext], NOW + 12))
    log.append(snapshot(engine, keys))
    for p in ext:
        log.append(call(engine.cast_vote, "s", p.proposal_id, seed % 2 == 0, NOW + 13))
    log.append(engine.sweep_timeouts(NOW + 61))
    log.append(call(engine.handle_consensus_timeout, "s", e.proposal_id, NOW + 62))
    log.append(snapshot(engine, keys))
    log.append(side.events())
    # process_incoming_proposal: decided on arrival, then a late vote.
    single = side.engine(capacity=2, voter_capacity=8)
    f = side.grow(side.proposal(21 + seed, 4), 4)
    log.append(call(single.process_incoming_proposal, "s", side.wire(f), NOW + 5))
    log.append(call(single.process_incoming_proposal, "s", side.wire(f), NOW + 5))
    late = pkg.build_vote(single.get_proposal("s", f.proposal_id), True, side.signer(99), NOW + 6)
    log.append(call(single.process_incoming_vote, "s", late, NOW + 6))
    wide = side.grow(side.proposal(22 + seed, 30), 4)
    log.append(call(single.process_incoming_proposal, "s", side.wire(wide), NOW + 5,
                    pkg.ConsensusConfig.p2p()))
    expired = side.proposal(23 + seed, 4, expiry=3)
    log.append(call(single.process_incoming_proposal, "s", side.wire(expired), NOW + 5))
    log.append(snapshot(single, [("s", f.proposal_id), ("s", wide.proposal_id)]))
    log.append(side.events())
    # The per-scope cap: ties on created_at evict the newcomers.
    capped = side.engine(capacity=8, voter_capacity=8, max_sessions=2)
    props = [side.grow(side.proposal(31 + 10 * seed + k, 4), k % 3) for k in range(5)]
    log.append(capped.ingest_proposals([("s", side.wire(p)) for p in props[:3]], NOW + 5))
    log.append(capped.deliver_proposals([("s", side.wire(p)) for p in props[2:]], NOW + 6))
    log.append(snapshot(capped, [("s", p.proposal_id) for p in props]))
    log.append(side.events())
    return log


def scenario_cast(side, seed):
    """cast_vote_and_get_proposal on pooled and host sessions; the peer
    extends the returned chain."""
    log = []
    engine = side.engine(me=b"\x24" * 20, voter_capacity=8)
    pooled = side.grow(side.proposal(501 + seed, 8), 3)
    hosted = side.grow(side.proposal(502 + seed, 9), 3)
    log.append(engine.deliver_proposals([("s", side.wire(pooled)), ("s", side.wire(hosted))],
                                        NOW + 5))
    for p in (pooled, hosted):
        got = call(engine.cast_vote_and_get_proposal, "s", p.proposal_id, True, NOW + 6)
        log.append([v.vote_hash.hex() for v in got.votes] + [got.round]
                   if not isinstance(got, list) else got)
        log.append(call(engine.cast_vote_and_get_proposal, "s", p.proposal_id, False, NOW + 7))
        peer = side.grow(got, 2, first=60, t0=NOW + 8)
        log.append(engine.deliver_proposal("s", side.wire(peer), NOW + 9))
    log.append(call(engine.cast_vote_and_get_proposal, "s", 999_999, True, NOW + 6))
    log.append(snapshot(engine, [("s", pooled.proposal_id), ("s", hosted.proposal_id)]))
    log.append(side.events())
    return log


def scenario_pipelined(side, seed):
    """ingest_votes_pipelined against sequential ingest_votes on a second
    engine fed the same proposals and batches."""
    pkg = side.api.pkg
    rng = np.random.default_rng(seed)
    props = [side.proposal(700 + 10 * seed + k, int(rng.integers(3, 12))) for k in range(6)]
    shadows = [p.clone() for p in props]
    batches = []
    for b in range(4):
        batch = []
        for _ in range(int(rng.integers(1, 12))):
            k = int(rng.integers(0, len(props)))
            vote = pkg.build_vote(shadows[k], bool(rng.random() < 0.6),
                                  side.signer(int(rng.integers(0, 14))), NOW + 1 + b)
            shadows[k].votes.append(vote)
            kind = rng.random()
            if kind < 0.1:
                vote = vote.clone()
                vote.signature = b"\x01" * 32
            elif kind < 0.15:
                vote = vote.clone()
                vote.proposal_id = 4
            batch.append(("s", vote))
            if rng.random() < 0.15:
                batch.append(("s", vote.clone()))  # a redelivery in the batch
        batches.append(batch)
    batches.insert(2, [])
    log = []
    for pre_validated in (False, True):
        piped, serial = side.engine(), side.engine()
        for engine in (piped, serial):
            log.append(engine.deliver_proposals([("s", side.wire(p)) for p in props], NOW))
        a = [call(lambda s: s, x) for x in piped.ingest_votes_pipelined(
            batches, NOW + 5, pre_validated=pre_validated)]
        b = [call(serial.ingest_votes, batch, NOW + 5, pre_validated) for batch in batches]
        log.append([a, b])
        keys = [("s", p.proposal_id) for p in props]
        log.append([snapshot(piped, keys), snapshot(serial, keys)])
        log.append([side.events(-2), side.events(-1)])
    return log


def scenario_mixed(side, seed):
    """A seeded trace mixing every proposal entry point with votes, casts
    and timeouts, on a small pool with a per-scope cap."""
    pkg = side.api.pkg
    rng = np.random.default_rng(seed)
    engine = side.engine(capacity=6, voter_capacity=8, max_sessions=5)
    engine.scope("b").p2p_preset().initialize()
    props = []
    for k in range(8):
        n = int(rng.integers(2, 12))
        p = side.proposal(900 + 20 * seed + k, n, expiry=int(rng.integers(40, 400)),
                          live=bool(rng.random() < 0.5))
        chain = side.grow(p, min(n, int(rng.integers(2, 10))), first=k * 16,
                          choices=rng.random(12) < 0.6)
        props.append(("a" if k % 2 else "b", chain))
    keys = [(scope, chain.proposal_id) for scope, chain in props]

    def variant(chain):
        v = grown(chain, int(rng.integers(0, len(chain.votes) + 1)))
        kind = rng.random()
        if v.votes and kind < 0.12:
            v.votes[int(rng.integers(0, len(v.votes)))].signature = b"\x07" * 32
        elif len(v.votes) > 1 and kind < 0.24:
            i = int(rng.integers(1, len(v.votes)))
            v.votes[i].received_hash = b"\x31" * 32
            side.resign(v.votes[i])
        elif len(v.votes) > 1 and kind < 0.32:
            i = int(rng.integers(0, len(v.votes)))
            v.votes[i] = pkg.build_vote(grown(chain, i), True, side.signer(200 + i), NOW + 30)
        return side.wire(v)

    log = []
    now = NOW
    for step in range(24):
        now += int(rng.integers(0, 30))
        op = rng.random()
        picks = [props[int(rng.integers(0, len(props)))] for _ in range(int(rng.integers(1, 5)))]
        items = [(scope, variant(chain)) for scope, chain in picks]
        if op < 0.35:
            log.append(["deliver", engine.deliver_proposals(items, now)])
        elif op < 0.55:
            log.append(["ingest", engine.ingest_proposals(items, now)])
        elif op < 0.65:
            log.append(["process", call(engine.process_incoming_proposal, *items[0], now)])
        elif op < 0.8:
            scope, chain = picks[0]
            prop = call(engine.get_proposal, scope, chain.proposal_id)
            if isinstance(prop, list):
                log.append(["vote", prop])
            else:
                vote = pkg.build_vote(prop, bool(rng.random() < 0.5),
                                      side.signer(300 + step), now)
                log.append(["vote", call(engine.process_incoming_vote, scope, vote, now)])
        elif op < 0.9:
            scope, chain = picks[0]
            log.append(["cast", call(engine.cast_vote_and_get_proposal, scope,
                                     chain.proposal_id, True, now) is not None])
        else:
            log.append(["sweep", engine.sweep_timeouts(now)])
        log.append(side.events())
    log.append(snapshot(engine, keys))
    return log


# ── Registration in bulk ──────────────────────────────────────────────


def bulk_case(side, case):
    """One bulk-registration case: the engine, the calls before the batch
    (every scope of the first call full at the per-scope cap of 3) and the
    batch."""
    kwargs = dict(capacity=16, voter_capacity=8, max_sessions=3)
    prelude = [(s, side.proposal(900 + 10 * k + j, 4)) for k, s in enumerate("st") for j in range(3)]
    carried_ = [side.grow(side.proposal(200 + k, 4), votes) for k, votes in enumerate((2, 1, 4, 3))]
    if case == "cap":  # more than the cap to one scope: each evicts, then claims the slot freed
        batch = [("s", side.proposal(100 + k, 4)) for k in range(5)]
        batch += [("u", side.proposal(120 + k, 5)) for k in range(4)]
    elif case in ("mixed", "sharded"):  # each vote-carrying row load flushes the writes first
        free = [side.proposal(300 + k, 4) for k in range(5)]
        batch = [("s", free[0]), ("t", carried_[0]), ("s", free[1]), ("s", carried_[1]),
                 ("t", free[2]), ("u", carried_[2]), ("u", free[3]), ("t", carried_[3]),
                 ("s", free[4])]
        if case == "sharded":
            from hashgraph_tpu_torch.parallel.sharded import ShardedPool

            kwargs = dict(pool=ShardedPool(8, 8, mesh=["cpu", "cpu"]), max_sessions=3)
    elif case == "full":  # past the free slots, and wider than the lanes: served on the host
        kwargs["capacity"] = 9
        batch = [(f"v{k}", side.proposal(400 + k, 12 if k == 1 else 4)) for k in range(6)]
        batch += [("s", side.proposal(420, 4)), ("t", carried_[0])]
    else:  # "redelivered": twice in the batch, known before it, and expired
        batch = [("s", side.proposal(500, 4)), ("s", side.proposal(500, 4)),
                 ("s", prelude[1][1]), ("t", side.proposal(501, 4, expiry=3)),
                 ("t", carried_[1]), ("t", carried_[1]), ("u", side.proposal(502, 4)),
                 ("t", side.proposal(503, 4))]
    return side.engine(**kwargs), prelude, batch


def bulk_run(side, case, one_per_call=False, before_batch=None):
    """A bulk case's batch in one ``ingest_proposals`` call, or one call an
    item: statuses, events in order, each key's slot, every pool row and
    the snapshot. ``before_batch(engine)`` runs after the prelude."""
    engine, prelude, batch = bulk_case(side, case)
    w = side.wire
    log = [engine.ingest_proposals([(s, w(p)) for s, p in prelude], NOW + 1), side.events()]
    if before_batch is not None:
        before_batch(engine)
    items = [(s, w(p)) for s, p in batch]
    if one_per_call:
        log.append([engine.ingest_proposals([item], NOW + 5)[0] for item in items])
    else:
        log.append(engine.ingest_proposals(items, NOW + 5))
    keys = sorted({(s, p.proposal_id) for s, p in prelude + batch})
    pool = engine.pool()
    rows = pool.read_slots(list(range(pool.capacity)))
    log += [side.events(), [[s, pid, engine._index.get((s, pid))] for s, pid in keys],
            {name: np.asarray(value).tolist() for name, value in sorted(rows.items())},
            snapshot(engine, keys)]
    return log


BULK_CASES = ("cap", "mixed", "full", "sharded", "redelivered")


def scenario_bulk(side, seed):
    """The bulk cases the JAX package can run (all but the sharded pool),
    each batch in one call."""
    return [bulk_run(side, case) for case in BULK_CASES if case != "sharded"]


SCENARIOS = {
    "deliver": (scenario_deliver, (0,)),
    "ingest": (scenario_ingest, (0, 1)),
    "capacity": (scenario_capacity, (0, 1)),
    "cast": (scenario_cast, (0,)),
    "pipelined": (scenario_pipelined, (0, 1)),
    "mixed": (scenario_mixed, tuple(range(16))),
    "bulk": (scenario_bulk, (0,)),
}
KEYS = [f"{name}-{seed}-{cache}" for name, (_, seeds) in SCENARIOS.items()
        for seed in seeds for cache in CACHES]


def run_all(api):
    out = {}
    for name, (fn, seeds) in SCENARIOS.items():
        for seed in seeds:
            for cache in CACHES:
                with seeded_ids(api, 10_000 + seed):
                    out[f"{name}-{seed}-{cache}"] = fn(Side(api, cache), seed)
    return json.loads(json.dumps(out))


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's results, computed in a fresh interpreter."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    proc = subprocess.run(
        [sys.executable, __file__, "--reference"],
        capture_output=True, text=True, timeout=900, cwd=str(REPO), env=env,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield run_all(port_api())
    finally:
        torch.set_num_threads(prev)


@pytest.mark.parametrize("key", KEYS)
def test_proposals_match_reference(reference, port, key):
    ref_log, port_log = reference[key], port[key]
    assert len(port_log) == len(ref_log)
    for i, (a, b) in enumerate(zip(port_log, ref_log)):
        assert a == b, f"{key} step {i}"


def test_traces_reach_the_paths(port):
    """The traces reach what they are meant to: every proposal status, a
    decision on arrival, host sessions and evictions."""
    from hashgraph_tpu_torch.errors import StatusCode

    flat = json.dumps(port)
    for needle in ("ConsensusReached", "ConsensusFailedEvent", "UserAlreadyVoted",
                   "SessionNotFound", "ProposalAlreadyExist", "ProposalExpired",
                   "InvalidVoteSignature", "ValueError"):
        assert needle in flat, needle
    codes = set()

    def walk(x):
        if isinstance(x, list):
            if x and all(type(v) is int for v in x):
                codes.update(x)
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(port)
    for code in ("OK", "PROPOSAL_ALREADY_EXIST", "PROPOSAL_EXPIRED", "INVALID_VOTE_SIGNATURE",
                 "RECEIVED_HASH_MISMATCH", "PARENT_HASH_MISMATCH", "VOTE_PROPOSAL_ID_MISMATCH",
                 "DUPLICATE_VOTE", "ALREADY_REACHED"):
        assert int(getattr(StatusCode, code)) in codes, code
    capacity = port["capacity-0-None"]
    assert capacity[2]["occupancy"][2] == 2  # the wide and the overflowing session
    assert capacity[1] and capacity[1][0][1] == "ConsensusReached"


@pytest.mark.parametrize("case", BULK_CASES)
def test_bulk_registration_matches_one_per_call(case):
    """One ``ingest_proposals`` call of a batch (its slot writes deferred
    and made at once) against the same items one a call: statuses, events
    in order, slot numbers, every pool row and the snapshot equal."""
    api = port_api()
    runs = []
    for one_per_call in (False, True):
        with seeded_ids(api, 30_000):
            runs.append(json.loads(json.dumps(bulk_run(Side(api, None), case, one_per_call))))
    assert runs[0] == runs[1]
    assert runs[0][2].count(0) >= 2  # some of the batch registered


@pytest.mark.parametrize("case", ("cap", "sharded"))
def test_bulk_registration_under_a_foreign_reader(case):
    """Readers on another thread, which take no lock (the fleet's tally
    reads ``device_state_counts`` so, and ``pool_to_numpy``), run and are
    joined after every slot claim of the batch, while its writes are held:
    they write nothing (every dispatch on the calling thread, one activate
    and at most one release a flush), raise nothing, read a whole pool,
    and the batch's statuses, events, slot numbers, every pool row and the
    snapshot stay equal to one item a call."""
    import threading

    from hashgraph_tpu_torch.convert import pool_to_numpy

    from hashgraph_tpu_torch.tracing import Tracer

    api = port_api()
    callers, reads, tracer = [], [], Tracer(enabled=True)

    def foreign_reads(pool):
        arrays, _ = pool_to_numpy(pool)
        rows = pool.read_slots(list(range(pool.capacity)))
        sizes = {pool.capacity, len(arrays["state"]), len(rows["state"])}
        if hasattr(pool, "device_state_counts"):
            sizes.add(int(pool.device_state_counts().sum()))
        reads.append(sizes)

    def with_foreign_readers(engine):
        engine.tracer = tracer
        pool = engine.pool()
        for name in ("_dispatch_activate", "_dispatch_release"):
            def spy(*args, _name=name, _orig=getattr(pool, name)):
                callers.append((_name, threading.get_ident()))
                return _orig(*args)
            setattr(pool, name, spy)
        allocate = pool.allocate_batch

        def allocate_then_read(*args, **kwargs):
            slots = allocate(*args, **kwargs)
            reader = threading.Thread(target=foreign_reads, args=(pool,))
            reader.start()
            reader.join()
            return slots

        pool.allocate_batch = allocate_then_read

    runs = []
    for hook in (with_foreign_readers, None):
        with seeded_ids(api, 30_000):
            log = bulk_run(Side(api, None), case, before_batch=hook, one_per_call=hook is None)
            runs.append(json.loads(json.dumps(log)))
    assert runs[0] == runs[1]
    assert reads and all(len(sizes) == 1 for sizes in reads)
    assert {ident for _, ident in callers} == {threading.get_ident()}
    flushes = tracer.counters()["engine.register.flushes"]
    assert flushes == 1 if case == "cap" else flushes > 1  # row loads force flushes
    activates = sum(1 for name, _ in callers if name == "_dispatch_activate")
    assert 1 <= activates <= flushes and len(callers) - activates <= flushes


def spy_writes(pool):
    """Count the pool's activate and release dispatches."""
    calls = {"_dispatch_activate": 0, "_dispatch_release": 0}
    for name in calls:
        def spy(*args, _name=name, _orig=getattr(pool, name)):
            calls[_name] += 1
            return _orig(*args)
        setattr(pool, name, spy)
    return calls


@pytest.mark.parametrize("n_items", [1, 8, 40])
def test_bulk_registration_writes_once(n_items):
    """Vote-free proposals into full scopes, each evicting the oldest
    session, every third too wide for the lanes (its eviction a release
    alone): one activate and one release dispatch for the call whatever its
    size, and the tracer's counters read one flush of one slot an item."""
    from hashgraph_tpu_torch.tracing import Tracer

    api = port_api()
    side = Side(api, None)
    with seeded_ids(api, 40_000 + n_items):
        engine = side.engine(capacity=128, voter_capacity=8, max_sessions=2)
        scopes = [f"g{k}" for k in range(n_items)]
        engine.ingest_proposals([(s, side.proposal(1000 + 2 * k + j, 4))
                                 for k, s in enumerate(scopes) for j in range(2)], NOW + 1)
        batch = [(s, side.proposal(5000 + k, 12 if k % 3 == 2 else 4))
                 for k, s in enumerate(scopes)]
        calls = spy_writes(engine.pool())
        engine.tracer = Tracer(enabled=True)
        assert engine.ingest_proposals(batch, NOW + 5) == [0] * n_items
    wide = sum(1 for k in range(n_items) if k % 3 == 2)
    assert calls == {"_dispatch_activate": int(n_items > wide), "_dispatch_release": int(wide > 0)}
    counters = engine.tracer.counters()
    assert counters["engine.register.flushes"] == 1
    assert counters["engine.register.flushed_slots"] == n_items
    assert "engine.register.forced_flushes" not in counters
    assert engine.occupancy()["host_spilled"] == wide


def test_bulk_registration_forced_flush():
    """A vote-carrying proposal's row load inside the batch flushes the
    writes held so far (its own activation among them) before it, and the
    rest go at the loop's end."""
    from hashgraph_tpu_torch.tracing import Tracer

    api = port_api()
    side = Side(api, None)
    with seeded_ids(api, 40_100):
        engine = side.engine(capacity=16, voter_capacity=8, max_sessions=3)
        batch = [("s", side.proposal(10, 4)), ("s", side.grow(side.proposal(11, 4), 2)),
                 ("t", side.proposal(12, 4)), ("t", side.proposal(13, 4))]
        calls = spy_writes(engine.pool())
        engine.tracer = Tracer(enabled=True)
        assert engine.ingest_proposals([(s, side.wire(p)) for s, p in batch], NOW + 5) == [0] * 4
    assert calls == {"_dispatch_activate": 2, "_dispatch_release": 0}
    counters = engine.tracer.counters()
    assert counters["engine.register.flushes"] == 2
    assert counters["engine.register.forced_flushes"] == 1
    assert counters["engine.register.flushed_slots"] == 4


if __name__ == "__main__" and sys.argv[1:] == ["--reference"]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(run_all(reference_api())))
