"""The port's VerifiedVoteCache and its use by TorchConsensusEngine.

The cases of ``tests/test_verify_cache.py`` for the class (bounds, LRU
policy, negative verdicts, the admission key, which must equal the JAX
package's byte for byte), the engine integration with a stub scheme that
counts its verifications (in-batch dedup, the scalar path, poisoning,
scheme isolation, no signature work for identical redeliveries and expired
chains or extensions), and cache on against cache off on the same traffic
(``TestCacheOnOffEquivalence``'s shape, tolerance: exact). Stub signatures
only; every engine runs with ``device="cpu"``.
"""

import random
import threading

import numpy as np
import pytest
import torch

from hashgraph_tpu.engine.engine import hashlib_sha256_8
from hashgraph_tpu.engine.verify_cache import VerifiedVoteCache as RefCache
from hashgraph_tpu.signing import StubConsensusSigner as RefStub
from hashgraph_tpu_torch import (
    CreateProposalRequest,
    Ed25519ConsensusSigner,
    StubConsensusSigner,
    TorchConsensusEngine,
    build_vote,
)
from hashgraph_tpu_torch import protocol
from hashgraph_tpu_torch.engine.engine import _scheme_tag
from hashgraph_tpu_torch.engine.verify_cache import _ENTRY_OVERHEAD, MISS, VerifiedVoteCache
from hashgraph_tpu_torch.errors import ConsensusSchemeError, StatusCode
from hashgraph_tpu_torch.protocol import compute_vote_hash
from hashgraph_tpu_torch.wire import Proposal

NOW = 1_700_000_000
OK = int(StatusCode.OK)
EXISTS = int(StatusCode.PROPOSAL_ALREADY_EXIST)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class CountingSigner(StubConsensusSigner):
    """Stub scheme that counts class-level verify calls (verify_batch
    loops over verify, so one counter covers both)."""

    calls = 0

    @classmethod
    def verify(cls, identity, payload, signature):
        cls.calls += 1
        return super().verify(identity, payload, signature)


@pytest.fixture(autouse=True)
def _reset_counter():
    CountingSigner.calls = 0


def make_engine(cache="default", signer=None, voters=8, per_scope=10):
    return TorchConsensusEngine(
        signer if signer is not None else CountingSigner(b"\x77" * 20),
        32, voters, verify_cache=cache, device="cpu", max_sessions_per_scope=per_scope,
    )


def make_proposal(engine, n=6, scope="s", expiry=10_000):
    return engine.create_proposal(
        scope,
        CreateProposalRequest(name="p", payload=b"x", proposal_owner=b"o",
                              expected_voters_count=n, expiration_timestamp=expiry,
                              liveness_criteria_yes=True),
        NOW,
    )


def sender_chain(n_votes=3, n=6, expiry=10_000):
    sender = make_engine()
    proposal = make_proposal(sender, n=n, scope="src", expiry=expiry)
    chain = proposal.clone()
    for i in range(n_votes):
        chain.votes.append(build_vote(chain, True, CountingSigner(bytes([i + 1]) * 20), NOW + i))
    return proposal, chain


def grown(chain, k):
    p = chain.clone()
    p.votes = [v.clone() for v in chain.votes[:k]]
    return p


def cache_counts():
    """The cache counters on the port's process-wide registry, as a
    function that gives their change since this call (the registry is
    shared by every cache and test in the process)."""
    from hashgraph_tpu_torch import obs

    names = {
        "hits": obs.VERIFY_CACHE_HITS_TOTAL,
        "misses": obs.VERIFY_CACHE_MISSES_TOTAL,
        "negative_hits": obs.VERIFY_CACHE_NEGATIVE_HITS_TOTAL,
        "evictions": obs.VERIFY_CACHE_EVICTIONS_TOTAL,
    }
    before = {k: obs.registry.counter(n).value for k, n in names.items()}
    return lambda: {
        k: obs.registry.counter(n).value - before[k] for k, n in names.items()
    }


# ── The class ─────────────────────────────────────────────────────────


def test_roundtrip_and_miss():
    counts = cache_counts()
    cache = VerifiedVoteCache(max_entries=4)
    assert cache.get(b"k1") is MISS
    cache.put(b"k1", True)
    assert cache.get(b"k1") is True
    err = ConsensusSchemeError.verify("bad")
    cache.put(b"k2", err)
    assert cache.get(b"k2") is err
    cache.put(b"k3", False)
    assert cache.get(b"k3") is False
    stats = counts()
    assert (stats["hits"], stats["misses"], stats["negative_hits"]) == (3, 1, 2)


def test_entry_cap_evicts_lru():
    counts = cache_counts()
    cache = VerifiedVoteCache(max_entries=3)
    for k in (b"a", b"b", b"c"):
        cache.put(k, True)
    cache.get(b"a")  # refresh: "b" becomes the LRU victim
    cache.put(b"d", True)
    assert len(cache) == 3
    assert cache.get(b"b") is MISS
    assert cache.get(b"a") is True
    assert counts()["evictions"] == 1


def test_byte_cap_evicts():
    per_entry = 8 + _ENTRY_OVERHEAD
    counts = cache_counts()
    cache = VerifiedVoteCache(max_entries=1000, max_bytes=3 * per_entry)
    for i in range(10):
        cache.put(b"key%05d" % i, True)
    assert len(cache) <= 3
    assert cache.bytes_used <= 3 * per_entry
    assert cache.get(b"key00009") is True
    assert counts()["evictions"] == 7


def test_overwrite_does_not_leak_bytes():
    cache = VerifiedVoteCache(max_entries=8)
    for _ in range(100):
        cache.put(b"same-key", True)
    assert len(cache) == 1
    assert cache.bytes_used == 8 + _ENTRY_OVERHEAD


def test_invalid_bounds_rejected():
    with pytest.raises(ValueError):
        VerifiedVoteCache(max_entries=0)
    with pytest.raises(ValueError):
        VerifiedVoteCache(max_bytes=0)


def test_clear_and_stats():
    cache = VerifiedVoteCache(max_entries=8, max_bytes=10_000)
    cache.put(b"k", True)
    stats = cache.stats()
    assert stats["entries"] == 1 and stats["max_bytes"] == 10_000
    cache.clear()
    assert len(cache) == 0 and cache.bytes_used == 0


def test_get_many_counts_like_get():
    counts = cache_counts()
    cache = VerifiedVoteCache(max_entries=8)
    cache.put_many([(b"t", True), (b"f", False)])
    assert cache.get_many([b"t", b"f", b"x", b"t"]) == [True, False, MISS, True]
    stats = counts()
    assert (stats["hits"], stats["misses"], stats["negative_hits"]) == (3, 1, 1)


def test_concurrent_put_get_stays_bounded():
    counts = cache_counts()
    cache = VerifiedVoteCache(max_entries=64)
    errors = []

    def worker(seed):
        try:
            for i in range(500):
                cache.put(b"%d-%d" % (seed, i % 100), bool(i % 2))
                cache.get(b"%d-%d" % ((seed + 1) % 4, i % 100))
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(cache) <= 64
    stats = counts()
    assert stats["hits"] + stats["misses"] == 8 * 500  # no lost update


@pytest.mark.parametrize("seed", range(4))
def test_key_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        parts = [bytes(rng.integers(0, 256, int(rng.integers(0, 80)), np.uint8))
                 for _ in range(3)]
        assert VerifiedVoteCache.key(*parts) == RefCache.key(*parts)


def test_key_is_fixed_size_framed_digest():
    k = VerifiedVoteCache.key(b"payload", b"sig", b"tag")
    assert len(k) == 32
    assert k == VerifiedVoteCache.key(b"payload", b"sig", b"tag")
    assert k != VerifiedVoteCache.key(b"payload", b"sig", b"other")
    assert k != VerifiedVoteCache.key(b"other", b"sig", b"tag")
    assert k != VerifiedVoteCache.key(b"payload", b"other", b"tag")
    assert VerifiedVoteCache.key(b"b", b"", b"a") != VerifiedVoteCache.key(b"ab", b"", b"")
    assert VerifiedVoteCache.key(b"a", b"b", b"") != VerifiedVoteCache.key(b"", b"ab", b"")


def test_scheme_tag_namespaces_the_two_packages():
    """The tag is the JAX engine's rule over the port's module path, so a
    stub verdict of one package is never the other's."""
    tag = _scheme_tag(StubConsensusSigner)
    assert len(tag) == 8
    assert tag == hashlib_sha256_8(b"hashgraph_tpu_torch.signing.stub.StubConsensusSigner")
    assert tag != hashlib_sha256_8(f"{RefStub.__module__}.{RefStub.__qualname__}".encode())
    assert tag != _scheme_tag(Ed25519ConsensusSigner)


# ── The engine ────────────────────────────────────────────────────────


def test_redelivered_vote_verified_once():
    engine = make_engine()
    proposal = make_proposal(engine)
    vote = build_vote(proposal, True, CountingSigner(b"\x01" * 20), NOW + 1)
    CountingSigner.calls = 0
    counts = cache_counts()
    engine.process_incoming_vote("s", vote.clone(), NOW + 2)
    assert CountingSigner.calls == 1
    [code] = engine.ingest_votes([("s", vote.clone())], NOW + 3)
    assert CountingSigner.calls == 1
    assert int(code) == int(StatusCode.DUPLICATE_VOTE)
    assert counts()["hits"] == 1


def test_in_batch_dedup_single_verify():
    engine = make_engine()
    proposal = make_proposal(engine)
    vote = build_vote(proposal, True, CountingSigner(b"\x01" * 20), NOW + 1)
    CountingSigner.calls = 0
    statuses = engine.ingest_votes([("s", vote.clone()) for _ in range(5)], NOW + 2)
    assert CountingSigner.calls == 1
    assert int(statuses[0]) == OK
    assert all(int(s) != OK for s in statuses[1:])


def test_negative_verdict_cached():
    engine = make_engine()
    proposal = make_proposal(engine)
    vote = build_vote(proposal, True, CountingSigner(b"\x01" * 20), NOW + 1)
    vote.signature = b"\x00" * 32
    CountingSigner.calls = 0
    counts = cache_counts()
    for _ in range(3):
        [code] = engine.ingest_votes([("s", vote.clone())], NOW + 2)
        assert int(code) == int(StatusCode.INVALID_VOTE_SIGNATURE)
    assert CountingSigner.calls == 1
    assert counts()["negative_hits"] == 2


def test_forged_signature_cannot_poison_good_vote():
    engine = make_engine()
    proposal = make_proposal(engine)
    good = build_vote(proposal, True, CountingSigner(b"\x01" * 20), NOW + 1)
    forged = good.clone()
    forged.signature = b"\xff" * 32
    [code] = engine.ingest_votes([("s", forged)], NOW + 2)
    assert int(code) == int(StatusCode.INVALID_VOTE_SIGNATURE)
    [code] = engine.ingest_votes([("s", good)], NOW + 2)
    assert int(code) == OK


def test_collision_twin_cannot_inherit_cached_verdict():
    """Swapping bytes between parent_hash and received_hash keeps the vote
    hash but changes the signed bytes: the twin is a miss and is rejected."""
    engine = make_engine()
    proposal = make_proposal(engine)
    first = build_vote(proposal, True, CountingSigner(b"\x01" * 20), NOW + 1)
    chain = proposal.clone()
    chain.votes.append(first.clone())
    honest = build_vote(chain, True, CountingSigner(b"\x02" * 20), NOW + 2)
    assert honest.parent_hash == b"" and honest.received_hash == first.vote_hash
    crafted = honest.clone()
    crafted.parent_hash, crafted.received_hash = honest.received_hash, honest.parent_hash
    assert compute_vote_hash(crafted) == compute_vote_hash(honest)
    assert crafted.signing_payload() != honest.signing_payload()
    statuses = engine.ingest_votes([("s", first.clone()), ("s", honest.clone())], NOW + 3)
    assert [int(s) for s in statuses] == [OK, OK]
    [code] = engine.ingest_votes([("s", crafted)], NOW + 3)
    assert int(code) == int(StatusCode.INVALID_VOTE_SIGNATURE)


def test_tampered_hash_field_not_cached():
    engine = make_engine()
    proposal = make_proposal(engine)
    vote = build_vote(proposal, True, CountingSigner(b"\x01" * 20), NOW + 1)
    bad = vote.clone()
    bad.vote_hash = b"\x01" * 32
    [code] = engine.ingest_votes([("s", bad)], NOW + 2)
    assert int(code) == int(StatusCode.INVALID_VOTE_HASH)
    assert len(engine.verify_cache()) == 0
    [code] = engine.ingest_votes([("s", vote.clone())], NOW + 2)
    assert int(code) == OK


def test_unknown_string_sentinel_rejected():
    with pytest.raises(ValueError):
        make_engine("shared")
    assert make_engine(None).verify_cache() is None
    shared = VerifiedVoteCache()
    assert make_engine(shared).verify_cache() is shared


def test_shared_cache_across_engines():
    shared = VerifiedVoteCache()
    a = make_engine(shared)
    b = make_engine(shared, signer=CountingSigner(b"\x78" * 20))
    proposal = make_proposal(a)
    b.process_incoming_proposal("s", Proposal.decode(proposal.encode()), NOW)
    vote = build_vote(proposal, True, CountingSigner(b"\x01" * 20), NOW + 1)
    CountingSigner.calls = 0
    a.process_incoming_vote("s", vote.clone(), NOW + 2)
    b.process_incoming_vote("s", vote.clone(), NOW + 2)
    assert CountingSigner.calls == 1


def test_shared_cache_isolates_schemes():
    class RejectingSigner(StubConsensusSigner):
        @classmethod
        def verify(cls, identity, payload, signature):
            return False

    shared = VerifiedVoteCache()
    accepting = make_engine(shared)
    rejecting = make_engine(shared, signer=RejectingSigner(b"\x79" * 20))
    proposal = make_proposal(accepting)
    rejecting.process_incoming_proposal("s", Proposal.decode(proposal.encode()), NOW)
    vote = build_vote(proposal, True, CountingSigner(b"\x01" * 20), NOW + 1)
    accepting.process_incoming_vote("s", vote.clone(), NOW + 2)
    assert len(shared) >= 1
    [code] = rejecting.ingest_votes([("s", vote.clone())], NOW + 2)
    assert int(code) == int(StatusCode.INVALID_VOTE_SIGNATURE)


def test_process_incoming_proposal_consults_the_cache():
    shared = VerifiedVoteCache()
    _, chain = sender_chain(4)
    first, second = make_engine(shared), make_engine(shared)
    CountingSigner.calls = 0
    first.process_incoming_proposal("s", chain.clone(), NOW + 10)
    assert CountingSigner.calls == 4
    second.process_incoming_proposal("s", chain.clone(), NOW + 10)
    assert CountingSigner.calls == 4


def test_expired_proposal_batch_buys_no_crypto():
    proposal, chain = sender_chain()
    receiver = make_engine()
    CountingSigner.calls = 0
    late = proposal.expiration_timestamp + 1
    assert receiver.ingest_proposals([("s", chain.clone())], late) == [
        int(StatusCode.PROPOSAL_EXPIRED)]
    assert CountingSigner.calls == 0
    assert len(receiver.verify_cache()) == 0


def test_ingest_proposals_dedups_across_chains():
    _, chain = sender_chain()
    receiver = make_engine()
    CountingSigner.calls = 0
    assert receiver.ingest_proposals([("a", chain.clone()), ("b", chain.clone())],
                                     NOW + 10) == [OK, OK]
    assert CountingSigner.calls == 3


@pytest.mark.parametrize("cache", ["default", None])
def test_redelivered_proposal_skips_all_verification(cache):
    _, chain = sender_chain()
    receiver = make_engine(cache)
    assert receiver.ingest_proposals([("s", chain.clone())], NOW + 10) == [OK]
    CountingSigner.calls = 0
    assert receiver.ingest_proposals([("s", chain.clone())], NOW + 11) == [EXISTS]
    assert receiver.deliver_proposals([("s", chain.clone()), ("s", grown(chain, 2))],
                                      NOW + 11) == [EXISTS, EXISTS]
    assert CountingSigner.calls == 0


@pytest.mark.parametrize("cache", ["default", None])
def test_expired_extension_submits_no_signature(cache):
    proposal, chain = sender_chain(6, n=12)
    receiver = make_engine(cache, voters=16)
    assert receiver.deliver_proposal("s", grown(chain, 3), NOW + 20) == OK
    cached = len(receiver.verify_cache()) if cache else 0
    CountingSigner.calls = 0
    late = proposal.expiration_timestamp + 1
    assert receiver.deliver_proposals([("s", grown(chain, 6))], late) == [
        int(StatusCode.PROPOSAL_EXPIRED)]
    assert CountingSigner.calls == 0
    assert (len(receiver.verify_cache()) if cache else 0) == cached
    assert len(receiver.get_proposal("s", chain.proposal_id).votes) == 3


def test_extension_verifies_only_the_suffix():
    _, chain = sender_chain(6, n=12)
    receiver = make_engine(None, voters=16)
    assert receiver.deliver_proposal("s", grown(chain, 2), NOW + 20) == OK
    CountingSigner.calls = 0
    assert receiver.deliver_proposal("s", grown(chain, 5), NOW + 21) == OK
    assert CountingSigner.calls == 3


@pytest.mark.parametrize("cache", ["default", None])
def test_extensions_of_one_call_verify_in_one_batch(cache):
    """deliver_proposals submits the suffixes of every known key in one
    verify batch, and nothing but the suffixes; with the cache on, the
    chains of unknown keys join that batch, and without it each run of
    unknown keys submits its own."""
    submits = []

    class Recording(CountingSigner):
        @classmethod
        def verify_batch_submit(cls, identities, payloads, signatures):
            submits.append(len(identities))
            return super().verify_batch_submit(identities, payloads, signatures)

    chains = [sender_chain(5, n=12)[1] for _ in range(4)]
    receiver = make_engine(cache, signer=Recording(b"\x55" * 20), voters=16)
    assert receiver.ingest_proposals([("s", grown(c, 2)) for c in chains[:3]],
                                     NOW + 20) == [OK] * 3
    submits.clear()
    order = [chains[0], chains[3], chains[1], chains[2]]
    assert receiver.deliver_proposals([("s", grown(c, 5)) for c in order], NOW + 21) == [OK] * 4
    assert submits == ([14] if cache else [9, 5])
    for c in chains:
        assert ([v.vote_hash for v in receiver.get_proposal("s", c.proposal_id).votes]
                == [v.vote_hash for v in c.votes])


def _forked(chain, k):
    p = grown(chain, k)
    p.votes[1] = build_vote(grown(chain, 1), False, CountingSigner(b"\x66" * 20), NOW + 9)
    return p


# Per case: the calls that set the receiver up, then one deliver_proposals
# call; chain indices into [a, b, c, d], d expiring before the call.
BATCH_CASES = {
    "repeated": ([[(0, 2)], [(1, 2)]], [(0, 4), (1, 3), (0, 6), (1, 3), (0, 5)]),
    "expired": ([[(0, 2), (3, 2)]], [(3, 5), (0, 4), (3, 6)]),
    "evicted": ([[(0, 2)], [(1, 2)]], [(2, 3), (0, 4), (1, 4), (0, 6)]),
    "forked": ([[(0, 3), (1, 2)]], [("fork", 4), (1, 4), (0, 5)]),
    "unknown first": ([[(1, 2)]], [(0, 3), (1, 5), (0, 6), (2, 2)]),
}


@pytest.mark.parametrize("cache", ["default", None])
@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batched_extensions_equal_one_by_one(cache, case):
    """One deliver_proposals call gives the statuses, events, sessions and
    votes of the same deliveries made one call each: repeated keys, an
    expired session, a session an earlier item evicts (two sessions a
    scope), a fork, and unknown keys before known ones."""
    setup, call = BATCH_CASES[case]
    chains = [sender_chain(6, n=12)[1] for _ in range(3)]
    chains.append(sender_chain(6, n=12, expiry=25)[1])
    now = NOW + 30

    def item(ref):
        k, n = ref
        return ("s", _forked(chains[0], n) if k == "fork" else grown(chains[k], n))

    out = []
    for one_by_one in (False, True):
        receiver = make_engine(cache, voters=16, per_scope=2)
        rx = receiver.event_bus().subscribe()
        for t, refs in enumerate(setup):
            assert receiver.ingest_proposals([item(r) for r in refs], NOW + 20 + t) == (
                [OK] * len(refs))
        items = [item(r) for r in call]
        if one_by_one:
            codes = [receiver.deliver_proposal(scope, p, now) for scope, p in items]
        else:
            codes = receiver.deliver_proposals(items, now)
        sessions = []
        for c in chains:
            try:
                sessions.append((receiver.get_consensus_result("s", c.proposal_id),
                                 [v.vote_hash for v in receiver.get_proposal(
                                     "s", c.proposal_id).votes]))
            except Exception as exc:
                sessions.append(type(exc).__name__)
        events = []
        while (ev := rx.try_recv()) is not None:
            events.append((ev[0], type(ev[1]).__name__, ev[1].proposal_id, ev[1].timestamp))
        stats = receiver.get_scope_stats("s")
        out.append((codes, sessions, events, (stats.total_sessions, stats.active_sessions)))
    assert out[0] == out[1]
    assert any(code == OK for code in out[0][0])


@pytest.mark.parametrize("n_votes", [3, 5])
def test_cache_on_equals_off(n_votes):
    """Grow a chain delivery by delivery, redeliver it whole and through
    the vote path, process it on a fresh engine: cache-on and cache-off
    engines report identical statuses and end in identical sessions."""
    _, chain = sender_chain(n_votes, n=8)
    results = {}
    for cache in ("default", None):
        receiver = make_engine(cache)
        rx = receiver.event_bus().subscribe()
        codes = [receiver.deliver_proposal("s", grown(chain, k), NOW + 20)
                 for k in range(1, n_votes + 1)]
        codes.append(receiver.deliver_proposal("s", chain.clone(), NOW + 21))
        codes.append([int(s) for s in receiver.ingest_votes(
            [("s", v.clone()) for v in chain.votes], NOW + 30)])
        ids = random.Random(n_votes)  # the cast vote's id, the same on both
        protocol.set_id_entropy(lambda: ids.getrandbits(128))
        try:
            codes.append(receiver.cast_vote_and_get_proposal("s", chain.proposal_id, True,
                                                             NOW + 31).round)
        finally:
            protocol.set_id_entropy(None)
        other = make_engine(cache)
        try:
            other.process_incoming_proposal("s", chain.clone(), NOW + 40)
            codes.append("ok")
        except Exception as exc:
            codes.append(type(exc).__name__)
        events = []
        while (item := rx.try_recv()) is not None:
            events.append((item[0], type(item[1]).__name__, item[1].timestamp))
        results[cache] = (
            codes,
            [v.vote_hash for v in receiver.get_proposal("s", chain.proposal_id).votes],
            receiver.get_consensus_result("s", chain.proposal_id),
            other.get_consensus_result("s", chain.proposal_id),
            events,
        )
    assert results["default"] == results[None]
    assert results[None][0][:n_votes] == [OK] * n_votes


def test_pipelined_prepass_runs_before_the_previous_batch_applies():
    """ingest_votes_pipelined submits batch k+1's verify before batch k
    applies: with a scheme that records the order of submits and applies,
    the second submit comes first."""
    order = []

    class Recording(StubConsensusSigner):
        @classmethod
        def verify_batch_submit(cls, identities, payloads, signatures):
            order.append(("submit", len(identities)))
            return super().verify_batch_submit(identities, payloads, signatures)

    engine = make_engine(signer=Recording(b"\x55" * 20))
    proposal = make_proposal(engine, n=8)
    shadow = proposal.clone()
    batches = []
    for b in range(3):
        batch = []
        for k in range(2):
            vote = build_vote(shadow, True, StubConsensusSigner(bytes([10 * b + k + 1]) * 20),
                              NOW + 1)
            shadow.votes.append(vote)
            batch.append(("s", vote))
        batches.append(batch)
    real_ingest = engine.ingest_votes

    def ingest(items, now, pre_validated=False, **kw):
        order.append(("apply", len(items)))
        return real_ingest(items, now, pre_validated, **kw)

    engine.ingest_votes = ingest
    out = engine.ingest_votes_pipelined(batches, NOW + 2)
    assert [s.tolist() for s in out] == [[OK, OK], [OK, OK], [OK, OK]]
    assert [kind for kind, _ in order] == ["submit", "submit", "apply", "submit", "apply",
                                           "apply"]
