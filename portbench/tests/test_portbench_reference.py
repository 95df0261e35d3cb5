"""The reference against sessions worked out by hand."""

import pytest

from portbench.reference import engine as ref
from portbench.reference import rules, wire

TWO_THIRDS = 2.0 / 3.0


def node(mode: str, n: int, cap: int = 10, proposals: int = 1):
    table = [(0, 100 + i, 1000, 1060, n, True) for i in range(proposals)]
    return ref.ReferenceNode(table, [mode], TWO_THIRDS, cap)


def test_quorum_43_of_64_and_683_of_1024():
    assert rules.threshold_value(64, TWO_THIRDS) == 43
    assert rules.threshold_value(1024, TWO_THIRDS) == 683
    assert rules.threshold_value(64, TWO_THIRDS, quorum_floor=True) == 42
    assert rules.threshold_value(1024, TWO_THIRDS, quorum_floor=True) == 682


def test_gossipsub_decides_at_the_43rd_yes_of_64():
    nd = node(rules.GOSSIPSUB, 64)
    assert nd.deliver(1000, [0]) == [ref.OK]
    got = nd.columnar(1001, [0] * 44, [100] * 44, list(range(44)), [True] * 44)
    assert got[:43] == [ref.OK] * 43 and got[43] == ref.ALREADY_REACHED
    assert nd.events == [(0, True, 1001), (0, True, 1001)]
    assert nd.result(0) is True


def test_p2p_1024_yes_at_683_with_342_yes_else_fails_on_the_684th():
    nd = node(rules.P2P, 1024, proposals=2)
    nd.deliver(1000, [0, 1])
    values = [True] * 342 + [False] * 341
    assert nd.columnar(1001, [0] * 683, [100] * 683, list(range(683)), values)[-1] == ref.OK
    assert nd.result(0) is True
    values = [True] * 341 + [False] * 342
    got = nd.columnar(1001, [0] * 685, [101] * 685, list(range(685)), values + [True, True])
    assert got[:683] == [ref.OK] * 683
    assert got[683] == ref.MAX_ROUNDS_EXCEEDED and got[684] == ref.SESSION_NOT_ACTIVE
    assert nd.result(1) == "failed"


def test_p2p_round_cap_before_duplicate():
    nd = node(rules.P2P, 64)
    nd.deliver(1000, [0])
    values = [True] * 21 + [False] * 22  # undecided at 43
    nd.columnar(1001, [0] * 43, [100] * 43, list(range(43)), values)
    assert nd.result(0) is None
    # The 44th is a redelivery of voter 0: the round cap comes first.
    assert nd.columnar(1001, [0], [100], [0], [True]) == [ref.MAX_ROUNDS_EXCEEDED]


def test_gossipsub_has_no_round_cap_and_a_tie_goes_to_liveness():
    nd = node(rules.GOSSIPSUB, 64, proposals=2)
    nd.deliver(1000, [0, 1])
    undecided = [False] * 34 + [True] * 30  # silent voters weigh yes while voting
    assert nd.columnar(1001, [0] * 64, [100] * 64, list(range(64)), undecided) == [ref.OK] * 64
    assert nd.result(0) is None
    tie = [False] * 32 + [True] * 32
    nd.columnar(1001, [0] * 64, [101] * 64, list(range(64)), tie)
    assert nd.result(1) is True
    assert rules.decide(32, 64, 64, TWO_THIRDS, liveness_yes=False) == rules.NO


def test_duplicates_expiry_and_eviction_by_age():
    nd = node(rules.GOSSIPSUB, 64, cap=2, proposals=4)
    nd.deliver(1000, [0, 1])
    assert nd.columnar(1001, [0, 0], [100, 100], [5, 5], [True, True]) == [ref.OK, ref.DUPLICATE_VOTE]
    nd.deliver(1001, [2])  # evicts the oldest: proposal 0 and 1 are as old; 1 registered last
    assert nd.columnar(1001, [0, 0], [100, 101], [6, 6], [True, True]) == [ref.OK, ref.SESSION_NOT_FOUND]
    assert nd.deliver(1001, [0]) == [ref.PROPOSAL_ALREADY_EXIST]
    assert nd.columnar(1060, [0], [100], [7], [True]) == [ref.PROPOSAL_EXPIRED]


def test_resolved_path_equals_the_plain_path():
    a, b = node(rules.P2P, 64, proposals=3), node(rules.P2P, 64, proposals=3)
    for nd in (a, b):
        nd.deliver(1000, [0, 1, 2])
    import random

    rng = random.Random(7)
    rows = [(rng.randrange(3), rng.randrange(64), rng.random() < 0.5) for _ in range(400)]
    plain = a.columnar(1001, [0] * 400, [100 + p for p, _, _ in rows], [v for _, v, _ in rows],
                       [x for _, _, x in rows])
    fast = b.columnar_resolved(1001, [p for p, _, _ in rows], [v for _, v, _ in rows],
                               [x for _, _, x in rows])
    assert plain == fast and a.events == b.events


def wire_row(pid, owner, value, received, vhash=None, hash_ok=True, sig_ok=True, ts=1001):
    return {"scope": 0, "proposal_id": pid, "timestamp": ts, "value": value, "owner": owner,
            "received": received, "hash": vhash or bytes([owner[0] + 1]) * 32,
            "hash_ok": hash_ok, "sig_ok": sig_ok}


def test_wire_chain_guard_follows_only_accepted_votes():
    nd = node(rules.GOSSIPSUB, 3)
    nd.deliver(1000, [0])
    a, b, c = (bytes([i]) * 32 for i in (1, 2, 3))
    ha, hb, hc = (bytes([i + 1]) * 32 for i in (1, 2, 3))
    # a, b decide (2 of 3 at n=3); c arrives in the same frame: the guard
    # passes it (its received names b) and the session answers ALREADY_REACHED.
    got = nd.wire(1001, [wire_row(100, a, True, b""), wire_row(100, b, True, ha),
                         wire_row(100, c, True, hb)])
    assert got == [ref.OK, ref.OK, ref.ALREADY_REACHED]
    # A later frame: the tail is b's hash (the last accepted), so a vote
    # chained after c's fails the guard.
    d = bytes([9]) * 32
    assert nd.wire(1002, [wire_row(100, d, True, hc)]) == [ref.RECEIVED_HASH_MISMATCH]


def test_wire_checks_in_upstreams_order():
    nd = node(rules.GOSSIPSUB, 64)
    nd.deliver(1000, [0])
    a = bytes([1]) * 32
    got = nd.wire(1001, [
        wire_row(999, a, True, b""),
        wire_row(100, a, True, b"", hash_ok=False, sig_ok=False),
        wire_row(100, a, True, b"", sig_ok=False),
        wire_row(100, a, True, b"", ts=999),
        wire_row(100, a, True, b"", ts=1061),
    ])
    assert got == [ref.SESSION_NOT_FOUND, ref.INVALID_VOTE_HASH, ref.INVALID_VOTE_SIGNATURE,
                   ref.TIMESTAMP_OLDER_THAN_CREATION_TIME, ref.VOTE_EXPIRED]


def test_wire_format_round_trip_and_hash():
    owner = bytes(range(32))
    h = wire.vote_hash(7, owner, 9, 1_700_000_001, True, b"", b"\x05" * 32)
    payload = wire.signed_fields(7, owner, 9, 1_700_000_001, True, b"", b"\x05" * 32, h)
    vote = wire.decode(wire.with_signature(payload, b"\x11" * 64))
    assert vote["payload"] == payload and vote["signature"] == b"\x11" * 64
    assert (vote["vote_id"], vote["owner"], vote["proposal_id"], vote["timestamp"], vote["value"]) == (
        7, owner, 9, 1_700_000_001, True)
    assert vote["hash"] == h and vote["received"] == b"\x05" * 32


def test_wire_format_matches_the_programs_encoder():
    from hashgraph_tpu_torch.protocol import compute_vote_hash
    from hashgraph_tpu_torch.wire import Vote

    owner = bytes(range(32))
    v = Vote(vote_id=123456, vote_owner=owner, proposal_id=2**32 - 5, timestamp=1_700_000_001,
             vote=False, parent_hash=b"", received_hash=b"\x07" * 32, vote_hash=b"", signature=b"")
    v.vote_hash = compute_vote_hash(v)
    v.signature = b"\x22" * 64
    assert v.vote_hash == wire.vote_hash(123456, owner, 2**32 - 5, 1_700_000_001, False, b"", b"\x07" * 32)
    assert v.encode() == wire.with_signature(
        wire.signed_fields(123456, owner, 2**32 - 5, 1_700_000_001, False, b"", b"\x07" * 32,
                           v.vote_hash), v.signature)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64])
def test_decide_matches_the_programs_scalar_rule(n):
    from hashgraph_tpu_torch.protocol import decide

    for liveness in (True, False):
        for timeout in (True, False):
            for total in range(n + 1):
                for yes in range(total + 1):
                    got = rules.decide(yes, total, n, TWO_THIRDS, liveness, timeout)
                    want = decide(yes, total, n, TWO_THIRDS, liveness, timeout)
                    assert got == {None: rules.UNDECIDED, True: rules.YES, False: rules.NO}[want]
