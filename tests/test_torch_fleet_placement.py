"""Parity: placement of the port's scope-sharded fleet
(``hashgraph_tpu_torch.parallel.fleet``) against the JAX package's.

Twins of ``tests/test_fleet_placement.py`` (golden assignments included),
on the port, and one cross-package test: ``rendezvous_owner`` and
``ScopePlacement.owner`` over 10,000 seeded scopes (str, bytes and int)
and shard sets of 1–16 members, plus one membership history, give the
JAX package's owner for every scope (tolerance: exact). Placement is
pure host-side hashing, so both packages run in this process.

The original's notes:

Two load-bearing properties:

- **Restart stability**: scope→shard assignment is a pure function of the
  (scope bytes, shard-id set) — no dependence on Python's randomized
  ``hash()``, process state, or insertion order. Pinned golden values
  catch an accidental algorithm change; a subprocess check proves a fresh
  interpreter (different PYTHONHASHSEED) computes identical placements.
- **Rendezvous invariant**: removing a shard remaps ONLY the scopes it
  owned; adding a shard moves scopes ONLY onto the new shard. This is
  what makes peer-set membership elastic — a resize never reshuffles
  unrelated scopes' traffic.

Pure host-side hashing: no devices.
"""

import random
import subprocess
import sys

import pytest

from hashgraph_tpu.parallel import fleet as ref_fleet
from hashgraph_tpu_torch.parallel.fleet import ScopePlacement, rendezvous_owner

SCOPES = [f"scope-{i}" for i in range(200)]


# ── Restart stability ──────────────────────────────────────────────────

# Golden assignments pinned at introduction: a change here is a placement
# algorithm change, which REMAPS EVERY DEPLOYED FLEET'S TRAFFIC — bump
# only with a migration story.
GOLDEN_4 = {
    "alpha": "shard-0",
    "beta": "shard-1",
    "gamma": "shard-0",
    "delta": "shard-2",
    "orders": "shard-1",
    "payments": "shard-3",
}


def test_golden_assignments_pinned():
    ids = ["shard-0", "shard-1", "shard-2", "shard-3"]
    assert {s: rendezvous_owner(s, ids) for s in GOLDEN_4} == GOLDEN_4


def test_assignment_ignores_shard_list_order():
    ids = ["shard-0", "shard-1", "shard-2", "shard-3"]
    for scope in SCOPES[:50]:
        assert rendezvous_owner(scope, ids) == rendezvous_owner(
            scope, list(reversed(ids))
        )


def test_shard_ids_longer_than_blake2b_key_are_rejected():
    """blake2b keys cap at 64 bytes: two ids sharing a 64-byte prefix
    would silently tie on EVERY scope (one shard starves). Must be a
    construction-time error, not a silent truncation."""
    long_a = "rack-" + "x" * 70 + "-a"
    assert len(long_a.encode()) > 64
    with pytest.raises(ValueError, match="64 bytes"):
        rendezvous_owner("s", ["ok", long_a])
    with pytest.raises(ValueError, match="64 bytes"):
        ScopePlacement([long_a])
    placement = ScopePlacement(["a", "b"])
    with pytest.raises(ValueError, match="64 bytes"):
        placement.add_shard(long_a)
    # 64 bytes exactly is fine.
    edge = "y" * 64
    assert rendezvous_owner("s", ["a", edge]) in ("a", edge)


def test_scope_types_are_canonicalized():
    ids = ["a", "b", "c"]
    # str/bytes/int canonical forms are distinct namespaces (multihost
    # _canonical_scope_bytes discipline), each deterministic.
    assert rendezvous_owner("7", ids) == rendezvous_owner("7", ids)
    assert rendezvous_owner(7, ids) == rendezvous_owner(7, ids)
    with pytest.raises(TypeError):
        rendezvous_owner(object(), ids)
    with pytest.raises(ValueError):
        rendezvous_owner("s", [])


def test_placement_stable_across_process_restart():
    """A fresh interpreter (fresh PYTHONHASHSEED) must compute the exact
    same 200-scope placement — the property that lets two peers (or one
    peer before and after a restart) route without coordination."""
    ids = ["shard-0", "shard-1", "shard-2", "shard-3", "shard-4"]
    local = ",".join(rendezvous_owner(s, ids) for s in SCOPES)
    script = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from hashgraph_tpu_torch.parallel.fleet import rendezvous_owner\n"
        f"ids = {ids!r}\n"
        f"scopes = [f'scope-{{i}}' for i in range(200)]\n"
        "print(','.join(rendezvous_owner(s, ids) for s in scopes))\n"
    )
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", script, repo],
        capture_output=True,
        text=True,
        check=True,
        env={**os.environ, "PYTHONHASHSEED": "12345"},
    )
    assert out.stdout.strip() == local


# ── Rendezvous invariant ───────────────────────────────────────────────


@pytest.mark.parametrize("n_shards", [2, 3, 5, 9])
def test_remove_shard_remaps_only_its_scopes(n_shards):
    ids = [f"shard-{k}" for k in range(n_shards)]
    before = {s: rendezvous_owner(s, ids) for s in SCOPES}
    for removed in ids:
        survivors = [sid for sid in ids if sid != removed]
        for scope in SCOPES:
            after = rendezvous_owner(scope, survivors)
            if before[scope] != removed:
                # Not owned by the removed shard: owner unchanged.
                assert after == before[scope], (scope, removed)
            else:
                assert after != removed


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_add_shard_moves_scopes_only_onto_new_shard(n_shards):
    ids = [f"shard-{k}" for k in range(n_shards)]
    before = {s: rendezvous_owner(s, ids) for s in SCOPES}
    grown = ids + ["shard-new"]
    moved = 0
    for scope in SCOPES:
        after = rendezvous_owner(scope, grown)
        if after != before[scope]:
            assert after == "shard-new", scope
            moved += 1
    if n_shards <= 4:
        # Expected steal fraction is 1/(n+1); with 200 scopes the count
        # being zero would itself be a red flag for the hash spreading.
        assert moved > 0


def test_distribution_is_roughly_balanced():
    ids = [f"shard-{k}" for k in range(4)]
    counts = {sid: 0 for sid in ids}
    for scope in SCOPES:
        counts[rendezvous_owner(scope, ids)] += 1
    # 200 scopes over 4 shards: E=50 per shard; a keyed-64-bit-digest HRW
    # should not be wildly skewed (loose 3x bound, not a chi-square test).
    assert all(15 <= c <= 110 for c in counts.values()), counts


# ── ScopePlacement wrapper ─────────────────────────────────────────────


def test_scope_placement_membership_and_cache():
    placement = ScopePlacement(["a", "b"])
    owners = {s: placement.owner(s) for s in SCOPES[:40]}
    # Memoized: repeat lookups agree.
    assert {s: placement.owner(s) for s in SCOPES[:40]} == owners
    placement.add_shard("c")
    for scope, prior in owners.items():
        after = placement.owner(scope)
        assert after in ("c", prior)  # rendezvous invariant through the API
    with pytest.raises(ValueError):
        placement.add_shard("c")
    placement.remove_shard("c")
    assert {s: placement.owner(s) for s in SCOPES[:40]} == owners
    with pytest.raises(ValueError):
        placement.remove_shard("zz")
    placement.remove_shard("b")
    with pytest.raises(ValueError):
        placement.remove_shard("a")  # never below one shard
    with pytest.raises(ValueError):
        ScopePlacement([])


# ── Cross-package: every owner equals the JAX package's ───────────────


def seeded_scopes(seed, n):
    """``n`` seeded scope ids: str, bytes and int, as the engine takes."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        kind = rng.randrange(3)
        if kind == 0:
            out.append("".join(rng.choice("abcxyz-:_0123456789é") for _ in range(rng.randint(0, 24))))
        elif kind == 1:
            out.append(rng.randbytes(rng.randint(0, 32)))
        else:
            out.append(rng.randint(-(2**63), 2**63))
    return out


def test_rendezvous_owner_matches_reference_over_10000_scopes():
    scopes = seeded_scopes(0, 10_000)
    rng = random.Random(1)
    for n_shards in range(1, 17):
        ids = [rng.choice(["shard-", "host:", "r", ""]) + str(k) for k in range(n_shards)]
        ids = list(dict.fromkeys(ids))
        rng.shuffle(ids)
        got = [rendezvous_owner(s, ids) for s in scopes]
        want = [ref_fleet.rendezvous_owner(s, ids) for s in scopes]
        assert got == want, n_shards


def test_scope_placement_history_matches_reference():
    """One membership history (adds, removes, evictions) through both
    packages' ``ScopePlacement``: every lookup equal, the memo included."""
    scopes = seeded_scopes(2, 10_000)
    rng = random.Random(3)
    ours, theirs = ScopePlacement(["shard-0", "shard-1"]), ref_fleet.ScopePlacement(
        ["shard-0", "shard-1"])
    next_id = 2
    for step in range(24):
        action = rng.random()
        if action < 0.45:
            sid = f"shard-{next_id}"
            next_id += 1
            ours.add_shard(sid)
            theirs.add_shard(sid)
        elif action < 0.75 and len(ours.shard_ids) > 1:
            sid = rng.choice(ours.shard_ids)
            ours.remove_shard(sid)
            theirs.remove_shard(sid)
        else:
            for scope in rng.sample(scopes, 50):
                ours.evict(scope)
                theirs.evict(scope)
        assert ours.shard_ids == theirs.shard_ids
        sample = scopes if step % 8 == 7 else rng.sample(scopes, 1_000)
        assert [ours.owner(s) for s in sample] == [theirs.owner(s) for s in sample], step
