"""Parity: the port's two-level (host, shard) placement
(``hashgraph_tpu_torch.parallel.federation.FederationPlacement``) against
the JAX package's.

Twins of ``tests/test_federation_placement.py`` (golden assignments
included), on the port, and one cross-package test: ``owner`` over
10,000 seeded scopes (str, bytes and int) on uniform topologies of 1–8
hosts, and one membership history with pins, releases, host changes and
migrations, equal to the JAX package's for every scope (tolerance:
exact). Placement is pure host-side hashing, so both packages run in
this process.

The original's notes:

The federation's routing contract: every participant that constructs a
:class:`~hashgraph_tpu.parallel.federation.FederationPlacement` from the
same membership history computes IDENTICAL assignments (golden values +
a fresh-subprocess check), membership changes remap minimally (the
rendezvous invariant at the host level), live scopes are pinned and
never split, and a migration flips a shard's home atomically — no
reader ever observes dual ownership."""

import random
import subprocess
import sys
import threading

import pytest

from hashgraph_tpu.parallel import federation as ref_federation
from hashgraph_tpu_torch.parallel.federation import FederationPlacement
from test_torch_fleet_placement import seeded_scopes

HOSTS = ["alpha", "beta", "gamma"]


def uniform():
    return FederationPlacement.uniform(HOSTS, 2)


# Pinned (host, shard) assignments: placement is a pure function of the
# membership history, so these values must never drift — a silent hash
# change would strand every live deployment's scopes.
GOLDEN = {
    "scope-0": ("gamma", "gamma:0"),
    "scope-1": ("alpha", "alpha:0"),
    "scope-2": ("gamma", "gamma:1"),
    "scope-3": ("alpha", "alpha:1"),
    "scope-4": ("alpha", "alpha:0"),
    "scope-5": ("alpha", "alpha:1"),
    "scope-6": ("alpha", "alpha:0"),
    "scope-7": ("gamma", "gamma:0"),
    "scope-8": ("alpha", "alpha:1"),
    "scope-9": ("beta", "beta:0"),
    "scope-10": ("alpha", "alpha:1"),
    "scope-11": ("beta", "beta:1"),
}


def test_golden_assignments():
    placement = uniform()
    got = {scope: placement.owner(scope) for scope in GOLDEN}
    assert got == GOLDEN


def test_fresh_subprocess_restart_stability():
    """A restarted (or different-machine) participant reconstructs the
    identical placement — no dependence on interpreter state or
    randomized hashing."""
    script = (
        "from hashgraph_tpu_torch.parallel.federation import FederationPlacement\n"
        f"p = FederationPlacement.uniform({HOSTS!r}, 2)\n"
        "print(';'.join('%s=%s,%s' % (s, *p.owner(s))"
        " for s in ['scope-%d' % i for i in range(12)]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.strip()
    got = {}
    for item in out.split(";"):
        scope, owner = item.split("=")
        host, shard = owner.split(",")
        got[scope] = (host, shard)
    assert got == GOLDEN


def test_second_level_matches_fleet_rendezvous():
    """The placement's shard choice and a host fleet's own rendezvous
    over the same shard set MUST coincide — both sides pin a scope at
    its first mutating touch, and the pins only agree because the HRW
    agrees."""
    from hashgraph_tpu_torch.parallel.fleet import rendezvous_owner

    placement = uniform()
    for i in range(64):
        scope = f"match-{i}"
        host, shard = placement.owner(scope)
        assert shard == rendezvous_owner(scope, placement.shards_of(host))


def test_add_host_remaps_only_onto_new_host():
    placement = uniform()
    scopes = [f"elastic-{i}" for i in range(256)]
    before = {s: placement.owner(s) for s in scopes}
    placement.add_host("delta", ["delta:0", "delta:1"])
    after = {s: placement.owner(s) for s in scopes}
    moved = {s for s in scopes if before[s] != after[s]}
    assert moved, "a 4th host should win some scopes"
    for scope in moved:
        assert after[scope][0] == "delta", (scope, after[scope])


def test_remove_host_remaps_only_its_own_scopes():
    placement = uniform()
    scopes = [f"elastic-{i}" for i in range(256)]
    before = {s: placement.owner(s) for s in scopes}
    placement.remove_host("gamma")
    after = {s: placement.owner(s) for s in scopes}
    for scope in scopes:
        if before[scope][0] == "gamma":
            assert after[scope][0] != "gamma"
        else:
            assert after[scope] == before[scope], scope


def test_pins_survive_membership_changes():
    placement = uniform()
    host, shard = placement.owner("pinned-scope")
    placement.pin("pinned-scope", shard)
    placement.add_host("delta", ["delta:0"])
    assert placement.owner("pinned-scope") == (host, shard)
    placement.release("pinned-scope")


def test_remove_host_refuses_with_pinned_scopes():
    placement = uniform()
    host, shard = placement.owner("scope-0")  # gamma
    placement.pin("scope-0", shard)
    with pytest.raises(ValueError, match="live scopes"):
        placement.remove_host(host)
    placement.remove_host(host, force=True)
    assert host not in placement.host_ids


def test_migration_flips_atomically_no_dual_ownership():
    """Concurrent readers during a flip observe EXACTLY one of the two
    legal owners — never a third value, never an error; after the flip,
    only the new one. Pinned scopes follow their shard."""
    placement = uniform()
    host, shard = placement.owner("scope-1")  # alpha, alpha:0
    placement.pin("scope-1", shard)
    target = "beta"
    observed = set()
    errors = []
    stop = threading.Event()

    def reader():
        try:
            while not stop.is_set():
                observed.add(placement.owner("scope-1"))
        except BaseException as exc:  # pragma: no cover - the failure
            errors.append(exc)

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for thread in threads:
        thread.start()
    placement.begin_migration(shard)
    assert placement.migrating(shard)
    placement.complete_migration(shard, target)
    stop.set()
    for thread in threads:
        thread.join()
    assert not errors
    assert observed <= {(host, shard), (target, shard)}, observed
    assert placement.owner("scope-1") == (target, shard)
    assert not placement.migrating(shard)
    assert shard in placement.shards_of(target)
    assert shard not in placement.shards_of(host)


def test_abort_migration_restores_routing():
    placement = uniform()
    _host, shard = placement.owner("scope-9")
    placement.begin_migration(shard, retry_after=0.5)
    assert placement.retry_after(shard) == 0.5
    placement.abort_migration(shard)
    assert not placement.migrating(shard)
    assert placement.owner("scope-9") == ("beta", shard)


def test_unpinned_scopes_avoid_empty_hosts():
    """A host whose shards all migrated away owns nothing at level 1."""
    placement = FederationPlacement.uniform(["a", "b"], 1)
    placement.begin_migration("a:0")
    placement.complete_migration("a:0", "b")
    for i in range(32):
        host, _shard = placement.owner(f"empty-{i}")
        assert host == "b"


def test_duplicate_shard_home_rejected():
    with pytest.raises(ValueError, match="two hosts"):
        FederationPlacement({"a": ["s:0"], "b": ["s:0"]})


# ── Cross-package: every owner equals the JAX package's ───────────────


def test_owner_matches_reference_over_10000_scopes():
    scopes = seeded_scopes(10, 10_000)
    for n_hosts in range(1, 9):
        hosts = [f"host-{k}" for k in range(n_hosts)]
        shards = 1 + n_hosts % 3
        ours = FederationPlacement.uniform(hosts, shards)
        theirs = ref_federation.FederationPlacement.uniform(hosts, shards)
        assert [ours.owner(s) for s in scopes] == [theirs.owner(s) for s in scopes], n_hosts


def test_membership_history_matches_reference():
    """Pins, releases, host additions and removals, and migrations
    (begun, completed, aborted) through both packages: every lookup and
    readout equal after every step."""
    scopes = seeded_scopes(11, 10_000)
    rng = random.Random(12)
    ours = FederationPlacement.uniform(HOSTS, 2)
    theirs = ref_federation.FederationPlacement.uniform(HOSTS, 2)
    next_host = 0
    for step in range(40):
        action = rng.random()
        both = (ours, theirs)
        if action < 0.25:
            for scope in rng.sample(scopes, 20):
                shard = ours.owner(scope)[1]
                for p in both:
                    p.pin(scope, shard)
        elif action < 0.35:
            for scope in rng.sample(scopes, 40):
                for p in both:
                    p.release(scope)
        elif action < 0.5:
            host = f"new-{next_host}"
            next_host += 1
            shard_ids = [f"{host}:{k}" for k in range(rng.randint(1, 3))]
            for p in both:
                p.add_host(host, shard_ids)
        elif action < 0.6 and len(ours.host_ids) > 1:
            host = rng.choice(ours.host_ids)
            for p in both:
                p.remove_host(host, force=True)
        else:
            shard = rng.choice(ours.shard_ids)
            target = rng.choice(ours.host_ids)
            for p in both:
                p.begin_migration(shard, retry_after=0.25)
            assert ours.migrating(shard) and theirs.migrating(shard)
            if rng.random() < 0.7:
                for p in both:
                    p.complete_migration(shard, target)
            else:
                for p in both:
                    p.abort_migration(shard)
        assert ours.host_ids == theirs.host_ids
        assert ours.shard_ids == theirs.shard_ids
        for host in ours.host_ids:
            assert ours.shards_of(host) == theirs.shards_of(host)
        for shard in ours.shard_ids:
            assert ours.pins_of_shard(shard) == theirs.pins_of_shard(shard)
        if not any(ours.shards_of(h) for h in ours.host_ids):
            break
        sample = scopes if step % 10 == 9 else rng.sample(scopes, 1_000)
        assert [ours.owner(s) for s in sample] == [theirs.owner(s) for s in sample], step
