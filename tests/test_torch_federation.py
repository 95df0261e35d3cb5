"""Parity: the port's federation (``parallel/federation``) against the
JAX package's.

Three parts, on the CPU:

1. Twins of the 11 tests of ``tests/test_federation.py``: two port
   ``FleetGroup``s (``devices=[cpu]``) over real TCP loopback — remote
   vote routing over the gossip fabric, cross-host tallies on the fabric
   path, and live shard migration under traffic with the typed
   retry-after window — with the original's fixtures, traffic and timing.
2. Cross-package: one seeded federation trace (remote-routed votes,
   ``deliver_proposals``, ``federated_state_counts``, one
   ``migrate_shard``) on both packages gives equal statuses, tallies,
   host fingerprints and migration reports (all but ``seconds``). The
   JAX side runs in a subprocess (``python tests/test_torch_federation.py
   --reference trace ROOT``).
3. A mixed federation: h0 a JAX ``FleetGroup`` in a subprocess
   (``--reference host ROOT``, driven by lines on its stdin), h1 a port
   ``FleetGroup`` here. Votes routed in both directions land with the
   statuses of an all-JAX federation on the same traffic, and
   ``OP_FLEET_TALLY`` answers agree.

Tolerance: exact."""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hashgraph_tpu_torch import CreateProposalRequest, StubConsensusSigner, build_vote
from hashgraph_tpu_torch.errors import StatusCode
from hashgraph_tpu_torch.parallel.federation import (
    FederationPlacement,
    FleetGroup,
    migrate_shard,
)
from hashgraph_tpu_torch.parallel.fleet import ShardMigratingError

NOW = 1_700_000_000
OK = int(StatusCode.OK)
ALREADY = int(StatusCode.ALREADY_REACHED)
REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _build_federation(wal_root):
    placement = FederationPlacement.uniform(["h0", "h1"], 2)
    groups = {}
    for host in ("h0", "h1"):
        groups[host] = FleetGroup(
            host,
            lambda k: StubConsensusSigner(bytes([k + 1]) * 20),
            placement=placement,
            wal_root=wal_root,
            capacity_per_shard=64,
            voter_capacity=8,
            devices=[CPU],
        )
        groups[host].start()
    for a in groups:
        for b in groups:
            if a != b:
                groups[a].connect(b, *groups[b].address, groups[b].peer_id)
    return placement, groups


# Module-scoped (as the original, whose groups compile jax kernels): the
# read-only / freeze-and-abort tests share one topology (distinct scope
# tags keep them independent). Tests that CHANGE the topology (a real
# migration) take the fresh fixture below.
@pytest.fixture(scope="module")
def federation(tmp_path_factory):
    placement, groups = _build_federation(
        str(tmp_path_factory.mktemp("federation"))
    )
    try:
        yield placement, groups
    finally:
        for group in groups.values():
            group.close()


@pytest.fixture()
def fresh_federation(tmp_path):
    placement, groups = _build_federation(str(tmp_path))
    try:
        yield placement, groups
    finally:
        for group in groups.values():
            group.close()


def scope_owned_by(placement, host, tag="s"):
    return next(
        f"{tag}{i}" for i in range(1000)
        if placement.owner(f"{tag}{i}")[0] == host
    )


def make_session(placement, groups, scope, voters=3):
    """Create a proposal on the owner host, pin, and return (proposal,
    ``voters`` chained signed votes)."""
    host, shard = placement.owner(scope)
    request = CreateProposalRequest(
        name="p", payload=b"", proposal_owner=b"o" * 20,
        expected_voters_count=voters, expiration_timestamp=3600,
        liveness_criteria_yes=True,
    )
    proposal = groups[host].adapter.create_proposal(scope, request, NOW)
    placement.pin(scope, shard)
    votes = []
    for i in range(voters):
        vote = build_vote(
            proposal, True, StubConsensusSigner(bytes([50 + i]) * 20), NOW + 1
        )
        proposal.votes.append(vote)
        votes.append(vote)
    return proposal, votes


def test_remote_votes_ride_the_fabric(federation):
    """Votes submitted on the NON-owning host land on the owner over a
    coalesced OP_VOTE_BATCH frame — not SESSION_NOT_FOUND."""
    placement, groups = federation
    scope = scope_owned_by(placement, "h1")
    proposal, votes = make_session(placement, groups, scope)
    statuses = groups["h0"].ingest_votes(
        [(scope, v) for v in votes[:2]], NOW + 2
    )
    assert (statuses == OK).all(), statuses
    # 2/3 quorum: decided on the owner.
    assert (
        groups["h1"].adapter.get_consensus_result(
            scope, proposal.proposal_id
        )
        is True
    )
    # Mixed local+remote batch in one call, statuses in input order.
    local_scope = scope_owned_by(placement, "h0", tag="loc")
    local_prop, local_votes = make_session(placement, groups, local_scope)
    mixed = [(scope, votes[2]), (local_scope, local_votes[0]),
             (local_scope, local_votes[1])]
    statuses = groups["h0"].ingest_votes(mixed, NOW + 3)
    assert statuses[0] == ALREADY  # decided session absorbs
    assert statuses[1] == OK and statuses[2] == OK, statuses


def test_remote_statuses_align_on_interleaved_scopes(federation):
    """Two remote scopes interleaved in one call: the frame groups rows
    per scope (reordering them), so statuses must map back through the
    frame order — each row's status describes ITS vote. A bad vote
    placed between good ones is the discriminator."""
    placement, groups = federation
    s_a = scope_owned_by(placement, "h1", tag="ila")
    s_b = scope_owned_by(placement, "h1", tag="ilb")
    _pa, votes_a = make_session(placement, groups, s_a)
    _pb, votes_b = make_session(placement, groups, s_b)
    # B's SECOND vote without its first: a dangling chain link the
    # engine rejects (RECEIVED_HASH_MISMATCH) — in input position 1,
    # but in frame position 2 (after both A rows).
    items = [(s_a, votes_a[0]), (s_b, votes_b[1]), (s_a, votes_a[1])]
    statuses = groups["h0"].ingest_votes(items, NOW + 2)
    assert statuses[0] == OK, statuses
    assert statuses[1] == int(StatusCode.RECEIVED_HASH_MISMATCH), statuses
    assert statuses[2] == OK, statuses


def test_deliver_proposals_routes_remotely(federation):
    placement, groups = federation
    scope = scope_owned_by(placement, "h1", tag="dlv")
    proposal, _votes = make_session(placement, groups, scope)
    # Deliver the full chain from the non-owner: extends the owner's
    # empty chain via the watermark path (one OP_DELIVER_PROPOSALS
    # frame over the fabric).
    codes = groups["h0"].deliver_proposals([(scope, proposal)], NOW + 2)
    assert codes[0] in (OK, int(StatusCode.PROPOSAL_ALREADY_EXIST)), codes
    assert (
        groups["h1"].adapter.get_consensus_result(
            scope, proposal.proposal_id
        )
        is True
    )


def test_federated_state_counts_fabric_path(federation):
    """Cross-host tallies on the OP_FLEET_TALLY fabric arm (this box has
    no cross-process collectives — tally_path() says so)."""
    from hashgraph_tpu_torch.parallel.federation import tally_path

    placement, groups = federation
    assert tally_path() == "fabric"
    from hashgraph_tpu_torch.ops.decide import STATE_ACTIVE

    before = groups["h0"].federated_state_counts()
    for host in ("h0", "h1"):
        scope = scope_owned_by(placement, host, tag=f"tly-{host}-")
        make_session(placement, groups, scope)
    counts0 = groups["h0"].federated_state_counts()
    counts1 = groups["h1"].federated_state_counts()
    assert counts0 == counts1  # both sum the same federation
    delta = counts0.get(STATE_ACTIVE, 0) - before.get(STATE_ACTIVE, 0)
    assert delta == 2, (before, counts0)
    # The federation's total slot space: 2 hosts x 2 shards x 64.
    assert sum(counts0.values()) == 4 * 64, counts0


def test_fleet_tally_opcode_over_bridge(federation):
    from hashgraph_tpu_torch.bridge.client import BridgeClient

    placement, groups = federation
    with BridgeClient(*groups["h0"].address) as client:
        counts = client.fleet_tally(groups["h0"].peer_id)
    # One host's whole local fleet: 2 shards x 64 slots.
    assert sum(counts.values()) == 2 * 64, counts


def test_migrating_shard_raises_typed_with_retry_after(federation):
    placement, groups = federation
    scope = scope_owned_by(placement, "h1", tag="frz")
    _proposal, votes = make_session(placement, groups, scope)
    _host, shard = placement.owner(scope)
    # Freeze BOTH sides the orchestrator freezes: the placement (drivers
    # consult it) and the owning fleet (the wire refuses typed).
    placement.begin_migration(shard, retry_after=0.25)
    groups["h1"].fleet.begin_migration(shard, retry_after=0.25)
    try:
        with pytest.raises(ShardMigratingError) as excinfo:
            groups["h0"].ingest_votes([(scope, votes[0])], NOW + 2)
        assert excinfo.value.retry_after == 0.25
        assert excinfo.value.shard_id == shard
        # Local routes on the owner refuse the same way.
        with pytest.raises(ShardMigratingError):
            groups["h1"].ingest_votes([(scope, votes[0])], NOW + 2)
    finally:
        placement.abort_migration(shard)
        groups["h1"].fleet.end_migration(shard)
    # The freeze lifted: the held vote lands.
    statuses = groups["h0"].ingest_votes([(scope, votes[0])], NOW + 3)
    assert statuses[0] == OK, statuses


def test_wire_migrating_status_crosses_the_bridge(federation):
    """The typed refusal survives the wire: a remote sender's
    OP_VOTE_BATCH frame comes back STATUS_SHARD_MIGRATING (246) when
    the owner froze AFTER the sender's placement read."""
    from hashgraph_tpu_torch.bridge import protocol as P
    from hashgraph_tpu_torch.bridge.client import BridgeClient, BridgeError

    placement, groups = federation
    scope = scope_owned_by(placement, "h1", tag="wire")
    _proposal, votes = make_session(placement, groups, scope)
    _host, shard = placement.owner(scope)
    groups["h1"].fleet.begin_migration(shard, retry_after=0.5)
    try:
        with BridgeClient(*groups["h1"].address) as client:
            payload = P.encode_vote_batch(
                NOW + 2,
                [(groups["h1"].peer_id, scope, [votes[0].encode()])],
            )
            with pytest.raises(BridgeError) as excinfo:
                client._call(P.OP_VOTE_BATCH, payload)
            assert excinfo.value.status == P.STATUS_SHARD_MIGRATING
    finally:
        groups["h1"].fleet.end_migration(shard)


def test_live_migration_under_traffic(fresh_federation):
    """The tentpole end to end, in process: sustained ingest with a
    typed-retry loop while the scope's shard re-homes h1 -> h0.
    Zero lost votes, source==destination fingerprints (asserted inside
    migrate_shard), atomic flip, migration metrics + flight events, and
    the session keeps serving."""
    from hashgraph_tpu_torch.obs import (
        FEDERATION_MIGRATION_SECONDS,
        FEDERATION_MIGRATIONS_TOTAL,
        registry,
    )

    placement, groups = fresh_federation
    migrations0 = registry.counter(FEDERATION_MIGRATIONS_TOTAL).value
    seconds0 = registry.histogram(FEDERATION_MIGRATION_SECONDS).count
    scope = scope_owned_by(placement, "h1", tag="live")
    # 24 chained votes against a quorum of EXACTLY 24 (ceil(2*36/3)):
    # the last vote is the deciding one, so `result is True` proves
    # every single vote survived the migration — and no vote ever links
    # past an absorbed post-decision vote (which would be a dangling
    # chain by protocol rule, not a migration artifact).
    host, shard = placement.owner(scope)
    request = CreateProposalRequest(
        name="p", payload=b"", proposal_owner=b"o" * 20,
        expected_voters_count=36, expiration_timestamp=3600,
        liveness_criteria_yes=True,
    )
    proposal = groups[host].adapter.create_proposal(scope, request, NOW)
    placement.pin(scope, shard)
    votes = []
    for i in range(24):
        vote = build_vote(
            proposal, True, StubConsensusSigner(bytes([50 + i]) * 20),
            NOW + 1,
        )
        proposal.votes.append(vote)
        votes.append(vote)

    applied = []
    errors = []

    def traffic():
        try:
            for vote in votes:
                while True:  # the retry-after loop the error prescribes
                    try:
                        statuses = groups["h0"].ingest_votes(
                            [(scope, vote)], NOW + 2
                        )
                        break
                    except ShardMigratingError as exc:
                        time.sleep(min(exc.retry_after, 0.05))
                assert statuses[0] in (OK, ALREADY), statuses
                applied.append(int(statuses[0]))
        except BaseException as exc:  # surfaced by the join below
            errors.append(exc)

    thread = threading.Thread(target=traffic)
    thread.start()
    time.sleep(0.05)  # let some votes land pre-migration
    report = migrate_shard(
        placement, groups, shard, "h0", retry_after=0.05
    )
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert not errors, errors
    assert report["from"] == "h1" and report["to"] == "h0"
    assert report["sessions"] >= 1
    assert placement.owner(scope) == ("h0", shard)
    assert shard in groups["h0"].fleet.shard_ids
    assert shard not in groups["h1"].fleet.shard_ids
    # ZERO LOST VOTES: all 24 landed as plain acks across freeze+flip.
    assert len(applied) == 24 and all(s == OK for s in applied), applied
    # The migrated session decided on its new home AT THE LAST VOTE:
    # True iff nothing was lost across the migration.
    result = groups["h0"].adapter.get_consensus_result(
        scope, proposal.proposal_id
    )
    assert result is True, (result, applied)
    # One migration, counted and timed.
    assert (
        registry.counter(FEDERATION_MIGRATIONS_TOTAL).value
        == migrations0 + 1
    )
    assert (
        registry.histogram(FEDERATION_MIGRATION_SECONDS).count
        == seconds0 + 1
    )
    # Drain h1 COMPLETELY (its last shard migrates too — the
    # decommission flow): the emptied host keeps serving the wire, and
    # new scopes rendezvous only onto hosts that home shards.
    last = placement.shards_of("h1")[0]
    migrate_shard(placement, groups, last, "h0")
    assert placement.shards_of("h1") == []
    assert groups["h1"].fleet.n_shards == 0
    for i in range(16):
        assert placement.owner(f"post-drain-{i}")[0] == "h0"


def test_migrate_shard_unknown_target_leaves_topology_intact(federation):
    placement, groups = federation
    scope = scope_owned_by(placement, "h1", tag="abrt")
    _proposal, votes = make_session(placement, groups, scope)
    _host, shard = placement.owner(scope)
    with pytest.raises(KeyError):
        migrate_shard(placement, groups, shard, "nope")
    # Rolled back: not migrating, still owned and serving on h1.
    assert not placement.migrating(shard)
    assert placement.host_of(shard) == "h1"
    statuses = groups["h0"].ingest_votes([(scope, votes[0])], NOW + 2)
    assert statuses[0] == OK, statuses


def test_adapter_columnar_wire_multi_scope(federation):
    """A multi-scope OP_VOTE_BATCH frame through the host's zero-copy
    columnar ingest: rows split per owning shard (columnar.pack_rows)
    and every status lands in flattened frame order."""
    from hashgraph_tpu_torch.bridge import protocol as P
    from hashgraph_tpu_torch.bridge.client import BridgeClient, parse_status_list

    placement, groups = federation
    sessions = []
    for i in range(4):
        scope = scope_owned_by(placement, "h0", tag=f"col{i}-")
        _proposal, votes = make_session(placement, groups, scope)
        sessions.append((scope, votes))
    frame_groups = [
        (groups["h0"].peer_id, scope, [v.encode() for v in votes[:2]])
        for scope, votes in sessions
    ]
    payload = P.encode_vote_batch(NOW + 2, frame_groups)
    with BridgeClient(*groups["h0"].address) as client:
        statuses = parse_status_list(client._call(P.OP_VOTE_BATCH, payload))
    assert statuses == [OK] * 8, statuses
    for scope, _votes in sessions:
        assert (
            groups["h0"].adapter.get_consensus_result(
                scope, _votes[0].proposal_id
            )
            is True
        )


def test_host_fingerprint_covers_all_shards(federation):
    """The adapter's state_fingerprint digests the union of the shards'
    canonical frames: adding a session on EITHER shard changes it."""
    placement, groups = federation
    before = groups["h0"].state_fingerprint()
    scope = scope_owned_by(placement, "h0", tag="fpr")
    make_session(placement, groups, scope)
    assert groups["h0"].state_fingerprint() != before


# ── Cross-package: one seeded federation trace on both packages ───────


def port_api():
    import hashgraph_tpu_torch as pkg
    from hashgraph_tpu_torch import protocol
    from hashgraph_tpu_torch.parallel import federation

    def make_group(host, placement, root):
        return federation.FleetGroup(
            host, lambda k: pkg.StubConsensusSigner(bytes([k + 1]) * 20),
            placement=placement, wal_root=root, capacity_per_shard=64,
            voter_capacity=8, devices=[CPU],
        )

    return _Api(pkg, protocol, federation, make_group)


def reference_api():
    import hashgraph_tpu as pkg
    from hashgraph_tpu import protocol
    from hashgraph_tpu.parallel import federation

    def make_group(host, placement, root):
        return federation.FleetGroup(
            host, lambda k: pkg.StubConsensusSigner(bytes([k + 1]) * 20),
            placement=placement, wal_root=root, capacity_per_shard=64,
            voter_capacity=8,
        )

    return _Api(pkg, protocol, federation, make_group)


class _Api:
    def __init__(self, pkg, protocol, federation, make_group):
        self.pkg, self.protocol = pkg, protocol
        self.federation, self.make_group = federation, make_group


class _Seeded:
    """Seeded proposal and vote ids (``protocol.set_id_entropy``) and batch
    id draws (``os.urandom``), so both packages mint the same ids."""

    def __init__(self, api, seed):
        import random

        self.api, self.ids = api, random.Random(seed)
        self.draws = random.Random(seed + 1_000_003)

    def __enter__(self):
        self.saved = os.urandom
        self.api.protocol.set_id_entropy(lambda: self.ids.getrandbits(128))
        os.urandom = self.draws.randbytes

    def __exit__(self, *exc):
        os.urandom = self.saved
        self.api.protocol.set_id_entropy(None)


def _request(pkg, voters):
    return pkg.CreateProposalRequest(
        name="p", payload=b"", proposal_owner=b"o" * 20,
        expected_voters_count=voters, expiration_timestamp=3600,
        liveness_criteria_yes=True,
    )


def _chain(pkg, proposal, voters, first=0, now=NOW + 1):
    votes = []
    for i in range(voters):
        vote = pkg.build_vote(
            proposal, bool(i % 3 != 2),
            pkg.StubConsensusSigner(bytes([50 + first + i]) * 20), now)
        proposal.votes.append(vote)
        votes.append(vote)
    return votes


def _raised(fn, *args):
    try:
        out = fn(*args)
    except Exception as exc:  # the exception type is the result compared
        return ["raised", type(exc).__name__]
    return out.tolist() if isinstance(out, np.ndarray) else list(out)


def federation_trace(api, root, seed=17):
    """One seeded trace through two FleetGroups of one package: votes
    submitted at both hosts (half ride the fabric), remote deliveries, the
    fabric tally, host fingerprints, one migrate_shard; returns its log."""
    pkg, log = api.pkg, {}
    with _Seeded(api, seed):
        placement = api.federation.FederationPlacement.uniform(["h0", "h1"], 2)
        groups = {}
        try:
            for host in ("h0", "h1"):
                groups[host] = api.make_group(host, placement, root)
                groups[host].start()
            for a in groups:
                for b in groups:
                    if a != b:
                        groups[a].connect(b, *groups[b].address, groups[b].peer_id)
            _federation_body(api, pkg, placement, groups, log)
        finally:
            for group in groups.values():
                group.close()
    return json.loads(json.dumps(log))


def _federation_body(api, pkg, placement, groups, log):
    scopes = [scope_owned_by(placement, host, tag=f"fx{i}-{host}-")
              for host in ("h0", "h1") for i in range(4)]
    log["owners"] = [list(placement.owner(s)) for s in scopes]
    sessions, pids = {}, {}
    for s in scopes:
        host, shard = placement.owner(s)
        proposal = groups[host].adapter.create_proposal(s, _request(pkg, 7), NOW)
        placement.pin(s, shard)
        pids[s] = proposal.proposal_id
        sessions[s] = (proposal, _chain(pkg, proposal, 6))
    # Round r goes in at h0 for even r and h1 for odd: every other round is
    # remote for each scope. The fifth vote decides (quorum of 7 is 5).
    for r in range(6):
        at = "h0" if r % 2 == 0 else "h1"
        items = [(s, sessions[s][1][r]) for s in scopes]
        log[f"round{r}"] = _raised(groups[at].ingest_votes, items, NOW + 2)
    log["results"] = [
        groups[placement.owner(s)[0]].adapter.get_consensus_result(s, sessions[s][0].proposal_id)
        for s in scopes
    ]
    # Deliveries from the other host: a fresh session's chain of three.
    deliver = {}
    for host in ("h0", "h1"):
        other = "h1" if host == "h0" else "h0"
        s = scope_owned_by(placement, host, tag=f"fd-{host}-")
        proposal = groups[host].adapter.create_proposal(s, _request(pkg, 4), NOW)
        placement.pin(s, placement.owner(s)[1])
        pids[s] = proposal.proposal_id
        _chain(pkg, proposal, 3, first=20)
        deliver[host] = groups[other].deliver_proposals([(s, proposal)], NOW + 3)
        deliver[host + "-again"] = groups[other].deliver_proposals([(s, proposal)], NOW + 3)
        scopes.append(s)
    log["deliver"] = deliver
    log["tally_path"] = api.federation.tally_path()
    log["counts"] = [groups[h].federated_state_counts() for h in ("h0", "h1")]
    log["fingerprints"] = [groups[h].state_fingerprint() for h in ("h0", "h1")]
    # Migrate the h1 shard that holds the most pinned scopes onto h0.
    shard = max(placement.shards_of("h1"), key=lambda sid: (len(placement.pins_of_shard(sid)), sid))
    report = api.federation.migrate_shard(placement, groups, shard, "h0", retry_after=0.05)
    report.pop("seconds")
    log["migration"] = report
    log["owners_after"] = [list(placement.owner(s)) for s in scopes]
    # One more vote for each moved scope, sent to h1, which now forwards it.
    late = [s for s in scopes if placement.owner(s)[1] == shard]
    log["late"] = _raised(groups["h1"].ingest_votes, [
        (s, _chain(pkg, groups["h0"].adapter.get_proposal(s, pids[s]), 1, first=40,
                   now=NOW + 4)[0])
        for s in late
    ], NOW + 4)
    log["counts_after"] = [groups[h].federated_state_counts() for h in ("h0", "h1")]
    log["fingerprints_after"] = [groups[h].state_fingerprint() for h in ("h0", "h1")]
    log["shards_after"] = [groups[h].fleet.shard_ids for h in ("h0", "h1")]


@pytest.fixture(scope="module")
def reference_federation_trace(tmp_path_factory):
    root = tmp_path_factory.mktemp("federation-reference")
    proc = subprocess.run(
        [sys.executable, __file__, "--reference", "trace", str(root)],
        capture_output=True, text=True, timeout=600, cwd=str(REPO), env=_reference_env(),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _reference_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def test_federation_trace_matches_reference(reference_federation_trace, tmp_path):
    port = federation_trace(port_api(), str(tmp_path))
    ref = reference_federation_trace
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert port[key] == ref[key], key
    # The trace reaches what it is meant to: remote rounds acked, decisions,
    # a moved shard with its sessions, equal tallies on both hosts.
    assert port["tally_path"] == "fabric"
    assert port["counts"][0] == port["counts"][1]
    assert sum(port["counts"][0].values()) == 4 * 64
    assert all(r is True for r in port["results"])
    assert port["migration"]["sessions"] >= 1
    assert port["late"] and set(port["late"]) <= {OK, ALREADY}


# ── A mixed federation: a JAX host and a port host ─────────────────────


class _RemoteHost:
    """A JAX ``FleetGroup`` in a subprocess (``--reference host``), driven
    by one JSON command a line on its stdin, one JSON answer a line on its
    stdout."""

    def __init__(self, host_id, root):
        self.proc = subprocess.Popen(
            [sys.executable, __file__, "--reference", "host", root, host_id],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=str(REPO), env=_reference_env(),
        )

    def ready(self):
        hello = self._read()
        self.address, self.peer_id = tuple(hello["address"]), hello["peer_id"]

    def _read(self):
        line = self.proc.stdout.readline()
        if not line:
            self.proc.kill()
            raise AssertionError("reference host died:\n" + self.proc.stderr.read()[-4000:])
        return json.loads(line)

    def call(self, **cmd):
        self.proc.stdin.write(json.dumps(cmd) + "\n")
        self.proc.stdin.flush()
        return self._read()

    def connect(self, host_id, address, peer_id):
        self.call(op="connect", host=host_id, address=list(address), peer=peer_id)

    def create(self, scope, voters):
        return bytes.fromhex(self.call(op="create", scope=scope, voters=voters)["proposal"])

    def ingest(self, items, now):
        return self.call(op="ingest", now=now,
                         items=[[s, vote.hex()] for s, vote in items])["statuses"]

    def counts(self):
        return {int(k): v for k, v in self.call(op="counts")["counts"].items()}

    def close(self):
        """Ask the host to close; :meth:`wait` reaps it."""
        if self.proc.poll() is None:
            self.proc.stdin.write(json.dumps({"op": "close"}) + "\n")
            self.proc.stdin.flush()

    def wait(self):
        try:
            self.proc.communicate(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.communicate()


class _LocalHost:
    """A port ``FleetGroup`` in this process, with the same interface."""

    def __init__(self, host_id, root):
        import hashgraph_tpu_torch as pkg

        self.pkg = pkg
        self.placement = FederationPlacement.uniform(["h0", "h1"], 2)
        self.group = _host_group(pkg, FleetGroup, host_id, self.placement, root,
                                 devices=[CPU])
        self.group.start()
        self.address, self.peer_id = self.group.address, self.group.peer_id

    def ready(self):
        pass

    def wait(self):
        pass

    def connect(self, host_id, address, peer_id):
        self.group.connect(host_id, *address, peer_id)

    def create(self, scope, voters):
        return self.group.adapter.create_proposal(scope, _request(self.pkg, voters), NOW).encode()

    def ingest(self, items, now):
        from hashgraph_tpu_torch.wire import Vote

        return self.group.ingest_votes([(s, Vote.decode(v)) for s, v in items], now).tolist()

    def counts(self):
        return self.group.federated_state_counts()

    def close(self):
        self.group.close()


def _host_group(pkg, group_cls, host_id, placement, root, **kw):
    return group_cls(
        host_id, lambda k: pkg.StubConsensusSigner(bytes([k + 1]) * 20),
        placement=placement, wal_root=root, capacity_per_shard=64, voter_capacity=8, **kw,
    )


def mixed_traffic(hosts):
    """Sessions on both hosts, votes for each submitted at the other host
    (they ride the fabric) and at its owner, the fabric tallies and the
    OP_FLEET_TALLY answers. Votes are built here with the port's
    ``build_vote`` from the owner's proposal bytes; statuses do not
    depend on ids."""
    import hashgraph_tpu_torch as pkg
    from hashgraph_tpu_torch.bridge.client import BridgeClient
    from hashgraph_tpu_torch.wire import Proposal

    placement = FederationPlacement.uniform(["h0", "h1"], 2)
    log = {}
    chains = {}
    for host in ("h0", "h1"):
        for i in range(3):
            s = scope_owned_by(placement, host, tag=f"mix{i}-{host}-")
            proposal = Proposal.decode(hosts[host].create(s, 6))
            chains[s] = (host, [v.encode() for v in _chain(pkg, proposal, 5)])
    for r in range(5):
        for at in ("h0", "h1"):
            # Round r's vote of every scope whose owner is not ``at`` when r
            # is even, of every scope ``at`` owns when r is odd.
            items = [(s, votes[r]) for s, (owner, votes) in chains.items()
                     if (owner != at) == (r % 2 == 0)]
            log[f"round{r}-{at}"] = hosts[at].ingest(items, NOW + 2)
    log["counts"] = [hosts[h].counts() for h in ("h0", "h1")]
    tallies = []
    for h in ("h0", "h1"):
        with BridgeClient(*hosts[h].address) as client:
            tallies.append(client.fleet_tally(hosts[h].peer_id))
    log["fleet_tally"] = tallies
    return json.loads(json.dumps(log))


def _run_mixed(kinds, root):
    hosts = {}
    try:
        # The subprocesses start together; their teardowns run together too.
        for host, kind in kinds.items():
            hosts[host] = (_LocalHost if kind == "port" else _RemoteHost)(
                host, os.path.join(root, host))
        for host in hosts.values():
            host.ready()
        for a in hosts:
            for b in hosts:
                if a != b:
                    hosts[a].connect(b, hosts[b].address, hosts[b].peer_id)
        return mixed_traffic(hosts)
    finally:
        for host in hosts.values():
            host.close()
        for host in hosts.values():
            host.wait()


def test_mixed_federation_matches_all_reference(tmp_path):
    """h0 a JAX host, h1 a port host: votes routed both ways land with the
    statuses of two JAX hosts given the same traffic, and the tallies
    agree (each host's OP_FLEET_TALLY over its two shards, the fabric sum
    equal on both hosts)."""
    mixed = _run_mixed({"h0": "reference", "h1": "port"}, str(tmp_path / "mixed"))
    baseline = _run_mixed({"h0": "reference", "h1": "reference"}, str(tmp_path / "jax"))
    assert mixed == baseline
    for r in range(5):
        for at in ("h0", "h1"):
            assert mixed[f"round{r}-{at}"], (r, at)
    assert all(code == OK for code in mixed["round0-h0"] + mixed["round0-h1"])
    assert ALREADY in mixed["round4-h0"] + mixed["round4-h1"]
    t0, t1 = mixed["fleet_tally"]
    assert sum(t0.values()) == sum(t1.values()) == 2 * 64
    summed = {k: t0.get(k, 0) + t1.get(k, 0) for k in set(t0) | set(t1)}
    assert mixed["counts"][0] == mixed["counts"][1] == summed


def reference_host(root, host_id):
    """The ``--reference host`` loop: one JAX FleetGroup serving commands."""
    import hashgraph_tpu as pkg
    from hashgraph_tpu.parallel.federation import FederationPlacement as Placement
    from hashgraph_tpu.parallel.federation import FleetGroup as Group
    from hashgraph_tpu.wire import Vote

    placement = Placement.uniform(["h0", "h1"], 2)
    group = _host_group(pkg, Group, host_id, placement, root)
    group.start()
    print(json.dumps({"address": list(group.address), "peer_id": group.peer_id}), flush=True)
    for line in sys.stdin:
        cmd = json.loads(line)
        op = cmd["op"]
        if op == "connect":
            group.connect(cmd["host"], *cmd["address"], cmd["peer"])
            out = {}
        elif op == "create":
            proposal = group.adapter.create_proposal(
                cmd["scope"], _request(pkg, cmd["voters"]), NOW)
            out = {"proposal": proposal.encode().hex()}
        elif op == "ingest":
            items = [(s, Vote.decode(bytes.fromhex(v))) for s, v in cmd["items"]]
            out = {"statuses": group.ingest_votes(items, cmd["now"]).tolist()}
        elif op == "counts":
            out = {"counts": group.federated_state_counts()}
        elif op == "close":
            group.close()
            print(json.dumps({}), flush=True)
            return
        print(json.dumps(out), flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[2] == "trace":
        print(json.dumps(federation_trace(reference_api(), sys.argv[3])))
    else:
        reference_host(sys.argv[3], sys.argv[4])
