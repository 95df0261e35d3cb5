"""Parity: the port's multi-host pool and engine, two processes on a gloo
group, against the JAX package's under ``jax.distributed``.

Twins of ``tests/test_multihost.py``:

- the collectives probe and the gap matcher, and the federation's tally
  path in one process (``"fabric"``);
- the tally path's collective arm: two gloo processes, each a
  ``FleetGroup`` of one shard on the fabric with the other, where
  ``tally_path()`` is ``"psum"`` and ``federated_state_counts`` (one
  all-gather) equals the fabric sum (``python
  tests/test_torch_multihost.py --federation-worker DEVICE SCALE_JSON
  RANK HOST:PORT``; the JAX package's CPU backend reports the collectives
  gap there, a difference of backend);
- the two-process ``MultiHostPool``: replicated allocation, process-local
  ingest, the empty collective dispatch, summed stats, the collective
  timeout (each process gets its own slots back);
- the two-process engine on a ``MultiHostPool``: the JAX worker's whole
  surface, plus the branches the JAX package's tests leave out
  (``deliver_proposals`` on a misrouted session, wire and columnar rows of
  another process's session, the tier's refusal);
- ``_canonical_scope_bytes``.

The engine worker runs the same code on both packages (``python
tests/test_torch_multihost.py --worker port|reference DEVICE SCALE_JSON
RANK HOST:PORT``):
2 processes × 2 CPU devices each, a gloo group for the port and
``jax.distributed`` for the JAX package. Each process prints its
observations as one JSON line, and the port's must equal the JAX
package's, process by process (tolerance: exact), deterministic created
proposal id included. ``chip_smoke.py`` runs the port worker on the card
at a larger scale.

Every run binds a free port, spawns two processes, and kills them at its
timeout.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
NOW = 1_700_000_000

# Test scale: 2 processes × 2 devices × 4 slots, 8 proposals, 2 voters.
TEST_SCALE = dict(proposals=8, voters=2, per_device=4, voter_capacity=8, local_devices=2)


# ── The engine worker (both packages) ────────────────────────────────────


def port_worker_api(rank, coordinator, device, local_devices):
    import hashgraph_tpu_torch as pkg
    from hashgraph_tpu_torch.bridge import columnar
    from hashgraph_tpu_torch.engine.session_sync import state_code_of
    from hashgraph_tpu_torch.errors import InsufficientVotesAtTimeout
    from hashgraph_tpu_torch.parallel import (
        MultiHostPool,
        distributed_consensus_mesh,
        initialize_distributed,
    )
    from hashgraph_tpu_torch.parallel.multihost import process_allgather

    initialize_distributed(coordinator, 2, rank)
    mesh = distributed_consensus_mesh(local_devices, device=device)
    assert len(mesh) == 2 * local_devices

    def make_pool(per_device, voter_capacity):
        return MultiHostPool(per_device, voter_capacity, mesh=mesh)

    def make_engine(signer, pool, **kw):
        return pkg.TorchConsensusEngine(signer, pool=pool, **kw)

    def make_plain_engine(signer, capacity, voter_capacity, **kw):
        return pkg.TorchConsensusEngine(
            signer, capacity, voter_capacity, device=device, **kw
        )

    return SimpleNamespace(
        pkg=pkg, C=columnar, state_code_of=state_code_of, make_pool=make_pool,
        make_engine=make_engine, make_plain_engine=make_plain_engine,
        allgather=process_allgather, Insufficient=InsufficientVotesAtTimeout,
    )


def reference_worker_api(rank, coordinator, device, local_devices):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=2, process_id=rank
    )
    assert len(jax.local_devices()) == local_devices
    from jax.experimental import multihost_utils

    import hashgraph_tpu as pkg
    from hashgraph_tpu.bridge import columnar
    from hashgraph_tpu.engine import TpuConsensusEngine
    from hashgraph_tpu.engine.session_sync import state_code_of
    from hashgraph_tpu.errors import InsufficientVotesAtTimeout
    from hashgraph_tpu.parallel import MultiHostPool, distributed_consensus_mesh

    mesh = distributed_consensus_mesh()

    def make_pool(per_device, voter_capacity):
        return MultiHostPool(per_device, voter_capacity, mesh=mesh)

    def make_engine(signer, pool, **kw):
        return TpuConsensusEngine(signer, pool=pool, **kw)

    def make_plain_engine(signer, capacity, voter_capacity, **kw):
        return TpuConsensusEngine(
            signer, capacity=capacity, voter_capacity=voter_capacity, **kw
        )

    return SimpleNamespace(
        pkg=pkg, C=columnar, state_code_of=state_code_of, make_pool=make_pool,
        make_engine=make_engine, make_plain_engine=make_plain_engine,
        allgather=lambda a: np.asarray(multihost_utils.process_allgather(a)),
        Insufficient=InsufficientVotesAtTimeout,
    )


def engine_worker(api, rank, proposals, voters, per_device, voter_capacity,
                  local_devices, side=None):
    """The JAX package's two-process engine worker (tests/test_multihost.py),
    generalized to ``proposals`` sessions decided by ``voters`` votes each,
    with the branches its tests leave out. Returns this process's
    observations; asserts what must hold on either package."""
    pkg = api.pkg
    obs: dict = {"rank": rank}
    pool = api.make_pool(per_device, voter_capacity)
    lo, hi = pool.local_slots()
    obs["local_slots"] = [lo, hi]
    engine = api.make_engine(
        pkg.StubConsensusSigner(b"fleet-signer-00000000"[:20]), pool,
        max_sessions_per_scope=100_000,
    )
    rx = engine.event_bus().subscribe()

    def drain():
        out = []
        while (item := rx.try_recv()) is not None:
            out.append([type(item[1]).__name__, item[1].proposal_id])
        return out

    def of_kind(events, kind):
        return [pid for k, pid in events if k == kind]

    # n such that the 2/3 quorum is exactly `voters`: every vote lands OK
    # and the last one decides.
    n_main = 3 * voters // 2

    def proposal(pid, n=3, expiry=10_000, liveness=True):
        return pkg.Proposal(
            name="p%d" % pid, payload=b"", proposal_id=pid, proposal_owner=b"o" * 20,
            votes=[], expected_voters_count=n, round=1, timestamp=NOW,
            expiration_timestamp=NOW + expiry, liveness_criteria_yes=liveness,
        )

    # Control plane: deterministic proposals registered identically.
    pids = [10_000 + i for i in range(proposals)]
    for pid in pids:
        engine.process_incoming_proposal("s", proposal(pid, n=n_main), NOW)
    # A replicated create_proposal mints the SAME pid on every process.
    created = engine.create_proposal(
        "create-check",
        pkg.CreateProposalRequest(
            name="replicated", payload=b"x", proposal_owner=b"o" * 20,
            expected_voters_count=3, expiration_timestamp=60,
            liveness_criteria_yes=True,
        ),
        NOW,
    )
    agreed = api.allgather(np.array([created.proposal_id], np.int64))
    assert int(np.min(agreed)) == int(np.max(agreed)), agreed
    obs["created_pid"] = int(created.proposal_id)
    engine.delete_scope("create-check")
    local_pids = [pid for pid in pids if engine.is_local("s", pid)]
    assert 0 < len(local_pids) < proposals, local_pids

    # Data plane: one ingest_votes call a voter, each process only its own
    # sessions (collective cadence).
    voter_signers = [pkg.StubConsensusSigner(bytes([i + 1]) * 20) for i in range(voters)]
    ferries = {pid: engine.get_proposal("s", pid) for pid in pids}
    local_set = set(local_pids)
    vote_statuses = []
    for voter in voter_signers:
        batch = []
        for pid in pids:
            vote = pkg.build_vote(ferries[pid], True, voter, NOW + 1)
            ferries[pid].votes.append(vote)
            if pid in local_set:
                batch.append(("s", vote))
        statuses = engine.ingest_votes(batch, NOW + 2)
        assert (statuses == int(pkg.StatusCode.OK)).all(), statuses
        vote_statuses.append(np.bincount(statuses, minlength=1).tolist())
    obs["vote_statuses"] = vote_statuses
    events = drain()
    reached = sorted(set(of_kind(events, "ConsensusReached")))
    assert reached == sorted(local_pids), (reached, local_pids)
    obs["vote_events"] = events
    for pid in local_pids:
        assert engine.get_consensus_result("s", pid) is True

    # Misrouted vote: SESSION_NOT_FOUND here; the cadence still holds.
    remote_pid = next(pid for pid in pids if pid not in local_set)
    stray = pkg.build_vote(ferries[remote_pid], True, pkg.StubConsensusSigner(b"z" * 20), NOW + 3)
    obs["misrouted_vote"] = engine.ingest_votes([("s", stray)], NOW + 4).tolist()
    assert obs["misrouted_vote"] == [int(pkg.StatusCode.SESSION_NOT_FOUND)]
    # Misrouted delivery (no collective): SESSION_NOT_FOUND before any
    # suffix validation, though the ferry strictly extends the session.
    obs["misrouted_delivery"] = [int(x) for x in engine.deliver_proposals(
        [("s", ferries[remote_pid])], NOW + 4)]
    assert obs["misrouted_delivery"] == [int(pkg.StatusCode.SESSION_NOT_FOUND)]
    # Columnar rows of another process's session report SESSION_NOT_FOUND
    # before the gid check (the gid here is never interned); the same gid
    # on a local session is an identity rejection.
    obs["misrouted_columnar"] = engine.ingest_columnar(
        "s", np.array([remote_pid, local_pids[0]], np.int64),
        np.array([1 << 40, 1 << 40], np.int64), np.ones(2, bool), NOW + 4,
    ).tolist()
    assert obs["misrouted_columnar"] == [
        int(pkg.StatusCode.SESSION_NOT_FOUND), int(pkg.StatusCode.EMPTY_VOTE_OWNER)
    ]
    # Wire rows of another process's session: SESSION_NOT_FOUND too.
    wire_vote = pkg.build_vote(ferries[remote_pid], False, pkg.StubConsensusSigner(b"w" * 20),
                               NOW + 4)
    row = wire_vote.encode()
    data = np.frombuffer(row, np.uint8)
    offsets = np.array([0, len(row)], np.int64)
    cols, flags = api.C.parse_vote_columns(data, offsets)
    assert flags.all()
    obs["misrouted_wire"] = engine.ingest_wire_columnar(
        ["s"], np.zeros(1, np.int64), cols, data, offsets, NOW + 4
    ).tolist()
    assert obs["misrouted_wire"] == [int(pkg.StatusCode.SESSION_NOT_FOUND)]

    # Columnar on the fleet: the owner passes rows, the other process an
    # empty local batch; both join the agreed plan.
    cpid = 2000
    engine.process_incoming_proposal("s", proposal(cpid, n=4), NOW)
    c_owner = engine.is_local("s", cpid)
    cvoters = [pkg.StubConsensusSigner(bytes([40 + i]) * 20) for i in range(3)]
    ferry = engine.get_proposal("s", cpid)
    cvotes = []
    for signer in cvoters:
        vote = pkg.build_vote(ferry, True, signer, NOW + 5)
        ferry.votes.append(vote)
        cvotes.append(vote)
    if c_owner:
        st = engine.ingest_columnar(
            "s", np.full(3, cpid, np.int64),
            np.array([engine.voter_gid(v.vote_owner) for v in cvotes]),
            np.array([v.vote for v in cvotes]), NOW + 6,
            wire_votes=[v.encode() for v in cvotes],
        )
        assert (st == int(pkg.StatusCode.OK)).all(), st
        obs["exported_votes"] = len(engine.get_proposal("s", cpid).votes)
        assert obs["exported_votes"] == 3
    else:
        st = engine.ingest_columnar(
            "s", np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, bool), NOW + 6
        )
        assert len(st) == 0
    obs["columnar_statuses"] = st.tolist()
    events = drain()
    assert (cpid in of_kind(events, "ConsensusReached")) == c_owner
    obs["columnar_events"] = events

    # Collective timeouts: a deciding one, a failing one (both processes
    # raise, only the owner emits), then a sweep.
    tpid, fpid, spid = 3000, 3001, 4000
    engine.process_incoming_proposal("s", proposal(tpid, n=3), NOW)
    assert engine.handle_consensus_timeout("s", tpid, NOW + 20_000) is True
    events = drain()
    assert (tpid in of_kind(events, "ConsensusReached")) == engine.is_local("s", tpid)
    obs["timeout_events"] = events
    engine.process_incoming_proposal("s", proposal(fpid, n=2), NOW)
    try:
        engine.handle_consensus_timeout("s", fpid, NOW + 20_000)
        raise AssertionError("expected InsufficientVotesAtTimeout")
    except api.Insufficient:
        pass
    events = drain()
    assert (fpid in of_kind(events, "ConsensusFailedEvent")) == engine.is_local("s", fpid)
    obs["failed_events"] = events
    engine.process_incoming_proposal("s", proposal(spid, n=3, expiry=10), NOW)
    swept = engine.sweep_timeouts(NOW + 100)
    obs["swept"] = sorted([pid, result] for _, pid, result in swept)
    assert (spid in [pid for _, pid, _ in swept]) == engine.is_local("s", spid)
    obs["sweep_events"] = drain()
    # Fleet-wide truth after the collective sweep synced the state mirror.
    for pid in pids + [cpid, tpid, spid]:
        assert engine.get_consensus_result("s", pid) is True, pid
    stats = engine.get_scope_stats("s")
    obs["stats"] = [stats.total_sessions, stats.active_sessions,
                    stats.consensus_reached, stats.failed_sessions]
    assert obs["stats"] == [proposals + 4, 0, proposals + 3, 1], obs["stats"]
    obs["global_counts"] = {str(k): v for k, v in pool.global_state_counts().items()}

    # The tier is refused on a multi-host pool.
    try:
        engine.demote_session("s", pids[0])
        obs["demote"] = "returned"
    except RuntimeError as exc:
        obs["demote"] = type(exc).__name__
    assert obs["demote"] == "RuntimeError"
    obs["lifecycle"] = engine.lifecycle_sweep(NOW + 10**9)
    assert obs["lifecycle"] == {"demoted": 0, "gc_live": 0, "gc_tier": 0}

    # Fill the remaining slots so the next 9 sessions spill to the host:
    # replicated everywhere, votes applied fleet-wide, events from
    # process 0 only.
    drain()
    for pid in [4500 + i for i in range(engine.pool().free_slots)]:
        engine.process_incoming_proposal("fill", proposal(pid, n=3), NOW)
    assert engine.pool().free_slots == 0
    mscopes = ["m0", "m1", "m2"]
    mpids = {s: [5000 + 100 * k + j for j in range(3)] for k, s in enumerate(mscopes)}
    for s in mscopes:
        for pid in mpids[s]:
            engine.process_incoming_proposal(s, proposal(pid, n=3), NOW)
            assert engine.is_local(s, pid)  # replicated spill: local everywhere
    mv = [pkg.StubConsensusSigner(bytes([70 + i]) * 20) for i in range(2)]
    col_sidx, col_pids, col_gids = [], [], []
    for k, s in enumerate(mscopes):
        for pid in mpids[s]:
            ferry = engine.get_proposal(s, pid)
            for voter in mv:
                v = pkg.build_vote(ferry, True, voter, NOW + 7)
                ferry.votes.append(v)
                col_sidx.append(k)
                col_pids.append(pid)
                col_gids.append(engine.voter_gid(v.vote_owner))
    st = engine.ingest_columnar_multi(
        mscopes, np.array(col_sidx, np.int64), np.array(col_pids, np.int64),
        np.array(col_gids, np.int64), np.ones(len(col_pids), bool), NOW + 8,
    )
    assert (st == int(pkg.StatusCode.OK)).all(), st
    m_events = sorted(of_kind(drain(), "ConsensusReached"))
    assert m_events == (sorted(p for s in mscopes for p in mpids[s]) if rank == 0 else [])
    obs["spill_events"] = m_events
    obs["spill_stats"] = []
    for s in mscopes:
        mstats = engine.get_scope_stats(s)
        obs["spill_stats"].append([mstats.total_sessions, mstats.active_sessions,
                                   mstats.consensus_reached, mstats.failed_sessions])
    assert obs["spill_stats"] == [[3, 0, 3, 0]] * 3

    # Fleet checkpoint: byte-identical stored state on every process, and a
    # fresh engine restores it.
    storage = pkg.InMemoryConsensusStorage()
    for s in mscopes:
        for pid in mpids[s]:
            storage.save_session(s, engine.export_session(s, pid))
    digest = hashlib.sha256()
    for s in mscopes:
        for sess in sorted(storage.list_scope_sessions(s), key=lambda x: x.proposal.proposal_id):
            digest.update(sess.proposal.encode())
            digest.update(bytes([api.state_code_of(sess.state)]))
            digest.update(repr(sorted(sess.tallies.items())).encode())
    agreed = api.allgather(np.frombuffer(digest.digest()[:8], np.int64).copy())
    assert int(np.min(agreed)) == int(np.max(agreed)), "fleet desync"
    obs["digest"] = digest.hexdigest()
    restored = api.make_plain_engine(
        pkg.StubConsensusSigner(b"fleet-signer-00000000"[:20]), 16, voter_capacity,
        max_sessions_per_scope=64,
    )
    assert restored.load_from_storage(storage) == 9
    for s in mscopes:
        for pid in mpids[s]:
            assert restored.get_consensus_result(s, pid) is True
            assert len(restored.export_session(s, pid).tallies) == 2

    obs["owned"] = sorted(
        local_pids + [p for p in (cpid, tpid, fpid, spid) if engine.is_local("s", p)]
    )
    if side is not None and hasattr(pool, "scan_dispatches"):
        side["scan_dispatches"] = list(pool.scan_dispatches)
    return obs


def run_worker(kind, rank, coordinator, device, scale):
    """One rank of the engine worker: its observations, and for the port the
    kernel launches it made and its pool's scan dispatches a block."""
    api = (port_worker_api if kind == "port" else reference_worker_api)(
        rank, coordinator, device, scale["local_devices"]
    )
    side: dict = {}
    obs = engine_worker(api, rank, side=side, **scale)
    if kind == "port":
        from hashgraph_tpu_torch import _build

        side["launches"] = dict(_build.launches)
    return obs, side


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_pair(args, env, timeout):
    """Run two worker processes (ranks 0 and 1) of ``args + [rank,
    coordinator]``; returns their (returncode, stdout, stderr). Kills
    both when the timeout passes."""
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [
        subprocess.Popen(
            args + [str(rank), coordinator], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=str(REPO),
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=timeout)
            outs.append((proc.returncode, out, err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def worker_env(kind):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    if kind == "reference":
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    return env


def run_engine_workers(kind, device="cpu", scale=TEST_SCALE, timeout=300, sides=None):
    """Both ranks' observations (parsed from their last stdout lines); the
    lines before them (launches, scan dispatches) go to ``sides``."""
    outs = spawn_pair(
        [sys.executable, str(Path(__file__).resolve()), "--worker", kind, device,
         json.dumps(scale)],
        worker_env(kind), timeout,
    )
    observed = []
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"{kind} rank {rank} failed:\n{out[-3000:]}\n{err[-6000:]}"
        lines = out.strip().splitlines()
        observed.append(json.loads(lines[-1]))
        if sides is not None:
            sides.append(json.loads(lines[-2]))
    return observed


# ── Tests ────────────────────────────────────────────────────────────────

@pytest.fixture(scope="module")
def port_run():
    return run_engine_workers("port")

@pytest.fixture(scope="module")
def reference_run():
    return run_engine_workers("reference")

def test_collectives_probe_single_process():
    """Without a process group the probe is trivially True and
    memoizes."""
    from hashgraph_tpu_torch.parallel.multihost import collectives_available

    assert collectives_available(refresh=True) is True
    assert collectives_available() is True

def test_agree_trace_context_single_process():
    """Without a process group this process is process 0: its context is
    the agreed one, and no context agrees on none."""
    from hashgraph_tpu_torch.obs.trace import TraceContext
    from hashgraph_tpu_torch.parallel import agree_trace_context

    ctx = TraceContext.generate()
    assert agree_trace_context(ctx).to_wire() == ctx.to_wire()
    assert agree_trace_context() is None


def test_collectives_gap_signature_matcher():
    """The discriminator accepts exceptions and strings, matches only
    the known backend-gap signature, and never a generic failure."""
    from hashgraph_tpu_torch.parallel import multihost as mh

    wrapped = RuntimeError(
        "INVALID_ARGUMENT: " + mh.COLLECTIVES_GAP_SIGNATURE + " (dispatch)"
    )
    assert mh.is_collectives_gap(wrapped)
    assert mh.is_collectives_gap(mh.COLLECTIVES_GAP_SIGNATURE)
    assert not mh.is_collectives_gap(RuntimeError("connection refused"))
    assert not mh.is_collectives_gap(ValueError("shape mismatch"))
    from hashgraph_tpu.parallel import multihost as ref_mh

    assert mh.COLLECTIVES_GAP_SIGNATURE == ref_mh.COLLECTIVES_GAP_SIGNATURE

def test_collectives_probe_drives_federation_tally_path():
    """The federation's tally-path selector consults the probe: in one
    process there is no process group, so cross-host tallies ride the
    gossip fabric's OP_FLEET_TALLY frames, not the collective — as in the
    JAX package."""
    from hashgraph_tpu.parallel.federation import tally_path as ref_tally_path
    from hashgraph_tpu_torch.parallel.federation import tally_path
    from hashgraph_tpu_torch.parallel.multihost import process_count

    assert process_count() == 1
    assert tally_path() == "fabric" == ref_tally_path()


FEDERATION_SCALE = dict(proposals=20, voters=8)


def run_federation_workers(device="cpu", scale=FEDERATION_SCALE, timeout=200, sides=None):
    """Both ranks' observations from the federation worker (last stdout
    line); the launches line before it goes to ``sides``."""
    outs = spawn_pair(
        [sys.executable, str(Path(__file__).resolve()), "--federation-worker", device,
         json.dumps(scale)],
        worker_env("port"), timeout,
    )
    observed = []
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"federation rank {rank} failed:\n{out[-3000:]}\n{err[-6000:]}"
        lines = out.strip().splitlines()
        observed.append(json.loads(lines[-1]))
        if sides is not None:
            sides.append(json.loads(lines[-2]))
    return observed


def test_two_process_federation_tally_rides_the_collective():
    """Two gloo processes, one FleetGroup each: ``tally_path()`` is
    ``"psum"`` (gloo runs the all-gather, on the CPU too), and the
    collective's counts equal the fabric's OP_FLEET_TALLY sum, on both
    ranks."""
    from hashgraph_tpu_torch.ops.decide import STATE_ACTIVE, STATE_REACHED_YES

    observed = run_federation_workers()
    for obs in observed:
        assert obs["tally_path"] == "psum"
        assert obs["psum"] == obs["fabric"]
        assert obs["psum"] == observed[0]["psum"]
    counts = observed[0]["psum"]
    per_host = FEDERATION_SCALE["proposals"]
    assert counts[str(STATE_REACHED_YES)] == per_host  # the even half, on each host
    assert counts[str(STATE_ACTIVE)] == per_host
    from hashgraph_tpu_torch import StatusCode

    snf = int(StatusCode.SESSION_NOT_FOUND)
    assert [obs["remote"] for obs in observed] == [[snf] * 4] * 2


def federation_worker(rank, coordinator, device, proposals, voters):
    """One rank of the federation worker: a FleetGroup of one shard on
    ``device``, hosting ``proposals`` sessions of ``voters`` voters in
    four scopes it owns; the deciding ceil(2n/3) votes of the even
    sessions and three of the odd ones, wave by wave (a vote after the
    decision would be absorbed, and the next one would link past it).
    Returns its observations."""
    import tempfile

    import torch
    import torch.distributed as dist

    import hashgraph_tpu_torch as pkg
    from hashgraph_tpu_torch import _build
    from hashgraph_tpu_torch.parallel import (
        FederationPlacement,
        FleetGroup,
        initialize_distributed,
        tally_path,
    )
    from hashgraph_tpu_torch.parallel.multihost import process_allgather

    initialize_distributed(coordinator, 2, rank)
    hosts = ["r0", "r1"]
    me, other = hosts[rank], hosts[1 - rank]
    placement = FederationPlacement.uniform(hosts, 1)
    obs = {}
    with tempfile.TemporaryDirectory() as root:
        group = FleetGroup(
            me, lambda k: pkg.StubConsensusSigner(bytes([16 * rank + k + 1]) * 20),
            placement=placement, wal_root=root, capacity_per_shard=proposals,
            voter_capacity=voters, fsync_policy="off", devices=[torch.device(device)],
        )
        try:
            group.start()
            ports = process_allgather(np.array([group.address[1], group.peer_id], np.int64))
            group.connect(other, "127.0.0.1", int(ports[1 - rank][0]), int(ports[1 - rank][1]))
            mine = [s for s in (f"fed-{i}" for i in range(1000))
                    if placement.owner(s)[0] == me][:4]
            theirs = [s for s in (f"fed-{i}" for i in range(1000))
                      if placement.owner(s)[0] == other][:4]
            request = pkg.CreateProposalRequest(
                name="p", payload=b"", proposal_owner=b"o" * 20,
                expected_voters_count=voters, expiration_timestamp=3600,
                liveness_criteria_yes=True,
            )
            sessions = []
            for k in range(proposals):
                scope = mine[k % 4]
                proposal = group.adapter.create_proposal(scope, request, NOW)
                sessions.append((scope, proposal))
            signers = [pkg.StubConsensusSigner(b"voter-%d" % j) for j in range(voters)]
            quorum = -(-2 * voters // 3)
            _build.launches.clear()
            for j in range(quorum):
                items = []
                for k, (scope, proposal) in enumerate(sessions):
                    if k % 2 == 0 or j < 3:
                        vote = pkg.build_vote(proposal, True, signers[j], NOW + 1)
                        proposal.votes.append(vote)
                        items.append((scope, vote))
                statuses = group.ingest_votes(items, NOW + 1)
                assert set(statuses.tolist()) == {0}, (j, statuses.tolist())
            launches = dict(_build.launches)
            # A vote for each of the other host's scopes rides the fabric
            # and comes back SESSION_NOT_FOUND from the owner (no such
            # session there).
            probe = pkg.CreateProposalRequest(
                name="probe", payload=b"", proposal_owner=b"o" * 20,
                expected_voters_count=3, expiration_timestamp=3600,
                liveness_criteria_yes=True,
            )
            process_allgather(np.ones(1, np.int64))  # both hosts' traffic is in
            remote = []
            for scope in theirs:
                created = pkg.TorchConsensusEngine(
                    pkg.StubConsensusSigner(b"w" * 20), capacity=4, voter_capacity=4,
                    device="cpu").create_proposal(scope, probe, NOW)
                vote = pkg.build_vote(created, True, signers[0], NOW + 2)
                remote.append(int(group.ingest_votes([(scope, vote)], NOW + 2)[0]))
            obs["remote"] = remote
            process_allgather(np.ones(1, np.int64))
            obs["tally_path"] = tally_path()
            obs["psum"] = {str(k): v for k, v in group.federated_state_counts().items()}
            fabric = dict(group.fleet.fleet_state_counts())
            for counts in group._fabric_tallies().values():
                for code, count in counts.items():
                    fabric[code] = fabric.get(code, 0) + count
            obs["fabric"] = {str(k): v for k, v in fabric.items()}
            process_allgather(np.ones(1, np.int64))  # both fabric reads are done
        finally:
            group.close()
            dist.destroy_process_group()
    return obs, {"launches": launches}


def test_two_process_multihost_pool():
    """Twin of the JAX package's pool worker: replicated allocation,
    process-local ingest, summed stats, the empty collective dispatch
    and the collective timeout."""
    outs = spawn_pair(
        [sys.executable, str(Path(__file__).resolve()), "--pool-worker"],
        worker_env("port"), 200,
    )
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{out[-3000:]}\n{err[-6000:]}"
        assert f"MULTIHOST_OK p{rank}" in out, out

def test_two_process_engine_on_multihost_pool(port_run):
    """The engine surface from two processes: ownership partitions the
    sessions, so no event is emitted by both."""
    owned = [set(obs["owned"]) for obs in port_run]
    assert owned[0] & owned[1] == set(), owned
    assert len(owned[0]) > 0 and len(owned[1]) > 0
    assert [obs["local_slots"] for obs in port_run] == [[0, 8], [8, 16]]
    assert port_run[0]["created_pid"] == port_run[1]["created_pid"]

def test_multihost_branches_the_reference_tests_leave_out(port_run):
    """Misrouted deliveries, columnar and wire rows report
    SESSION_NOT_FOUND (columnar: before the gid check), and the tier is
    refused on a multi-host pool (asserted inside the worker too)."""
    from hashgraph_tpu_torch import StatusCode

    snf = int(StatusCode.SESSION_NOT_FOUND)
    for obs in port_run:
        assert obs["misrouted_delivery"] == [snf]
        assert obs["misrouted_wire"] == [snf]
        assert obs["misrouted_columnar"] == [snf, int(StatusCode.EMPTY_VOTE_OWNER)]
        assert obs["demote"] == "RuntimeError"
        assert obs["lifecycle"] == {"demoted": 0, "gc_live": 0, "gc_tier": 0}

def test_engine_worker_matches_reference(port_run, reference_run):
    """The same worker on both packages: every observation equal,
    process by process."""
    for port_obs, ref_obs in zip(port_run, reference_run):
        assert sorted(port_obs) == sorted(ref_obs)
        for key in ref_obs:
            assert port_obs[key] == ref_obs[key], key

def test_canonical_scope_bytes_rejects_default_repr():
    """Deterministic multi-host pids hash the scope; a default object
    repr embeds a memory address, so non-canonical scope types are a
    hard error. The encoding equals the JAX package's."""
    from hashgraph_tpu.engine.engine import _canonical_scope_bytes as ref
    from hashgraph_tpu_torch.engine.engine import _canonical_scope_bytes

    assert _canonical_scope_bytes("s") == b"s:s"
    assert _canonical_scope_bytes(b"s") == b"b:s"
    assert _canonical_scope_bytes(7) == b"i:7"
    for scope in ("s", b"s", 7, True, bytearray(b"q")):
        assert _canonical_scope_bytes(scope) == ref(scope)

    class Opaque:
        pass

    with pytest.raises(TypeError, match="canonical"):
        _canonical_scope_bytes(Opaque())


def pool_worker(process_id: int, coordinator: str) -> None:
    """Twin of the JAX package's two-process pool worker."""
    from hashgraph_tpu_torch.ops.decide import STATE_ACTIVE, STATE_REACHED_YES, required_votes_np
    from hashgraph_tpu_torch.obs.trace import TraceContext
    from hashgraph_tpu_torch.parallel import (
        MultiHostPool, agree_trace_context, distributed_consensus_mesh,
        initialize_distributed, local_slot_range,
    )
    from hashgraph_tpu_torch.parallel.multihost import process_allgather

    initialize_distributed(coordinator, 2, process_id)
    NOW = 1_700_000_000
    mesh = distributed_consensus_mesh(2, device="cpu")
    pool = MultiHostPool(capacity_per_device=4, voter_capacity=8, mesh=mesh)
    assert pool.capacity == 16
    lo, hi = pool.local_slots()
    assert (lo, hi) == ((0, 8) if process_id == 0 else (8, 16)), (lo, hi)
    assert [b is not None for b in pool._blocks] == [process_id == 0] * 2 + [process_id == 1] * 2

    P = 8
    slots = pool.allocate_batch(
        keys=[("s", i) for i in range(P)], n=np.full(P, 3),
        req=required_votes_np(np.full(P, 3), 2.0 / 3.0), cap=np.full(P, 2),
        gossip=np.ones(P, bool), liveness=np.full(P, True),
        expiry=np.array([NOW + (10_000 if i % 2 == 0 else 10) for i in range(P)]),
        created_at=np.full(P, NOW),
    )
    assert slots == [0, 4, 8, 12, 1, 5, 9, 13], slots

    mine = [s for s in slots if lo <= s < hi]
    assert len(mine) == 4
    for lane in range(2):
        pending = pool.ingest_async(np.array(mine, np.int64), np.full(4, lane, np.int32),
                                    np.ones(4, bool), NOW)
        statuses, transitions = pool.complete(pending)
        assert list(statuses) == [0, 0, 0, 0], statuses
    assert {s for s, _ in transitions} == set(mine)
    assert all(st == STATE_REACHED_YES for _, st in transitions)

    counts = pool.global_state_counts()
    assert counts[STATE_REACHED_YES] == 8, counts
    assert counts[STATE_ACTIVE] == 0, counts

    pending = pool.ingest_async(np.empty(0, np.int64), np.empty(0, np.int32), np.empty(0, bool), NOW)
    st, tr = pool.complete(pending)
    assert len(st) == 0 and tr == []

    try:
        pool.ingest_async(np.array([(mine[0] + 8) % 16]), np.zeros(1, np.int32), np.ones(1, bool), NOW)
        raise AssertionError("a non-local slot must be refused")
    except ValueError:
        pass

    swept = pool.timeout(slots)
    assert {s for s, _ in swept} == set(mine), swept
    assert all(st == STATE_REACHED_YES for _, st in swept)
    pool.sync_states()
    assert pool.state_counts()[STATE_REACHED_YES] == 8

    # Process 0's trace context wins everywhere; none on process 0, none
    # agreed.
    assert local_slot_range(4, mesh) == (lo, hi)
    agreed = agree_trace_context(TraceContext.generate())
    wires = process_allgather(np.frombuffer(agreed.to_wire(), np.uint8))
    assert (wires[0] == wires[1]).all()
    assert agree_trace_context() is None

    print(f"MULTIHOST_OK p{process_id} slots={mine}")


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    kind, device, scale = sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
    rank, coordinator = int(sys.argv[5]), sys.argv[6]
    sys.path.insert(0, str(REPO))
    obs, side = run_worker(kind, rank, coordinator, device, scale)
    print(json.dumps(side, sort_keys=True))
    print(json.dumps(obs, sort_keys=True))
elif __name__ == "__main__" and sys.argv[1:2] == ["--federation-worker"]:
    device, scale = sys.argv[2], json.loads(sys.argv[3])
    rank, coordinator = int(sys.argv[4]), sys.argv[5]
    sys.path.insert(0, str(REPO))
    obs, side = federation_worker(rank, coordinator, device, **scale)
    print(json.dumps(side, sort_keys=True))
    print(json.dumps(obs, sort_keys=True))
elif __name__ == "__main__" and sys.argv[1:2] == ["--pool-worker"]:
    sys.path.insert(0, str(REPO))
    pool_worker(int(sys.argv[2]), sys.argv[3])
