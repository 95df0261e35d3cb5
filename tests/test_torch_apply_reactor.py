"""The port's apply reactor: cross-connection continuous batching on the
wire path, over ``TorchConsensusEngine`` on the CPU.

A twin of ``tests/test_apply_reactor.py``: merge correctness against the
single-dispatch oracle, window scheduling rules (equal-``now`` merges,
rows/bytes closes, manual-mode determinism, adaptive delay), error
scatter, reactor-on vs reactor-off DECISION IDENTITY on a randomized
multi-connection workload (byte-identical fingerprints AND per-row
statuses), and the serial-lane admission shed counting queued reactor
rows. The reference's two simulator tests wait for the port of ``sim/``."""

import random
import sys
import threading

import numpy as np
import pytest
import torch

from hashgraph_tpu_torch import build_vote
from hashgraph_tpu_torch.bridge import columnar as WC
from hashgraph_tpu_torch.bridge import protocol as P
from hashgraph_tpu_torch.bridge.reactor import (
    ApplyReactor,
    merge_entries,
    reactor_enabled,
)
from hashgraph_tpu_torch.bridge.server import BridgeServer
from hashgraph_tpu_torch.signing.stub import StubConsensusSigner
from hashgraph_tpu_torch.sync.snapshot import state_fingerprint
from hashgraph_tpu_torch.wire import Proposal, Vote

NOW = 1_700_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _columnar(votes: "list[bytes]"):
    """(cols, data, offsets) for a list of canonical wire-vote blobs."""
    offsets = np.zeros(len(votes) + 1, np.int64)
    np.cumsum([len(v) for v in votes], out=offsets[1:])
    data = np.frombuffer(b"".join(votes), np.uint8)
    cols, flags = WC.parse_vote_columns(data, offsets)
    assert flags.all()
    return cols, data, offsets


def _proposal(pid: int, voters: int = 64, tag: str = "p") -> Proposal:
    return Proposal(
        name=f"{tag}-{pid}",
        payload=b"x",
        proposal_id=pid,
        proposal_owner=b"\x11" * 20,
        expected_voters_count=voters,
        timestamp=NOW,
        expiration_timestamp=NOW + 3_600,
        liveness_criteria_yes=True,
    )


def _chain(proposal: Proposal, n: int, salt: int = 0) -> "list[bytes]":
    out = []
    for i in range(n):
        signer = StubConsensusSigner(bytes([salt + i + 1]) * 20)
        vote = build_vote(proposal, True, signer, NOW + 1)
        proposal.votes.append(vote)
        out.append(vote.encode())
    return out


class _RecordingEngine:
    """Columnar-capable fake: records each fused dispatch and returns
    row-index codes so scatter slices are checkable."""

    def __init__(self, fail=False):
        self.calls = []
        self.fail = fail

    def ingest_wire_columnar(
        self, scopes, scope_idx, cols, data, offsets, now,
        max_depth=8, stage_seconds=None, _prepass=None, _buf=None,
    ):
        if self.fail:
            raise RuntimeError("engine exploded")
        self.calls.append(
            (list(scopes), np.asarray(scope_idx).copy(),
             np.asarray(cols).copy(), np.asarray(data).copy(),
             np.asarray(offsets).copy(), now)
        )
        if stage_seconds is not None:
            stage_seconds["apply"] = stage_seconds.get("apply", 0.0) + 0.001
        return np.arange(len(cols), dtype=np.int64)


class TestMergeEntries:
    def test_merged_frame_is_bytewise_consistent(self):
        """Two frames merged: offsets contiguous over the concatenated
        data, every shifted byte-offset column still points at the same
        bytes (owner + signature spot-checked per row)."""
        p1, p2 = _proposal(1), _proposal(2)
        votes_a = _chain(p1, 3, salt=0)
        votes_b = _chain(p2, 2, salt=10)
        reactor = ApplyReactor()
        engine = _RecordingEngine()
        reactor.submit(engine, ["a"], np.zeros(3, np.int64),
                       *_columnar(votes_a), NOW + 1)
        reactor.submit(engine, ["b"], np.zeros(2, np.int64),
                       *_columnar(votes_b), NOW + 1)
        reactor.flush()
        assert len(engine.calls) == 1  # ONE fused dispatch
        scopes, sidx, cols, data, offsets, now = engine.calls[0]
        assert scopes == ["a", "b"]
        assert sidx.tolist() == [0, 0, 0, 1, 1]
        assert now == NOW + 1
        blobs = votes_a + votes_b
        assert offsets[0] == 0 and offsets[-1] == len(data)
        buf = data.tobytes()
        for i, blob in enumerate(blobs):
            assert buf[int(offsets[i]):int(offsets[i + 1])] == blob
            vote = Vote.decode(blob)
            o, ol = int(cols[i][WC.COL_OWNER_OFF]), int(cols[i][WC.COL_OWNER_LEN])
            assert buf[o:o + ol] == vote.vote_owner
            s, sl = int(cols[i][WC.COL_SIG_OFF]), int(cols[i][WC.COL_SIG_LEN])
            assert buf[s:s + sl] == vote.signature

    def test_scatter_slices_codes_back_per_entry(self):
        reactor = ApplyReactor()
        engine = _RecordingEngine()
        p1, p2 = _proposal(1), _proposal(2)
        h1 = reactor.submit(engine, ["a"], np.zeros(3, np.int64),
                            *_columnar(_chain(p1, 3)), NOW + 1)
        h2 = reactor.submit(engine, ["b"], np.zeros(2, np.int64),
                            *_columnar(_chain(p2, 2, salt=10)), NOW + 1)
        reactor.flush()
        assert h1.wait(1).tolist() == [0, 1, 2]
        assert h2.wait(1).tolist() == [3, 4]  # rows 3-4 of the fusion

    def test_merged_prepass_chains_sources_and_joins_bufs(self):
        from hashgraph_tpu_torch.engine.engine import WireVotePrepass

        p1, p2 = _proposal(1), _proposal(2)

        class _E:
            def __init__(self, blobs):
                self.blobs = blobs

        entries = []
        row_base = 0
        for blobs in (_chain(p1, 2), _chain(p2, 3, salt=10)):
            cols, data, offsets = _columnar(blobs)
            pre = np.zeros(len(blobs), np.int32)
            pre[0] = 7  # a pre-rejected row per entry
            crypto = np.nonzero(pre == 0)[0].astype(np.int64)
            verdicts = [True] * len(crypto)
            prepass = WireVotePrepass(
                pre, crypto, lambda v=verdicts: v, buf=data.tobytes()
            )
            from hashgraph_tpu_torch.bridge.reactor import _Entry, ReactorHandle

            entries.append(_Entry(
                ["s"], np.zeros(len(blobs), np.int64), cols, data, offsets,
                prepass, ReactorHandle(len(blobs)),
            ))
            row_base += len(blobs)
        scopes, sidx, cols, data, offsets, merged = merge_entries(entries)
        assert merged.pre_status.tolist() == [7, 0, 7, 0, 0]
        assert merged.crypto_rows.tolist() == [1, 3, 4]  # shifted by row base
        assert merged.buf == data.tobytes()
        assert len(merged.collect()) == 3


class TestWindowRules:
    def test_manual_mode_dispatches_nothing_until_flush(self):
        reactor = ApplyReactor()
        engine = _RecordingEngine()
        p = _proposal(1)
        handle = reactor.submit(engine, ["a"], np.zeros(2, np.int64),
                                *_columnar(_chain(p, 2)), NOW + 1)
        assert not handle.done and not engine.calls
        assert reactor.pending(engine) == (1, 2)
        reactor.flush(engine)
        assert handle.done and len(engine.calls) == 1
        assert reactor.pending(engine) == (0, 0)

    def test_now_change_closes_the_open_window(self):
        reactor = ApplyReactor()
        engine = _RecordingEngine()
        p1, p2 = _proposal(1), _proposal(2)
        reactor.submit(engine, ["a"], np.zeros(2, np.int64),
                       *_columnar(_chain(p1, 2)), NOW + 1)
        reactor.submit(engine, ["b"], np.zeros(2, np.int64),
                       *_columnar(_chain(p2, 2, salt=10)), NOW + 2)
        reactor.flush()
        # Different logical now NEVER merges: two dispatches, each at
        # its own now — the unconditional determinism guarantee.
        assert [call[5] for call in engine.calls] == [NOW + 1, NOW + 2]

    def test_engines_get_separate_windows(self):
        reactor = ApplyReactor()
        e1, e2 = _RecordingEngine(), _RecordingEngine()
        p1, p2 = _proposal(1), _proposal(2)
        reactor.submit(e1, ["a"], np.zeros(2, np.int64),
                       *_columnar(_chain(p1, 2)), NOW + 1)
        reactor.submit(e2, ["b"], np.zeros(2, np.int64),
                       *_columnar(_chain(p2, 2, salt=10)), NOW + 1)
        reactor.flush()
        assert len(e1.calls) == 1 and len(e2.calls) == 1

    def test_max_rows_closes_and_preserves_order(self):
        reactor = ApplyReactor(max_rows=4)
        engine = _RecordingEngine()
        handles = []
        for i in range(3):
            p = _proposal(i + 1)
            handles.append(reactor.submit(
                engine, [f"s{i}"], np.zeros(2, np.int64),
                *_columnar(_chain(p, 2, salt=10 * i)), NOW + 1,
            ))
        reactor.flush()
        # 2+2 rows hit max_rows=4 -> window 1; the third frame opens
        # window 2. Creation order is dispatch order.
        assert [len(call[0]) for call in engine.calls] == [2, 1]
        for handle in handles:
            assert handle.wait(1) is not None

    def test_adaptive_delay_shrinks_and_grows(self):
        reactor = ApplyReactor(max_rows=2, max_delay=0.001, min_delay=0.0001)
        engine = _RecordingEngine()
        p = _proposal(1)
        start = reactor._delay
        reactor.submit(engine, ["a"], np.zeros(2, np.int64),
                       *_columnar(_chain(p, 2)), NOW + 1)  # rows close
        grown = reactor._delay
        assert grown == start  # already at max_delay, growth capped
        # Single-entry deadline close halves the delay.
        p2 = _proposal(2)
        reactor.submit(engine, ["b"], np.zeros(1, np.int64),
                       *_columnar(_chain(p2, 1, salt=10)), NOW + 1)
        reactor._close(reactor._queues[id(engine)], "deadline")
        assert reactor._delay < grown
        reactor.flush()

    def test_dispatch_error_reaches_every_handle(self):
        reactor = ApplyReactor()
        engine = _RecordingEngine(fail=True)
        p1, p2 = _proposal(1), _proposal(2)
        h1 = reactor.submit(engine, ["a"], np.zeros(2, np.int64),
                            *_columnar(_chain(p1, 2)), NOW + 1)
        h2 = reactor.submit(engine, ["b"], np.zeros(2, np.int64),
                            *_columnar(_chain(p2, 2, salt=10)), NOW + 1)
        reactor.flush()
        for handle in (h1, h2):
            assert handle.done and handle.error is not None
            with pytest.raises(RuntimeError, match="engine exploded"):
                handle.wait(1)

    def test_started_mode_deadline_flushes_without_explicit_flush(self):
        reactor = ApplyReactor(max_delay=0.005, min_delay=0.005,
                               adaptive=False)
        engine = _RecordingEngine()
        reactor.start()
        try:
            p = _proposal(1)
            handle = reactor.submit(engine, ["a"], np.zeros(2, np.int64),
                                    *_columnar(_chain(p, 2)), NOW + 1)
            assert handle.wait(5.0).tolist() == [0, 1]
        finally:
            reactor.stop()

    def test_stop_drains_queued_windows(self):
        reactor = ApplyReactor(max_delay=60.0, min_delay=60.0,
                               adaptive=False)
        engine = _RecordingEngine()
        reactor.start()
        p = _proposal(1)
        handle = reactor.submit(engine, ["a"], np.zeros(2, np.int64),
                                *_columnar(_chain(p, 2)), NOW + 1)
        reactor.stop()  # never hit the 60s deadline: stop must drain
        assert handle.done and handle.wait(0).tolist() == [0, 1]

    def test_env_override_contract(self, monkeypatch):
        monkeypatch.delenv("HASHGRAPH_TPU_APPLY_REACTOR", raising=False)
        assert reactor_enabled(None) is False  # default OFF
        assert reactor_enabled(True) is True
        monkeypatch.setenv("HASHGRAPH_TPU_APPLY_REACTOR", "1")
        assert reactor_enabled(None) is True
        assert reactor_enabled(False) is False  # explicit wins


# ── decision identity: reactor on == reactor off, exactly ──────────────


def _build_plans(n_conns: int, seed: int):
    """Per-connection replayable workload plans: ``(scope, proposal
    blob, vote-blob chunks)`` built ONCE so both arms of an A/B see
    byte-identical wire traffic (``build_vote`` mints uuid4 vote ids —
    regenerating per arm would diverge the *inputs*, not the arms)."""
    rng = random.Random(seed)
    plans = []
    for c in range(n_conns):
        plan = []
        for p in range(rng.randint(1, 3)):
            scope = f"c{c}-s{p}"
            voters = rng.randint(6, 18)
            proposal = _proposal(1 + c * 10 + p, voters=voters + 10,
                                 tag=scope)
            blob = proposal.encode()
            votes = []
            for i in range(voters):
                signer = StubConsensusSigner(
                    bytes([c * 40 + i + 1]) * 20
                )
                vote = build_vote(proposal, True, signer, NOW + 1)
                proposal.votes.append(vote)
                votes.append(vote.encode())
            size = rng.choice((2, 3, 5))
            chunks = [votes[i:i + size] for i in range(0, len(votes), size)]
            plan.append((scope, blob, chunks))
        plans.append(plan)
    return plans


def _run_workload(server: BridgeServer, plans):
    """Replay pre-built plans: one REAL TCP connection per plan, each
    owning disjoint scopes, firing interleaved chunked vote batches
    from its own thread. Returns (statuses by (conn, frame), state
    fingerprint)."""
    from hashgraph_tpu_torch.bridge.client import BridgeClient

    host, port = server.address
    setup = BridgeClient(host, port, timeout=30.0)
    pid, _identity = setup.add_peer(b"\x11" * 32)
    for plan in plans:
        for scope, blob, _chunks in plan:
            setup.process_proposal(pid, scope, blob, NOW)
    results: dict = {}
    errors: list = []

    def run_conn(c: int) -> None:
        try:
            client = BridgeClient(host, port, timeout=30.0)
            try:
                frames = []
                for scope, _blob, chunks in plans[c]:
                    for part in chunks:
                        status_list = client.process_votes(
                            pid, scope, part, NOW + 1
                        )
                        frames.append((scope, tuple(status_list)))
                results[c] = frames
            finally:
                client.close()
        except Exception as exc:  # pragma: no cover - surfaced below
            errors.append((c, exc))

    threads = [
        threading.Thread(target=run_conn, args=(c,))
        for c in range(len(plans))
    ]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(60)
    assert not errors, errors
    fingerprint = setup.state_fingerprint(pid)
    setup.close()
    return results, fingerprint


@pytest.mark.parametrize("seed", [11, 23, 3, 47, 101])
def test_decision_identity_reactor_on_vs_off(seed):
    """The tentpole's safety bar: a randomized multi-connection workload
    produces BYTE-IDENTICAL per-row statuses and state fingerprints with
    the reactor on and off. Per-connection scopes are disjoint (rows
    within one window from different connections are order-free, same
    as today's concurrent dispatches), so statuses are deterministic."""
    plans = _build_plans(n_conns=3, seed=seed)
    outcomes = {}
    for pin in (False, True):
        server = BridgeServer(
            capacity=64, voter_capacity=40,
            signer_factory=StubConsensusSigner,
            wire_columnar=True,
            device="cpu",
            apply_reactor=(
                ApplyReactor(max_delay=0.002, min_delay=0.0005)
                if pin else False
            ),
        )
        server.start()
        try:
            outcomes[pin] = _run_workload(server, plans)
        finally:
            server.stop()
    (status_off, fp_off), (status_on, fp_on) = outcomes[False], outcomes[True]
    assert status_on == status_off
    assert fp_on == fp_off


def test_sync_dispatch_parity_with_mixed_bad_rows():
    """Embedded (manual-reactor) parity including per-row errors: a
    flipped signature and a duplicate must land the same codes in the
    same rows either way. The frame bytes are built ONCE (vote ids are
    uuid4-minted) and replayed into both arms."""
    proposal = _proposal(5, voters=16)
    blob = proposal.encode()
    rows = _chain(proposal, 6)
    flipped = bytearray(rows[3])
    flipped[-1] ^= 0xFF
    batch = rows[:3] + [bytes(flipped), rows[0], rows[4]]
    responses = {}
    fingerprints = {}
    for pin in (False, True):
        server = BridgeServer(
            capacity=16, voter_capacity=12,
            signer_factory=StubConsensusSigner, wire_columnar=True,
            apply_reactor=pin, device="cpu",
        )
        server.start_embedded()
        try:
            st, out = server.dispatch_frame(P.OP_ADD_PEER, P.u8(32) + b"\x11" * 32)
            assert st == P.STATUS_OK
            pid = P.Cursor(out).u32()
            st, _ = server.dispatch_frame(
                P.OP_PROCESS_PROPOSAL,
                P.u32(pid) + P.string("m") + P.u64(NOW) + P.blob(blob),
            )
            assert st == P.STATUS_OK
            responses[pin] = server.dispatch_frame(
                P.OP_VOTE_BATCH,
                P.encode_vote_batch(NOW + 1, [(pid, "m", batch)]),
            )
            fingerprints[pin] = state_fingerprint(server.peer_engine(pid))
        finally:
            server.stop()
    assert responses[True] == responses[False]
    assert fingerprints[True] == fingerprints[False]


# ── satellite: admission shed counts queued reactor rows ───────────────


def test_shed_counts_queued_reactor_rows():
    """A parked (huge-threshold, never-flushing) window's frames must
    still count toward the serial-lane admission limit: the shed sees
    reactor_frames/reactor_rows, so a full window cannot silently
    bypass overload control."""
    server = BridgeServer(
        capacity=8, voter_capacity=8, ordered_admission_limit=2, device="cpu",
        apply_reactor=ApplyReactor(
            max_rows=10**9, max_bytes=10**9, max_delay=10.0,
            min_delay=10.0, adaptive=False,
        ),
    )

    class _FakeConn:
        def __init__(self):
            self.sent = b""

        def sendall(self, data: bytes) -> None:
            self.sent += data

    from hashgraph_tpu_torch.bridge.server import _ConnState

    state = _ConnState.__new__(_ConnState)
    state.write_lock = threading.Lock()
    state.reactor_lock = threading.Lock()
    state.reactor_frames = 0
    state.reactor_rows = 0

    class _Lane:
        def depth(self) -> int:
            return 0  # the lane itself is EMPTY: work sits in windows

    state.ordered = _Lane()
    mutating = next(iter(P.MUTATING_OPCODES))
    conn = _FakeConn()
    # No queued reactor work: admitted.
    assert not server._shed_retry_after(conn, state, mutating, 1)
    # Two frames' rows parked in an unflushed window: at the limit.
    state.reactor_frames = 2
    state.reactor_rows = 4096
    assert server._shed_retry_after(conn, state, mutating, 2)
    status, corr, cursor = P.parse_frame(conn.sent[4:], tagged=True)
    assert status == P.STATUS_RETRY_AFTER and corr == 2
    hint = float(cursor.string())
    # Queued rows scale the hint beyond the frame count alone.
    assert hint > 2 / 1000.0
    server.stop()


# ── pinned: the JAX package's merge changes the wire chain guard ───────


def merged_frames_statuses(pkg_name: str) -> dict:
    """Two frames of one session's chain at one ``now``: the first decides
    the session and refuses its third vote (ALREADY_REACHED); the second
    holds the vote chained on that refused one. Applied as two
    ``ingest_wire_columnar`` calls (reactor off, or windows that do not
    merge) and as one reactor window merging both (manual mode)."""
    import importlib

    ht = importlib.import_module(pkg_name)
    reactor = importlib.import_module(f"{pkg_name}.bridge.reactor")
    columnar = importlib.import_module(f"{pkg_name}.bridge.columnar")
    wire = importlib.import_module(f"{pkg_name}.wire")
    if pkg_name == "hashgraph_tpu":
        from hashgraph_tpu.engine import TpuConsensusEngine

        def engine():
            return TpuConsensusEngine(ht.StubConsensusSigner(b"me"), capacity=8,
                                      voter_capacity=8, verify_cache=None)
    else:
        def engine():
            return ht.TorchConsensusEngine(ht.StubConsensusSigner(b"me"), 8, 8,
                                           device="cpu", verify_cache=None)

    def columns(votes):
        offsets = np.zeros(len(votes) + 1, np.int64)
        np.cumsum([len(v) for v in votes], out=offsets[1:])
        data = np.frombuffer(b"".join(votes), np.uint8)
        cols, flags = columnar.parse_vote_columns(data, offsets)
        assert flags.all()
        return cols, data, offsets

    blob = wire.Proposal(
        name="p", payload=b"", proposal_id=7, proposal_owner=b"o" * 20,
        expected_voters_count=3, timestamp=NOW, expiration_timestamp=NOW + 600,
        liveness_criteria_yes=True,
    ).encode()
    chain = wire.Proposal.decode(blob)
    rows = []
    for i in range(4):
        vote = ht.build_vote(chain, True, ht.StubConsensusSigner(bytes([i + 1]) * 20), NOW + 1)
        chain.votes.append(vote)
        rows.append(vote.encode())
    frames = [rows[:3], rows[3:]]
    out = {}
    for mode in ("separate", "merged"):
        eng = engine()
        eng.process_incoming_proposal("s", wire.Proposal.decode(blob), NOW)
        if mode == "separate":
            out[mode] = [int(code) for frame in frames for code in eng.ingest_wire_columnar(
                ["s"], np.zeros(len(frame), np.int64), *columns(frame), NOW + 1)]
        else:
            window = reactor.ApplyReactor()
            handles = [window.submit(eng, ["s"], np.zeros(len(frame), np.int64),
                                     *columns(frame), NOW + 1) for frame in frames]
            window.flush()
            out[mode] = [int(code) for h in handles for code in h.wait(5)]
    return out


def test_pinned_fault_merged_frames_change_the_chain_guard():
    """The JAX package's reactor merges consecutive frames of one chain
    into one call, and the wire chain guard walks a call's own rows but
    checks a later call's against the tail the session kept: the vote
    after a refused one is RECEIVED_HASH_MISMATCH in its own frame and
    ALREADY_REACHED when the window merged the two. So reactor-on equals
    reactor-off only when no window holds two votes of one chain across a
    refused one (phase 13's 1,024-row frames each fill a window alone).
    The port keeps the reference's behaviour; both packages are held to
    it, the JAX one in a subprocess."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from hashgraph_tpu_torch.errors import StatusCode

    ok, reached = int(StatusCode.OK), int(StatusCode.ALREADY_REACHED)
    want = {"separate": [ok, ok, reached, int(StatusCode.RECEIVED_HASH_MISMATCH)],
            "merged": [ok, ok, reached, reached]}
    assert merged_frames_statuses("hashgraph_tpu_torch") == want
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([str(repo)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, __file__, "--reference"], capture_output=True,
                          text=True, timeout=300, cwd=str(repo), env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == want


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    import json

    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(merged_frames_statuses("hashgraph_tpu")))
