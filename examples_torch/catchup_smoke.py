"""State-sync smoke check on the PyTorch port (the twin of the
``make catchup-smoke`` target).

Two in-process peers on a BridgeServer build a small signed history; two
fresh joiners then catch up over the wire — one via snapshot+tail
(CatchUpClient.catch_up: manifest, digest-checked chunks, one batched
chain/signature verify, atomic install, WAL-tail the suffix), one via
full WAL replay (CatchUpClient.full_replay) — and both must converge to
byte-identical engine state (sync.state_fingerprint equality) with the
source. A third joiner resumes an interrupted transfer from the same
CatchUpState. The server's engines and the joiners hold their tallies on
``--device`` (the card by default, raising without a GPU). Exit code 0
and a final ``catchup-smoke OK`` line mean the state-sync path works end
to end.

Run: python examples_torch/catchup_smoke.py [--device cuda|cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, ".")  # run from the repo root

from hashgraph_tpu_torch.bridge.client import BridgeClient  # noqa: E402
from hashgraph_tpu_torch.bridge.server import BridgeServer  # noqa: E402
from hashgraph_tpu_torch.engine import TorchConsensusEngine  # noqa: E402
from hashgraph_tpu_torch.obs import registry  # noqa: E402
from hashgraph_tpu_torch.signing.ethereum import EthereumConsensusSigner  # noqa: E402
from hashgraph_tpu_torch.sync import CatchUpClient, state_fingerprint  # noqa: E402

NOW = 1_700_000_000


def fresh_joiner(device: str) -> TorchConsensusEngine:
    return TorchConsensusEngine(
        EthereumConsensusSigner.random(), capacity=32, voter_capacity=8,
        device=device,
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = parser.parse_args().device
    with tempfile.TemporaryDirectory() as wal_dir:
        server = BridgeServer(
            capacity=32, voter_capacity=8, wal_dir=wal_dir, wal_fsync="off",
            device=device,
        )
        with server:
            host, port = server.address
            with BridgeClient(host, port) as client:
                source_peer, identity = client.add_peer(os.urandom(32))
                voters = [client.add_peer(os.urandom(32))[0] for _ in range(3)]
                # A small multi-proposal history: create, gossip, vote.
                for p in range(4):
                    pid, blob = client.create_proposal(
                        source_peer, "smoke", NOW, f"p{p}", b"payload", 4, 3_600
                    )
                    for vp in voters:
                        client.process_proposal(vp, "smoke", blob, NOW)
                        vote = client.cast_vote(vp, "smoke", pid, True, NOW + 1)
                        client.process_vote(source_peer, "smoke", vote, NOW + 1)
                source = server.durable_engine(identity)
                src_fp = state_fingerprint(source)

                # Snapshot + tail.
                joiner = fresh_joiner(device)
                with CatchUpClient(host, port, source_peer) as cu:
                    report = cu.catch_up(joiner, max_chunk_bytes=512)
                assert report.sessions_installed == 4, report
                assert report.votes_verified > 0, report
                assert state_fingerprint(joiner) == src_fp, "snapshot+tail diverged"

                # Full WAL replay must land on the same bytes.
                replayer = fresh_joiner(device)
                with CatchUpClient(host, port, source_peer) as cu:
                    replay = cu.full_replay(replayer)
                assert replay.tail_records > 0, replay
                assert state_fingerprint(replayer) == src_fp, "full replay diverged"

                # Interrupt mid-download, resume with the same state.
                resumer = fresh_joiner(device)
                cu = CatchUpClient(host, port, source_peer)
                manifest = cu._bridge.sync_manifest(source_peer, 512)
                cu.state.manifest = manifest
                cu.state.chunks[0] = cu._bridge.sync_chunk(
                    source_peer, manifest["snapshot_id"], 0
                )
                cu.close()  # "connection dropped" after one chunk
                with CatchUpClient(
                    host, port, source_peer, state=cu.state
                ) as cu2:
                    resumed = cu2.catch_up(resumer, max_chunk_bytes=512)
                assert resumed.resumed, resumed
                assert state_fingerprint(resumer) == src_fp, "resume diverged"

                # The sync metric families carry the traffic just driven.
                text = client.get_metrics()
                for family in (
                    "hashgraph_sync_chunks_sent_total",
                    "hashgraph_sync_chunks_received_total",
                    "hashgraph_sync_tail_records_total",
                    "hashgraph_sync_catchup_seconds_count",
                ):
                    assert family in text, f"missing {family} in metrics"
                sent = registry.counter("hashgraph_sync_chunks_sent_total").value
                assert sent > 0, "no chunks counted as sent"

    print("catchup-smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
