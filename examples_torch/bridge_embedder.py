"""Embedder bridge demo on the PyTorch port: drive the consensus engine
from outside Python.

Starts a BridgeServer (one TorchConsensusEngine per added peer, on
``--device``), then plays both sides of the embedder boundary:
1. the Python client runs the 3-voter quick-start over TCP, and
2. if a C compiler is available, builds native/bridge_client.c and lets the
   C embedder run the same scenario — proving a non-Python process can
   create proposals, vote, ferry the reference-schema protobuf bytes
   between peers, and receive events.

Run: python examples_torch/bridge_embedder.py [--device cuda|cpu]
(the card by default, raising without a GPU)
"""

import argparse
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, ".")

from hashgraph_tpu_torch.bridge import BridgeClient, BridgeServer


def python_quickstart(host: str, port: int) -> None:
    now = 1_700_000_000
    with BridgeClient(host, port) as client:
        print(f"bridge protocol v{client.ping()}")
        peers = {}
        for name in ("alice", "bob", "carol"):
            peer_id, identity = client.add_peer()
            peers[name] = peer_id
            print(f"  {name}: peer {peer_id}, address 0x{identity.hex()}")

        pid, _ = client.create_proposal(
            peers["alice"], "demo", now, "genesis-upgrade", b"ship it", 3, 600
        )
        client.cast_vote(peers["alice"], "demo", pid, True, now + 1)
        proposal = client.get_proposal(peers["alice"], "demo", pid)
        for name in ("bob", "carol"):
            client.process_proposal(peers[name], "demo", proposal, now + 2)
        for i, name in enumerate(("bob", "carol")):
            vote = client.cast_vote(peers[name], "demo", pid, True, now + 3 + i)
            for other in ("alice", "bob", "carol"):
                if other != name:
                    client.process_vote(peers[other], "demo", vote, now + 4 + i)

        for name, peer in peers.items():
            result = client.get_result(peer, "demo", pid)
            events = client.poll_events(peer)
            print(f"  {name}: consensus={result}, {len(events)} event(s)")
            assert result is True
    print("python embedder: PASS")


def c_quickstart(host: str, port: int) -> None:
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        print("c embedder: skipped (no C compiler)")
        return
    with tempfile.TemporaryDirectory() as tmp:
        binary = f"{tmp}/bridge_demo"
        subprocess.run(
            [cc, "-O2", "-o", binary, "native/bridge_client.c"], check=True
        )
        out = subprocess.run(
            [binary, host, str(port)], capture_output=True, text=True, timeout=120
        )
        print(out.stdout.strip())
        assert out.returncode == 0 and "QUICKSTART PASS" in out.stdout
    print("c embedder: PASS")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args()
    with BridgeServer(capacity=64, voter_capacity=8, device=args.device) as server:
        host, port = server.address
        print(f"bridge listening on {host}:{port}")
        python_quickstart(host, port)
        c_quickstart(host, port)


if __name__ == "__main__":
    main()
