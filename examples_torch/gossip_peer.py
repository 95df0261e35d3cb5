"""Standalone gossip peer on the PyTorch port: one BridgeServer in its own
process.

The gossip fabric's point is throughput ACROSS processes — in-process
"peers" share one GIL, so an aggregate number measured there is really
one interpreter's ceiling. This runner hosts a bridge server (stub
scheme by default — transport benches measure the fabric, not host
crypto) as a real OS process:

    python examples_torch/gossip_peer.py [--capacity N] [--voter-capacity N]
                                         [--scheme stub|ethereum|ed25519]
                                         [--reactor on|off|env]
                                         [--device cuda|cpu]

Its engines hold their tallies on ``--device``: the card by default,
raising without a GPU. With ``--scheme ed25519`` and
``HASHGRAPH_TPU_DEVICE_VERIFY=1`` the peers' signers are the device
signer, whose batch verification runs on the card, as the variable
selects everywhere in the port.

It prints ``PORT <port>`` on stdout once listening, then serves until
stdin reaches EOF (the parent closing the pipe is the shutdown signal —
no PID files, no signals racing the accept loop). A benchmark spawns one
of these per peer; it is also a handy way to run a real multi-process
fabric by hand.
"""

import argparse
import sys

sys.path.insert(0, ".")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--capacity", type=int, default=256)
    parser.add_argument("--voter-capacity", type=int, default=66)
    parser.add_argument(
        "--scheme", choices=("stub", "ethereum", "ed25519"), default="stub"
    )
    # Apply-reactor pin for A/B benches: "env" defers to the server's
    # HASHGRAPH_TPU_APPLY_REACTOR default; on/off override it so a
    # paired arm cannot be polluted by the environment.
    parser.add_argument("--reactor", choices=("on", "off", "env"), default="env")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args()

    from hashgraph_tpu_torch.bridge.server import BridgeServer

    if args.scheme == "stub":
        from hashgraph_tpu_torch.signing.stub import StubConsensusSigner as scheme
    elif args.scheme == "ed25519":
        from hashgraph_tpu_torch.signing.ed25519 import Ed25519ConsensusSigner as scheme
    else:
        from hashgraph_tpu_torch.signing.ethereum import EthereumConsensusSigner as scheme

    server = BridgeServer(
        capacity=args.capacity,
        voter_capacity=args.voter_capacity,
        signer_factory=scheme,
        apply_reactor=(
            None if args.reactor == "env" else args.reactor == "on"
        ),
        device=args.device,
    )
    with server:
        _host, port = server.address
        print(f"PORT {port}", flush=True)
        # Serve until the parent closes our stdin.
        sys.stdin.buffer.read()


if __name__ == "__main__":
    main()
