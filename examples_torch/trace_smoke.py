"""Distributed-tracing smoke check on the PyTorch port (the twin of the
``make trace-smoke`` target).

Two bridge peers on one server (engines on ``--device``, the card by
default, raising without a GPU) drive a proposal to decision over the
wire with the trace context propagating as frame suffixes, then the
check asserts the tracing path end to end:

- both peers' engines bound contexts sharing ONE trace_id (cross-peer
  span stitching through the bridge protocol's optional suffix);
- per-peer JSONL dumps merge (``merge_traces``) into one Chrome
  trace-event file that Perfetto opens, with both peers present and the
  proposal's spans causally ordered (created on A before processed on B
  before decided);
- ``BridgeClient.explain`` returns the vote chain and quorum arithmetic
  matching the decided outcome, plus the same trace identity;
- a peer speaking the OLD wire (no trace suffix anywhere) still
  interoperates on the same server.

Exit code 0 and a final ``trace-smoke OK`` line mean the distributed
tracing path works end to end.

Run: python examples_torch/trace_smoke.py [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, ".")  # run from the repo root

from hashgraph_tpu_torch.bridge.client import BridgeClient  # noqa: E402
from hashgraph_tpu_torch.bridge.server import BridgeServer  # noqa: E402
from hashgraph_tpu_torch.obs.trace import merge_traces, trace_store  # noqa: E402

NOW = 1_700_000_000


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = parser.parse_args().device
    trace_store.clear()
    with BridgeServer(capacity=16, voter_capacity=8, device=device) as server:
        host, port = server.address
        with BridgeClient(host, port) as alice, BridgeClient(host, port) as bob:
            a_peer, a_id = alice.add_peer(os.urandom(32))
            b_peer, b_id = bob.add_peer(os.urandom(32))
            a_label = "peer:" + a_id.hex()[:12]
            b_label = "peer:" + b_id.hex()[:12]

            # Proposal created on A; its bound trace context comes back on
            # the response suffix and travels with every gossiped byte.
            pid, proposal = alice.create_proposal(
                a_peer, "smoke", NOW, "trace-me", b"payload", 2, 600
            )
            ctx = alice.last_trace_context
            assert ctx is not None, "server did not bind a trace context"
            bob.process_proposal(b_peer, "smoke", proposal, NOW, trace=ctx)
            vote_a = alice.cast_vote(a_peer, "smoke", pid, True, NOW + 1)
            vote_b = bob.cast_vote(b_peer, "smoke", pid, True, NOW + 1)
            alice.process_vote(a_peer, "smoke", vote_b, NOW + 2, trace=ctx)
            bob.process_vote(b_peer, "smoke", vote_a, NOW + 2, trace=ctx)
            assert alice.get_result(a_peer, "smoke", pid) is True

            # EXPLAIN: quorum arithmetic must match the decided outcome
            # and carry the same trace identity.
            verdict = alice.explain(a_peer, "smoke", pid)
            quorum = verdict["quorum"]
            assert verdict["status"] == "reached" and verdict["result"] is True
            assert quorum["reached"] and quorum["recomputed_result"] is True
            assert quorum["yes"] >= quorum["required_votes"], quorum
            assert len(verdict["vote_chain"]) == 2, verdict["vote_chain"]
            assert verdict["trace"]["trace_id"] == ctx.trace_id.hex()

            # Old-wire interop: a third peer speaking the seed protocol
            # (no suffixes at all — explicit trace=None and no ambient
            # context) decides the same proposal on the same server.
            with BridgeClient(host, port) as carol:
                c_peer, _ = carol.add_peer()
                pid2, _ = carol.create_proposal(
                    c_peer, "old", NOW, "untraced", b"", 1, 600
                )
                carol.cast_vote(c_peer, "old", pid2, True, NOW + 1)
                assert carol.get_result(c_peer, "old", pid2) is True

    with tempfile.TemporaryDirectory() as tmp:
        # Per-peer dumps (what each node of a real fleet would ship) ...
        a_path = os.path.join(tmp, "alice.jsonl")
        b_path = os.path.join(tmp, "bob.jsonl")
        assert trace_store.export_jsonl(a_path, peer=a_label) > 0
        assert trace_store.export_jsonl(b_path, peer=b_label) > 0
        # ... stitched into ONE Chrome trace-event file.
        merged = os.path.join(tmp, "merged-trace.json")
        summary = merge_traces([a_path, b_path], merged)
        assert summary["peers"] == sorted([a_label, b_label]), summary
        assert summary["traces"].get(ctx.trace_id.hex(), 0) >= 2, summary

        with open(merged) as fh:
            doc = json.load(fh)
        events = [
            e
            for e in doc["traceEvents"]
            if e.get("args", {}).get("trace_id") == ctx.trace_id.hex()
        ]
        by_name = {}
        for e in events:
            by_name.setdefault(e["name"], e)
        created = by_name["consensus.create_proposal"]
        processed = by_name["consensus.process_proposal"]
        decided = by_name["consensus.decided"]
        # Causal order across peers on the shared wall clock.
        assert created["ts"] <= processed["ts"] <= decided["ts"], (
            created["ts"],
            processed["ts"],
            decided["ts"],
        )
        # Cross-peer parent link: B's process span parents into A's trace.
        assert processed["args"]["parent_id"] == ctx.span_id.hex()
        peer_pids = {e["pid"] for e in events}
        assert len(peer_pids) >= 2, "merged trace lost a peer"

    print("trace-smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
