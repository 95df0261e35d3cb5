"""Multi-peer gossip simulation on the PyTorch port: independent services,
out-of-order delivery.

Five fully separate peers (own storage, own bus, own keys) exchange wire
bytes only — the pattern a real gossip transport implements
(reference: tests/network_gossip_tests.rs). The gossiped bytes carry a
distributed trace context as a skippable protobuf field
(:func:`hashgraph_tpu_torch.obs.trace.attach_trace`): peers built without
tracing decode the exact same messages, peers built with it stitch every
delivery into one causal trace. The scalar services do no device work, so
this program takes no ``--device``.

Run: python examples_torch/gossip_simulation.py
"""

import random
import sys
import time

sys.path.insert(0, ".")

from hashgraph_tpu_torch import (
    ConsensusService,
    CreateProposalRequest,
    StubConsensusSigner,
    Proposal,
    Vote,
)
from hashgraph_tpu_torch.obs.trace import (
    TraceContext,
    attach_trace,
    current_context,
    extract_trace,
    trace_store,
    use_context,
)

N_PEERS = 5


def main() -> None:
    rng = random.Random(42)
    peers = [
        ConsensusService.default_service(StubConsensusSigner(bytes([i + 1]) * 20))
        for i in range(N_PEERS)
    ]
    now = int(time.time())
    scope = "network"

    # Peer 0 creates and broadcasts the proposal as wire bytes, with the
    # root trace context attached to the gossiped message itself.
    proposal = peers[0].create_proposal(
        scope,
        CreateProposalRequest(
            name="elect-coordinator", payload=b"", proposal_owner=b"p0",
            expected_voters_count=N_PEERS, expiration_timestamp=60,
            liveness_criteria_yes=False,
        ),
        now,
    )
    root = TraceContext.generate()
    trace_store.record(
        "consensus.create_proposal", root, time.time(), 0.0, peer="peer-0",
        attrs={"proposal_id": proposal.proposal_id},
    )
    wire = attach_trace(proposal.encode(), root)
    for i, peer in enumerate(peers[1:], start=1):
        # Activate the context the bytes travelled with — the idiom a
        # receiving node wraps around its delivery handler (an engine, or
        # any observed_span-instrumented layer, would auto-tag its spans;
        # the scalar service records none, so the example stamps one).
        with use_context(extract_trace(wire)):
            peer.process_incoming_proposal(scope, Proposal.decode(wire), now)
            ctx = current_context()
            trace_store.record(
                "consensus.process_proposal", ctx.child(), time.time(), 0.0,
                parent=ctx.span_id, peer=f"peer-{i}",
            )
    print(f"proposal {proposal.proposal_id} delivered to {N_PEERS} peers")

    # Everyone votes (peer 1 dissents -> 4 YES of 5, quorum is ceil(10/3)=4);
    # votes gossip to all peers in RANDOM order, trace context attached.
    mailbox: list[bytes] = []
    for i, peer in enumerate(peers):
        vote = peer.cast_vote(scope, proposal.proposal_id, i != 1, now)
        mailbox.append(attach_trace(vote.encode(), root))
    rng.shuffle(mailbox)

    for raw in mailbox:
        vote = Vote.decode(raw)  # the trace field is skipped by decoders
        with use_context(extract_trace(raw)):
            ctx = current_context()
            for i, peer in enumerate(peers):
                if peer.signer().identity() == vote.vote_owner:
                    continue  # own vote already applied locally
                peer.process_incoming_vote(scope, vote.clone(), now)
                trace_store.record(
                    "consensus.process_vote", ctx.child(), time.time(), 0.0,
                    parent=ctx.span_id, peer=f"peer-{i}",
                )

    # All peers converge on the same result — and on the same trace.
    results = [
        peer.storage().get_consensus_result(scope, proposal.proposal_id)
        for peer in peers
    ]
    print("per-peer results:", results)
    assert len(set(results)) == 1, "peers diverged!"
    traced_peers = {s.peer for s in trace_store.spans(trace_id=root.trace_id)}
    assert len(traced_peers) == N_PEERS, traced_peers
    print(f"converged: consensus = {results[0]} (4 YES of {N_PEERS})")
    print(f"one trace ({root.trace_id.hex()[:16]}…) spans {len(traced_peers)} peers")


if __name__ == "__main__":
    main()
