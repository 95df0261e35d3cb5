"""README quick-start on the PyTorch port: one proposal, three voters,
Gossipsub 2/3 quorum.

The scalar ``ConsensusService`` over ``InMemoryConsensusStorage`` does no
device work, so this program takes no ``--device``.

Run: python examples_torch/quickstart.py
"""

import sys
import time

sys.path.insert(0, ".")

from hashgraph_tpu_torch import (
    BroadcastEventBus,
    ConsensusService,
    CreateProposalRequest,
    InMemoryConsensusStorage,
    StubConsensusSigner,
    build_vote,
)


def main() -> None:
    # Three peers sharing storage + event bus (in-process simulation; a real
    # deployment gives each peer its own service and ferries wire bytes).
    storage, bus = InMemoryConsensusStorage(), BroadcastEventBus()
    alice = ConsensusService(storage, bus, StubConsensusSigner(b"A" * 20))
    bob = ConsensusService(storage, bus, StubConsensusSigner(b"B" * 20))
    events = bus.subscribe()

    now = int(time.time())
    proposal = alice.create_proposal(
        "deployments",
        CreateProposalRequest(
            name="ship-v2",
            payload=b"git:abc123",
            proposal_owner=alice.signer().identity(),
            expected_voters_count=3,
            expiration_timestamp=60,
            liveness_criteria_yes=True,
        ),
        now,
    )
    print(f"proposal {proposal.proposal_id}: {proposal.name!r}, 3 voters, 2/3 quorum")

    alice.cast_vote("deployments", proposal.proposal_id, True, now)
    print("alice voted YES ->", storage.get_session("deployments", proposal.proposal_id).state.kind.value)

    bob.cast_vote("deployments", proposal.proposal_id, True, now)
    scope, event = events.recv(timeout=1)
    print(f"bob voted YES   -> ConsensusReached(result={event.result}) in scope {scope!r}")

    # Carol's vote arrives after the decision: accepted as a no-op success.
    carol_vote = build_vote(
        storage.get_proposal("deployments", proposal.proposal_id),
        False,
        StubConsensusSigner(b"C" * 20),
        now,
    )
    alice.process_incoming_vote("deployments", carol_vote, now)
    print("carol voted NO  -> still ConsensusReached (idempotent)")


if __name__ == "__main__":
    main()
