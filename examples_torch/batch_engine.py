"""GPU engine demo: 1,000 concurrent proposals decided in batched dispatches.

Run: python examples_torch/batch_engine.py [--device cuda|cpu]
(The engine's tallies live on ``--device``, the card by default; without a
GPU that default raises, and ``--device cpu`` runs the same program on the
CPU. Uses the stub signature scheme for speed.)
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

from hashgraph_tpu_torch import CreateProposalRequest, StubConsensusSigner, build_vote
from hashgraph_tpu_torch.engine import TorchConsensusEngine
from hashgraph_tpu_torch.tracing import Tracer


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args()

    engine = TorchConsensusEngine(
        StubConsensusSigner(b"E" * 20), capacity=1024, voter_capacity=8,
        max_sessions_per_scope=1000, device=args.device,
    )
    engine.tracer = Tracer(enabled=True)
    now = int(time.time())

    print("creating 1000 proposals (5 voters each, liveness=YES)...")
    pids = [
        engine.create_proposal(
            "fleet",
            CreateProposalRequest(
                name=f"job-{i}", payload=b"", proposal_owner=b"scheduler",
                expected_voters_count=5, expiration_timestamp=120,
                liveness_criteria_yes=True,
            ),
            now,
        ).proposal_id
        for i in range(1000)
    ]

    voters = [StubConsensusSigner(bytes([i + 1]) * 20) for i in range(4)]
    start = time.perf_counter()
    total = 0
    for voter in voters:
        batch = [
            ("fleet", build_vote(engine.get_proposal("fleet", pid), True, voter, now))
            for pid in pids
        ]
        statuses = engine.ingest_votes(batch, now, pre_validated=True)
        total += len(batch)
        decided = sum(1 for s in statuses if s == 28)  # ALREADY_REACHED
        print(f"  round: {len(batch)} votes dispatched ({decided} were post-decision)")
    elapsed = time.perf_counter() - start

    stats = engine.get_scope_stats("fleet")
    print(
        f"\n{total} votes in {elapsed:.2f}s "
        f"({total / elapsed:,.0f} votes/sec incl. host build_vote)"
    )
    print(
        f"sessions: {stats.total_sessions} total, "
        f"{stats.consensus_reached} reached, {stats.active_sessions} active"
    )
    print("tracer counters:", {
        k: v for k, v in engine.tracer.counters().items() if not k.startswith("span")
    })


if __name__ == "__main__":
    main()
