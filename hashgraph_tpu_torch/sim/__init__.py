"""hashgraph_tpu_torch.sim — deterministic chaos harness.

A seeded discrete-event cluster simulator (FoundationDB lineage — see
PAPERS.md) driving N in-process peers — real engines, real WALs, the
real bridge dispatch table in embedded (socketless) mode, the real
gossip node — through every public entry point on VIRTUAL time, with a
composable fault-injector layer: partitions (incl. asymmetric), message
drop/duplicate/reorder/delay, in-flight frame mutation, kill-9
crash-restart through live WAL recovery (torn tails included), lost-disk
rejoin through snapshot+tail catch-up, and genuinely-keyed Byzantine
actors (equivocators, chain forkers, expired-gossip spammers,
signature-burst senders).

Every scenario run is a pure function of its seed and ends with three
machine-checked verdicts: **convergence** (honest state-fingerprint
equality), **accountability** (the health observatory convicts exactly
the injected culprits, with offline-verifiable evidence and zero honest
convictions — the Polygraph/BFT-forensics bar), and **safety** (no two
honest peers decide one session differently). ``run_corpus`` is the
regression harness.

Port of the JAX package's ``sim/`` over the port's bridge server and
engine: every peer's engines live on the cluster's ``device`` (``"cuda"``
by default), and a scenario's verdict JSON is byte-identical to the JAX
package's at the same seed.
"""

from .byzantine import ByzantineActor, corrupt_vote_batch_signatures
from .cluster import SimCluster, SimPeer, SimSession
from .core import SimScheduler, derived_rng, deterministic_ids
from .scenarios import SCENARIOS, run_corpus, run_scenario
from .transport import (
    LinkFaults,
    SimBridgeAdapter,
    SimFuture,
    SimNetwork,
    SimTransport,
)
from .verdicts import (
    accountability_verdict,
    convergence_verdict,
    safety_verdict,
    verify_evidence_record,
)

__all__ = [
    "ByzantineActor",
    "LinkFaults",
    "SCENARIOS",
    "SimBridgeAdapter",
    "SimCluster",
    "SimFuture",
    "SimNetwork",
    "SimPeer",
    "SimScheduler",
    "SimSession",
    "SimTransport",
    "accountability_verdict",
    "convergence_verdict",
    "corrupt_vote_batch_signatures",
    "derived_rng",
    "deterministic_ids",
    "run_corpus",
    "run_scenario",
    "safety_verdict",
    "verify_evidence_record",
]
