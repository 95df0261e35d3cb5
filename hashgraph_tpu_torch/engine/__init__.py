"""The engine of the PyTorch port: a device-resident proposal pool
(:mod:`.pool`), the batch-first consensus engine over it (:mod:`.engine`)
and its memoized vote-admission verdicts (:mod:`.verify_cache`).
"""

from .engine import (
    ConsensusStats,
    PendingVoteVerdicts,
    SessionRecord,
    TorchConsensusEngine,
)
from .pool import PendingIngest, PoolFullError, ProposalPool, SlotMeta
from .verify_cache import VerifiedVoteCache

__all__ = [
    "ConsensusStats",
    "PendingIngest",
    "PendingVoteVerdicts",
    "PoolFullError",
    "ProposalPool",
    "SessionRecord",
    "SlotMeta",
    "TorchConsensusEngine",
    "VerifiedVoteCache",
]
