"""The engine of the PyTorch port: a device-resident proposal pool
(:mod:`.pool`), the batch-first consensus engine over it (:mod:`.engine`),
its memoized vote-admission verdicts (:mod:`.verify_cache`) and the
``ConsensusStorage`` over the pool that the service runs on
(:mod:`.storage`).
"""

from .engine import (
    ConsensusStats,
    PendingVoteVerdicts,
    SessionRecord,
    TorchConsensusEngine,
)
from .pool import PendingIngest, PoolFullError, ProposalPool, SlotMeta
from .storage import TorchBackedStorage
from .verify_cache import VerifiedVoteCache

__all__ = [
    "ConsensusStats",
    "PendingIngest",
    "PendingVoteVerdicts",
    "PoolFullError",
    "ProposalPool",
    "SessionRecord",
    "SlotMeta",
    "TorchBackedStorage",
    "TorchConsensusEngine",
    "VerifiedVoteCache",
]
