"""The engine of the PyTorch port: a device-resident proposal pool
(:mod:`.pool`) and the batch-first consensus engine over it (:mod:`.engine`).
"""

from .engine import ConsensusStats, SessionRecord, TorchConsensusEngine
from .pool import PendingIngest, PoolFullError, ProposalPool, SlotMeta

__all__ = [
    "ConsensusStats",
    "PendingIngest",
    "PoolFullError",
    "ProposalPool",
    "SessionRecord",
    "SlotMeta",
    "TorchConsensusEngine",
]
