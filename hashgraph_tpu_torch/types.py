"""Copy of ``hashgraph_tpu/types.py`` for the PyTorch port, which imports
nothing of the JAX package.

Core request and event types (reference: src/types.rs)."""

from __future__ import annotations

from dataclasses import dataclass

from .protocol import (
    generate_id,
    validate_expected_voters_count,
    validate_timeout,
)
from .wire import Proposal

_U64_MAX = 0xFFFFFFFFFFFFFFFF


@dataclass(frozen=True)
class ConsensusReached:
    """Consensus was reached with a final yes/no result
    (reference: src/types.rs:17-22)."""

    proposal_id: int
    result: bool
    timestamp: int


@dataclass(frozen=True)
class ConsensusFailedEvent:
    """Consensus failed — insufficient votes before timeout
    (reference: src/types.rs:23-24)."""

    proposal_id: int
    timestamp: int


# A ConsensusEvent is one of the two dataclasses above.
ConsensusEvent = ConsensusReached | ConsensusFailedEvent


@dataclass(frozen=True)
class SessionTransition:
    """Result of adding votes to a session (reference: src/types.rs:29-34).

    ``reached is None`` means still active; otherwise the boolean result.
    """

    reached: bool | None = None

    @classmethod
    def still_active(cls) -> "SessionTransition":
        return cls(None)

    @classmethod
    def consensus_reached(cls, result: bool) -> "SessionTransition":
        return cls(result)

    @property
    def is_reached(self) -> bool:
        return self.reached is not None


STILL_ACTIVE = SessionTransition.still_active()


@dataclass
class CreateProposalRequest:
    """Validated parameters for creating a new proposal
    (reference: src/types.rs:42-83).

    ``expiration_timestamp`` is a *relative* duration in seconds, converted to
    an absolute timestamp at creation time.
    """

    name: str
    payload: bytes
    proposal_owner: bytes
    expected_voters_count: int
    expiration_timestamp: int
    liveness_criteria_yes: bool

    def __post_init__(self):
        validate_expected_voters_count(self.expected_voters_count)
        validate_timeout(self.expiration_timestamp)

    def into_proposal(self, now: int, pid: int | None = None) -> Proposal:
        """Stamp ``now``, generate an id, derive absolute expiration with
        saturating add (reference: src/types.rs:90-105). ``pid`` lets batch
        creators supply a pre-drawn id (same id space, one urandom read for
        the whole batch) instead of paying a uuid4 per proposal."""
        return Proposal(
            name=self.name,
            payload=self.payload,
            proposal_id=generate_id() if pid is None else pid,
            proposal_owner=self.proposal_owner,
            votes=[],
            expected_voters_count=self.expected_voters_count,
            round=1,
            timestamp=now,
            expiration_timestamp=min(now + self.expiration_timestamp, _U64_MAX),
            liveness_criteria_yes=self.liveness_criteria_yes,
        )
