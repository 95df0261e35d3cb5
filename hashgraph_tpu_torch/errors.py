"""Copy of ``hashgraph_tpu/errors.py`` for the PyTorch port, which imports
nothing of the JAX package.

Error types for the TPU-native hashgraph consensus framework.

Mirrors the reference error surface (reference: src/error.rs:11-74) as a Python
exception hierarchy plus an integer ``StatusCode`` enum. The integer codes exist
because the TPU batch-ingest path reports per-vote outcomes as dense ``int32``
status vectors from device kernels; host code maps codes back to exceptions via
:func:`error_for_code`.
"""

from __future__ import annotations

import enum


class StatusCode(enum.IntEnum):
    """Dense per-vote / per-proposal status codes used by device kernels.

    ``OK`` (0) means the operation succeeded. Codes are stable: they are part of
    the batch API surface (``ingest_votes`` returns one code per vote).
    """

    OK = 0

    # Configuration validation (reference: src/error.rs:13-20)
    INVALID_CONSENSUS_THRESHOLD = 1
    INVALID_TIMEOUT = 2
    INVALID_EXPECTED_VOTERS_COUNT = 3
    INVALID_MAX_ROUNDS = 4

    # Vote / proposal validation (reference: src/error.rs:23-50)
    INVALID_VOTE_SIGNATURE = 5
    EMPTY_SIGNATURE = 6
    DUPLICATE_VOTE = 7
    USER_ALREADY_VOTED = 8
    VOTE_EXPIRED = 9
    EMPTY_VOTE_OWNER = 10
    INVALID_VOTE_HASH = 11
    EMPTY_VOTE_HASH = 12
    PROPOSAL_EXPIRED = 13
    VOTE_PROPOSAL_ID_MISMATCH = 14
    RECEIVED_HASH_MISMATCH = 15
    PARENT_HASH_MISMATCH = 16
    INVALID_VOTE_TIMESTAMP = 17
    TIMESTAMP_OLDER_THAN_CREATION_TIME = 18

    # Session / state (reference: src/error.rs:53-60)
    SESSION_NOT_ACTIVE = 19
    SESSION_NOT_FOUND = 20
    PROPOSAL_ALREADY_EXIST = 21
    SCOPE_NOT_FOUND = 22

    # Consensus results (reference: src/error.rs:63-70)
    INSUFFICIENT_VOTES_AT_TIMEOUT = 23
    MAX_ROUNDS_EXCEEDED = 24
    CONSENSUS_NOT_REACHED = 25
    CONSENSUS_FAILED = 26

    # Signature scheme failure (reference: src/error.rs:72-73)
    SIGNATURE_SCHEME = 27

    # Batch-engine specific: the vote was accepted by a session that had already
    # reached consensus — the reference returns Ok(ConsensusReached) without
    # inserting the vote (reference: src/session.rs:246). Not an error.
    ALREADY_REACHED = 28

    # Batch-engine specific (no reference analogue): the proposal's device
    # voter lanes are exhausted — more than voter_capacity distinct owners
    # voted on one proposal. Only possible in Gossipsub mode, which accepts
    # any number of distinct voters; size voter_capacity accordingly.
    VOTER_CAPACITY_EXCEEDED = 29


class ConsensusError(Exception):
    """Base class for everything that can go wrong during consensus operations.

    Each variant of the reference's error enum (src/error.rs:11-74) is a
    subclass carrying a :class:`StatusCode`.
    """

    code: StatusCode = StatusCode.SIGNATURE_SCHEME
    default_message: str = "consensus error"

    def __init__(self, message: str | None = None):
        super().__init__(message if message is not None else self.default_message)


# ── Configuration validation ─────────────────────────────────────────────


class InvalidConsensusThreshold(ConsensusError):
    code = StatusCode.INVALID_CONSENSUS_THRESHOLD
    default_message = "consensus_threshold must be between 0.0 and 1.0"


class InvalidTimeout(ConsensusError):
    code = StatusCode.INVALID_TIMEOUT
    default_message = "timeout must be greater than 0"


class InvalidExpectedVotersCount(ConsensusError):
    code = StatusCode.INVALID_EXPECTED_VOTERS_COUNT
    default_message = "expected_voters_count must be greater than 0"


class InvalidMaxRounds(ConsensusError):
    code = StatusCode.INVALID_MAX_ROUNDS
    default_message = "max_rounds must be greater than 0"


# ── Vote and proposal validation ─────────────────────────────────────────


class InvalidVoteSignature(ConsensusError):
    code = StatusCode.INVALID_VOTE_SIGNATURE
    default_message = "Invalid vote signature"


class EmptySignature(ConsensusError):
    code = StatusCode.EMPTY_SIGNATURE
    default_message = "Empty signature"


class DuplicateVote(ConsensusError):
    code = StatusCode.DUPLICATE_VOTE
    default_message = "Duplicate vote"


class UserAlreadyVoted(ConsensusError):
    code = StatusCode.USER_ALREADY_VOTED
    default_message = "User already voted"


class VoteExpired(ConsensusError):
    code = StatusCode.VOTE_EXPIRED
    default_message = "Vote expired"


class EmptyVoteOwner(ConsensusError):
    code = StatusCode.EMPTY_VOTE_OWNER
    default_message = "Empty vote owner"


class InvalidVoteHash(ConsensusError):
    code = StatusCode.INVALID_VOTE_HASH
    default_message = "Invalid vote hash"


class EmptyVoteHash(ConsensusError):
    code = StatusCode.EMPTY_VOTE_HASH
    default_message = "Empty vote hash"


class ProposalExpired(ConsensusError):
    code = StatusCode.PROPOSAL_EXPIRED
    default_message = "Proposal expired"


class VoteProposalIdMismatch(ConsensusError):
    code = StatusCode.VOTE_PROPOSAL_ID_MISMATCH
    default_message = "Vote proposal_id mismatch: vote belongs to different proposal"


class ReceivedHashMismatch(ConsensusError):
    code = StatusCode.RECEIVED_HASH_MISMATCH
    default_message = "Received hash mismatch"


class ParentHashMismatch(ConsensusError):
    code = StatusCode.PARENT_HASH_MISMATCH
    default_message = "Parent hash mismatch"


class InvalidVoteTimestamp(ConsensusError):
    code = StatusCode.INVALID_VOTE_TIMESTAMP
    default_message = "Invalid vote timestamp"


class TimestampOlderThanCreationTime(ConsensusError):
    code = StatusCode.TIMESTAMP_OLDER_THAN_CREATION_TIME
    default_message = "Vote timestamp is older than creation time"


# ── Session / state ──────────────────────────────────────────────────────


class SessionNotActive(ConsensusError):
    code = StatusCode.SESSION_NOT_ACTIVE
    default_message = "Session not active"


class SessionNotFound(ConsensusError):
    code = StatusCode.SESSION_NOT_FOUND
    default_message = "Session not found"


class ProposalAlreadyExist(ConsensusError):
    code = StatusCode.PROPOSAL_ALREADY_EXIST
    default_message = "Proposal already exist in consensus service"


class ScopeNotFound(ConsensusError):
    code = StatusCode.SCOPE_NOT_FOUND
    default_message = "Scope not found"


# ── Consensus results ────────────────────────────────────────────────────


class InsufficientVotesAtTimeout(ConsensusError):
    code = StatusCode.INSUFFICIENT_VOTES_AT_TIMEOUT
    default_message = "Insufficient votes at timeout"


class MaxRoundsExceeded(ConsensusError):
    code = StatusCode.MAX_ROUNDS_EXCEEDED
    default_message = "Consensus exceeded configured max rounds"


class ConsensusNotReached(ConsensusError):
    code = StatusCode.CONSENSUS_NOT_REACHED
    default_message = "Consensus not reached"


class ConsensusFailed(ConsensusError):
    code = StatusCode.CONSENSUS_FAILED
    default_message = "Consensus failed"


class VoterCapacityExceeded(ConsensusError):
    """Engine-specific: device voter lanes exhausted for this proposal."""

    code = StatusCode.VOTER_CAPACITY_EXCEEDED
    default_message = "Pool voter capacity exceeded for proposal"


# ── Signature scheme errors (reference: src/signing.rs:77-86) ────────────


class ConsensusSchemeError(ConsensusError):
    """Error raised by a signature scheme (sign or verify failure)."""

    code = StatusCode.SIGNATURE_SCHEME
    default_message = "Signature scheme failure"

    @classmethod
    def sign(cls, detail: str) -> "ConsensusSchemeError":
        return cls(f"Signing failed: {detail}")

    @classmethod
    def verify(cls, detail: str) -> "ConsensusSchemeError":
        return cls(f"Verification rejected inputs: {detail}")


_CODE_TO_ERROR: dict[int, type[ConsensusError]] = {
    cls.code: cls
    for cls in [
        InvalidConsensusThreshold,
        InvalidTimeout,
        InvalidExpectedVotersCount,
        InvalidMaxRounds,
        InvalidVoteSignature,
        EmptySignature,
        DuplicateVote,
        UserAlreadyVoted,
        VoteExpired,
        EmptyVoteOwner,
        InvalidVoteHash,
        EmptyVoteHash,
        ProposalExpired,
        VoteProposalIdMismatch,
        ReceivedHashMismatch,
        ParentHashMismatch,
        InvalidVoteTimestamp,
        TimestampOlderThanCreationTime,
        SessionNotActive,
        SessionNotFound,
        ProposalAlreadyExist,
        ScopeNotFound,
        InsufficientVotesAtTimeout,
        MaxRoundsExceeded,
        ConsensusNotReached,
        ConsensusFailed,
        VoterCapacityExceeded,
        ConsensusSchemeError,
    ]
}


def error_for_code(code: int) -> type[ConsensusError] | None:
    """Map a dense device status code back to its exception class.

    Returns ``None`` for the non-error codes ``OK`` and ``ALREADY_REACHED``
    (a vote accepted by an already-decided session is a success in the
    reference semantics, src/session.rs:246). Raises ``ValueError`` only for
    codes this module does not define.
    """
    status = StatusCode(code)  # raises ValueError for genuinely unknown ints
    if status in (StatusCode.OK, StatusCode.ALREADY_REACHED):
        return None
    return _CODE_TO_ERROR[status]
