"""Copy of ``hashgraph_tpu/protocol.py`` for the PyTorch port, which imports
nothing of the JAX package.

Scalar protocol kernels: hashing, vote building, validation, consensus math.

This is the host-side *oracle* layer: pure functions that reproduce the
reference's protocol semantics bit-exactly (reference: src/utils.rs). The
vectorized JAX kernels in :mod:`hashgraph_tpu.ops` are validated against these
functions case-by-case, and the integer threshold values shipped to the device
are computed here (in IEEE-754 double precision, matching Rust f64).
"""

from __future__ import annotations

import hashlib
import math
import sys
import uuid
from typing import TYPE_CHECKING, Iterable, Mapping

from .errors import (
    EmptySignature,
    EmptyVoteHash,
    EmptyVoteOwner,
    InvalidConsensusThreshold,
    InvalidExpectedVotersCount,
    InvalidTimeout,
    InvalidVoteHash,
    InvalidVoteSignature,
    ParentHashMismatch,
    ProposalExpired,
    ReceivedHashMismatch,
    TimestampOlderThanCreationTime,
    VoteExpired,
    VoteProposalIdMismatch,
)
from .wire import Proposal, Vote

if TYPE_CHECKING:
    from .signing import ConsensusSignatureScheme

_U32_MASK = 0xFFFFFFFF
_U32_MAX = 0xFFFFFFFF
_F64_EPSILON = sys.float_info.epsilon  # == Rust f64::EPSILON
_TWO_THIRDS = 2.0 / 3.0


def fold_u128_to_u32(n: int) -> int:
    """Fold a 128-bit value into 32 bits via XOR so every bit contributes
    (reference: src/utils.rs:19-21)."""
    return ((n >> 96) ^ (n >> 64) ^ (n >> 32) ^ n) & _U32_MASK


# Entropy seam for deterministic simulation: when set, generate_id draws
# its 128-bit value from this callable instead of uuid4. The seeded
# cluster simulator (hashgraph_tpu.sim) installs a scenario-rng source so
# every minted proposal/vote id — and therefore every signed byte and
# state fingerprint — is a pure function of the scenario seed. Production
# and tests leave it None (uuid4, the reference's behavior).
_id_entropy = None


def set_id_entropy(source) -> None:
    """Install (or with ``None`` remove) a ``() -> int`` 128-bit entropy
    source backing :func:`generate_id`. Simulation-only seam; not
    thread-scoped — callers own the install/restore discipline."""
    global _id_entropy
    _id_entropy = source


def generate_id() -> int:
    """Generate a unique 32-bit ID from a UUIDv4 (reference: src/utils.rs:27-30).

    Under :func:`set_id_entropy` the 128 bits come from the installed
    source instead, making id minting deterministic per scenario seed."""
    if _id_entropy is not None:
        return fold_u128_to_u32(_id_entropy() & ((1 << 128) - 1))
    return fold_u128_to_u32(uuid.uuid4().int)


def regenerate_until_unique(proposal, is_taken) -> int:
    """Regenerate a locally-generated proposal id while ``is_taken(pid)``.

    u32 ids birthday-collide at realistic populations (~1.2% per 10k-proposal
    wave); the reference's HashMap insert silently overwrites the incumbent
    session (reference: src/storage.rs:225-230). Regenerating before the
    fresh (vote-free) proposal becomes visible is semantically free and
    strictly safer than overwrite. Incoming network proposals must NOT be
    rewritten — their id is signed into vote chains — so their paths raise
    ProposalAlreadyExist instead. Returns the number of collisions resolved.
    """
    collisions = 0
    while is_taken(proposal.proposal_id):
        collisions += 1
        proposal.proposal_id = generate_id()
    return collisions


def compute_vote_hash(vote: Vote) -> bytes:
    """SHA-256 over the vote's identifying fields in a fixed byte order
    (reference: src/utils.rs:37-47). The signature field is excluded.
    One join + one hash call: the seven-update form paid ~2x in
    per-call dispatch on the validated ingest hot path (this runs once
    per vote there), for identical digests."""
    return hashlib.sha256(
        b"".join(
            (
                (vote.vote_id & _U32_MASK).to_bytes(4, "little"),
                vote.vote_owner,
                (vote.proposal_id & _U32_MASK).to_bytes(4, "little"),
                (vote.timestamp & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little"),
                b"\x01" if vote.vote else b"\x00",
                vote.parent_hash,
                vote.received_hash,
            )
        )
    ).digest()


def build_vote(
    proposal: Proposal,
    user_vote: bool,
    signer: "ConsensusSignatureScheme",
    now: int,
) -> Vote:
    """Create a new signed vote with hashgraph chain linking.

    ``received_hash`` links to the last vote in the proposal's list;
    ``parent_hash`` links to this voter's own most recent vote
    (reference: src/utils.rs:55-98).
    """
    voter_identity = signer.identity()

    if proposal.votes:
        latest_vote = proposal.votes[-1]
        own_last_vote = next(
            (v for v in reversed(proposal.votes) if v.vote_owner == voter_identity),
            None,
        )
        if own_last_vote is not None:
            parent_hash, received_hash = own_last_vote.vote_hash, latest_vote.vote_hash
        else:
            parent_hash, received_hash = b"", latest_vote.vote_hash
    else:
        parent_hash, received_hash = b"", b""

    vote = Vote(
        vote_id=generate_id(),
        vote_owner=bytes(voter_identity),
        proposal_id=proposal.proposal_id,
        timestamp=now,
        vote=user_vote,
        parent_hash=parent_hash,
        received_hash=received_hash,
        vote_hash=b"",
        signature=b"",
    )
    vote.vote_hash = compute_vote_hash(vote)
    vote.signature = signer.sign(vote.encode())
    return vote


# Sentinel: "compute the chain check here" (vs an injected device result).
COMPUTE_CHAIN = object()


def validate_proposal(
    proposal: Proposal,
    scheme,
    now: int,
    sig_verdicts=None,
    chain_error=COMPUTE_CHAIN,
    computed_hashes=None,
) -> None:
    """Validate a proposal and all its votes (reference: src/utils.rs:106-120).

    ``sig_verdicts``/``chain_error``/``computed_hashes`` optionally inject
    precomputed results from the batched paths (scheme.verify_batch / the
    device chain kernel / a prior ``compute_vote_hash`` pass):
    ``sig_verdicts`` is one verdict per vote in order; ``chain_error`` is
    None (chain valid) or the exception to raise at the chain-check
    position; ``computed_hashes`` is one digest per vote in order.
    Injection changes where the work happens, not the semantics.
    """
    validate_proposal_timestamp(proposal.expiration_timestamp, now)
    for i, vote in enumerate(proposal.votes):
        if vote.proposal_id != proposal.proposal_id:
            raise VoteProposalIdMismatch()
        validate_vote(
            vote,
            scheme,
            proposal.expiration_timestamp,
            proposal.timestamp,
            now,
            sig_verdict=sig_verdicts[i] if sig_verdicts is not None else None,
            computed_hash=(
                computed_hashes[i] if computed_hashes is not None else None
            ),
        )
    if chain_error is COMPUTE_CHAIN:
        validate_vote_chain(proposal.votes)
    elif chain_error is not None:
        raise chain_error


def validate_vote(
    vote: Vote,
    scheme,
    expiration_timestamp: int,
    creation_time: int,
    now: int,
    sig_verdict=None,
    computed_hash=None,
) -> None:
    """Validate a single vote: structure, hash, signature, replay, expiry.

    Check order matters and mirrors the reference exactly
    (reference: src/utils.rs:127-171).

    ``sig_verdict`` optionally injects a precomputed signature result from
    the scheme's batched verification (bool, or the ConsensusSchemeError
    ``verify`` would have raised) — the batch ingest path verifies all
    signatures in one native call, then replays this check sequence per
    vote. ``computed_hash`` optionally injects the caller's own
    ``compute_vote_hash(vote)`` result (the verify-cache prepass hashes
    every vote to build its keys; recomputing here would double the SHA
    work per vote). Semantics are identical to the inline computations.
    """
    if not vote.vote_owner:
        raise EmptyVoteOwner()
    if not vote.vote_hash:
        raise EmptyVoteHash()
    if not vote.signature:
        raise EmptySignature()

    expected_hash = (
        computed_hash if computed_hash is not None else compute_vote_hash(vote)
    )
    if vote.vote_hash != expected_hash:
        raise InvalidVoteHash()

    if sig_verdict is None:
        sig_verdict = scheme.verify(
            vote.vote_owner, vote.signing_payload(), vote.signature
        )
    if isinstance(sig_verdict, Exception):
        raise sig_verdict
    if not sig_verdict:
        raise InvalidVoteSignature()

    # Replay guard: the vote cannot predate the proposal
    # (reference: src/utils.rs:160-164).
    if vote.timestamp < creation_time:
        raise TimestampOlderThanCreationTime()

    if vote.timestamp > expiration_timestamp or now > expiration_timestamp:
        raise VoteExpired()


def validate_vote_chain(votes: list[Vote], start: int = 0) -> None:
    """Validate the hashgraph chain structure over an ordered vote list
    (reference: src/utils.rs:175-215).

    Rules:
    - a non-empty ``received_hash`` must equal the immediately previous vote's
      ``vote_hash``, with non-decreasing timestamps;
    - a non-empty ``parent_hash`` must resolve to an earlier-indexed vote by
      the same owner with timestamp <= this vote's.

    ``start`` restricts WHICH indices are checked (the hash map still spans
    the full list, preserving last-occurrence-wins): the engine's
    validated-chain watermark passes the accepted prefix + suffix with
    ``start`` at the watermark, so the suffix is checked against the full
    chain without re-checking links the prefix already passed. The rules
    themselves have exactly one home — this function.
    """
    if len(votes) <= 1:
        return

    hash_index: dict[bytes, tuple[bytes, int, int]] = {}
    for idx, vote in enumerate(votes):
        hash_index[vote.vote_hash] = (vote.vote_owner, vote.timestamp, idx)

    for idx in range(start, len(votes)):
        vote = votes[idx]
        if idx > 0 and vote.received_hash:
            prev_vote = votes[idx - 1]
            if vote.received_hash != prev_vote.vote_hash:
                raise ReceivedHashMismatch()
            if prev_vote.timestamp > vote.timestamp:
                raise ReceivedHashMismatch()

        if vote.parent_hash:
            entry = hash_index.get(vote.parent_hash)
            if entry is None:
                raise ParentHashMismatch()
            owner, ts, parent_idx = entry
            if not (owner == vote.vote_owner and ts <= vote.timestamp and parent_idx < idx):
                raise ParentHashMismatch()


def calculate_consensus_result(
    votes: Mapping[bytes, Vote] | Iterable[Vote],
    expected_voters: int,
    consensus_threshold: float,
    liveness_criteria_yes: bool,
    is_timeout: bool,
) -> bool | None:
    """THE decision kernel (scalar form). Reference: src/utils.rs:227-286.

    Accepts either an owner->Vote mapping or an iterable of votes (each owner
    assumed distinct). Returns True (YES), False (NO), or None (undecided).
    """
    if isinstance(votes, Mapping):
        vote_values = [v.vote for v in votes.values()]
    else:
        vote_values = [v.vote for v in votes]
    total_votes = len(vote_values)
    yes_votes = sum(1 for v in vote_values if v)
    return decide(
        yes_votes,
        total_votes,
        expected_voters,
        consensus_threshold,
        liveness_criteria_yes,
        is_timeout,
    )


def decide(
    yes_votes: int,
    total_votes: int,
    expected_voters: int,
    consensus_threshold: float,
    liveness_criteria_yes: bool,
    is_timeout: bool,
) -> bool | None:
    """Count-level form of the decision kernel — the exact scalar rules the
    vectorized device kernel must match (reference: src/utils.rs:227-286)."""
    no_votes = max(total_votes - yes_votes, 0)
    silent_votes = max(expected_voters - total_votes, 0)

    # n <= 2: unanimity rule (reference: src/utils.rs:239-244).
    if expected_voters <= 2:
        if total_votes < expected_voters:
            return None
        return yes_votes == expected_voters

    required_votes = calculate_required_votes(expected_voters, consensus_threshold)
    # At timeout, silent peers count toward quorum (reference: src/utils.rs:249-253).
    effective_total = expected_voters if is_timeout else total_votes
    if effective_total < required_votes:
        return None

    required_choice_votes = calculate_threshold_based_value(
        expected_voters, consensus_threshold
    )
    yes_weight = yes_votes + (silent_votes if liveness_criteria_yes else 0)
    no_weight = no_votes + (0 if liveness_criteria_yes else silent_votes)

    if yes_weight >= required_choice_votes and yes_weight > no_weight:
        return True
    if no_weight >= required_choice_votes and no_weight > yes_weight:
        return False
    if total_votes == expected_voters and yes_weight == no_weight:
        return liveness_criteria_yes
    return None


def calculate_required_votes(expected_voters: int, consensus_threshold: float) -> int:
    """Minimum participation to potentially reach consensus
    (reference: src/utils.rs:292-299)."""
    if expected_voters <= 2:
        return expected_voters
    return calculate_threshold_based_value(expected_voters, consensus_threshold)


def calculate_max_rounds(expected_voters: int, consensus_threshold: float) -> int:
    """Dynamic P2P round cap, ceil(2n/3) by default (reference: src/utils.rs:302-304)."""
    return calculate_threshold_based_value(expected_voters, consensus_threshold)


def calculate_threshold_based_value(expected_voters: int, consensus_threshold: float) -> int:
    """Precision-critical threshold math (reference: src/utils.rs:307-313).

    The default 2/3 threshold takes an exact integer path — ``ceil(2n/3)`` via
    integer division — to avoid f64 rounding; other thresholds use
    ``ceil(n * t)`` in f64 (Python floats are IEEE-754 doubles, matching Rust).
    The final ``as u32`` cast saturates like Rust's.
    """
    if abs(consensus_threshold - _TWO_THIRDS) < _F64_EPSILON:
        return (2 * expected_voters + 2) // 3  # div_ceil(2n, 3)
    value = math.ceil((expected_voters * 1.0) * consensus_threshold)
    if value < 0:
        return 0
    return min(int(value), _U32_MAX)


def validate_proposal_timestamp(expiration_timestamp: int, now: int) -> None:
    """Reject expired proposals (reference: src/utils.rs:320-328)."""
    if now >= expiration_timestamp:
        raise ProposalExpired()


def validate_threshold(threshold: float) -> None:
    """Threshold must be within [0.0, 1.0] (reference: src/utils.rs:331-336)."""
    if not (0.0 <= threshold <= 1.0):
        raise InvalidConsensusThreshold()


def validate_timeout(timeout_seconds: float) -> None:
    """Timeout must be > 0 (reference: src/utils.rs:339-344)."""
    if timeout_seconds <= 0:
        raise InvalidTimeout()


def validate_expected_voters_count(expected_voters_count: int) -> None:
    """expected_voters_count must be a valid nonzero u32
    (reference: src/utils.rs:347-354; values outside u32 range are
    unrepresentable in the reference's wire type)."""
    if not (1 <= expected_voters_count <= _U32_MAX):
        raise InvalidExpectedVotersCount()


def has_sufficient_votes(
    total_votes: int, expected_voters: int, consensus_threshold: float
) -> bool:
    """Quick participation check (reference: src/utils.rs:360-367)."""
    return total_votes >= calculate_required_votes(expected_voters, consensus_threshold)
