"""Scalar-session ↔ dense-row helpers for the pool's clients.

Port of ``hashgraph_tpu/engine/session_sync.py``: projecting a proposal
onto a pool slot with the same threshold math and round caps as the JAX
package, and writing a scalar session's tallies into an allocated slot.
"""

from __future__ import annotations

from typing import Hashable

import numpy as np

from ..ops.decide import (
    STATE_ACTIVE,
    STATE_FAILED,
    STATE_REACHED_NO,
    STATE_REACHED_YES,
)
from ..protocol import calculate_threshold_based_value
from ..session import ConsensusConfig, ConsensusSession, ConsensusState
from ..wire import Proposal
from .pool import ProposalPool

__all__ = ["allocate_slot", "load_session_rows", "state_code_of"]


def state_code_of(state: ConsensusState) -> int:
    if state.is_reached:
        return STATE_REACHED_YES if state.result else STATE_REACHED_NO
    return STATE_FAILED if state.is_failed else STATE_ACTIVE


def allocate_slot(
    pool: ProposalPool,
    key: Hashable,
    proposal: Proposal,
    config: ConsensusConfig,
    created_at: int,
) -> int:
    """Claim and configure one slot for a proposal (exact integer threshold
    math, reference: src/utils.rs:307-313). Raises PoolFullError/ValueError
    like allocate_batch."""
    n = proposal.expected_voters_count
    return pool.allocate_batch(
        keys=[key],
        n=[n],
        req=[calculate_threshold_based_value(n, config.consensus_threshold)],
        cap=[config.max_round_limit(n)],
        gossip=[config.use_gossipsub_rounds],
        liveness=[proposal.liveness_criteria_yes],
        expiry=[proposal.expiration_timestamp],
        created_at=[created_at],
    )[0]


def load_session_rows(
    pool: ProposalPool, slot: int, session: ConsensusSession
) -> bool:
    """Write a session's tallies/masks/lifecycle into an allocated slot.

    Returns False (without loading) when the session's distinct voters
    exceed the pool's lane capacity — the caller decides whether that is an
    error or a degrade-to-host condition."""
    vcap = pool.voter_capacity
    total = len(session.votes) + len(session.tallies)
    if total > vcap:
        return False
    mask = np.zeros((1, vcap), bool)
    vals = np.zeros((1, vcap), bool)
    # Votes and columnar tallies (owner -> bool, no Vote object) project
    # onto lanes identically — each owner holds exactly one of the two.
    participants = [(o, v.vote) for o, v in session.votes.items()] + list(
        session.tallies.items()
    )
    for owner, value in participants:
        lane = pool.lane_for(slot, owner)
        if lane is None:
            return False
        mask[0, lane] = True
        vals[0, lane] = value
    yes = sum(1 for _, value in participants if value)
    pool.load_rows(
        [slot],
        state=np.array([state_code_of(session.state)]),
        yes=np.array([yes]),
        tot=np.array([total]),
        mask_rows=mask,
        val_rows=vals,
    )
    return True
