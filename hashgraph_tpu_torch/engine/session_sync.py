"""Scalar-session ↔ dense-row helpers for the pool's clients.

Port of the part of ``hashgraph_tpu/engine/session_sync.py`` that the
engine's vote path needs: projecting a proposal onto a pool slot with the
same threshold math and round caps as the JAX package.
"""

from __future__ import annotations

from typing import Hashable

import numpy as np

from ..ops.decide import (
    STATE_ACTIVE,
    STATE_FAILED,
    STATE_REACHED_NO,
    STATE_REACHED_YES,
    required_votes_np,
)
from ..session import ConsensusConfig, ConsensusState
from ..wire import Proposal
from .pool import ProposalPool

__all__ = ["allocate_slot", "state_code_of"]


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
        n=np.array([n]),
        req=required_votes_np(np.array([n]), config.consensus_threshold),
        cap=np.array([config.max_round_limit(n)]),
        gossip=np.array([config.use_gossipsub_rounds]),
        liveness=np.array([proposal.liveness_criteria_yes]),
        expiry=np.array([proposal.expiration_timestamp]),
        created_at=np.array([created_at]),
    )[0]
