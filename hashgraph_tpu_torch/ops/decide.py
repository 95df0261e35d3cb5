"""The consensus decision rule over dense proposal tallies, in PyTorch.

Port of ``hashgraph_tpu/ops/decide.py``. Reproduces
``calculate_consensus_result`` (reference: src/utils.rs:227-286)
elementwise over ``[P]`` tensors of vote tallies. All inputs are int32/bool;
the only floating-point step — converting a threshold to an integer required
vote count — happens once per proposal on the host in IEEE-754 f64
(:func:`required_votes_np`), so the device side is pure integer arithmetic
and bit-exact with the JAX package by construction.

The pool's tensors are updated in place (CUDA has no buffer donation to
mirror; writing rows by slot id avoids a copy of the whole ``[P]`` vector).
"""

from __future__ import annotations

import numpy as np
import torch

# Proposal slot lifecycle states (dense codes).
STATE_FREE = 0  # unallocated pool slot
STATE_ACTIVE = 1  # accepting votes
STATE_FAILED = 2  # ConsensusState::Failed
STATE_REACHED_NO = 3  # ConsensusReached(false)
STATE_REACHED_YES = 4  # ConsensusReached(true)

_F64_EPS = float(np.finfo(np.float64).eps)  # == Rust f64::EPSILON
_TWO_THIRDS = 2.0 / 3.0
_U32_MAX = 0xFFFFFFFF


def required_votes_np(
    expected_voters: np.ndarray, consensus_threshold: np.ndarray | float
) -> np.ndarray:
    """Host-side ``calculate_threshold_based_value`` over arrays
    (reference: src/utils.rs:307-313).

    The 2/3 default takes the exact-integer ``div_ceil(2n, 3)`` path; any
    other threshold uses ``ceil(n * t)`` in f64 (numpy float64 == Rust f64),
    with the final u32-saturating cast mirrored. Returns int64 (values are
    bounded by n, so they fit whatever the device needs).
    """
    n = np.asarray(expected_voters, dtype=np.int64)
    t = np.broadcast_to(np.asarray(consensus_threshold, dtype=np.float64), n.shape)
    exact_path = np.abs(t - _TWO_THIRDS) < _F64_EPS
    exact = (2 * n + 2) // 3
    general = np.ceil(n.astype(np.float64) * t)
    general = np.clip(general, 0, _U32_MAX).astype(np.int64)
    return np.where(exact_path, exact, general)


def decide_kernel(yes, tot, n, req, liveness, is_timeout):
    """Elementwise decision over ``[P]`` tallies.

    ``yes``/``tot``/``n``/``req`` are int32 tensors, ``liveness`` bool, and
    ``is_timeout`` a bool tensor or a Python bool. Returns ``(decided,
    result)`` bool tensors; ``result`` is meaningful only where ``decided``.
    Mirrors reference src/utils.rs:227-286: n<=2 unanimity, quorum gate
    (silent peers join at timeout), silent-peer weighting, strict-majority
    wins, full-participation tie-break.
    """
    no = tot - yes
    silent = torch.clamp(n - tot, min=0)

    small = n <= 2
    small_decided = tot >= n
    small_result = yes == n

    if isinstance(is_timeout, bool):
        eff = n if is_timeout else tot
    else:
        eff = torch.where(is_timeout, n, tot)
    gate = eff >= req

    zeros = torch.zeros_like(silent)
    yes_w = yes + torch.where(liveness, silent, zeros)
    no_w = no + torch.where(liveness, zeros, silent)

    yes_win = (yes_w >= req) & (yes_w > no_w)
    no_win = (no_w >= req) & (no_w > yes_w)
    tie = (tot == n) & (yes_w == no_w)

    big_decided = gate & (yes_win | no_win | tie)
    big_result = yes_win | (~no_win & liveness)

    decided = torch.where(small, small_decided, big_decided)
    result = torch.where(small, small_result, big_result)
    return decided, result


def _reached_code(result, dtype):
    return torch.where(
        result,
        torch.tensor(STATE_REACHED_YES, dtype=dtype, device=result.device),
        torch.tensor(STATE_REACHED_NO, dtype=dtype, device=result.device),
    )


def decide_update(state, yes, tot, n, req, liveness):
    """Post-ingest consensus check (is_timeout=False) applied to ACTIVE
    slots; undecided slots stay ACTIVE (reference: src/session.rs:372-387).
    Returns a new state tensor."""
    decided, result = decide_kernel(yes, tot, n, req, liveness, False)
    active = state == STATE_ACTIVE
    return torch.where(active & decided, _reached_code(result, state.dtype), state)


def timeout_update(state, yes, tot, n, req, liveness, timeout_mask):
    """Timeout decision for masked slots (is_timeout=True).

    Mirrors ``handle_consensus_timeout`` (reference: src/service.rs:329-348):
    REACHED slots are untouched; ACTIVE *and* FAILED slots are recomputed
    and transition to FAILED when undecidable. Returns a new state tensor.
    """
    decided, result = decide_kernel(yes, tot, n, req, liveness, True)
    fires = ((state == STATE_ACTIVE) | (state == STATE_FAILED)) & timeout_mask
    failed = torch.full_like(state, STATE_FAILED)
    outcome = torch.where(decided, _reached_code(result, state.dtype), failed)
    return torch.where(fires, outcome, state)


def state_result(state):
    """Map slot states to (has_result, result) pairs for host readback."""
    has_result = (state == STATE_REACHED_YES) | (state == STATE_REACHED_NO)
    return has_result, state == STATE_REACHED_YES


def timeout_body(state, yes, tot, n, req, liveness, slot_ids):
    """Fire the timeout decision for the given slots, updating ``state`` in
    place; returns ``(state, row_state)`` with one new state per id.

    ``slot_ids`` (int tensor) uses the ingest pad contract: ids ``>= P`` are
    sentinels whose write is dropped and whose read clips to row ``P-1``
    (the clipped row's returned state is unused by the host).
    """
    p = state.shape[0]
    ids = slot_ids.long()
    clipped = ids.clamp(max=p - 1)
    real = ids < p
    rows = clipped[real]
    new_rows = timeout_update(
        state[rows],
        yes[rows],
        tot[rows],
        n[rows],
        req[rows],
        liveness[rows],
        torch.ones_like(rows, dtype=torch.bool),
    )
    state[rows] = new_rows
    return state, state[clipped]
