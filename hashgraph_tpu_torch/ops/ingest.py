"""Batched vote ingest over the dense proposal pool, in PyTorch.

Port of ``hashgraph_tpu/ops/ingest.py``. Applies a batch of (already
host-validated) votes to the pool with semantics bit-identical to repeated
``ConsensusSession::add_vote`` (reference: src/session.rs:225-249): per-slot
votes apply in arrival order with the precedence chain already-reached →
session-not-active → proposal-expired → round-cap (fails the session) →
duplicate-owner → accept, then the consensus check runs on the new tally.

Transfer format (identical to the JAX package's, so host code is shared):
- ``slot_pack`` int32[S]: slot id in bits 0-29, ``expired`` in bit 30. Rows
  with id ``>= P`` are pad rows: reads clip to row ``P-1``, writes drop.
- ``grid_pack`` [S, L]: voter lane, vote value and cell-valid bits, in the
  narrowest layout that fits the pool's lane range (:func:`grid_layout`).
  torch's ``uint16`` has few operations, so the uint16 layout crosses to the
  device as the same bits viewed as int16 (:func:`grid_tensor`).
- output int8[S, L+1]: per-vote statuses in columns [0, L), the row's final
  lifecycle state in column L.

:func:`ingest_body` is the plain version of the arrival-ordered scan: the
CPU path runs it, and the tests hold the CUDA kernel
(:mod:`hashgraph_tpu_torch.ops.cuda_ingest`) against it.
:func:`fresh_ingest_body` is the closed-form ingest for fresh slots.
Both update the pool tensors in place and return them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import StatusCode
from .decide import (
    STATE_ACTIVE,
    STATE_FAILED,
    STATE_REACHED_NO,
    STATE_REACHED_YES,
    decide_kernel,
)

# Status emitted for padding cells (no vote present).
PAD_STATUS = -1

_SLOT_MASK = (1 << 30) - 1
_EXPIRED_BIT = 30
_LANE_MASK = (1 << 16) - 1
_VAL_BIT = 16
_VALID_BIT = 17


def pack_slots(slot_ids: np.ndarray, expired: np.ndarray) -> np.ndarray:
    """Host-side: fuse slot ids + expiry flags into one int32 transfer."""
    return (
        np.asarray(slot_ids, np.int32) | (np.asarray(expired, np.int32) << _EXPIRED_BIT)
    ).astype(np.int32)


def unpack_slots(slot_pack: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side inverse of :func:`pack_slots`."""
    packed = np.asarray(slot_pack, np.int32)
    return packed & _SLOT_MASK, ((packed >> _EXPIRED_BIT) & 1).astype(bool)


def grid_dtype(voter_capacity: int):
    """Narrowest packed-grid dtype that fits lane + value + valid bits:
    uint8 cells for capacity <= 64, uint16 for <= 16384, else int32."""
    if voter_capacity <= 64:
        return np.uint8
    if voter_capacity <= 16384:
        return np.uint16
    return np.int32


def grid_layout(dtype) -> tuple[int, int, int]:
    """(lane_mask, val_bit, valid_bit) for a packed-grid dtype. Accepts the
    numpy dtypes of :func:`grid_dtype` and their torch forms (int16 stands
    for the uint16 layout, see :func:`grid_tensor`)."""
    if isinstance(dtype, torch.dtype):
        dt = np.dtype(
            {torch.uint8: np.uint8, torch.int16: np.uint16}.get(dtype, np.int32)
        )
    else:
        dt = np.dtype(dtype)
    if dt == np.uint8:
        return (1 << 6) - 1, 6, 7
    if dt == np.uint16:
        return (1 << 14) - 1, 14, 15
    return _LANE_MASK, _VAL_BIT, _VALID_BIT


def pack_grid(
    voter_grid: np.ndarray,
    val_grid: np.ndarray,
    valid_grid: np.ndarray,
    voter_capacity: int | None = None,
) -> np.ndarray:
    """Host-side: fuse lane/value/valid grids into one packed transfer.
    ``voter_capacity`` (when given) selects the narrowest dtype whose lane
    field still holds capacity-1; None keeps the int32 layout."""
    dt = np.int32 if voter_capacity is None else grid_dtype(voter_capacity)
    _, val_bit, valid_bit = grid_layout(dt)
    return (
        np.asarray(voter_grid, dt)
        | (np.asarray(val_grid, dt) << val_bit)
        | (np.asarray(valid_grid, dt) << valid_bit)
    ).astype(dt)


def grid_tensor(grid: np.ndarray, device) -> torch.Tensor:
    """Move a packed grid to ``device`` as raw bits: uint16 grids travel as
    int16 (same bytes), uint8 and int32 as themselves."""
    grid = np.ascontiguousarray(grid)
    if grid.dtype == np.uint16:
        grid = grid.view(np.int16)
    return torch.from_numpy(grid).to(device)


def group_batch(slot_idx: np.ndarray):
    """Host-side: group a flat vote batch by proposal slot into grid
    coordinates, preserving arrival order within each slot.

    Returns ``(uniq_slots[S], row[B], col[B], L)`` where batch item ``b``
    lands at grid cell ``(row[b], col[b])`` and ``L`` is the deepest
    per-slot chain.
    """
    b_count = len(slot_idx)
    if b_count == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int64), 0
    order = np.argsort(slot_idx, kind="stable")
    sorted_slots = slot_idx[order]
    is_start = np.empty(b_count, bool)
    is_start[0] = True
    np.not_equal(sorted_slots[1:], sorted_slots[:-1], out=is_start[1:])
    starts_idx = np.nonzero(is_start)[0]
    uniq = sorted_slots[starts_idx]
    inverse_sorted = np.cumsum(is_start) - 1
    starts = starts_idx[inverse_sorted]
    pos_sorted = np.arange(b_count) - starts
    counts_max = int(np.max(np.diff(np.append(starts_idx, b_count))))
    row = np.empty(b_count, dtype=np.int64)
    col = np.empty(b_count, dtype=np.int64)
    row[order] = inverse_sorted
    col[order] = pos_sorted
    return uniq, row, col, counts_max


_OK = int(StatusCode.OK)
_ALREADY_REACHED = int(StatusCode.ALREADY_REACHED)
_SESSION_NOT_ACTIVE = int(StatusCode.SESSION_NOT_ACTIVE)
_PROPOSAL_EXPIRED = int(StatusCode.PROPOSAL_EXPIRED)
_MAX_ROUNDS_EXCEEDED = int(StatusCode.MAX_ROUNDS_EXCEEDED)
_DUPLICATE_VOTE = int(StatusCode.DUPLICATE_VOTE)


def _unpack_slots(slot_pack, p: int):
    slot_ids = (slot_pack & _SLOT_MASK).long()
    expired = ((slot_pack >> _EXPIRED_BIT) & 1).bool()
    return slot_ids, slot_ids.clamp(max=p - 1), slot_ids < p, expired


def _unpack_cells(grid_pack):
    """(lane int64, value bool, valid bool) planes of a packed grid."""
    lane_mask, val_bit, valid_bit = grid_layout(grid_pack.dtype)
    cells = grid_pack.to(torch.int32)
    if grid_pack.dtype == torch.int16:
        cells = cells & 0xFFFF  # undo the sign extension of the raw bits
    return (
        (cells & lane_mask).long(),
        ((cells >> val_bit) & 1).bool(),
        ((cells >> valid_bit) & 1).bool(),
    )


def _select(cond, a: int, b):
    return torch.where(cond, torch.full_like(b, a), b)


def ingest_body(
    state,  # int32[P] slot lifecycle
    yes,  # int32[P] YES tally
    tot,  # int32[P] total tally
    vote_mask,  # bool[P, V] who has voted
    vote_val,  # bool[P, V] their choice
    n,  # int32[P] expected voters
    req,  # int32[P] precomputed required votes
    cap,  # int32[P] max round limit (max_round_limit semantics)
    gossipsub,  # bool[P] gossipsub round semantics flag
    liveness,  # bool[P] silent-peers-as-YES flag
    slot_pack,  # int32[S] packed slot ids + expired flags
    grid_pack,  # [S, L] packed voter/value/valid cells
):
    """The arrival-ordered vote scan, plain PyTorch. Updates the pool
    tensors in place and returns ``(state, yes, tot, vote_mask, vote_val,
    out int8[S, L+1])``."""
    p = state.shape[0]
    s_count, depth = grid_pack.shape
    rows = torch.arange(s_count, device=state.device)
    slot_ids, gather_ids, real, expired = _unpack_slots(slot_pack, p)
    voter_grid, val_grid, valid_grid = _unpack_cells(grid_pack)

    st = state[gather_ids]
    ys = yes[gather_ids]
    tt = tot[gather_ids]
    mask = vote_mask[gather_ids]
    vals = vote_val[gather_ids]
    row_n = n[gather_ids]
    row_req = req[gather_ids]
    row_cap = cap[gather_ids]
    row_gossip = gossipsub[gather_ids]
    row_live = liveness[gather_ids]

    two = torch.full_like(tt, 2)
    statuses = torch.empty((s_count, depth), dtype=torch.int32, device=state.device)
    for col in range(depth):
        voter = voter_grid[:, col]
        val = val_grid[:, col]
        valid = valid_grid[:, col]

        reached = (st == STATE_REACHED_YES) | (st == STATE_REACHED_NO)
        active = st == STATE_ACTIVE
        # Round projection (reference: src/session.rs:306-344): gossipsub
        # always projects round 2; P2P projects accepted-votes + 1.
        projected = torch.where(row_gossip, two, tt + 1)
        exceeded = projected > row_cap
        dup = mask[rows, voter]

        ok = valid & active & ~expired & ~exceeded & ~dup
        status = torch.full_like(tt, _OK)
        status = _select(dup, _DUPLICATE_VOTE, status)
        status = _select(exceeded, _MAX_ROUNDS_EXCEEDED, status)
        status = _select(expired, _PROPOSAL_EXPIRED, status)
        status = _select(~active, _SESSION_NOT_ACTIVE, status)
        status = _select(reached, _ALREADY_REACHED, status)
        status = _select(~valid, PAD_STATUS, status)
        statuses[:, col] = status

        # A cap violation fails the session though the vote is rejected
        # (reference: src/session.rs:334-341).
        st = _select(valid & active & ~expired & exceeded, STATE_FAILED, st)

        tt = tt + ok.to(tt.dtype)
        ys = ys + (ok & val).to(ys.dtype)
        mask[rows, voter] = dup | ok
        vals[rows, voter] = torch.where(ok, val, vals[rows, voter])

        decided, result = decide_kernel(ys, tt, row_n, row_req, row_live, False)
        newly = ok & decided
        reached_state = torch.where(
            result, torch.full_like(st, STATE_REACHED_YES),
            torch.full_like(st, STATE_REACHED_NO),
        )
        st = torch.where(newly, reached_state, st)

    ids = slot_ids[real]
    state[ids] = st[real]
    yes[ids] = ys[real]
    tot[ids] = tt[real]
    vote_mask[ids] = mask[real]
    vote_val[ids] = vals[real]

    out = torch.cat([statuses, st[:, None]], dim=1).to(torch.int8)
    return state, yes, tot, vote_mask, vote_val, out


def fresh_ingest_body(
    state,
    yes,
    tot,
    vote_mask,
    vote_val,
    n,
    req,
    cap,
    gossipsub,
    liveness,
    slot_pack,  # int32[S] packed slot ids + expired flags
    grid_pack,  # packed cells: see `laneless` below
    *,
    laneless: bool = False,
):
    """Closed-form ingest for FRESH slots: the whole per-slot vote chain in
    one dispatch with no sequential scan.

    ``laneless=True``: the grid carries only value (bit 0) and valid (bit 1)
    per uint8 cell; voter lanes are the within-slot arrival index, which is
    exactly what the fresh-path lane assignment produces.

    For a batch where every touched slot is freshly ACTIVE with zero tallies
    and no (slot, voter) pair repeats, every valid vote before the terminal
    event is accepted: running tallies are prefix sums, the round-cap and
    decision indices are first-true reductions over the elementwise
    :func:`decide_kernel`, and statuses follow from index-vs-terminal
    comparisons. Bit-identical to replaying the scan on a fresh slot.

    PRECONDITIONS (engine-enforced): touched slots are ACTIVE with
    tot == yes == 0 and cleared mask/val rows; no duplicate (slot, voter)
    pair. Updates the pool tensors in place; returns the same tuple as
    :func:`ingest_body`.
    """
    p, v_cap = vote_mask.shape
    s_count, depth = grid_pack.shape
    dev = state.device

    slot_ids, gather_ids, real, expired = _unpack_slots(slot_pack, p)
    if laneless:
        cells = grid_pack.to(torch.int32)
        val_grid = (cells & 1).bool()
        valid = ((cells >> 1) & 1).bool()
        voter_grid = torch.arange(depth, device=dev).expand(s_count, depth)
    else:
        voter_grid, val_grid, valid = _unpack_cells(grid_pack)

    row_n = n[gather_ids][:, None]
    row_req = req[gather_ids][:, None]
    row_cap = cap[gather_ids][:, None]
    row_gossip = gossipsub[gather_ids][:, None]
    row_live = liveness[gather_ids][:, None]

    live = valid & ~expired[:, None]
    T = torch.cumsum(live.to(torch.int32), dim=1, dtype=torch.int32)
    Y = torch.cumsum((live & val_grid).to(torch.int32), dim=1, dtype=torch.int32)

    # Round-cap check per vote, pre-accept (reference: src/session.rs:306-344).
    projected = torch.where(row_gossip, torch.full_like(T, 2), T)
    exceeded = live & (projected > row_cap)
    decided_i, result_i = decide_kernel(Y, T, row_n, row_req, row_live, False)
    dec = live & decided_i

    idxs = torch.arange(depth, dtype=torch.int32, device=dev)[None, :]
    no_term = torch.full((s_count,), depth, dtype=torch.int32, device=dev)
    c_has = dec.any(dim=1)
    c = torch.where(c_has, torch.argmax(dec.to(torch.int8), dim=1).to(torch.int32), no_term)
    f_has = exceeded.any(dim=1)
    f = torch.where(
        f_has, torch.argmax(exceeded.to(torch.int8), dim=1).to(torch.int32), no_term
    )
    # A vote that violates the cap is rejected before it could decide, so
    # the cap-fail terminal wins ties.
    dec_term = c < f
    fail_term = f_has & ~dec_term
    t_idx = torch.where(dec_term, c, f)[:, None]

    pre = idxs < t_idx
    at = idxs == t_idx
    dec_col = dec_term[:, None]
    status = torch.where(
        pre,
        _OK,
        torch.where(
            at,
            torch.where(dec_col, _OK, _MAX_ROUNDS_EXCEEDED),
            torch.where(dec_col, _ALREADY_REACHED, _SESSION_NOT_ACTIVE),
        ),
    ).to(torch.int32)
    status = torch.where(expired[:, None], _PROPOSAL_EXPIRED, status).to(torch.int32)
    status = torch.where(valid, status, PAD_STATUS).to(torch.int32)

    # Accepted set: valid live votes up to the terminal (inclusive for a
    # decision — the deciding vote is accepted; exclusive for a cap fail).
    acc = live & (pre | (at & dec_col))

    def take_at(m, i):
        return torch.gather(m, 1, i.long()[:, None])[:, 0]

    zeros = torch.zeros(s_count, dtype=torch.int32, device=dev)
    last_T = T[:, -1] if depth else zeros
    last_Y = Y[:, -1] if depth else zeros
    cc = torch.clamp(c, max=depth - 1)
    ff = torch.clamp(f, max=depth - 1)
    tot_new = torch.where(
        dec_term,
        take_at(T, cc),
        torch.where(fail_term, take_at(T, ff) - 1, last_T),
    )
    yes_new = torch.where(
        dec_term,
        take_at(Y, cc),
        torch.where(
            fail_term,
            take_at(Y, ff) - (take_at(val_grid, ff) & take_at(live, ff)).to(torch.int32),
            last_Y,
        ),
    )
    result_c = take_at(result_i, cc)
    prev_state = state[gather_ids]
    row_state = torch.where(
        dec_term,
        torch.where(
            result_c,
            torch.full_like(prev_state, STATE_REACHED_YES),
            torch.full_like(prev_state, STATE_REACHED_NO),
        ),
        torch.where(fail_term, torch.full_like(prev_state, STATE_FAILED), prev_state),
    )

    ids = slot_ids[real]
    state[ids] = row_state[real]
    yes[ids] = yes_new[real].to(yes.dtype)
    tot[ids] = tot_new[real].to(tot.dtype)
    # Fresh rows start all-False and each (slot, lane) is touched at most
    # once, so setting the accepted cells is the reference's scatter-max.
    # Pad rows and out-of-range lanes drop, as the reference's scatter does.
    rows_flat = slot_ids[:, None].expand(s_count, depth)
    keep = acc & real[:, None] & (voter_grid < v_cap)
    vote_mask[rows_flat[keep], voter_grid[keep]] = True
    keep_val = keep & val_grid
    vote_val[rows_flat[keep_val], voter_grid[keep_val]] = True

    out = torch.cat([status, row_state[:, None].to(torch.int32)], dim=1).to(torch.int8)
    return state, yes, tot, vote_mask, vote_val, out
