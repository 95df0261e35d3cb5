"""Vectorized hashgraph vote-chain validation, in PyTorch.

Port of ``hashgraph_tpu/ops/chain.py``. The vote chain is an append-only
hash-linked sequence per proposal (reference: src/utils.rs:175-215). The
scalar rules only reference index ``i-1`` (received link) and one
hash-indexed earlier vote (parent link), so validation needs no sequential
scan: a shifted row compare plus an O(V²) equality matrix, over a batch of
chains at once.

Exact reference semantics reproduced:
- received rule (``idx > 0`` only — index 0 is never checked): a non-empty
  ``received_hash`` must equal the previous vote's ``vote_hash`` and the
  previous timestamp must be ≤ this one's (utils.rs:188-198);
- parent rule: a non-empty ``parent_hash`` is looked up in a hash→index map
  built with LAST-occurrence-wins over the full list (utils.rs:181-184);
  that single entry must be an earlier index, same owner, timestamp ≤
  (utils.rs:200-211) — existence of *some* matching earlier vote is NOT
  sufficient if a later vote shadows it in the map;
- fail-fast order: first offending index wins; within one index the
  received check precedes the parent check.

Device encoding (the host packs with :func:`pack_chain`, a copy of the JAX
package's, so its arrays are identical):
- hashes → ``int32[V, 9]``: 8 little-endian 4-byte words + a length column
  (length participates in equality; hashes over 32 bytes are canonicalised
  through SHA-256 first, with length sentinel 33);
- u64 timestamps → two bias-encoded int32 columns (hi, lo) compared
  lexicographically;
- owners → dict-encoded int32 ids (exact bytes equality).

The JAX package leaves this to XLA (``jit(vmap(chain_body))``), which fuses
the ``[V, V, 9]`` equality away. Here :func:`chain_body` is written once
over ``[B, V, ...]`` tensors on whatever device they live on, and the
parent match is ANDed word by word into one ``[B, V, V]`` bool (never a
``[B, V, V, 9]`` tensor); :func:`chain_kernel_batch` splits the batch so
that no piece passes :data:`CHAIN_CELL_BUDGET` matrix cells. Everything is
int32 or bool and every comparison is exact.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..errors import StatusCode
from ..wire import Vote

__all__ = [
    "CHAIN_CELL_BUDGET",
    "CHAIN_FIELDS",
    "chain_body",
    "chain_kernel",
    "chain_kernel_batch",
    "first_chain_error",
    "pack_chain",
    "pack_chains",
    "parent_matches",
]

HASH_WORDS = 8
_BIAS = np.int64(-0x80000000)  # maps u32 order onto i32 order

_OK = int(StatusCode.OK)
_RECV = int(StatusCode.RECEIVED_HASH_MISMATCH)
_PARENT = int(StatusCode.PARENT_HASH_MISMATCH)

# The packed fields and their dtypes, in chain_body's argument order.
CHAIN_FIELDS = {
    "vote_hash": torch.int32,
    "received_hash": torch.int32,
    "parent_hash": torch.int32,
    "owner": torch.int32,
    "ts": torch.int32,
    "valid": torch.bool,
}

# Most [B, V, V] cells one chain_body call may hold: the parent match keeps
# a bool and an int32 per cell and makes one bool temporary (96 MB at this
# budget). A 1,024-vote chain is 2^20 cells, so 16 of them go in one piece.
CHAIN_CELL_BUDGET = 1 << 24


def _pack_hashes(hashes: list[bytes]) -> np.ndarray:
    """[V] bytes -> int32[V, 9] (8 words + length; empty = all-zero row)."""
    v = len(hashes)
    out = np.zeros((v, HASH_WORDS + 1), np.int32)
    for i, h in enumerate(hashes):
        if len(h) > 32:
            h = hashlib.sha256(h).digest()
            length = 33  # sentinel: "canonicalised long hash"
        else:
            length = len(h)
        padded = h + b"\x00" * (32 - len(h))
        out[i, :HASH_WORDS] = np.frombuffer(padded, np.uint32).view(np.int32)
        out[i, HASH_WORDS] = length
    return out


def _pack_ts(ts: list[int]) -> np.ndarray:
    """u64 timestamps -> bias-encoded int32[V, 2] (hi, lo), order-preserving
    under lexicographic signed comparison."""
    arr = np.array(ts, np.uint64)
    hi = ((arr >> np.uint64(32)).astype(np.int64) + _BIAS).astype(np.int32)
    lo = ((arr & np.uint64(0xFFFFFFFF)).astype(np.int64) + _BIAS).astype(np.int32)
    return np.stack([hi, lo], axis=1)


def pack_chain(
    votes: list[Vote], pad_to: int | None = None
) -> dict[str, np.ndarray]:
    """Encode a proposal's ordered vote list for :func:`chain_body`."""
    v = len(votes)
    width = pad_to if pad_to is not None else v
    if width < v:
        raise ValueError("pad_to smaller than vote count")

    owners: dict[bytes, int] = {}
    owner_ids = np.zeros(width, np.int32)
    for i, vote in enumerate(votes):
        owner_ids[i] = owners.setdefault(vote.vote_owner, len(owners))

    def field(hashes: list[bytes]) -> np.ndarray:
        packed = _pack_hashes(hashes)
        out = np.zeros((width, HASH_WORDS + 1), np.int32)
        out[:v] = packed
        return out

    ts = np.zeros((width, 2), np.int32)
    ts[:v] = _pack_ts([vote.timestamp for vote in votes])
    valid = np.zeros(width, bool)
    valid[:v] = True
    return dict(
        vote_hash=field([vote.vote_hash for vote in votes]),
        received_hash=field([vote.received_hash for vote in votes]),
        parent_hash=field([vote.parent_hash for vote in votes]),
        owner=owner_ids,
        ts=ts,
        valid=valid,
    )


def pack_chains(chains: "list[list[Vote]]") -> dict[str, np.ndarray]:
    """Pack several chains, padded to the longest, stacked on a leading
    batch axis: the ``[B, V, ...]`` input of :func:`chain_kernel_batch`."""
    pad = max(len(votes) for votes in chains)
    packs = [pack_chain(votes, pad_to=pad) for votes in chains]
    return {key: np.stack([p[key] for p in packs]) for key in CHAIN_FIELDS}


def _ts_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic ≤ over bias-encoded (hi, lo) int32 pairs."""
    return (a[..., 0] < b[..., 0]) | (
        (a[..., 0] == b[..., 0]) & (a[..., 1] <= b[..., 1])
    )


def parent_matches(
    parent_hash: torch.Tensor, vote_hash: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """``eq[b, i, j]``: chain b's parent hash i equals its vote hash j, and
    row j is a real vote. The 9 words are compared one at a time and ANDed
    into one ``[B, V, V]`` bool, equal to ``(parent_hash[:, :, None] ==
    vote_hash[:, None]).all(-1) & valid[:, None, :]`` without its
    ``[B, V, V, 9]`` intermediate."""
    eq = parent_hash[:, :, None, 0] == vote_hash[:, None, :, 0]
    for w in range(1, HASH_WORDS + 1):
        eq &= parent_hash[:, :, None, w] == vote_hash[:, None, :, w]
    eq &= valid[:, None, :]
    return eq


def chain_body(vote_hash, received_hash, parent_hash, owner, ts, valid):
    """Per-vote chain statuses for a batch of proposals' ordered votes.

    Args (tensors on one device, B chains, V = padded vote count):
      vote_hash / received_hash / parent_hash: int32[B, V, 9]
      owner: int32[B, V] dict-encoded owner ids
      ts: int32[B, V, 2] bias-encoded timestamps
      valid: bool[B, V] real-vote mask (pad rows always pass)

    Returns int32[B, V]: OK / RECEIVED_HASH_MISMATCH / PARENT_HASH_MISMATCH
    per vote, with the reference's intra-vote precedence (received first).
    """
    b, v = owner.shape
    if v == 0:
        return torch.zeros((b, 0), dtype=torch.int32, device=owner.device)
    idx = torch.arange(v, dtype=torch.int32, device=owner.device)
    empty_recv = received_hash[..., HASH_WORDS] == 0
    empty_parent = parent_hash[..., HASH_WORDS] == 0

    # Received rule: row i vs row i-1 of the same chain (row 0 exempt).
    prev_hash = torch.roll(vote_hash, 1, dims=1)
    prev_ts = torch.roll(ts, 1, dims=1)
    recv_eq = (received_hash == prev_hash).all(dim=2)
    recv_ok = (idx == 0) | empty_recv | (recv_eq & _ts_le(prev_ts, ts))

    # Parent rule: last-occurrence hash index. eq[b, i, j] = parent i
    # matches vote-hash j (pad rows excluded); j* = the largest matching j.
    eq = parent_matches(parent_hash, vote_hash, valid)
    j_star = (eq * (idx + 1)).amax(dim=2) - 1
    found = j_star >= 0
    j_clip = j_star.clamp(min=0).long()
    parent_owner = torch.gather(owner, 1, j_clip)
    parent_ts = torch.gather(ts, 1, j_clip[..., None].expand(b, v, 2))
    parent_ok = empty_parent | (
        found
        & (parent_owner == owner)
        & _ts_le(parent_ts, ts)
        & (j_star < idx)
    )

    status = torch.full((b, v), _OK, dtype=torch.int32, device=owner.device)
    status.masked_fill_(~parent_ok, _PARENT)
    status.masked_fill_(~recv_ok, _RECV)
    return status.masked_fill_(~valid, _OK)


def chain_kernel_batch(vote_hash, received_hash, parent_hash, owner, ts, valid):
    """:func:`chain_body` over ``[B, V, ...]``, in pieces of at most
    :data:`CHAIN_CELL_BUDGET` parent-match cells (at least one chain a
    piece)."""
    b, v = owner.shape
    per = max(1, CHAIN_CELL_BUDGET // max(v * v, 1))
    if b <= per:
        return chain_body(vote_hash, received_hash, parent_hash, owner, ts, valid)
    return torch.cat([
        chain_body(vote_hash[s:s + per], received_hash[s:s + per],
                   parent_hash[s:s + per], owner[s:s + per], ts[s:s + per],
                   valid[s:s + per])
        for s in range(0, b, per)
    ])


def chain_kernel(vote_hash, received_hash, parent_hash, owner, ts, valid):
    """One chain (``[V, ...]`` tensors, B = 1): int32[V] statuses."""
    return chain_body(
        vote_hash[None], received_hash[None], parent_hash[None],
        owner[None], ts[None], valid[None],
    )[0]


def first_chain_error(statuses) -> int:
    """Reduce per-vote statuses to the reference's fail-fast result: the
    status of the first offending vote, or OK. Lists of length ≤ 1 are
    trivially valid (utils.rs:176-178) — callers skip the check for those.
    """
    statuses = np.asarray(statuses)
    bad = np.nonzero(statuses != _OK)[0]
    return int(statuses[bad[0]]) if bad.size else _OK
