"""Device-resident proposal pool: dense slot-indexed consensus state.

Port of ``hashgraph_tpu/engine/pool.py`` to PyTorch. A fixed-capacity,
structure-of-arrays store of ``P`` proposal slots × ``V`` voter lanes held
as tensors on one device (reference: src/storage.rs:188-194 holds the same
state as per-scope session maps). The host keeps the irregular bookkeeping
— the free list, slot↔proposal mapping, owner-bytes→voter-lane tables,
expiry timestamps and a mirror of every slot's state — exactly as the JAX
package does; only the ``_dispatch_*`` methods touch the device. Inside
:meth:`ProposalPool.deferred_writes` the slot writes of releases and
allocations are held back and made at the scope's end as one release and
one activate dispatch, while the host bookkeeping changes at once.

Differences from the JAX pool:
- the ten device tensors are updated in place by slot id (no donation);
- no power-of-two batch buckets: PyTorch compiles nothing per shape, so
  dispatches carry exactly the touched rows (the fresh-path cell budget
  keeps the reference's bucketed arithmetic so routing is unchanged);
- the arrival-ordered scan runs the hand-written CUDA kernel on a GPU
  (:mod:`hashgraph_tpu_torch.ops.cuda_ingest`) and its plain version on
  the CPU; the closed-form fresh ingest is PyTorch ops on either.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from itertools import repeat
from typing import Callable, Hashable

import numpy as np
import torch

from .._build import resolve_device
from ..ops.cuda_ingest import ingest_scan
from ..ops.decide import STATE_ACTIVE, STATE_FREE, timeout_body
from ..ops.ingest import (
    fresh_ingest_body,
    grid_tensor,
    group_batch,
    pack_grid,
    pack_slots,
    unpack_slots,
)

__all__ = [
    "ProposalPool", "SlotMeta", "SlotTensors", "PoolFullError", "PendingIngest",
]


class PoolFullError(RuntimeError):
    """The pool has no free slots (capacity P exhausted)."""


def _bucket(size: int, floor: int = 8) -> int:
    """Power-of-two round-up the JAX pool pads its dispatches to; kept for
    the fresh-path cell budget so the port routes batches identically."""
    return max(floor, 1 << max(size - 1, 0).bit_length())


@dataclass
class PendingIngest:
    """An in-flight ingest dispatch: the device output plus the host-side
    coordinates needed to interpret it."""

    # device int8[rows, L+1]: statuses + final row state (a sharded pool's
    # is one such tensor a block, parallel.sharded.BlockOutputs)
    out: torch.Tensor
    uniq: np.ndarray  # [S] touched slots
    row: np.ndarray  # [B] batch item -> grid row
    col: np.ndarray  # [B] batch item -> grid col
    row_select: np.ndarray  # routed-row indexer: out[row_select] -> [S, :]


@dataclass(slots=True)
class SlotMeta:
    """Host-side bookkeeping for one allocated slot. Voter-lane assignments
    live in the pool's dense ``_lane_gids``/``_lane_count`` tables."""

    key: Hashable  # engine-level key, e.g. (scope, proposal_id)
    expiry: int  # absolute expiration timestamp (seconds)
    created_at: int


class SlotTensors:
    """The device half of a pool: the ten slot-indexed tensors, ``capacity``
    rows of them on one device, and the dispatches that touch them by row
    id. :class:`ProposalPool` is one of these plus the host bookkeeping; a
    sharded pool (:mod:`..parallel.sharded`) holds one a mesh entry."""

    def __init__(self, capacity: int, voter_capacity: int, device: torch.device):
        self.capacity = capacity
        self.voter_capacity = voter_capacity
        self.device = device
        self._init_device_arrays()

    def _init_device_arrays(self) -> None:
        p, v, dev = self.capacity, self.voter_capacity, self.device
        self._state = torch.full((p,), STATE_FREE, dtype=torch.int32, device=dev)
        self._yes = torch.zeros(p, dtype=torch.int32, device=dev)
        self._tot = torch.zeros(p, dtype=torch.int32, device=dev)
        self._vote_mask = torch.zeros((p, v), dtype=torch.bool, device=dev)
        self._vote_val = torch.zeros((p, v), dtype=torch.bool, device=dev)
        self._n = torch.zeros(p, dtype=torch.int32, device=dev)
        self._req = torch.zeros(p, dtype=torch.int32, device=dev)
        self._cap = torch.zeros(p, dtype=torch.int32, device=dev)
        self._gossip = torch.zeros(p, dtype=torch.bool, device=dev)
        self._liveness = torch.zeros(p, dtype=torch.bool, device=dev)

    def _to_device(self, arr: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=self.device, dtype=dtype
        )

    def _pool_tensors(self) -> tuple:
        return (
            self._state, self._yes, self._tot, self._vote_mask, self._vote_val,
            self._n, self._req, self._cap, self._gossip, self._liveness,
        )

    # ── Device dispatch ────────────────────────────────────────────────

    def _dispatch_activate(self, slots, n, req, cap, gossip, liveness) -> None:
        ids = self._to_device(slots, torch.long)
        self._state[ids] = STATE_ACTIVE
        self._yes[ids] = 0
        self._tot[ids] = 0
        self._vote_mask[ids] = False
        self._vote_val[ids] = False
        self._n[ids] = self._to_device(n, torch.int32)
        self._req[ids] = self._to_device(req, torch.int32)
        self._cap[ids] = self._to_device(cap, torch.int32)
        self._gossip[ids] = self._to_device(gossip, torch.bool)
        self._liveness[ids] = self._to_device(liveness, torch.bool)

    def _dispatch_load(self, slots, state, yes, tot, mask_rows, val_rows) -> None:
        ids = self._to_device(slots, torch.long)
        self._state[ids] = self._to_device(state, torch.int32)
        self._yes[ids] = self._to_device(yes, torch.int32)
        self._tot[ids] = self._to_device(tot, torch.int32)
        self._vote_mask[ids] = self._to_device(mask_rows, torch.bool)
        self._vote_val[ids] = self._to_device(val_rows, torch.bool)

    def _dispatch_release(self, slots) -> None:
        self._state[self._to_device(slots, torch.long)] = STATE_FREE

    def _dispatch_ingest(self, slot_pack, grid_pack):
        """Launch the arrival-ordered scan on the packed batch; returns
        (device out [S, L+1], row-select indexer). Does not block. The
        host knows whether the batch holds pad rows (ids >= P), so the
        kernel's pad-row phase is launched only when it does."""
        out = ingest_scan(
            *self._pool_tensors(),
            self._to_device(slot_pack, torch.int32),
            grid_tensor(grid_pack, self.device),
            pad_rows=bool((unpack_slots(slot_pack)[0] >= self.capacity).any()),
        )
        return out, np.arange(len(slot_pack))

    def _dispatch_ingest_fresh(self, slot_pack, grid_pack, laneless=False):
        """Closed-form (scan-free) ingest dispatch for fresh-slot batches —
        same transfer contract as :meth:`_dispatch_ingest`."""
        out = fresh_ingest_body(
            *self._pool_tensors(),
            self._to_device(slot_pack, torch.int32),
            grid_tensor(grid_pack, self.device),
            laneless=laneless,
        )[-1]
        return out, np.arange(len(slot_pack))

    def _dispatch_timeout(self, slots) -> np.ndarray:
        """Returns new row states, one per requested slot."""
        _, row_state = timeout_body(
            self._state, self._yes, self._tot, self._n, self._req,
            self._liveness, self._to_device(slots, torch.long),
        )
        return row_state.cpu().numpy()

    def read_slots(self, slots) -> dict[str, np.ndarray]:
        """Batched :meth:`read_slot`: one gather and one transfer per array
        for many slots (arrays indexed [k] in ``slots`` order)."""
        ids = self._to_device(np.asarray(slots, np.int64), torch.long)
        ids = ids.clamp(0, self.capacity - 1)
        return dict(
            state=self._state[ids].cpu().numpy(),
            yes=self._yes[ids].cpu().numpy(),
            tot=self._tot[ids].cpu().numpy(),
            vote_mask=self._vote_mask[ids].cpu().numpy(),
            vote_val=self._vote_val[ids].cpu().numpy(),
        )


class ProposalPool(SlotTensors):
    """Fixed-capacity device pool of consensus proposal slots.

    ``capacity`` (P) bounds concurrent proposals; ``voter_capacity`` (V)
    bounds ``expected_voters_count`` per proposal. ``device`` defaults to
    ``"cuda"`` and raises without a GPU. All mutating methods are batched;
    statuses and transitions are returned per call with no global
    readbacks.
    """

    # The slot writes :meth:`deferred_writes` holds back: slot -> [its last
    # activation's fields (n, req, cap, gossip, liveness) or None, whether a
    # release came after it]; None while writes are dispatched at once. The
    # scope belongs to the thread that opened it. Class defaults, so pools
    # built without __init__ (convert.pool_from_numpy) have them.
    _deferred: "dict[int, list] | None" = None
    _deferring_thread: "int | None" = None
    _on_flush: "Callable[[int, bool], None] | None" = None

    def __init__(self, capacity: int, voter_capacity: int, device="cuda"):
        if capacity < 1 or voter_capacity < 1:
            raise ValueError("capacity and voter_capacity must be >= 1")
        super().__init__(capacity, voter_capacity, resolve_device(device))

        # Host mirrors / bookkeeping (identical to the JAX pool's).
        self._state_host = np.full(capacity, STATE_FREE, np.int32)
        self._expiry_host = np.zeros(capacity, np.int64)
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        self._meta: dict[int, SlotMeta] = {}
        # Voter identity registry + dense lane tables: owners intern to a
        # generation-tagged global id (``generation << 32 | index``);
        # per-slot lanes are first-come order in ``_lane_gids`` rows.
        self._gid_of: dict[bytes, int] = {}
        self._owners: list[bytes] = []
        self._gid_refs = np.zeros(0, np.int64)
        self._gid_live = np.zeros(0, bool)
        self._gid_gen = np.zeros(0, np.int64)
        self._gen_floor = 0
        self._free_gids: list[int] = []
        self._lane_gids = np.full((capacity, voter_capacity), -1, np.int32)
        self._lane_count = np.zeros(capacity, np.int32)
        # Host mirror updates must apply in dispatch order, and no other
        # mutation may interleave with in-flight ingests.
        self._inflight: list[PendingIngest] = []

    # ── Introspection ──────────────────────────────────────────────────

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def allocated_slots(self) -> int:
        return self.capacity - len(self._free)

    def meta(self, slot: int) -> SlotMeta:
        return self._meta[slot]

    # ── Voter identity / lane resolution ───────────────────────────────

    def voter_gid(self, owner: bytes) -> int:
        """Intern owner bytes to a generation-tagged global voter id
        (``generation << 32 | index``; first use assigns, indices of
        fully-released voters are recycled under a bumped generation).
        Columnar callers ship these ids instead of bytes. A gid freed by a
        release is rejected with a typed status from then on — including
        after its index is recycled to a new owner, whose gid carries a
        different generation. Holding a gid across membership-mutating
        calls is therefore safe-but-wasteful (it may start rejecting);
        re-intern per batch (a dict hit) for gids that track membership."""
        gid = self._gid_of.get(owner)
        if gid is None:
            if self._free_gids:
                gid = self._free_gids.pop()
                self._owners[gid] = owner
                self._gid_refs[gid] = 0
            else:
                gid = len(self._owners)
                self._owners.append(owner)
                if gid >= len(self._gid_refs):
                    grow = max(64, len(self._gid_refs))
                    self._gid_refs = np.concatenate(
                        [self._gid_refs, np.zeros(grow, np.int64)]
                    )
                    self._gid_live = np.concatenate(
                        [self._gid_live, np.zeros(grow, bool)]
                    )
                    self._gid_gen = np.concatenate(
                        [self._gid_gen, np.full(grow, self._gen_floor, np.int64)]
                    )
                self._gid_refs[gid] = 0
            self._gid_live[gid] = True
            self._gid_of[owner] = gid
        return (int(self._gid_gen[gid]) << 32) | gid

    def voter_gids(self, owners: "list[bytes]") -> np.ndarray:
        """:meth:`voter_gid` of each owner, in order: the same gids, and new
        owners interned in the same order. Known owners resolve in one
        dict pass (a lookup changes nothing), the rest one at a time."""
        index = np.array(list(map(self._gid_of.get, owners, repeat(-1))), np.int64)
        gids = np.empty(len(owners), np.int64)
        known = index >= 0
        gids[known] = (self._gid_gen[index[known]] << 32) | index[known]
        for i in np.nonzero(~known)[0].tolist():
            gids[i] = self.voter_gid(owners[i])
        return gids

    def owner_of_gid(self, gid: int) -> bytes:
        """Owner bytes for a gid the caller has checked via gids_live
        (the generation tag is stripped; liveness is not re-checked)."""
        return self._owners[int(gid) & 0xFFFFFFFF]

    @property
    def voter_gid_count(self) -> int:
        """Size of the gid index-space (low 32 bits of public gids).
        Recycled indices keep this from growing with voter churn."""
        return len(self._owners)

    @property
    def live_voter_count(self) -> int:
        """Number of owner identities currently mapped to a gid."""
        return len(self._gid_of)

    def lane_owners(self, slot: int) -> dict[int, bytes]:
        """lane -> owner bytes for one slot's assigned lanes (export path)."""
        row = self._lane_gids[slot]
        out: dict[int, bytes] = {}
        for lane in range(int(self._lane_count[slot])):
            gid = int(row[lane])
            if 0 <= gid < len(self._owners) and self._gid_live[gid]:
                out[lane] = self._owners[gid]
        return out

    def gids_live(self, gids: np.ndarray) -> np.ndarray:
        """Bool mask: True where the gid currently maps an interned owner
        AND carries that index's current generation. Out-of-range ids,
        freed ids, and stale-generation ids (held across a release, even
        after the index was recycled to a new owner) are all False —
        columnar callers use this to reject stale gids with a typed status
        instead of attributing votes to the recycled index's new claimant."""
        gids = np.asarray(gids, np.int64)
        if len(gids) >= 512:
            # Fused native pass (GIL released); ~6 numpy passes otherwise.
            from .. import native

            res = native.gids_live(
                gids, self._gid_live[: len(self._owners)],
                self._gid_gen[: len(self._owners)],
            )
            if res is not None:
                return res
        idx = gids & 0xFFFFFFFF
        gen = gids >> 32
        out = np.zeros(len(gids), bool)
        ok = (gids >= 0) & (idx < len(self._owners))
        if ok.any():
            sel = idx[ok]
            out[ok] = self._gid_live[sel] & (self._gid_gen[sel] == gen[ok])
        return out

    def clear_voter_registry(self) -> None:
        """Reset the owner↔gid interning tables.

        The registry is append-only while sessions are live (gids are
        embedded in active slots' lane tables), so it grows with the
        distinct-voter population — bounded for real consensus deployments
        (a known peer set), but a long-lived pool that has churned through
        many transient identities can reclaim the memory at any quiesce
        point where no slots are allocated. Interned gids become invalid;
        columnar callers must re-intern via voter_gid."""
        if self._meta:
            raise RuntimeError(
                f"cannot clear voter registry with {len(self._meta)} slots "
                "allocated (their lane tables reference interned gids)"
            )
        # Raise the generation floor past everything ever minted: a gid
        # held across the clear must keep rejecting (typed), not become
        # bit-identical to the first post-clear claimant's gid.
        if len(self._gid_gen):
            self._gen_floor = int(self._gid_gen.max()) + 1
        self._gid_of.clear()
        self._owners.clear()
        self._gid_refs = np.zeros(0, np.int64)
        self._gid_live = np.zeros(0, bool)
        self._gid_gen = np.zeros(0, np.int64)
        self._free_gids.clear()

    def lane_for(self, slot: int, owner: bytes) -> int | None:
        """Resolve (or first-come assign) one owner's voter lane on a slot.
        Returns None when all V lanes are taken by *other* owners — the
        protocol bounds distinct voters by expected_voters_count ≤ V in P2P
        mode; Gossipsub mode accepts arbitrarily many distinct voters, so
        size ``voter_capacity`` accordingly."""
        idx = self.voter_gid(owner) & 0xFFFFFFFF  # lane tables store indices
        row = self._lane_gids[slot]
        hits = np.nonzero(row == idx)[0]
        if hits.size:
            return int(hits[0])
        count = int(self._lane_count[slot])
        if count >= self.voter_capacity:
            return None
        row[count] = idx
        self._lane_count[slot] = count + 1
        self._gid_refs[idx] += 1
        return count

    def lanes_for_batch(
        self, slots: np.ndarray, gids: np.ndarray, assume_live: bool = False
    ) -> np.ndarray:
        """Vectorized lane_for over a flat arrival-ordered batch.

        Existing assignments resolve by a dense [B, V] match; unseen
        (slot, gid) pairs are assigned fresh lanes in first-occurrence
        order. Returns int32 lanes with -1 marking voter-capacity
        exhaustion. Cost is O(B·V) int32 host work — the per-vote Python
        dictionary hop this replaces is ~50x slower per vote.

        ``assume_live=True`` skips the liveness/generation gate for callers
        that already filtered the batch through :meth:`gids_live` (the
        engine's columnar path — avoids a duplicate O(B) pass).
        """
        slots = np.asarray(slots, np.int64)
        gids_i64 = np.asarray(gids, np.int64)
        idx64 = gids_i64 & 0xFFFFFFFF
        gids32 = idx64.astype(np.int32)
        lanes = np.full(len(slots), -1, np.int32)
        if len(slots) == 0:
            return lanes
        # In-range ids are real registry indices: require live + current
        # generation, else refuse the lane (-1). A freed or stale-generation
        # gid must never claim a lane — it would be stored in _lane_gids and
        # then wrongly decrement the recycled index's refcount on slot
        # release, evicting a live voter. Out-of-range ids are synthetic
        # (direct pool callers) and pass through unrefcounted as before.
        if not assume_live:
            in_range = (gids_i64 >= 0) & (idx64 < len(self._owners))
            if in_range.any():
                ir = np.nonzero(in_range)[0]
                sel = idx64[ir]
                bad = ~(
                    self._gid_live[sel]
                    & (self._gid_gen[sel] == (gids_i64[ir] >> 32))
                )
                if bad.any():
                    keep = np.ones(len(slots), bool)
                    keep[ir[bad]] = False
                    ok_rows = np.nonzero(keep)[0]
                    lanes[ok_rows] = self.lanes_for_batch(
                        slots[ok_rows], gids_i64[ok_rows], assume_live=True
                    )
                    return lanes
        # The dense [B, V] match is only needed for votes whose slot already
        # has assignments — on fresh slots (the common streaming case) the
        # whole batch short-circuits to first-occurrence assignment.
        may_exist = self._lane_count[slots] > 0
        if may_exist.any():
            cand = np.nonzero(may_exist)[0]
            match = self._lane_gids[slots[cand]] == gids32[cand, None]
            has_c = match.any(axis=1)
            lanes[cand[has_c]] = np.argmax(match[has_c], axis=1)
        has = lanes >= 0

        rem = np.nonzero(~has)[0]
        if rem.size == 0:
            return lanes
        # One key per unseen (slot, gid); np.unique gives the first flat
        # occurrence of each, and within-slot arrival rank = lane offset.
        # Mask the gid to its unsigned 32-bit pattern: without it a gid
        # >= 2^31 sign-extends and corrupts the slot bits of the key.
        keys = (slots[rem] << 32) | (gids32[rem].astype(np.int64) & 0xFFFFFFFF)
        uniq_keys, first_pos, inverse = np.unique(
            keys, return_index=True, return_inverse=True
        )
        uslot = (uniq_keys >> 32).astype(np.int64)
        ugid = (uniq_keys & 0xFFFFFFFF).astype(np.int32)
        order = np.lexsort((first_pos, uslot))  # by slot, then arrival
        s_sorted = uslot[order]
        is_start = np.empty(len(s_sorted), bool)
        is_start[0] = True
        np.not_equal(s_sorted[1:], s_sorted[:-1], out=is_start[1:])
        grp_starts = np.nonzero(is_start)[0]
        within = np.arange(len(s_sorted)) - grp_starts[np.cumsum(is_start) - 1]
        lane_uniq = np.empty(len(uniq_keys), np.int64)
        lane_uniq[order] = self._lane_count[s_sorted] + within
        valid = lane_uniq < self.voter_capacity
        self._lane_gids[uslot[valid], lane_uniq[valid]] = ugid[valid]
        self._lane_count += np.bincount(
            uslot[valid], minlength=self.capacity
        ).astype(np.int32)
        assigned = ugid[valid].astype(np.int64)
        if assigned.size:
            # In-range ids reaching here are live current-generation indices
            # (stale and freed ids were refused above), so every stored
            # in-range reference is counted and _retire_lanes' decrement is
            # exact; synthetic out-of-range ids pass through unrefcounted
            # (and are never evicted).
            sel = assigned[(assigned >= 0) & (assigned < len(self._owners))]
            np.add.at(self._gid_refs, sel, 1)
        lanes[rem] = np.where(valid, lane_uniq, -1)[inverse].astype(np.int32)
        return lanes

    def fresh_lanes_grouped(
        self,
        s_sorted: np.ndarray,
        gid_idx_sorted: np.ndarray,
        col_sorted: np.ndarray,
        uniq: np.ndarray,
        counts: np.ndarray,
    ) -> np.ndarray | None:
        """Fast-path lane assignment for a slot-grouped batch (sorted by
        slot, arrival order within slot) targeting ALL-FRESH slots with no
        repeated (slot, voter) pair in the batch: each item's lane is then
        simply its within-slot arrival index (``col_sorted``). Returns
        int32 lanes in sorted-domain order (-1 = capacity exhausted), or
        None when the preconditions don't hold and the caller must fall
        back to :meth:`lanes_for_batch`. One nearly-sorted dup-check sort
        replaces lanes_for_batch's unique+lexsort passes — the difference
        is ~4x host time on the multi-million-row columnar batches.

        ``gid_idx_sorted`` are registry *indices* (generation tag already
        stripped) the caller has validated live via :meth:`gids_live`.
        """
        if len(s_sorted) == 0:
            return np.empty(0, np.int32)
        if self._lane_count[uniq].any():
            return None
        keys = (s_sorted << 32) | gid_idx_sorted
        # Plain introsort: numpy's "stable" on int64 is radix sort, which
        # measures ~4x SLOWER here and cannot exploit the slot-major runs.
        ks = np.sort(keys)
        if (ks[1:] == ks[:-1]).any():
            return None  # same voter twice on one slot: general path resolves
        ok = col_sorted < self.voter_capacity
        lanes = np.where(ok, col_sorted, -1).astype(np.int32)
        sl = s_sorted[ok] if not ok.all() else s_sorted
        gi = gid_idx_sorted[ok] if not ok.all() else gid_idx_sorted
        co = col_sorted[ok] if not ok.all() else col_sorted
        self._lane_gids[sl, co] = gi.astype(np.int32)
        self._lane_count[uniq] = np.minimum(
            counts, self.voter_capacity
        ).astype(np.int32)
        # bincount + add is one O(B) pass; np.add.at's unbuffered scatter
        # is ~10x slower per element on multi-million-row batches. (An
        # out-of-range index still fails loudly: the longer bincount
        # result refuses to broadcast.)
        self._gid_refs += np.bincount(gi, minlength=len(self._gid_refs))
        return lanes

    def state_of(self, slot: int) -> int:
        """Host-mirrored lifecycle state (no device traffic)."""
        return int(self._state_host[slot])

    def states_of(self, slots) -> np.ndarray:
        """Vectorized :meth:`state_of` (host mirror gather, no device
        traffic) — the bulk demotion/sweep paths read one array instead
        of N accessor calls."""
        return self._state_host[np.asarray(slots, np.int64)]

    def state_counts(self) -> dict[int, int]:
        """Histogram of slot states from the host mirror (stats path,
        reference: src/service_stats.rs:32-59)."""
        values, counts = np.unique(self._state_host, return_counts=True)
        return {int(v): int(c) for v, c in zip(values, counts)}

    # ── Deferred slot writes ───────────────────────────────────────────

    @contextmanager
    def deferred_writes(self, on_flush: "Callable[[int, bool], None] | None" = None):
        """Hold back the device writes of :meth:`release` and
        :meth:`allocate_batch` until the scope ends, then make them as one
        activate and one release dispatch. The host bookkeeping (free list,
        mirrors, lanes, metadata) still changes at once, so every slot gets
        the number immediate writes give it. Every other device operation of
        the pool flushes first, so nothing reads or overwrites a stale row.

        Exact because an activation writes all ten tensors of its row and a
        release writes only the row's state: per slot, its last activation
        followed by a release if one came after it leaves the row that the
        writes made one by one leave. ``on_flush(slots, forced)`` hears of
        every flush that writes: the slots written, and whether another
        operation forced it inside the scope.

        The scope belongs to the thread that opened it, which holds the
        engine's lock as every writer of the pool does. A reader on another
        thread (the fleet's tally, which takes no lock) neither flushes nor
        touches the held writes: it reads the rows as the last flush left
        them, the state after an earlier item of the loop, as a read between
        two items did before. A scope opened inside another raises."""
        if self._deferred is not None:
            raise RuntimeError("deferred_writes is already open on this pool")
        self._deferred, self._on_flush = {}, on_flush
        self._deferring_thread = threading.get_ident()
        try:
            yield
        finally:
            try:
                self._flush_writes(forced=False)
            finally:
                self._deferred = self._deferring_thread = self._on_flush = None

    def _deferring(self) -> bool:
        """Whether this thread's slot writes are held back: a scope is open
        and this thread opened it."""
        return (
            self._deferred is not None
            and self._deferring_thread == threading.get_ident()
        )

    def _flush_writes(self, forced: bool = True) -> None:
        """Dispatch the writes a deferral scope holds: the activations
        first, then the releases that followed them (a no-op with nothing
        held, and on any thread but the scope's)."""
        if not self._deferring() or not self._deferred:
            return
        pending, self._deferred = self._deferred, {}
        active = [(slot, fields) for slot, (fields, _) in pending.items() if fields]
        if active:
            n, req, cap, gossip, liveness = (
                np.asarray(column) for column in zip(*(f for _, f in active))
            )
            self._dispatch_activate(
                np.asarray([slot for slot, _ in active], np.int32),
                n.astype(np.int32),
                req.astype(np.int32),
                cap.astype(np.int32),
                gossip.astype(bool),
                liveness.astype(bool),
            )
        released = [slot for slot, (_, rel) in pending.items() if rel]
        if released:
            self._dispatch_release(np.asarray(released, np.int32))
        if self._on_flush is not None:
            self._on_flush(len(pending), forced)

    # ── Allocation ─────────────────────────────────────────────────────

    def allocate_batch(
        self,
        keys: list[Hashable],
        n: np.ndarray,
        req: np.ndarray,
        cap: np.ndarray,
        gossip: np.ndarray,
        liveness: np.ndarray,
        expiry: np.ndarray,
        created_at: np.ndarray,
    ) -> list[int]:
        """Claim one slot per key and initialise its on-device config.

        ``req``/``cap`` are host-precomputed (exact integer threshold math,
        reference: src/utils.rs:307-313 — see ops.decide.required_votes_np).
        Raises PoolFullError (allocating nothing) if fewer than len(keys)
        slots are free.
        """
        count = len(keys)
        if count == 0:
            return []
        self._check_no_inflight("allocate_batch")
        n = np.asarray(n, np.int32)
        if int(n.max()) > self.voter_capacity:
            raise ValueError(
                f"expected_voters_count {int(n.max())} exceeds pool "
                f"voter_capacity {self.voter_capacity}"
            )
        if count > len(self._free):
            raise PoolFullError(
                f"need {count} slots, {len(self._free)} free of {self.capacity}"
            )
        # Claim the tail of the free list in one slice (same slots, same
        # order as count pop() calls would yield).
        slots = self._free[-count:][::-1]
        del self._free[-count:]
        slots_arr = np.asarray(slots, np.int32)
        if self._deferring():
            pending = self._deferred
            for slot, fields in zip(slots, zip(
                n.tolist(), np.asarray(req).tolist(), np.asarray(cap).tolist(),
                np.asarray(gossip).tolist(), np.asarray(liveness).tolist(),
            )):
                pending[slot] = [fields, False]
        else:
            self._dispatch_activate(
                slots_arr,
                n,
                np.asarray(req, np.int32),
                np.asarray(cap, np.int32),
                np.asarray(gossip, bool),
                np.asarray(liveness, bool),
            )

        expiry = np.asarray(expiry, np.int64)
        created_at = np.asarray(created_at, np.int64)
        # Lane rows need no clearing here: free slots always have cleared
        # rows (initialised at construction, retired on release).
        self._state_host[slots_arr] = STATE_ACTIVE
        self._expiry_host[slots_arr] = expiry
        meta = self._meta
        for slot, key, exp, cre in zip(
            slots, keys, expiry.tolist(), created_at.tolist()
        ):
            meta[slot] = SlotMeta(key=key, expiry=exp, created_at=cre)
        return slots

    def load_rows(
        self,
        slots: list[int],
        state: np.ndarray,
        yes: np.ndarray,
        tot: np.ndarray,
        mask_rows: np.ndarray,
        val_rows: np.ndarray,
    ) -> None:
        """Overwrite tallies of already-allocated slots (snapshot restore)."""
        if not slots:
            return
        self._check_no_inflight("load_rows")
        self._flush_writes()
        self._dispatch_load(
            np.asarray(slots, np.int32),
            np.asarray(state, np.int32),
            np.asarray(yes, np.int32),
            np.asarray(tot, np.int32),
            np.asarray(mask_rows, bool),
            np.asarray(val_rows, bool),
        )
        self._state_host[np.asarray(slots)] = np.asarray(state, np.int32)

    def release(self, slots: list[int]) -> None:
        """Return slots to the free list (eviction / delete_scope). Tallies
        are lazily cleared on the next allocation of the slot; lane tables
        are retired now so fully-released voter identities leave the
        registry (the id is recycled by a later intern)."""
        if not slots:
            return
        self._check_no_inflight("release")
        if self._deferring():
            for slot in slots:
                entry = self._deferred.get(slot)
                if entry is None:
                    self._deferred[slot] = [None, True]
                else:
                    entry[1] = True
        else:
            self._dispatch_release(np.asarray(slots, np.int32))
        self._retire_lanes(np.asarray(slots, np.int64))
        for slot in slots:
            self._state_host[slot] = STATE_FREE
            self._expiry_host[slot] = 0
            del self._meta[slot]
            self._free.append(slot)

    def _retire_lanes(self, slot_arr: np.ndarray) -> None:
        """Drop the released slots' lane references; evict gids that no live
        slot references anymore."""
        if len(slot_arr) > 1:  # registration retires one slot at a time
            slot_arr = np.unique(slot_arr)  # a duplicated slot must not double-deref
        rows = self._lane_gids[slot_arr]
        referenced = rows[rows >= 0].astype(np.int64)
        self._lane_gids[slot_arr] = -1
        self._lane_count[slot_arr] = 0
        if referenced.size == 0:
            return
        referenced = referenced[referenced < len(self._owners)]
        if referenced.size == 0:
            return
        # Unbuffered: a gid referenced by several slots loses one a slot.
        np.subtract.at(self._gid_refs, referenced, 1)
        # _gid_live gates eviction so synthetic (never-interned) ids and
        # already-freed ids are skipped; the dead, rare, go in gid order.
        dead = referenced[(self._gid_refs[referenced] <= 0) & self._gid_live[referenced]]
        for gid in np.unique(dead).tolist() if dead.size else ():
            del self._gid_of[self._owners[gid]]
            self._owners[gid] = b""
            self._gid_live[gid] = False
            # Bump the generation so every gid minted for this index before
            # the eviction is permanently distinguishable from the next
            # claimant's gid (stale use → typed rejection, never
            # misattribution).
            self._gid_gen[gid] += 1
            self._free_gids.append(gid)

    # ── Hot paths ──────────────────────────────────────────────────────

    def ingest(
        self,
        slots: np.ndarray,
        lanes: np.ndarray,
        values: np.ndarray,
        now: int,
    ) -> tuple[np.ndarray, list[tuple[int, int]]]:
        """Apply a flat, arrival-ordered vote batch (synchronous).

        Args:
          slots: int64[B] target slot per vote.
          lanes: int32[B] voter lane per vote (from SlotMeta.lane_for).
          values: bool[B] the yes/no choices.
          now: caller clock, for the per-slot expiry check
            (reference: src/session.rs:226).

        Returns:
          (statuses int32[B] in batch order, transitions) where transitions
          lists (slot, new_state) for every slot whose lifecycle state
          changed — the engine turns these into ConsensusReached events.
        """
        pending = self.ingest_async(slots, lanes, values, now)
        if pending is None:
            return np.empty(0, np.int32), []
        return self.complete(pending)

    def ingest_async(
        self,
        slots: np.ndarray,
        lanes: np.ndarray,
        values: np.ndarray,
        now: int,
    ) -> PendingIngest | None:
        """Dispatch a vote batch without waiting for results.

        The pool tensors advance immediately (updated in place on the device), so
        subsequent dispatches chain correctly; statuses/transitions become
        visible when :meth:`complete` is called. Streaming callers keep
        several batches in flight to hide host↔device latency (the pipeline
        axis from SURVEY §2.3).
        """
        slots = np.asarray(slots, np.int64)
        if slots.size == 0:
            return None
        uniq, row, col, depth = group_batch(slots)
        return self.ingest_async_grouped(
            uniq, row, col, depth, lanes, values, now
        )

    # True where ingest_async_grouped(fresh=True) routes to the closed-form
    # ingest.
    supports_fresh_ingest = True

    def fresh_grid_within_budget(self, s_count: int, depth: int) -> bool:
        """Absolute cell budget for the [S, depth]-padded fresh grid —
        padding blows up when one huge chain sits amid many shallow slots,
        at which point the segmented scan wins. Multi-host callers check
        this against the FLEET-agreed max shapes (the dispatch pads every
        process to those)."""
        return _bucket(s_count) * _bucket(depth, floor=1) <= 33_554_432

    def fresh_ingest_viable(
        self, uniq: np.ndarray, depth: int, n_items: int
    ) -> bool:
        """Whether a slot-grouped batch may take the closed-form (scan-free)
        ingest dispatch. Owns the invariants next to the kernel they guard:
        the pool supports it, every touched slot is still ACTIVE on the
        host state mirror (rare non-ACTIVE fresh slots: empty sessions
        decided by timeout), and the padded grid stays within the cell
        budget (with a relative padding-factor guard on top). The caller
        must separately establish freshness + no duplicate voters
        (fresh_lanes_grouped does both)."""
        if not self.supports_fresh_ingest:
            return False
        return self.grid_within_budget(len(uniq), depth, n_items) and bool(
            (self._state_host[uniq] == STATE_ACTIVE).all()
        )

    def grid_within_budget(self, s_count: int, depth: int, n_items: int) -> bool:
        """Whether the padded [s_count, depth] grid of ``n_items`` votes may
        go in one dispatch: the absolute cell budget, and at most 8 padded
        cells a vote (or 65,536 cells) so that one hot row far deeper than
        the rest does not pad every other row to its depth."""
        cells = _bucket(s_count) * _bucket(depth, floor=1)
        return cells <= max(8 * n_items, 65_536) and self.fresh_grid_within_budget(
            s_count, depth
        )

    def ingest_async_grouped(
        self,
        uniq: np.ndarray,
        row: np.ndarray,
        col: np.ndarray,
        depth: int,
        lanes: np.ndarray,
        values: np.ndarray,
        now: int,
        fresh: bool = False,
    ) -> PendingIngest:
        """Pre-grouped :meth:`ingest_async`: the caller already grouped the
        batch by slot (``uniq[S]`` touched slots, per-item grid coordinates
        ``row``/``col``, ``depth`` = max votes per slot). The engine's
        columnar path computes the grouping once for a whole multi-dispatch
        batch and slices it per segment — skipping one O(B log B) sort per
        dispatch that :func:`group_batch` would redo.

        ``fresh=True`` dispatches the closed-form kernel (no sequential
        scan) — ONLY valid when every touched slot is freshly ACTIVE with
        zero tallies and the batch has no repeated (slot, voter) pair; the
        engine's fast path establishes exactly that. On >64-lane pools the
        fresh grid additionally requires (and checks) that every lane is
        the within-slot arrival index — the fresh assignment rule — so the
        lane plane need not cross the link at all (laneless uint8 cells,
        half the uint16 upload)."""
        s_count = len(uniq)
        depth = max(int(depth), 1)
        laneless = fresh and self.voter_capacity > 64
        if laneless and len(row):
            if not np.array_equal(lanes, col):
                raise ValueError(
                    "fresh ingest on a >64-lane pool requires lanes == "
                    "within-slot arrival index (the fresh assignment rule)"
                )
            grid = np.zeros((s_count, depth), np.uint8)
            grid[row, col] = np.asarray(values, np.uint8) | 2  # value|valid
        elif laneless:
            grid = np.zeros((s_count, depth), np.uint8)
        else:
            voter_grid = np.zeros((s_count, depth), np.int32)
            valbit = np.zeros((s_count, depth), np.int32)
            if len(row):
                voter_grid[row, col] = np.asarray(lanes, np.int32)
                valbit[row, col] = np.asarray(values, np.int32) | 2
            # Narrow grid cells to the pool's lane range (uint8/uint16) —
            # the grid is the dominant upload of every dispatch; the CUDA
            # scan takes all three layouts.
            grid = pack_grid(
                voter_grid,
                valbit & 1,
                valbit >> 1,
                voter_capacity=self.voter_capacity,
            )

        expired = self._expiry_host[uniq] <= now
        slot_pack2 = pack_slots(uniq.astype(np.int32), expired)
        self._flush_writes()
        if fresh:
            out, row_select = self._dispatch_ingest_fresh(
                slot_pack2, grid, laneless=laneless
            )
        else:
            out, row_select = self._dispatch_ingest(slot_pack2, grid)
        pending = PendingIngest(
            out=out, uniq=uniq, row=row, col=col, row_select=row_select
        )
        self._inflight.append(pending)
        return pending

    def complete_all(
        self, pendings: list[PendingIngest]
    ) -> list[tuple[np.ndarray, list[tuple[int, int]]]]:
        """Block on many in-flight ingests with one device-to-host copy per
        output shape: same-shape outputs are stacked on the device first.
        Must be called in dispatch order (enforced)."""
        groups: dict[tuple, list[int]] = {}
        for i, pending in enumerate(pendings):
            groups.setdefault(tuple(pending.out.shape), []).append(i)
        host: list = [None] * len(pendings)
        for idxs in groups.values():
            if len(idxs) == 1:
                host[idxs[0]] = pendings[idxs[0]].out.cpu().numpy()
                continue
            stacked = torch.stack([pendings[i].out for i in idxs]).cpu().numpy()
            for k, i in enumerate(idxs):
                host[i] = stacked[k]
        return [
            self._finish(pending, out) for pending, out in zip(pendings, host)
        ]

    def complete(
        self, pending: PendingIngest
    ) -> tuple[np.ndarray, list[tuple[int, int]]]:
        """Block on an in-flight ingest; return (statuses[B], transitions)."""
        return self._finish(pending, pending.out.cpu().numpy())

    def _check_no_inflight(self, op: str) -> None:
        if self._inflight:
            raise RuntimeError(
                f"{op} while {len(self._inflight)} ingest dispatch(es) are "
                "in flight: complete() them first (the host state mirror "
                "must apply updates in dispatch order)"
            )

    def _finish(
        self, pending: PendingIngest, host_out: np.ndarray
    ) -> tuple[np.ndarray, list[tuple[int, int]]]:
        if not self._inflight or self._inflight[0] is not pending:
            raise RuntimeError(
                "ingest completions must happen in dispatch order"
            )
        self._inflight.pop(0)
        arr = host_out[pending.row_select]
        statuses = arr[:, :-1]
        row_state = arr[:, -1]
        prev = self._state_host[pending.uniq]
        changed = prev != row_state
        self._state_host[pending.uniq] = row_state
        transitions = list(
            zip(
                pending.uniq[changed].tolist(),
                row_state[changed].tolist(),
            )
        )
        return statuses[pending.row, pending.col], transitions

    def timeout(self, slots: list[int]) -> list[tuple[int, int]]:
        """Fire the timeout decision for the given slots.

        Returns (slot, new_state) for each *requested* slot after the sweep
        (including unchanged already-decided ones, so the caller can
        implement the reference's idempotent timeout return,
        src/service.rs:331-334).
        """
        if not slots:
            return []
        self._check_no_inflight("timeout")
        self._flush_writes()
        row_state = self._dispatch_timeout(np.asarray(slots, np.int32))
        out: list[tuple[int, int]] = []
        for i, slot in enumerate(slots):
            new_state = int(row_state[i])
            self._state_host[slot] = new_state
            out.append((int(slot), new_state))
        return out

    # ── Cold query path ────────────────────────────────────────────────

    def read_slots(self, slots) -> dict[str, np.ndarray]:
        self._flush_writes()
        return super().read_slots(slots)

    def read_slot(self, slot: int) -> dict[str, np.ndarray]:
        """Gather one slot's full row back to host (debug / session export);
        an out-of-range slot clips to the last row, as the JAX pool's does."""
        rows = self.read_slots([slot])
        return {key: value[0] for key, value in rows.items()}
