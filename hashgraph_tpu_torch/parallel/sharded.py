"""Multi-device proposal pool: the slot axis split over a device mesh.

Port of ``hashgraph_tpu/parallel/sharded.py`` to PyTorch. Layout:

- the ten pool tensors are held as one block of ``local_capacity`` rows per
  mesh entry, on that entry's device; entry ``d`` owns the contiguous slot
  range ``[d·local_capacity, (d+1)·local_capacity)``;
- batched mutations are routed on the host (:meth:`ShardedPool._route`, the
  JAX package's routing verbatim): each block receives only its own slots'
  work, with block-local slot ids, and runs the *same single-device body*
  on it — ``ingest_scan`` (the CUDA kernel on a GPU block, its plain
  version on a CPU block), the closed-form fresh ingest, the timeout and
  the slot writes. No collective runs on the hot path;
- the only cross-block step is the sum behind
  :meth:`ShardedPool.global_state_counts` (the JAX pool's ``psum``);
- slot allocation round-robins across blocks, so load stays balanced.

The host bookkeeping — the state mirror, the voter registry, the lane
tables, the free list — is the base :class:`ProposalPool`'s, unchanged.

One difference from the JAX pool: the JAX pool runs every shard on every
dispatch (``shard_map``), padding idle shards with sentinel rows; here a
block with no rows in a dispatch is skipped (a pad-only shard changes no
state and no result), so ``ingest_scan`` launches once per block that has
rows. :attr:`ShardedPool.scan_dispatches` counts them per block.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._build import resolve_device
from ..engine.pool import ProposalPool, SlotTensors, _bucket
from ..ops.decide import (
    STATE_ACTIVE,
    STATE_FAILED,
    STATE_FREE,
    STATE_REACHED_NO,
    STATE_REACHED_YES,
)
from ..ops.ingest import pack_slots, unpack_slots
from .mesh import consensus_mesh

__all__ = ["ShardedPool"]

_STATE_CODES = (
    STATE_FREE,
    STATE_ACTIVE,
    STATE_FAILED,
    STATE_REACHED_NO,
    STATE_REACHED_YES,
)


@dataclass
class BlockOutputs:
    """The device outputs of one routed ingest dispatch: one int8
    ``[rows, width]`` tensor per block that had rows, in mesh order."""

    tensors: list
    width: int  # L+1: statuses, then the row's final state


class ShardedPool(ProposalPool):
    """ProposalPool with its slot axis split over a device mesh.

    ``capacity_per_device`` slots live in each of the mesh's D blocks
    (total capacity = D × capacity_per_device). ``mesh`` is a list of
    devices (default: :func:`.mesh.consensus_mesh`, every visible GPU,
    raising without one); an entry may repeat, so ``[cuda:0] * 4`` holds
    four blocks on one card. The public API — and all host bookkeeping
    inherited from ProposalPool — is unchanged; only the ``_dispatch_*``
    device hooks, ``read_slots`` and the completions are replaced.
    """

    def __init__(self, capacity_per_device: int, voter_capacity: int, mesh=None):
        self.mesh = consensus_mesh() if mesh is None else [resolve_device(d) for d in mesh]
        if not self.mesh:
            raise ValueError("ShardedPool needs a mesh of at least one device")
        self.n_devices = len(self.mesh)
        self.local_capacity = capacity_per_device
        # Arrival-ordered scan dispatches per block (each one launch of
        # ingest_scan on a GPU block).
        self.scan_dispatches = [0] * self.n_devices
        super().__init__(
            capacity_per_device * self.n_devices, voter_capacity, device=self.mesh[0]
        )
        # Round-robin free list across blocks: pops yield block 0, 1, ...,
        # D-1, then wrap — keeps per-block load balanced as slots fill.
        order = [
            d * self.local_capacity + k
            for k in range(self.local_capacity)
            for d in range(self.n_devices)
        ]
        self._free = order[::-1]

    def _init_device_arrays(self) -> None:
        self._blocks: list[SlotTensors | None] = [
            SlotTensors(self.local_capacity, self.voter_capacity, device)
            for device in self.mesh
        ]

    # ── Host-side routing ──────────────────────────────────────────────

    def _route(
        self,
        slots: np.ndarray,
        payloads: list[tuple[np.ndarray, object]],
        bucket: int | None = None,
    ) -> tuple[np.ndarray, list[np.ndarray], np.ndarray, int]:
        """Distribute per-slot work to the owning devices.

        Returns (slot_grid [D*B] of local ids with per-device sentinel,
        routed payload arrays [D*B, ...], flat positions [K] mapping input
        order -> routed row, bucket B). ``bucket`` overrides the local
        per-device row bucket (the multi-host pool passes the fleet-agreed
        value).
        """
        dev = slots // self.local_capacity
        local = (slots % self.local_capacity).astype(np.int32)
        counts = np.bincount(dev, minlength=self.n_devices)
        if bucket is None:
            bucket = _bucket(int(counts.max()) if len(slots) else 0)
        order = np.argsort(dev, kind="stable")
        within = np.empty(len(slots), np.int64)
        starts = np.cumsum(counts) - counts
        within[order] = np.arange(len(slots)) - starts[dev[order]]
        rows = dev * bucket + within  # [K] flat routed position

        slot_grid = np.full(self.n_devices * bucket, self.local_capacity, np.int32)
        slot_grid[rows] = local
        routed = []
        for payload, fill in payloads:
            shape = (self.n_devices * bucket,) + payload.shape[1:]
            out = np.full(shape, fill, payload.dtype)
            out[rows] = payload
            routed.append(out)
        return slot_grid, routed, rows, bucket

    def _parts(self, slots, payloads, bucket: int | None = None):
        """:meth:`_route` cut into the blocks that have rows: returns
        ``[(block, local ids, payload rows)]`` in mesh order (each block's
        real rows only, in input order: the pad rows are dropped) and the
        position of every input row in the blocks' outputs concatenated in
        that order."""
        slots = np.asarray(slots, np.int64)
        slot_grid, routed, rows, bucket = self._route(
            slots, [(p, 0) for p in payloads], bucket
        )
        counts = np.bincount(slots // self.local_capacity, minlength=self.n_devices)
        parts = []
        for d in np.nonzero(counts)[0].tolist():
            lo = d * bucket
            hi = lo + int(counts[d])
            parts.append((d, slot_grid[lo:hi], [r[lo:hi] for r in routed]))
        dev = rows // bucket
        select = rows - dev * bucket + (np.cumsum(counts) - counts)[dev]
        return parts, select

    def _block(self, d: int) -> SlotTensors:
        block = self._blocks[d]
        if block is None:
            lo = d * self.local_capacity
            raise ValueError(
                f"slots [{lo}, {lo + self.local_capacity}) live in another "
                "process; route their work to the owning host"
            )
        return block

    def _on_blocks(self, op: str, slots, *payloads) -> None:
        """Run one slot-write dispatch on every block the slots touch."""
        parts, _ = self._parts(slots, payloads)
        for d, local, rows in parts:
            block = self._blocks[d]
            if block is not None:  # a multi-host pool holds its own blocks only
                getattr(block, op)(local, *rows)

    # ── Dispatch overrides ─────────────────────────────────────────────

    def _dispatch_activate(self, slots, n, req, cap, gossip, liveness) -> None:
        self._on_blocks("_dispatch_activate", slots, n, req, cap, gossip, liveness)

    def _dispatch_load(self, slots, state, yes, tot, mask_rows, val_rows) -> None:
        self._on_blocks("_dispatch_load", slots, state, yes, tot, mask_rows, val_rows)

    def _dispatch_release(self, slots) -> None:
        self._on_blocks("_dispatch_release", slots)

    def _dispatch_ingest(self, slot_pack, grid_pack):
        """Route the packed batch to the owning blocks and launch the scan
        on each block that has rows; non-blocking. Returns
        (:class:`BlockOutputs`, row indexer recovering the S input rows)."""
        return self._routed_ingest(slot_pack, grid_pack, fresh=False)

    def _dispatch_ingest_fresh(self, slot_pack, grid_pack, laneless=False):
        """Routed closed-form ingest; same contract as :meth:`_dispatch_ingest`."""
        return self._routed_ingest(slot_pack, grid_pack, fresh=True, laneless=laneless)

    def _routed_ingest(
        self, slot_pack, grid_pack, fresh: bool, laneless: bool = False,
        bucket_s: int | None = None,
    ):
        """Shared routing body for the scan and closed-form dispatches: one
        place owns the block-local pack contract. Multi-host callers pass
        the fleet-agreed ``bucket_s``."""
        slots_g, expired = unpack_slots(slot_pack)
        local_pack = pack_slots(
            (slots_g % self.local_capacity).astype(np.int32), expired
        )
        parts, select = self._parts(slots_g, [local_pack, grid_pack], bucket=bucket_s)
        outs = []
        for d, _, (pack_d, grid_d) in parts:
            block = self._block(d)
            if fresh:
                out, _ = block._dispatch_ingest_fresh(pack_d, grid_d, laneless=laneless)
            else:
                out, _ = block._dispatch_ingest(pack_d, grid_d)
                self.scan_dispatches[d] += 1
            outs.append(out)
        return BlockOutputs(outs, grid_pack.shape[1] + 1), select

    def _dispatch_timeout(self, slots) -> np.ndarray:
        parts, select = self._parts(slots, [])
        states = [self._block(d)._dispatch_timeout(local) for d, local, _ in parts]
        if not states:
            return np.empty(0, np.int32)
        return np.concatenate(states)[select]

    # ── Completions ────────────────────────────────────────────────────

    def complete_all(
        self, pendings
    ) -> list[tuple[np.ndarray, list[tuple[int, int]]]]:
        """Block on many in-flight ingests with one device-to-host copy per
        device: every block output on a device is flattened into one
        buffer first. Must be called in dispatch order (enforced)."""
        by_device: dict = {}
        for pending in pendings:
            for t in pending.out.tensors:
                by_device.setdefault(t.device, []).append(t)
        host: dict[int, np.ndarray] = {}
        for tensors in by_device.values():
            flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
            pos = 0
            for t in tensors:
                host[id(t)] = flat[pos:pos + t.numel()].reshape(tuple(t.shape))
                pos += t.numel()
        results = []
        for pending in pendings:
            arrs = [host[id(t)] for t in pending.out.tensors]
            out = (
                np.concatenate(arrs)
                if arrs
                else np.zeros((0, pending.out.width), np.int8)
            )
            results.append(self._finish(pending, out))
        return results

    def complete(self, pending):
        return self.complete_all([pending])[0]

    # ── Cold query path ────────────────────────────────────────────────

    def read_slots(self, slots) -> dict[str, np.ndarray]:
        """Batched slot rows gathered block by block (arrays indexed [k]
        in ``slots`` order; out-of-range slots clip as the base pool's)."""
        self._flush_writes()
        slots = np.clip(np.asarray(slots, np.int64), 0, self.capacity - 1)
        parts, select = self._parts(slots, [])
        reads = [self._block(d).read_slots(local) for d, local, _ in parts]
        if not reads:
            v = self.voter_capacity
            return dict(
                state=np.zeros(0, np.int32), yes=np.zeros(0, np.int32),
                tot=np.zeros(0, np.int32), vote_mask=np.zeros((0, v), bool),
                vote_val=np.zeros((0, v), bool),
            )
        return {
            key: np.concatenate([r[key] for r in reads])[select] for key in reads[0]
        }

    # ── Global views ───────────────────────────────────────────────────

    def per_device_occupancy(self) -> list[int]:
        """Occupied (non-FREE) slots per mesh device, from the host state
        mirror — the per-device view the MULTICHIP artifact and the fleet
        bench's per-shard breakdown report. Device ``d`` owns the
        contiguous block ``[d·local_capacity, (d+1)·local_capacity)``."""
        blocks = self._state_host.reshape(self.n_devices, self.local_capacity)
        return (blocks != STATE_FREE).sum(axis=1).astype(int).tolist()

    def device_state_counts(self) -> torch.Tensor:
        """int64[5] slot-state histogram over this process's blocks, left on
        the device: each block counts on its device, and the vectors are
        summed on the first block's device. No host copy (the fleet tally
        reduces these vectors across shards before its one copy)."""
        self._flush_writes()
        total = None
        for block in self._blocks:
            if block is None:
                continue
            counts = torch.stack(
                [(block._state == code).sum() for code in _STATE_CODES]
            )
            total = counts if total is None else total + counts.to(total.device)
        return total

    def global_state_counts(self) -> dict[int, int]:
        """Device-side global histogram of slot states: each block counts
        on its device and the blocks are summed there, with one host copy
        (the JAX pool's psum)."""
        counts = self.device_state_counts().cpu().tolist()
        return {code: int(c) for code, c in zip(_STATE_CODES, counts)}
