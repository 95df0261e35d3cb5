"""Multi-host pool: the slot axis split across the devices of many
processes, with process-local data feeding.

Port of ``hashgraph_tpu/parallel/multihost.py`` to PyTorch. Execution
model (the JAX package's, unchanged):

- **Slot ownership follows device ownership.** The global pool's slot
  axis splits over the full mesh; each process owns the contiguous slot
  ranges of its own devices (`local_slot_range`), and holds only their
  blocks.
- **Control plane is replicated.** Allocation, release, snapshot loads
  and timeout sweeps must be invoked with identical arguments on every
  process. Host bookkeeping stays consistent because these ops are
  deterministic.
- **Data plane is process-local.** Each process ingests only votes for its
  own slots (the embedder's shard-aware relay forwards votes to the owning
  host — consensus state never crosses processes). Every ingest dispatch
  is collective in cadence: one small all-gather of the batch shape, which
  every process joins, empty batches included.
- **Events are emitted by the owning process only**, so a fleet of engine
  front-ends never double-publishes.

The control plane runs on a ``torch.distributed`` process group over
**gloo**, on every device type. Its collectives carry a few host int64s
(batch shapes, the fresh-or-scan plan, the dispatch count, the state
mirror, the trace context, the stats); device tallies never cross
processes. NCCL is not used: it would add a device round trip for a few
integers, and it cannot put two ranks on one GPU. The choice is fixed,
never taken at run time.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..engine.pool import SlotTensors, _bucket
from .mesh import consensus_mesh
from .sharded import _STATE_CODES, ShardedPool

__all__ = [
    "initialize_distributed",
    "distributed_consensus_mesh",
    "local_slot_range",
    "agree_trace_context",
    "collectives_available",
    "is_collectives_gap",
    "COLLECTIVES_GAP_SIGNATURE",
    "MultiHostPool",
    "ProcessMesh",
    "process_allgather",
    "process_count",
    "process_index",
]


# The JAX package's backend-gap signature (jaxlib CPU backends without
# multi-process collectives), kept so the federation's tally path can
# match on it. Gloo implements every collective used here, so the port's
# probe never meets it.
COLLECTIVES_GAP_SIGNATURE = (
    "Multiprocess computations aren't implemented on the CPU backend"
)


def is_collectives_gap(exc: "BaseException | str") -> bool:
    """Whether an exception (or its message) is the known CPU-backend
    multi-process collectives gap — the one condition under which the
    fleet demotes cross-host tallies from collectives to fabric frames."""
    return COLLECTIVES_GAP_SIGNATURE in str(exc)


def process_count() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_allgather(arr: np.ndarray) -> np.ndarray:
    """Every process's ``arr`` stacked in rank order (``[processes, ...]``);
    the arrays must have one shape and dtype on every process. Collective:
    all processes call it at the same point."""
    local = np.ascontiguousarray(arr)
    if process_count() == 1:
        return local[None].copy()
    tensor = torch.from_numpy(local.copy())
    out = [torch.empty_like(tensor) for _ in range(process_count())]
    dist.all_gather(out, tensor)
    return np.stack([t.numpy() for t in out])


_collectives_probe: "bool | None" = None


def collectives_available(refresh: bool = False) -> bool:
    """Runtime capability probe: can this process run cross-process
    collectives?

    Single process: trivially True — every collective is an in-process
    reduction. Several processes: run ONE tiny all-gather over the group;
    any failure re-raises (a real fault must not silently demote the
    tally path). Memoized; ``refresh=True`` probes again."""
    global _collectives_probe
    if _collectives_probe is not None and not refresh:
        return _collectives_probe
    if process_count() > 1:
        process_allgather(np.ones(1, np.int32))
    _collectives_probe = True
    return True


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up the gloo process group of a multi-host deployment.

    ``coordinator_address`` (``host:port``, reachable from every process)
    is rank 0's rendezvous; with it, pass ``num_processes`` and
    ``process_id`` too. Without it the arguments come from torch's
    standard environment variables (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). Call once per process, before building a
    :class:`MultiHostPool`.
    """
    dist.init_process_group(
        "gloo",
        init_method=(
            f"tcp://{coordinator_address}" if coordinator_address is not None else "env://"
        ),
        world_size=num_processes if num_processes is not None else -1,
        rank=process_id if process_id is not None else -1,
    )


class ProcessMesh(list):
    """A mesh across processes: its devices in slot-block order, and
    ``processes[k]``, the rank that holds entry ``k``."""

    def __init__(self, devices, processes):
        super().__init__(devices)
        if len(processes) != len(self):
            raise ValueError("one process index per mesh entry")
        self.processes = list(processes)


_DEVICE_TYPES = ("cpu", "cuda")


def distributed_consensus_mesh(n_devices: int | None = None, device="cuda") -> ProcessMesh:
    """The 1-D consensus mesh spanning every device of every process: each
    rank's :func:`~.mesh.consensus_mesh` (``n_devices``, ``device``),
    gathered in rank order. Collective."""
    local = consensus_mesh(n_devices, device)
    counts = process_allgather(np.array([len(local)], np.int64)).reshape(-1)
    width = int(counts.max())
    codes = np.full((width, 2), -1, np.int64)
    for k, dev in enumerate(local):
        codes[k] = (_DEVICE_TYPES.index(dev.type), -1 if dev.index is None else dev.index)
    gathered = process_allgather(codes)
    devices, processes = [], []
    for rank, (count, rows) in enumerate(zip(counts.tolist(), gathered)):
        if rank == process_index():
            devices.extend(local)
        else:
            devices.extend(
                torch.device(_DEVICE_TYPES[t], None if i < 0 else i)
                for t, i in rows[:count].tolist()
            )
        processes.extend([rank] * count)
    return ProcessMesh(devices, processes)


def agree_trace_context(ctx=None):
    """Fleet-wide distributed-trace agreement: every process adopts
    process 0's trace context so the replicated control plane's spans
    (allocation, timeout sweeps) stitch into ONE causal trace instead of
    N disjoint ones.

    Collective — call with identical cadence on every process (like the
    pool's control-plane ops), typically right after minting a root
    context on process 0::

        ctx = agree_trace_context(TraceContext.generate())
        with use_context(ctx):
            engine.sweep_timeouts(now)   # spans share one trace_id fleet-wide

    ``ctx`` defaults to this process's ambient context
    (:func:`~hashgraph_tpu_torch.obs.trace.current_context`); processes
    other than 0 may pass anything (or nothing) — process 0's value wins.
    Returns the agreed context, or None when process 0 had none.
    """
    from ..obs.trace import TRACE_WIRE_BYTES, TraceContext, current_context

    local = ctx if ctx is not None else current_context()
    wire = np.frombuffer(
        local.to_wire() if local is not None else bytes(TRACE_WIRE_BYTES),
        np.uint8,
    )
    gathered = process_allgather(wire).reshape(-1, TRACE_WIRE_BYTES)
    agreed = gathered[0].tobytes()
    if not any(agreed):
        return None
    return TraceContext.from_wire(agreed)


def local_slot_range(capacity_per_device: int, mesh=None) -> tuple[int, int]:
    """The global slot interval owned by this process: [start, stop).

    With slots laid out contiguously per device in mesh order, a process
    owns the union of its devices' ranges (contiguous when a process's
    entries are consecutive in the mesh, as :func:`distributed_consensus_mesh`
    lays them out).
    """
    mesh = mesh if mesh is not None else distributed_consensus_mesh()
    start, stop = _local_device_span(mesh)
    return (start * capacity_per_device, stop * capacity_per_device)


def _local_device_span(mesh) -> tuple[int, int]:
    """[start, stop) positions of this process's devices in mesh order. A
    plain device list (no ``processes``) is this process's own."""
    me = process_index()
    owners = getattr(mesh, "processes", None) or [me] * len(mesh)
    local = [i for i, p in enumerate(owners) if p == me]
    if not local:
        return (0, 0)
    start, stop = min(local), max(local) + 1
    if local != list(range(start, stop)):
        raise RuntimeError(
            "this process's devices are not contiguous in the mesh; "
            "reorder the mesh so slot ranges stay process-local"
        )
    return (start, stop)


class MultiHostPool(ShardedPool):
    """ShardedPool across the devices of the processes of a gloo group.

    Contract (module docstring has the full model):
    - control-plane calls (``allocate_batch``, ``release``, ``load_rows``,
      ``timeout``) are collective with IDENTICAL arguments on every process;
    - ``ingest_async``/``complete_all`` are collective in *cadence* (every
      process dispatches the same number of batches, empty ones included)
      but each process passes only votes for its own slots
      (``local_slots``); statuses/transitions come back for local
      votes/slots only, so each process emits events for what it owns;
    - each dispatch's batch shape is agreed via one small all-gather.
    """

    def __init__(self, capacity_per_device, voter_capacity, mesh=None):
        mesh = mesh if mesh is not None else distributed_consensus_mesh()
        # Span first: _init_device_arrays (called from the base ctor) needs
        # it to materialize this process's blocks only.
        self._dev_lo, self._dev_hi = _local_device_span(mesh)
        self.process_index = process_index()
        super().__init__(capacity_per_device, voter_capacity, mesh)

    def local_slots(self) -> tuple[int, int]:
        """The global slot interval [start, stop) this process owns."""
        return (
            self._dev_lo * self.local_capacity,
            self._dev_hi * self.local_capacity,
        )

    def _init_device_arrays(self) -> None:
        """This process's blocks only: other processes hold theirs."""
        self._blocks = [
            SlotTensors(self.local_capacity, self.voter_capacity, device)
            if self._dev_lo <= d < self._dev_hi
            else None
            for d, device in enumerate(self.mesh)
        ]

    # ── Data plane ─────────────────────────────────────────────────────

    def ingest_async(self, slots, lanes, values, now):
        """Collective dispatch; ``slots`` must all be process-local. Unlike
        the single-host pools an EMPTY batch still dispatches (the other
        processes' batches join the same collective) — the inherited
        grouped path dispatches unconditionally, preserving that.
        """
        from ..ops.ingest import group_batch

        slots = np.asarray(slots, np.int64)
        lo, hi = self.local_slots()
        if slots.size and not ((slots >= lo) & (slots < hi)).all():
            raise ValueError(
                f"ingest batch contains non-local slots (this process owns "
                f"[{lo}, {hi})); route votes to the owning host first"
            )
        uniq, row, col, depth = group_batch(slots)
        return self.ingest_async_grouped(
            uniq, row, col, depth, lanes, values, now
        )

    def _dispatch_ingest(self, slot_pack, grid_pack):
        return self._fleet_routed_ingest(slot_pack, grid_pack, fresh=False)

    def _dispatch_ingest_fresh(self, slot_pack, grid_pack, laneless=False):
        """Fleet closed-form ingest: same shape agreement + routing as the
        scan dispatch (the caller — the engine — has already agreed
        fleet-wide that this call takes the fresh path; the laneless flag
        derives from voter_capacity, identical on every process)."""
        return self._fleet_routed_ingest(
            slot_pack, grid_pack, fresh=True, laneless=laneless
        )

    def _fleet_routed_ingest(self, slot_pack, grid_pack, fresh, laneless=False):
        """Agree the batch's bucketed shape across processes (the JAX
        package's per-dispatch collective: every process joins it, so the
        cadence is the same), then route with the agreed row bucket. The
        blocks carry their real rows only, so no grid is padded to the
        agreed depth."""
        s_count, depth = grid_pack.shape
        local_shape = np.array(
            [_bucket(s_count), _bucket(depth, floor=1)], np.int64
        )
        agreed = process_allgather(local_shape)
        return self._routed_ingest(
            slot_pack, grid_pack, fresh, laneless,
            bucket_s=int(agreed[..., 0].max()),
        )

    # ── Control plane ──────────────────────────────────────────────────

    def timeout(self, slots):
        """Collective (identical ``slots`` everywhere); returns only this
        process's slots — the owner emits the events. The host state mirror
        is synced for ALL requested slots (one small all-gather), so
        ``state_of``/``state_counts`` — and any engine layered on top — stay
        truthful for non-local slots after a sweep."""
        if not slots:
            return []
        self._check_no_inflight("timeout")
        self._flush_writes()
        slot_arr = np.asarray(slots, np.int64)
        lo, hi = self.local_slots()
        local = (slot_arr >= lo) & (slot_arr < hi)
        local_states = np.full(len(slots), -1, np.int64)
        if local.any():
            local_states[local] = self._dispatch_timeout(slot_arr[local])
        # Every slot is local to exactly one process; max over the gathered
        # per-process vectors (-1 where non-local) recovers each slot's
        # owner-observed state on every process.
        global_states = process_allgather(local_states).reshape(-1, len(slots)).max(axis=0)
        self._state_host[slot_arr] = global_states.astype(np.int32)
        return [
            (int(slot), int(local_states[i]))
            for i, slot in enumerate(slots)
            if local[i]
        ]

    def sync_states(self) -> None:
        """Refresh the host state mirror for non-local slots.

        Ingest transitions are observed owner-locally by design (no
        collective on the hot path), so remote slots' mirrored states lag
        until the next collective touch. This collective (identical cadence
        on every process; requires the same device count on every process)
        gathers each process's local mirror block so
        ``state_of``/``state_counts`` are globally exact at a quiesce/stats
        point."""
        self._check_no_inflight("sync_states")
        lo, hi = self.local_slots()
        gathered = process_allgather(
            np.concatenate(
                [np.array([lo], np.int64), self._state_host[lo:hi].astype(np.int64)]
            )
        ).reshape(process_count(), -1)
        for row in gathered:
            start = int(row[0])
            block = row[1:].astype(np.int32)
            self._state_host[start : start + len(block)] = block

    def global_state_counts(self) -> dict[int, int]:
        """Fleet-wide slot-state histogram: this process's blocks counted
        on their devices, then summed over the group (collective)."""
        counts = self.device_state_counts().cpu()
        if process_count() > 1:
            dist.all_reduce(counts)
        return {code: int(c) for code, c in zip(_STATE_CODES, counts.tolist())}
