"""hashgraph_tpu_torch.parallel — multi-device placement, part one.

The mesh (:mod:`.mesh`: a list of devices), the sharded pool
(:mod:`.sharded`: one block of pool tensors a mesh entry, the
single-device bodies run block by block) and the multi-host pool
(:mod:`.multihost`: the slot axis across the processes of a gloo
process group, with the engine's multi-host branches keyed on it), plus
the fleet's two shard-availability errors (:mod:`.fleet`), which the
bridge server answers as ``STATUS_SHARD_MIGRATING``.

The rest of the JAX package's ``parallel/`` — the fleet itself
(``ConsensusFleet``, ``FleetShard``, ``ScopePlacement``), ``rollup`` and
``federation`` — is not ported yet.
"""

from .fleet import ShardMigratingError, ShardRecoveringError
from .mesh import PROPOSAL_AXIS, consensus_mesh
from .multihost import (
    COLLECTIVES_GAP_SIGNATURE,
    MultiHostPool,
    agree_trace_context,
    collectives_available,
    distributed_consensus_mesh,
    initialize_distributed,
    is_collectives_gap,
    local_slot_range,
)
from .sharded import ShardedPool

__all__ = [
    "consensus_mesh",
    "ShardedPool",
    "MultiHostPool",
    "PROPOSAL_AXIS",
    "agree_trace_context",
    "initialize_distributed",
    "distributed_consensus_mesh",
    "local_slot_range",
    "collectives_available",
    "is_collectives_gap",
    "COLLECTIVES_GAP_SIGNATURE",
    "ShardMigratingError",
    "ShardRecoveringError",
]
