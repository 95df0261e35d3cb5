"""hashgraph_tpu_torch.parallel — multi-device and multi-host placement.

Port of the JAX package's ``parallel/``:

- the mesh (:mod:`.mesh`: a list of devices; an entry may repeat);
- the sharded pool (:mod:`.sharded`: one block of pool tensors a mesh
  entry, the single-device bodies run block by block);
- the multi-host pool (:mod:`.multihost`: the slot axis across the
  processes of a gloo process group, with the engine's multi-host
  branches keyed on it);
- the scope-sharded fleet (:mod:`.fleet`: rendezvous placement, one
  engine on a one-block :class:`ShardedPool` a shard, the router, the
  fleet tally reduced on the device, crash recovery and catch-up);
- the shared rollups (:mod:`.rollup`);
- the federation (:mod:`.federation`: (host, shard) placement, one
  bridge peer a host over its fleet, cross-host routing over the gossip
  fabric, live shard migration).
"""

from .federation import (
    FederationDriver,
    FederationPlacement,
    FleetEngineAdapter,
    FleetGroup,
    MigrationError,
    migrate_shard,
    tally_path,
)
from .fleet import (
    ConsensusFleet,
    FleetShard,
    ScopePlacement,
    ShardMigratingError,
    ShardRecoveringError,
    rendezvous_owner,
)
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
    "ConsensusFleet",
    "FleetShard",
    "ScopePlacement",
    "ShardRecoveringError",
    "ShardMigratingError",
    "rendezvous_owner",
    "FederationPlacement",
    "FleetEngineAdapter",
    "FleetGroup",
    "FederationDriver",
    "MigrationError",
    "migrate_shard",
    "tally_path",
]
