"""hashgraph_tpu_torch.parallel — multi-device placement (in part).

Only the fleet's two shard-availability errors are here
(:mod:`.fleet`): the bridge server answers them as
``STATUS_SHARD_MIGRATING``. The rest of the JAX package's ``parallel/``
(mesh, sharded pool, fleet, multi-host, federation, rollup) is not
ported yet.
"""

from .fleet import ShardMigratingError, ShardRecoveringError

__all__ = ["ShardMigratingError", "ShardRecoveringError"]
