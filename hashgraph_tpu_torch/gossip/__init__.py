"""hashgraph_tpu_torch.gossip — the gossip fabric (in part).

Only the shared-memory frame rings (:mod:`.shm`) are here: the bridge
server maps a client's rings on ``OP_SHM_ATTACH`` and serves frames over
them. The JAX package's transport, coalescer and ``GossipNode`` are not
ported yet.
"""

from . import shm

__all__ = ["shm"]
