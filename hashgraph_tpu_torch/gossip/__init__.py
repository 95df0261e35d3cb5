"""hashgraph_tpu_torch.gossip — the gossip fabric.

The bridge (:mod:`hashgraph_tpu_torch.bridge`) is strictly
request/response, one frame at a time. This package is the throughput
layer on top of the SAME wire protocol: a selectors-based event-loop
transport with connection multiplexing and frame pipelining
(:class:`GossipTransport`, with the shared-memory frame rings of
:mod:`.shm`), send-side vote coalescing into columnar batch frames
(:class:`VoteCoalescer`), and a :class:`GossipNode` that fans deliveries
to a sampled peer subset and repairs divergence with periodic
anti-entropy over the engine's validated-chain watermark, escalating
far-behind peers to the state-sync catch-up path
(:class:`~hashgraph_tpu_torch.sync.CatchUpClient`).

Port of the JAX package's ``gossip/``: its frames are byte-identical to
the JAX package's, so nodes and servers of the two packages gossip with
each other. Every frame lands on a peer's
:class:`~hashgraph_tpu_torch.engine.TorchConsensusEngine`, so on the
``ingest_scan`` kernel when the peer's engine is on the card.
"""

from . import shm
from .coalescer import VoteCoalescer
from .node import GossipNode
from .transport import ChannelBusy, GossipTransport, PeerChannel

__all__ = [
    "ChannelBusy",
    "GossipNode",
    "GossipTransport",
    "PeerChannel",
    "VoteCoalescer",
    "shm",
]
