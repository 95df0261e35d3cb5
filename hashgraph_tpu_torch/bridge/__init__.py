"""Embedder/FFI bridge of the port: the consensus surface for non-Python
processes, over :class:`~hashgraph_tpu_torch.engine.TorchConsensusEngine`.

See :mod:`.protocol` for the wire format (the JAX package's, byte for
byte), :class:`~.server.BridgeServer` for the host side,
``native/bridge_client.c`` for the C reference embedder,
:class:`~.client.PipelinedBridgeClient` for the feature-negotiated
many-in-flight client, :mod:`.reactor` for the apply reactor that merges
columnar vote frames into one ``ingest_wire_columnar`` dispatch a window,
and :mod:`.columnar` for the columnar parse of ``OP_VOTE_BATCH`` rows.
"""

from . import columnar
from .client import (
    BridgeClient,
    BridgeConnectionLost,
    BridgeError,
    BridgeEvent,
    PipelinedBridgeClient,
)
from .server import BridgeServer

__all__ = [
    "BridgeClient",
    "BridgeConnectionLost",
    "BridgeError",
    "BridgeEvent",
    "BridgeServer",
    "PipelinedBridgeClient",
    "columnar",
]
