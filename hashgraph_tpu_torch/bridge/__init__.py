"""The bridge's wire layer of the port: the columnar parse of
``OP_VOTE_BATCH`` vote rows (:mod:`.columnar`) that
:meth:`~hashgraph_tpu_torch.engine.TorchConsensusEngine.ingest_wire_columnar`
and WAL replay read. The bridge's server and client are not ported yet;
this package imports neither.
"""

from . import columnar

__all__ = ["columnar"]
