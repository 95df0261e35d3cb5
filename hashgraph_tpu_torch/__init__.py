"""hashgraph_tpu_torch — the PyTorch and CUDA port of ``hashgraph_tpu``.

Binary yes/no consensus among n peers via signed hashgraph vote chains,
ceil(2n/3) quorum math, Gossipsub/P2P round semantics and silent-peer
liveness at timeout, with the per-proposal tallies held as dense tensors on
an NVIDIA GPU. Ed25519 batch verification can run on the GPU too
(``Ed25519DeviceConsensusSigner``, :mod:`.crypto_device`). Five kernels are
hand-written CUDA, built at first use for ``sm_90a``: the arrival-ordered
vote scan ``ingest_scan`` (``csrc/ingest_scan.cu``); the GF(2^255-19)
product ``fe_mul`` (``csrc/fe_mul.cu``) and the inverse-square-root chain
``fe_pow22523`` (``csrc/fe_pow22523.cu``) of decompression; and the MSM's
window loop ``msm_windows`` and its tree with the cofactored identity test
``msm_reduce`` (``csrc/ed_msm.cu``). Every other device step is
PyTorch, among it the batched vote-chain check of proposals from peers
(:mod:`.ops.chain`), which runs on the engine's device. Sessions the pool
cannot hold are served on the host, as in the JAX package. Proposals from
peers enter through ``process_incoming_proposal``, ``ingest_proposals`` and
``deliver_proposal(s)``, and signature checks go through the admission
cache (:class:`VerifiedVoteCache`) unless an engine is built with
``verify_cache=None``.

The port imports nothing of the JAX package: the modules that carry no
device code (errors, wire, protocol, types, events, scope config, session,
signing) are copies of that package's, and the JAX package stays the
reference the tests hold the port against. Entry points take ``device=``
and default to ``"cuda"``; they raise without a GPU rather than move to the
CPU, which callers ask for with ``device="cpu"``.
"""

from .engine import (
    ConsensusStats,
    PendingVoteVerdicts,
    PoolFullError,
    ProposalPool,
    TorchConsensusEngine,
    VerifiedVoteCache,
)
from .errors import ConsensusError, StatusCode
from .events import BroadcastEventBus, ConsensusEventBus, EventReceiver
from .protocol import (
    build_vote,
    calculate_consensus_result,
    compute_vote_hash,
    validate_vote_chain,
)
from .scope_config import NetworkType, ScopeConfig, ScopeConfigBuilder
from .session import ConsensusConfig, ConsensusSession, ConsensusState
from .signing import (
    ConsensusSignatureScheme,
    Ed25519ConsensusSigner,
    Ed25519DeviceConsensusSigner,
    StubConsensusSigner,
)
from .types import (
    ConsensusFailedEvent,
    ConsensusReached,
    CreateProposalRequest,
)
from .wire import Proposal, Vote

__all__ = [
    "BroadcastEventBus",
    "ConsensusConfig",
    "ConsensusError",
    "ConsensusEventBus",
    "ConsensusFailedEvent",
    "ConsensusReached",
    "ConsensusSession",
    "ConsensusSignatureScheme",
    "ConsensusState",
    "ConsensusStats",
    "CreateProposalRequest",
    "Ed25519ConsensusSigner",
    "Ed25519DeviceConsensusSigner",
    "EventReceiver",
    "NetworkType",
    "PendingVoteVerdicts",
    "PoolFullError",
    "Proposal",
    "ProposalPool",
    "ScopeConfig",
    "ScopeConfigBuilder",
    "StatusCode",
    "StubConsensusSigner",
    "TorchConsensusEngine",
    "VerifiedVoteCache",
    "Vote",
    "build_vote",
    "calculate_consensus_result",
    "compute_vote_hash",
    "validate_vote_chain",
]
