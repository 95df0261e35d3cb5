"""hashgraph_tpu_torch — the PyTorch and CUDA port of ``hashgraph_tpu``.

Binary yes/no consensus among n peers via signed hashgraph vote chains,
ceil(2n/3) quorum math, Gossipsub/P2P round semantics and silent-peer
liveness at timeout, with the per-proposal tallies held as dense tensors on
an NVIDIA GPU.

Two entry points serve it. :class:`ConsensusService` is the scalar API the
README's quick-start uses: one service per peer over a
:class:`ConsensusStorage`, either :class:`InMemoryConsensusStorage` or
:class:`TorchBackedStorage`, which keeps every session's tallies, voter
masks and lifecycle in a GPU pool slot, reloaded on each write; its default
signer is :class:`EthereumConsensusSigner`. :class:`TorchConsensusEngine` is
the batch-first engine over the same pool: batch, columnar and validated
vote ingest, proposals from peers (``process_incoming_proposal``,
``ingest_proposals``, ``deliver_proposal(s)``) through the admission cache
(:class:`VerifiedVoteCache`), validated wire-columnar ingest of peers'
vote frames (``ingest_wire_columnar``, with :mod:`.bridge.columnar`'s
parser), multi-scope creation and ingest, checkpoint to and restore from
a ``ConsensusStorage``, timeouts, and sessions the pool cannot hold served
on the host, as in the JAX package. :class:`DurableEngine` (:mod:`.wal`)
logs every mutating call before acknowledging it, in the JAX package's
write-ahead-log format, and recovers an engine from the log.
:mod:`.bridge` serves the engine to other processes over the JAX
package's framed TCP protocol, byte for byte: ``BridgeServer`` hosts one
engine a peer on the card (``device=``), ``BridgeClient`` and
``PipelinedBridgeClient`` drive it, and the apply reactor merges vote
frames from every connection into one dispatch a window.
:mod:`.obs` and :mod:`.tracing` observe all of it as the JAX package's do
(metrics registry and Prometheus text, timelines, health scoring,
distributed traces, the flight recorder, SLOs, the profiler), on objects
of this package's own; ``tracing.device_profile`` captures the GPU with
``torch.profiler``.

Host cryptography (Keccak, SHA-256, Ethereum ECDSA, Ed25519 signing and
batch verification) runs in the native C++ runtime (:mod:`.native`), which
``g++`` builds from the repo's ``native/consensus_native.cpp`` at first use,
with a pure-Python path where it is absent. Ed25519 batch verification can
run on the GPU instead (``Ed25519DeviceConsensusSigner``,
:mod:`.crypto_device`). Five kernels are hand-written CUDA, built at first
use for ``sm_90a``: the arrival-ordered vote scan ``ingest_scan``
(``csrc/ingest_scan.cu``); the GF(2^255-19) product ``fe_mul``
(``csrc/fe_mul.cu``) and the inverse-square-root chain ``fe_pow22523``
(``csrc/fe_pow22523.cu``) of decompression; and the MSM's window loop
``msm_windows`` and its tree with the cofactored identity test
``msm_reduce`` (``csrc/ed_msm.cu``). Every other device step is PyTorch,
among it the batched vote-chain check of proposals from peers
(:mod:`.ops.chain`) and the pool's slot writes that the service path makes.

The port imports nothing of the JAX package: the modules that carry no
device code (errors, wire, protocol, types, events, scope config, session,
signing, storage, service, native, the bridge, the write-ahead log and
the observability layer) are copies or ports of that package's, and the
JAX package stays the reference the tests hold the port against. Entry
points that hold device state take ``device=`` and default to ``"cuda"``;
they raise without a GPU rather than move to the CPU, which callers ask for
with ``device="cpu"``.
"""

__version__ = "0.1.0"

from .engine import (
    PendingVoteVerdicts,
    PoolFullError,
    ProposalPool,
    TorchBackedStorage,
    TorchConsensusEngine,
    VerifiedVoteCache,
)
from .errors import (
    ConsensusError,
    ConsensusFailed,
    ConsensusNotReached,
    ConsensusSchemeError,
    DuplicateVote,
    EmptySignature,
    EmptyVoteHash,
    EmptyVoteOwner,
    InsufficientVotesAtTimeout,
    InvalidConsensusThreshold,
    InvalidExpectedVotersCount,
    InvalidMaxRounds,
    InvalidTimeout,
    InvalidVoteHash,
    InvalidVoteSignature,
    InvalidVoteTimestamp,
    MaxRoundsExceeded,
    ParentHashMismatch,
    ProposalAlreadyExist,
    ProposalExpired,
    ReceivedHashMismatch,
    ScopeNotFound,
    SessionNotActive,
    SessionNotFound,
    StatusCode,
    TimestampOlderThanCreationTime,
    UserAlreadyVoted,
    VoteExpired,
    VoteProposalIdMismatch,
)
from .events import BroadcastEventBus, ConsensusEventBus, EventReceiver
from .protocol import (
    build_vote,
    calculate_consensus_result,
    compute_vote_hash,
    has_sufficient_votes,
    validate_proposal,
    validate_vote_chain,
)
from .scope_config import NetworkType, ScopeConfig, ScopeConfigBuilder
from .service import ConsensusService, ConsensusStats, ScopeConfigBuilderWrapper
from .session import ConsensusConfig, ConsensusSession, ConsensusState
from .signing import (
    ConsensusSignatureScheme,
    Ed25519ConsensusSigner,
    Ed25519DeviceConsensusSigner,
    EthereumConsensusSigner,
    StubConsensusSigner,
)
from .storage import ConsensusStorage, InMemoryConsensusStorage
from .types import (
    ConsensusFailedEvent,
    ConsensusReached,
    CreateProposalRequest,
    SessionTransition,
)
from .wal import DurableEngine, WalWriter
from .wire import Proposal, Vote

__all__ = [
    "BroadcastEventBus",
    "DurableEngine",
    "WalWriter",
    "ConsensusConfig",
    "ConsensusError",
    "ConsensusEventBus",
    "ConsensusFailed",
    "ConsensusFailedEvent",
    "ConsensusNotReached",
    "ConsensusReached",
    "ConsensusSchemeError",
    "ConsensusService",
    "ConsensusSession",
    "ConsensusSignatureScheme",
    "ConsensusState",
    "ConsensusStats",
    "ConsensusStorage",
    "CreateProposalRequest",
    "DuplicateVote",
    "Ed25519ConsensusSigner",
    "Ed25519DeviceConsensusSigner",
    "EmptySignature",
    "EmptyVoteHash",
    "EmptyVoteOwner",
    "EthereumConsensusSigner",
    "EventReceiver",
    "InMemoryConsensusStorage",
    "InsufficientVotesAtTimeout",
    "InvalidConsensusThreshold",
    "InvalidExpectedVotersCount",
    "InvalidMaxRounds",
    "InvalidTimeout",
    "InvalidVoteHash",
    "InvalidVoteSignature",
    "InvalidVoteTimestamp",
    "MaxRoundsExceeded",
    "NetworkType",
    "ParentHashMismatch",
    "PendingVoteVerdicts",
    "PoolFullError",
    "Proposal",
    "ProposalAlreadyExist",
    "ProposalExpired",
    "ProposalPool",
    "ReceivedHashMismatch",
    "ScopeConfig",
    "ScopeConfigBuilder",
    "ScopeConfigBuilderWrapper",
    "ScopeNotFound",
    "SessionNotActive",
    "SessionNotFound",
    "SessionTransition",
    "StatusCode",
    "StubConsensusSigner",
    "TimestampOlderThanCreationTime",
    "TorchBackedStorage",
    "TorchConsensusEngine",
    "UserAlreadyVoted",
    "VerifiedVoteCache",
    "Vote",
    "VoteExpired",
    "VoteProposalIdMismatch",
    "build_vote",
    "calculate_consensus_result",
    "compute_vote_hash",
    "has_sufficient_votes",
    "validate_proposal",
    "validate_vote_chain",
]
