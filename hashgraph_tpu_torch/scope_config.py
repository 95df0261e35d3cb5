"""Copy of ``hashgraph_tpu/scope_config.py`` for the PyTorch port, which imports
nothing of the JAX package.

Scope-level configuration: per-scope defaults every proposal inherits.

Mirrors the reference semantics (reference: src/scope_config.rs): a scope
holds a network type (Gossipsub/P2P round presets — these are round-semantics
presets, not transports), a default threshold/timeout/liveness, and an
optional max-rounds override. Timeouts are float seconds (the reference uses
``Duration``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from .errors import InvalidMaxRounds
from .protocol import validate_threshold, validate_timeout

DEFAULT_TIMEOUT_SECONDS = 60.0  # reference: src/scope_config.rs:13


class NetworkType(enum.Enum):
    """Round/vote semantics preset (reference: src/scope_config.rs:17-23)."""

    GOSSIPSUB = "gossipsub"  # 2 rounds, all votes land in round 2
    P2P = "p2p"  # dynamic ceil(2n/3) cap, each vote increments the round


@dataclass
class ScopeConfig:
    """Per-scope defaults (reference: src/scope_config.rs:30-53).

    ``demote_after`` / ``evict_decided_after`` are TPU-framework-specific
    storage-tiering policies with no reference analogue (the reference's
    only lifecycle is ``delete_scope``, src/storage.rs:92 — see PARITY.md):
    ``demote_after`` seconds of inactivity move a session out of its
    device slot / host record into the compact demoted tier (it pages
    back transparently on any touch), and ``evict_decided_after`` seconds
    after a session's deciding activity garbage-collect decided/failed
    sessions outright. Both default to None = never (reference
    behavior).

    ``decide_p99_ms`` is the scope's declarative latency SLO (also
    embedder-layer, no reference analogue): the p99 decision-latency
    objective in milliseconds. Decisions slower than this count against
    the scope's error budget in the SLO engine
    (:mod:`hashgraph_tpu.obs.slo`) — sustained breaching fires a
    multi-window burn-rate alert and an incident dump. None (the
    default) = best-effort scope, tracked but never alerting.

    ``timeout_min`` / ``timeout_max`` bound the ADAPTIVE consensus
    timeout (also embedder-layer — the reference's timer contract at
    src/lib.rs:15-34 is static and embedder-supplied): when BOTH are
    set, the engine learns a per-scope timeout between them —
    PBFT-style multiplicative backoff each time a consensus timeout
    actually fires, decay toward the SLO engine's observed decision
    p99 on every successful (vote-driven) decision. Both None (the
    default) = static ``default_timeout``, exactly the reference
    behavior. Timeouts remain embedder-driven calls, so adaptivity is
    WAL-replay-safe: the learner is advisory, in-memory, and paused
    during replay."""

    network_type: NetworkType = NetworkType.GOSSIPSUB
    default_consensus_threshold: float = 2.0 / 3.0
    default_timeout: float = DEFAULT_TIMEOUT_SECONDS
    default_liveness_criteria_yes: bool = True
    max_rounds_override: int | None = None
    demote_after: float | None = None
    evict_decided_after: float | None = None
    decide_p99_ms: float | None = None
    timeout_min: float | None = None
    timeout_max: float | None = None

    def validate(self) -> None:
        """reference: src/scope_config.rs:57-69 — Some(0) override is only
        legal for P2P (it triggers dynamic calculation). Negative overrides
        are unrepresentable in the reference's u32 and rejected here."""
        validate_threshold(self.default_consensus_threshold)
        validate_timeout(self.default_timeout)
        if self.max_rounds_override is not None:
            if self.max_rounds_override < 0:
                raise InvalidMaxRounds()
            if (
                self.max_rounds_override == 0
                and self.network_type == NetworkType.GOSSIPSUB
            ):
                raise InvalidMaxRounds()
        for ttl in (self.demote_after, self.evict_decided_after):
            if ttl is not None and not ttl > 0:
                raise ValueError("tier TTLs must be positive seconds (or None)")
        if self.decide_p99_ms is not None and not self.decide_p99_ms > 0:
            raise ValueError(
                "decide_p99_ms must be positive milliseconds (or None)"
            )
        for bound in (self.timeout_min, self.timeout_max):
            if bound is not None and not bound > 0:
                raise ValueError(
                    "timeout bounds must be positive seconds (or None)"
                )
        if (self.timeout_min is None) != (self.timeout_max is None):
            raise ValueError(
                "timeout_min and timeout_max must be set together "
                "(adaptivity needs both bounds)"
            )
        if (
            self.timeout_min is not None
            and self.timeout_max is not None
            and self.timeout_min > self.timeout_max
        ):
            raise ValueError("timeout_min must not exceed timeout_max")

    def adaptive_timeout_enabled(self) -> bool:
        """True when this scope opted into the learned timeout."""
        return self.timeout_min is not None and self.timeout_max is not None

    def clone(self) -> "ScopeConfig":
        return ScopeConfig(
            network_type=self.network_type,
            default_consensus_threshold=self.default_consensus_threshold,
            default_timeout=self.default_timeout,
            default_liveness_criteria_yes=self.default_liveness_criteria_yes,
            max_rounds_override=self.max_rounds_override,
            demote_after=self.demote_after,
            evict_decided_after=self.evict_decided_after,
            decide_p99_ms=self.decide_p99_ms,
            timeout_min=self.timeout_min,
            timeout_max=self.timeout_max,
        )

    @classmethod
    def from_network_type(cls, network_type: NetworkType) -> "ScopeConfig":
        """reference: src/scope_config.rs:72-91 — both presets share the
        2/3 threshold, 60s timeout, liveness=True defaults."""
        return cls(network_type=network_type)


class ScopeConfigBuilder:
    """Fluent builder with presets (reference: src/scope_config.rs:93-204)."""

    def __init__(self, config: ScopeConfig | None = None):
        self._config = config.clone() if config is not None else ScopeConfig()

    @classmethod
    def from_existing(cls, config: ScopeConfig) -> "ScopeConfigBuilder":
        return cls(config)

    def with_network_type(self, network_type: NetworkType) -> "ScopeConfigBuilder":
        self._config.network_type = network_type
        return self

    def with_threshold(self, threshold: float) -> "ScopeConfigBuilder":
        self._config.default_consensus_threshold = threshold
        return self

    def with_timeout(self, timeout_seconds: float) -> "ScopeConfigBuilder":
        self._config.default_timeout = timeout_seconds
        return self

    def with_liveness_criteria(self, liveness_criteria_yes: bool) -> "ScopeConfigBuilder":
        self._config.default_liveness_criteria_yes = liveness_criteria_yes
        return self

    def with_max_rounds(self, max_rounds: int | None) -> "ScopeConfigBuilder":
        self._config.max_rounds_override = max_rounds
        return self

    def with_demote_after(self, seconds: float | None) -> "ScopeConfigBuilder":
        """Idle/decided sessions demote to the compact tier after this
        many seconds of inactivity (None = never; tiering off)."""
        self._config.demote_after = seconds
        return self

    def with_evict_decided_after(
        self, seconds: float | None
    ) -> "ScopeConfigBuilder":
        """Decided/failed sessions are garbage-collected outright this
        many seconds after their deciding activity (None = never)."""
        self._config.evict_decided_after = seconds
        return self

    def with_decide_p99_ms(self, ms: float | None) -> "ScopeConfigBuilder":
        """Declare the scope's p99 decision-latency SLO in milliseconds
        (None = best-effort; tracked in the SLO engine, never alerting)."""
        self._config.decide_p99_ms = ms
        return self

    def with_timeout_bounds(
        self, timeout_min: float | None, timeout_max: float | None
    ) -> "ScopeConfigBuilder":
        """Opt the scope into the ADAPTIVE consensus timeout, clamped to
        ``[timeout_min, timeout_max]`` seconds (both None = static
        ``default_timeout``, the reference behavior)."""
        self._config.timeout_min = timeout_min
        self._config.timeout_max = timeout_max
        return self

    def p2p_preset(self) -> "ScopeConfigBuilder":
        """reference: src/scope_config.rs:140-147"""
        self._config = ScopeConfig(network_type=NetworkType.P2P)
        return self

    def gossipsub_preset(self) -> "ScopeConfigBuilder":
        """reference: src/scope_config.rs:150-157"""
        self._config = ScopeConfig(network_type=NetworkType.GOSSIPSUB)
        return self

    def strict_consensus(self) -> "ScopeConfigBuilder":
        """Higher threshold = 0.9 (reference: src/scope_config.rs:160-163)."""
        self._config.default_consensus_threshold = 0.9
        return self

    def fast_consensus(self) -> "ScopeConfigBuilder":
        """Lower threshold = 0.6, 30s timeout (reference: src/scope_config.rs:166-170)."""
        self._config.default_consensus_threshold = 0.6
        self._config.default_timeout = 30.0
        return self

    def with_network_defaults(self, network_type: NetworkType) -> "ScopeConfigBuilder":
        """Reset network/threshold/timeout to the preset, preserving liveness
        and max-rounds override (reference: src/scope_config.rs:173-187)."""
        self._config.network_type = network_type
        self._config.default_consensus_threshold = 2.0 / 3.0
        self._config.default_timeout = DEFAULT_TIMEOUT_SECONDS
        return self

    def validate(self) -> None:
        self._config.validate()

    def build(self) -> ScopeConfig:
        self.validate()
        return self._config.clone()

    def get_config(self) -> ScopeConfig:
        return self._config.clone()
