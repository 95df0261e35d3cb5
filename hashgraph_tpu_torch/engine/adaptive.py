"""Adaptive per-scope consensus timeouts learned from observed latency.

The reference's timer contract is static and embedder-supplied
(reference: src/lib.rs:15-34): the embedder schedules a fixed
``consensus_timeout`` per proposal and calls ``handle_consensus_timeout``
when it fires. A fixed timeout forces one trade for every network
condition — too short and a transiently-slow network mass-fails healthy
sessions; too long and genuinely-dead sessions linger for the full
worst-case bound.

This learner keeps the reference contract intact (timeouts remain
embedder-driven calls; nothing here schedules anything) and makes the
*value* the embedder should schedule adaptive, PBFT-style
(Castro & Liskov 1999, §2.3 view-change timers):

- every time a consensus timeout actually FIRES for a scope, the scope's
  learned timeout multiplies by ``backoff`` — repeated timeouts mean the
  network is slower than we believed, so back off geometrically;
- every vote-driven decision decays the learned timeout toward the SLO
  engine's observed decision-latency p99 for that scope times
  ``headroom`` — successes mean the observed tail is trustworthy, so the
  timeout tracks it from above instead of staying inflated forever;
- the result is always clamped to the scope's declared
  ``[timeout_min, timeout_max]`` (``ScopeConfig`` validates both-set).

The book is advisory, in-memory, and per-process on purpose: it feeds
``Engine.adaptive_timeout(scope)``, which the embedder polls when
scheduling its next timer. It is NOT replicated state — WAL replay
re-fires no timers (the engine's ``_health_live`` gate pauses learning
during replay), so a restarted process simply re-learns from live
traffic starting at the scope's static default. Determinism of the
consensus state machine is untouched: the learned value only changes
WHEN the embedder chooses to time out, never what a timeout does.

Scope entries live in a bounded LRU (churn benches mint millions of
scopes; unbounded per-scope floats would be a leak).
"""

from __future__ import annotations

from collections import OrderedDict

from ..scope_config import ScopeConfig

DEFAULT_BACKOFF = 2.0
DEFAULT_DECAY = 0.2
DEFAULT_HEADROOM = 1.5
DEFAULT_MAX_SCOPES = 256


class AdaptiveTimeoutBook:
    """Per-scope learned consensus-timeout values (seconds).

    All methods take the scope's ``ScopeConfig`` and are no-ops (returning
    the static default) unless the scope opted in via
    ``config.adaptive_timeout_enabled()``. Callers hold the engine lock;
    the book itself is not thread-safe.
    """

    def __init__(
        self,
        *,
        backoff: float = DEFAULT_BACKOFF,
        decay: float = DEFAULT_DECAY,
        headroom: float = DEFAULT_HEADROOM,
        max_scopes: int = DEFAULT_MAX_SCOPES,
    ):
        if backoff <= 1.0:
            raise ValueError("backoff must exceed 1.0")
        if not 0.0 < decay <= 1.0:
            raise ValueError("decay must be in (0, 1]")
        if headroom < 1.0:
            raise ValueError("headroom must be at least 1.0")
        self.backoff = float(backoff)
        self.decay = float(decay)
        self.headroom = float(headroom)
        self.max_scopes = max_scopes
        self._timeouts: "OrderedDict[object, float]" = OrderedDict()
        # Observability counters (per-process, read via snapshot()).
        self.backoffs_total = 0
        self.decays_total = 0

    @staticmethod
    def _clamp(value: float, config: ScopeConfig) -> float:
        return min(config.timeout_max, max(config.timeout_min, value))

    def _seed(self, scope, config: ScopeConfig) -> float:
        current = self._timeouts.get(scope)
        if current is None:
            current = self._clamp(config.default_timeout, config)
            self._timeouts[scope] = current
            while len(self._timeouts) > self.max_scopes:
                self._timeouts.popitem(last=False)
        else:
            self._timeouts.move_to_end(scope)
        return current

    def current(self, scope, config: ScopeConfig | None) -> float | None:
        """The timeout the embedder should schedule next for ``scope``:
        the learned value when the scope opted in, else None (caller
        falls back to the static resolution path)."""
        if config is None or not config.adaptive_timeout_enabled():
            return None
        return self._clamp(self._seed(scope, config), config)

    def on_timeout(self, scope, config: ScopeConfig | None) -> float | None:
        """A consensus timeout actually fired for ``scope``: multiply the
        learned timeout by ``backoff`` (clamped). Returns the new value,
        or None when the scope is not adaptive."""
        if config is None or not config.adaptive_timeout_enabled():
            return None
        nxt = self._clamp(self._seed(scope, config) * self.backoff, config)
        self._timeouts[scope] = nxt
        self.backoffs_total += 1
        return nxt

    def on_decided(
        self, scope, config: ScopeConfig | None, observed_p99_s: float
    ) -> float | None:
        """A vote-driven decision landed for ``scope``: decay the learned
        timeout toward ``observed_p99_s * headroom`` (clamped). A zero
        observation (no recent window data) leaves the value untouched —
        never decay toward a target the SLO engine has not measured."""
        if config is None or not config.adaptive_timeout_enabled():
            return None
        current = self._seed(scope, config)
        if observed_p99_s <= 0.0:
            return current
        target = self._clamp(observed_p99_s * self.headroom, config)
        nxt = self._clamp(current + self.decay * (target - current), config)
        self._timeouts[scope] = nxt
        self.decays_total += 1
        return nxt

    def snapshot(self) -> dict:
        """Debug/introspection readout (keys stringified for JSON)."""
        return {
            "scopes": {str(k): round(v, 6) for k, v in self._timeouts.items()},
            "backoffs_total": self.backoffs_total,
            "decays_total": self.decays_total,
        }

    def reset(self) -> None:
        self._timeouts.clear()
        self.backoffs_total = 0
        self.decays_total = 0
