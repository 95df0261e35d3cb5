"""φ-accrual failure suspicion (Hayashibara et al. 2004, PAPERS.md).

The reference contract leaves liveness to the embedder (reference:
src/lib.rs:15-34); the health watchdog's original answer was a binary
``stale_after`` threshold — one fixed silence bound for every peer, so a
slow-but-honest peer under partial synchrony is convicted exactly as
hard as a dead one. The φ-accrual detector replaces the binary verdict
with a *continuous suspicion level*:

    phi(now) = -log10( P(silence >= now - last_heartbeat) )

under a normal approximation of the peer's own observed inter-arrival
distribution. ``phi = 1`` means "this much silence happens ~10% of the
time for THIS peer", ``phi = 8`` means one in 10^8 — the operator picks
a threshold on *confidence*, not on seconds, and a peer with naturally
jittery arrivals earns a proportionally wider tolerance (the
Chandra–Toueg unreliable-failure-detector framing: suspicion may be
wrong, and must be cheap to revise — phi falls back toward zero the
moment a heartbeat lands).

Time is the embedder's logical clock (the library's no-clock contract):
heartbeats are vote-admission ticks, never wall time, so the detector is
deterministic in the chaos sim and WAL-replay-safe in production.

Numerics: the Gaussian tail is Q(x) = erfc(x/√2)/2; past the double-
precision underflow point the standard asymptotic expansion
Q(x) ≈ exp(-x²/2)/(x·√(2π)) keeps phi finite and monotone instead of
collapsing to -log10(0). Phi is clamped to ``max_phi`` — beyond ~10^-64
confidence there is no operational difference, and a bounded value keeps
gauges and JSON serializations sane.
"""

from __future__ import annotations

import math
from collections import deque

# Below this many observed inter-arrival samples the distribution is not
# trustworthy and phi reports 0.0 (never suspicious): a freshly-seen
# peer must not be convictable off two data points.
DEFAULT_MIN_SAMPLES = 8
DEFAULT_WINDOW = 64
DEFAULT_MAX_PHI = 64.0
# Variance floors: a metronome-regular peer (stddev -> 0) must not make
# one tick of lateness look like certain death. The effective stddev is
# max(observed, min_stddev, rel_stddev * mean).
DEFAULT_MIN_STDDEV = 0.5
DEFAULT_REL_STDDEV = 0.1

_SQRT2 = math.sqrt(2.0)
_LN10 = math.log(10.0)
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def phi_from_deviation(x: float, max_phi: float = DEFAULT_MAX_PHI) -> float:
    """phi for a silence ``x`` standard deviations past the mean.

    ``x <= 0`` (silence no longer than a typical interval) is never
    suspicious. The direct erfc evaluation is exact until the tail
    underflows double precision (~x > 37); past that the asymptotic
    expansion continues the same monotone curve in log space.
    """
    if x <= 0.0:
        return 0.0
    if x < 8.0:
        q = 0.5 * math.erfc(x / _SQRT2)
        if q > 0.0:
            return min(max_phi, -math.log10(q))
    # Q(x) ~ exp(-x^2/2) / (x * sqrt(2*pi)) for large x: phi in log10.
    ln_q = -(x * x) / 2.0 - math.log(x) - _LOG_SQRT_2PI
    return min(max_phi, -ln_q / _LN10)


class PhiAccrual:
    """Bounded inter-arrival history + phi readout for ONE peer.

    ``heartbeat(now)`` records an arrival on the logical clock (same-tick
    arrivals coalesce: a burst of votes in one batch is one liveness
    observation, not a window full of zero intervals that would poison
    the variance). ``phi(now)`` is the current suspicion level. All
    methods are O(1); the window keeps running sums so phi never walks
    the deque.
    """

    __slots__ = (
        "window",
        "min_samples",
        "min_stddev",
        "rel_stddev",
        "max_phi",
        "last_heartbeat",
        "_intervals",
        "_sum",
        "_sumsq",
    )

    def __init__(
        self,
        *,
        window: int = DEFAULT_WINDOW,
        min_samples: int = DEFAULT_MIN_SAMPLES,
        min_stddev: float = DEFAULT_MIN_STDDEV,
        rel_stddev: float = DEFAULT_REL_STDDEV,
        max_phi: float = DEFAULT_MAX_PHI,
    ):
        if window < 2:
            raise ValueError("window must hold at least 2 intervals")
        if min_samples < 2:
            raise ValueError("min_samples must be at least 2")
        self.window = window
        self.min_samples = min_samples
        self.min_stddev = float(min_stddev)
        self.rel_stddev = float(rel_stddev)
        self.max_phi = float(max_phi)
        self.last_heartbeat: float | None = None
        self._intervals: deque[float] = deque()
        self._sum = 0.0
        self._sumsq = 0.0

    def heartbeat(self, now: float) -> None:
        """One arrival at logical tick ``now``. Out-of-order or same-tick
        arrivals (interval <= 0) refresh nothing — the clock is
        monotone per the embedder contract, and a coalesced batch is one
        observation."""
        last = self.last_heartbeat
        if last is None:
            self.last_heartbeat = now
            return
        interval = now - last
        if interval <= 0.0:
            return
        self.last_heartbeat = now
        self._intervals.append(interval)
        self._sum += interval
        self._sumsq += interval * interval
        if len(self._intervals) > self.window:
            old = self._intervals.popleft()
            self._sum -= old
            self._sumsq -= old * old

    @property
    def sample_count(self) -> int:
        return len(self._intervals)

    def mean(self) -> float:
        n = len(self._intervals)
        return self._sum / n if n else 0.0

    def stddev(self) -> float:
        n = len(self._intervals)
        if n < 2:
            return 0.0
        var = (self._sumsq - self._sum * self._sum / n) / n
        # Running-sum cancellation can drift epsilon-negative.
        return math.sqrt(var) if var > 0.0 else 0.0

    def phi(self, now: float) -> float:
        """Suspicion level at ``now``: 0.0 while the history is too thin
        (min_samples) or the silence is within a typical interval;
        monotone non-decreasing in silence after that."""
        if (
            self.last_heartbeat is None
            or len(self._intervals) < self.min_samples
        ):
            return 0.0
        silence = now - self.last_heartbeat
        if silence <= 0.0:
            return 0.0
        mean = self.mean()
        stddev = max(
            self.stddev(), self.min_stddev, self.rel_stddev * mean
        )
        return phi_from_deviation((silence - mean) / stddev, self.max_phi)

    def reset(self) -> None:
        self.last_heartbeat = None
        self._intervals.clear()
        self._sum = 0.0
        self._sumsq = 0.0
