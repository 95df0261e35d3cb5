"""SLO engine: sliding-window decision-latency quantiles, multi-window
burn-rate alerting, and exemplar-linked incident capture.

The registry's :class:`~hashgraph_tpu_torch.obs.registry.Histogram` is
cumulative-forever — right for trend dashboards, useless for "is p99 over
objective *right now*". This module adds the time dimension:

- :class:`WindowedHistogram` — a sliding-window sketch over the SAME
  log-spaced bucket bounds the registry uses. Observations land in fixed
  time slices (a bounded deque of count vectors); a windowed quantile
  sums the slices inside the window and interpolates with the shared
  :func:`~hashgraph_tpu_torch.obs.registry.quantile_from`. Memory is bounded at
  ``ceil(max_age / slice_seconds)`` count vectors regardless of rate.
- :class:`SloEngine` — per-scope, per-shard, and global windowed
  trackers; declarative objectives arrive per decision (the engine reads
  ``ScopeConfig.decide_p99_ms``); *multi-window burn-rate* alerting in
  the Google-SRE style: the burn rate is (breaching fraction) / (error
  budget fraction), and an alert fires only when BOTH the fast (5m) and
  slow (1h) windows burn above threshold — the fast window gives low
  detection latency, the slow window suppresses blips — and clears when
  the fast window recovers. State is machine-readable (:meth:`SloEngine
  .state`, the ``/slo`` sidecar endpoint) and exported as
  ``hashgraph_slo_*`` families on the metrics registry.
- :class:`IncidentCapture` — when a decision breaches its objective or an
  alert fires, dump the correlated evidence (flight-recorder ring,
  ``trace_store`` spans as a Perfetto-loadable Chrome trace, breach
  metadata) into a bounded on-disk incident directory, cooled down per
  scope so a sustained breach storm produces one dump, not thousands.

Everything takes an injectable ``clock`` so the chaos sim drives it on
virtual time; the process-wide instance (``hashgraph_tpu_torch.obs.slo_engine``)
runs on ``time.monotonic``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
from bisect import bisect_left
from collections import OrderedDict, deque

from .flight import flight_recorder
from .registry import DEFAULT_TIME_BUCKETS, quantile_from
from .trace import chrome_trace, trace_store

# ── Well-known SLO families (installed eagerly by hashgraph_tpu_torch.obs) ───

SLO_BREACHES_TOTAL = "hashgraph_slo_breaches_total"
SLO_ALERTS_TOTAL = "hashgraph_slo_alerts_total"
SLO_ALERTS_FIRING = "hashgraph_slo_alerts_firing"
SLO_DECISION_P99_SECONDS = "hashgraph_slo_decision_p99_seconds"
SLO_BURN_RATE = "hashgraph_slo_burn_rate"
SLO_INCIDENTS_TOTAL = "hashgraph_slo_incidents_total"

DEFAULT_FAST_WINDOW = 300.0  # 5 minutes
DEFAULT_SLOW_WINDOW = 3600.0  # 1 hour
# Google SRE multi-window default: 14.4x burn consumes a 30-day budget in
# ~2 days — page-worthy, yet blips shorter than the fast window never fire.
DEFAULT_BURN_THRESHOLD = 14.4

_ENV_INCIDENT_DIR = "HASHGRAPH_INCIDENT_DIR"

_escape = (
    lambda v: str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
)


class WindowedHistogram:
    """Sliding-window log-bucketed sketch. NOT self-locking — the owner
    (:class:`SloEngine`) serializes access; standalone users in tests may
    call it single-threaded."""

    __slots__ = ("bounds", "slice_seconds", "max_age", "_slices")

    def __init__(
        self,
        bounds: tuple[float, ...] = DEFAULT_TIME_BUCKETS,
        slice_seconds: float = 10.0,
        max_age: float = DEFAULT_SLOW_WINDOW,
    ):
        if slice_seconds <= 0 or max_age <= slice_seconds:
            raise ValueError("need 0 < slice_seconds < max_age")
        self.bounds = tuple(float(b) for b in bounds)
        self.slice_seconds = float(slice_seconds)
        self.max_age = float(max_age)
        # Each slice: [slice_start, counts(len(bounds)+1), total, breaching].
        # Only slices that saw traffic exist; the deque stays time-ordered.
        self._slices: deque = deque()

    def _prune(self, now: float) -> None:
        horizon = now - self.max_age
        slices = self._slices
        while slices and slices[0][0] + self.slice_seconds <= horizon:
            slices.popleft()

    def observe(self, value: float, now: float, breaching: bool = False) -> None:
        start = math.floor(now / self.slice_seconds) * self.slice_seconds
        slices = self._slices
        if not slices or slices[-1][0] != start:
            self._prune(now)
            slices.append([start, [0] * (len(self.bounds) + 1), 0, 0])
        cur = slices[-1]
        cur[1][bisect_left(self.bounds, value)] += 1
        cur[2] += 1
        if breaching:
            cur[3] += 1

    def window_counts(
        self, window: float, now: float
    ) -> tuple[list[int], int, int]:
        """(bucket counts, total, breaching) summed over slices whose span
        intersects ``[now - window, now]``."""
        horizon = now - window
        counts = [0] * (len(self.bounds) + 1)
        total = breaching = 0
        for start, slice_counts, n, b in self._slices:
            if start + self.slice_seconds <= horizon:
                continue
            for i, c in enumerate(slice_counts):
                if c:
                    counts[i] += c
            total += n
            breaching += b
        return counts, total, breaching

    def quantile(self, q: float, window: float, now: float) -> float:
        counts, total, _ = self.window_counts(window, now)
        return quantile_from(self.bounds, counts, total, q)

    def summary(self, window: float, now: float) -> dict:
        counts, total, breaching = self.window_counts(window, now)
        return {
            "count": total,
            "breaching": breaching,
            "p50": quantile_from(self.bounds, counts, total, 0.5),
            "p95": quantile_from(self.bounds, counts, total, 0.95),
            "p99": quantile_from(self.bounds, counts, total, 0.99),
        }


class _ScopeTracker:
    __slots__ = (
        "window",
        "objective_s",
        "breaches",
        "alerts_total",
        "alert_firing",
        "alert_since",
    )

    def __init__(self, window: WindowedHistogram):
        self.window = window
        self.objective_s: float | None = None
        self.breaches = 0
        self.alerts_total = 0
        self.alert_firing = False
        self.alert_since: float | None = None


class IncidentCapture:
    """Bounded on-disk incident dumps linking an SLO breach to its causal
    evidence. Each incident directory holds:

    - ``incident.json`` — reason, scope/shard, breach latency vs
      objective, the breaching decision's trace id, span/event counts;
    - ``flight.jsonl`` — the process flight-recorder ring at capture time
      (explicit-path dump, so the fault-dump throttle is not consumed);
    - ``trace.json`` — ``trace_store`` spans as a Chrome trace-event
      document (Perfetto / chrome://tracing open it directly), filtered
      to the breaching trace id when its spans are still in the store;
    - ``profile.json`` — the wall-clock attribution report
      (:func:`~hashgraph_tpu_torch.obs.attribution.attribution_report`):
      per-stage busy shares plus the continuous profiler's sampled
      per-role stack counts — *what the process was doing* when the
      objective broke, not just the breaching trace.

    Bounded two ways: newest ``max_incidents`` directories are kept
    (oldest pruned), and a per-scope ``cooldown_s`` collapses a breach
    storm into one dump. ``root=None`` (and no ``$HASHGRAPH_INCIDENT_DIR``)
    disables capture entirely."""

    def __init__(
        self,
        root: str | None = None,
        *,
        max_incidents: int = 16,
        cooldown_s: float = 60.0,
        clock=time.monotonic,
        counter=None,
    ):
        self.root = root if root is not None else os.environ.get(_ENV_INCIDENT_DIR)
        self.max_incidents = max_incidents
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._last: dict[str, float] = {}
        self._seq = 0
        self.counter = counter

    @property
    def enabled(self) -> bool:
        return self.root is not None

    def capture(
        self,
        reason: str,
        *,
        scope=None,
        shard: str | None = None,
        trace_hex: str | None = None,
        latency_s: float | None = None,
        objective_s: float | None = None,
        detail: dict | None = None,
    ) -> str | None:
        """Dump one incident; returns its directory (None when disabled,
        cooled down, or the filesystem refuses — capture is best-effort
        evidence on what is effectively a fault path, never a second
        fault)."""
        if self.root is None:
            return None
        key = str(scope)
        with self._lock:
            now = self._clock()
            last = self._last.get(key)
            if last is not None and now - last < self.cooldown_s:
                return None
            self._last[key] = now
            self._seq += 1
            seq = self._seq
        path = os.path.join(self.root, f"incident-{seq:06d}-{reason}")
        try:
            os.makedirs(path, exist_ok=True)
            flight_recorder.dump(reason, path=os.path.join(path, "flight.jsonl"))
            spans = []
            if trace_hex:
                try:
                    spans = trace_store.spans(trace_id=bytes.fromhex(trace_hex))
                except ValueError:
                    spans = []
            if not spans:
                # The breaching trace already aged out of the bounded
                # store (or none was bound): keep the whole store — a
                # partial causal picture beats an empty file.
                spans = trace_store.spans()
            doc = chrome_trace(spans)
            doc.setdefault("otherData", {})["incident"] = reason
            with open(os.path.join(path, "trace.json"), "w") as fh:
                json.dump(doc, fh)
            try:
                # Additive evidence: a failing attribution read must not
                # cost the flight/trace dumps already on disk.
                from .attribution import attribution_report

                with open(os.path.join(path, "profile.json"), "w") as fh:
                    json.dump(attribution_report(), fh, indent=2)
            except Exception:
                pass
            meta = {
                "reason": reason,
                "scope": key if scope is not None else None,
                "shard": shard,
                "trace_id": trace_hex,
                "latency_s": latency_s,
                "objective_s": objective_s,
                "spans": len(spans),
                "flight_events": len(flight_recorder),
                "wall_ts": time.time(),
            }
            if detail:
                meta["detail"] = detail
            with open(os.path.join(path, "incident.json"), "w") as fh:
                json.dump(meta, fh, indent=2)
            self._gc()
        except Exception:
            return None
        if self.counter is not None:
            self.counter.inc()
        return path

    def incidents(self) -> list[str]:
        """Sorted incident directory names currently on disk (oldest
        first — the capture sequence is embedded in the name)."""
        if self.root is None or not os.path.isdir(self.root):
            return []
        return sorted(
            d
            for d in os.listdir(self.root)
            if d.startswith("incident-")
            and os.path.isdir(os.path.join(self.root, d))
        )

    def _gc(self) -> None:
        names = self.incidents()
        for stale in names[: max(0, len(names) - self.max_incidents)]:
            shutil.rmtree(os.path.join(self.root, stale), ignore_errors=True)


class SloEngine:
    """Windowed decision-latency tracking + multi-window burn-rate alerts.

    ``observe`` is the one hot entry point (called once per *decision*,
    under the caller's engine lock): it files the latency into the
    global, per-shard, and per-scope windowed sketches, applies the
    scope's objective if one was declared, and evaluates the alert state
    machine. Scope trackers live in a bounded LRU (a churn bench mints
    millions of scopes; unbounded per-scope state would be a leak) —
    scopes with declared objectives are pinned and never evicted.

    ``enabled=False`` short-circuits ``observe`` before any lock — the
    kill switch the SLO-overhead A/B in ``bench.py`` flips."""

    def __init__(
        self,
        registry=None,
        *,
        clock=time.monotonic,
        fast_window: float = DEFAULT_FAST_WINDOW,
        slow_window: float = DEFAULT_SLOW_WINDOW,
        burn_threshold: float = DEFAULT_BURN_THRESHOLD,
        target_quantile: float = 0.99,
        slice_seconds: float = 10.0,
        max_scopes: int = 256,
        capture: IncidentCapture | None = None,
    ):
        if not 0.0 < target_quantile < 1.0:
            raise ValueError("target_quantile must be in (0, 1)")
        if fast_window >= slow_window:
            raise ValueError("fast_window must be shorter than slow_window")
        self.enabled = True
        self.fast_window = float(fast_window)
        self.slow_window = float(slow_window)
        self.burn_threshold = float(burn_threshold)
        self.target_quantile = float(target_quantile)
        # Error budget: the fraction of decisions ALLOWED over objective
        # (1% for a p99 objective). burn = breaching_fraction / budget.
        self.budget_fraction = 1.0 - target_quantile
        self.slice_seconds = float(slice_seconds)
        self.max_scopes = max_scopes
        self._clock = clock
        self._lock = threading.Lock()
        self._global = self._new_window()
        self._shards: dict[str, WindowedHistogram] = {}
        self._scopes: "OrderedDict[str, _ScopeTracker]" = OrderedDict()
        self.capture = capture
        self._registry = registry
        self._m_breaches = None
        self._m_alerts = None
        self._shard_gauges: set[str] = set()
        self._scope_gauges: set[str] = set()
        if registry is not None:
            self._m_breaches = registry.counter(SLO_BREACHES_TOTAL)
            self._m_alerts = registry.counter(SLO_ALERTS_TOTAL)
            registry.register_gauge(
                SLO_ALERTS_FIRING, self._alerts_firing_count, owner=self
            )
            registry.register_gauge(
                SLO_DECISION_P99_SECONDS,
                lambda: self._global_p99(),
                owner=self,
            )
            registry.register_gauge(
                SLO_BURN_RATE, lambda: self._max_burn(), owner=self
            )

    def _new_window(self) -> WindowedHistogram:
        return WindowedHistogram(
            DEFAULT_TIME_BUCKETS, self.slice_seconds, self.slow_window
        )

    # ── Hot path ───────────────────────────────────────────────────────

    def observe(
        self,
        scope,
        latency_s: float,
        *,
        shard: str | None = None,
        objective_s: float | None = None,
        trace_hex: str | None = None,
        now: float | None = None,
    ) -> None:
        """File one decision latency. ``objective_s`` is the scope's
        declared SLO threshold (``ScopeConfig.decide_p99_ms / 1000``) or
        None for best-effort scopes (tracked, never alerting)."""
        if not self.enabled:
            return
        if now is None:
            now = self._clock()
        key = str(scope)
        breaching = objective_s is not None and latency_s > objective_s
        fired = False
        with self._lock:
            self._global.observe(latency_s, now, breaching)
            if shard is not None:
                wh = self._shards.get(shard)
                if wh is None:
                    wh = self._shards.setdefault(shard, self._new_window())
                    self._install_shard_gauge(shard)
                wh.observe(latency_s, now, breaching)
            tracker = self._scopes.get(key)
            if tracker is None:
                tracker = _ScopeTracker(self._new_window())
                self._scopes[key] = tracker
                self._evict_scopes()
            else:
                self._scopes.move_to_end(key)
            if objective_s is not None:
                if tracker.objective_s is None:
                    self._install_scope_gauges(key)
                tracker.objective_s = objective_s
            tracker.window.observe(latency_s, now, breaching)
            if breaching:
                tracker.breaches += 1
                if self._m_breaches is not None:
                    self._m_breaches.inc()
            if tracker.objective_s is not None:
                fired = self._evaluate_alert(key, tracker, now)
        if self.capture is not None and (breaching or fired):
            self.capture.capture(
                "burn_rate_alert" if fired else "slo_breach",
                scope=scope,
                shard=shard,
                trace_hex=trace_hex,
                latency_s=latency_s,
                objective_s=objective_s,
            )

    def _evict_scopes(self) -> None:
        # Objective-carrying trackers are pinned: an operator declared an
        # SLO on them, so their alert state must survive scope churn.
        while len(self._scopes) > self.max_scopes:
            for key, tracker in self._scopes.items():
                if tracker.objective_s is None:
                    del self._scopes[key]
                    break
            else:
                break  # every tracker is pinned; accept the overshoot

    def _burn(self, tracker: _ScopeTracker, window: float, now: float) -> float:
        _, total, breaching = tracker.window.window_counts(window, now)
        if total == 0:
            return 0.0
        return (breaching / total) / self.budget_fraction

    def _evaluate_alert(
        self, key: str, tracker: _ScopeTracker, now: float
    ) -> bool:
        fast = self._burn(tracker, self.fast_window, now)
        if tracker.alert_firing:
            if fast < self.burn_threshold:
                tracker.alert_firing = False
                tracker.alert_since = None
            return False
        if fast < self.burn_threshold:
            return False
        slow = self._burn(tracker, self.slow_window, now)
        if slow < self.burn_threshold:
            return False
        tracker.alert_firing = True
        tracker.alert_since = now
        tracker.alerts_total += 1
        if self._m_alerts is not None:
            self._m_alerts.inc()
        return True

    # ── Gauges (scrape-time providers on labelled families) ────────────

    def _install_shard_gauge(self, shard: str) -> None:
        if self._registry is None or shard in self._shard_gauges:
            return
        self._shard_gauges.add(shard)
        name = f'{SLO_DECISION_P99_SECONDS}{{shard="{_escape(shard)}"}}'
        self._registry.register_gauge(
            name, lambda s=shard: self._shard_p99(s), owner=self
        )

    def _install_scope_gauges(self, key: str) -> None:
        # Only objective-carrying scopes get labelled families: those are
        # operator-declared and few; minting one per churned bench scope
        # would grow the registry without bound (families are permanent).
        if self._registry is None or key in self._scope_gauges:
            return
        self._scope_gauges.add(key)
        label = _escape(key)
        self._registry.register_gauge(
            f'{SLO_DECISION_P99_SECONDS}{{scope="{label}"}}',
            lambda k=key: self._scope_quantile(k),
            owner=self,
        )
        self._registry.register_gauge(
            f'{SLO_BURN_RATE}{{scope="{label}",window="fast"}}',
            lambda k=key: self._scope_burn(k, self.fast_window),
            owner=self,
        )
        self._registry.register_gauge(
            f'{SLO_BURN_RATE}{{scope="{label}",window="slow"}}',
            lambda k=key: self._scope_burn(k, self.slow_window),
            owner=self,
        )

    def _global_p99(self) -> float:
        with self._lock:
            return self._global.quantile(
                self.target_quantile, self.fast_window, self._clock()
            )

    def _shard_p99(self, shard: str) -> float:
        with self._lock:
            wh = self._shards.get(shard)
            if wh is None:
                return 0.0
            return wh.quantile(
                self.target_quantile, self.fast_window, self._clock()
            )

    def _scope_quantile(self, key: str) -> float:
        with self._lock:
            tracker = self._scopes.get(key)
            if tracker is None:
                return 0.0
            return tracker.window.quantile(
                self.target_quantile, self.fast_window, self._clock()
            )

    def observed_p99(self, scope, *, now: float | None = None) -> float:
        """Per-scope windowed decision-latency quantile in SECONDS (the
        engine's ``target_quantile`` over the fast window), 0.0 while the
        scope has no recent decisions. Public read for the adaptive
        consensus-timeout learner (:mod:`hashgraph_tpu_torch.engine.adaptive`),
        which decays a scope's learned timeout toward this observation."""
        with self._lock:
            tracker = self._scopes.get(str(scope))
            if tracker is None:
                return 0.0
            if now is None:
                now = self._clock()
            return tracker.window.quantile(
                self.target_quantile, self.fast_window, now
            )

    def _scope_burn(self, key: str, window: float) -> float:
        with self._lock:
            tracker = self._scopes.get(key)
            if tracker is None:
                return 0.0
            return self._burn(tracker, window, self._clock())

    def _alerts_firing_count(self) -> int:
        with self._lock:
            return sum(1 for t in self._scopes.values() if t.alert_firing)

    def _max_burn(self) -> float:
        with self._lock:
            now = self._clock()
            return max(
                (
                    self._burn(t, self.fast_window, now)
                    for t in self._scopes.values()
                    if t.objective_s is not None
                ),
                default=0.0,
            )

    # ── Readout ────────────────────────────────────────────────────────

    def state(self, now: float | None = None) -> dict:
        """Machine-readable SLO state — the ``/slo`` endpoint's body and
        the ``slo`` block ``OP_METRICS_PULL`` ships per host."""
        if now is None:
            now = self._clock()
        with self._lock:
            scopes = {}
            alerting = []
            for key, t in self._scopes.items():
                entry = t.window.summary(self.fast_window, now)
                entry["objective_s"] = t.objective_s
                entry["breaches_total"] = t.breaches
                if t.objective_s is not None:
                    entry["burn_fast"] = self._burn(t, self.fast_window, now)
                    entry["burn_slow"] = self._burn(t, self.slow_window, now)
                    entry["alert_firing"] = t.alert_firing
                    entry["alerts_total"] = t.alerts_total
                    if t.alert_firing:
                        alerting.append(key)
                scopes[key] = entry
            out = {
                "enabled": self.enabled,
                "windows": {
                    "fast_s": self.fast_window,
                    "slow_s": self.slow_window,
                },
                "burn_threshold": self.burn_threshold,
                "target_quantile": self.target_quantile,
                "global": self._global.summary(self.fast_window, now),
                "shards": {
                    sid: wh.summary(self.fast_window, now)
                    for sid, wh in self._shards.items()
                },
                "scopes": scopes,
                "alerts_firing": alerting,
            }
        if self.capture is not None:
            out["incidents"] = self.capture.incidents()
            out["incident_dir"] = self.capture.root
        return out

    def reset(self) -> None:
        """Drop every tracker (tests/bench reps; families persist)."""
        with self._lock:
            self._global = self._new_window()
            self._shards.clear()
            self._scopes.clear()
