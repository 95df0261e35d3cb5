"""MetricsRegistry: always-on counters, gauges, and log-bucketed histograms.

The tracer (:mod:`hashgraph_tpu_torch.tracing`) answers "what happened in this
run" — it is off by default and accumulates unbounded span lists for
offline analysis. This registry answers the production questions a consensus
service gets asked continuously ("what is p99 decision latency", "how many
WAL segments exist right now") and is therefore ALWAYS on, with bounded
state (a histogram is a fixed bucket array) and per-instrument cost small
enough for hot paths that run once per *batch* (never per vote):

- :class:`Counter` — monotonically increasing int, one lock-protected add;
- :class:`Gauge` — last-set value and/or registered provider callables
  (weakly referenced, so a dead engine's gauges vanish instead of freezing
  at their last value); multiple providers sum, which is what you want when
  several engines/WAL writers coexist in one process;
- :class:`Histogram` — log-spaced bucket bounds chosen at construction
  (``log_buckets``), observation is one bisect + one add under a lock;
  quantiles are estimated by log-linear interpolation inside the bucket.

Families are created lazily on first use and live for the process; name
them like Prometheus families (``wal_fsync_seconds``,
``hashgraph_decision_latency_seconds``) because
:mod:`hashgraph_tpu_torch.obs.prometheus` renders them verbatim.
"""

from __future__ import annotations

import math
import threading
import time
import weakref
from bisect import bisect_left


def quantile_from(
    bounds: tuple[float, ...], counts: list[int], total: int, q: float
) -> float:
    """Estimate the q-quantile (0 < q < 1) of a log-bucketed count vector
    by log-linear interpolation within the containing bucket. 0.0 when
    empty; the last finite bound when the quantile falls in the +Inf
    bucket. Shared by :class:`Histogram` and the SLO engine's windowed
    sketches (:mod:`hashgraph_tpu_torch.obs.slo`), which reuse these buckets."""
    if total == 0:
        return 0.0
    rank = q * total
    running = 0.0
    for i, n in enumerate(counts):
        if n == 0:
            continue
        if running + n >= rank:
            if i >= len(bounds):
                return bounds[-1]
            hi = bounds[i]
            lo = bounds[i - 1] if i > 0 else hi / 2.0
            frac = (rank - running) / n
            # Interpolate in log space — the buckets are log-spaced.
            return math.exp(
                math.log(lo) + frac * (math.log(hi) - math.log(lo))
            )
        running += n
    return bounds[-1]


def log_buckets(lo: float, hi: float, factor: float = 2.0) -> tuple[float, ...]:
    """Geometric bucket upper bounds from ``lo`` until ``hi`` is covered.
    The implicit final bucket is +Inf (everything above the last bound)."""
    if lo <= 0 or hi <= lo or factor <= 1.0:
        raise ValueError("need 0 < lo < hi and factor > 1")
    bounds = [lo]
    while bounds[-1] < hi:
        bounds.append(bounds[-1] * factor)
    return tuple(bounds)


class Counter:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Point-in-time value. ``set`` stores a number; ``add_provider``
    registers a zero-arg callable sampled at read time (weakly referenced
    through ``owner`` when given, so the provider dies with its component).
    ``value`` is the stored number plus every live provider's sample —
    summation across providers is the aggregate a process-wide scrape
    wants (total live proposals across all engines, total WAL bytes across
    all writers)."""

    __slots__ = ("name", "_value", "_providers", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._providers: list = []  # (weakref-to-owner-or-None, fn)
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        self._value = float(value)

    def add_provider(self, fn, owner=None) -> "GaugeHandle":
        ref = weakref.ref(owner) if owner is not None else None
        entry = (ref, fn)
        with self._lock:
            self._providers.append(entry)
        return GaugeHandle(self, entry)

    def _remove(self, entry) -> None:
        with self._lock:
            try:
                self._providers.remove(entry)
            except ValueError:
                pass

    @property
    def value(self) -> float:
        total = self._value
        dead = []
        with self._lock:
            providers = list(self._providers)
        for entry in providers:
            ref, fn = entry
            if ref is not None and ref() is None:
                dead.append(entry)
                continue
            try:
                total += float(fn())
            except Exception:
                # A provider raising (component mid-teardown) must not
                # poison the whole scrape.
                continue
        for entry in dead:
            self._remove(entry)
        return total


class Info:
    """Constant metadata family rendered as a labelled gauge with value 1
    (the Prometheus ``*_build_info`` convention). Label values may be
    strings or zero-arg callables — callables resolve at read time, so a
    label like the JAX runtime backend can be named lazily without the
    metrics layer forcing the runtime up."""

    __slots__ = ("name", "_labels", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._labels: dict[str, object] = {}
        self._lock = threading.Lock()

    def set(self, **labels) -> None:
        with self._lock:
            self._labels.update(labels)

    def labels(self) -> dict[str, str]:
        """Resolved label set (callables invoked; a raising provider
        yields ``"error"`` rather than poisoning the scrape)."""
        with self._lock:
            items = list(self._labels.items())
        out: dict[str, str] = {}
        for key, value in items:
            if callable(value):
                try:
                    value = value()
                except Exception:
                    value = "error"
            out[key] = str(value)
        return out


class GaugeHandle:
    """Unregistration token for one gauge provider (components with an
    explicit close(), e.g. WalWriter, unregister there instead of waiting
    for GC)."""

    __slots__ = ("_gauge", "_entry")

    def __init__(self, gauge: Gauge, entry):
        self._gauge = gauge
        self._entry = entry

    def unregister(self) -> None:
        self._gauge._remove(self._entry)


# Default bounds: wide enough for microsecond fsyncs up to minute-scale
# decision latencies; 2x spacing keeps quantile error under ~41%-of-value
# worst case, plenty for dashboards and regression gates.
DEFAULT_TIME_BUCKETS = log_buckets(1e-6, 128.0)  # seconds
DEFAULT_SIZE_BUCKETS = log_buckets(1.0, 32 * 1024 * 1024)  # counts/bytes


class Histogram:
    """Fixed log-bucketed histogram. ``observe`` is one bisect + two adds
    under the instrument lock; there is no per-observation allocation.

    An observation may carry an OpenMetrics-style *exemplar* — a trace id
    correlating that one sample with its distributed trace. One exemplar
    is kept per bucket (latest wins), so a scrape can always link each
    latency band to a concrete causal trace; storage stays bounded at one
    small tuple per bucket, allocated lazily on the first exemplar."""

    __slots__ = ("name", "bounds", "_counts", "_sum", "_count", "_lock",
                 "_exemplars")

    def __init__(self, name: str, bounds: tuple[float, ...] = DEFAULT_TIME_BUCKETS):
        if not bounds or any(
            b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])
        ):
            raise ValueError("bucket bounds must be strictly increasing")
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()
        self._exemplars: dict[int, tuple[float, str, float]] | None = None

    def observe(self, value: float, exemplar: "str | None" = None) -> None:
        idx = bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if exemplar is not None:
                if self._exemplars is None:
                    self._exemplars = {}
                self._exemplars[idx] = (float(value), exemplar, time.time())

    def exemplars(self) -> dict[int, tuple[float, str, float]]:
        """Per-bucket-index {idx: (value, trace_id, unix_ts)} — the latest
        exemplar observed into each bucket (empty until one is recorded)."""
        with self._lock:
            return dict(self._exemplars) if self._exemplars else {}

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def buckets(self) -> list[tuple[float, int]]:
        """CUMULATIVE (upper_bound, count) pairs, +Inf last — the
        Prometheus exposition shape."""
        return self.exposition()[0]

    def exposition(self) -> tuple[list[tuple[float, int]], float, int]:
        """(cumulative buckets, sum, count) from ONE locked copy, so a
        render never shows an +Inf bucket disagreeing with _count (the
        text format requires them equal)."""
        with self._lock:
            counts = list(self._counts)
            s, total = self._sum, self._count
        out = []
        running = 0
        for bound, n in zip(self.bounds, counts):
            running += n
            out.append((bound, running))
        out.append((math.inf, running + counts[-1]))
        return out, s, total

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0 < q < 1) by log-linear interpolation
        within the containing bucket. 0.0 when empty; the last finite bound
        when the quantile falls in the +Inf bucket."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        return self._quantile_from(counts, total, q)

    def _quantile_from(self, counts: list[int], total: int, q: float) -> float:
        return quantile_from(self.bounds, counts, total, q)

    def snapshot(self) -> dict:
        # ONE locked copy: count/sum and every quantile must describe the
        # same moment even while observers keep writing.
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        return {
            "count": total,
            "sum": s,
            "p50": self._quantile_from(counts, total, 0.5),
            "p90": self._quantile_from(counts, total, 0.9),
            "p99": self._quantile_from(counts, total, 0.99),
        }

    def export_state(self) -> dict:
        """Raw mergeable state (NON-cumulative per-bucket counts, bounds,
        sum, count, exemplars keyed by bucket index as strings) — the
        JSON-able shape ``OP_METRICS_PULL`` ships and
        ``parallel.rollup.merge_metric_states`` sums across hosts."""
        with self._lock:
            counts = list(self._counts)
            s, total = self._sum, self._count
            ex = dict(self._exemplars) if self._exemplars else {}
        return {
            "bounds": list(self.bounds),
            "counts": counts,
            "sum": s,
            "count": total,
            "exemplars": {str(i): list(v) for i, v in ex.items()},
        }


class MetricsRegistry:
    """Process-wide instrument directory. Families are created on first
    access and never removed (a scrape must see stable families); all
    accessors are thread-safe and idempotent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._infos: dict[str, Info] = {}

    # ── Family access ──────────────────────────────────────────────────

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(
        self, name: str, bounds: tuple[float, ...] | None = None
    ) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.get(name)
                if h is None:
                    h = Histogram(
                        name, bounds if bounds is not None else DEFAULT_TIME_BUCKETS
                    )
                    self._histograms[name] = h
                    return h
        if bounds is not None and tuple(float(b) for b in bounds) != h.bounds:
            # Silently handing back an instrument with other buckets would
            # put observations in the wrong places with no error anywhere.
            raise ValueError(
                f"histogram {name!r} already exists with different bucket "
                f"bounds; a family's buckets are fixed at first creation"
            )
        return h

    def info(self, name: str) -> Info:
        i = self._infos.get(name)
        if i is None:
            with self._lock:
                i = self._infos.setdefault(name, Info(name))
        return i

    def register_gauge(self, name: str, fn, owner=None) -> GaugeHandle:
        """Attach a sampled-at-read provider to ``name`` (see
        :meth:`Gauge.add_provider`)."""
        return self.gauge(name).add_provider(fn, owner=owner)

    # ── Readout ────────────────────────────────────────────────────────

    def snapshot(self) -> dict:
        """JSON-ready state: counter values, gauge samples, histogram
        count/sum/quantiles. This is what ``bench.py --metrics-out``
        persists next to the throughput numbers."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            histograms = list(self._histograms.values())
            infos = list(self._infos.values())
        return {
            "counters": {c.name: c.value for c in counters},
            "gauges": {g.name: g.value for g in gauges},
            "histograms": {h.name: h.snapshot() for h in histograms},
            "infos": {i.name: i.labels() for i in infos},
        }

    def export_state(self) -> dict:
        """One JSON-able frame of the whole registry: counter values,
        sampled gauge values, raw (mergeable) histogram buckets with
        exemplars, resolved info labels. This is what the bridge's
        ``OP_METRICS_PULL`` ships and what
        ``parallel.rollup.merge_metric_states`` merges into a fleet-wide
        view — unlike :meth:`snapshot`, nothing is pre-aggregated into
        quantiles, so sums across hosts stay exact."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            histograms = list(self._histograms.values())
            infos = list(self._infos.values())
        return {
            "counters": {c.name: c.value for c in counters},
            "gauges": {g.name: g.value for g in gauges},
            "histograms": {h.name: h.export_state() for h in histograms},
            "infos": {i.name: i.labels() for i in infos},
        }

    def render_prometheus(self) -> str:
        from .prometheus import render

        return render(self)

    def reset(self) -> None:
        """Drop every family (tests only — production families should live
        for the process)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._infos.clear()
