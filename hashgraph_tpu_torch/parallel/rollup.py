"""Shared rollups: one summation for every aggregate surface.

``TorchConsensusEngine.occupancy()`` defines the per-engine capacity
snapshot (live/device/spilled counts plus the demoted-tier counters).
Fleet and federation both need the fleet-wide sum, and before this
helper each hand-summed its own key set — a new engine key (like the
tier counters) could silently go missing from one aggregate. Now the
key set lives here once: extend ``OCCUPANCY_SUM_KEYS`` and every
aggregate surface (fleet totals, the federation adapter, bench
rollups) carries the new counter automatically.

The same discipline applies to cross-host METRIC federation:
:func:`merge_metric_states` is the ONE merge for ``OP_METRICS_PULL``
frames — fleet-wide totals plus per-host labelled breakdowns in the
registry's export-state schema, renderable by
``obs.prometheus.render_state`` — used by the federation driver's merged
``/metrics`` view and ``bench.py``'s fleet reports alike. A second
hand-sum anywhere means a new family can silently go missing from one
surface; add behavior here instead.

A copy of the JAX package's ``parallel/rollup.py``: pure Python, no
device work.
"""

from __future__ import annotations

# Engine occupancy keys that sum meaningfully across shards/hosts.
# (voter_capacity deliberately excluded: it is a per-pool geometry, not
# an additive capacity.)
OCCUPANCY_SUM_KEYS = (
    "live_sessions",
    "device_slots_used",
    "host_spilled",
    "capacity",
    "tier_sessions",
    "tier_bytes",
    "tier_demotions_total",
    "tier_promotions_total",
    "tier_gc_total",
)


def aggregate_occupancy(entries) -> dict:
    """Sum per-shard ``occupancy()`` entries into one capacity view.

    Shards that are mid-recovery or mid-migration report no counts (their
    entries carry ``recovering``/``migrating`` flags instead); they are
    skipped and surfaced as ``unavailable_shards`` so a rollup that hides
    half the fleet says so.
    """
    out = {key: 0 for key in OCCUPANCY_SUM_KEYS}
    unavailable = 0
    for entry in entries:
        if entry.get("recovering") or entry.get("migrating"):
            unavailable += 1
            continue
        for key in OCCUPANCY_SUM_KEYS:
            out[key] += entry.get(key, 0)
    out["unavailable_shards"] = unavailable
    return out


# ── Cross-host metric federation ───────────────────────────────────────


def _escape_label(value: str) -> str:
    return (
        str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def with_label(name: str, key: str, value: str) -> str:
    """Insert ``key="value"`` into a (possibly pre-labelled) family name:
    ``f{a="b"}`` -> ``f{key="value",a="b"}``; ``f`` -> ``f{key="value"}``."""
    base, brace, rest = name.partition("{")
    label = f'{key}="{_escape_label(value)}"'
    if not brace:
        return f"{base}{{{label}}}"
    return f"{base}{{{label},{rest}"


def _merge_histograms(merged: dict, hist: dict) -> bool:
    """Sum ``hist`` into ``merged`` in place (export_state schema).
    Returns False — leaving ``merged`` untouched — when the bucket bounds
    disagree (two hosts on different builds); the per-host labelled
    series still carry the data, so nothing is lost, only un-summed."""
    if merged["bounds"] != hist["bounds"]:
        return False
    counts = merged["counts"]
    for i, c in enumerate(hist["counts"]):
        counts[i] += c
    merged["sum"] += hist["sum"]
    merged["count"] += hist["count"]
    for idx, ex in (hist.get("exemplars") or {}).items():
        # Keep the largest-valued exemplar per bucket: the outlier is the
        # trace a fleet-wide p99 investigation wants to open first.
        cur = merged["exemplars"].get(idx)
        if cur is None or ex[0] > cur[0]:
            merged["exemplars"][idx] = list(ex)
    return True


def merge_metric_states(frames) -> dict:
    """Merge ``OP_METRICS_PULL`` frames (``{"host": label, "state":
    <MetricsRegistry.export_state()>}``) into ONE registry-state dict:

    - every family appears re-labelled per host (``name{host="h1"}``),
      so a single scrape keeps the per-host breakdown;
    - counters/gauges/histograms additionally appear under their bare
      name as the fleet-wide sum (histograms only when every host agrees
      on bucket bounds);
    - infos stay per-host only — constant metadata does not sum.

    The result renders with ``obs.prometheus.render_state`` — the one
    merge + one renderer every fleet-wide surface (federation sidecar,
    ``bench.py`` fleet reports) goes through.
    """
    out = {"counters": {}, "gauges": {}, "histograms": {}, "infos": {}}
    skip_total: set = set()  # histogram families with mismatched bounds
    for frame in frames:
        host = str(frame.get("host", "unknown"))
        state = frame.get("state") or {}
        for kind in ("counters", "gauges"):
            for name, value in (state.get(kind) or {}).items():
                bucket = out[kind]
                bucket[with_label(name, "host", host)] = value
                bucket[name] = bucket.get(name, 0) + value
        for name, hist in (state.get("histograms") or {}).items():
            out["histograms"][with_label(name, "host", host)] = hist
            if name in skip_total:
                continue
            total = out["histograms"].get(name)
            if total is None:
                out["histograms"][name] = {
                    "bounds": list(hist["bounds"]),
                    "counts": list(hist["counts"]),
                    "sum": hist["sum"],
                    "count": hist["count"],
                    "exemplars": {
                        k: list(v)
                        for k, v in (hist.get("exemplars") or {}).items()
                    },
                }
            elif not _merge_histograms(total, hist):
                del out["histograms"][name]
                skip_total.add(name)
        for name, labels in (state.get("infos") or {}).items():
            out["infos"][with_label(name, "host", host)] = labels
    return out


def merge_slo_states(frames) -> dict:
    """Fleet ``/slo`` view from ``OP_METRICS_PULL`` frames: per-host SLO
    states keyed by host label, plus the fleet rollup a single pager
    needs — every firing alert as ``host/scope``, total windowed decision
    count, the worst per-host fast-window p99, and every incident dump.
    (True merged quantiles would need the raw windows, which stay
    host-local; the worst host's p99 is the conservative fleet answer.)"""
    hosts: dict = {}
    alerts: list = []
    incidents: list = []
    count = 0
    worst_p99 = 0.0
    for frame in frames:
        host = str(frame.get("host", "unknown"))
        slo = frame.get("slo") or {}
        hosts[host] = slo
        for scope in slo.get("alerts_firing", ()):  # noqa: B007
            alerts.append(f"{host}/{scope}")
        for inc in slo.get("incidents", ()):  # noqa: B007
            incidents.append(f"{host}/{inc}")
        overall = slo.get("global") or {}
        count += overall.get("count", 0)
        worst_p99 = max(worst_p99, overall.get("p99", 0.0))
    return {
        "hosts": hosts,
        "alerts_firing": alerts,
        "incidents": incidents,
        "global": {"count": count, "worst_p99": worst_p99},
    }


def merge_profile_states(frames) -> dict:
    """Fleet attribution view from ``OP_PROFILE`` frames (``{"host":
    label, "profile": <obs.attribution.attribution_report()>}``):
    per-host reports keyed by host label, plus the fleet rollup —
    per-stage busy seconds summed across hosts with shares recomputed
    over the fleet-wide denominator, device dispatch/row totals (and
    the fleet-wide amortization factor), and sample/role totals from
    every host's continuous profiler. The same discipline as
    :func:`merge_metric_states`: ONE merge, every fleet surface (the
    federation sidecar's ``/profile``, bench reports) goes through it."""
    from ..obs.attribution import STAGE_KEYS

    hosts: dict = {}
    seconds = {key: 0.0 for key in STAGE_KEYS}
    dispatches = 0.0
    apply_rows = 0.0
    wal_fsyncs = 0
    samples_total = 0
    samples_dropped = 0
    overhead_s = 0.0
    roles: dict = {}
    for frame in frames:
        host = str(frame.get("host", "unknown"))
        profile = frame.get("profile") or {}
        hosts[host] = profile
        for key, stage in (profile.get("stages") or {}).items():
            if key in seconds:
                seconds[key] += float(stage.get("seconds", 0.0))
        device = profile.get("device") or {}
        dispatches += float(device.get("dispatches", 0.0))
        apply_rows += float(device.get("apply_rows", 0.0))
        wal_fsyncs += int((profile.get("wal") or {}).get("fsyncs", 0))
        samples = profile.get("samples") or {}
        samples_total += int(samples.get("total", 0))
        samples_dropped += int(samples.get("dropped", 0))
        overhead_s += float(samples.get("overhead_seconds", 0.0))
        for role, n in (samples.get("roles") or {}).items():
            roles[role] = roles.get(role, 0) + int(n)
    busy = sum(seconds.values())
    return {
        "schema": "hashgraph.attribution.v1",
        "hosts": hosts,
        "busy_seconds": round(busy, 6),
        "stages": {
            key: {
                "seconds": round(seconds[key], 6),
                "share": round(seconds[key] / busy, 4) if busy else 0.0,
            }
            for key in STAGE_KEYS
        },
        "device": {
            "dispatches": dispatches,
            "apply_rows": apply_rows,
            "votes_per_dispatch": (
                round(apply_rows / dispatches, 2) if dispatches else 0.0
            ),
        },
        "wal": {"fsyncs": wal_fsyncs},
        "samples": {
            "total": samples_total,
            "dropped": samples_dropped,
            "overhead_seconds": round(overhead_s, 6),
            "roles": dict(sorted(roles.items())),
        },
    }
