"""AttributionReport — the round-11/19 busy-share math as a readout.

Round 11 found "device-apply is 66.8% of server busy time" and round 19
attacked it down to 50.9% — but both numbers were ad-hoc counter
arithmetic inside ``bench.py``. This module makes the per-component
wall-clock attribution a first-class, machine-readable report any
operator (or incident bundle) can pull:

- the wire-path stage counters
  (``hashgraph_bridge_wire_{decode,crypto,apply}_seconds_total``),
- the WAL fsync histogram (``wal_fsync_seconds`` sum/count),
- the reactor window/dispatch counters (fused dispatches, rows,
  flush-reason breakdown),
- and the continuous profiler's sampled per-role stack counts,

fused into one ``{"stages": {name: {"seconds", "share"}}}`` body whose
shares sum to 1.0 over the instrumented busy time. The report is served
three ways (same body each time): the ``OP_PROFILE`` bridge opcode, the
sidecar's ``/profile`` endpoint, and ``IncidentCapture``'s
``profile.json``; ``parallel.rollup.merge_profile_states`` federates
host-labelled reports into one fleet view.

``report_from_stage_totals`` accepts a bench ``stage_totals`` block
(the BENCH_*.json schema) so the BENCH_r19 device-apply share is
reproducible from the checked-in artifact — an acceptance test, not a
coincidence: both paths share ``_build_report``.
"""

from __future__ import annotations

ATTRIBUTION_SCHEMA = "hashgraph.attribution.v1"

# Instrumented busy-time components, in pipeline order. ``wal_fsync``
# rides the histogram rather than a *_seconds_total counter; everything
# shares one denominator so the shares are comparable across rounds.
STAGE_KEYS = ("wire_decode", "crypto", "device_apply", "wal_fsync")

_STAGE_COUNTERS = {
    "hashgraph_bridge_wire_decode_seconds_total": "wire_decode",
    "hashgraph_bridge_wire_crypto_seconds_total": "crypto",
    "hashgraph_bridge_wire_apply_seconds_total": "device_apply",
}
_WAL_FSYNC_HISTOGRAM = "wal_fsync_seconds"
_DISPATCHES = "hashgraph_bridge_wire_device_dispatches_total"
_APPLY_ROWS = "hashgraph_bridge_wire_apply_rows_total"
_REACTOR_COUNTERS = {
    "hashgraph_reactor_windows_total": "windows",
    "hashgraph_reactor_rows_total": "rows",
    "hashgraph_reactor_flush_rows_total": "flush_rows",
    "hashgraph_reactor_flush_bytes_total": "flush_bytes",
    "hashgraph_reactor_flush_deadline_total": "flush_deadline",
    "hashgraph_reactor_flush_now_change_total": "flush_now_change",
    "hashgraph_reactor_flush_forced_total": "flush_forced",
}


def _build_report(
    seconds: dict,
    *,
    dispatches: float = 0.0,
    apply_rows: float = 0.0,
    wal_fsyncs: int = 0,
    reactor: dict | None = None,
    samples: dict | None = None,
) -> dict:
    busy = sum(seconds.values())
    stages = {
        key: {
            "seconds": round(seconds.get(key, 0.0), 6),
            "share": round(seconds.get(key, 0.0) / busy, 4) if busy else 0.0,
        }
        for key in STAGE_KEYS
    }
    report = {
        "schema": ATTRIBUTION_SCHEMA,
        "busy_seconds": round(busy, 6),
        "stages": stages,
        "device": {
            "dispatches": dispatches,
            "apply_rows": apply_rows,
            # The round-19 amortization factor, measured not asserted.
            "votes_per_dispatch": (
                round(apply_rows / dispatches, 2) if dispatches else 0.0
            ),
        },
        "wal": {"fsyncs": wal_fsyncs},
    }
    if reactor is not None:
        report["reactor"] = reactor
    if samples is not None:
        report["samples"] = samples
    return report


def attribution_report(state: dict | None = None, profiler=None) -> dict:
    """The live process's attribution report. ``state`` defaults to the
    process registry's ``export_state()``; ``profiler`` defaults to the
    process-wide :data:`~hashgraph_tpu_torch.obs.default_profiler` (its sample
    summary is included only when it has actually sampled — an idle
    profiler must not imply an empty profile means an idle process)."""
    if state is None:
        from hashgraph_tpu_torch.obs import registry

        state = registry.export_state()
    counters = state.get("counters") or {}
    histograms = state.get("histograms") or {}

    seconds = {key: 0.0 for key in STAGE_KEYS}
    for family, key in _STAGE_COUNTERS.items():
        seconds[key] = float(counters.get(family, 0.0))
    wal_fsyncs = 0
    wal = histograms.get(_WAL_FSYNC_HISTOGRAM)
    if wal:
        seconds["wal_fsync"] = float(wal.get("sum", 0.0))
        wal_fsyncs = int(wal.get("count", 0))

    reactor = {
        key: float(counters.get(family, 0.0))
        for family, key in _REACTOR_COUNTERS.items()
    }

    if profiler is None:
        from hashgraph_tpu_torch.obs import default_profiler

        profiler = default_profiler
    samples = None
    snap = profiler.snapshot() if profiler is not None else None
    if snap is not None and snap["samples"]:
        samples = {
            "total": snap["samples"],
            "dropped": snap["dropped"],
            "rate_hz": snap["rate_hz"],
            "overhead_seconds": snap["overhead_seconds"],
            "roles": snap["roles"],
        }

    return _build_report(
        seconds,
        dispatches=float(counters.get(_DISPATCHES, 0.0)),
        apply_rows=float(counters.get(_APPLY_ROWS, 0.0)),
        wal_fsyncs=wal_fsyncs,
        reactor=reactor,
        samples=samples,
    )


def report_from_stage_totals(totals: dict) -> dict:
    """Attribution report from a bench ``stage_totals`` block (the
    BENCH_*.json schema: ``wire_decode_s / crypto_s / device_apply_s``
    plus ``device_dispatches / apply_rows``). Shares from this path are
    formula-identical to the bench's ``apply_share`` — the BENCH_r19
    reproduction test holds the two to the same number."""
    seconds = {
        "wire_decode": float(totals.get("wire_decode_s", 0.0)),
        "crypto": float(totals.get("crypto_s", 0.0)),
        "device_apply": float(totals.get("device_apply_s", 0.0)),
        "wal_fsync": float(totals.get("wal_fsync_s", 0.0)),
    }
    return _build_report(
        seconds,
        dispatches=float(totals.get("device_dispatches", 0.0)),
        apply_rows=float(totals.get("apply_rows", 0.0)),
    )
