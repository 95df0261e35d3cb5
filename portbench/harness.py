"""What every cell shares: finding its files by name, the profiler's
reading of the device, and the import guard.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: it names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); the traffic names its driver
(``drivers/<driver>.py``). A per-layer metric is read by
``layer_metrics/<metric>.py``. Adding any of them is adding files and
entries.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

# Top-level module names that the port's run must never load.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "hashgraph_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(BENCHMARK)


def cell(name: str) -> "tuple[dict, dict, dict]":
    """The workload entry of ``name``, its configuration and its traffic."""
    spec = benchmark()
    for entry in spec["workloads"]:
        if entry["name"] == name:
            config = load_json(HERE / "configs" / f"{entry['config']}.json")
            traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
            return entry, config, traffic
    raise SystemExit(f"no workload named {name!r} in {BENCHMARK.name}")


def metrics_of(name: str, traced: bool) -> "list[dict]":
    """The metrics that cell ``name`` reports: with ``traced`` its per-layer
    metrics, else its end-to-end ones. A metric without ``workloads``
    belongs to every cell."""
    spec = benchmark()
    group = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def load_module(path: Path):
    """A driver or a metric reader, by its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_loaded() -> "list[str]":
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN_MODULES})


@dataclass
class Ctx:
    """What a driver is given."""

    name: str
    config: dict
    traffic: dict
    seed: int
    device: str = "cuda"
    trace: bool = False
    signer_class: object = None         # None: the traffic's signer


def log_calls(label: str, records: "list[dict]") -> None:
    """Calls on standard error: each one's seconds, each span's and each
    verification phase's seconds, and each span's sum."""
    if not records:
        return
    totals: "dict[str, float]" = {}
    for r in records:
        for name, sec in r["spans"].items():
            totals[name] = totals.get(name, 0.0) + sec
    log(f"[{label}] seconds " + " ".join(f"{sum(r['spans'].values()):.4f}" for r in records))
    for name in sorted({k for r in records for k in r["spans"]}):
        log(f"[{label}] {name} " + " ".join(f"{r['spans'].get(name, 0.0):.4f}" for r in records))
    for name in sorted({k for r in records for k in r.get("phases", {})}):
        log(f"[{label}] phase.{name} "
            + " ".join(f"{r.get('phases', {}).get(name, 0.0):.4f}" for r in records))
    log(f"[{label}] ok " + " ".join(str(r.get("ok", 0)) for r in records))
    log(f"[{label}] spans " + " ".join(f"{k} {v:.4f}" for k, v in sorted(totals.items())))


def quantile(values, q: float) -> float:
    """The ``q`` quantile by linear interpolation between order statistics
    (NumPy's default), of every value given."""
    import numpy as np

    return float(np.quantile(np.asarray(values, np.float64), q))


# ── The device profile ──────────────────────────────────────────────────

CALL_SPAN = "portbench.call"


class DeviceProfile:
    """``torch.profiler`` over some calls of the traced run. Each call runs
    inside a ``portbench.call`` range; the stretch from the first call's
    start to the last call's end is the traced window."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        return False

    def summary(self, top: int = 10) -> dict:
        """Kernel sums by name, launches, busy and window seconds, and the
        longest idle gaps named by the benchmark's range that held them."""
        device, ranges = [], []
        for ev in self._prof.profiler.kineto_results.events():
            kind = ev.device_type().name if hasattr(ev.device_type(), "name") else str(ev.device_type())
            start, dur = ev.start_ns(), ev.duration_ns()
            if ev.name().startswith("portbench."):
                # The benchmark's ranges; the profiler also mirrors them onto
                # the device's timeline, which is not device work.
                if "CUDA" not in kind:
                    ranges.append((start, start + dur, ev.name()))
            elif "CUDA" in kind:
                device.append((start, start + dur, ev.name()))
        calls = [r for r in ranges if r[2] == CALL_SPAN]
        if not calls or not device:
            return {}
        lo = min(r[0] for r in calls)
        hi = max(r[1] for r in calls)
        kernels: "dict[str, list]" = {}
        launches = 0
        for start, end, name in device:
            if not name.startswith(("Memcpy", "Memset")):
                launches += 1
            entry = kernels.setdefault(name, [0, 0.0])
            entry[0] += 1
            entry[1] += (end - start) / 1e9
        # Busy: the union of device intervals inside the stretch.
        busy = 0
        gaps = []
        cursor = lo
        for start, end, _ in sorted(device):
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            if start > cursor:
                gaps.append((start - cursor, cursor, start))
            if end > cursor:
                busy += end - max(start, cursor)
                cursor = end
        if hi > cursor:
            gaps.append((hi - cursor, cursor, hi))
        gaps.sort(reverse=True)
        named = []
        inner = [r for r in ranges if r[2] != CALL_SPAN]
        for length, start, end in gaps[:top]:
            mid = (start + end) // 2
            holders = [r for r in inner if r[0] <= mid <= r[1]]
            label = min(holders, key=lambda r: r[1] - r[0])[2] if holders else "between calls"
            named.append([label, length / 1e9])
        ops = sorted(([k[:160], v[1]] for k, v in kernels.items()), key=lambda kv: -kv[1])
        return {
            "kernels": kernels,
            "launches": launches,
            "busy_s": busy / 1e9,
            "window_s": (hi - lo) / 1e9,
            "device_ops": ops[:top],
            "idle_gaps": named,
        }


def warm_profiler() -> None:
    """Start and stop the profiler once around one device operation, so
    that its first start (the device tracer's set-up) falls in set-up."""
    import torch

    with DeviceProfile():
        if torch.cuda.is_available():
            torch.ones(1, device="cuda").sum().item()


class Spans:
    """The benchmark's own spans around each layer it calls: seconds by name
    for every call, and, in a traced run, the same ranges in the profile."""

    def __init__(self, profiled: bool = False):
        self.profiled = profiled
        self.calls: "list[dict]" = []

    def new_call(self, **info) -> dict:
        record = {"spans": {}, **info}
        self.calls.append(record)
        return record

    def span(self, record: dict, name: str):
        return _Span(self, record, name)

    def call(self):
        """The profile's range around one whole call (nothing when the
        calls are not profiled)."""
        if not self.profiled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(CALL_SPAN)


class _Span:
    def __init__(self, owner: Spans, record: dict, name: str):
        self.owner, self.record, self.name = owner, record, name
        self._rf = None

    def __enter__(self):
        if self.owner.profiled:
            import torch

            self._rf = torch.profiler.record_function("portbench." + self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        elapsed = time.perf_counter() - self.t0
        spans = self.record["spans"]
        spans[self.name] = spans.get(self.name, 0.0) + elapsed
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False
