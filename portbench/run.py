"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; the traffic names the driver that makes the inputs from the
seed and runs the window. Set-up (inputs, the node, the ramp to the steady
state, which builds and warms every kernel) counts as ``setup_s``. Then
the window runs for ``--seconds``; then the node's answers are read, the
node is let go, and the plain reference works the same inputs out again.
``correct`` is true when no answer differs.

With ``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read by
``layer_metrics/<metric>.py`` from the run's spans and the profile of the
window's first calls, and ``breakdown``. The numbers compared, each with
its limit, are the last lines on standard error and the result's last key.

It runs on the card it is started on and nowhere else: without CUDA, or
with fewer cards than the cell asks for, it exits 2 and prints no result.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# One process, few threads: no library's own thread pool competes with the
# node's host loop for the cores.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


def since_start() -> float:
    """Seconds since this process started (its interpreter's start
    included, as the kernel records it), else since this module loaded."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _START


def power_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


class GcClock:
    """The collector's passes while it is on: how many, of the oldest
    generation how many, and their seconds."""

    def __init__(self):
        self.count = self.oldest = 0
        self.seconds = 0.0
        self._t0 = 0.0

    def _note(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.count += 1
            self.oldest += info.get("generation") == 2
            self.seconds += time.perf_counter() - self._t0

    def __enter__(self):
        gc.callbacks.append(self._note)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._note)
        return False


def run(name: str, config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", signer_class=None) -> dict:
    """One run; returns the result line's object. ``device="cpu"`` and
    ``signer_class`` serve the tests, which drive a run on the CPU at a toy
    size."""
    import torch

    from portbench import check, harness
    from portbench.harness import Ctx, Spans, log

    torch.set_num_threads(1)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ctx = Ctx(name=name, config=config, traffic=traffic, seed=seed, device=device,
              trace=trace, signer_class=signer_class)
    driver = harness.load_module(harness.HERE / "drivers" / f"{traffic['driver']}.py").Driver(ctx)
    driver.setup()
    # The benchmark's own inputs stay out of the collector's way: what the
    # program allocates from here on is collected as usual.
    gc.collect()
    gc.freeze()
    if trace:
        driver.engine.tracer.enable()
    if cuda:
        torch.cuda.synchronize()
    setup_s = since_start()
    cpu = time.process_time()
    spans = Spans()
    with GcClock() as gc_clock:
        window = driver.window(seconds, spans, int(traffic.get("profile_calls", 4)) if trace else 0)
    log(f"[host] window: process CPU {time.process_time() - cpu:.3f} s; collector "
        f"{gc_clock.count} passes ({gc_clock.oldest} of the oldest generation) "
        f"{gc_clock.seconds:.3f} s; {len(os.sched_getaffinity(0))} CPUs")
    counters = driver.engine.tracer.counters() if trace else {}
    if trace:
        driver.engine.tracer.disable()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = driver.end_to_end(window)
    harness.log_calls("calls", spans.calls)
    log(f"[window] {window['calls']} calls, {window['rows']} rows, {window['ok']} accepted "
        f"in {window['seconds']:.6f} s; setup {setup_s:.6f} s; peak {peak} bytes")
    driver.finish()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    want = driver.reference()
    counts, failed = check.compare(driver.answers.reading(), want, driver.follow, driver.handed)
    checked = sum(sum(1 for s in want.votes[c] if s is not None) for c in driver.handed)
    log(f"[reference] {time.perf_counter() - t_ref:.3f} s; {int(driver.follow.sum())} of "
        f"{len(driver.follow)} sessions followed, {checked} window rows checked")

    metrics = {}
    breakdown = None
    if trace:
        profile = getattr(driver, "profile", None) or {}
        t = {
            "cell": name, "window": window, "calls": spans.calls, "profile": profile,
            "counters": counters, "inputs": _inputs(driver, want, profile.get("calls", [])),
            "latencies_s": list(driver.answers.latencies_s),
        }
        for m in harness.metrics_of(name, traced=True):
            value = harness.load_module(harness.HERE / "layer_metrics" / f"{m['name']}.py").read(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if "device_ops" in profile:
            breakdown = {"device_ops": profile["device_ops"], "idle_gaps": profile["idle_gaps"]}
    else:
        for m in harness.metrics_of(name, traced=False):
            value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    for key, value in e2e.items():
        log(f"[e2e] {key} {value}")

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace and "busy_s" in (getattr(driver, "profile", None) or {}):
        dev["busy_s"] = driver.profile["busy_s"]
        dev["window_s"] = driver.profile["window_s"]
    result = {
        "correct": check.verdict(counts),
        "attempted": int(window["rows"]),
        "failed": int(failed),
        "metrics": metrics,
        "device": dev,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in counts.items()}
    return result


def _inputs(driver, want, calls) -> "list[dict]":
    """For each profiled call, the work its inputs need: the signatures no
    earlier frame carried and, where the reference answered every row, the
    sessions and votes that reach the pool and the votes applied."""
    from portbench.reference import engine as ref

    pool_codes = {ref.OK, ref.ALREADY_REACHED, ref.SESSION_NOT_ACTIVE, ref.PROPOSAL_EXPIRED,
                  ref.MAX_ROUNDS_EXCEEDED, ref.DUPLICATE_VOTE}
    sched = driver.sched
    out = []
    for c in calls:
        sl = sched.rows(c)
        item = {"rows": sl.stop - sl.start,
                "fresh_signatures": int((~sched.row_redelivered[sl]).sum())}
        got = want.votes.get(c, [])
        if got and all(s is not None for s in got):
            rows_p = sched.row_p[sl]
            reach = [i for i, s in enumerate(got) if s in pool_codes]
            item.update(sessions=len({int(rows_p[i]) for i in reach}), votes=len(reach),
                        applied=sum(1 for s in got if s == ref.OK))
        out.append(item)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    from portbench import harness

    entry, config, traffic = harness.cell(args.workload)
    try:
        import torch
    except ImportError as exc:
        harness.log(f"no PyTorch: {exc}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        harness.log(f"{entry['name']} needs {entry['chips']} CUDA device(s); "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2
    try:
        import hashgraph_tpu_torch  # noqa: F401
    except ImportError as exc:
        harness.log(f"the program is not here: {exc}")
        return 2
    harness.log(f"[device] {power_line()}")
    result = run(entry["name"], config, traffic, args.seed, args.seconds, bool(args.trace))
    loaded = harness.forbidden_loaded()
    if loaded:
        harness.log(f"modules of the JAX package or of JAX were loaded: {', '.join(loaded)}")
        return 3
    for key, item in result["checks"].items():
        harness.log(f"check {key} {item['value']} limit {item['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
