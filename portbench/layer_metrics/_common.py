"""Helpers the per-layer readers share. ``t`` is the traced run's record:
``calls`` (one dict a call of the window: its rows, the benchmark's spans,
the program's ``stages`` and verification ``phases``), ``profile`` (the
device profile of the window's first calls; empty when there is none) and
``inputs`` (the work each profiled call's inputs need)."""


def unprofiled(t: dict) -> "list[dict]":
    """The timed window's calls, which ran after the profiled ones and
    without the profiler, so that it did not slow their host times."""
    profiled = set(t["profile"].get("calls", []))
    return [r for r in t["calls"] if r["call"] not in profiled]


def ms_per_kvote(records: "list[dict]", seconds_of) -> "float | None":
    """Milliseconds a thousand rows handed, of the seconds ``seconds_of``
    reads from each call's record (None where a call has none)."""
    rows, seconds = 0, 0.0
    for r in records:
        got = seconds_of(r)
        if got is None:
            continue
        rows += r["rows"]
        seconds += got
    return seconds * 1e3 / (rows / 1e3) if rows else None


def kernel_seconds(t: dict, fragment: str) -> "float | None":
    kernels = t["profile"].get("kernels", {})
    found = [v[1] for name, v in kernels.items() if fragment in name]
    return sum(found) if found else None


def idle_pct(t: dict) -> "float | None":
    prof = t["profile"]
    if not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
