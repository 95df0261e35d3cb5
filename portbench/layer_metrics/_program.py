"""Helpers of the readers of the program's own spans: the records of the
process-wide tracer (``hashgraph_tpu_torch.tracing.tracer``, the engine's
default, which ``run.py`` turns on for the traced run's window) in the
timed window.

The window's records are those that start at or after the n-th-from-last
record of ``opening``, the span that opens each call, where n is the
number of the window's calls; the profiled calls ran before them. A
program without the span, or a run without enough of them, gives None."""

from portbench.layer_metrics._common import unprofiled


def _tracer():
    from hashgraph_tpu_torch.tracing import tracer

    return tracer


def window_start(t: dict, opening: str) -> "float | None":
    """The start, on the tracer's clock, of the timed window's first call."""
    calls = unprofiled(t)
    opens = sorted(s.start for s in _tracer().spans(opening))
    if not calls or len(opens) < len(calls):
        return None
    return opens[-len(calls)]


def ms_per_kvote(t: dict, opening: str, names: "tuple[str, ...]") -> "float | None":
    """Milliseconds a thousand rows of the window: the summed durations of
    the spans named ``names``, over the window's rows."""
    since = window_start(t, opening)
    if since is None:
        return None
    seconds = [s.duration for s in _tracer().spans() if s.name in names and s.start >= since]
    rows = sum(r["rows"] for r in unprofiled(t))
    if not seconds or not rows:
        return None
    return sum(seconds) * 1e3 / (rows / 1e3)


def event_values(t: dict, opening: str, name: str, key: str) -> "list | None":
    """Every value of the list attribute ``key`` of the events ``name``
    recorded in the window."""
    since = window_start(t, opening)
    if since is None:
        return None
    events = getattr(_tracer(), "events", None)
    if events is None:
        return None
    return [v for e in events(name) if e["ts"] >= since for v in e.get(key, ())]
