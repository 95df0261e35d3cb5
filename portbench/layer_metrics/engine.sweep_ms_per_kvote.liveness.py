"""Milliseconds a thousand rows of the timeout sweep in the liveness cell:
the whole ``sweep_timeouts`` (the expired-set scan, the pool's timeout
dispatch, each fired session's event, the tier TTLs; the program's
``engine.sweep`` spans)."""

from portbench.layer_metrics._program import ms_per_kvote


def read(t: dict):
    return ms_per_kvote(t, "engine.ingest_proposals", ("engine.sweep",))
