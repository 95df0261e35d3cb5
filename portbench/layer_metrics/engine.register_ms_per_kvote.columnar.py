"""Milliseconds a thousand rows of registration in the columnar cell:
``ingest_proposals``' per-item loop of session build, LRU eviction, slot
writes and events (the program's ``engine.register`` spans)."""

from portbench.layer_metrics._program import ms_per_kvote


def read(t: dict):
    return ms_per_kvote(t, "engine.ingest_proposals", ("engine.register",))
