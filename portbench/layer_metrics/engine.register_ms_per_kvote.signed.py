"""Milliseconds a thousand rows of registration in the signed cell:
``ingest_proposals``' per-item loop of session build, LRU eviction, slot
writes and events (the program's ``engine.register`` spans)."""

from portbench.layer_metrics._program import ms_per_kvote


def read(t: dict):
    return ms_per_kvote(t, "engine.wire_verify_begin", ("engine.register",))
