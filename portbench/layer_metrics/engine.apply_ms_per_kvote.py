"""Milliseconds a thousand rows of the engine's apply stage of
``ingest_wire_columnar``: replay and expiry checks, the chain guard, the
columnar apply and its events (the program's ``stage_seconds["apply"]``)."""

from portbench.layer_metrics._common import ms_per_kvote, unprofiled


def read(t: dict):
    return ms_per_kvote(unprofiled(t), lambda r: r.get("stages", {}).get("apply"))
