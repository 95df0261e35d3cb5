"""Milliseconds a thousand rows of the whole columnar apply,
``ingest_columnar_multi``: resolution, lanes, the device dispatch and the
events (the program's ``engine.ingest_columnar`` spans)."""

from portbench.layer_metrics._program import ms_per_kvote


def read(t: dict):
    return ms_per_kvote(t, "engine.ingest_proposals", ("engine.ingest_columnar",))
