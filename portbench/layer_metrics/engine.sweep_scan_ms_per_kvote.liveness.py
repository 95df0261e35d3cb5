"""Milliseconds a thousand rows of the timeout sweep's expired-set scan in
the liveness cell: every live record's state and expiry read on the host
(the program's ``engine.sweep.scan`` spans)."""

from portbench.layer_metrics._program import ms_per_kvote


def read(t: dict):
    return ms_per_kvote(t, "engine.ingest_proposals", ("engine.sweep.scan",))
