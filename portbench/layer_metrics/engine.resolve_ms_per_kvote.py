"""Milliseconds a thousand rows of slot resolution in the signed cell: the
proposal id of every wire row to its pool slot, before the crypto stage
(the program's ``engine.resolve`` spans)."""

from portbench.layer_metrics._program import ms_per_kvote


def read(t: dict):
    return ms_per_kvote(t, "engine.wire_verify_begin", ("engine.resolve",))
