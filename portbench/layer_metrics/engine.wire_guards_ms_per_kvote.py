"""Milliseconds a thousand rows of the wire apply's per-row rules: replay
and expiry with the reject health, the dangling-vote guard and the chain
tracking after the apply, and the admission health with its equivocation
probe (the program's ``engine.wire.rules``, ``engine.wire.guard``,
``engine.wire.chain`` and ``engine.wire.admit_health`` spans)."""

from portbench.layer_metrics._program import ms_per_kvote

SPANS = ("engine.wire.rules", "engine.wire.guard", "engine.wire.chain", "engine.wire.admit_health")


def read(t: dict):
    return ms_per_kvote(t, "engine.wire_verify_begin", SPANS)
