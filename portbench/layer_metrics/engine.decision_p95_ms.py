"""The 95th percentile, in milliseconds, of the program's own decision
latencies in the timed window: for each deciding ``ConsensusReached``,
from the start of ``wire_verify_begin`` of the frame that held the
deciding vote to the event's emission (the ``latencies_s`` of the
program's ``engine.decided`` events)."""

from portbench.harness import quantile
from portbench.layer_metrics._program import event_values


def read(t: dict):
    lat = event_values(t, "engine.wire_verify_begin", "engine.decided", "latencies_s")
    return quantile(lat, 0.95) * 1e3 if lat else None
