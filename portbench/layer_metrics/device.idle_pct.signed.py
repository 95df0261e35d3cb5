"""Share of the profiled calls' stretch in which no operation ran on the
card."""

from portbench.layer_metrics._common import idle_pct


def read(t: dict):
    return idle_pct(t)
