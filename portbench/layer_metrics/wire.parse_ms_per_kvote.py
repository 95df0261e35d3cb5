"""Milliseconds a thousand rows that ``bridge.columnar.parse_vote_columns``
takes, from the benchmark's span around it."""

from portbench.layer_metrics._common import ms_per_kvote, unprofiled


def read(t: dict):
    return ms_per_kvote(unprofiled(t), lambda r: r["spans"].get("parse"))
