"""The 95th percentile of the decision latencies of the traced run's timed
window: for each session decided there, from the start of
``wire_verify_begin`` of the frame that held its deciding vote to taking
its event off the bus. Where the card idles most of the window the host
paces this tail, so it is read here and not held to a bound."""

from portbench.harness import quantile


def read(t: dict):
    lat = t.get("latencies_s") or []
    return quantile(lat, 0.95) * 1e3 if lat else None
