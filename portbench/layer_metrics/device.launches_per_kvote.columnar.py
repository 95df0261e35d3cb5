"""Kernel launches of every kind on the card a thousand rows, over the
profiled calls (the profiler's count)."""


def read(t: dict):
    prof = t["profile"]
    rows = sum(c["rows"] for c in t["inputs"])
    if not prof.get("launches") or not rows:
        return None
    return prof["launches"] / (rows / 1e3)
