"""Milliseconds a thousand rows of the device batch's SHA-512 challenge
hashes: enqueue and wait (the program's ``last_phase_seconds()["hash"]``,
read after every frame)."""

from portbench.layer_metrics._common import ms_per_kvote, unprofiled


def read(t: dict):
    return ms_per_kvote(unprofiled(t), lambda r: r.get("phases", {}).get("hash"))
