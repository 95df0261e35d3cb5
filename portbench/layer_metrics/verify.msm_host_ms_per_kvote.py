"""Milliseconds a thousand rows of the MSM stage's host work in the device
signature batch: the mod-L scalar algebra and the window nibbles, before
the points go to the card (the program's ``verify.msm.scalars`` and
``verify.msm.nibbles`` spans)."""

from portbench.layer_metrics._program import ms_per_kvote


def read(t: dict):
    return ms_per_kvote(t, "engine.wire_verify_begin", ("verify.msm.scalars", "verify.msm.nibbles"))
