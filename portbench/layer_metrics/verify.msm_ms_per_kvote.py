"""Milliseconds a thousand rows of the device batch's MSM stage: the mod-L
scalar algebra and window split on the host, the MSM kernels and the
verdict read (the program's ``last_phase_seconds()["msm"]``, read after
every frame)."""

from portbench.layer_metrics._common import ms_per_kvote, unprofiled


def read(t: dict):
    return ms_per_kvote(unprofiled(t), lambda r: r.get("phases", {}).get("msm"))
