"""``msm_windows``' share of its roofline on the profiled frames: the least
time the H100 needs for the integer instructions that the frames' batches
need (``counts/msm_windows.py``, at the published issue rate), over the
kernel's summed time in the profile."""

from portbench.counts import msm_windows, peaks
from portbench.layer_metrics._common import kernel_seconds


def read(t: dict):
    seconds = kernel_seconds(t, "msm_windows")
    ops = sum(msm_windows.ops_needed(c["fresh_signatures"]) for c in t["inputs"])
    if not seconds or not ops:
        return None
    return 100.0 * (ops / peaks.INT_OPS_PER_S) / seconds
