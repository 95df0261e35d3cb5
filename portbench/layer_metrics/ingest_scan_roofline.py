"""``ingest_scan``'s share of its roofline on the profiled calls: the least
time the H100 needs to move the bytes that the calls' votes need
(``counts/ingest_scan.py``, at the published 3.35 TB/s), over the
kernel's summed time in the profile."""

from portbench.counts import ingest_scan, peaks
from portbench.layer_metrics._common import kernel_seconds


def read(t: dict):
    seconds = kernel_seconds(t, "ingest_scan")
    calls = t["inputs"]
    if not seconds or not calls or any("votes" not in c for c in calls):
        return None
    need = sum(ingest_scan.bytes_needed(c["sessions"], c["votes"], c["applied"]) for c in calls)
    return 100.0 * (need / peaks.HBM_BYTES_PER_S) / seconds
