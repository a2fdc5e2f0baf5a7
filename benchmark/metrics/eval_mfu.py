"""The whole eval episode's share of the card's float32 peak: the
policy's forward FLOPs for the episode's steps, counted by the benchmark
on its reference policy (``work/flops.py``), over the episodes'
unprofiled host-clock seconds in the window, against
``work/peaks.json``."""
READS = ("each window episode's host-clock seconds",)


def read(rec):
    peaks, seconds = rec.get("peaks"), sum(rec.get("unit_seconds") or [])
    if not peaks or not seconds:
        return None
    return 100.0 * sum(rec["unit_flops"]) / seconds / peaks["float32_flops"]
