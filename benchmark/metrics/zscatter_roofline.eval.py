"""The exact scatter-min z-buffer kernel's share of its roofline
(``ops/zbuf_scatter.py`` -> ``csrc/zbuf_scatter_min.cu``): its least time,
summed over its calls in the profiled window (the larger of bytes over
the peak bandwidth and operations over the float32 peak, from the
benchmark's frozen count, ``work/zbuf_scatter.py``, on each profiled env
step's shapes), over the device time of the records of the kernel named
below."""
from benchmark.work import zbuf_scatter

READS = ("zbuf_scatter_min_kernel",)


def read(rec):
    spans, calls, peaks = (rec.get("spans"), rec.get("zscatter_calls"),
                           rec.get("peaks"))
    if not spans or not calls or not peaks:
        return None
    device_ns = sum(s.end_ns - s.start_ns for s in spans if READS[0] in s.name)
    if not device_ns:
        return None
    least = sum(zbuf_scatter.least_seconds(*c, peaks["float32_flops"],
                                           peaks["hbm_bytes_per_s"])
                for c in calls)
    return 100.0 * least / (device_ns / 1e9)
