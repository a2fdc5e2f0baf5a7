"""The ray march's share of its roofline (``ops/render.py``'s
``render_depth``): its least time a call (the larger of bytes over the
peak bandwidth and operations over the float32 peak, from the
benchmark's frozen count, ``work/raymarch.py``, of the voxels the
benchmark's own march reads at the profiled steps' poses), over the
device time a call of the program's span ``env/render/raymarch``, both
the mean over the profiled eval episodes' env steps."""
from benchmark import device_spans
from benchmark.work import raymarch

READS = ("env/render/raymarch",)
MARGIN_S = 0.1


def read(rec):
    calls, peaks = rec.get("raymarch_calls"), rec.get("peaks")
    if not calls or not peaks:
        return None
    took = device_spans.timed(rec, READS[0], MARGIN_S)
    if not took:
        return None
    least = sum(raymarch.least_seconds(*c, peaks["float32_flops"],
                                       peaks["hbm_bytes_per_s"])
                for c in calls) / len(calls)
    return 100.0 * least / (sum(took) / len(took))
