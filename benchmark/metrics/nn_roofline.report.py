"""The nearest-neighbour passes' share of their roofline: their least
time an episode (the larger of bytes over the peak bandwidth and
operations over the float32 peak, from the benchmark's frozen count,
``work/chamfer.py``, of the point counts its own reference works out at
the checked episodes, which take the profiled episodes' actions), over
the mean device time an episode of the program's span
``eval/accuracy/nn``."""
from benchmark import device_spans
from benchmark.work import chamfer

READS = ("eval/accuracy/nn",)
MARGIN_S = 0.1


def read(rec):
    counts, peaks = rec.get("nn_counts"), rec.get("peaks")
    if not counts or not peaks:
        return None
    took = device_spans.timed(rec, READS[0], MARGIN_S)
    if not took:
        return None
    least = chamfer.least_seconds(counts, peaks["float32_flops"],
                                  peaks["hbm_bytes_per_s"])
    return 100.0 * least / (sum(took) / len(took))
