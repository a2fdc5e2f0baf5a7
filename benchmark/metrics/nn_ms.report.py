"""The nearest-neighbour passes' device milliseconds an episode
(``algo/evaluation.py``'s ``batched_accuracy``: scan to GT, GT to scan
and GT to GT, their copies to the host included, under the program's
device-timed span ``eval/accuracy/nn``), the mean over the profiled
report episodes.  Read from the device-only profile's session
(``benchmark/device_spans.py``)."""
from benchmark import device_spans

READS = ("eval/accuracy/nn",)
# the device-only session's episodes lie within a millisecond of its
# records (NVIDIA H100, PERF.md)
MARGIN_S = 0.1


def read(rec):
    return device_spans.mean_ms(rec, READS[0], MARGIN_S)
