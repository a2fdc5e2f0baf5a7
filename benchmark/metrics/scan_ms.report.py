"""The accuracy scan's device milliseconds a view (``algo/evaluation.py``:
the DDA march of the strided sub-rays and their back-projection, under
the program's device-timed span ``eval/scan``), the mean over the
profiled report episodes' views (31 an episode, the reset's included).
Read from the device-only profile's session
(``benchmark/device_spans.py``)."""
from benchmark import device_spans

READS = ("eval/scan",)
# the device-only session's episodes lie within a millisecond of its
# records (NVIDIA H100, PERF.md)
MARGIN_S = 0.1


def read(rec):
    return device_spans.mean_ms(rec, READS[0], MARGIN_S)
