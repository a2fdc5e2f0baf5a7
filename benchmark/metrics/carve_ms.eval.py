"""The carve's device milliseconds a batched env step (``ops/carve.py``:
the Bresenham rays of the "dda" path, or its z-test; under the program's
device-timed span ``env/map/carve``), the mean over the profiled eval
episodes' env steps (31 an episode, the reset's included).  Read from
the device-only profile's session (``benchmark/device_spans.py``)."""
from benchmark import device_spans

READS = ("env/map/carve",)
# the device-only session's episodes lie within a millisecond of its
# records (NVIDIA H100, PERF.md)
MARGIN_S = 0.1


def read(rec):
    return device_spans.mean_ms(rec, READS[0], MARGIN_S)
