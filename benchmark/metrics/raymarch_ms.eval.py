"""The ray march's device milliseconds a batched env step
(``ops/render.py``'s ``render_depth`` on the "dda" path, under the
program's device-timed span ``env/render/raymarch``: CUDA events at its
ends, so its host syncs' bubbles count), the mean over the profiled eval
episodes' env steps (31 an episode, the reset's included).  Read from
the device-only profile's session (``benchmark/device_spans.py``)."""
from benchmark import device_spans

READS = ("env/render/raymarch",)
# the device-only session's episodes lie within a millisecond of its
# records (NVIDIA H100, PERF.md)
MARGIN_S = 0.1


def read(rec):
    return device_spans.mean_ms(rec, READS[0], MARGIN_S)
