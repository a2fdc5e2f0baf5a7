"""The exact z-buffer's device milliseconds a batched env step
(``ops/splat.py``'s ``zbuf_scatter_vis_px`` under ``zbuf_impl="scatter"``:
the scatter-min kernel, the min-pool and the visibility's gather, under
the program's device-timed span ``env/render/zbuf``: CUDA events at its
ends, so the host's enqueue of its launches counts), the mean over the
profiled eval episodes' env steps (31 an episode, the reset's included).
Read from the device-only profile's session
(``benchmark/device_spans.py``)."""
from benchmark import device_spans

READS = ("env/render/zbuf",)
# the device-only session's episodes lie within a millisecond of its
# records (NVIDIA H100, PERF.md)
MARGIN_S = 0.1


def read(rec):
    return device_spans.mean_ms(rec, READS[0], MARGIN_S)
