"""The share of the profiled eval window (two whole episodes, between
the spin-kernel pads) in which the device is idle while the host is
inside a batched env step (the span ``env/step``): 100 x that idle time
over the window.  The idle time is the complement of the union of the
device records (``benchmark/trace.py``); the spans are the program's of
the device-only profile (``benchmark/spans.py``).  At most
``idle_share.eval``."""
from benchmark import spans

READS = ("env/step",)
# the device-only session's episodes lie within a millisecond of its
# records; the host-records session starts 0.75 s after them (NVIDIA
# H100, PERF.md)
MARGIN_S = 0.1


def read(rec):
    steps = spans.named(spans.session(rec, MARGIN_S), READS[0])
    if not steps or not rec.get("window_ns"):
        return None
    return 100.0 * spans.idle_inside(rec, steps) / rec["window_ns"]
