"""The share of the profiled steady-state training iteration (the window
``idle_share.train`` reads: the second of three, from its dispatch to
the next's) in which the device is idle while the host is inside an
iteration's rollout (the span ``rollout``): 100 x that idle time over
the window.  The idle time is the complement of the union of the device
records (``benchmark/trace.py``); the spans are the program's of the
device-only profile (``benchmark/spans.py``).  At most
``idle_share.train``."""
from benchmark import spans

READS = ("rollout",)
MARGIN_S = 10.0


def read(rec):
    rollouts = spans.named(spans.session(rec, MARGIN_S), READS[0])
    if not rollouts or not rec.get("window_ns"):
        return None
    return 100.0 * spans.idle_inside(rec, rollouts) / rec["window_ns"]
