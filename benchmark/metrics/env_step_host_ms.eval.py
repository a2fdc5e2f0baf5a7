"""The host's milliseconds in one batched env step (``env/recon_env.py``'s
``step``, the span ``env/step``), over the profiled eval episodes' env
steps (31 an episode, the reset's included): the spans' summed duration
over their count, each span one of the ``env/steps`` count.  Read from
the program's spans of the device-only profile (``benchmark/spans.py``),
so each launch carries the profiler's cost, as on every side."""
from benchmark import spans

READS = ("env/step",)
# the device-only session's episodes lie within a millisecond of its
# records; the host-records session starts 0.75 s after them (NVIDIA
# H100, PERF.md)
MARGIN_S = 0.1


def read(rec):
    steps = spans.named(spans.session(rec, MARGIN_S), READS[0])
    if not steps:
        return None
    return sum(s.end_ns - s.start_ns for s in steps) / len(steps) / 1e6
