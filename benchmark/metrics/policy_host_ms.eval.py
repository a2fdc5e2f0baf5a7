"""The host's milliseconds in one policy forward (``models/policy.py``,
the span ``policy/forward``) in the profiled eval episodes (30 an
episode): the spans' summed duration over their count, each span one of
the ``policy/forwards`` count.  Read from the program's spans of the
device-only profile (``benchmark/spans.py``)."""
from benchmark import spans

READS = ("policy/forward",)
# the device-only session's episodes lie within a millisecond of its
# records; the host-records session starts 0.75 s after them (NVIDIA
# H100, PERF.md)
MARGIN_S = 0.1


def read(rec):
    calls = spans.named(spans.session(rec, MARGIN_S), READS[0])
    if not calls:
        return None
    return sum(s.end_ns - s.start_ns for s in calls) / len(calls) / 1e6
