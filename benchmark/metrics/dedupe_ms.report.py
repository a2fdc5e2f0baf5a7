"""The host's milliseconds of the 1 cm dedupe an episode
(``algo/evaluation.py``'s ``episode_scans``: each env's scan points
rounded and passed through ``np.unique``, the span
``eval/accuracy/dedupe``), the mean over the profiled report episodes.
Read from the program's spans of the device-only profile
(``benchmark/spans.py``)."""
from benchmark import spans

READS = ("eval/accuracy/dedupe",)
# the device-only session's episodes lie within a millisecond of its
# records (NVIDIA H100, PERF.md)
MARGIN_S = 0.1


def read(rec):
    found = spans.named(spans.session(rec, MARGIN_S), READS[0])
    if not found:
        return None
    return sum(s.end_ns - s.start_ns for s in found) / len(found) / 1e6
