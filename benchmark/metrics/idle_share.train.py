"""The share of a profiled window in which no device activity runs: 100 x
(1 - the union of the device records' spans over the window), from
torch.profiler's raw device records (``benchmark/trace.py``).  The
window is the second iteration of a profiled three-iteration
``Runner.train`` call, from its dispatch to the next one's (CUDA events
placed on the records' clock): the pipelined loop's steady state, as the
timed window runs it, without the call's reset and drain."""
from benchmark import trace

READS = ("every device record between the pads",)


def read(rec):
    spans, window = rec.get("spans"), rec.get("window_ns")
    if not spans or not window:
        return None
    return 100.0 * (1.0 - trace.busy_ns(spans) / window)
