"""The share of a profiled window of whole units of work in which no
device activity runs: 100 x (1 - the union of the device records' spans
over the window between the spin-kernel pads), from torch.profiler's
raw device records (``benchmark/trace.py``)."""
from benchmark import trace

READS = ("every device record between the pads",)


def read(rec):
    spans, window = rec.get("spans"), rec.get("window_ns")
    if not spans or not window:
        return None
    return 100.0 * (1.0 - trace.busy_ns(spans) / window)
