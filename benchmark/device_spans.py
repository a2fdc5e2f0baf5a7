"""The device time of the program's device-timed spans in a traced run:
those of ``gennbv_tpu_torch.utils.profiling.device_span``, which keep
the CUDA events recorded at their ends on the recorded span (``took``),
in the units of the device-only session (``spans.py``).  A program whose
spans carry no device time, or that records none of the name, gives
none."""
from __future__ import annotations

from benchmark import spans


def seconds(span) -> float | None:
    """A span's seconds on the device, or None where it kept none."""
    took = getattr(span, "took", None)
    if took is None or isinstance(took, float):
        return took
    start, end = took
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def timed(rec: dict, name: str, margin_s: float) -> list:
    """The device seconds of each span called `name` of the device-only
    session's units, by start."""
    found = (seconds(s) for s in
             spans.named(spans.session(rec, margin_s), name))
    return [t for t in found if t is not None]


def mean_ms(rec: dict, name: str, margin_s: float) -> float | None:
    """The spans' mean device milliseconds, or None without any."""
    took = timed(rec, name, margin_s)
    return 1e3 * sum(took) / len(took) if took else None
