"""The program's own spans (``gennbv_tpu_torch.utils.profiling.spans()``)
in a traced run, for the per-layer metrics whose source is
``program_span``.

A traced run profiles whole units of work twice: first with the device's
records only (``rec["spans"]``, what the readers are given), then with
the host's records too, a while later (reading the first profile takes
seconds to a minute).  The program records its spans in both sessions,
each span under the unit of work it belongs to (a training iteration, an
eval call).  A reader keeps the units of the first session: those whose
spans all lie within the time range of ``rec["spans"]`` widened by a
margin.  Spans are stamped with ``time.time_ns()``, the Unix-epoch clock
of the profiler's host and device records.  A program that records no
spans gives none, and the readers then return None.
"""
from __future__ import annotations

from benchmark import trace


def program_spans() -> list:
    """Every span the program holds (none where it has no tracer)."""
    from gennbv_tpu_torch.utils import profiling
    read = getattr(profiling, "spans", None)
    return [] if read is None else list(read())


def session(rec: dict, margin_s: float) -> dict:
    """{unit: [its spans]} of the units whose spans all lie within the
    time range of the device records ``rec["spans"]``, widened by
    `margin_s` on each side; {} without device records."""
    device = rec.get("spans")
    if not device:
        return {}
    margin = round(margin_s * 1e9)
    lo = min(s.start_ns for s in device) - margin
    hi = max(s.end_ns for s in device) + margin
    units: dict = {}
    for s in program_spans():
        if getattr(s, "unit", None) is not None:
            units.setdefault(s.unit, []).append(s)
    return {u: ss for u, ss in units.items()
            if lo <= min(s.start_ns for s in ss)
            and max(s.end_ns for s in ss) <= hi}


def named(units: dict, name: str) -> list:
    """The spans called `name` of `units`, by start."""
    return sorted((s for ss in units.values() for s in ss if s.name == name),
                  key=lambda s: s.start_ns)


def idle_inside(rec: dict, spans: list) -> int:
    """Nanoseconds of the profiled window in which the device is idle and
    the host is inside one of `spans`.  The window is ``rec["window_ns"]``
    long and starts at its first device record: the records are those of
    the window (for training, clipped to it), and the device runs from
    the window's first instant, or the host's first launch of it follows
    within microseconds."""
    device = rec["spans"]
    lo = min(s.start_ns for s in device)
    hi = lo + rec["window_ns"]
    idle, at = [], lo
    for s, e in trace.busy_intervals(device):
        if s > at:
            idle.append((at, min(s, hi)))
        at = max(at, e)
    if hi > at:
        idle.append((at, hi))
    inside = [(max(s, lo), min(e, hi))
              for s, e in trace.busy_intervals(spans) if e > lo and s < hi]
    total, i, j = 0, 0, 0
    while i < len(idle) and j < len(inside):
        s, e = max(idle[i][0], inside[j][0]), min(idle[i][1], inside[j][1])
        total += max(0, e - s)
        if idle[i][1] < inside[j][1]:
            i += 1
        else:
            j += 1
    return total
