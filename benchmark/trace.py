"""The traced run's profiles: device records of whole units of work
(training iterations, eval episodes), fenced by spin-kernel pads, and
what the metric readers derive from them.

A copy of ``chip_smoke.py``'s ``_profiled``: torch.profiler loses device
records at the ends of a session once a process has worked a while (now
and then all of them; ``gennbv_tpu_torch/tools/profile_loss.py``), so
PADS spin kernels are launched and finished on each side of the run, and
its records are those between the last leading pad and the first
trailing one.  A profile that kept no pad on a side is taken again.
The records are read raw from kineto's results (no event tree), which
holds windows of about a million kernels.  A CUDA event recorded behind
the leading pads (``Profile.origin``) places other events of the run on
the records' clock, so that a part of the run can be read alone
(``cut``).
"""
from __future__ import annotations

import bisect
from typing import Callable, NamedTuple

PADS, PAD_CYCLES, TAKES = 256, 50_000, 3


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Profile(NamedTuple):
    value: object
    spans: list          # device records between the pads, by start
    window: tuple        # (start, end) ns: from the last leading pad's
                         # end to the first trailing pad's start
    host: list           # host records (with host=True), else []
    origin: object       # a CUDA event completed at window[0]


def profiled(run: Callable, host: bool = False) -> Profile:
    """Runs `run` under torch.profiler (device activity only, or with
    `host` the host's too) between the pads."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    def pads(behind=None):
        for _ in range(PADS):
            torch.cuda._sleep(PAD_CYCLES)
        if behind is not None:
            behind.record()
        torch.cuda.synchronize()

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    for take in range(1, TAKES + 1):
        torch.cuda.synchronize()
        origin = torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=activities) as prof:
            pads(origin)
            value = run()
            torch.cuda.synchronize()
            pads()
        device, cpu = [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    device.append(Span(e.name(), e.start_ns(), e.end_ns()))
            elif host:
                cpu.append(Span(e.name(), e.start_ns(), e.end_ns()))
        device.sort(key=lambda s: s.start_ns)
        is_pad = ["spin_kernel" in s.name for s in device]
        lead = next((i for i, p in enumerate(is_pad) if not p), len(device))
        tail = len(device) - next((i for i, p in enumerate(reversed(is_pad))
                                   if not p), len(device))
        if 0 < lead <= tail < len(device) and not any(is_pad[lead:tail]):
            return Profile(value, device[lead:tail],
                           (device[lead - 1].end_ns, device[tail].start_ns),
                           cpu, origin)
        print(f"profile {take} of {TAKES} lost the device's records: "
              f"{len(device)} records, {sum(is_pad)} of {2 * PADS} pads",
              flush=True)
    raise RuntimeError(f"the profiler lost the device's records {TAKES} times")


def cut(profile: Profile, start, end) -> Profile:
    """The part of `profile` between two CUDA events recorded during its
    run (placed by their time after its origin): that window, and the
    device records in it, each clipped to it."""
    def at(event) -> int:
        return profile.window[0] + round(
            profile.origin.elapsed_time(event) * 1e6)
    t0, t1 = at(start), at(end)
    spans = [Span(s.name, max(s.start_ns, t0), min(s.end_ns, t1))
             for s in profile.spans if s.start_ns < t1 and s.end_ns > t0]
    return profile._replace(spans=spans, window=(t0, t1))


def busy_intervals(spans) -> list:
    """The union of the spans' [start, end) intervals, in order."""
    out: list = []
    for s in sorted(spans, key=lambda s: s.start_ns):
        if out and s.start_ns <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s.end_ns)
        else:
            out.append([s.start_ns, s.end_ns])
    return out


def busy_ns(spans) -> int:
    return sum(e - s for s, e in busy_intervals(spans))


def device_ops(spans, top: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time."""
    by: dict = {}
    for s in spans:
        by[s.name] = by.get(s.name, 0) + (s.end_ns - s.start_ns)
    return [[name[:120], ns / 1e9] for name, ns in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(spans, host: list, window: tuple, top: int = 10) -> list:
    """[[what the host was doing, seconds]] of the device's idle gaps in
    `window` (start, end ns), each gap named by the innermost host record
    (an annotation, an aten op or a runtime call) around its middle, the
    gaps of one name summed, the longest first."""
    busy = busy_intervals(spans)
    gaps, at = [], window[0]
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if window[1] > at:
        gaps.append((at, window[1]))
    gaps.sort(key=lambda g: g[0] - g[1])
    records = sorted(host, key=lambda h: h.start_ns)
    starts = [h.start_ns for h in records]
    by: dict = {}
    for s, e in gaps[:200]:
        mid = (s + e) // 2
        # the latest-starting record that still runs at the middle: the
        # innermost of nested ones (looking back a bounded distance)
        i = bisect.bisect_right(starts, mid)
        name = next((records[j].name for j in range(i - 1, max(i - 5000, 0) - 1, -1)
                     if records[j].end_ns >= mid), "(no host record)")
        by[name] = by.get(name, 0) + (e - s)
    return [[name[:120], ns / 1e9] for name, ns in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]
