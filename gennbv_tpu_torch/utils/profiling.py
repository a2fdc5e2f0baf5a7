"""Phase timers and traces (port of ``gennbv_tpu/utils/profiling.py``).

- :class:`PhaseTimer` -- named-phase accounting, emitting the
  reference-compatible ``time/*`` metric keys.  On a CUDA device (the
  host returns from a launch before the card finishes) each phase is
  fenced by ``torch.cuda.synchronize()``, or, for a loop that must not
  wait (``events=True``), timed by CUDA events recorded at its ends and
  read once the device has run them;
- :func:`trace` -- a context manager around ``torch.profiler`` that writes
  a Chrome trace (``trace.json``, viewable in Perfetto or
  ``chrome://tracing``) of the enclosed steps, wired to the training CLI
  as ``--set runner.profile_dir=<dir>``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Accumulates the seconds of each named phase.

    with timer.phase("rollout", fence=device): ...
    metrics.update(timer.metrics())

    With ``events=True`` a phase on a CUDA device records a CUDA event at
    each end instead of fencing: its seconds are the device's, from the
    first event to the second, and ``take`` hands a finished iteration's
    phases over to be read later, when the device has run them."""

    def __init__(self, events: bool = False):
        self.events = events
        # per phase: seconds, and (start, end) CUDA event pairs
        self._acc: Dict[str, list] = {}

    @contextlib.contextmanager
    def phase(self, name: str, fence: Optional[torch.device | str] = None):
        """Times the enclosed block; with `fence` a CUDA device, the time
        runs until that device has finished the block's work."""
        on_card = fence is not None and torch.device(fence).type == "cuda"
        if on_card and self.events:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._acc.setdefault(name, []).append((start, end))
            return
        t0 = time.perf_counter()
        yield
        if on_card:
            torch.cuda.synchronize(fence)
        self._acc.setdefault(name, []).append(time.perf_counter() - t0)

    def metrics(self) -> Dict[str, float]:
        """``time/<phase>``: the seconds of each phase since the reset
        (waiting for the device where a phase's end event has not been
        reached yet)."""
        def seconds(t) -> float:
            if isinstance(t, float):
                return t
            start, end = t
            if not end.query():
                end.synchronize()
            return start.elapsed_time(end) / 1e3
        return {f"time/{k}": sum(map(seconds, v)) for k, v in self._acc.items()}

    def reset(self):
        self._acc = {}

    def take(self) -> "PhaseTimer":
        """The phases since the reset, as a timer of their own, and a
        reset."""
        taken = PhaseTimer(self.events)
        taken._acc, self._acc = self._acc, {}
        return taken


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """torch.profiler trace (host and, where there is one, CUDA activity)
    of the enclosed block, exported to `log_dir`/trace.json; a no-op when
    log_dir is falsy (so call sites need no branching)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
