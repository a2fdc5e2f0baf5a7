"""Phase timers and traces (port of ``gennbv_tpu/utils/profiling.py``).

- :class:`PhaseTimer` -- named-phase wall-clock accounting, each phase
  fenced by ``torch.cuda.synchronize()`` when it ran on a CUDA device (the
  host returns from a launch before the card finishes), emitting the
  reference-compatible ``time/*`` metric keys;
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
    """Accumulates wall-clock per named phase.

    with timer.phase("rollout", fence=device): ...
    metrics.update(timer.metrics())
    """

    def __init__(self):
        self._acc: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, fence: Optional[torch.device | str] = None):
        """Times the enclosed block; with `fence` a CUDA device, the time
        runs until that device has finished the block's work."""
        t0 = time.perf_counter()
        yield
        if fence is not None and torch.device(fence).type == "cuda":
            torch.cuda.synchronize(fence)
        self._acc[name] = self._acc.get(name, 0.0) + time.perf_counter() - t0

    def metrics(self) -> Dict[str, float]:
        """``time/<phase>``: the seconds of each phase since the reset."""
        return {f"time/{k}": v for k, v in self._acc.items()}

    def reset(self):
        self._acc.clear()


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
