"""The port's one tracer: spans, device-timed phases, counters and traces
(port of ``gennbv_tpu/utils/profiling.py``).

- :func:`span` -- a named region of host time, with its parent span and
  the unit of work it belongs to (a training iteration, an eval call).
  Off by default, where it costs one flag test and records nothing; on
  while a ``torch.profiler`` session records (then it also enters
  ``record_function``, so every profile and Chrome trace shows it) or
  inside :func:`tracing`.  Spans stay in memory, in a bounded ring with
  a drop count (:func:`spans`, :func:`dropped`), and are written out
  only when asked (:func:`write_spans`; :func:`trace` writes its own).
- ``span(..., device=)`` -- always on: the region's seconds on a device,
  from CUDA events recorded at its ends on a card (read later, without a
  host wait), or the host's seconds on the CPU; :func:`phases` hands a
  unit's over, as the reference-compatible ``time/*`` metric keys.
- :func:`count` -- always-on integer counters in one store
  (:func:`counters`), the kernels' launch counts among them.
- :func:`trace` -- a context manager around ``torch.profiler`` that writes
  a Chrome trace (``trace.json``, viewable in Perfetto or
  ``chrome://tracing``) of the enclosed steps, the spans among its
  records, wired to the training CLI as ``--set runner.profile_dir=<dir>``.

Spans are stamped with ``time.time_ns()``, the Unix-epoch clock on which
torch.profiler stamps its host and device records, so a span can be laid
over a profile's records.  The tracer keeps one stack of open spans for
the process: spans are meant for the thread that runs the loop.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from collections import deque
from typing import Dict, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

RING = 1 << 16          # spans kept; the oldest are dropped beyond it


class Span(NamedTuple):
    id: int
    name: str
    parent: Optional[int]    # the enclosing span's id
    unit: object             # given, or the enclosing span's
    start_ns: int            # time.time_ns()
    end_ns: int


_ring: deque = deque(maxlen=RING)
_dropped = 0
_forced = 0                  # depth of open tracing() blocks
_open: list = []             # the open traced spans, innermost last
_ids = itertools.count()
_timed: dict = {}            # unit -> {name: [(start, end) events or seconds]}
_counts: Dict[str, int] = {}
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "given", "unit", "device", "traced", "id",
                 "parent", "start_ns", "start", "record")

    def __init__(self, name: str, unit, device, traced: bool):
        self.name, self.traced = name, traced
        self.given = self.unit = unit
        self.device = None if device is None else torch.device(device)

    def __enter__(self):
        if self.traced:
            outer = _open[-1] if _open else None
            self.parent = None if outer is None else outer.id
            if self.unit is None and outer is not None:
                self.unit = outer.unit
            self.id = next(_ids)
            _open.append(self)
            self.record = None
            if _profiler._is_profiler_enabled:
                self.record = _profiler.record_function(self.name)
                self.record.__enter__()
            self.start_ns = time.time_ns()
        if self.device is not None:
            if self.device.type == "cuda":
                self.start = torch.cuda.Event(enable_timing=True)
                self.start.record()
            else:
                self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None:
            if self.device.type == "cuda":
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                took = (self.start, end)
            else:
                took = time.perf_counter() - self.start
            # filed under the unit it was given, traced or not
            _timed.setdefault(self.given, {}).setdefault(
                self.name, []).append(took)
        if self.traced:
            end_ns = time.time_ns()
            if self.record is not None:
                self.record.__exit__(None, None, None)
            _open.pop()
            _keep(Span(self.id, self.name, self.parent, self.unit,
                       self.start_ns, end_ns))
        return False


def span(name: str, unit=None, device: Optional[torch.device | str] = None):
    """A context manager around a region named `name` of unit `unit`
    (None: the enclosing span's).  With tracing off and no `device` it is
    a shared no-op.  With `device` the region's seconds on that device are
    kept, traced or not, under the `unit` given (:func:`phases`)."""
    if _forced or _profiler._is_profiler_enabled:
        return _Span(name, unit, device, True)
    if device is None:
        return _OFF
    return _Span(name, unit, device, False)


@contextlib.contextmanager
def tracing():
    """Spans are recorded inside the block, with or without a profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def _keep(s: Span) -> None:
    global _dropped
    if len(_ring) == _ring.maxlen:
        _dropped += 1
    _ring.append(s)


def spans() -> list:
    """The recorded spans, oldest first (each kept when it ends)."""
    return list(_ring)


def dropped() -> int:
    """Spans dropped from the ring since the process started."""
    return _dropped


def write_spans(path: str, since_ns: int = 0) -> None:
    """The spans that started at or after `since_ns`, one JSON object a
    line."""
    with open(path, "w") as f:
        for s in spans():
            if s.start_ns >= since_ns:
                f.write(json.dumps(s._asdict(), default=str) + "\n")


class Phases:
    """A unit's device-timed spans: seconds by name, summed over the
    unit's spans of that name."""

    def __init__(self, taken: dict):
        self._acc = taken

    def metrics(self) -> Dict[str, float]:
        """``time/<name>``: each name's seconds (waiting for the device
        where an end event has not been reached yet)."""
        def seconds(t) -> float:
            if isinstance(t, float):
                return t
            start, end = t
            if not end.query():
                end.synchronize()
            return start.elapsed_time(end) / 1e3
        return {f"time/{k}": sum(map(seconds, v)) for k, v in self._acc.items()}


def phases(unit=None) -> Phases:
    """The device-timed spans of `unit` since it was last taken, handed
    over (and forgotten here)."""
    return Phases(_timed.pop(unit, {}))


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def counters(prefix: str = "") -> Dict[str, int]:
    """The counters whose names start with `prefix`."""
    return {k: v for k, v in _counts.items() if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    """Zeroes the counters whose names start with `prefix`."""
    for k in counters(prefix):
        _counts[k] = 0


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """torch.profiler trace (host and, where there is one, CUDA activity)
    of the enclosed block, exported to `log_dir`/trace.json with the
    spans among its host records, and the block's spans to
    `log_dir`/spans.jsonl; a no-op when log_dir is falsy (so call sites
    need no branching)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    since = time.time_ns()
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    write_spans(os.path.join(log_dir, "spans.jsonl"), since)
