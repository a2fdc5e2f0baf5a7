"""The numbers that decide ``correct``: gaps between what the program's
timed path produced and what the plain reference computes from the same
inputs, each held to its limit (``limits/<workload>.json``; how each was
set is in PERF.md)."""
from __future__ import annotations

import statistics

import torch

# the number of a comparison that found nothing to compare: fails any limit
NO_READING = 1e30


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements that differ (an exact comparison)."""
    return int((got.to(want.device) != want).sum())


def max_gap(got: torch.Tensor, want: torch.Tensor, scale: float = 1.0) -> float:
    """The largest |got - want|, over `scale`."""
    return float((got.to(want.device).double() - want.double()).abs().max()) \
        / scale


def leaf_gap(got: dict, want: dict, keep) -> float:
    """The worst leaf's gap between two norms: |got - want| over the
    larger of the leaf's reference norm and the median leaf's."""
    median = statistics.median(want[k] for k in keep)
    return max(abs(got[k] - want[k]) / max(want[k], median) for k in keep)


def moving_leaves(grad_norms: dict) -> list:
    """The leaves whose reference gradient is above a thousandth of the
    median leaf's: the others (a conv bias ahead of a BatchNorm) move
    under Adam by round-off alone."""
    median = statistics.median(grad_norms.values())
    return [k for k, v in grad_norms.items() if v > 1e-3 * median]


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or below its
    limit; a number with no limit fails."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
