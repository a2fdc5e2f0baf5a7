"""Whether two trainings from one seed ended the same: a Runner's state
and logged metrics, copied, and the first difference between two such
copies.  ``chip_smoke.py`` phase 7 and ``tests/test_torch_card.py`` train
two Runners from one seed and require no difference."""
from __future__ import annotations

import itertools
import json
import os

import torch


def read_logged(log_dir: str) -> list:
    """The records a Runner wrote to ``log_dir/metrics.jsonl``, in order."""
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def snapshot(runner, logged: list) -> dict:
    """A runner's parameters and BatchNorm statistics, Adam state and the
    metrics it logged, copied."""
    state = runner.opt_state
    return {"variables": {k: v.clone() for k, v in runner.variables().items()},
            "mu": {k: v.clone() for k, v in state.mu.items()},
            "nu": {k: v.clone() for k, v in state.nu.items()},
            "count": state.count, "logged": logged}


def _differing(a: dict, b: dict) -> list:
    """The keys whose tensors differ, or that only one side has, in the
    order of `a` (then of `b`)."""
    keys = list(a) + [k for k in b if k not in a]
    return [k for k in keys
            if k not in a or k not in b or not torch.equal(a[k], b[k])]


def first_difference(a: dict, b: dict) -> str | None:
    """The first difference between two snapshots, in the order
    parameters and BatchNorm statistics, Adam moments and count, logged
    metrics but time/*; None where they are equal bit for bit."""
    for key, label in (("variables", "variable"), ("mu", "Adam mu"),
                       ("nu", "Adam nu")):
        diffs = _differing(a[key], b[key])
        if diffs:
            return f"{label} {diffs[0]}"
    if a["count"] != b["count"]:
        return "Adam count"
    for ra, rb in itertools.zip_longest(a["logged"], b["logged"]):
        if ra is None or rb is None:
            return "the number of logged iterations"
        for k in sorted(set(ra) | set(rb)):
            if not k.startswith("time/") and ra.get(k) != rb.get(k):
                return f"metric {k} at iteration {ra['step']}"
    return None
