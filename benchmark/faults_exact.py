"""Faults of the exact-mapping path (the "eval_exact" traffic), planted in
the program to read what each does to the compared numbers, as
``calibrate.py --fault`` does for the other traffics (whose table,
``faults.BY_LOOP``, this module extends):

    python -m benchmark.faults_exact --workload dda400.eval --fault <name> \\
        --seeds 1 2 3 [--seconds 2]

The eval's own faults hold here too.  Never used by a benchmark run."""
from __future__ import annotations

import sys

import torch

from benchmark import calibrate, faults


def march_depth_ulp():
    """Every hit's depth one float32 ulp farther: the least error a
    march can make."""
    from gennbv_tpu_torch.ops import render
    march = render.raymarch

    def farther(*args):
        depth, hit = march(*args)
        far = torch.nextafter(depth, torch.full_like(depth, float("inf")))
        return torch.where(hit, far, depth), hit
    return faults._patched(render, "raymarch", farther)


def march_dropped():
    """The march finds no surface: every ray misses."""
    from gennbv_tpu_torch.ops import render
    march = render.raymarch

    def missed(*args):
        depth, hit = march(*args)
        return torch.full_like(depth, args[-1]), torch.zeros_like(hit)
    return faults._patched(render, "raymarch", missed)


def carve_dropped():
    """The carve marks no voxel free."""
    from gennbv_tpu_torch.ops import carve
    traversed = carve.bresenham_traversed

    def none(src, targets, valid, g):
        return torch.zeros_like(traversed(src, targets, valid, g))
    return faults._patched(carve, "bresenham_traversed", none)


EXACT = {"march_depth_ulp": march_depth_ulp, "march_dropped": march_dropped,
         "carve_dropped": carve_dropped}
faults.BY_LOOP.setdefault("eval_exact", {**faults.BY_LOOP["eval"], **EXACT})


if __name__ == "__main__":
    sys.exit(calibrate.main())
