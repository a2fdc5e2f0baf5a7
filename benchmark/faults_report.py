"""Faults of the report's accuracy path (the "eval_report" traffic),
planted in the program to read what each does to the compared numbers,
as ``calibrate.py --fault`` does for the other traffics (whose table,
``faults.BY_LOOP``, this module extends):

    python -m benchmark.faults_report --workload ref400.report \\
        --fault <name> --seeds 1 2 3 [--seconds 2]

The eval's own faults hold here too.  Never used by a benchmark run."""
from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark import calibrate, faults


def nn_expanded():
    """The nearest-neighbour passes' squared distances in the expanded
    form |a|^2 + |b|^2 - 2 a.b in float32: each carries the rounding of
    |a|^2 (coordinates reach ~10 m, so ~1e-5 m^2), where the sound
    difference form rounds relative to the distance itself."""
    from gennbv_tpu_torch.ops import chamfer

    def expanded(a, b):
        a2 = (a * a).sum(-1)[..., :, None]
        b2 = (b * b).sum(-1)[..., None, :]
        dot = sum(a[..., :, None, k] * b[..., None, :, k] for k in range(3))
        return a2 + b2 - 2.0 * dot
    return faults._patched(chamfer, "_sq_dists", expanded)


def nn_last_chunk_skipped():
    """Each pass skips its last chunk of query rows: their minima stay at
    the pass's empty value."""
    from gennbv_tpu_torch.ops import chamfer
    rows = chamfer._row_mins

    def skipped(a, a_mask, b, b_mask, chunk, exclude_self=False):
        out = rows(a, a_mask, b, b_mask, chunk, exclude_self)
        extent = chamfer._extent(a_mask)
        if extent:
            out[..., (extent - 1) // chunk * chunk:extent] = chamfer._BIG
        return out
    return faults._patched(chamfer, "_row_mins", skipped)


def init_scan_dropped():
    """The reset's forced view scans no point."""
    from gennbv_tpu_torch.algo import evaluation
    init = evaluation._init_points

    def dropped(env, scene_id, sub_rays):
        pts, valid = init(env, scene_id, sub_rays)
        return pts, torch.zeros_like(valid)
    return faults._patched(evaluation, "_init_points", dropped)


def dedupe_2cm():
    """The dedupe rounds the scan points to 2 cm, not 1 cm."""
    from gennbv_tpu_torch.ops import chamfer

    def coarse(points):
        return np.unique(np.round(points * 50.0) / 50.0, axis=0)
    return faults._patched(chamfer, "dedupe_round_cm", coarse)


REPORT = {"nn_expanded": nn_expanded,
          "nn_last_chunk_skipped": nn_last_chunk_skipped,
          "init_scan_dropped": init_scan_dropped, "dedupe_2cm": dedupe_2cm}
faults.BY_LOOP.setdefault("eval_report", {**faults.BY_LOOP["eval"], **REPORT})


if __name__ == "__main__":
    sys.exit(calibrate.main())
