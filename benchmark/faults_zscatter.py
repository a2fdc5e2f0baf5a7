"""Faults of the splat renderer's exact z-buffer (the "eval_zscatter"
traffic), planted in the program to read what each does to the compared
numbers, as ``calibrate.py --fault`` does for the other traffics (whose
table, ``faults.BY_LOOP``, this module extends):

    python -m benchmark.faults_zscatter --workload exact400.eval \\
        --fault <name> --seeds 1 2 3 [--seconds 2]

The eval's own faults hold here too.  Never used by a benchmark run."""
from __future__ import annotations

import sys
import types

import torch

from benchmark import calibrate, faults


def zbuf_quantized():
    """The two-digit z-buffer of the default path in the exact one's
    place: depths bucketed into 100 levels of each frame's range, the
    visibility slack widened by a level."""
    from gennbv_tpu_torch.ops import splat
    return faults._patched(splat, "zbuf_scatter_vis_px", splat.zbuf_vis_px)


def last_band_unwritten():
    """The scatter-min leaves the last tenth of each image's rows (a band
    of the kernel at 400x400) at the fill depth."""
    from gennbv_tpu_torch.ops import zbuf_scatter
    scatter_min = zbuf_scatter.zbuf_scatter_min

    def unwritten(flat, zz, height, width, fill):
        out = scatter_min(flat, zz, height, width, fill)
        out[:, height - max(height // 10, 1):] = fill
        return out
    return faults._patched(zbuf_scatter, "zbuf_scatter_min", unwritten)


def pool_skipped():
    """The z-buffer is not min-pooled: a point splats its own pixel
    alone."""
    from gennbv_tpu_torch.ops import splat
    return faults._patched(splat, "min_pool",
                           lambda z2d, footprint, depth_max: z2d)


def slack_dropped():
    """The visibility test without its slack: a point is visible only
    where its depth is at most the pooled depth at its pixel."""
    from gennbv_tpu_torch.ops import splat
    vis = splat.zbuf_scatter_vis_px

    def tight(vic, uic, z, ok, height, width, depth_max, voxel_eps,
              footprint=1):
        return vis(vic, uic, z, ok, height, width, depth_max,
                   torch.zeros_like(voxel_eps), footprint)
    return faults._patched(splat, "zbuf_scatter_vis_px", tight)


def visibility_unrounded():
    """The visibility reads the pooled depth at each point's pixel in
    float32, without its rounding to bfloat16 (the carve's read keeps
    it)."""
    from gennbv_tpu_torch.ops import gather, splat

    def unrounded(img, vi, ui):
        n, h, w = img.shape
        return torch.gather(img.reshape(n, h * w), 1,
                            vi.long() * w + ui.long())
    return faults._patched(splat, "gather", types.SimpleNamespace(
        gather_image=unrounded, gather_image_ref=gather.gather_image_ref))


ZSCATTER = {"zbuf_quantized": zbuf_quantized,
            "last_band_unwritten": last_band_unwritten,
            "pool_skipped": pool_skipped,
            "slack_dropped": slack_dropped,
            "visibility_unrounded": visibility_unrounded}
faults.BY_LOOP.setdefault("eval_zscatter",
                          {**faults.BY_LOOP["eval"], **ZSCATTER})


if __name__ == "__main__":
    sys.exit(calibrate.main())
