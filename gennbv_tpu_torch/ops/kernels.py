"""The port's hand-written CUDA kernels by name, and their launch counts:
each wrapper adds one to its counter ``kernel/<name>/launches``
(``utils/profiling.count``) where it launches its kernel, and nowhere
else."""
from __future__ import annotations

from gennbv_tpu_torch.ops import (bresenham, conv3d_wgrad, dedupe,
                                  fused_splat, gather, nn_min, raymarch,
                                  scatter, zbuf_scatter)
from gennbv_tpu_torch.utils import profiling

WRAPPERS = {
    "gather_image": gather.gather_image,
    "scatter_cells_any": scatter.scatter_cells_any,
    "zbuf_visible": fused_splat.zbuf_visible,
    "zbuf_scatter_min": zbuf_scatter.zbuf_scatter_min,
    "conv3d_wgrad": conv3d_wgrad.conv3d_wgrad,
    "raymarch": raymarch.raymarch,
    "bresenham": bresenham.bresenham,
    "nn_min": nn_min.nn_min,
    "dedupe_cm": dedupe.dedupe_cm,
}


def launches() -> dict:
    """Each kernel's launches since its count was last reset."""
    counts = profiling.counters("kernel/")
    return {name: counts.get(f"kernel/{name}/launches", 0)
            for name in WRAPPERS}


def reset_launches() -> None:
    profiling.reset_counters("kernel/")
