"""The port's hand-written CUDA kernels by name, and their launch counts:
each wrapper adds one to its ``launches`` attribute where it launches its
kernel, and nowhere else."""
from __future__ import annotations

from gennbv_tpu_torch.ops import fused_splat, gather, scatter, zbuf_scatter

WRAPPERS = {
    "gather_image": gather.gather_image,
    "scatter_cells_any": scatter.scatter_cells_any,
    "zbuf_visible": fused_splat.zbuf_visible,
    "zbuf_scatter_min": zbuf_scatter.zbuf_scatter_min,
}


def launches() -> dict:
    """Each kernel's launches since its count was last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
