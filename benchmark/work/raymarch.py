"""The least work of one batched ray march (``ops/render.py``'s
``render_depth``), counted by the benchmark's own march
(``reference/env_exact.march``: the voxels each ray reads up to its first
hit or its exit from the box), so that it reads the same work whatever
implements the march: the plain loop of elementwise ops, or a kernel that
runs a thread a ray."""
from __future__ import annotations

# one DDA iteration: the flat index's two multiply-adds, the solid test,
# two comparisons choosing the axis, the next crossing's add, the voxel's
# step and its bounds test
OPS_PER_ITERATION = 8
DEPTH_BYTES, HIT_BYTES = 4, 1      # float32 depth and a bool a ray


def work(reads: int, rays: int, scenes: int,
         grid_res: int) -> tuple[int, int]:
    """(bytes, operations) of a march of `rays` rays that read `reads`
    voxels in all, over `scenes` distinct occupancy grids of grid_res^3
    one-byte voxels: each grid read once, each ray's depth and hit
    written once; OPS_PER_ITERATION operations a voxel read."""
    return (scenes * grid_res ** 3 + rays * (DEPTH_BYTES + HIT_BYTES),
            OPS_PER_ITERATION * reads)


def least_seconds(reads: int, rays: int, scenes: int, grid_res: int,
                  peak_flops: float, peak_bytes: float) -> float:
    """The larger of the bytes over the peak bandwidth and the operations
    over the peak rate."""
    nbytes, ops = work(reads, rays, scenes, grid_res)
    return max(nbytes / peak_bytes, ops / peak_flops)
