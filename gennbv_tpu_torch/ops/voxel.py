"""Voxelization / grid ops (port of ``gennbv_tpu/ops/voxel.py``).

- points -> voxel indices with the half-voxel-offset bounds mask
  (gennbv/utils.py:230-270, ``scanned_pts_to_idx_3D``)
- pose -> unclipped voxel index, the Bresenham source
  (gennbv/utils.py:273-306, ``pose_coord_to_idx_3D``)
- tri-class grid {-1 free, 0 unknown, 1 occupied} (gennbv/utils.py:309-325)
- hit grid: an idempotent scatter of 1.0 (no dedup needed; ops/scatter.py)
- coverage of the GT surface
"""
from __future__ import annotations

import torch

from gennbv_tpu_torch import spec
from gennbv_tpu_torch.ops import scatter


def points_to_voxel_idx(pts, valid, range_gt, voxel_size):
    """pts [..., P, 3], valid [..., P], range_gt [..., 6] (x_max, x_min,
    y_max, y_min, z_max, z_min), voxel_size [..., 3] -> (idx [..., P, 3]
    int32 clamped to [0, G-1], in_bounds [..., P]).  G is
    ``spec.GRID_SIZE``, not the scenes' grid size, as in the JAX package
    (gennbv_tpu/ops/voxel.py:42).

    idx = floor((p - (xyz_min - 0.5*v)) / v); in bounds iff
    xyz_min - 0.5*v < p < xyz_max + 0.5*v per axis (utils.py:242-258)."""
    xyz_max = range_gt[..., None, 0::2]
    xyz_min = range_gt[..., None, 1::2]
    v = voxel_size[..., None, :]
    lo = xyz_min - 0.5 * v
    hi = xyz_max + 0.5 * v
    idx = torch.floor((pts - lo) / v).clamp_(0, spec.GRID_SIZE - 1).to(torch.int32)
    in_bounds = ((pts > lo) & (pts < hi)).all(-1) & valid
    return idx, in_bounds


def pose_to_voxel_idx(pos, range_gt, voxel_size):
    """pos [..., 3], range_gt [..., 6], voxel_size [..., 3] -> [..., 3]
    int32 voxel index of a camera position, unclipped: the Bresenham
    source may lie outside the grid (utils.py:273-306 with if_col=False).
    ``floor((p - (xyz_min - 0.5*v)) / v)``, rounded as
    ``points_to_voxel_idx`` rounds it."""
    xyz_min = range_gt[..., [1, 3, 5]]
    lo = xyz_min - 0.5 * voxel_size
    return torch.floor((pos - lo) / voxel_size).to(torch.int32)


def tri_cls(prob_grid: torch.Tensor) -> torch.Tensor:
    """{-1: free (<0.0), 0: unknown, 1: occupied (>0.5)} (utils.py:309-325)."""
    occ = (prob_grid > spec.TRI_CLS_THRESHOLD_OCC).float()
    free = (prob_grid < spec.TRI_CLS_THRESHOLD_FREE).float()
    return occ - free


def scatter_hits(grid_size: int, idx: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """[N, G, G, G] float grid with 1.0 at the cells of valid points.
    idx [N, P, 3] int32 (in range), valid [N, P] bool.  The any-hit
    scatter of ``ops/scatter.py``: its CUDA kernel on the card, its plain
    version on the CPU."""
    return scatter.scatter_cells_any(idx.contiguous(), valid.contiguous(),
                                     grid_size)


def coverage_update(scanned_gt, hit_grid, grid_gt, num_valid):
    """scanned' = clip(scanned + hit*gt, 0, 1); ratio = sum(scanned')/valid
    (env_train_gennbv.py:323-326, 535-539).  Grids [..., G, G, G],
    num_valid [...]."""
    scanned = torch.clamp(scanned_gt + hit_grid * grid_gt, 0.0, 1.0)
    ratio = scanned.sum(dim=(-1, -2, -3)) / torch.clamp_min(num_valid, 1.0)
    return scanned, ratio
