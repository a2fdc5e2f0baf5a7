"""Voxelization / grid ops (port of ``gennbv_tpu/ops/voxel.py``).

- points -> voxel indices with the half-voxel-offset bounds mask
  (gennbv/utils.py:230-270, ``scanned_pts_to_idx_3D``)
- tri-class grid {-1 free, 0 unknown, 1 occupied} (gennbv/utils.py:309-325)
- hit grid: an idempotent scatter of 1.0 (no dedup needed)
- coverage of the GT surface
"""
from __future__ import annotations

import torch

from gennbv_tpu_torch import spec


def points_to_voxel_idx(pts, valid, range_gt, voxel_size):
    """pts [..., P, 3], valid [..., P], range_gt [..., 6] (x_max, x_min,
    y_max, y_min, z_max, z_min), voxel_size [..., 3] -> (idx [..., P, 3]
    int32 clamped to [0, G-1], in_bounds [..., P]).

    idx = floor((p - (xyz_min - 0.5*v)) / v); in bounds iff
    xyz_min - 0.5*v < p < xyz_max + 0.5*v per axis (utils.py:242-258)."""
    xyz_max = range_gt[..., None, [0, 2, 4]]
    xyz_min = range_gt[..., None, [1, 3, 5]]
    v = voxel_size[..., None, :]
    lo = xyz_min - 0.5 * v
    hi = xyz_max + 0.5 * v
    idx = torch.floor((pts - lo) / v).clamp_(0, spec.GRID_SIZE - 1).to(torch.int32)
    in_bounds = ((pts > lo) & (pts < hi)).all(-1) & valid
    return idx, in_bounds


def tri_cls(prob_grid: torch.Tensor) -> torch.Tensor:
    """{-1: free (<0.0), 0: unknown, 1: occupied (>0.5)} (utils.py:309-325)."""
    occ = (prob_grid > spec.TRI_CLS_THRESHOLD_OCC).float()
    free = (prob_grid < spec.TRI_CLS_THRESHOLD_FREE).float()
    return occ - free


def scatter_hits(grid_size: int, idx: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """[N, G, G, G] float grid with 1.0 at the cells of valid points.
    idx [N, P, 3] int32 (in range), valid [N, P].  Invalid points write
    to a spare cell past the grid, which is dropped; every write stores
    the same 1.0, so the scatter is idempotent and order-free."""
    g = grid_size
    n = idx.shape[0]
    flat = (idx[..., 0].long() * g + idx[..., 1]) * g + idx[..., 2]
    flat = torch.where(valid, flat, g ** 3)
    grid = torch.zeros(n, g ** 3 + 1, device=idx.device)
    grid.scatter_(1, flat, 1.0)
    return grid[:, : g ** 3].reshape(n, g, g, g)


def coverage_update(scanned_gt, hit_grid, grid_gt, num_valid):
    """scanned' = clip(scanned + hit*gt, 0, 1); ratio = sum(scanned')/valid
    (env_train_gennbv.py:323-326, 535-539).  Grids [..., G, G, G],
    num_valid [...]."""
    scanned = torch.clamp(scanned_gt + hit_grid * grid_gt, 0.0, 1.0)
    ratio = scanned.sum(dim=(-1, -2, -3)) / torch.clamp_min(num_valid, 1.0)
    return scanned, ratio
