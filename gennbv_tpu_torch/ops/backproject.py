"""Depth-map back-projection to world points (port of
``gennbv_tpu/ops/backproject.py``; reference ``back_projection_fg``,
env_train_gennbv.py:494-533).

The output keeps the fixed [P = H*W] axis plus a validity mask instead of
the reference's ragged per-env point lists.  Background pixels have their
depth zeroed before projection (``depth_maps[~depth_maps_fg] = 0``,
env_train_gennbv.py:509): their points collapse to the camera center and
are masked invalid.
"""
from __future__ import annotations

import torch

from gennbv_tpu_torch.ops import fp32


def backproject(depth: torch.Tensor, fg: torch.Tensor, cam_rays: torch.Tensor,
                r_c2w: torch.Tensor, t_c2w: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """depth, fg [..., P] (z-depth, foreground mask), cam_rays [P, 3]
    K^-1 (u, v, 1), r_c2w [..., 3, 3], t_c2w [..., 3] -> (pts [..., P, 3]
    world points, valid [..., P])."""
    d = torch.where(fg, depth, 0.0)
    # camera-frame points: rays scale linearly with z-depth
    pts_cam = d[..., None] * cam_rays
    # einsum("...ij,...pj->...pi", R, X) + t, the dot rounded as XLA does
    pts = fp32.rotate_fma(pts_cam, r_c2w.transpose(-1, -2)) + t_c2w[..., None, :]
    return pts, fg & (depth > 0.0)
