"""Free-space carving + probabilistic grid update (port of
``gennbv_tpu/ops/carve.py``, the projective z-test path).

A mapping voxel is observed free iff its center projects into the image
onto a foreground pixel and lies in front of the measured surface by more
than a margin.  Pure gather, no scatter; batched over a leading env axis.
The fused grid update is ``prob' = where(hit, 1.0, prob - 0.05 * traversed)``
(env_train_gennbv.py:311-314: the occupied overwrite wins).
"""
from __future__ import annotations

import torch

from gennbv_tpu_torch import spec
from gennbv_tpu_torch.ops import fp32, gather
from gennbv_tpu_torch.ops.camera import pixel_index


def project_centers_px(voxel_centers, k, r_c2w, t_c2w, height: int, width: int):
    """Project voxel centers [N, P, 3] into the camera.  Returns (vi, ui)
    clipped int32, z and in_img, each [N, P].  The near plane is 1e-6,
    not the splat's 1e-3 (carve.py:138)."""
    # einsum("ij,pj->pi", R^T, X - t) of carve.py:136, rounded as XLA does
    p_cam = fp32.rotate(voxel_centers - t_c2w[:, None, :], r_c2w)
    z = p_cam[..., 2]
    in_front = z > 1e-6
    safe_z = torch.where(in_front, z, 1.0)
    u = k[0, 0] * p_cam[..., 0] / safe_z + k[0, 2]
    v = k[1, 1] * p_cam[..., 1] / safe_z + k[1, 2]
    ui = pixel_index(u, width)
    vi = pixel_index(v, height)
    in_img = in_front & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    return vi.clamp(0, height - 1), ui.clamp(0, width - 1), z, in_img


def carve_ztest(voxel_centers, depth, k, r_c2w, t_c2w, margin: torch.Tensor,
                depth_max: float) -> torch.Tensor:
    """[N, P] {0,1} float mask of voxels observed free by the depth frames
    depth [N, H, W] (depth_max where no surface).  Foreground is read off
    the gathered depth itself (the reference's fg=None path): a pixel is
    foreground below depth_max * (1 - 1e-4).  margin [N]."""
    h, w = depth.shape[-2:]
    vi, ui, z, in_img = project_centers_px(voxel_centers, k, r_c2w, t_c2w, h, w)
    d_px = gather.gather_image(depth, vi, ui)
    fg_px = d_px < depth_max * (1.0 - 1e-4)
    free = in_img & fg_px & (z < d_px - margin[:, None])
    return free.float()


def update_prob_grid(prob_grid: torch.Tensor, hit_grid: torch.Tensor,
                     traversed: torch.Tensor) -> torch.Tensor:
    """prob' = where(hit, 1.0, prob - 0.05 * traversed)."""
    return torch.where(hit_grid > 0.5, spec.OCCUPIED_VALUE,
                       prob_grid - spec.CARVE_DELTA * traversed)
