"""Pinhole camera model (PyTorch port of ``gennbv_tpu/ops/camera.py``).

Intrinsics from horizontal FOV (env_train_base.py:787-803), pixel grid at
integer coordinates, and the camera-to-world transform built directly from
the drone pose: R = Rz(yaw) @ Ry(pitch), optical axis = body +x, OpenCV
camera convention (x right, y down, z forward), camera 0.1 m above the body.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gennbv_tpu_torch.ops import fp32


def intrinsics(height: int, width: int, horizontal_fov_deg: float) -> np.ndarray:
    """3x3 K matrix; vertical FOV derived from the aspect ratio
    (env_train_base.py:787-803)."""
    fov_x = math.radians(horizontal_fov_deg)
    fov_y = fov_x * height / width
    focal_x = 0.5 * width / math.tan(0.5 * fov_x)
    focal_y = 0.5 * height / math.tan(0.5 * fov_y)
    cx, cy = width / 2.0, height / 2.0
    return np.array(
        [[focal_x, 0.0, cx], [0.0, focal_y, cy], [0.0, 0.0, 1.0]], dtype=np.float32
    )


def pixel_grid(height: int, width: int) -> np.ndarray:
    """[H*W, 3] homogeneous pixel coords (u, v, 1) at integer positions,
    row-major over (v, u)."""
    xs = np.arange(width, dtype=np.float32)
    ys = np.arange(height, dtype=np.float32)
    vv, uu = np.meshgrid(ys, xs, indexing="ij")
    ones = np.ones_like(uu)
    return np.stack([uu, vv, ones], axis=-1).reshape(-1, 3)


def camera_rays(height: int, width: int, horizontal_fov_deg: float) -> np.ndarray:
    """[H*W, 3] camera-frame ray directions K^-1 (u, v, 1); z is 1, so the
    ray parameter equals z-depth."""
    k = intrinsics(height, width, horizontal_fov_deg)
    inv_k = np.linalg.inv(k).astype(np.float32)
    return pixel_grid(height, width) @ inv_k.T


def pose_to_c2w(pose: torch.Tensor, cam_z_offset: float = 0.1
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pose [..., 6] (x, y, z, roll=0, pitch, yaw) -> (R_c2w [..., 3, 3],
    t [..., 3]).  Columns of R are the OpenCV camera axes in world frame."""
    cp, sp = fp32.cos_sin(pose[..., 4])
    cy, sy = fp32.cos_sin(pose[..., 5])
    # R_body = Rz(yaw) @ Ry(pitch); body axes in world frame:
    bx = torch.stack([cy * cp, sy * cp, -sp], dim=-1)        # body +x (optical axis)
    by = torch.stack([-sy, cy, torch.zeros_like(sy)], dim=-1)  # body +y
    bz = torch.stack([cy * sp, sy * sp, cp], dim=-1)          # body +z
    # OpenCV cam axes: x_cam=-by, y_cam=-bz, z_cam=bx
    r = torch.stack([-by, -bz, bx], dim=-1)                   # columns
    offset = torch.tensor([0.0, 0.0, cam_z_offset], dtype=pose.dtype,
                          device=pose.device)
    t = pose[..., 0:3] + offset
    return r, t


def depth_to_grayscale(depth: torch.Tensor, depth_max: float, rgb_h: int,
                       rgb_w: int) -> torch.Tensor:
    """Shaded depth frame standing in for the reference's RGB->64x64
    grayscale chain (env_train_base.py:513-519); the encoder never reads
    it (hybrid_encoder.py:83), it keeps the observation layout.

    depth: [N, H, W] -> [N, rgb_h, rgb_w] in [0, 255].  Antialiased
    bilinear resampling matches ``jax.image.resize(method="linear")`` to a
    few 1e-5 on this scale."""
    gray = (1.0 - torch.clamp(depth / depth_max, 0.0, 1.0)) * 255.0
    out = F.interpolate(gray[:, None], size=(rgb_h, rgb_w), mode="bilinear",
                        align_corners=False, antialias=True)
    return out[:, 0]


def pixel_index(coord: torch.Tensor, size: int) -> torch.Tensor:
    """floor(coord) as int32, the image-index cast of the reference
    (``jnp.floor(u).astype(int32)``; a bare ``.int()`` would truncate
    toward zero).  Values beyond the image are first clamped to [-1, size]
    so the cast stays in range; in-image tests and clipping see the same
    answer either way."""
    return torch.floor(coord).clamp_(-1, size).to(torch.int32)
