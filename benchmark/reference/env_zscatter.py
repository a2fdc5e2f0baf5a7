"""The GenNBV env step on the splat path with the exact z-buffer
(``renderer.zbuf_impl`` "scatter"), written as plain PyTorch over the
benchmark's scene arrays: the per-pixel minimum of the unquantized depths
of the points that project into the image, its (2f+1)^2 min-pool, and the
visibility of each point within voxel_eps of the pooled depth at its
pixel, read in bfloat16.  Everything else (the pose decode, the hits, the
z-test carve, the grayscale, the occupancy and coverage update,
collision, reward, termination, the observation and the auto-reset) is
``env.py``'s.

It follows the JAX package's exact branch of the splat z-buffer
(``gennbv_tpu/ops/splat.py::_zbuf_px``, scatter: ``zbuf.at[flat].min(
where(ok, z, depth_max))`` into an image filled with depth_max), which
differs from the two-digit path of ``env.py`` in two places: no depth is
bucketed, and the visibility slack is voxel_eps alone, not widened by the
quantization step zrange / 100.  Nor does this path take the init-view
cache: every fresh env splats its own init view.  The min, the pool and
the bfloat16 read are exact, and the projection rounds as ``env.py``'s,
so the program's results are held to it bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import env as ref_env

GRID_SIZE = ref_env.GRID_SIZE


def splat(pts, mask, k, r_c2w, t_c2w, height: int, width: int,
          depth_max: float, voxel_eps, footprint: int):
    """(pooled z-buffer [N, H, W], visible [N, Q], valid point count [N]):
    the per-pixel minimum of depth_max and the depths of the valid points
    that land there, min-pooled over (2f+1)^2 pixels (padding at
    depth_max), and each valid point visible where its depth lies within
    voxel_eps [N] of the pooled depth at its pixel, read in bfloat16."""
    vi, ui, z, ok = ref_env.project(pts, k, r_c2w, t_c2w, height, width,
                                    1e-3)
    ok = ok & mask
    n = z.shape[0]
    pix = vi.long() * width + ui.long()
    zbuf = torch.full((n, height * width), depth_max, dtype=torch.float32,
                      device=z.device)
    zbuf.scatter_reduce_(1, pix, torch.where(ok, z, depth_max),
                         reduce="amin")
    zbuf = zbuf.reshape(n, height, width)
    if footprint:
        f = footprint
        padded = F.pad(zbuf[:, None], (f, f, f, f), value=depth_max)
        zbuf = torch.clamp_max(-F.max_pool2d(-padded, 2 * f + 1, stride=1)[:, 0],
                               depth_max)
    visible = ok & (z <= ref_env.gather_bf16(zbuf, vi, ui) + voxel_eps[:, None])
    return zbuf, visible, ok.sum(-1)


class Env(ref_env.Env):
    """``env.py``'s task with the exact z-buffer of ``splat`` above.
    Refuses any other z-buffer, renderer or carve."""

    def __init__(self, cfg: dict, scenes: dict, grid_res: int):
        rc = cfg["renderer"]
        if rc["mode"] != "splat" or cfg["carve_mode"] != "ztest" \
                or rc["zbuf_impl"] != "scatter":
            raise ValueError("the exact z-buffer reference env runs the splat "
                             "renderer's scatter-min z-buffer (zbuf_impl "
                             "scatter) with the z-test carve only")
        self.cfg, self.sc, self.r = cfg, scenes, grid_res
        dev = self.dev = scenes["surf_pts"].device
        cam = cfg["camera"]
        self.h, self.w = cam["height"], cam["width"]

        def t(x, dtype=torch.float32):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        self.k = t(ref_env.intrinsics(self.h, self.w,
                                      cam["horizontal_fov_deg"]))
        self.unit, self.low = t(ref_env.ACTION_UNIT), t(ref_env.CLIP_POSE_LOW)
        self.nvec = t(ref_env.NVEC, torch.int32)
        self.init_action = t(ref_env.INIT_ACTION, torch.int32)
        self.init_pose = t(ref_env.INIT_POSE_BUF)
        self.cache = None

    def _products(self, scene_id, poses, skip):
        cfg, sc, g = self.cfg, self.sc, GRID_SIZE
        cam = cfg["camera"]
        r_c2w, t_c2w = ref_env.pose_to_c2w(poses, cam["z_offset"])
        veps = ref_env.mean3_of_scaled(
            sc["box_hi"][scene_id] - sc["box_lo"][scene_id], self.r)
        pts = sc["surf_pts"][scene_id]
        zbuf, visible, n_valid = splat(
            pts, sc["surf_mask"][scene_id], self.k, r_c2w, t_c2w, self.h,
            self.w, cam["depth_max"], veps, cfg["renderer"]["footprint"])
        range_gt, vsize = sc["range_gt"][scene_id], sc["voxel_size"][scene_id]
        hit = ref_env.hit_grid(pts, visible, range_gt, vsize, g)
        trav = ref_env.carve_ztest(
            ref_env.voxel_centers(range_gt, vsize, g), zbuf, self.k, r_c2w,
            t_c2w, 0.5 * ref_env.mean3(vsize), cam["depth_max"])
        gray = ref_env.grayscale(zbuf, cam["depth_max"], cfg["rgb_h"],
                                 cfg["rgb_w"])
        return hit, trav.reshape(-1, g, g, g), gray, n_valid
