"""The GenNBV env step on the exact-mapping path, written as plain PyTorch
over the benchmark's scene arrays: the voxel DDA ray march of every pixel
(Amanatides and Woo, "A Fast Voxel Traversal Algorithm for Ray Tracing",
Eurographics 1987), the back-projection of every foreground pixel, the hit
scatter, and the carve: the reference's Bresenham rays from the camera
voxel to every hit voxel (zjwzcx/GenNBV ``gennbv/utils.py:24-227``), or
the z-test against the march's hits.  Everything after the map (the
occupancy update, tri classes, coverage, collision, reward, termination,
the observation and the auto-reset) is ``env.py``'s ``Env.step``.

Departures from the published task, each kept by the program too:

- Depth comes from the scene's render grid of R^3 voxels, not from Isaac
  Gym's rasterizer: a ray's depth is its parameter where it enters the
  first solid voxel, and the rays are K^-1 (u, v, 1), whose camera-frame z
  is 1, so that parameter is z-depth.  The march reads at most 3R voxels a
  ray; foreground (the reference's segmentation id > 50) is a ray that
  hit.
- Bresenham rays keep the reference kernel's cap of 3G points a ray
  (``max_pts_per_ray``), and leave out the points of a ray that lie
  outside the grid (the camera voxel may).  A ray's points are written in
  closed form: after k steps along the leading axis (the one of most
  voxels, d_c), an axis of d voxels has moved floor((2 k d + d_c) /
  (2 d_c)), which is where the kernel's error terms (2 d - d_c, stepping
  at >= 0) put it.  The kernel picks the leading axis in the order x, y,
  z on ties; two tied axes move alike, so that order moves no point.

Float32 rounds where the JAX package rounds under XLA's CPU compiler, as
in ``env.py``: a fused multiply-add where XLA fuses one (the ray's entry
point, the next voxel bound, the rotations' chains), a product with the
reciprocal for a division by a constant, and true divisions elsewhere.
The march, the hits and Bresenham are then exact: integer or explicitly
rounded.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import env as ref_env

GRID_SIZE = ref_env.GRID_SIZE
BRESENHAM_CAP = 3          # points a ray, times the grid size


def camera_rays(height: int, width: int, fov_deg: float) -> np.ndarray:
    """[H*W, 3] float32 rays K^-1 (u, v, 1) at the integer pixel
    positions, row by row."""
    inv_k = np.linalg.inv(ref_env.intrinsics(height, width, fov_deg)) \
        .astype(np.float32)
    v, u = np.meshgrid(np.arange(height, dtype=np.float32),
                       np.arange(width, dtype=np.float32), indexing="ij")
    pix = np.stack([u, v, np.ones_like(u)], axis=-1).reshape(-1, 3)
    return pix @ inv_k.T


def rotate(x, r):
    """R x for x [P, 3] or [N, P, 3] and r [N, 3, 3] -> [N, P, 3]: each
    component a chain of fused multiply-adds over the three products."""
    col = r[:, None]                                  # [N, 1, 3, 3]
    acc = (x[..., 0, None].double() * col[..., 0].double()).float()
    acc = ref_env.fma(x[..., 1, None], col[..., 1], acc)
    return ref_env.fma(x[..., 2, None], col[..., 2], acc)


def march(occ, box_lo, box_hi, origin, dirs, r: int, max_steps: int,
          depth_max: float):
    """Rays dirs [N, P, 3] from origin [N, 3] through each env's grid occ
    [N, R^3] (> 0 solid) spanning [box_lo, box_hi] [N, 3] -> (depth [N, P],
    hit [N, P] bool, reads [N, P] int64: the voxels each ray read, up to
    its first hit or its exit from the box, at most max_steps)."""
    n = dirs.shape[0]
    lo, hi, org = box_lo[:, None], box_hi[:, None], origin[:, None]
    vsize = ref_env.div_const(hi - lo, r)
    d = torch.where(dirs.abs() < 1e-9, 1e-9, dirs)
    inv = 1.0 / d
    ta, tb = (lo - org) * inv, (hi - org) * inv
    t_in = torch.minimum(ta, tb).amax(-1)
    t_out = torch.maximum(ta, tb).amin(-1)
    t = torch.clamp_min(t_in, 1e-3)
    alive = t_out > t
    # the entry point, nudged 1e-5 along the ray
    entry = ref_env.fma(d, (t + 1e-5)[..., None], org)
    cell = torch.floor((entry - lo) / vsize).clamp(0, r - 1).long()
    ahead = dirs >= 0
    step = ahead.long() * 2 - 1
    t_delta = (vsize * inv).abs()
    t_cross = (ref_env.fma((cell + ahead.long()).float(), vsize, lo)
               - org) * inv
    hit = torch.zeros_like(alive)
    depth_hit = torch.full_like(t, depth_max)
    reads = torch.zeros(alive.shape, dtype=torch.int64, device=dirs.device)
    base = torch.arange(n, device=dirs.device)[:, None] * r ** 3
    for _ in range(max_steps):
        if not bool(alive.any()):
            break
        reads += alive
        x, y, z = cell.unbind(-1)
        solid = occ.reshape(-1)[base + (x * r + y) * r + z] > 0
        first = alive & solid
        depth_hit = torch.where(first, t, depth_hit)
        hit = hit | first
        # the axis whose boundary the ray crosses first (the lowest on ties)
        tx, ty, tz = t_cross.unbind(-1)
        on_x = (tx <= ty) & (tx <= tz)
        on_y = ~on_x & (ty <= tz)
        axis = torch.stack([on_x, on_y, ~on_x & ~on_y], dim=-1)
        t = torch.where(on_x, tx, torch.where(on_y, ty, tz))
        cell = cell + axis.long() * step
        t_cross = t_cross + axis.float() * t_delta
        alive = alive & ~first & ((cell >= 0) & (cell < r)).all(-1)
        cell = torch.where(alive[..., None], cell, 0)
    depth = torch.where(hit, torch.clamp_max(depth_hit, depth_max), depth_max)
    return depth, hit, reads


def backproject(depth, fg, rays, r_c2w, t_c2w):
    """The world points [N, P, 3] of every pixel at its depth (background
    pixels at the camera) and which are foreground hits [N, P]."""
    z = torch.where(fg, depth, 0.0)
    return rotate(z[..., None] * rays, r_c2w) + t_c2w[:, None], fg & (depth > 0)


def camera_voxel(pos, range_gt, vsize):
    """The mapping-grid voxel [N, 3] of the camera positions pos [N, 3],
    unclipped (gennbv/utils.py:273-306 with if_col=False)."""
    lo = range_gt[..., 1::2] - 0.5 * vsize
    return torch.floor((pos - lo) / vsize).long()


def bresenham(hit, src, g: int):
    """[N, G, G, G] {0, 1}: the in-grid voxels on the Bresenham rays from
    src [N, 3] to every hit voxel of hit [N, G, G, G], each ray's points
    from its source to its target, at most BRESENHAM_CAP * G of them."""
    n = hit.shape[0]
    env, flat = (hit.reshape(n, -1) > 0.5).nonzero(as_tuple=True)
    target = torch.stack([flat // (g * g), flat // g % g, flat % g], dim=-1)
    delta = target - src[env]
    d, s = delta.abs(), delta.sign()
    d_lead = d.amax(-1, keepdim=True)                          # [M, 1]
    k = torch.arange(BRESENHAM_CAP * g, device=hit.device)     # [K]
    # the leading axis moves k (its own term is floor(k + 1/2)); two tied
    # axes move alike, so the kernel's tie-break order moves no point
    moved = torch.div(2 * k[None, :, None] * d[:, None, :] + d_lead[:, None],
                      2 * d_lead.clamp_min(1)[:, None], rounding_mode="floor")
    pts = src[env][:, None] + s[:, None] * moved               # [M, K, 3]
    keep = (k[None] <= d_lead) & ((pts >= 0) & (pts < g)).all(-1)
    cells = env[:, None] * g ** 3 + (pts[..., 0] * g + pts[..., 1]) * g \
        + pts[..., 2]
    out = torch.zeros(n * g ** 3, device=hit.device)
    out[cells[keep]] = 1.0
    return out.reshape(n, g, g, g)


def carve_ztest_fg(centers, depth, fg, k, r_c2w, t_c2w, margin):
    """[N, G^3] {0, 1}: voxel centers that project onto a foreground pixel
    (the march's hit mask, read in bfloat16 as the depth is) and lie in
    front of its depth by more than `margin` [N]."""
    h, w = depth.shape[-2:]
    vi, ui, z, in_img = ref_env.project(centers, k, r_c2w, t_c2w, h, w, 1e-6)
    d_px = ref_env.gather_bf16(depth, vi, ui)
    fg_px = ref_env.gather_bf16(fg.float(), vi, ui) > 0.5
    return (in_img & fg_px & (z < d_px - margin[:, None])).float()


class Env(ref_env.Env):
    """``env.py``'s task with the exact depth source and mapping: the DDA
    ray march at the scene's render resolution R, 3R voxels a ray, and the
    configuration's carve ("bresenham", or "ztest" with the march's hits
    as foreground).  ``marched`` keeps (voxels read, rays, distinct scenes)
    of each step's march, the benchmark's own count of the march's work."""

    def __init__(self, cfg: dict, scenes: dict, grid_res: int):
        if cfg["renderer"]["mode"] != "dda" \
                or cfg["carve_mode"] not in ("bresenham", "ztest"):
            raise ValueError("the exact reference env runs the DDA ray march "
                             "with the Bresenham or z-test carve only")
        self.cfg, self.sc, self.r = cfg, scenes, grid_res
        dev = self.dev = scenes["surf_pts"].device
        cam = cfg["camera"]
        self.h, self.w = cam["height"], cam["width"]

        def t(x, dtype=torch.float32):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        self.k = t(ref_env.intrinsics(self.h, self.w,
                                      cam["horizontal_fov_deg"]))
        self.rays = t(camera_rays(self.h, self.w, cam["horizontal_fov_deg"]))
        self.unit, self.low = t(ref_env.ACTION_UNIT), t(ref_env.CLIP_POSE_LOW)
        self.nvec = t(ref_env.NVEC, torch.int32)
        self.init_action = t(ref_env.INIT_ACTION, torch.int32)
        self.init_pose = t(ref_env.INIT_POSE_BUF)
        self.cache = None
        self.marched: list = []

    def _products(self, scene_id, poses, skip):
        cfg, sc, g = self.cfg, self.sc, GRID_SIZE
        cam = cfg["camera"]
        r_c2w, t_c2w = ref_env.pose_to_c2w(poses, cam["z_offset"])
        depth, fg, reads = march(
            sc["render_occ"][scene_id], sc["box_lo"][scene_id],
            sc["box_hi"][scene_id], t_c2w, rotate(self.rays, r_c2w), self.r,
            3 * self.r, cam["depth_max"])
        self.marched.append((int(reads.sum()), reads.numel(),
                             int(scene_id.unique().numel())))
        range_gt, vsize = sc["range_gt"][scene_id], sc["voxel_size"][scene_id]
        pts, valid = backproject(depth, fg, self.rays, r_c2w, t_c2w)
        hit = ref_env.hit_grid(pts, valid, range_gt, vsize, g)
        if cfg["carve_mode"] == "bresenham":
            trav = bresenham(hit, camera_voxel(poses[:, :3], range_gt, vsize),
                             g)
        else:
            trav = carve_ztest_fg(
                ref_env.voxel_centers(range_gt, vsize, g),
                depth.reshape(-1, self.h, self.w),
                fg.reshape(-1, self.h, self.w), self.k, r_c2w, t_c2w,
                0.5 * ref_env.mean3(vsize)).reshape(-1, g, g, g)
        gray = ref_env.grayscale(depth.reshape(-1, self.h, self.w),
                                 cam["depth_max"], cfg["rgb_h"], cfg["rgb_w"])
        return hit, trav, gray, fg.sum(-1)
