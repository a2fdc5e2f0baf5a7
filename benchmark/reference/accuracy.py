"""The post-training report's reconstruction accuracy, written as plain
PyTorch and numpy over the benchmark's scene arrays: each view's accuracy
scan (the voxel DDA ray march of a strided pixel subset and the
back-projection of its hits, ``env_exact.py``'s), each env's scan points
rounded to 1 cm and deduplicated, and the chamfer distance x100 to the
scene's GT point cloud by brute-force nearest neighbours in float64
(zjwzcx/GenNBV ``gennbv/env/env_eval_gennbv.py:252-264``: PyTorch3D's
``chamfer_distance(unique(round(pts, 2)), pc_gt) * 100``, the sum of the
two directed mean squared distances).

Departures from ``env_eval_gennbv.py``, each kept by the program too:

- The scan back-projects every ``stride``-th pixel of every
  ``stride``-th row of the view's depth, not every foreground pixel, and
  the depth is the DDA march's on the render grid (``env_exact.py``), not
  Isaac Gym's rasterizer.  The reset's forced view is scanned first, at
  the init pose computed as a product and a sum rounded apart (the JAX
  package folds it from constants so); every other view at the pose the
  env step decodes from the action (one fused multiply-add), a fresh
  env's at the init pose.
- An env's points are those of the views up to and including its first
  done; the mean runs over the envs that have any.
- Beyond the reference's one number, its decomposition: the two directed
  terms (scan to GT, GT to scan), the part of GT to scan over GT points
  within 2 render voxels of a scan point and the share of GT points
  beyond them, and the GT sampling's own floor (each GT point's squared
  distance to its nearest other GT point).

The nearest neighbours are computed in float64 from the float32 points,
so they are independent of the program's float32 rounding.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import env as ref_env
from benchmark.reference import env_exact

# point pairs of one chunk of a nearest-neighbour pass: ~0.4 GB of
# float64 differences at 24 bytes a pair
CHUNK_PAIRS = 1 << 24
NAMES = ("mean_accuracy_cm", "accuracy_scan2gt", "accuracy_gt2scan",
         "accuracy_gt2scan_seen", "gt_unseen_frac",
         "accuracy_floor_gt_sampling")


def scan_rays(height: int, width: int, fov_deg: float,
              stride: int) -> np.ndarray:
    """[S, 3] float32 rays K^-1 (u, v, 1) of every `stride`-th pixel of
    every `stride`-th row, row by row."""
    rays = env_exact.camera_rays(height, width, fov_deg)
    return np.ascontiguousarray(
        rays.reshape(height, width, 3)[::stride, ::stride].reshape(-1, 3))


def view_poses(episode_len, actions):
    """The poses [N, 6] of the views an env step takes from a state whose
    episode_len is `episode_len` [N] for `actions` [N, 6]: the clamped
    action index times its unit plus the low bound, one fused
    multiply-add; a fresh env (episode_len 0) at the init pose, a product
    and a sum rounded apart."""
    dev = actions.device
    nvec = torch.tensor(ref_env.NVEC, dtype=torch.int32, device=dev)
    unit = torch.tensor(ref_env.ACTION_UNIT, dtype=torch.float32, device=dev)
    low = torch.tensor(ref_env.CLIP_POSE_LOW, dtype=torch.float32,
                       device=dev)
    init = torch.tensor(ref_env.INIT_ACTION, dtype=torch.float32,
                        device=dev) * unit + low
    acts = torch.minimum(torch.clamp_min(actions.to(torch.int32), 0),
                         nvec - 1)
    poses = ref_env.fma(acts.float(), unit, low)
    return torch.where((episode_len == 0)[:, None], init, poses)


def scan(scenes: dict, scene_id, poses, rays, grid_res: int, camera: dict):
    """The world points [N, S, 3] of the rays `rays` [S, 3] marched from
    poses [N, 6] through each env's render grid, and which are foreground
    hits [N, S]."""
    r_c2w, t_c2w = ref_env.pose_to_c2w(poses, camera["z_offset"])
    depth, fg, _ = env_exact.march(
        scenes["render_occ"][scene_id], scenes["box_lo"][scene_id],
        scenes["box_hi"][scene_id], t_c2w, env_exact.rotate(rays, r_c2w),
        grid_res, 3 * grid_res, camera["depth_max"])
    return env_exact.backproject(depth, fg, rays, r_c2w, t_c2w)


def dedupe(pts: np.ndarray, valid: np.ndarray, dones: np.ndarray) -> list:
    """Each env's valid scan points [T + 1, N, S, 3] / [T + 1, N, S] (the
    reset's view first) of the views up to its first done (dones
    [T, N]), rounded to 1 cm and deduplicated."""
    t_max, n = dones.shape
    first = np.where(dones.any(0), dones.argmax(0), t_max - 1)
    out = []
    for e in range(n):
        views = first[e] + 2                  # the reset's and the steps'
        kept = pts[:views, e][valid[:views, e]]
        out.append(np.unique(np.round(kept, 2), axis=0))
    return out


def nearest_sq(a: torch.Tensor, b: torch.Tensor,
               exclude_self: bool = False) -> torch.Tensor:
    """[P] float64: each point of a [P, 3]'s squared distance to its
    nearest point of b [Q, 3] (with exclude_self, row i skips b's row i),
    the differences and their squares in float64."""
    a, b = a.double(), b.double()
    out = torch.empty(a.shape[0], dtype=torch.float64, device=a.device)
    chunk = max(1, CHUNK_PAIRS // max(b.shape[0], 1))
    for i0 in range(0, a.shape[0], chunk):
        d = ((a[i0:i0 + chunk, None, :] - b[None]) ** 2).sum(-1)
        if exclude_self:
            rows = torch.arange(d.shape[0], device=a.device)
            d[rows, i0 + rows] = float("inf")
        out[i0:i0 + chunk] = d.amin(-1)
    return out


def accuracy(deduped: list, gt_points, gt_mask, vox) -> dict:
    """The six numbers of the report (``NAMES``) for each env's deduped
    scan points and its GT points gt_points [N, M, 3] where gt_mask [N,
    M], render voxel size vox [N]; the means over the envs with scan
    points, in the reference's x100 units (the unseen share as a
    fraction).  TF32 is turned off first: the passes are differences and
    products in float64, which it does not touch, and stay so whatever a
    caller left set."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    per_env = []
    for e, pts in enumerate(deduped):
        if len(pts) == 0:
            continue
        gt = gt_points[e][gt_mask[e]]
        scan_t = torch.as_tensor(pts, device=gt.device)
        s2g = nearest_sq(scan_t, gt).mean()
        g2s_each = nearest_sq(gt, scan_t)
        g2s = g2s_each.mean()
        seen = g2s_each <= (2.0 * float(vox[e])) ** 2
        seen_mean = g2s_each[seen].mean() if bool(seen.any()) else \
            torch.zeros((), dtype=torch.float64)
        floor = nearest_sq(gt, gt, exclude_self=True).mean()
        per_env.append([float(s2g + g2s), float(s2g), float(g2s),
                        float(seen_mean), 1.0 - float(seen.double().mean()),
                        float(floor)])
    if not per_env:
        return {k: float("nan") for k in NAMES}
    means = np.mean(np.array(per_env, dtype=np.float64), axis=0)
    scale = np.array([100.0, 100.0, 100.0, 100.0, 1.0, 100.0])
    return dict(zip(NAMES, (means * scale).tolist()))


def render_voxels(box_lo, box_hi, grid_res: int) -> np.ndarray:
    """[N] float64: each scene's render voxel, its box's longest side over
    the grid's resolution."""
    lo = np.asarray(box_lo, np.float64)
    hi = np.asarray(box_hi, np.float64)
    return (hi - lo).max(axis=1) / grid_res
