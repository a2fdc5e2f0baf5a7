"""Depth rendering by voxel-DDA ray marching, and the collision test
against the scenes' render grids (port of ``gennbv_tpu/ops/render.py``).

``raymarch`` traverses each camera ray voxel by voxel through a dense
occupancy grid (Amanatides-Woo DDA) for at most ``max_steps`` steps and
returns the exact first-hit depth.  The ray parameter equals z-depth (rays
are R_c2w K^-1 (u, v, 1), whose camera-frame z is 1), so the depth feeds
``ops/backproject.py`` unchanged.  The port carries a leading batch axis
itself where the JAX module is vmapped, and rounds where XLA's CPU
compiler rounds the jitted JAX function (``ops/fp32.py``), so the hit
flags and depths equal the reference's.

The device of the tensors picks the implementation.  CUDA tensors launch
the hand-written kernel ``csrc/raymarch.cu`` once, a thread a ray
(``ops/raymarch.py``); every other device runs the plain loop
``raymarch_ref``, which steps all rays together and ends early once none
is left.  Both give the same bits (``tests/test_torch_raymarch_kernel.py``
holds them equal on a card).

Counters, summed over calls (``utils/profiling.py``):

- ``kernel/raymarch/launches``: the kernel's launches, always (the loop
  adds nothing to it);
- while spans record (``profiling.recording``) only:
  ``raymarch/voxel_reads``, the voxels the rays read up to their first
  hit or their exit, at most ``max_steps`` a ray (the benchmark's own
  count of the march's work), summed on the device on both paths and
  read on the host only by ``profiling.counters``.

Collision is the voxel-grid replacement of the PhysX contact-force
termination test (env_train_gennbv.py:446): a pose collides iff any
occupied render voxel lies under one of 27 probes on the cube of
half-width `radius` around it.
"""
from __future__ import annotations

import math

import torch

from gennbv_tpu_torch.ops import fp32
from gennbv_tpu_torch.ops import raymarch as march_kernel
from gennbv_tpu_torch.utils import profiling

# rays still alive are tested for an early end every this many DDA steps
# (one host sync each); dead rays never change state, so ending early
# gives the result of the full loop
_ALIVE_CHECK_EVERY = 16


def raymarch(occ_flat: torch.Tensor, box_lo: torch.Tensor,
             box_hi: torch.Tensor, origin: torch.Tensor, dirs: torch.Tensor,
             grid_res: int, max_steps: int, depth_max: float
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """occ_flat [..., R^3] (C-order, any dtype; > 0 is solid), box_lo,
    box_hi and origin [..., 3], dirs [..., P, 3] world ray directions ->
    (depth [..., P], hit [..., P] bool); depth = depth_max where no hit.
    The kernel on CUDA tensors, the plain loop elsewhere."""
    if dirs.device.type == "cuda":
        return march_kernel.raymarch(occ_flat, box_lo, box_hi, origin, dirs,
                                     grid_res, max_steps, depth_max)
    return raymarch_ref(occ_flat, box_lo, box_hi, origin, dirs, grid_res,
                        max_steps, depth_max)


def raymarch_ref(occ_flat: torch.Tensor, box_lo: torch.Tensor,
                 box_hi: torch.Tensor, origin: torch.Tensor,
                 dirs: torch.Tensor, grid_res: int, max_steps: int,
                 depth_max: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain loop on any device: ``raymarch``'s arguments and
    result."""
    lead = dirs.shape[:-2]
    p = dirs.shape[-2]
    b = math.prod(lead)
    occ = occ_flat.reshape(b, -1)
    lo = box_lo.reshape(b, 1, 3)
    org = origin.reshape(b, 1, 3)
    dirs = dirs.reshape(b, p, 3)
    r = grid_res
    vsize = fp32.div_const(box_hi.reshape(b, 1, 3) - lo, r)   # [B, 1, 3]

    eps = 1e-9
    safe_dirs = torch.where(dirs.abs() < eps, eps, dirs)
    inv_d = 1.0 / safe_dirs

    # slab test for [box_lo, box_hi]
    t0 = (lo - org) * inv_d
    t1 = (box_hi.reshape(b, 1, 3) - org) * inv_d
    t_near = torch.minimum(t0, t1).amax(-1)
    t_far = torch.maximum(t0, t1).amin(-1)
    t_enter = torch.clamp_min(t_near, 1e-3)
    alive = t_far > t_enter

    # entry voxel, nudged inside: origin + dirs * (t + 1e-5) is one FMA
    p_enter = fp32.fma(safe_dirs, (t_enter + 1e-5)[..., None], org)
    voxel = torch.floor((p_enter - lo) / vsize).clamp_(0, r - 1).int()
    step = torch.where(dirs >= 0, 1, -1).int()                  # [B, P, 3]
    t_delta = (vsize * inv_d).abs()
    # box_lo + (voxel + (step > 0)) * vsize, one FMA
    next_bound = fp32.fma((voxel + (step > 0).int()).float(), vsize, lo)
    t_max = (next_bound - org) * inv_d

    t_cur = t_enter
    hit = torch.zeros(b, p, dtype=torch.bool, device=dirs.device)
    t_hit = torch.full((b, p), depth_max, dtype=torch.float32,
                       device=dirs.device)
    strides = torch.tensor([r * r, r, 1], dtype=torch.int32, device=dirs.device)
    axes = torch.arange(3, device=dirs.device)
    recording = profiling.recording()
    reads = (torch.zeros((), dtype=torch.int64, device=dirs.device)
             if recording else None)
    for i in range(max_steps):
        if i % _ALIVE_CHECK_EVERY == 0 and not bool(alive.any()):
            break
        if recording:
            reads += alive.sum()
        flat = (voxel * strides).sum(-1, dtype=torch.int64)
        solid = torch.gather(occ, 1, flat) > 0
        new_hit = alive & solid & ~hit
        t_hit = torch.where(new_hit, t_cur, t_hit)
        hit = hit | new_hit
        # advance along the axis with the smallest t_max (the first on ties)
        t_next, axis = t_max.min(-1)
        onehot = (axis[..., None] == axes).int()
        voxel = voxel + onehot * step
        t_max = t_max + onehot * t_delta
        t_cur = t_next
        in_grid = ((voxel >= 0) & (voxel < r)).all(-1)
        alive = alive & in_grid & ~hit
        # a dead ray's voxel may leave the grid: keep its read in range
        voxel = torch.where(alive[..., None], voxel, 0)
    if recording:
        profiling.count("raymarch/voxel_reads", reads)

    depth = torch.where(hit, torch.clamp_max(t_hit, depth_max), depth_max)
    return depth.reshape(*lead, p), hit.reshape(*lead, p)


def render_depth(occ_flat, box_lo, box_hi, cam_rays, r_c2w, t_c2w,
                 grid_res: int, max_steps: int, depth_max: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cameras [...]: (depth [..., P], fg [..., P]) of the camera-frame rays
    cam_rays [P, 3] (ops.camera.camera_rays) under poses r_c2w [..., 3, 3],
    t_c2w [..., 3].  fg == hit-the-object, the stand-in for segmentation
    id > 50 (the ground plane and sky never enter the grid)."""
    # cam_rays @ r_c2w.T, rounded as XLA rounds this dot
    dirs = fp32.rotate_fma(cam_rays, r_c2w.transpose(-1, -2))
    return raymarch(occ_flat, box_lo, box_hi, t_c2w, dirs, grid_res,
                    max_steps, depth_max)


def check_collision(occ_flat, box_lo, box_hi, pos, radius: float,
                    grid_res: int) -> torch.Tensor:
    """One pose: collision iff any occupied render voxel of occ_flat [R^3]
    lies under a probe on the cube of half-width `radius` around pos [3]."""
    return check_collision_batch(
        occ_flat[None], box_lo[None], box_hi[None],
        torch.zeros(1, dtype=torch.int64, device=pos.device), pos[None],
        radius, grid_res)[0]


def check_collision_batch(occ_all, box_lo, box_hi, scene_id, pos,
                          radius: float, grid_res: int) -> torch.Tensor:
    """occ_all [S, R^3] (all scenes, never copied), box_lo/box_hi [S, 3],
    scene_id [N], pos [N, 3] -> [N] bool, with one flat gather into the
    scene stack."""
    r = grid_res
    n = pos.shape[0]
    lo = box_lo[scene_id]                                    # [N, 3]
    vsize = fp32.div_const(box_hi[scene_id] - lo, r)         # [N, 3]
    # [-radius, 0, radius], made on the device (no copy from the host)
    offs = torch.arange(-1.0, 2.0, device=pos.device) * radius
    cube = torch.cartesian_prod(offs, offs, offs)            # [27, 3]
    probes = pos[:, None, :] + cube[None, :, :]              # [N, 27, 3]
    idx = torch.floor((probes - lo[:, None, :]) / vsize[:, None, :])
    idx = idx.clamp_(-1, r).long()
    in_grid = ((idx >= 0) & (idx < r)).all(-1)               # [N, 27]
    idx = idx.clamp_(0, r - 1)
    flat = (idx[..., 0] * r + idx[..., 1]) * r + idx[..., 2]
    gflat = scene_id[:, None].long() * (r ** 3) + flat
    occ = occ_all.reshape(-1)[gflat.reshape(-1)].reshape(n, -1)
    return ((occ > 0) & in_grid).any(-1)
