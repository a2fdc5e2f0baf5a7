"""Free-space carving + probabilistic grid update (port of
``gennbv_tpu/ops/carve.py``), batched over a leading env axis.

- ``carve_bresenham``: the reference's exact semantics, the union of the
  voxels on integer Bresenham rays from the camera voxel to every hit
  voxel (gennbv/utils.py:24-227).  Integer arithmetic only, so it equals
  the JAX function bit for bit.
- ``carve_ztest`` (default): a mapping voxel is observed free iff its
  center projects into the image onto a foreground pixel and lies in
  front of the measured surface by more than a margin.  Pure gather.

Both give a {0,1} traversed mask; the fused grid update is
``prob' = where(hit, 1.0, prob - 0.05 * traversed)``
(env_train_gennbv.py:311-314: the occupied overwrite wins).

The device of the tensors picks the Bresenham implementation.  CUDA
tensors take a zero fill and one launch of the hand-written kernel
``csrc/bresenham.cu``, a thread a ray (``ops/bresenham.py``); every other
device runs the plain loop ``bresenham_traversed_ref``.  Both give the
same bits (``tests/test_torch_bresenham_kernel.py`` holds them equal on
a card).  ``carve_bresenham`` reaches either through the module's name
``bresenham_traversed``, which the benchmark's fault hooks patch.

While spans record (``utils/profiling.recording``), ``bresenham_traversed``
counts the valid rays it marches (``carve/bresenham_rays``, summed on the
device), on both paths.
"""
from __future__ import annotations

import torch

from gennbv_tpu_torch import spec
from gennbv_tpu_torch.ops import bresenham, fp32, gather
from gennbv_tpu_torch.ops.camera import pixel_index
from gennbv_tpu_torch.utils import profiling


def bresenham_traversed(src: torch.Tensor, targets: torch.Tensor,
                        target_valid: torch.Tensor, grid_size: int
                        ) -> torch.Tensor:
    """src [N, 3] int32 camera voxels (may lie outside the grid), targets
    [R, 3] or [N, R, 3] int32 in-grid target voxels, target_valid [N, R]
    bool -> [N, G, G, G] {0,1} float mask of the voxels any valid ray
    visits.  The kernel on CUDA tensors, the plain loop elsewhere."""
    if profiling.recording():
        profiling.count("carve/bresenham_rays", target_valid.sum())
    if src.device.type == "cuda":
        return bresenham.bresenham(src, targets, target_valid, grid_size)
    return bresenham_traversed_ref(src, targets, target_valid, grid_size)


def bresenham_traversed_ref(src: torch.Tensor, targets: torch.Tensor,
                            target_valid: torch.Tensor, grid_size: int
                            ) -> torch.Tensor:
    """The plain loop on any device: ``bresenham_traversed``'s arguments
    and result.

    Every ray runs 3G steps (spec.BRESENHAM_MAX_PTS_FACTOR * G, the
    reference's max_pts_per_ray, utils.py:37), emitting its current voxel
    before it advances, as the reference's CUDA kernel records before
    stepping.  The dominant axis is picked with that kernel's tie-break
    order (x, then y, then z; utils.py:69-164).  The mask is marked step
    by step (a scatter of 1.0, order-free) instead of stacking the scan's
    indices."""
    g = grid_size
    n = src.shape[0]
    targets = targets.to(torch.int32).expand(n, -1, 3)
    delta = targets - src.to(torch.int32)[:, None, :]           # [N, R, 3]
    d = delta.abs()
    s = delta.sign()
    dx, dy, dz = d.unbind(-1)
    c = torch.where((dx >= dy) & (dx >= dz), 0, torch.where(dy >= dz, 1, 2))
    o1 = (c == 0).long()                                        # 1 or 0
    o2 = torch.where(c == 2, 1, 2)
    d_c = d.gather(-1, c[..., None])[..., 0]
    d_1 = d.gather(-1, o1[..., None])[..., 0]
    d_2 = d.gather(-1, o2[..., None])[..., 0]
    dm = d.amax(-1)
    eye = torch.eye(3, dtype=torch.int32, device=src.device)
    s_c, s_1, s_2 = s * eye[c], s * eye[o1], s * eye[o2]        # step vectors

    pos = src.to(torch.int32)[:, None, :].expand_as(targets).clone()
    p1 = 2 * d_1 - d_c
    p2 = 2 * d_2 - d_c
    mask = torch.zeros(n, g ** 3 + 1, device=src.device)        # + overflow
    strides = torch.tensor([g * g, g, 1], dtype=torch.int32, device=src.device)
    for i in range(spec.BRESENHAM_MAX_PTS_FACTOR * g):
        emit = target_valid & (i <= dm)
        in_b = ((pos >= 0) & (pos < g)).all(-1)
        flat = (pos * strides).sum(-1, dtype=torch.int64)
        flat = torch.where(emit & in_b, flat, g ** 3)
        mask.scatter_(1, flat, 1.0)
        step1 = (p1 >= 0).int()
        step2 = (p2 >= 0).int()
        pos = pos + s_1 * step1[..., None] + s_2 * step2[..., None] + s_c
        p1 = p1 - 2 * d_c * step1 + 2 * d_1
        p2 = p2 - 2 * d_c * step2 + 2 * d_2
    return mask[:, : g ** 3].reshape(n, g, g, g)


def carve_bresenham(hit_grid: torch.Tensor, cam_voxel: torch.Tensor,
                    grid_size: int) -> torch.Tensor:
    """[N, G, G, G] traversed mask of exact Bresenham rays from cam_voxel
    [N, 3] int32 to every hit voxel of hit_grid [N, G, G, G] {0,1}."""
    valid = hit_grid.reshape(hit_grid.shape[0], -1) > 0.5
    return bresenham_traversed(cam_voxel,
                               grid_voxels(grid_size, hit_grid.device), valid,
                               grid_size)


# grid_voxels' tables by (G, device); each is only read
_GRID_VOXELS: dict = {}


def grid_voxels(grid_size: int, device: torch.device) -> torch.Tensor:
    """[G^3, 3] int32: every voxel of the grid in C order, the Bresenham
    carve's targets.  Made once a (G, device) and kept, so a step does not
    launch its build; made afresh while the current CUDA stream is being
    captured into a graph, where a new tensor holds its values only in the
    graph's replays."""
    device = torch.device(device)
    key = (grid_size, device)
    if key in _GRID_VOXELS:
        return _GRID_VOXELS[key]
    ar = torch.arange(grid_size, dtype=torch.int32, device=device)
    table = torch.cartesian_prod(ar, ar, ar)
    if device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        _GRID_VOXELS[key] = table
    return table


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
                depth_max: float | None = None,
                fg: torch.Tensor | None = None) -> torch.Tensor:
    """[N, P] {0,1} float mask of voxels observed free by the depth frames
    depth [N, H, W] (depth_max where no surface).  margin [N].  With fg
    None, foreground is read off the gathered depth itself: a pixel is
    foreground below depth_max * (1 - 1e-4).  Otherwise fg [N, H, W] bool
    is gathered too, as float32 (a second gather), and a pixel is
    foreground where it is set.  Both gathers are ``gather.gather_image``:
    ``bf16(img)[vi, ui]``, the JAX package's inexact mxu gather."""
    h, w = depth.shape[-2:]
    vi, ui, z, in_img = project_centers_px(voxel_centers, k, r_c2w, t_c2w, h, w)
    d_px = gather.gather_image(depth, vi, ui)
    if fg is None:
        if depth_max is None:
            raise ValueError("carve_ztest needs fg or depth_max")
        fg_px = d_px < depth_max * (1.0 - 1e-4)
    else:
        fg_px = gather.gather_image(fg.float(), vi, ui) > 0.5
    free = in_img & fg_px & (z < d_px - margin[:, None])
    return free.float()


def update_prob_grid(prob_grid: torch.Tensor, hit_grid: torch.Tensor,
                     traversed: torch.Tensor) -> torch.Tensor:
    """prob' = where(hit, 1.0, prob - 0.05 * traversed)."""
    return torch.where(hit_grid > 0.5, spec.OCCUPIED_VALUE,
                       prob_grid - spec.CARVE_DELTA * traversed)
