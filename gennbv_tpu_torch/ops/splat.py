"""Surface-splatting depth renderer (port of ``gennbv_tpu/ops/splat.py``).

Each scene's surface voxel centers [Q, 3] are projected into the camera,
min-reduced into a z-buffer, widened by a 3x3 min-pool (the splat
footprint), and tested for visibility against the pooled z-buffer.
Everything is batched over a leading env axis N.

The z-buffer has the semantics of the JAX package's default
``zbuf_impl="mxu"`` path (``mxu.depth_digits`` + ``mxu.scatter_min_image``):
depths are bucketed into two decimal digits (d1, d2) over each frame's
valid z range, the per-pixel minimum bucket is taken, and the pixel depth
is the bucket's midpoint.  The JAX package takes that minimum in two radix
passes of one-hot matmuls, because XLA lowers scatters badly on a TPU.
Here it is one integer-key min, ``key = d1 * 10 + d2`` with
``scatter_reduce_("amin")``: the same lexicographic minimum, exact for any
number of points per pixel (the radix form goes one bucket low once a
(pixel, bucket) pair holds 2^12 points or more).

The device of the tensors picks the implementation, whatever
``renderer.zbuf_impl`` says ("mxu" or "pallas"): on CUDA tensors
``splat_depth`` runs the z-buffer, pool and visibility as the fused CUDA
kernel of ``ops/fused_splat.py`` (the port of the JAX package's Pallas
kernel); on CPU tensors it runs their plain composition ``zbuf_vis_px``.
Both give the same bits.

``zbuf_impl="scatter"`` is another function: the JAX package's exact
scatter-min of the unquantized depths (``_zbuf_px``'s scatter branch, plain
XLA there; ``tools/bench_scatter.py`` holds a Pallas form of it), pooled
alike, with the visibility slack not widened.  The port runs it as
``zbuf_scatter_vis_px``: the z-buffer from
``zbuf_scatter.zbuf_scatter_min`` (its CUDA kernel on the card, its plain
version on the CPU), the pool, then the visibility read through
``gather.gather_image`` (likewise).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from gennbv_tpu_torch.ops import fp32, gather, zbuf_scatter
from gennbv_tpu_torch.ops.camera import pixel_index
from gennbv_tpu_torch.utils import profiling

LEVELS = 10                      # levels per depth digit (mxu.scatter_min_image)
EMPTY_KEY = LEVELS * LEVELS      # key of a pixel that no valid point reaches


def project_px(surf_pts, surf_mask, k, r_c2w, t_c2w, height: int, width: int):
    """Project world points into the camera.  surf_pts [N, Q, 3], surf_mask
    [N, Q], k [3, 3], r_c2w [N, 3, 3], t_c2w [N, 3].  Returns (vic, uic)
    clipped int32 pixel coordinates, z-depth and validity (in front of the
    1e-3 near plane, in the image, not padding), each [N, Q]."""
    # p_cam = R^T (p - t), rounded as the reference's projection dot
    p_cam = fp32.rotate(surf_pts - t_c2w[:, None, :], r_c2w)
    z = p_cam[..., 2]
    in_front = (z > 1e-3) & surf_mask
    safe_z = torch.where(in_front, z, 1.0)
    u = k[0, 0] * p_cam[..., 0] / safe_z + k[0, 2]
    v = k[1, 1] * p_cam[..., 1] / safe_z + k[1, 2]
    ui = pixel_index(u, width)
    vi = pixel_index(v, height)
    ok = in_front & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    return vi.clamp(0, height - 1), ui.clamp(0, width - 1), z, ok


def depth_digits(z: torch.Tensor, valid: torch.Tensor, levels: int = LEVELS):
    """Two-digit bucketing of depths over each frame's valid z range
    (``mxu.depth_digits``).  z/valid [N, Q] -> (d1, d2 [N, Q] float32,
    zmin [N], zrange [N]).  A frame with no valid point gets zmin = +inf
    and zrange = 1e-3, as in the reference."""
    inf = torch.tensor(float("inf"), device=z.device)
    zmin = torch.where(valid, z, inf).amin(-1)
    zmax = torch.where(valid, z, -inf).amax(-1)
    zrange = torch.clamp_min(zmax - zmin, 1e-3)
    t = torch.clamp((z - zmin[:, None]) / zrange[:, None] * levels,
                    0.0, levels - 1e-3)
    d1 = torch.floor(t)
    d2 = torch.floor((t - d1) * levels)
    return d1, d2, zmin, zrange


def zbuf_keymin(vic, uic, z, ok, height: int, width: int, depth_max: float):
    """Unpooled z-buffer [N, H*W] and the quantization step [N].

    The per-pixel minimum of ``key = d1 * 10 + d2`` over valid points
    (invalid points carry the sentinel 100, so they never win), decoded to
    the bucket midpoint as ``mxu.scatter_min_image`` decodes its two radix
    digits.  Pixels no valid point reaches hold depth_max."""
    n = z.shape[0]
    d1, d2, zmin, zrange = depth_digits(z, ok)
    key = torch.where(ok, (d1 * LEVELS + d2).to(torch.int32), EMPTY_KEY)
    env = torch.arange(n, device=z.device)[:, None] * (height * width)
    pix = env + vic.long() * width + uic.long()
    keymin = torch.full((n * height * width,), EMPTY_KEY, dtype=torch.int32,
                        device=z.device)
    keymin.scatter_reduce_(0, pix.reshape(-1), key.reshape(-1), reduce="amin")
    keymin = keymin.reshape(n, height * width)
    m1 = (keymin // LEVELS).float()
    m2 = (keymin % LEVELS).float()
    # zq = zmin + (m1 + (m2 + 0.5) / 10) / 10 * zrange, rounded as XLA
    # compiles it in the reference: each division by 10 becomes a product
    # with 0.1f, the outer one moved onto the per-frame zrange, and the
    # last sum is a fused multiply-add
    frac10 = m1 + fp32.div_const(m2 + 0.5, LEVELS)
    zq = fp32.fma(frac10, fp32.div_const(zrange, LEVELS)[:, None], zmin[:, None])
    zbuf = torch.where(keymin < EMPTY_KEY, zq, depth_max)
    return zbuf, fp32.div_const(zrange, LEVELS * LEVELS)


def min_pool(z2d: torch.Tensor, footprint: int, depth_max: float) -> torch.Tensor:
    """(2f+1)^2 min-pool of [N, H, W] with "SAME" padding by depth_max, as
    the reference's ``reduce_window(z, depth_max, min, ...)``: depth_max
    is also the window's initial value, so results never exceed it."""
    if footprint == 0:
        return z2d
    f = footprint
    padded = F.pad(z2d[:, None], (f, f, f, f), value=depth_max)
    pooled = -F.max_pool2d(-padded, 2 * f + 1, stride=1)
    return torch.clamp_max(pooled[:, 0], depth_max)


def zbuf_vis_px(vic, uic, z, ok, height: int, width: int, depth_max: float,
                voxel_eps: torch.Tensor, footprint: int = 1):
    """Pooled z-buffer [N, H*W] and per-point visibility [N, Q] from
    projected pixel coordinates: the plain version of the fused kernel
    (``fused_splat.zbuf_visible``).  A point is visible when its depth is
    within ``voxel_eps + zrange/100`` (slack widened by the quantization
    step) of the pooled z-buffer at its pixel, read rounded to bf16."""
    n = z.shape[0]
    zbuf0, quant = zbuf_keymin(vic, uic, z, ok, height, width, depth_max)
    zbuf2d = min_pool(zbuf0.reshape(n, height, width), footprint, depth_max)
    eps = voxel_eps + quant
    z_at_px = gather.gather_image_ref(zbuf2d, vic, uic)
    visible = ok & (z <= z_at_px + eps[:, None])
    return zbuf2d.reshape(n, height * width), visible


def zbuf_scatter_vis_px(vic, uic, z, ok, height: int, width: int,
                        depth_max: float, voxel_eps: torch.Tensor,
                        footprint: int = 1):
    """``zbuf_impl="scatter"``: pooled z-buffer [N, H*W] of the exact
    per-pixel minimum depth of the valid points (depth_max where none),
    and visibility [N, Q] with slack voxel_eps [N], the pooled depth read
    rounded to bf16 by ``gather.gather_image``.  The unpooled z-buffer is
    ``zbuf_scatter.zbuf_scatter_min`` of each point's pixel in its own
    env's image and its depth, depth_max where it is not valid.  The
    z-buffer, pool and visibility lie in the device-timed span
    ``env/render/zbuf`` (recorded only while spans record)."""
    n = z.shape[0]
    with profiling.device_span("env/render/zbuf", z.device):
        zbuf0 = zbuf_scatter.zbuf_scatter_min(vic * width + uic,
                                              torch.where(ok, z, depth_max),
                                              height, width, depth_max)
        zbuf2d = min_pool(zbuf0, footprint, depth_max)
        z_at_px = gather.gather_image(zbuf2d, vic, uic)
        visible = ok & (z <= z_at_px + voxel_eps[:, None])
    return zbuf2d.reshape(n, height * width), visible


def splat_depth(surf_pts, surf_mask, k, r_c2w, t_c2w, height: int, width: int,
                depth_max: float, voxel_eps: torch.Tensor, footprint: int = 1,
                zbuf_impl: str = "mxu"):
    """Returns (zbuf [N, H*W], fg [N, H*W] bool, visible [N, Q] bool),
    through the fused kernel on CUDA tensors and its plain version on CPU
    tensors, or, under zbuf_impl "scatter", ``zbuf_scatter_vis_px``."""
    # imported here: fused_splat's plain version is this module's zbuf_vis_px
    from gennbv_tpu_torch.ops import fused_splat
    vic, uic, z, ok = project_px(surf_pts, surf_mask, k, r_c2w, t_c2w,
                                 height, width)
    if zbuf_impl == "scatter":
        zbuf, visible = zbuf_scatter_vis_px(vic, uic, z, ok, height, width,
                                            depth_max, voxel_eps, footprint)
    else:
        # z is a column of p_cam: the kernel takes it packed
        zbuf, visible = fused_splat.zbuf_visible(
            vic, uic, z.contiguous(), ok, voxel_eps.contiguous(), height,
            width, depth_max, footprint)
    fg = zbuf < depth_max - 1e-6
    return zbuf, fg, visible


def splat_depth_batch(surf_pts, surf_mask, k, r_c2w, t_c2w, height: int,
                      width: int, depth_max: float, voxel_eps: torch.Tensor,
                      footprint: int = 1, skip_env=None,
                      zbuf_impl: str = "mxu"):
    """The JAX package's batched splat on its dense branch: ``splat_depth``
    with every point of the envs in ``skip_env`` [N] bool masked out (the
    caller substitutes their outputs from the init-view cache).  Its
    survivor compaction and row banding only shorten the TPU's matrix
    products and are bit-identical to the dense branch
    (gennbv_tpu/ops/splat.py:436-457), so the port runs the dense branch
    for them."""
    if skip_env is not None:
        surf_mask = surf_mask & ~skip_env[:, None]
    return splat_depth(surf_pts, surf_mask, k, r_c2w, t_c2w, height, width,
                       depth_max, voxel_eps, footprint, zbuf_impl)
