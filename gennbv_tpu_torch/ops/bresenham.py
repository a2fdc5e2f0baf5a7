"""The Bresenham carve on the card: ``carve.bresenham_traversed``'s CUDA
path.

``bresenham(src, targets, target_valid, grid_size)`` takes what
``carve.bresenham_traversed`` takes and returns what its plain loop
(``carve.bresenham_traversed_ref``) returns, bit for bit: the [N, G, G, G]
{0, 1} float32 mask of the in-grid voxels on the valid rays.  A call is a
zero fill of the mask and one launch of the hand-written kernel
``csrc/bresenham.cu``, a thread a (env, target) ray; it raises on a
tensor that is not on a CUDA device.  No TPU kernel is ported here: the
JAX package carves in an XLA loop, as the plain loop does.

Any N and G are taken, and targets as [R, 3] (every env's, read with a
stride of 0) or [N, R, 3] (each env's own).  The call counts one in
``kernel/bresenham/launches`` where it launches (N and R above 0).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from gennbv_tpu_torch import spec
from gennbv_tpu_torch.ops import _cuda
from gennbv_tpu_torch.utils import profiling
from gennbv_tpu_torch.utils.work import count_kernel

# one point of a ray: the bounds test (3), the flat index (2), the two
# error-term tests (2), the three coordinate steps (3) and the two
# error-term updates (2)
OPS_PER_POINT = 12


def work(src: torch.Tensor, targets: torch.Tensor, target_valid: torch.Tensor,
         grid_size: int) -> tuple[int, int]:
    """The least a call must do on these inputs, for
    ``utils/work.WorkCounter``: bytes -- each ray's flag (1 B), each
    camera voxel and each target row passed (12 B), the mask written once
    (4 B a cell) -- and operations, OPS_PER_POINT a point of each valid
    ray, min(its largest distance, 3G - 1) + 1 points."""
    n, g = src.shape[0], grid_size
    rows = targets.reshape(-1, target_valid.shape[-1], 3)
    dist = (rows.long() - src.long()[:, None]).abs().amax(-1)
    points = (dist.clamp_max(spec.BRESENHAM_MAX_PTS_FACTOR * g - 1) + 1
              ) * target_valid
    return (target_valid.numel() + 12 * (n + rows.shape[0] * rows.shape[1])
            + 4 * n * g ** 3, OPS_PER_POINT * int(points.sum()))


def bresenham(src: torch.Tensor, targets: torch.Tensor,
              target_valid: torch.Tensor, grid_size: int) -> torch.Tensor:
    """src [N, 3] integer camera voxels (may lie outside the grid),
    targets [R, 3] or [N, R, 3] integer in-grid voxels, target_valid
    [N, R] bool, all on one CUDA device -> [N, G, G, G] float32 {0, 1}."""
    tensors = (src, targets, target_valid)
    device = src.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError("bresenham: the kernel takes tensors on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if target_valid.dtype is not torch.bool:
        raise TypeError(f"bresenham: target_valid must be bool, got "
                        f"{target_valid.dtype}")
    n, r, g = src.shape[0], target_valid.shape[-1], grid_size
    if (src.shape != (n, 3) or target_valid.shape != (n, r)
            or targets.shape not in ((r, 3), (1, r, 3), (n, r, 3))):
        raise ValueError(f"bresenham: src {list(src.shape)}, targets "
                         f"{list(targets.shape)} and target_valid "
                         f"{list(target_valid.shape)} do not fit [N, 3], "
                         "[R, 3] or [N, R, 3], and [N, R]")
    rows = targets.to(torch.int32).reshape(-1, r, 3).contiguous()
    cams = src.to(torch.int32).contiguous()
    valid = target_valid.contiguous().view(torch.uint8)
    out = torch.zeros(n, g, g, g, device=device)
    if n * r:
        err = _cuda.launch(
            src.get_device(), _launcher(), cams.data_ptr(), rows.data_ptr(),
            0 if rows.shape[0] == 1 else 3 * r, valid.data_ptr(),
            out.data_ptr(), n, r, g, spec.BRESENHAM_MAX_PTS_FACTOR * g)
        if err != 0:
            raise RuntimeError(f"bresenham kernel launch failed: CUDA error "
                               f"{err}")
        profiling.count("kernel/bresenham/launches")
        count_kernel(work, cams, rows, target_valid, g)
    return out


@functools.cache
def _launcher():
    fn = _cuda.load_library("bresenham").bresenham
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
