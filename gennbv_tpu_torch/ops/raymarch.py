"""The voxel DDA ray march on the card: ``render.raymarch``'s CUDA path.

``raymarch(occ_flat, box_lo, box_hi, origin, dirs, grid_res, max_steps,
depth_max)`` takes what ``render.raymarch`` takes and returns what its
plain loop (``render.raymarch_ref``) returns, bit for bit: each ray's
first-hit depth and hit flag.  It launches the hand-written kernel
``csrc/raymarch.cu`` once, a thread a ray, and raises on a tensor that is
not on a CUDA device.  No TPU kernel is ported here: the JAX package
marches in an XLA loop, as the plain loop does.

Any leading batch shape, any number of rays, any ``grid_res`` and
``max_steps`` are taken as they come; occupancy of any dtype is solid
where > 0 (uint8 and bool are read as they are, another dtype is compared
first).  The call counts one in ``kernel/raymarch/launches``, always.
While spans record (``utils/profiling.recording``) it also adds the
voxels its rays read, summed on the device, to ``raymarch/voxel_reads``
(read on the host only by ``profiling.counters``); inside a
``utils/work.WorkCounter`` it counts the reads too, for ``work``.
Otherwise the kernel is given no counter and does no atomics.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from gennbv_tpu_torch.ops import _cuda
from gennbv_tpu_torch.utils import profiling
from gennbv_tpu_torch.utils.work import count_kernel, counting

# one DDA iteration: the solid test, two comparisons choosing the axis,
# the next crossing's add, the voxel's and the flat index's steps, the
# bounds test and the count (the benchmark's own count also takes 8)
OPS_PER_READ = 8


def work(occ: torch.Tensor, dirs: torch.Tensor,
         reads: torch.Tensor) -> tuple[int, int]:
    """The least a call must do on these inputs, for the bench's count:
    bytes -- each env's grid read once, each ray's direction read (12 B),
    its depth and hit written (5 B) -- and operations, OPS_PER_READ a voxel
    read (`reads`, the kernel's count)."""
    rays = dirs.numel() // 3
    return occ.numel() + 17 * rays, OPS_PER_READ * int(reads)


def raymarch(occ_flat: torch.Tensor, box_lo: torch.Tensor,
             box_hi: torch.Tensor, origin: torch.Tensor, dirs: torch.Tensor,
             grid_res: int, max_steps: int, depth_max: float
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """occ_flat [..., R^3], box_lo, box_hi and origin [..., 3] float32,
    dirs [..., P, 3] float32, all on one CUDA device -> (depth [..., P]
    float32, hit [..., P] bool); depth = depth_max where no hit."""
    tensors = (occ_flat, box_lo, box_hi, origin, dirs)
    device = dirs.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError("raymarch: the kernel takes tensors on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype is not torch.float32 for t in tensors[1:]):
        raise TypeError("raymarch: box_lo, box_hi, origin and dirs must be "
                        f"float32, got {[t.dtype for t in tensors[1:]]}")
    lead, p = dirs.shape[:-2], dirs.shape[-2]
    b, r = math.prod(lead), grid_res
    occ = occ_flat.reshape(b, r ** 3)
    if occ.dtype is torch.bool:
        occ = occ.view(torch.uint8)
    elif occ.dtype is not torch.uint8:
        occ = (occ > 0).to(torch.uint8)
    occ = occ.contiguous()
    lo, hi, org = (t.reshape(b, 3).contiguous()
                   for t in (box_lo, box_hi, origin))
    dirs = dirs.reshape(b, p, 3).contiguous()
    depth = torch.empty(b, p, dtype=torch.float32, device=device)
    hit = torch.empty(b, p, dtype=torch.bool, device=device)
    if b * p:
        recording = profiling.recording()
        reads = (torch.zeros((), dtype=torch.int64, device=device)
                 if recording or counting() else None)
        err = _cuda.launch(
            dirs.get_device(), _launcher(), occ.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), org.data_ptr(), dirs.data_ptr(), depth.data_ptr(),
            hit.data_ptr(), None if reads is None else reads.data_ptr(), b, p,
            r, max_steps, depth_max)
        if err != 0:
            raise RuntimeError(f"raymarch kernel launch failed: CUDA error "
                               f"{err}")
        profiling.count("kernel/raymarch/launches")
        if reads is not None:
            if recording:
                profiling.count("raymarch/voxel_reads", reads)
            count_kernel(work, occ, dirs, reads)
    return depth.reshape(*lead, p), hit.reshape(*lead, p)


@functools.cache
def _launcher():
    fn = _cuda.load_library("raymarch").raymarch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
