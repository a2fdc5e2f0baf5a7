"""The nearest-neighbour minima on the card: ``chamfer._row_mins``'s CUDA
path.

``nn_min(a, a_mask, b, b_mask, exclude_self)`` takes what
``chamfer._row_mins`` takes (but its CPU loop's chunk) and returns what
that loop returns, bit for bit: each valid query's least squared distance
to the valid targets of its env, 1e10 where the query is masked out or no
target counts (with ``exclude_self``, row i skips target i, and only that
index).  It launches the hand-written kernel ``csrc/nn_min.cu`` once, a
CTA for 256 query rows of an env, and raises on a tensor that is not on a
CUDA device.  No TPU kernel is ported here: the JAX package's chamfer is
plain jnp, as the plain loop is.

Each env's pairs run to its own extents, which the kernel finds on the
device (no host wait); ``pairs`` counts them from the host's copies of the
masks, as ``algo/evaluation.py``'s ``batched_accuracy`` does for the
counter ``accuracy/nn_pairs``.  The call counts one in
``kernel/nn_min/launches`` where it launches (N and P above 0).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from gennbv_tpu_torch.ops import _cuda
from gennbv_tpu_torch.utils import profiling
from gennbv_tpu_torch.utils.work import count_kernel

# csrc/nn_min.cu's geometry: a CTA's query rows (kRows), a warp's
# (kWarpRows: a warp whose rows hold no valid query computes nothing), and
# the targets read at once (kGroup: an env's targets run to its extent
# rounded up to it)
ROWS, WARP_ROWS, GROUP = 256, 64, 4
# one pair: three subtractions, a product, two fused multiply-adds at two
# each, and the min (benchmark/work/chamfer.py counts the same)
OPS_PER_PAIR = 8


def pairs(a_mask: np.ndarray, b_mask: np.ndarray) -> int:
    """The point pairs a call computes on host masks a_mask [N, P] and
    b_mask [N, Q]: each env's WARP_ROWS rows of every warp that holds a
    valid query, times its target extent (one past its last valid
    target) rounded up to GROUP."""
    a_mask, b_mask = np.asarray(a_mask, bool), np.asarray(b_mask, bool)
    n, p = a_mask.shape
    rows = np.zeros((n, -(-p // WARP_ROWS) * WARP_ROWS), bool)
    rows[:, :p] = a_mask
    active = rows.reshape(n, -1, WARP_ROWS).any(-1).sum(-1) * WARP_ROWS
    q = b_mask.shape[1]
    extent = np.where(b_mask.any(-1), q - b_mask[:, ::-1].argmax(-1), 0)
    return int((active * (-(-extent // GROUP) * GROUP)).sum())


def work(a: torch.Tensor, a_mask: torch.Tensor, b: torch.Tensor,
         b_mask: torch.Tensor) -> tuple[int, int]:
    """The least a call must do on these inputs, for
    ``utils/work.WorkCounter``: bytes -- each valid point read once (12 B),
    each valid query's minimum written (4 B) -- and operations,
    OPS_PER_PAIR a pair of a valid query and a valid target of its env."""
    am = a_mask.reshape(-1, a_mask.shape[-1]).sum(-1).long()
    bm = b_mask.reshape(-1, b_mask.shape[-1]).sum(-1).long()
    return (int(16 * am.sum() + 12 * bm.sum()),
            OPS_PER_PAIR * int((am * bm).sum()))


def nn_min(a: torch.Tensor, a_mask: torch.Tensor, b: torch.Tensor,
           b_mask: torch.Tensor, exclude_self: bool = False) -> torch.Tensor:
    """a [..., P, 3] and b [..., Q, 3] float32 points (finite), a_mask
    [..., P] and b_mask [..., Q] bool, one leading shape, all on one CUDA
    device -> [..., P] float32 minima."""
    if a.dtype is not torch.float32 or b.dtype is not torch.float32:
        raise TypeError(f"nn_min: points must be float32, got {a.dtype} and "
                        f"{b.dtype}")
    if a_mask.dtype is not torch.bool or b_mask.dtype is not torch.bool:
        raise TypeError(f"nn_min: masks must be bool, got {a_mask.dtype} and "
                        f"{b_mask.dtype}")
    lead, p = a.shape[:-2], a.shape[-2]
    q = b.shape[-2] if b.dim() >= 2 else -1
    if (a.dim() < 2 or a.shape[-1] != 3 or b.shape != (*lead, q, 3)
            or a_mask.shape != (*lead, p) or b_mask.shape != (*lead, q)):
        raise ValueError(f"nn_min: a {list(a.shape)}, a_mask "
                         f"{list(a_mask.shape)}, b {list(b.shape)} and b_mask "
                         f"{list(b_mask.shape)} do not fit [..., P, 3], "
                         "[..., P], [..., Q, 3] and [..., Q]")
    tensors = (a, a_mask, b, b_mask)
    device = a.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError("nn_min: the kernel takes tensors on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    n = math.prod(lead)
    a3, b3 = a.reshape(n, p, 3).contiguous(), b.reshape(n, q, 3).contiguous()
    am = a_mask.reshape(n, p).contiguous().view(torch.uint8)
    bm = b_mask.reshape(n, q).contiguous().view(torch.uint8)
    out = torch.empty(n, p, dtype=torch.float32, device=device)
    if n * p:
        err = _cuda.launch(a.get_device(), _launcher(), a3.data_ptr(),
                           am.data_ptr(), b3.data_ptr(), bm.data_ptr(),
                           out.data_ptr(), n, p, q, int(exclude_self))
        if err != 0:
            raise RuntimeError(f"nn_min kernel launch failed: CUDA error "
                               f"{err}")
        profiling.count("kernel/nn_min/launches")
        count_kernel(work, a, a_mask, b, b_mask)
    return out.reshape(*lead, p)


@functools.cache
def _launcher():
    fn = _cuda.load_library("nn_min").nn_min
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
