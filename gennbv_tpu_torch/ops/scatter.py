"""Voxel-cell any-hit scatter (port of ``ops/pallas_scatter.py``).

``scatter_cells_any(idx, valid, g)`` returns the {0, 1} float grid
[N, G, G, G] that holds 1.0 at the cells of the valid points: what the JAX
package's Pallas kernel ``pallas_scatter.scatter_cells_any`` and
``mxu.scatter_cells_any`` produce.  The env step's hit grid is this
scatter (``voxel.scatter_hits``).

The device of the tensors picks the implementation.  CUDA tensors launch
the hand-written kernel ``csrc/scatter_cells_any.cu`` once (and raise if
it cannot run); CPU tensors run the plain PyTorch version
``scatter_cells_any_ref``.  There is no fallback from one to the other.

The kernel runs one CTA per env, which holds the env's grid as byte flags
in shared memory; ``flag_bytes`` says how many.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from gennbv_tpu_torch.ops import _cuda
from gennbv_tpu_torch.utils import profiling
from gennbv_tpu_torch.utils.work import count_kernel


def scatter_cells_any_ref(idx: torch.Tensor, valid: torch.Tensor,
                          g: int) -> torch.Tensor:
    """Plain PyTorch version: idx [N, P, 3] int32 (in range), valid [N, P]
    bool -> [N, G, G, G] float32.  Invalid points write to a spare cell
    past the grid, which is dropped; every write stores the same 1.0, so
    the scatter is idempotent and order-free."""
    n = idx.shape[0]
    flat = (idx[..., 0].long() * g + idx[..., 1]) * g + idx[..., 2]
    flat = torch.where(valid, flat, g ** 3)
    grid = torch.zeros(n, g ** 3 + 1, device=idx.device)
    grid.scatter_(1, flat, 1.0)
    return grid[:, : g ** 3].reshape(n, g, g, g)


def work(idx: torch.Tensor, valid: torch.Tensor, g: int) -> tuple[int, int]:
    """The least a call must do on these inputs, for its bound and
    ``utils/work.WorkCounter``: bytes -- the validity of every point (1 B),
    the indices of the valid ones (12 B), the grid written once (4 B a cell)
    -- and operations, a flat index and a store per valid point."""
    n, q, _ = idx.shape
    nvalid = int(valid.sum())
    return n * q + 12 * nvalid + 4 * n * g ** 3, 5 * nvalid


def _check(idx: torch.Tensor, valid: torch.Tensor) -> None:
    if idx.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"scatter_cells_any: idx must be int32 and valid "
                        f"bool, got {idx.dtype}/{valid.dtype}")
    if idx.dim() != 3 or idx.shape[2] != 3 or valid.shape != idx.shape[:2]:
        raise ValueError("scatter_cells_any: expected idx [N, P, 3] and valid "
                         f"[N, P], got {tuple(idx.shape)}, {tuple(valid.shape)}")
    if idx.device != valid.device:
        raise ValueError(f"scatter_cells_any: tensors on different devices "
                         f"({idx.device}, {valid.device})")
    if not (idx.is_contiguous() and valid.is_contiguous()):
        raise ValueError("scatter_cells_any: tensors must be contiguous")


def flag_bytes(g: int) -> int:
    """Shared memory the kernel's CTA takes for a G^3 grid: one byte a
    cell, rounded up to a multiple of 16 for 16-byte stores.  Raises where
    the grid does not fit in one CTA's shared memory."""
    nbytes = -(-(g ** 3) // 16) * 16
    if nbytes > _cuda.SHARED_PER_CTA:
        raise ValueError(f"scatter_cells_any: G^3 = {g ** 3} flags exceed "
                         f"the {_cuda.SHARED_PER_CTA} B of shared memory of "
                         "one CTA")
    return nbytes


def scatter_cells_any(idx: torch.Tensor, valid: torch.Tensor,
                      g: int) -> torch.Tensor:
    """idx [N, P, 3] int32 in [0, G), valid [N, P] bool -> [N, G, G, G]
    float32 any-hit grid.  Counts its kernel launches in the counter
    ``kernel/scatter_cells_any/launches``.  The kernel writes every cell,
    so the grid is not zeroed first."""
    _check(idx, valid)
    if idx.device.type == "cpu":
        return scatter_cells_any_ref(idx, valid, g)
    if idx.device.type != "cuda":
        raise ValueError(f"scatter_cells_any: no kernel for device {idx.device}")
    smem = flag_bytes(g)
    n, p, _ = idx.shape
    grid = torch.empty(n, g, g, g, dtype=torch.float32, device=idx.device)
    if n == 0:
        return grid
    err = _cuda.launch(idx.get_device(), _launcher(), idx.data_ptr(),
                       valid.data_ptr(), grid.data_ptr(), n, p, g, smem)
    if err != 0:
        raise RuntimeError(f"scatter_cells_any kernel launch failed: CUDA "
                           f"error {err}")
    profiling.count("kernel/scatter_cells_any/launches")
    count_kernel(work, idx, valid, g)
    return grid


@functools.cache
def _launcher():
    fn = _cuda.load_library("scatter_cells_any").scatter_cells_any
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
