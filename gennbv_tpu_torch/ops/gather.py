"""Per-point image gather with bf16 rounding (port of ``ops/pallas_gather.py``).

``gather_image(img, vi, ui)`` returns ``img.to(bfloat16)[vi, ui]`` as
float32 for a batch of images: the value the JAX package's Pallas kernel
``pallas_gather.gather_image`` and ``mxu.gather_image(exact=False)``
produce.  The splat visibility test and the z-test carve read the pooled
z-buffer through it.

The device of the tensors picks the implementation.  CUDA tensors launch
the hand-written kernel ``csrc/gather_image.cu`` (and raise if it cannot
run); CPU tensors run the plain PyTorch version ``gather_image_ref``.
There is no fallback from one to the other.

The kernel runs a 1-D grid in which each thread takes ``PER_THREAD``
queries; ``launch_geometry`` picks the vector path (one vector of
``VECTOR`` consecutive queries a thread, 16-byte loads and stores) where q
is a multiple of ``VECTOR`` and the index arrays are 16-byte aligned, and
the scalar path (single queries) where either fails, as for a ragged q or
a contiguous view one int32 into its buffer.  Both give the same bits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from gennbv_tpu_torch.ops import _cuda
from gennbv_tpu_torch.utils import profiling
from gennbv_tpu_torch.utils.work import count_kernel


def gather_image_ref(img: torch.Tensor, vi: torch.Tensor,
                     ui: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: img [N, H, W] float32, vi/ui [N, Q] int32
    (in range) -> [N, Q] float32."""
    n, h, w = img.shape
    flat = img.to(torch.bfloat16).float().reshape(n, h * w)
    return torch.gather(flat, 1, vi.long() * w + ui.long())


def work(img: torch.Tensor, vi: torch.Tensor,
         ui: torch.Tensor) -> tuple[int, int]:
    """The least a call must do on these inputs, for its bound and
    ``utils/work.WorkCounter``: bytes -- each distinct pixel read once
    (4 B), the two index arrays (8 B a query), the output (4 B a query) --
    and operations, two a query."""
    n, h, w = img.shape
    q = vi.shape[1]
    env = torch.arange(n, device=img.device)[:, None] * (h * w)
    distinct = torch.unique(vi.long() * w + ui.long() + env).numel()
    return 4 * distinct + 12 * n * q, 2 * n * q


# queries a vector on the vector path (int4 loads, float4 stores)
VECTOR = 4
# queries a thread and threads a CTA (csrc/gather_image.cu's kPerThread
# and kThreads): chosen by timing at the rollout's [256, 128, 128] x
# [256, 8000] and the eval's [50, 400, 400] x [50, 8000] on an H100
# (PERF.md, section 6)
PER_THREAD = 4
THREADS = 256
# n * q must stay below this: the kernel indexes queries in 32 bits
MAX_QUERIES = 2 ** 31


class Geometry(NamedTuple):
    """How the kernel is launched: ``path`` "vector" or "scalar",
    ``width`` queries a vector (4 or 1) and ``ctas`` CTAs of ``THREADS``
    in a 1-D grid, ``PER_THREAD`` queries a thread."""
    path: str
    width: int
    ctas: int


def _width(n: int, q: int, address: int) -> int:
    """``VECTOR`` where q is a multiple of it (no vector straddles two
    envs) and `address`, the OR of the index arrays' addresses, is
    16-byte aligned; else 1.  Raises on more queries than the kernel
    indexes."""
    if n * q >= MAX_QUERIES:
        raise ValueError(f"gather_image: {n} x {q} queries, the kernel takes "
                         f"fewer than 2^31")
    return VECTOR if q % VECTOR == 0 and address % 16 == 0 else 1


def launch_geometry(n: int, q: int, *pointers: int) -> Geometry:
    """The launch for [N, Q] queries whose index arrays start at the
    device addresses `pointers`: vectors of ``VECTOR`` queries where Q is
    a multiple of it and every pointer is 16-byte aligned, else single
    queries."""
    address = 0
    for p in pointers:
        address |= p
    width = _width(n, q, address)
    return Geometry("vector" if width == VECTOR else "scalar", width,
                    -(-(n * q) // (PER_THREAD * THREADS)))


def _check(img: torch.Tensor, vi: torch.Tensor, ui: torch.Tensor) -> None:
    """Raises on a type, shape or layout the kernel does not take."""
    if img.dtype is not torch.float32:
        raise TypeError(f"gather_image: img must be float32, got {img.dtype}")
    if vi.dtype is not torch.int32 or ui.dtype is not torch.int32:
        raise TypeError(f"gather_image: vi/ui must be int32, got "
                        f"{vi.dtype}/{ui.dtype}")
    shape = vi.shape
    if img.ndim != 3 or len(shape) != 2 or shape != ui.shape \
            or shape[0] != img.shape[0]:
        raise ValueError(
            "gather_image: expected img [N, H, W] and vi/ui [N, Q], got "
            f"{tuple(img.shape)}, {tuple(vi.shape)}, {tuple(ui.shape)}")
    if not (img.is_contiguous() and vi.is_contiguous() and ui.is_contiguous()):
        raise ValueError("gather_image: tensors must be contiguous")


def gather_image(img: torch.Tensor, vi: torch.Tensor,
                 ui: torch.Tensor) -> torch.Tensor:
    """img [N, H, W] float32 and in-range vi/ui [N, Q] int32 -> [N, Q]
    float32 ``bf16(img[n, vi, ui])``.  Counts its kernel launches in the
    counter ``kernel/gather_image/launches``."""
    _check(img, vi, ui)
    # the kernel's case first, tested without building device objects
    if img.is_cuda and vi.is_cuda and ui.is_cuda \
            and img.get_device() == vi.get_device() == ui.get_device():
        return _launch(img, vi, ui)
    device = img.device
    if vi.device != device or ui.device != device:
        raise ValueError(f"gather_image: tensors on different devices "
                         f"({img.device}, {vi.device}, {ui.device})")
    if device.type == "cpu":
        return gather_image_ref(img, vi, ui)
    raise ValueError(f"gather_image: no kernel for device {device}")


def _launch(img: torch.Tensor, vi: torch.Tensor, ui: torch.Tensor) -> torch.Tensor:
    """The kernel on checked CUDA tensors, on the path that
    ``launch_geometry`` gives."""
    n, h, w = img.shape
    q = vi.shape[1]
    vp, up = vi.data_ptr(), ui.data_ptr()
    width = _width(n, q, vp | up)
    out = torch.empty_like(vi, dtype=torch.float32)     # [N, Q], contiguous
    if n * q == 0:
        return out
    err = _cuda.launch(img.get_device(), _launcher(), img.data_ptr(), vp, up,
                       out.data_ptr(), n, q, h, w, width)
    if err != 0:
        raise RuntimeError(f"gather_image kernel launch failed: CUDA error {err}")
    profiling.count("kernel/gather_image/launches")
    count_kernel(work, img, vi, ui)
    return out


@functools.cache
def _launcher():
    fn = _cuda.load_library("gather_image").gather_image
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
