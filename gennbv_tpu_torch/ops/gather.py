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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from gennbv_tpu_torch.ops import _cuda


def gather_image_ref(img: torch.Tensor, vi: torch.Tensor,
                     ui: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: img [N, H, W] float32, vi/ui [N, Q] int32
    (in range) -> [N, Q] float32."""
    n, h, w = img.shape
    flat = img.to(torch.bfloat16).float().reshape(n, h * w)
    return torch.gather(flat, 1, vi.long() * w + ui.long())


def _check(img: torch.Tensor, vi: torch.Tensor, ui: torch.Tensor) -> None:
    if img.dtype != torch.float32:
        raise TypeError(f"gather_image: img must be float32, got {img.dtype}")
    if vi.dtype != torch.int32 or ui.dtype != torch.int32:
        raise TypeError(f"gather_image: vi/ui must be int32, got "
                        f"{vi.dtype}/{ui.dtype}")
    if img.dim() != 3 or vi.dim() != 2 or vi.shape != ui.shape \
            or vi.shape[0] != img.shape[0]:
        raise ValueError(
            "gather_image: expected img [N, H, W] and vi/ui [N, Q], got "
            f"{tuple(img.shape)}, {tuple(vi.shape)}, {tuple(ui.shape)}")
    if not (img.device == vi.device == ui.device):
        raise ValueError(f"gather_image: tensors on different devices "
                         f"({img.device}, {vi.device}, {ui.device})")
    if not (img.is_contiguous() and vi.is_contiguous() and ui.is_contiguous()):
        raise ValueError("gather_image: tensors must be contiguous")


def gather_image(img: torch.Tensor, vi: torch.Tensor,
                 ui: torch.Tensor) -> torch.Tensor:
    """img [N, H, W] float32 and in-range vi/ui [N, Q] int32 -> [N, Q]
    float32 ``bf16(img[n, vi, ui])``.  Counts its kernel launches in
    ``gather_image.launches``."""
    _check(img, vi, ui)
    if img.device.type == "cpu":
        return gather_image_ref(img, vi, ui)
    if img.device.type != "cuda":
        raise ValueError(f"gather_image: no kernel for device {img.device}")
    n, h, w = img.shape
    out = torch.empty(vi.shape, dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = _launcher()(img.data_ptr(), vi.data_ptr(), ui.data_ptr(),
                          out.data_ptr(), n, vi.shape[1], h, w, stream)
    if err != 0:
        raise RuntimeError(f"gather_image kernel launch failed: CUDA error {err}")
    gather_image.launches += 1
    return out


gather_image.launches = 0


@functools.cache
def _launcher():
    fn = _cuda.load_library("gather_image").gather_image
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
