"""Exact scatter-min z-buffer (port of ``tools/bench_scatter.py``'s Pallas
kernel ``zbuf_kernel``).

``zbuf_scatter_min(flat, zz, height, width, fill)`` returns the [N, H, W]
image whose pixel p holds the minimum of `fill` and every ``zz[n, i]``
with ``flat[n, i] == p``: the JAX package's exact z-buffer, the scatter
branch of ``gennbv_tpu/ops/splat.py::_zbuf_px``
(``zbuf.at[flat].min(where(ok, z, depth_max))``, ``renderer.zbuf_impl=
"scatter"``), and what the Pallas kernel of ``tools/bench_scatter.py``
computes with the fill DMAX.  ``splat.zbuf_scatter_vis_px`` takes its
z-buffer from it.

The device of the tensors picks the implementation.  CUDA tensors launch
the hand-written kernel ``csrc/zbuf_scatter_min.cu`` once (and raise if it
cannot run); CPU tensors run the plain PyTorch version
``zbuf_scatter_min_ref``.  There is no fallback from one to the other.

The kernel runs one CTA per (env, band of image rows), the band's pixels
as keys in shared memory; ``band_rows`` and ``ctas_per_env`` give the
geometry.  The min is order-free, so the kernel's result is
deterministic and equal bit for bit to the plain version's, except that
a pixel that gets both -0.0 and +0.0 holds -0.0 in the kernel, while
``scatter_reduce_`` compares the two as equal (the env's depths lie
beyond a 1e-3 near plane).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from gennbv_tpu_torch.ops import _cuda

# shared memory a pixel of a CTA's band takes: one uint32 key
BYTES_PER_PIXEL = 4


def zbuf_scatter_min_ref(flat: torch.Tensor, zz: torch.Tensor, height: int,
                         width: int, fill: float) -> torch.Tensor:
    """Plain PyTorch version: flat [N, Q] int32 in [0, H*W), zz [N, Q]
    float32 -> [N, H, W] float32."""
    n = flat.shape[0]
    out = torch.full((n, height * width), fill, dtype=torch.float32,
                     device=flat.device)
    out.scatter_reduce_(1, flat.long(), zz, reduce="amin")
    return out.reshape(n, height, width)


def _check(flat: torch.Tensor, zz: torch.Tensor) -> None:
    if flat.dtype != torch.int32 or zz.dtype != torch.float32:
        raise TypeError(f"zbuf_scatter_min: flat must be int32 and zz "
                        f"float32, got {flat.dtype}/{zz.dtype}")
    if flat.dim() != 2 or zz.shape != flat.shape:
        raise ValueError("zbuf_scatter_min: expected flat and zz [N, Q], got "
                         f"{tuple(flat.shape)}, {tuple(zz.shape)}")
    if flat.device != zz.device:
        raise ValueError(f"zbuf_scatter_min: tensors on different devices "
                         f"({flat.device}, {zz.device})")
    if not (flat.is_contiguous() and zz.is_contiguous()):
        raise ValueError("zbuf_scatter_min: tensors must be contiguous")


@functools.cache
def band_rows(height: int, width: int) -> int:
    """Rows of each CTA's band: the image cut into the fewest bands whose
    keys fit in the shared memory that lets two CTAs share an SM (failing
    that, in one CTA's limit), its rows spread evenly over them; the last
    band holds what is left.  Raises where one row does not fit in a
    CTA."""
    row_bytes = BYTES_PER_PIXEL * width
    for budget in (_cuda.SHARED_TWO_PER_SM, _cuda.SHARED_PER_CTA):
        if row_bytes <= budget:
            bands = -(-(height * row_bytes) // budget)
            while -(-height // bands) * row_bytes > budget:
                bands += 1
            return -(-height // bands)
    raise ValueError(f"zbuf_scatter_min: a row of {width} pixels exceeds the "
                     f"{_cuda.SHARED_PER_CTA} B of shared memory of one CTA")


def ctas_per_env(height: int, width: int) -> int:
    """CTAs, one a band, that share an env's image."""
    return -(-height // band_rows(height, width))


def zbuf_scatter_min(flat: torch.Tensor, zz: torch.Tensor, height: int,
                     width: int, fill: float) -> torch.Tensor:
    """flat [N, Q] int32 pixel indices in [0, H*W) (``v * W + u``, no env
    offset), zz [N, Q] float32 -> [N, H, W] float32, each pixel the
    minimum of `fill` and the zz that land on it.  Counts its kernel
    launches in ``zbuf_scatter_min.launches``.  The kernel writes every
    pixel, so the image is not filled first."""
    _check(flat, zz)
    if flat.device.type == "cpu":
        return zbuf_scatter_min_ref(flat, zz, height, width, fill)
    if flat.device.type != "cuda":
        raise ValueError(f"zbuf_scatter_min: no kernel for device {flat.device}")
    rows = band_rows(height, width)
    n, q = flat.shape
    out = torch.empty(n, height, width, dtype=torch.float32, device=flat.device)
    if n == 0:
        return out
    err = _cuda.launch(flat.get_device(), _launcher(), flat.data_ptr(),
                       zz.data_ptr(), out.data_ptr(), n, q, height * width,
                       rows * width, ctas_per_env(height, width), fill)
    if err != 0:
        raise RuntimeError(f"zbuf_scatter_min kernel launch failed: CUDA "
                           f"error {err}")
    zbuf_scatter_min.launches += 1
    return out


zbuf_scatter_min.launches = 0


@functools.cache
def _launcher():
    fn = _cuda.load_library("zbuf_scatter_min").zbuf_scatter_min
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
