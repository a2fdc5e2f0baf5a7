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

The kernel runs persistent CTAs, at most one an SM, over (env, band of
image rows) items; the CTA's two halves each build a band as keys in
shared memory, in a buffer of their own, and store it as they decode it.
``geometry`` picks the bands and the CTAs from the shapes and the card's
SM count (``sm_count``).
The min is order-free, so the kernel's result is deterministic and equal
bit for bit to the plain version's, except that
a pixel that gets both -0.0 and +0.0 holds -0.0 in the kernel, while
``scatter_reduce_`` compares the two as equal (the env's depths lie
beyond a 1e-3 near plane).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from gennbv_tpu_torch.ops import _cuda

# shared memory a pixel of a band takes: one uint32 key
BYTES_PER_PIXEL = 4
# band buffers a CTA holds: one for each of its two halves
BUFFERS = 2
# bytes each item streams besides its band: every pixel index and depth of
# its env, 4 B each (a band cannot know which points fall in it)
STREAM_BYTES_PER_POINT = 8
# what a byte of the band written to HBM costs against a byte of the
# points read, most of them from L2: fitted to a sweep of band heights on
# an H100 (PERF.md, section 6, PR 14), where any weight from 3.3 to 9.2
# picks the fastest measured at both paths' shapes
WRITE_WEIGHT = 6


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


class Geometry(NamedTuple):
    """How the kernel cuts the work: each env's image into `bands` bands
    of `rows` rows (the last may be shorter), the n * bands items walked
    by `ctas` persistent CTAs, at most one an SM, with a static stride."""
    rows: int
    bands: int
    ctas: int


def buffer_bytes(rows: int, width: int) -> int:
    """Shared memory of one band buffer: the band's keys."""
    return BYTES_PER_PIXEL * rows * width


def fits(rows: int, width: int) -> bool:
    """Whether BUFFERS buffers of `rows` rows fit one CTA's shared
    memory."""
    return BUFFERS * buffer_bytes(rows, width) <= _cuda.SHARED_PER_CTA


def item_cost(rows: int, width: int, q: int) -> int:
    """What one item costs an SM: its band written once, weighed by
    WRITE_WEIGHT, and its env's Q indices and depths read (from L2 after
    the first band)."""
    return (WRITE_WEIGHT * BYTES_PER_PIXEL * rows * width
            + STREAM_BYTES_PER_POINT * q)


@functools.cache
def geometry(n: int, q: int, height: int, width: int, sms: int) -> Geometry:
    """The band count, among those whose BUFFERS buffers fit one CTA's
    shared memory, that minimises what the busiest SM moves:
    ceil(items / sms) * item_cost, on min(items, sms) CTAs; the fewest
    bands among equals.  An SM's items follow one another through its
    memory path, so the SM that moves the most sets the kernel's end.
    Raises where one row does not fit."""
    if n < 1 or sms < 1:
        raise ValueError(f"zbuf_scatter_min: no geometry for {n} envs on "
                         f"{sms} SMs")
    best, best_cost = None, None
    for bands in range(1, height + 1):
        rows = -(-height // bands)
        if -(-height // rows) != bands or not fits(rows, width):
            continue                   # no band of whole rows gives this count
        items = n * bands
        cost = -(-items // sms) * item_cost(rows, width, q)
        if best_cost is None or cost < best_cost:
            best, best_cost = Geometry(rows, bands, min(items, sms)), cost
    if best is None:
        raise ValueError(f"zbuf_scatter_min: {BUFFERS} buffers of a row of "
                         f"{width} pixels exceed the {_cuda.SHARED_PER_CTA} B "
                         "of shared memory of one CTA")
    return best


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    n, q = flat.shape
    if n == 0:
        return torch.empty(0, height, width, dtype=torch.float32,
                           device=flat.device)
    return launch(flat, zz, height, width, fill,
                  geometry(n, q, height, width, sm_count(flat.get_device())))


zbuf_scatter_min.launches = 0


def launch(flat: torch.Tensor, zz: torch.Tensor, height: int, width: int,
           fill: float, geo: Geometry) -> torch.Tensor:
    """The kernel on checked CUDA tensors (n > 0) with the geometry given,
    which ``zbuf_scatter_min`` takes from ``geometry``;
    ``tools/profile_wrappers.py`` also times other band heights."""
    n, q = flat.shape
    out = torch.empty(n, height, width, dtype=torch.float32, device=flat.device)
    err = _cuda.launch(flat.get_device(), _launcher(), flat.data_ptr(),
                       zz.data_ptr(), out.data_ptr(), n, q, height * width,
                       geo.rows * width, geo.bands, geo.ctas, fill)
    if err != 0:
        raise RuntimeError(f"zbuf_scatter_min kernel launch failed: CUDA "
                           f"error {err}")
    zbuf_scatter_min.launches += 1
    return out


@functools.cache
def _launcher():
    fn = _cuda.load_library("zbuf_scatter_min").zbuf_scatter_min
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
