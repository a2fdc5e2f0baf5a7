"""Fused splat z-buffer + visibility (port of ``ops/pallas_splat.py``).

``zbuf_visible(vic, uic, z, ok, voxel_eps, H, W, depth_max, footprint)``
takes the projected points of ``splat.project_px`` and returns the pooled
z-buffer and the per-point visibility, as the JAX package's Pallas kernel
``pallas_splat.zbuf_visible`` does for ``renderer.zbuf_impl="pallas"``:
the per-env z range of the valid points, the two-digit bucket minimum per
pixel, its decode to the bucket midpoint, the (2f+1)^2 min-pool and the
bf16 visibility compare with slack ``voxel_eps + zrange / 100``.

The plain version is ``splat.zbuf_vis_px``, the composition of the JAX
package's ``"mxu"`` path (key-min, pool, bf16 gather, compare), with the
same bits.  The JAX Pallas kernel can differ from its own mxu path by one
ulp in the z-buffer, where XLA fuses the decode differently
(``tests/test_pallas_splat.py``); the port follows the mxu rounding.

The JAX wrapper front-packs the valid points with a sort and scatters the
visibility back through a one-hot product, so that the TPU kernel can skip
empty 512-point chunks.  The CUDA kernel needs neither: a thread whose
point is not valid returns at once, and outputs stay in point order.

The device of the tensors picks the implementation.  CUDA tensors launch
the hand-written kernel of ``csrc/zbuf_visible.cu`` once (and raise if it
cannot run); CPU tensors run the plain PyTorch version
``zbuf_visible_ref``.  There is no fallback from one to the other.

The kernel runs one thread-block cluster per env, whose CTAs each hold a
band of the env's image rows in shared memory; ``cluster_ctas`` picks their
number from the image's shape and the footprint.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from gennbv_tpu_torch.ops import _cuda, splat
from gennbv_tpu_torch.utils import profiling
from gennbv_tpu_torch.utils.work import count_kernel


def zbuf_visible_ref(vic, uic, z, ok, voxel_eps, height: int, width: int,
                     depth_max: float, footprint: int = 1):
    """Plain PyTorch version; the arguments and results of
    ``zbuf_visible``."""
    return splat.zbuf_vis_px(vic, uic, z, ok, height, width, depth_max,
                             voxel_eps, footprint)


def work(vic, uic, z, ok, voxel_eps, height: int,
         width: int) -> tuple[int, int]:
    """The least a call must do on these inputs, for its bound and
    ``utils/work.WorkCounter``: bytes -- the validity of every point, the
    pixel and depth of the valid ones, the slack; the z-buffer and the
    visibility written once -- and operations, 19 per valid point (z range,
    digits, key, visibility compare) and 16 per pixel (9-key min,
    decode)."""
    n, q = z.shape
    nvalid = int(ok.sum())
    return (n * q + 12 * nvalid + 4 * n + 4 * n * height * width + n * q,
            19 * nvalid + 16 * n * height * width)


def _check(vic, uic, z, ok, voxel_eps) -> None:
    if vic.dtype != torch.int32 or uic.dtype != torch.int32 \
            or z.dtype != torch.float32 or ok.dtype != torch.bool \
            or voxel_eps.dtype != torch.float32:
        raise TypeError(
            "zbuf_visible: expected vic/uic int32, z float32, ok bool and "
            f"voxel_eps float32, got {vic.dtype}/{uic.dtype}/{z.dtype}/"
            f"{ok.dtype}/{voxel_eps.dtype}")
    if z.dim() != 2 or not (vic.shape == uic.shape == ok.shape == z.shape) \
            or voxel_eps.shape != z.shape[:1]:
        raise ValueError(
            "zbuf_visible: expected vic/uic/z/ok [N, Q] and voxel_eps [N], "
            f"got {tuple(vic.shape)}, {tuple(uic.shape)}, {tuple(z.shape)}, "
            f"{tuple(ok.shape)}, {tuple(voxel_eps.shape)}")
    devices = {t.device for t in (vic, uic, z, ok, voxel_eps)}
    if len(devices) != 1:
        raise ValueError(f"zbuf_visible: tensors on different devices {devices}")
    if not all(t.is_contiguous() for t in (vic, uic, z, ok, voxel_eps)):
        raise ValueError("zbuf_visible: tensors must be contiguous")


# shared memory of one CTA of the kernel: an int32 key and a uint8 row min
# for each pixel of its band, rows padded to a multiple of 4 pixels
# (dynamic), and its reduction scratch and decode tables (static)
_BYTES_PER_PIXEL = 5
_STATIC_SMEM = 952


def band_rows(height: int, ctas: int) -> int:
    """Rows of each CTA's band when `ctas` CTAs share an image of `height`
    rows; the last band holds what is left."""
    return -(-height // ctas)


def cta_smem_bytes(height: int, width: int, ctas: int) -> int:
    """Shared memory one CTA takes when `ctas` CTAs share the image."""
    stride = -(-width // 4) * 4
    return _BYTES_PER_PIXEL * band_rows(height, ctas) * stride + _STATIC_SMEM


@functools.cache
def cluster_ctas(height: int, width: int, footprint: int) -> int:
    """CTAs per env: the fewest (at most 8) whose bands fit in the shared
    memory that lets two CTAs share an SM, failing that in one CTA's limit.
    With more than one CTA each band holds at least `footprint` rows, so
    that a pixel's pool window reaches no further than the neighbouring
    bands.  Raises where no cluster holds the image."""
    for budget in (_cuda.SHARED_TWO_PER_SM, _cuda.SHARED_PER_CTA):
        for ctas in range(1, _cuda.MAX_CLUSTER + 1):
            if ctas > 1 and band_rows(height, ctas) < footprint:
                break
            if cta_smem_bytes(height, width, ctas) <= budget:
                return ctas
    raise ValueError(
        f"zbuf_visible: no cluster of at most {_cuda.MAX_CLUSTER} CTAs holds "
        f"a {height}x{width} image with footprint {footprint} in shared memory")


def zbuf_visible(vic, uic, z, ok, voxel_eps, height: int, width: int,
                 depth_max: float, footprint: int = 1):
    """vic/uic [N, Q] int32 in-range pixel coordinates, z [N, Q] float32,
    ok [N, Q] bool, voxel_eps [N] float32 -> (zbuf [N, H*W] float32,
    visible [N, Q] bool).  Counts its kernel launches in the counter
    ``kernel/zbuf_visible/launches``."""
    _check(vic, uic, z, ok, voxel_eps)
    if z.device.type == "cpu":
        return zbuf_visible_ref(vic, uic, z, ok, voxel_eps, height, width,
                                depth_max, footprint)
    if z.device.type != "cuda":
        raise ValueError(f"zbuf_visible: no kernel for device {z.device}")
    return launch(vic, uic, z, ok, voxel_eps, height, width, depth_max,
                  footprint, cluster_ctas(height, width, footprint))


def launch(vic, uic, z, ok, voxel_eps, height: int, width: int,
           depth_max: float, footprint: int, ctas: int):
    """The kernel on checked CUDA tensors with `ctas` CTAs per env, which
    ``zbuf_visible`` takes from ``cluster_ctas``; the card's tests also
    give it other cluster sizes."""
    if not 1 <= ctas <= _cuda.MAX_CLUSTER \
            or (ctas > 1 and band_rows(height, ctas) < footprint) \
            or cta_smem_bytes(height, width, ctas) > _cuda.SHARED_PER_CTA:
        raise ValueError(f"zbuf_visible: {ctas} CTAs cannot hold a "
                         f"{height}x{width} image with footprint {footprint}")
    n, q = z.shape
    dev = z.device
    zbuf = torch.empty(n, height * width, dtype=torch.float32, device=dev)
    visible = torch.empty(n, q, dtype=torch.bool, device=dev)
    if n == 0:
        return zbuf, visible
    err = _cuda.launch(z.get_device(), _launcher(), vic.data_ptr(),
                       uic.data_ptr(), z.data_ptr(), ok.data_ptr(),
                       voxel_eps.data_ptr(), zbuf.data_ptr(), visible.data_ptr(),
                       n, q, height, width, footprint, depth_max, ctas)
    if err != 0:
        raise RuntimeError(f"zbuf_visible kernel launch failed: CUDA error {err}")
    profiling.count("kernel/zbuf_visible/launches")
    count_kernel(work, vic, uic, z, ok, voxel_eps, height, width)
    return zbuf, visible


@functools.cache
def _launcher():
    fn = _cuda.load_library("zbuf_visible").zbuf_visible
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
