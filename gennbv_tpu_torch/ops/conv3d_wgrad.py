"""Deterministic weight and bias gradients of the HybridEncoder's Conv3d
layers (valid, kernel 3, stride 2), and the autograd Function that takes
them in the PPO update's backward pass.

``conv3d_wgrad(x, dy)`` returns ``(dW, db)``: dW [C_out, C_in, 3, 3, 3]
the sum over samples and output voxels of dY times the input patch, db
[C_out] the sum of dY.  CUDA tensors launch the hand-written kernel
``csrc/conv3d_wgrad.cu`` (two launches, the counter
``kernel/conv3d_wgrad/launches`` up by one a call) and raise if it cannot
run; CPU tensors run the plain PyTorch version ``conv3d_wgrad_ref``
(``aten.convolution_backward``, the call autograd makes for an
``nn.Conv3d``).  There is no fallback from one to the other.

It replaces no TPU kernel: the JAX encoder's convolutions are XLA's.  It
was added because the port keeps cuDNN deterministic (``ops/fp32.py``:
two trainings from one seed stay bit-equal), and for these shapes cuDNN's
deterministic weight gradient is 80 to 300 times the least time the card
could take (PERF.md, section 6).  What bounds the work on an H100 is
memory and latency: at the update's minibatch of 128 the first layer
reads 10.1 MB for 81 MFLOP (~3.0 us at 3.35 TB/s), the second 6.5 MB for
113 MFLOP (~2.0 us).  The design (the kernel's source note has the
details): a split-K over the (sample, output voxel) positions, cut by
``geometry`` into fixed contiguous chunks, about two an SM; a CTA a chunk
stages dY and the input patches in shared memory and accumulates register
blocks in float32 FMAs, without tensor cores (TF32 is a different
result); the chunks' partials go to a workspace that a second launch sums
in a fixed order.  No atomics: the result is the same bit for bit from run
to run, and differs from cuDNN's only by the order of the float32 sums.

``conv3d(conv, x)`` is the layer as the encoder calls it: the module's
forward (the same ``F.conv3d`` call, the same bits) where no gradient is
recorded, and ``Conv3dWgrad`` where one is, whose backward takes the input
gradient from cuDNN's deterministic data gradient and the weight and bias
gradients from ``conv3d_wgrad``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gennbv_tpu_torch.ops import _cuda
from gennbv_tpu_torch.ops.zbuf_scatter import sm_count
from gennbv_tpu_torch.utils import profiling
from gennbv_tpu_torch.utils.work import count_kernel

aten = torch.ops.aten

KERNEL_SIZE = 3
STRIDE = 2
TAPS = KERNEL_SIZE ** 3
# the kernel's constants (csrc/conv3d_wgrad.cu): threads a CTA, a register
# block's output channels and patch columns, the blocks a thread holds
THREADS = 256
RC = RK = 4
MAX_BLOCKS = 2
# chunks of positions an SM, the fewest positions a chunk takes (a chunk
# writes C_out x (C_in * 27 + 1) partials, which a position's FMAs should
# outweigh), and the shared memory a tile of positions may take: two
# CTAs an SM
CHUNKS_PER_SM = 2
MIN_CHUNK = 32
TILE_BYTES = 96 * 1024


def _round4(v: int) -> int:
    return -(-v // 4) * 4


def conv3d_wgrad_ref(x: torch.Tensor,
                     dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the weight and bias gradients that autograd
    takes for an ``nn.Conv3d`` (``aten.convolution_backward``, which reads
    only the weight's shape)."""
    cout, cin = dy.shape[1], x.shape[1]
    weight = x.new_empty(1).expand(cout, cin, *(KERNEL_SIZE,) * 3)
    _, dw, db = aten.convolution_backward(
        dy, x, weight, [cout], [STRIDE] * 3, [0] * 3, [1] * 3, False,
        [0] * 3, 1, [False, True, True])
    return dw, db


def out_size(side: int) -> int:
    return (side - KERNEL_SIZE) // STRIDE + 1


def work(x: torch.Tensor, dy: torch.Tensor) -> tuple[int, int]:
    """The least a call must do, for its bound and the bench's count:
    bytes -- X and dY read once, dW and db written once -- and operations,
    a multiply and an add a (position, output channel, tap) and an add a
    (position, output channel) for the bias."""
    n, cin = x.shape[:2]
    cout = dy.shape[1]
    positions = n * dy.shape[2] * dy.shape[3] * dy.shape[4]
    nbytes = 4 * (x.numel() + dy.numel() + cout * (cin * TAPS + 1))
    return nbytes, positions * cout * (2 * cin * TAPS + 1)


def _check(x: torch.Tensor, dy: torch.Tensor, kernel_size: int,
           stride: int) -> None:
    if kernel_size != KERNEL_SIZE or stride != STRIDE:
        raise ValueError(f"conv3d_wgrad: only kernel {KERNEL_SIZE} stride "
                         f"{STRIDE}, got kernel {kernel_size} stride {stride}")
    if x.dtype != torch.float32 or dy.dtype != torch.float32:
        raise TypeError(f"conv3d_wgrad: x and dy must be float32, got "
                        f"{x.dtype}/{dy.dtype}")
    if x.dim() != 5 or dy.dim() != 5 or dy.shape[0] != x.shape[0] or \
            min(x.shape[2:]) < KERNEL_SIZE or \
            tuple(dy.shape[2:]) != tuple(out_size(s) for s in x.shape[2:]):
        raise ValueError(f"conv3d_wgrad: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} are not the input and output of "
                         f"a valid kernel-{KERNEL_SIZE} stride-{STRIDE} Conv3d")
    if x.device != dy.device:
        raise ValueError(f"conv3d_wgrad: tensors on different devices "
                         f"({x.device}, {dy.device})")


class Geometry(NamedTuple):
    """How the kernel cuts the work: the positions (sample, output voxel)
    into `chunks` contiguous chunks of `chunk` (the last may be shorter),
    a CTA each, staged `tile` positions at a time; the register blocks
    into `slabs` slabs of `slab_blocks`, a CTA each."""
    chunk: int
    chunks: int
    tile: int
    slab_blocks: int
    slabs: int


def shared_bytes(tile: int, cin: int, cout: int) -> int:
    """A CTA's dynamic shared memory, as the kernel lays it out: a tile of
    dY and patches (or after it the parts' sums, the larger), the taps'
    offsets and the tile's two position tables."""
    k1 = cin * TAPS
    tile_floats = tile * (_round4(cout) + _round4(k1 + 1))
    return 4 * (max(tile_floats, THREADS * RC * RK) + k1 + 2 * tile)


@functools.cache
def geometry(n: int, out_volume: int, cin: int, cout: int,
             sms: int) -> Geometry:
    """CHUNKS_PER_SM chunks an SM, of MIN_CHUNK positions or more; the
    fewest tiles of equal length within TILE_BYTES (the whole chunk where
    it fits); one slab where the blocks fit THREADS x MAX_BLOCKS.  Raises where the taps'
    table and one position do not fit a CTA's shared memory."""
    positions = n * out_volume
    if positions < 1 or cin < 1 or cout < 1 or sms < 1:
        raise ValueError(f"conv3d_wgrad: no geometry for {positions} "
                         f"positions, {cin} -> {cout} channels on {sms} SMs")
    chunk = max(min(MIN_CHUNK, positions),
                -(-positions // (CHUNKS_PER_SM * sms)))
    per_position = 4 * (_round4(cout) + _round4(cin * TAPS + 1))
    most = max(1, TILE_BYTES // per_position)
    tiles = -(-chunk // most)
    tile = -(-chunk // tiles)          # the chunk's tiles of equal length
    if shared_bytes(tile, cin, cout) > _cuda.SHARED_PER_CTA:
        raise ValueError(f"conv3d_wgrad: {cin} input channels need more "
                         f"than the {_cuda.SHARED_PER_CTA} B of shared memory "
                         "of one CTA")
    blocks = _round4(cout) // RC * (_round4(cin * TAPS + 1) // RK)
    slab_blocks = min(blocks, THREADS * MAX_BLOCKS)
    return Geometry(chunk, -(-positions // chunk), tile, slab_blocks,
                    -(-blocks // slab_blocks))


def conv3d_wgrad(x: torch.Tensor, dy: torch.Tensor,
                 kernel_size: int = KERNEL_SIZE,
                 stride: int = STRIDE) -> tuple[torch.Tensor, torch.Tensor]:
    """x [N, C_in, D, H, W], dy [N, C_out, D', H', W'] float32, the input
    and output gradient of a valid kernel-3 stride-2 Conv3d -> (dW [C_out,
    C_in, 3, 3, 3], db [C_out]).  On a card X may have any distance between
    samples, as a view of the observation has; its inner dims and dY are
    made contiguous where they are not."""
    _check(x, dy, kernel_size, stride)
    if x.device.type == "cpu":
        return conv3d_wgrad_ref(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_wgrad: no kernel for device {x.device}")
    n, cin, d, h, w = x.shape
    cout = dy.shape[1]
    if n == 0:
        return (x.new_zeros(cout, cin, *(KERNEL_SIZE,) * 3),
                x.new_zeros(cout))
    geo = geometry(n, dy.shape[2] * dy.shape[3] * dy.shape[4], cin, cout,
                   sm_count(x.get_device()))
    inner = cin * d * h * w
    if x.stride()[1:] != (d * h * w, h * w, w, 1) or (
            n > 1 and x.stride(0) < inner):
        x = x.contiguous()
    dy = dy.contiguous()
    dw = torch.empty(cout, cin, *(KERNEL_SIZE,) * 3, device=x.device)
    db = torch.empty(cout, device=x.device)
    ws = torch.empty(geo.chunks, cout, cin * TAPS + 1, device=x.device)
    err = _cuda.launch(x.get_device(), _launcher(), x.data_ptr(),
                       dy.data_ptr(), ws.data_ptr(), dw.data_ptr(),
                       db.data_ptr(), n, cin, d, h, w,
                       x.stride(0) if n > 1 else inner, cout, geo.chunk,
                       geo.chunks, geo.tile, geo.slab_blocks)
    if err != 0:
        raise RuntimeError(f"conv3d_wgrad kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count("kernel/conv3d_wgrad/launches")
    count_kernel(work, x, dy)
    return dw, db


@functools.cache
def _launcher():
    fn = _cuda.load_library("conv3d_wgrad").conv3d_wgrad
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class Conv3dWgrad(torch.autograd.Function):
    """``F.conv3d(x, weight, bias, stride=2)``, whose backward takes dW and
    db from ``conv3d_wgrad`` and dX (only where x needs it) from
    ``aten.convolution_backward``: cuDNN's deterministic data gradient on a
    card, as autograd would."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return F.conv3d(x, weight, bias, stride=STRIDE)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = aten.convolution_backward(
                dy, x, weight, None, [STRIDE] * 3, [0] * 3, [1] * 3, False,
                [0] * 3, 1, [True, False, False])[0]
        dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = conv3d_wgrad(x, dy)
        return dx, dw, db if ctx.has_bias else None


def conv3d(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """The encoder's valid kernel-3 stride-2 ``conv`` on x: its module
    forward where no gradient is recorded (the rollout, the eval), else
    ``Conv3dWgrad`` on its parameters."""
    if not torch.is_grad_enabled():
        return conv(x)
    return Conv3dWgrad.apply(x, conv.weight, conv.bias)
