"""Float32 arithmetic that rounds where the JAX reference rounds.

The JAX package runs its env step under ``jit``, and XLA on the CPU
contracts ``a * b + c`` inside one fusion into a fused multiply-add (one
rounding), turns ``x / constant`` into a product with the float32
reciprocal, evaluates its small ``[P, 3] x [3, 3]`` projection dot in a
fixed rounding order, and has its own ``sin``/``cos``.  Pixel and voxel
indices come from ``floor`` of such values, so a one-ulp difference can
move a point to the next pixel.  The helpers below reproduce those
roundings with float64 intermediates, on the CPU and on the card alike, so
the port lands on the same pixels and voxels as the reference
(tests/test_torch_fp32.py holds each helper to XLA's result).
"""
from __future__ import annotations

import os

import numpy as np
import torch


# cuBLAS's workspace setting under which its results do not depend on
# what other streams run (CUDA's cuBLAS documentation, "Results
# reproducibility"); read once, at the process's first cuBLAS call
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


def deterministic_fp32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card,
    and make every run of the same work give the same bits.

    PyTorch's default lets cuDNN run float32 convolutions in TF32, which
    keeps about three decimal digits and would put the HybridEncoder's
    Conv3d three digits off the reference.  Its default also lets cuDNN
    pick convolution algorithms that sum with atomics, in an order that
    changes from run to run: the second Conv3d's data gradient in the PPO
    update's backward pass did, so two trainings from one seed differed
    from the first minibatch's gradients of the first Conv3d and
    BatchNorm on.  The deterministic algorithms are asked for instead,
    chosen by cuDNN's heuristics rather than by timing.  For the encoder's
    two Conv3d layers the deterministic weight gradient that cuDNN picks
    took 80 to 300 times the shapes' least time on an H100, most of the
    PPO update's device time (PERF.md, sections 5 and 6), so those layers
    take their weight and bias gradients from the port's own deterministic
    kernel (``ops/conv3d_wgrad.py``) and only their forward and data
    gradient from cuDNN.  cuBLAS gets
    a fixed workspace per stream, where the environment does not already
    set one, as a precaution: no cuBLAS result was seen to differ without
    it.  It takes effect only before the process's first cuBLAS call, and
    the port makes none before the policy is built.  Called by the env, policy and PPO constructors, the
    port's entry points; no configuration key turns any of it off (the
    JAX reference is deterministic by construction)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)


def const(c: float, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The scalar c as a 0-d tensor on `device`, rounded to `dtype`.  A
    fill kernel writes it: ``torch.tensor(c, device=...)`` copies it from
    the host, which on a card waits for the device to drain."""
    return torch.full((), c, dtype=dtype, device=device)


def f32(x: float) -> float:
    """x rounded to float32, as a Python float (exact in float32): what a
    Python constant becomes in JAX's float32 arithmetic (a weak type)."""
    return float(np.float32(x))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors, rounded once to float32 as a fused
    multiply-add rounds it.  The float32 product is exact in float64; the
    float64 sum is then rounded to float32, which differs from a true FMA
    only when the float64 sum lands exactly on a float32 rounding
    midpoint."""
    return (a.double() * b.double() + c.double()).float()


def cos_sin(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Correctly rounded float32 cos and sin (float64, then rounded).
    On the env's discrete action grid XLA's float32 cos/sin return the
    correctly rounded values, where PyTorch's float32 kernels differ by an
    ulp at some angles."""
    x64 = x.double()
    return torch.cos(x64).float(), torch.sin(x64).float()


def rotate(d: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``d @ r`` for d [..., P, 3] and r [..., 3, 3], rounded as XLA's CPU
    dot rounds this shape: output columns x and y sum the rounded products
    left to right, column z accumulates them in a chain of fused
    multiply-adds.  Returns [..., P, 3] float32."""
    d64 = d.double()
    r64 = r.double()[..., None, :, :]                 # [..., 1, 3, 3]

    def prod(k: int, i: int) -> torch.Tensor:        # exact in float64
        return d64[..., k] * r64[..., k, i]

    x = (prod(0, 0).float() + prod(1, 0).float()) + prod(2, 0).float()
    y = (prod(0, 1).float() + prod(1, 1).float()) + prod(2, 1).float()
    z = prod(0, 2).float()
    z = (prod(1, 2) + z.double()).float()
    z = (prod(2, 2) + z.double()).float()
    return torch.stack([x, y, z], dim=-1)


def rotate_fma(d: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``d @ r`` for d [..., P, 3] and r [..., 3, 3], rounded as XLA's CPU
    dot rounds the render's and the back-projection's shapes (the rays
    times a batch of rotations, and their einsum): every output column
    accumulates its three products in a chain of fused multiply-adds."""
    d64 = d.double()
    r64 = r.double()[..., None, :, :]                 # [..., 1, 3, 3]
    acc = (d64[..., 0, None] * r64[..., 0, :]).float()
    acc = (d64[..., 1, None] * r64[..., 1, :] + acc.double()).float()
    return (d64[..., 2, None] * r64[..., 2, :] + acc.double()).float()


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant c, as XLA compiles it: a product with the
    float32 reciprocal of c."""
    return x * const(c, x.device).reciprocal()


def mean3(x: torch.Tensor) -> torch.Tensor:
    """Mean over a last axis of 3 as XLA compiles ``jnp.mean``: summed left
    to right, times the float32 reciprocal of 3.  The same on every device
    (a library reduction may sum in another order)."""
    return div_const(x[..., 0] + x[..., 1] + x[..., 2], 3.0)


def mean3_of_scaled(x: torch.Tensor, c: float) -> torch.Tensor:
    """``mean(x / c)`` over a last axis of 3 as XLA compiles it: the
    scaling by the reciprocal of c is fused into the reduction, each term
    added to the running sum by a fused multiply-add."""
    r = const(c, x.device).reciprocal()
    acc = x[..., 0] * r
    acc = fma(x[..., 1], r, acc)
    acc = fma(x[..., 2], r, acc)
    return div_const(acc, 3.0)
