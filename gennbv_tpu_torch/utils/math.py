"""Math utilities (port of ``gennbv_tpu/utils/math.py``, the counterpart of
legged_gym/utils/math.py): quaternion helpers and angle wrapping over
batched tensors.

Quaternion convention: (x, y, z, w), matching Isaac Gym's torch_utils that
the reference builds on.
"""
from __future__ import annotations

import math

import torch


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, (x,y,z,w) convention; broadcasts over leading dims."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis of 3, broadcasting like
    ``jnp.cross`` (``torch.linalg.cross`` needs equal batch shapes on
    some devices)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by quaternions q [..., 4]."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(xyz, v)
    return v + w * t + cross(xyz, t)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_from_euler_zyx(roll: torch.Tensor, pitch: torch.Tensor,
                        yaw: torch.Tensor) -> torch.Tensor:
    """Intrinsic ZYX (yaw-pitch-roll) Euler angles -> (x,y,z,w) quaternion."""
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    return torch.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], dim=-1)


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by only the yaw component of q
    (legged_gym/utils/math.py:39-45)."""
    yaw_q = torch.cat([torch.zeros_like(q[..., :2]), q[..., 2:3], q[..., 3:4]],
                      dim=-1)
    yaw_q = yaw_q / torch.linalg.vector_norm(yaw_q, dim=-1, keepdim=True)
    return quat_apply(yaw_q, v)


def wrap_to_pi(angles: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi] (legged_gym/utils/math.py:47-51).  The modulo is
    ``jnp.mod``'s: the exact ``fmod``, moved into [0, 2 pi)."""
    two_pi = 2.0 * math.pi
    a = torch.fmod(angles, two_pi)
    a = torch.where((a != 0) & (a < 0), a + two_pi, a)
    return torch.where(a > math.pi, a - two_pi, a)


def rand_sqrt_float(generator: torch.Generator, lower: float, upper: float,
                    shape) -> torch.Tensor:
    """sqrt-distributed random floats in [lower, upper] on `generator`'s
    device -- the reference's velocity-jitter sampler
    (legged_gym/utils/math.py:54-59): signed sqrt of uniform[-1,1],
    rescaled."""
    r = 2.0 * torch.rand(shape, generator=generator,
                         device=generator.device) - 1.0
    r = torch.where(r < 0, -torch.sqrt(-r), torch.sqrt(r))
    return (r + 1.0) / 2.0 * (upper - lower) + lower
