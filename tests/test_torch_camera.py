"""The port's camera model against ``gennbv_tpu/ops/camera.py``."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu import spec
from gennbv_tpu.ops import camera as jax_camera
from gennbv_tpu_torch.ops import camera as pt_camera


def test_intrinsics_and_rays_equal():
    for h, w in ((16, 16), (128, 128), (48, 64)):
        np.testing.assert_array_equal(pt_camera.intrinsics(h, w, 90.0),
                                      jax_camera.intrinsics(h, w, 90.0))
        np.testing.assert_array_equal(pt_camera.camera_rays(h, w, 90.0),
                                      jax_camera.camera_rays(h, w, 90.0))


def test_pose_to_c2w_random_poses():
    """Arbitrary poses: float32 trig differs between the frameworks by an
    ulp, so R and t are held to 1e-6 (|R| <= 1, |t| <= 10)."""
    rng = np.random.default_rng(0)
    pose = np.c_[rng.uniform(-8, 8, (64, 3)), np.zeros(64),
                 rng.uniform(-math.pi / 2, math.pi / 2, 64),
                 rng.uniform(0, 2 * math.pi, 64)].astype(np.float32)
    r_j, t_j = jax.jit(jax.vmap(jax_camera.pose_to_c2w))(jnp.asarray(pose))
    r_p, t_p = pt_camera.pose_to_c2w(torch.from_numpy(pose))
    np.testing.assert_allclose(r_p.numpy(), np.asarray(r_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=0, atol=1e-6)


def test_pose_to_c2w_bit_equal_on_action_grid():
    """Every pitch and yaw the discrete action space reaches gives the
    same float32 rotation bit for bit (the env's pixels depend on it)."""
    idx = np.array([[0, 0, 0, 0, p, y] for p in range(spec.NVEC[4])
                    for y in range(spec.NVEC[5])], np.float32)
    unit = np.asarray(spec.ACTION_UNIT, np.float32)
    low = np.asarray(spec.CLIP_POSE_LOW, np.float32)
    pose_j = jax.jit(lambda a: a * unit + low)(jnp.asarray(idx))
    r_j, _ = jax.jit(jax.vmap(jax_camera.pose_to_c2w))(pose_j)
    r_p, _ = pt_camera.pose_to_c2w(torch.from_numpy(np.array(pose_j)))
    np.testing.assert_array_equal(r_p.numpy(), np.asarray(r_j))


@pytest.mark.parametrize("size", [128, 24, 400])
def test_depth_to_grayscale(size):
    """Antialiased bilinear resize agrees with jax.image.resize(linear) to
    a few 1e-5 on the 0-255 scale; 1e-4 is the golden's obs tolerance."""
    rng = np.random.default_rng(size)
    depth = rng.uniform(0.5, 60.0, (3, size, size)).astype(np.float32)
    depth[:, : size // 4] = 50.0          # empty sky at exactly depth_max
    want = jax_camera.depth_to_grayscale(jnp.asarray(depth), 50.0, 64, 64)
    got = pt_camera.depth_to_grayscale(torch.from_numpy(depth), 50.0, 64, 64)
    assert got.shape == (3, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_pixel_index_floors():
    u = torch.tensor([-0.5, -1e-7, 0.0, 3.999, 4.0, 1e9, -1e9])
    assert pt_camera.pixel_index(u, 4).tolist() == [-1, -1, 0, 3, 4, 4, -1]
