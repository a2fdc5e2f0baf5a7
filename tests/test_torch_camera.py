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


def test_polar_and_direction_decodes_on_the_reference_cases():
    """tests/test_ops.py's cases of the latent pose modes
    (env_train_base.py:686-706), held to the JAX functions at 1e-6: the
    same float32 formulas, whose sines and cosines differ by an ulp or
    two between the frameworks."""
    rtp = np.array([[2.0, 0.0, 0.0], [1.0, 0.3, np.pi / 2]], np.float32)
    got = pt_camera.polar_to_cartesian(torch.from_numpy(rtp)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_camera.polar_to_cartesian(
        jnp.asarray(rtp))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, [[2, 0, 0], [0, 0, 1]], atol=1e-6)
    c = float(np.cos(np.pi / 4))
    d = np.array([[1.0, 0.0, 0.0], [0.0, c, -c], [0.3, -0.5, 0.2]], np.float32)
    got = pt_camera.direction_to_rpy(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_camera.direction_to_rpy(
        jnp.asarray(d))), rtol=0, atol=1e-6)
    # +x forward: pitch 0, yaw 2pi (the reference's dy <= 0 branch)
    np.testing.assert_allclose(got[0], [0, 0, 2 * np.pi], atol=1e-6)
    np.testing.assert_allclose(got[1], [0, np.pi / 4, np.pi / 2], atol=1e-5)
    # the decoded pose's optical axis is the direction
    pose = torch.cat([torch.zeros(1, 3), torch.from_numpy(got[2:])], -1)
    r, _ = pt_camera.pose_to_c2w(pose[0])
    np.testing.assert_allclose(r[:, 2].numpy(), d[2] / np.linalg.norm(d[2]),
                               atol=1e-5)


def test_polar_to_cartesian_random():
    """Seeded radii, azimuths and elevations: equal to the JAX decode to
    1e-6 of the radius (|r| <= 12; the trig differs by an ulp or two)."""
    rng = np.random.default_rng(0)
    rtp = np.c_[rng.uniform(0.5, 12.0, 256), rng.uniform(-np.pi, 2 * np.pi, 256),
                rng.uniform(-np.pi / 2, np.pi / 2, 256)].astype(np.float32)
    want = np.asarray(jax.jit(jax_camera.polar_to_cartesian)(jnp.asarray(rtp)))
    got = pt_camera.polar_to_cartesian(torch.from_numpy(rtp)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * 12.0)


def test_direction_to_rpy_random():
    """Seeded direction vectors, pitch and yaw held to JAX's within the
    float32 conditioning of the reference's formula: asin and acos differ
    by an ulp or two between the frameworks, and the formula amplifies
    that.  Pitch = -asin(s), s = dz/|d|, moves by u|s| / sqrt(1 - s^2)
    (u = 2^-24) for each ulp of error; yaw = acos(x), x = dx / (cos(pitch)
    |d|), takes x's relative error (an ulp or two, plus tan^2(pitch) from
    the cosine of an inexact pitch, which loses its leading digits near
    vertical) times |x| / sqrt(1 - x^2).  Each is held to 8 such ulps plus
    2e-6 (up to 1.4e-4 rad of yaw near the x axis and the vertical).
    Where the decode is well conditioned (elevation within 60 degrees,
    the xy direction at least 14.5 degrees off the x axis) both are held
    to 2e-6, and the pose's optical axis (pose_to_c2w) is the unit
    direction to 1e-5, as JAX's own test holds it."""
    rng = np.random.default_rng(1)
    d = (rng.normal(size=(512, 3))
         * rng.uniform(0.1, 10.0, (512, 1))).astype(np.float32)
    want = np.asarray(jax.jit(jax_camera.direction_to_rpy)(jnp.asarray(d)))
    got = pt_camera.direction_to_rpy(torch.from_numpy(d)).numpy()
    assert (got[:, 0] == 0).all()
    assert ((got[:, 2] >= 0) & (got[:, 2] <= 2 * np.pi)).all()
    dd = d.astype(np.float64)
    u = 2.0 ** -24
    s = dd[:, 2] / np.linalg.norm(dd, axis=1)
    x = dd[:, 0] / np.linalg.norm(dd[:, :2], axis=1)
    tan2 = s ** 2 / (1 - s ** 2)
    tol_pitch = 2e-6 + 8 * u * np.abs(s) / np.sqrt(np.maximum(1 - s ** 2, 2 * u))
    tol_yaw = 2e-6 + 8 * u * (1 + tan2) * np.abs(x) / np.sqrt(
        np.maximum(1 - x ** 2, 2 * u))
    assert (np.abs(got[:, 1] - want[:, 1]) <= tol_pitch).all()
    assert (np.abs(got[:, 2] - want[:, 2]) <= tol_yaw).all()
    tame = (np.abs(s) < np.sin(np.pi / 3)) & (np.abs(x) < np.sqrt(1 - 0.25 ** 2))
    assert tame.sum() > 200
    np.testing.assert_allclose(got[tame], want[tame], rtol=0, atol=2e-6)
    r, _ = pt_camera.pose_to_c2w(torch.cat([torch.zeros(512, 3),
                                            torch.from_numpy(got)], -1))
    np.testing.assert_allclose(
        r[tame, :, 2].numpy(),
        (dd / np.linalg.norm(dd, axis=1, keepdims=True))[tame],
        rtol=0, atol=1e-5)
