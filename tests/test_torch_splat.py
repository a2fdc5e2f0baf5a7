"""The port's splat renderer against ``gennbv_tpu/ops/splat.py`` on its
default ``zbuf_impl="mxu"`` path.

The JAX functions run under ``jit(vmap(...))``, as inside the JAX env
step: that is where XLA contracts ``zmin + frac * zrange`` into one
multiply-add, which the port reproduces."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu import spec
from gennbv_tpu.config import SceneConfig as JaxSceneConfig
from gennbv_tpu.env import scene as jax_scene
from gennbv_tpu.ops import camera as jax_camera
from gennbv_tpu.ops import mxu
from gennbv_tpu.ops import splat as jax_splat
from gennbv_tpu_torch.ops import camera as pt_camera
from gennbv_tpu_torch.ops import splat as pt_splat

DMAX = 50.0


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _jax_zbuf_vis(vic, uic, z, ok, h, w, veps):
    fn = jax.jit(jax.vmap(
        lambda v, u, zz, o, e: jax_splat.zbuf_vis_px(v, u, zz, o, h, w, DMAX, e,
                                                     1, "mxu")))
    zbuf, vis = fn(*map(jnp.asarray, (vic, uic, z, ok, veps)))
    return np.asarray(zbuf), np.asarray(vis)


def _jax_zbuf0(vic, uic, z, ok, h, w):
    fn = jax.jit(jax.vmap(
        lambda v, u, zz, o: mxu.scatter_min_image(v, u, zz, o, h, w, DMAX)))
    zbuf0, quant = fn(*map(jnp.asarray, (vic, uic, z, ok)))
    return np.asarray(zbuf0), np.asarray(quant)


def test_keymin_zbuf_and_visibility_bit_equal():
    """Same (vic, uic, z, ok) in: the unpooled and pooled z-buffers and the
    visibility are bit-equal.  Env 0 is an empty frame (no valid point:
    every pixel is depth_max), env 1 has every point in view."""
    rng = np.random.default_rng(0)
    n, h, w, q = 4, 32, 32, 3000
    vic = rng.integers(0, h, (n, q)).astype(np.int32)
    uic = rng.integers(0, w, (n, q)).astype(np.int32)
    z = rng.uniform(1.0, 29.0, (n, q)).astype(np.float32)
    z[3, : q // 2] = rng.uniform(4.0, 4.2, q // 2)      # dense ties in few buckets
    ok = rng.random((n, q)) < 0.6
    ok[0], ok[1] = False, True
    veps = np.array([0.15, 0.2, 0.1, 0.17], np.float32)

    want0, want_quant = _jax_zbuf0(vic, uic, z, ok, h, w)
    got0, got_quant = pt_splat.zbuf_keymin(*_t(vic, uic, z, ok), h, w, DMAX)
    np.testing.assert_array_equal(got0.numpy(), want0)
    np.testing.assert_array_equal(got_quant.numpy(), want_quant)
    assert (want0[0] == DMAX).all()

    want_zbuf, want_vis = _jax_zbuf_vis(vic, uic, z, ok, h, w, veps)
    got_zbuf, got_vis = pt_splat.zbuf_vis_px(*_t(vic, uic, z, ok), h, w, DMAX,
                                             torch.from_numpy(veps), 1)
    np.testing.assert_array_equal(got_zbuf.numpy(), want_zbuf)
    np.testing.assert_array_equal(got_vis.numpy(), want_vis)
    assert not want_vis[0].any() and want_vis[1].any()


def test_overflow_keymin_exact_where_radix_goes_one_bucket_low():
    """Port of tests/test_splat.py's overflow case, with the divergence
    stated.  8192 points (> 2^12) in one pixel and one depth bucket: the
    radix form's exponent sum overflows its 12-bit spacing and reports a
    bucket one LOW (conservative), then falls back to that bucket's
    midpoint; the integer-key min has no count limit and returns the true
    bucket's midpoint."""
    h = w = 8
    q = 8192 + 2
    vic = np.zeros((1, q), np.int32)
    uic = np.zeros((1, q), np.int32)
    z = np.full((1, q), 6.25, np.float32)
    vic[0, -2:], uic[0, -2:] = 7, (6, 7)
    z[0, -2:] = (1.0, 11.0)                    # zmin 1, zrange 10: buckets of 0.1
    ok = np.ones((1, q), bool)
    radix, quant = _jax_zbuf0(vic, uic, z, ok, h, w)
    keymin, _ = pt_splat.zbuf_keymin(*_t(vic, uic, z, ok), h, w, DMAX)
    keymin = keymin.numpy()
    # key-min: bucket (5, 2) -> midpoint 1 + 0.525 * 10
    assert keymin[0, 0] == np.float32(6.25)
    # radix: coarse bucket 4 instead of 5, midpoint fallback 1 + 0.45 * 10
    assert radix[0, 0] == np.float32(5.5)
    assert radix[0, 0] < keymin[0, 0]
    assert abs(keymin[0, 0] - 6.25) <= quant[0]
    # the other pixels have no overflow: identical
    np.testing.assert_array_equal(keymin[0, 1:], radix[0, 1:])

    # the original case: all points on one pixel at one depth
    z1 = np.full((1, 8192), 10.0, np.float32)
    zero = np.zeros((1, 8192), np.int32)
    zb, quant = pt_splat.zbuf_keymin(*_t(zero, zero, z1, np.ones((1, 8192), bool)),
                                     h, w, DMAX)
    assert float(zb[0, 0]) <= 10.0 + float(quant[0]) * 1.01


def _scene_poses(n, seed):
    """Scene surface points and poses from the discrete action grid."""
    scenes = jax_scene.generate_procedural(JaxSceneConfig(num_scenes=n, seed=seed), 16)
    rng = np.random.default_rng(seed)
    acts = np.stack([rng.integers(0, k, n) for k in spec.NVEC], -1)
    acts[0] = spec.INIT_ACTION
    pose = (acts * np.asarray(spec.ACTION_UNIT, np.float32)
            + np.asarray(spec.CLIP_POSE_LOW, np.float32)).astype(np.float32)
    r, t = jax.vmap(jax_camera.pose_to_c2w)(jnp.asarray(pose))
    return (np.asarray(scenes.surf_pts), np.asarray(scenes.surf_mask),
            np.array(r), np.array(t),
            np.asarray((scenes.box_hi - scenes.box_lo) / 16).mean(-1))


def test_projection_within_ulps():
    """p_cam to 2e-6 m; pixel indices equal except for points within
    1e-4 px of a pixel boundary, where one ulp of p_cam may flip floor()."""
    pts, mask, r, t, _ = _scene_poses(6, 1)
    h = w = 128
    k = jax_camera.intrinsics(h, w, 90.0)
    p_cam_j = np.asarray(jax.jit(jax.vmap(lambda p, rr, tt: (p - tt[None]) @ rr))(
        pts, r, t))
    vic_j, uic_j, z_j, ok_j = map(np.asarray, jax.jit(jax.vmap(
        lambda p, m, rr, tt: jax_splat.project_px(p, m, k, rr, tt, h, w)))(
            pts, mask, r, t))
    p_t, m_t, r_t, t_t = _t(pts, mask, r, t)
    vic_p, uic_p, z_p, ok_p = pt_splat.project_px(
        p_t, m_t, torch.from_numpy(k), r_t, t_t, h, w)
    from gennbv_tpu_torch.ops import fp32
    p_cam_p = fp32.rotate(p_t - t_t[:, None], r_t).numpy()
    np.testing.assert_allclose(p_cam_p, p_cam_j, rtol=0, atol=2e-6)
    np.testing.assert_allclose(z_p.numpy(), z_j, rtol=0, atol=2e-6)

    safe = np.where(p_cam_j[..., 2] > 1e-3, p_cam_j[..., 2], 1.0)
    u = k[0, 0] * p_cam_j[..., 0] / safe + k[0, 2]
    v = k[1, 1] * p_cam_j[..., 1] / safe + k[1, 2]
    near_edge = (np.abs(u - np.round(u)) < 1e-4) | (np.abs(v - np.round(v)) < 1e-4)
    differ = ((vic_p.numpy() != vic_j) | (uic_p.numpy() != uic_j)
              | (ok_p.numpy() != ok_j))
    assert not (differ & ~near_edge).any()


def test_splat_depth_matches():
    """The whole splat (projection, key-min z-buffer, pool, visibility)
    on procedural scenes seen from action-grid poses: bit-equal."""
    pts, mask, r, t, veps = _scene_poses(6, 2)
    h = w = 64
    k = jax_camera.intrinsics(h, w, 90.0)
    want = jax.jit(jax.vmap(lambda p, m, rr, tt, e: jax_splat.splat_depth(
        p, m, k, rr, tt, h, w, DMAX, e, 1, "mxu")))(pts, mask, r, t,
                                                    veps.astype(np.float32))
    got = pt_splat.splat_depth(*_t(pts, mask), torch.from_numpy(k), *_t(r, t),
                               h, w, DMAX, torch.from_numpy(veps.astype(np.float32)))
    for g, wnt, name in zip(got, want, ("zbuf", "fg", "visible")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt), err_msg=name)
    assert np.asarray(want[2]).sum() > 50          # some points are seen
