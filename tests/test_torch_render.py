"""The port's ray-marched depth render and back-projection
(``gennbv_tpu_torch/ops/render.py``, ``backproject.py``) against the JAX
package's, as the eval's accuracy scan runs them: jitted, over a batch of
envs.  Hit flags, depths, points and validity are exact."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu import config as jax_config
from gennbv_tpu import spec
from gennbv_tpu.env import scene as jax_scene
from gennbv_tpu.ops import backproject as jax_backproject
from gennbv_tpu.ops import camera as jax_camera
from gennbv_tpu.ops import render as jax_render
from gennbv_tpu_torch.ops import backproject, camera, fp32, render

N, R, HW = 5, 24, 40


@pytest.fixture(scope="module")
def scenes():
    return jax_scene.generate_procedural(
        jax_config.SceneConfig(num_scenes=N, seed=3), R)


def _poses(seed):
    """Poses of the discrete action grid, as env.step makes them."""
    rng = np.random.default_rng(seed)
    acts = np.stack([rng.integers(0, k, N) for k in spec.NVEC], -1)
    acts[0] = spec.INIT_ACTION            # the top-down init view
    return acts.astype(np.int32)


def _jax_render(sc, acts, rays):
    unit = jnp.asarray(spec.ACTION_UNIT)
    low = jnp.asarray(spec.CLIP_POSE_LOW)

    def run(acts, sid):
        def one(s, pose):
            r, t = jax_camera.pose_to_c2w(pose, spec.CAMERA_Z_OFFSET)
            depth, fg = jax_render.render_depth(
                sc.render_occ[s], sc.box_lo[s], sc.box_hi[s], rays, r, t,
                R, 3 * R, spec.DEPTH_MAX)
            pts, valid = jax_backproject.backproject(depth, fg, rays, r, t)
            return depth, fg, pts, valid
        return jax.vmap(one)(sid, acts.astype(jnp.float32) * unit + low)

    out = jax.jit(run)(jnp.asarray(acts), jnp.arange(N))
    return [np.asarray(x) for x in out]


def _port_render(sc, acts, rays):
    t = {k: torch.from_numpy(np.array(getattr(sc, k)))
         for k in ("render_occ", "box_lo", "box_hi")}
    poses = fp32.fma(torch.from_numpy(acts).float(),
                     torch.tensor(spec.ACTION_UNIT), torch.tensor(spec.CLIP_POSE_LOW))
    r, tr = camera.pose_to_c2w(poses, spec.CAMERA_Z_OFFSET)
    rays = torch.from_numpy(rays)
    depth, fg = render.render_depth(t["render_occ"], t["box_lo"], t["box_hi"],
                                    rays, r, tr, R, 3 * R, spec.DEPTH_MAX)
    pts, valid = backproject.backproject(depth, fg, rays, r, tr)
    return [x.numpy() for x in (depth, fg, pts, valid)]


@pytest.mark.parametrize("seed,stride", [(0, 1), (1, 3)])
def test_render_and_backproject_match_jax(scenes, seed, stride):
    """Every ray of a 40x40 camera (and its strided sub-rays) from five
    poses, one of them the init view: hits, depths, points exact."""
    rays = camera.camera_rays(HW, HW, spec.HORIZONTAL_FOV_DEG)
    rays = rays.reshape(HW, HW, 3)[::stride, ::stride].reshape(-1, 3)
    acts = _poses(seed)
    want = _jax_render(scenes, acts, rays)
    got = _port_render(scenes, acts, rays)
    for name, g, w in zip(("depth", "hit", "pts", "valid"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    hit = got[1]
    assert hit.any() and not hit.all(), "rays hit the houses and miss them"
    assert (got[0][~hit] == spec.DEPTH_MAX).all()


def test_raymarch_axis_aligned_and_grazing_rays():
    """Rays along the axes (zero direction components, the 1e-9 guard),
    rays from inside the box, and rays that miss it: exact against the
    jitted JAX function."""
    r = 16
    occ = np.zeros((r, r, r), np.uint8)
    occ[5:11, 5:11, 0:6] = 1
    lo = np.array([-4.0, -4.0, 0.0], np.float32)
    hi = np.array([4.0, 4.0, 8.0], np.float32)
    rng = np.random.default_rng(4)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs[:6] = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                         [0, 0, 1], [0, 0, -1]], np.float32)
    dirs[6:9, 1] = 0.0
    for origin in ([0.3, -0.2, 6.0], [-7.0, 0.5, 1.0], [0.0, 0.0, 20.0]):
        origin = np.asarray(origin, np.float32)
        want = jax.jit(jax_render.raymarch, static_argnums=(5, 6, 7))(
            jnp.asarray(occ.reshape(-1)), lo, hi, origin, dirs, r, 3 * r, 30.0)
        got = render.raymarch(torch.from_numpy(occ.reshape(-1)),
                              torch.from_numpy(lo), torch.from_numpy(hi),
                              torch.from_numpy(origin), torch.from_numpy(dirs),
                              r, 3 * r, 30.0)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_render_backproject_roundtrip():
    """tests/test_ops.py's roundtrip on the port: a camera above a box
    looking down sees its top at the nadir, and every back-projected point
    lies on the box surface."""
    res = 32
    box_lo = torch.tensor([-4.0, -4.0, 0.0])
    box_hi = torch.tensor([4.0, 4.0, 8.0])
    occ = torch.zeros(res, res, res, dtype=torch.uint8)
    occ[12:20, 12:20, 0:8] = 1  # box x,y in [-1,1], z in [0,2]
    h = w = 48
    rays = torch.from_numpy(camera.camera_rays(h, w, 90.0))
    pose = torch.tensor([0.0, 0.0, 6.0, 0.0, np.pi / 2, 0.0])
    r_c2w, t_c2w = camera.pose_to_c2w(pose)
    depth, hit = render.render_depth(occ.reshape(-1), box_lo, box_hi, rays,
                                     r_c2w, t_c2w, res, 3 * res, 50.0)
    assert hit.any(), "camera above a box looking down must hit"
    # nadir pixel depth: camera at z=6.1 (offset), box top at z=2 -> 4.1
    assert abs(float(depth[(h // 2) * w + w // 2]) - 4.1) < 0.3

    pts, valid = backproject.backproject(depth, hit, rays, r_c2w, t_c2w)
    p = pts[valid].numpy()
    vox = 8.0 / res
    assert (p[:, 2] <= 2.0 + 2 * vox).all() and (p[:, 2] >= -2 * vox).all()
    assert (np.abs(p[:, :2]) <= 1.0 + 2 * vox).all()
    assert (p[:, 2] > 1.5).any(), "top-face points"
    # background pixels collapse to the camera and are invalid
    np.testing.assert_array_equal(pts[~hit].numpy(),
                                  np.broadcast_to(t_c2w.numpy(), (int((~hit).sum()), 3)))


def test_check_collision_single_pose_matches_jax():
    res = 16
    box_lo = np.array([-2.0, -2.0, 0.0], np.float32)
    box_hi = np.array([2.0, 2.0, 4.0], np.float32)
    occ = np.zeros((res, res, res), np.uint8)
    occ[8, 8, 4] = 1  # voxel at x,y ~ [0,0.25], z ~ [1.0,1.25]
    for pos, inside in (([0.1, 0.1, 1.1], True), ([1.5, 1.5, 3.0], False),
                        ([0.3, 0.3, 1.4], True), ([-3.0, 0.0, 1.0], False)):
        pos = np.asarray(pos, np.float32)
        want = bool(jax_render.check_collision(jnp.asarray(occ.reshape(-1)),
                                               box_lo, box_hi, pos, 0.25, res))
        got = bool(render.check_collision(
            torch.from_numpy(occ.reshape(-1)), torch.from_numpy(box_lo),
            torch.from_numpy(box_hi), torch.from_numpy(pos), 0.25, res))
        assert got == want == inside
