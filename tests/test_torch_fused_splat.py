"""The port's splat through its fused z-buffer + visibility
(``ops/fused_splat.py``; its plain version on these CPU tensors) against
the JAX package's ``splat_depth(..., "pallas")``, whose Pallas kernel runs
in interpret mode off a TPU, and against its ``"mxu"`` path.

Visibility and the foreground mask are exact.  The z-buffer is exact
against the JAX mxu path, whose rounding the port follows, and held to
rtol 3e-7 against the JAX pallas path: the JAX kernel's decode
``zmin + frac * zrange`` is fused differently by XLA and may differ from
its own mxu path by one ulp (tests/test_pallas_splat.py)."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu import spec
from gennbv_tpu.config import SceneConfig as JaxSceneConfig
from gennbv_tpu.env import scene as jax_scene
from gennbv_tpu.ops import camera as jax_camera
from gennbv_tpu.ops import splat as jax_splat
from gennbv_tpu_torch.ops import fused_splat
from gennbv_tpu_torch.ops import splat as pt_splat

DMAX = 50.0
PALLAS_ZBUF_RTOL = 3e-7


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _random_clouds(seeds, q=700, h=64, w=64):
    """tests/test_pallas_splat.py's random clouds, one env per seed, seen
    from its fixed pose."""
    pts, mask = [], []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        pts.append((rng.uniform(-2, 2, (q, 3)) * np.array([1, 1, 0.5])
                    + np.array([0, 0, 1.5])).astype(np.float32))
        mask.append(rng.random(q) < 0.8)
    pose = jnp.array([0.3, -0.2, 6.0, 0.0, np.pi / 2, 0.15])
    r, t = jax_camera.pose_to_c2w(pose)
    n = len(seeds)
    r = np.broadcast_to(np.asarray(r), (n, 3, 3)).copy()
    t = np.broadcast_to(np.asarray(t), (n, 3)).copy()
    k = jax_camera.intrinsics(h, w, 90.0)
    return np.stack(pts), np.stack(mask), k, r, t, h, w


def _jax_splat(impl, pts, mask, k, r, t, h, w, veps, skip=None):
    fn = jax.jit(lambda p, m, rr, tt, e, s: jax_splat.splat_depth_batch(
        p, m, k, rr, tt, h, w, DMAX, e, 1, impl, None, skip_env=s))
    return [np.asarray(x) for x in fn(pts, mask, r, t, veps, skip)]


def _check(got, want, impl):
    """The port's (zbuf, fg, visible) against one JAX path's."""
    zb, fg, vis = (x.numpy() for x in got)
    if impl == "mxu":
        np.testing.assert_array_equal(zb, want[0])
    else:
        np.testing.assert_allclose(zb, want[0], rtol=PALLAS_ZBUF_RTOL, atol=0)
    np.testing.assert_array_equal(fg, want[1], err_msg="fg")
    np.testing.assert_array_equal(vis, want[2], err_msg="visible")


def test_random_clouds_match_jax_pallas():
    """Seeds 0-2 of test_pallas_splat.py, 64x64, Q = 700, batched."""
    pts, mask, k, r, t, h, w = _random_clouds((0, 1, 2))
    veps = np.array([0.15, 0.15, 0.15], np.float32)
    want_p = _jax_splat("pallas", pts, mask, k, r, t, h, w, veps)
    want_m = _jax_splat("mxu", pts, mask, k, r, t, h, w, veps)
    got = pt_splat.splat_depth(*_t(pts, mask, k, r, t), h, w, DMAX,
                               torch.from_numpy(veps), 1)
    _check(got, want_p, "pallas")
    _check(got, want_m, "mxu")
    assert want_p[2].sum() > 100                  # points are seen

    # the plain version and the wrapper, on the projected points
    proj = [x.contiguous()
            for x in pt_splat.project_px(*_t(pts, mask, k, r, t), h, w)]
    for fn in (fused_splat.zbuf_visible_ref, fused_splat.zbuf_visible):
        zbuf, vis = fn(*proj, torch.from_numpy(veps), h, w, DMAX, 1)
        assert zbuf.dtype == torch.float32 and zbuf.shape == (3, h * w)
        assert vis.dtype == torch.bool and vis.shape == (3, 700)
        np.testing.assert_array_equal(zbuf.numpy(), want_m[0])
        np.testing.assert_array_equal(vis.numpy(), want_p[2])


def test_no_valid_points():
    """Every point above the camera: the z-buffer is depth_max everywhere
    and nothing is visible, on both JAX paths and the port."""
    _, _, k, r, t, h, w = _random_clouds((5,))
    pts = np.zeros((1, 16, 3), np.float32)
    pts[..., 2] = 20.0
    mask = np.ones((1, 16), bool)
    veps = np.array([0.1], np.float32)
    want_p = _jax_splat("pallas", pts, mask, k, r, t, h, w, veps)
    want_m = _jax_splat("mxu", pts, mask, k, r, t, h, w, veps)
    got = pt_splat.splat_depth(*_t(pts, mask, k, r, t), h, w, DMAX,
                               torch.from_numpy(veps), 1)
    _check(got, want_p, "pallas")
    _check(got, want_m, "mxu")
    assert (got[0] == DMAX).all() and not got[2].any()


@pytest.mark.parametrize("impl", ["pallas", "mxu"])
def test_splat_depth_batch_skip_env_matches_jax(impl):
    """Procedural scenes from action-grid poses (env 0 at the forced init
    view); envs 1 and 3 are skipped: their points are masked out.  Held
    against the JAX batched splat on each of its z-buffer paths."""
    n, h, w = 4, 48, 48
    scenes = jax_scene.generate_procedural(JaxSceneConfig(num_scenes=n, seed=3), 16)
    rng = np.random.default_rng(3)
    acts = np.stack([rng.integers(0, k, n) for k in spec.NVEC], -1)
    acts[0] = spec.INIT_ACTION
    pose = (acts * np.asarray(spec.ACTION_UNIT, np.float32)
            + np.asarray(spec.CLIP_POSE_LOW, np.float32)).astype(np.float32)
    r, t = (np.array(a) for a in jax.vmap(jax_camera.pose_to_c2w)(jnp.asarray(pose)))
    pts, mask = np.asarray(scenes.surf_pts), np.asarray(scenes.surf_mask)
    veps = np.asarray((scenes.box_hi - scenes.box_lo) / 16).mean(-1).astype(np.float32)
    k = jax_camera.intrinsics(h, w, 90.0)
    skip = np.array([False, True, False, True])

    want = _jax_splat(impl, pts, mask, k, r, t, h, w, veps, skip)
    got = pt_splat.splat_depth_batch(*_t(pts, mask, k, r, t), h, w, DMAX,
                                     torch.from_numpy(veps), 1,
                                     skip_env=torch.from_numpy(skip))
    _check(got, want, impl)
    assert (got[0][skip] == DMAX).all() and not got[2][skip].any()
    assert got[2][~skip].any()


def test_rejects_what_the_kernel_does_not_take():
    vi = torch.zeros(2, 5, dtype=torch.int32)
    z = torch.ones(2, 5)
    ok = torch.ones(2, 5, dtype=torch.bool)
    eps = torch.full((2,), 0.1)
    with pytest.raises(TypeError):
        fused_splat.zbuf_visible(vi, vi, z.double(), ok, eps, 4, 4, DMAX)
    with pytest.raises(ValueError):
        fused_splat.zbuf_visible(vi, vi, z, ok, eps[:1], 4, 4, DMAX)
    with pytest.raises(ValueError):
        fused_splat.zbuf_visible(vi, vi[:, :4], z, ok, eps, 4, 4, DMAX)
    with pytest.raises(ValueError):
        fused_splat.zbuf_visible(vi, vi, z.t().contiguous().t(), ok, eps, 4,
                                 4, DMAX)
