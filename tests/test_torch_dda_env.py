"""The port's non-splat env paths against the JAX package's: the DDA env
with z-test and with Bresenham carving, the Bresenham ops and the z-test
carve with an explicit foreground mask, the exact scatter-min z-buffer
(``zbuf_impl=scatter``), and the splat settings the port routes to its
dense fused splat (compaction, row banding, the merged vis/carve gather).

Tolerances: every ``StepOutput`` and ``EnvState`` field is exact, except
the grayscale frames (in ``obs`` and ``rgb_buf``), held to 1e-4 as the
mapping golden holds them (the antialiased resize).  The Bresenham ops
are integer arithmetic and exact."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu import config as jax_config
from gennbv_tpu.env import ReconEnv as JaxReconEnv
from gennbv_tpu.env import scene as jax_scene
from gennbv_tpu.ops import carve as jax_carve
from gennbv_tpu.ops import voxel as jax_voxel
from gennbv_tpu_torch import config as pt_config
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.ops import carve as pt_carve
from gennbv_tpu_torch.ops import voxel as pt_voxel

N_ENVS, HW, RES, G = 4, 24, 24, 20
N_STATE = 600 + G ** 3          # pose history + tri-class grid in obs


def _cfgs(carve_mode="ztest", max_episode_length=5, **renderer):
    """(JAX, port) env configs: 4 envs, 24^2 camera, R=24, 2 scenes."""
    out = []
    for mod in (jax_config, pt_config):
        out.append(mod.EnvConfig(
            num_envs=N_ENVS, max_episode_length=max_episode_length,
            carve_mode=carve_mode,
            camera=mod.CameraConfig(height=HW, width=HW),
            renderer=mod.RendererConfig(resolution=RES, **renderer),
            scene=mod.SceneConfig(num_scenes=2, seed=7)))
    return out


def _actions(n_steps):
    """Random poses; envs 0-1 fly into the house center at low altitude
    on steps 2-3 (collisions), the rest time out every 5 steps."""
    rng = np.random.default_rng(3)
    acts = np.stack([rng.integers(0, k, (n_steps, N_ENVS))
                     for k in (81, 81, 51, 1, 13, 13)], -1).astype(np.int32)
    acts[2:4, :2, :3] = (40, 40, 3)
    return acts


def assert_same_step(pstate, pout, jstate, jout, t):
    obs_p, obs_j = pout.obs.numpy(), np.asarray(jout.obs)
    np.testing.assert_array_equal(obs_p[:, :N_STATE], obs_j[:, :N_STATE],
                                  err_msg=f"step {t}: obs")
    np.testing.assert_allclose(obs_p[:, N_STATE:], obs_j[:, N_STATE:],
                               rtol=0, atol=1e-4, err_msg=f"step {t}: gray")
    for name in pout._fields[1:]:
        np.testing.assert_array_equal(getattr(pout, name).numpy(),
                                      np.asarray(getattr(jout, name)),
                                      err_msg=f"step {t}: {name}")
    np.testing.assert_allclose(pstate.rgb_buf.numpy(),
                               np.asarray(jstate.rgb_buf), rtol=0, atol=1e-4)
    for name in pstate._fields:
        if name != "rgb_buf":
            np.testing.assert_array_equal(
                getattr(pstate, name).numpy(),
                np.asarray(getattr(jstate, name)).astype(
                    getattr(pstate, name).numpy().dtype),
                err_msg=f"step {t}: state.{name}")


def run_both(jcfg, pcfg, n_steps, jax_source=None, port_source=None):
    """Reset + n_steps scripted steps of both envs, compared at each.
    Returns how many collisions, timeouts and hit cells the JAX run saw."""
    jscenes = jax_scene.generate_procedural(jcfg.scene, RES)
    jenv = JaxReconEnv(jcfg, jscenes, jax_source)
    penv = ReconEnv(pcfg, make_scenes(pcfg.scene, RES, "cpu"), port_source)
    assert penv._use_init_cache == (jenv._init_cache is not None)
    jstate, jout = jenv.reset(N_ENVS)
    pstate, pout = penv.reset(N_ENVS)
    seen = {"collision": 0, "time_out": 0, "occupied": 0}
    acts = _actions(n_steps)
    for t in range(n_steps + 1):
        assert_same_step(pstate, pout, jstate, jout, t)
        seen["collision"] += int(np.asarray(jout.collision).sum())
        seen["time_out"] += int(np.asarray(jout.time_out).sum())
        seen["occupied"] += int((np.asarray(jstate.tri_grid) > 0).sum())
        if t == n_steps:
            break
        jstate, jout = jenv.step(jstate, jnp.asarray(acts[t]))
        pstate, pout = penv.step(pstate, torch.from_numpy(acts[t]))
    return seen


@pytest.mark.parametrize("carve_mode", ["ztest", "bresenham"])
def test_dda_env_matches_jax_env(carve_mode):
    """renderer.mode=dda: reset, 7 steps of 5-step episodes (collisions,
    timeouts and the auto-resets after them), every field exact."""
    seen = run_both(*_cfgs(carve_mode, mode="dda"), n_steps=7)
    assert seen["collision"] > 0 and seen["time_out"] > 0
    assert seen["occupied"] > 0


@pytest.mark.parametrize("renderer", [
    {"zbuf_impl": "scatter"},
    {"compact_cap_frac": 0.5},
    {"band_split": 8},
    {"merge_vis_carve": True},
], ids=lambda r: ",".join(f"{k}={v}" for k, v in r.items()))
def test_routed_splat_settings_match_jax_env(renderer):
    """The exact scatter-min z-buffer, and the settings the port runs on
    its dense fused splat, equal the JAX env under the same setting
    (compaction and banding take the init-view cache there and here)."""
    run_both(*_cfgs(**renderer), n_steps=6)


def _bresenham_case(case):
    """(src [N, 3], hit grids [N, G, G, G]) for one case: sources inside
    the grid, outside it (above, as a camera is), and on ties between the
    axes' distances."""
    rng = np.random.default_rng({"inside": 0, "outside": 1, "ties": 2}[case])
    n = 3
    hit = (rng.random((n, G, G, G)) < 0.02).astype(np.float32)
    if case == "inside":
        src = rng.integers(0, G, (n, 3))
    elif case == "outside":
        src = np.array([[10, 10, 35], [-6, 25, 30], [24, -3, -2]])
    else:
        src = np.array([[0, 0, 0], [19, 19, 19], [5, 5, 5]])
        hit[:] = 0.0
        for k in range(n):   # targets on the diagonals through the source
            for d in range(-G, G):
                p = src[k] + np.array([d, d, d])
                q = src[k] + np.array([d, d, 0])
                r = src[k] + np.array([0, d, d])
                for c in (p, q, r):
                    if ((c >= 0) & (c < G)).all():
                        hit[k, c[0], c[1], c[2]] = 1.0
    return src.astype(np.int32), hit


@pytest.mark.parametrize("case", ["inside", "outside", "ties"])
def test_bresenham_ops_match_jax(case):
    """bresenham_traversed, carve_bresenham and pose_to_voxel_idx equal the
    JAX functions bit for bit."""
    src, hit = _bresenham_case(case)
    want = np.asarray(jax.jit(jax.vmap(
        lambda h, s: jax_carve.carve_bresenham(h, s, G)))(hit, src))
    got = pt_carve.carve_bresenham(torch.from_numpy(hit),
                                   torch.from_numpy(src), G).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.sum() > hit.sum() / 2

    # the traversal on a subset of targets, with its own validity mask
    ar = np.arange(G, dtype=np.int32)
    targets = np.stack(np.meshgrid(ar, ar, ar, indexing="ij"), -1)
    targets = targets.reshape(-1, 3)[::7]
    valid = hit.reshape(len(src), -1)[:, ::7] > 0.5
    want = np.asarray(jax.jit(jax.vmap(
        lambda s, v: jax_carve.bresenham_traversed(s, targets, v, G)))(
            src, valid))
    got = pt_carve.bresenham_traversed(
        torch.from_numpy(src), torch.from_numpy(targets),
        torch.from_numpy(valid), G).numpy()
    np.testing.assert_array_equal(got, want)

    # the camera voxel of poses inside and outside the mapped box
    sc = jax_scene.generate_procedural(
        jax_config.SceneConfig(num_scenes=3, seed=1), 16)
    rng = np.random.default_rng(5)
    pos = np.concatenate([rng.uniform(-8, 8, (3, 2)), rng.uniform(-1, 12, (3, 1))],
                         -1).astype(np.float32)
    pos[0] = np.asarray(sc.range_gt)[0, [1, 3, 5]]   # a voxel center
    want = np.asarray(jax.jit(jax_voxel.pose_to_voxel_idx)(
        pos, sc.range_gt, sc.voxel_size))
    got = pt_voxel.pose_to_voxel_idx(
        torch.from_numpy(pos), torch.from_numpy(np.array(sc.range_gt)),
        torch.from_numpy(np.array(sc.voxel_size))).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want < 0).any() or (want >= G).any()


def test_carve_ztest_with_explicit_fg():
    """carve_ztest with the ray march's hit mask as foreground, on frames
    with hits in [depth_max (1 - 1e-4), depth_max): there the depth-derived
    foreground says background and the mask says foreground."""
    sc = jax_scene.generate_procedural(
        jax_config.SceneConfig(num_scenes=2, seed=4), 16)
    rng = np.random.default_rng(6)
    n, h, w, dmax = 2, 20, 28, 20.0
    rg, vs = np.asarray(sc.range_gt), np.asarray(sc.voxel_size)
    centers = np.array(jax.jit(jax.vmap(
        lambda r, v: jax_scene.voxel_centers(r, v, G)))(rg, vs))
    from gennbv_tpu.ops import camera as jax_camera
    poses = np.array([[0.0, -9.0, 3.0, 0.0, 0.0, np.pi / 2],
                      [9.0, 0.0, 3.0, 0.0, 0.0, np.pi]], np.float32)
    r, t = jax.vmap(jax_camera.pose_to_c2w)(jnp.asarray(poses))
    r, t = np.array(r), np.array(t)
    depth = rng.uniform(dmax * (1 - 1e-4), dmax, (n, h, w)).astype(np.float32)
    near = rng.random((n, h, w)) < 0.5
    depth[near] = rng.uniform(5.0, 15.0, near.sum())
    fg = rng.random((n, h, w)) < 0.8
    margin = (0.5 * vs.mean(-1)).astype(np.float32)
    k = jax_camera.intrinsics(h, w, 90.0)
    want = np.asarray(jax.jit(jax.vmap(
        lambda c, d, f, rr, tt, m: jax_carve.carve_ztest(
            c, d, f, k, rr, tt, m)))(centers, depth, fg, r, t, margin))
    tt = torch.from_numpy
    got = pt_carve.carve_ztest(tt(centers), tt(depth), tt(k), tt(r), tt(t),
                               tt(margin), fg=tt(fg)).numpy()
    np.testing.assert_array_equal(got, want)
    derived = pt_carve.carve_ztest(tt(centers), tt(depth), tt(k), tt(r), tt(t),
                                   tt(margin), dmax).numpy()
    assert (got > derived).any(), "the far hits carve only with fg given"
    with pytest.raises(ValueError, match="fg or depth_max"):
        pt_carve.carve_ztest(tt(centers), tt(depth), tt(k), tt(r), tt(t),
                             tt(margin))


def test_config_routes_and_validates():
    """The init-view cache follows the JAX predicate; unknown names raise."""
    scenes = make_scenes(pt_config.SceneConfig(num_scenes=1), 16, "cpu")
    base = _cfgs()[1]
    cases = [({"mode": "dda", "zbuf_impl": "pallas"}, False),
             ({"band_split": 7}, False),            # 7 does not divide 24
             ({"band_split": 8}, True), ({"compact_cap_frac": 0.25}, True),
             ({"zbuf_impl": "pallas"}, True), ({"zbuf_impl": "scatter"}, False)]
    for renderer, cached in cases:
        cfg = dataclasses.replace(base, renderer=dataclasses.replace(
            base.renderer, resolution=16, **renderer))
        assert ReconEnv(cfg, scenes)._use_init_cache == cached, renderer
    for bad in ({"mode": "raster"}, {"zbuf_impl": "radix"}):
        with pytest.raises(ValueError):
            pt_config.RendererConfig(**bad)
    with pytest.raises(ValueError):
        pt_config.EnvConfig(carve_mode="raycast")
