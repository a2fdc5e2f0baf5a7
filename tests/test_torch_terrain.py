"""The port's terrain scene family (``gennbv_tpu_torch/env/terrain.py``,
``scene.dataset="terrain"``) against the JAX package's: the generated
SceneSet bit-equal for every terrain kind, with and without the
curriculum rows; tests/test_aux.py's two terrain cases on the port; and
the port's env on terrain scenes exact against the JAX env."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu import config as jax_config
from gennbv_tpu.env import ReconEnv as JaxReconEnv
from gennbv_tpu.env import terrain as jax_terrain
from gennbv_tpu_torch import config as pt_config
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.env import scene as pt_scene
from gennbv_tpu_torch.env import terrain as pt_terrain


def _assert_sceneset_equal(got, want):
    assert got.grid_res == want.grid_res and got.grid_size == want.grid_size
    for name in pt_scene.SceneSet._fields[:-2]:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.device.type == "cpu"
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("kind", pt_terrain.TERRAIN_TYPES)
def test_each_kind_bit_equal(kind):
    """Three curriculum rows of one kind at R=32."""
    kw = dict(num_scenes=3, seed=4, extent_xy=8.0, extent_z=4.0)
    want = jax_terrain.generate_terrain(jax_config.SceneConfig(**kw), 32,
                                        kinds=(kind,))
    got = pt_terrain.generate_terrain(pt_config.SceneConfig(**kw), 32,
                                      kinds=(kind,), device="cpu")
    _assert_sceneset_equal(got, want)


@pytest.mark.parametrize("curriculum", [True, False])
def test_make_scenes_terrain_bit_equal(curriculum):
    """make_scenes(dataset="terrain") (all five kinds, the curriculum
    rows) and a random-difficulty set, at the env's R=16 and R=64."""
    kw = dict(num_scenes=10, seed=0, dataset="terrain", extent_xy=8.0,
              extent_z=4.0)
    for res in (16, 64):
        if curriculum:
            want = jax_terrain.generate_terrain(jax_config.SceneConfig(**kw), res)
            got = make_scenes(pt_config.SceneConfig(**kw), res, "cpu")
        else:
            want = jax_terrain.generate_terrain(jax_config.SceneConfig(**kw),
                                                res, curriculum=False)
            got = pt_terrain.generate_terrain(pt_config.SceneConfig(**kw), res,
                                              curriculum=False, device="cpu")
        _assert_sceneset_equal(got, want)
    with pytest.raises(ValueError, match="unknown terrain kind"):
        pt_terrain._height_field("cliff", 8, 0.5, np.random.RandomState(0), 8.0)


# ---------------------------------------------------------------------------
# tests/test_aux.py's terrain cases, on the port


def _tiny_env_cfg(**kw):
    return pt_config.EnvConfig(
        num_envs=kw.pop("num_envs", 4),
        camera=pt_config.CameraConfig(height=16, width=16),
        renderer=pt_config.RendererConfig(resolution=16),
        scene=kw.pop("scene", pt_config.SceneConfig(num_scenes=2, seed=0)),
        max_episode_length=kw.pop("max_episode_length", 5), **kw)


def test_terrain_sceneset_all_kinds():
    cfg = pt_config.SceneConfig(num_scenes=2 * len(pt_terrain.TERRAIN_TYPES),
                                seed=0, extent_xy=8.0, extent_z=4.0)
    scenes = pt_terrain.generate_terrain(cfg, grid_res=16, device="cpu")
    assert scenes.num_scenes == 2 * len(pt_terrain.TERRAIN_TYPES)
    occ = scenes.render_occ.numpy().reshape(-1, 16, 16, 16)
    assert (occ[:, :, :, 0] == 1).all()
    frac = occ.mean(axis=(1, 2, 3))
    assert (frac > 0.03).all() and (frac < 0.9).all(), frac
    k = pt_terrain.TERRAIN_TYPES.index("stairs")
    assert occ[k + len(pt_terrain.TERRAIN_TYPES)].sum() >= occ[k].sum()
    assert (scenes.num_valid_voxel.numpy() > 0).all()


def test_terrain_env_steps():
    cfg = _tiny_env_cfg(scene=pt_config.SceneConfig(
        num_scenes=2, seed=0, dataset="terrain", extent_xy=8.0, extent_z=4.0))
    env = ReconEnv(cfg, make_scenes(cfg.scene, cfg.renderer.resolution, "cpu"))
    state, out = env.reset(4)
    assert bool(torch.isfinite(out.obs).all())
    a = env.init_action[None, :].repeat(4, 1).int()
    shift = torch.tensor([5, 5, -10, 0, 0, 3], dtype=torch.int32)
    state, out = env.step(state, (a + shift) % env.nvec)
    assert float(out.coverage.max()) > 0.0


# ---------------------------------------------------------------------------
# the env on terrain scenes, exact against the JAX env


def test_env_on_terrain_matches_jax_env():
    """8 envs over 5 terrain scenes (one of each kind), 16^2 camera, R=16,
    3-step episodes, 6 random steps: every field of the state and the
    step's outputs equal the JAX env's, but the grayscale frames (1e-4,
    the resize, as in the golden)."""
    kw = dict(num_envs=8, max_episode_length=3)
    scene_kw = dict(num_scenes=5, seed=2, dataset="terrain", extent_xy=8.0,
                    extent_z=4.0)
    cfgs = [mod.EnvConfig(camera=mod.CameraConfig(height=16, width=16),
                          renderer=mod.RendererConfig(resolution=16),
                          scene=mod.SceneConfig(**scene_kw), **kw)
            for mod in (jax_config, pt_config)]
    jenv = JaxReconEnv(cfgs[0], jax_terrain.generate_terrain(cfgs[0].scene, 16))
    penv = ReconEnv(cfgs[1], make_scenes(cfgs[1].scene, 16, "cpu"))
    jstate, jout = jenv.reset(8)
    pstate, pout = penv.reset(8)
    rng = np.random.default_rng(3)
    acts = np.stack([rng.integers(0, k, (6, 8)) for k in (81, 81, 51, 1, 13, 13)],
                    -1).astype(np.int32)
    n_state = 600 + 8000
    covered = 0.0
    for t in range(7):
        obs_j, obs_p = np.asarray(jout.obs), pout.obs.numpy()
        np.testing.assert_array_equal(obs_p[:, :n_state], obs_j[:, :n_state])
        np.testing.assert_allclose(obs_p[:, n_state:], obs_j[:, n_state:],
                                   rtol=0, atol=1e-4)
        for name in pout._fields[1:]:
            np.testing.assert_array_equal(getattr(pout, name).numpy(),
                                          np.asarray(getattr(jout, name)),
                                          err_msg=f"step {t}: {name}")
        for name in pstate._fields[2:]:
            np.testing.assert_array_equal(getattr(pstate, name).numpy(),
                                          np.asarray(getattr(jstate, name)),
                                          err_msg=f"step {t}: state.{name}")
        covered = max(covered, float(pout.coverage.max()))
        if t == 6:
            break
        jstate, jout = jenv.step(jstate, jnp.asarray(acts[t]))
        pstate, pout = penv.step(pstate, torch.from_numpy(acts[t]))
    assert covered > 0.0
