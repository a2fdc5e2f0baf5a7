"""The port's env end to end: the committed mapping golden, and a direct
run beside the JAX env that goes through collisions, timeouts and
auto-resets."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import torch

from gennbv_tpu import config as jax_config
from gennbv_tpu.env import ReconEnv as JaxReconEnv
from gennbv_tpu.env import scene as jax_scene
from gennbv_tpu_torch import config as pt_config
from gennbv_tpu_torch.env import ReconEnv, make_scenes

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "mapping_golden.npz")
# the golden's scripted actions (tools/make_goldens.py)
GOLDEN_ACTIONS = np.array([[50, 30, 20, 0, 6, 3],
                           [20, 60, 15, 0, 4, 9],
                           [70, 40, 30, 0, 8, 0]], np.int32)


def _golden_run():
    """tools/make_goldens.py's config and actions, through the port."""
    cfg = pt_config.EnvConfig(
        num_envs=4,
        camera=pt_config.CameraConfig(height=24, width=24),
        renderer=pt_config.RendererConfig(resolution=24),
        scene=pt_config.SceneConfig(num_scenes=2, seed=7),
        max_episode_length=6,
    )
    env = ReconEnv(cfg, make_scenes(cfg.scene, cfg.renderer.resolution, "cpu"))
    state, out = env.reset(4)
    obs, rew, cov = [out.obs], [], []
    for a in GOLDEN_ACTIONS:
        state, out = env.step(state, torch.from_numpy(a)[None].repeat(4, 1))
        obs.append(out.obs)
        rew.append(out.reward)
        cov.append(out.coverage)
    return {"obs": torch.stack(obs).numpy(),
            "rewards": torch.stack(rew).numpy(),
            "coverage": torch.stack(cov).numpy(),
            "prob_grid": state.prob_grid.numpy()}


def test_port_matches_mapping_golden():
    """tests/test_goldens.py's tolerances: coverage and prob_grid to 1e-6,
    rewards and obs to 1e-4 (obs holds the resized grayscale frames)."""
    got = _golden_run()
    want = np.load(GOLDEN)
    np.testing.assert_array_equal(GOLDEN_ACTIONS, want["actions"])
    np.testing.assert_allclose(got["coverage"], want["coverage"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["rewards"], want["rewards"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["prob_grid"], want["prob_grid"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["obs"], want["obs"], rtol=0, atol=1e-4)


def _direct_cfgs():
    kw = dict(num_envs=8, max_episode_length=3)
    sub = dict(camera=dict(height=16, width=16), renderer=dict(resolution=16),
               scene=dict(num_scenes=4, seed=11))
    cfgs = []
    for mod in (jax_config, pt_config):
        cfgs.append(mod.EnvConfig(
            camera=mod.CameraConfig(**sub["camera"]),
            renderer=mod.RendererConfig(**sub["renderer"]),
            scene=mod.SceneConfig(**sub["scene"]), **kw))
    return cfgs


def _scripted_actions(n_steps, n_envs):
    """Random poses, with envs 0-1 flying into the house center at low
    altitude (collisions) and the rest timing out every 3 steps."""
    rng = np.random.default_rng(0)
    acts = np.stack([rng.integers(0, k, (n_steps, n_envs))
                     for k in (81, 81, 51, 1, 13, 13)], -1).astype(np.int32)
    acts[1:4, :2, :3] = (40, 40, 3)          # x = y = 0, z = 0.7 m
    return acts


def _assert_same_step(pstate, pout, jstate, jout, t):
    for name in pout._fields[1:]:
        np.testing.assert_array_equal(getattr(pout, name).numpy(),
                                      np.asarray(getattr(jout, name)),
                                      err_msg=f"step {t}: {name}")
    for name in pstate._fields[2:]:
        np.testing.assert_array_equal(getattr(pstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=f"step {t}: state.{name}")


def test_port_env_matches_jax_env():
    """8 envs, 16^2 camera, R=16, 3-step episodes, 6 scripted steps.
    Pose history, the tri-class grid, rewards, dones, timeouts, collisions
    and coverage are exact; the grayscale frames are held to 1e-4 (the
    resize, as in the golden)."""
    jcfg, pcfg = _direct_cfgs()
    jenv = JaxReconEnv(jcfg, jax_scene.generate_procedural(jcfg.scene, 16))
    penv = ReconEnv(pcfg, make_scenes(pcfg.scene, 16, "cpu"))
    jstate, jout = jenv.reset(8)
    pstate, pout = penv.reset(8)
    acts = _scripted_actions(6, 8)
    n_state = 600 + 8000
    seen = {"collision": 0, "time_out": 0}
    for t in range(7):
        obs_j, obs_p = np.asarray(jout.obs), pout.obs.numpy()
        np.testing.assert_array_equal(obs_p[:, :n_state], obs_j[:, :n_state])
        np.testing.assert_allclose(obs_p[:, n_state:], obs_j[:, n_state:],
                                   rtol=0, atol=1e-4)
        _assert_same_step(pstate, pout, jstate, jout, t)
        for key in seen:
            seen[key] += int(np.asarray(getattr(jout, key)).sum())
        if t == 6:
            break
        jstate, jout = jenv.step(jstate, jnp.asarray(acts[t]))
        pstate, pout = penv.step(pstate, torch.from_numpy(acts[t]))
    assert seen["collision"] > 0 and seen["time_out"] > 0



def test_long_episodes_match_jax_env():
    """34 collision-free steps of 36-step episodes: past step 30 the
    short-path penalty enters the reward; rewards and the per-episode sums
    stay exact."""
    jcfg, pcfg = _direct_cfgs()
    jcfg = dataclasses.replace(jcfg, max_episode_length=36)
    pcfg = dataclasses.replace(pcfg, max_episode_length=36)
    jenv = JaxReconEnv(jcfg, jax_scene.generate_procedural(jcfg.scene, 16))
    penv = ReconEnv(pcfg, make_scenes(pcfg.scene, 16, "cpu"))
    jstate, jout = jenv.reset(8)
    pstate, pout = penv.reset(8)
    acts = _scripted_actions(34, 8)
    acts[..., 2] = np.random.default_rng(1).integers(40, 51, (34, 8))  # z >= 8.1 m
    for t in range(34):
        jstate, jout = jenv.step(jstate, jnp.asarray(acts[t]))
        pstate, pout = penv.step(pstate, torch.from_numpy(acts[t]))
        _assert_same_step(pstate, pout, jstate, jout, t)
    assert not np.asarray(jout.done).any()
    assert (np.asarray(jstate.ep_rew_short_path) < 0).all()
