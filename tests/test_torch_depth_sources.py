"""The port's external depth sources (``gennbv_tpu_torch/env/depth_sources.py``):
a replay env fed the frames of the visited poses equals the DDA env bit
for bit (both render with the same eager function), nearest-pose lookup,
the host-callback source, the missing-source refusal, and the replay env
against the JAX replay env on one bank (exact: the same frames go in)."""
import test_torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennbv_tpu import config as jax_config
from gennbv_tpu.env import ReconEnv as JaxReconEnv
from gennbv_tpu.env import scene as jax_scene
from gennbv_tpu.env.depth_sources import ReplayBank as JaxReplayBank
from gennbv_tpu.env.depth_sources import \
    ReplayDepthSource as JaxReplayDepthSource
from gennbv_tpu_torch import config as pt_config
from gennbv_tpu_torch import spec
from gennbv_tpu_torch.algo.runner import Runner
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.env.depth_sources import (CallbackDepthSource,
                                                ReplayBank,
                                                ReplayDepthSource,
                                                record_replay_bank)
from gennbv_tpu_torch.ops import camera, fp32, render

N, HW, RES = 4, 16, 16


def _cfg(mode, mod=pt_config, **kw):
    return mod.EnvConfig(
        num_envs=N, max_episode_length=5,
        camera=mod.CameraConfig(height=HW, width=HW),
        renderer=mod.RendererConfig(resolution=RES, mode=mode),
        scene=mod.SceneConfig(num_scenes=2, seed=0), **kw)


def _actions(steps):
    rng = np.random.default_rng(1)
    return np.stack([rng.integers(0, k, (steps, N)) for k in spec.NVEC],
                    -1).astype(np.int32)


def _visited_poses(env, acts):
    """[S, M, 6] the poses the env step makes of the forced init action and
    of each scripted action (one fused multiply-add, as the step)."""
    a = np.concatenate([np.broadcast_to(spec.INIT_ACTION, (1, N, 6)), acts])
    poses = fp32.fma(torch.from_numpy(a.reshape(-1, 6)).float(),
                     env.action_unit, env.pose_low)
    return poses[None].expand(env.scenes.num_scenes, -1, -1).numpy()


def _run(env, acts):
    state, out = env.reset(N)
    outs = [out]
    for a in acts:
        state, out = env.step(state, torch.from_numpy(a))
        outs.append(out)
    return state, outs


def _assert_equal_runs(a, b):
    (sa, oa), (sb, ob) = a, b
    for x, y in zip(oa, ob):
        for name in x._fields:
            assert torch.equal(getattr(x, name), getattr(y, name)), name
    for name in sa._fields:
        assert torch.equal(getattr(sa, name), getattr(sb, name)), name


@pytest.fixture(scope="module")
def scenes():
    return make_scenes(_cfg("dda").scene, RES, "cpu")


def test_replay_env_equals_dda_env(scenes):
    """Reset + 6 steps (auto-resets after step 4) with ztest and with
    bresenham carving: every output and state field equal."""
    acts = _actions(6)
    for carve in ("ztest", "bresenham"):
        dda = ReconEnv(_cfg("dda", carve_mode=carve), scenes)
        bank = record_replay_bank(scenes, dda.cfg.camera,
                                  _visited_poses(dda, acts))
        rep = ReconEnv(_cfg("replay", carve_mode=carve), scenes,
                       ReplayDepthSource(bank))
        want = _run(dda, acts)
        assert any(o.done.any() for o in want[1])
        _assert_equal_runs(_run(rep, acts), want)


def test_replay_nearest_pose_lookup(scenes):
    """Off-bank poses snap to the nearest recorded pose."""
    poses = np.array([[0, 0, 5, 0, np.pi / 2, 0],
                      [3, 3, 4, 0, 0.5, 1.0]], np.float32)
    bank = record_replay_bank(scenes, _cfg("dda").camera, poses)
    assert bank.frames.shape == (2, 2, HW * HW)
    src = ReplayDepthSource(bank)
    probe = torch.tensor([[0.1, -0.1, 5.05, 0, np.pi / 2, 0],
                          [2.9, 3.2, 4.1, 0, 0.45, 1.1]])
    d, fg = src.render_batch(torch.tensor([0, 1]), probe)
    assert torch.equal(d[0], bank.frames[0, 0])
    assert torch.equal(d[1], bank.frames[1, 1])
    assert torch.equal(fg[1], bank.fg[1, 1])


def test_callback_env_equals_dda_env(scenes):
    """A host callback that renders with the port's DDA on the host gives
    the DDA env's run."""
    cam = _cfg("dda").camera
    rays = torch.from_numpy(camera.camera_rays(HW, HW, cam.horizontal_fov_deg))
    calls = []

    def host_render(sids, poses):
        assert isinstance(sids, np.ndarray) and isinstance(poses, np.ndarray)
        calls.append(len(sids))
        r, t = camera.pose_to_c2w(torch.from_numpy(poses), cam.z_offset)
        sid = torch.from_numpy(sids).long()
        d, _ = render.render_depth(scenes.render_occ[sid], scenes.box_lo[sid],
                                   scenes.box_hi[sid], rays, r, t, RES,
                                   3 * RES, cam.depth_max)
        return d.numpy()

    acts = _actions(3)
    src = CallbackDepthSource(host_render, HW, HW, cam.depth_max)
    got = _run(ReconEnv(_cfg("callback"), scenes, src), acts)
    _assert_equal_runs(got, _run(ReconEnv(_cfg("dda"), scenes), acts))
    assert calls == [N] * 4
    bad = CallbackDepthSource(lambda s, p: np.zeros((N, 3)), HW, HW, 20.0)
    with pytest.raises(ValueError, match="depth callback"):
        bad.render_batch(torch.zeros(N, dtype=torch.long), torch.zeros(N, 6))


def test_missing_depth_source_raises(scenes):
    for mode in ("replay", "callback"):
        with pytest.raises(ValueError, match="depth_source"):
            ReconEnv(_cfg(mode), scenes)
    cfg = pt_config.Config(env=_cfg("replay"))
    cfg = dataclasses.replace(cfg, runner=dataclasses.replace(
        cfg.runner, eval_camera=32))
    bank = record_replay_bank(scenes, cfg.env.camera, np.zeros((1, 6), np.float32))
    with pytest.raises(ValueError, match="eval_camera"):
        Runner(cfg, scenes=scenes, eval_scenes=scenes, device="cpu",
               depth_source=ReplayDepthSource(bank),
               eval_depth_source=ReplayDepthSource(bank))


def test_replay_env_matches_jax_replay_env(scenes):
    """One bank (the port's DDA frames at the visited poses and at poses
    between them) fed to both packages' replay envs: every step equal, the
    grayscale frames to 1e-4."""
    from test_torch_dda_env import assert_same_step
    acts = _actions(6)
    poses = _visited_poses(ReconEnv(_cfg("dda"), scenes), acts)
    poses = np.concatenate([poses, poses[:, ::3] + 0.3], 1)
    bank = record_replay_bank(scenes, _cfg("dda").camera, poses)
    jbank = JaxReplayBank(*(jnp.asarray(x.numpy()) for x in bank))
    jscenes = jax_scene.generate_procedural(_cfg("dda").scene, RES)
    jenv = JaxReconEnv(_cfg("replay", jax_config), jscenes,
                       JaxReplayDepthSource(jbank))
    penv = ReconEnv(_cfg("replay"), scenes, ReplayDepthSource(
        ReplayBank(*bank)))
    jstate, jout = jenv.reset(N)
    pstate, pout = penv.reset(N)
    for t in range(len(acts) + 1):
        assert_same_step(pstate, pout, jstate, jout, t)
        if t == len(acts):
            break
        jstate, jout = jenv.step(jstate, jnp.asarray(acts[t]))
        pstate, pout = penv.step(pstate, torch.from_numpy(acts[t]))
