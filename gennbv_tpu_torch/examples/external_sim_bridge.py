"""Feed the NBV env from an external depth source (port of
``examples/03_external_sim_bridge.py``).

    python -m gennbv_tpu_torch.examples.external_sim_bridge [--device cpu]

Two modes (env/depth_sources.py):
- a recorded replay bank (train/test against captured frames);
- a live host-callback bridge (plug in any external simulator or
  renderer: the host function gets (scene_ids, poses) and returns depth
  frames).
Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from gennbv_tpu_torch import spec
from gennbv_tpu_torch.config import (CameraConfig, EnvConfig, RendererConfig,
                                     SceneConfig)
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.env.depth_sources import (CallbackDepthSource,
                                                ReplayDepthSource,
                                                record_replay_bank)


def main(argv=None) -> dict:
    """Runs both modes; returns the replay env's coverage and whether the
    callback env's observation is finite."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    device = p.parse_args(argv).device
    cfg = EnvConfig(num_envs=4,
                    camera=CameraConfig(height=16, width=16),
                    renderer=RendererConfig(resolution=16, mode="replay"),
                    scene=SceneConfig(num_scenes=2, seed=0),
                    max_episode_length=6)
    scenes = make_scenes(cfg.scene, cfg.renderer.resolution, device)

    # --- record a bank with the built-in DDA renderer (stand-in for
    # captured frames from a real sensor or an external simulator)
    rng = np.random.RandomState(0)
    acts = rng.randint(0, np.array(spec.NVEC), size=(20, 6))
    poses = (acts * np.array(spec.ACTION_UNIT)
             + np.array(spec.CLIP_POSE_LOW)).astype(np.float32)
    init = (np.array(spec.INIT_ACTION) * np.array(spec.ACTION_UNIT)
            + np.array(spec.CLIP_POSE_LOW)).astype(np.float32)
    bank = record_replay_bank(scenes, cfg.camera,
                              np.concatenate([init[None], poses]))

    env = ReconEnv(cfg, scenes, ReplayDepthSource(bank))
    state, out = env.reset(4)
    actions = torch.as_tensor(acts[:4], dtype=torch.int32,
                              device=env.nvec.device) % env.nvec
    state, out = env.step(state, actions)
    coverage = out.coverage.cpu().numpy()
    print("replay-fed coverage:", coverage.round(3))

    # --- live bridge: any host function returning [N, H*W] float32 depth
    frames, bposes = bank.frames.cpu().numpy(), bank.poses.cpu().numpy()
    weight = np.array([1, 1, 1, 0, 0.76, 0.76], np.float32)

    def my_simulator(scene_ids, q_poses):
        d2 = (((q_poses[:, None, :] - bposes[scene_ids]) * weight) ** 2).sum(-1)
        return frames[scene_ids, d2.argmin(-1)]

    cb_cfg = dataclasses.replace(
        cfg, renderer=RendererConfig(resolution=16, mode="callback"))
    env_cb = ReconEnv(cb_cfg, scenes, CallbackDepthSource(
        my_simulator, 16, 16, cfg.camera.depth_max))
    state, out = env_cb.reset(4)
    finite = bool(torch.isfinite(out.obs).all())
    print("callback-fed obs finite:", finite)
    return {"coverage": coverage, "finite": finite}


if __name__ == "__main__":
    main()
