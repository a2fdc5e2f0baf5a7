"""External depth sources for ``renderer.mode = "replay" | "callback"``
(port of ``gennbv_tpu/env/depth_sources.py``): the stand-ins for the
reference's Isaac Gym depth camera.

- :class:`ReplayDepthSource`: a recorded (pose -> depth frame) bank per
  scene with nearest-pose lookup, on the bank's device.  The fixture for
  tests, and the path for training on frames captured from any external
  renderer.
- :class:`CallbackDepthSource`: a host function that receives
  (scene_ids [N], poses [N, 6]) as numpy arrays and returns depth
  [N, H*W]; the port calls it directly, where the JAX package goes
  through ``jax.pure_callback``.

Both feed ReconEnv's back-projection and mapping, as the DDA renderer
does.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from gennbv_tpu_torch.ops import camera as camera_lib
from gennbv_tpu_torch.ops import render as render_lib


class ReplayBank(NamedTuple):
    poses: torch.Tensor   # [S, M, 6] recorded camera poses per scene
    frames: torch.Tensor  # [S, M, H*W] float32 depth frames
    fg: torch.Tensor      # [S, M, H*W] bool foreground masks


# pose-distance weights: position in meters, pitch/yaw in radians scaled to
# comparable magnitude (a 15-degree step ~ one 0.2 m position step)
_POSE_W = (1.0, 1.0, 1.0, 0.0, 0.76, 0.76)


class ReplayDepthSource:
    def __init__(self, bank: ReplayBank):
        self.bank = bank
        self._w = torch.tensor(_POSE_W, dtype=torch.float32,
                               device=bank.poses.device)

    def render_batch(self, scene_id: torch.Tensor, poses: torch.Tensor):
        """(depth [N, H*W], fg [N, H*W]) of the nearest recorded pose of
        each env's scene (the first of equals)."""
        ref = self.bank.poses[scene_id]                      # [N, M, 6]
        d2 = (((poses[:, None, :] - ref) * self._w) ** 2).sum(-1)
        nearest = d2.argmin(-1)
        return (self.bank.frames[scene_id, nearest],
                self.bank.fg[scene_id, nearest])


class CallbackDepthSource:
    """Host-function bridge to an external renderer or simulator.

    ``fn(scene_ids np[N], poses np[N, 6]) -> np.float32 [N, H*W]`` runs on
    the host every env step; its frames go back to the env's device, and
    foreground is ``depth < depth_max * (1 - 1e-4)``.
    """

    def __init__(self, fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
                 height: int, width: int, depth_max: float):
        self.fn = fn
        self.height = height
        self.width = width
        self.depth_max = depth_max

    def render_batch(self, scene_id: torch.Tensor, poses: torch.Tensor):
        n = poses.shape[0]
        frames = np.asarray(self.fn(scene_id.cpu().numpy(),
                                    poses.cpu().numpy()), np.float32)
        if frames.size != n * self.height * self.width:
            raise ValueError(
                f"depth callback returned {frames.shape}; expected "
                f"[{n}, {self.height * self.width}]")
        depth = torch.from_numpy(frames.reshape(n, -1)).to(poses.device)
        return depth, depth < self.depth_max * (1.0 - 1e-4)


def record_replay_bank(scenes, camera_cfg, pose_sets: np.ndarray,
                       grid_res: int | None = None) -> ReplayBank:
    """Render a replay bank with the built-in DDA renderer, on the scenes'
    device.  pose_sets: [S, M, 6] poses to record per scene (or [M, 6]
    shared by every scene), a numpy array or a tensor."""
    dev = scenes.render_occ.device
    poses = torch.as_tensor(pose_sets, dtype=torch.float32).to(dev)
    if poses.dim() == 2:
        poses = poses[None].expand(scenes.num_scenes, -1, -1)
    m = poses.shape[1]
    r = grid_res or scenes.grid_res
    rays = torch.as_tensor(camera_lib.camera_rays(
        camera_cfg.height, camera_cfg.width, camera_cfg.horizontal_fov_deg),
        dtype=torch.float32, device=dev)
    frames, fgs = [], []
    for j in range(m):
        r_c2w, t_c2w = camera_lib.pose_to_c2w(poses[:, j], camera_cfg.z_offset)
        d, f = render_lib.render_depth(
            scenes.render_occ, scenes.box_lo, scenes.box_hi, rays, r_c2w,
            t_c2w, r, 3 * r, camera_cfg.depth_max)
        frames.append(d)
        fgs.append(f)
    return ReplayBank(poses=poses, frames=torch.stack(frames, 1),
                      fg=torch.stack(fgs, 1))
