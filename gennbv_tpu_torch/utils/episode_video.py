"""Episode video recorder, the vec_video_recorder analogue
(stable_baselines3/common/vec_env/vec_video_recorder.py): a copy of
``gennbv_tpu/utils/episode_video.py``, which the port cannot import
(importing it runs the JAX package's ``__init__``).

The reference records RGB frames from Isaac Gym's viewer; here episodes are
recorded as animated GIFs built from the depth camera (what the agent
actually senses) with an optional top-down coverage-map panel, renderable
headless from any rollout.  PIL is imported only when a GIF is written.

    rec = EpisodeVideoRecorder(depth_max=50.0)
    rec.add(depth_frame_hw, coverage_grid_ggg)   # per step
    rec.write("episode.gif", fps=4)
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def _colorize_depth(depth: np.ndarray, depth_max: float) -> np.ndarray:
    """[H, W] depth -> [H, W, 3] uint8 (near = bright, far/sky = dark)."""
    x = 1.0 - np.clip(depth / depth_max, 0.0, 1.0)
    r = (x * 255).astype(np.uint8)
    g = (np.sqrt(x) * 220).astype(np.uint8)
    b = ((x ** 2) * 255).astype(np.uint8)
    return np.stack([r, g, b], axis=-1)


def _coverage_panel(grid: np.ndarray, size: int) -> np.ndarray:
    """[G, G, G] scanned grid -> [size, size, 3] top-down max-projection."""
    top = grid.max(axis=2)  # [G, G]
    g = top.shape[0]
    rep = max(1, size // g)
    img = np.kron(top, np.ones((rep, rep)))[:size, :size]
    pad_y, pad_x = size - img.shape[0], size - img.shape[1]
    img = np.pad(img, ((0, pad_y), (0, pad_x)))
    rgb = np.zeros(img.shape + (3,), np.uint8)
    rgb[..., 1] = (img * 255).astype(np.uint8)   # scanned = green
    rgb[..., 2] = 40                              # unscanned = dark blue
    return rgb


class EpisodeVideoRecorder:
    def __init__(self, depth_max: float, scale: int = 4):
        self.depth_max = depth_max
        self.scale = scale
        self._frames: List[np.ndarray] = []

    def add(self, depth_hw: np.ndarray,
            coverage_grid: Optional[np.ndarray] = None) -> None:
        depth_hw = np.asarray(depth_hw)
        panel = _colorize_depth(depth_hw, self.depth_max)
        if self.scale > 1:
            panel = np.kron(panel, np.ones((self.scale, self.scale, 1))
                            ).astype(np.uint8)
        if coverage_grid is not None:
            cov = _coverage_panel(np.asarray(coverage_grid), panel.shape[0])
            panel = np.concatenate([panel, cov], axis=1)
        self._frames.append(panel)

    def write(self, path: str, fps: int = 4) -> str:
        if not self._frames:
            raise ValueError("no frames recorded")
        from PIL import Image
        imgs = [Image.fromarray(f) for f in self._frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)
        return path

    def __len__(self) -> int:
        return len(self._frames)
