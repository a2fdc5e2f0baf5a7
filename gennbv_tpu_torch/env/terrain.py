"""Procedural terrain scenes (port of ``gennbv_tpu/env/terrain.py``; the
counterpart of legged_gym/utils/terrain.py): sloped / stair / discrete-
obstacle / wave / pit heightfields with difficulty-curriculum rows.

Where the reference emits Isaac Gym heightfield/trimesh assets, this emits
a :class:`~gennbv_tpu_torch.env.scene.SceneSet`: terrain scenes are
reconstruction targets for ReconEnv (``scene.dataset="terrain"``).
Heightfields are voxelized by thresholding each render column against the
sampled height map.  Generation is host-side numpy with the same
``RandomState`` draws as the JAX package, so the arrays are bit-equal to
its SceneSet; each is then copied once to the requested device.

Curriculum semantics follow the reference (terrain.py curriculum rows:
difficulty = row / num_rows): ``difficulty`` in [0, 1] scales slope angle,
step height, obstacle density, etc.
"""
from __future__ import annotations

import numpy as np
import torch

from gennbv_tpu_torch.config import SceneConfig
from gennbv_tpu_torch.env import scene as scene_lib

TERRAIN_TYPES = ("slope", "stairs", "discrete", "wave", "pit")


def _height_field(kind: str, n: int, difficulty: float,
                  rng: np.random.RandomState, extent_xy: float) -> np.ndarray:
    """[n, n] heights in meters over the xy box."""
    xs = np.linspace(-1.0, 1.0, n)
    xx, yy = np.meshgrid(xs, xs, indexing="ij")
    if kind == "slope":
        slope = difficulty * 0.9  # max ~42deg
        theta = rng.uniform(0, 2 * np.pi)
        h = (xx * np.cos(theta) + yy * np.sin(theta)) * slope * extent_xy / 2
        return h - h.min()
    if kind == "stairs":
        step_h = 0.05 + 0.25 * difficulty
        n_steps = rng.randint(4, 9)
        idx = np.floor((xx + 1.0) / 2.0 * n_steps)
        return idx * step_h
    if kind == "discrete":
        h = np.zeros((n, n))
        num = int(8 + 24 * difficulty)
        max_h = 0.15 + 0.85 * difficulty
        for _ in range(num):
            bw = rng.randint(max(2, n // 20), max(3, n // 6))
            x0 = rng.randint(0, n - bw)
            y0 = rng.randint(0, n - bw)
            h[x0:x0 + bw, y0:y0 + bw] = rng.uniform(0.1, max_h)
        return h
    if kind == "wave":
        amp = 0.1 + 0.6 * difficulty
        fx = rng.uniform(1.0, 3.0)
        fy = rng.uniform(1.0, 3.0)
        return amp * (np.sin(np.pi * fx * xx) * np.cos(np.pi * fy * yy) + 1.0)
    if kind == "pit":
        depth = 0.3 + 1.2 * difficulty
        h = np.full((n, n), depth)
        half = rng.uniform(0.2, 0.5)
        h[(np.abs(xx) < half) & (np.abs(yy) < half)] = 0.0
        return h
    raise ValueError(f"unknown terrain kind {kind!r} (one of {TERRAIN_TYPES})")


def generate_terrain(cfg: SceneConfig, grid_res: int,
                     kinds=TERRAIN_TYPES, curriculum: bool = True,
                     max_gt_points: int = 8192,
                     device: torch.device | str = "cuda") -> scene_lib.SceneSet:
    """A SceneSet of terrain patches on `device` (the card unless the
    caller asks for the CPU).

    Scene i gets kind ``kinds[i % len(kinds)]`` and difficulty
    ``(i // len(kinds)) / max(1, rows - 1)`` when ``curriculum`` (the
    reference's row-major curriculum layout), else a random difficulty.
    """
    rng = np.random.RandomState(cfg.seed)
    s, g, r = cfg.num_scenes, cfg.grid_size, grid_res
    rows = max(1, s // len(kinds))

    render_occ = np.zeros((s, r ** 3), dtype=np.uint8)
    box_lo = np.zeros((s, 3), dtype=np.float32)
    box_hi = np.zeros((s, 3), dtype=np.float32)
    grid_gt = np.zeros((s, g, g, g), dtype=np.float32)
    voxel_size = np.zeros((s, 3), dtype=np.float32)
    range_gt = np.zeros((s, 6), dtype=np.float32)
    gt_points = np.zeros((s, max_gt_points, 3), dtype=np.float32)
    gt_points_mask = np.zeros((s, max_gt_points), dtype=bool)

    for i in range(s):
        kind = kinds[i % len(kinds)]
        if curriculum:
            difficulty = (i // len(kinds)) / max(1, rows - 1)
        else:
            difficulty = rng.rand()

        e_xy, e_z = cfg.extent_xy, cfg.extent_z
        v = np.array([e_xy / g, e_xy / g, e_z / g], dtype=np.float32)
        range_i = np.array(
            [(e_xy - v[0]) / 2, -(e_xy - v[0]) / 2,
             (e_xy - v[1]) / 2, -(e_xy - v[1]) / 2,
             e_z - v[2], 0.0], dtype=np.float32)
        lo = np.array([-e_xy / 2, -e_xy / 2, -v[2] / 2], dtype=np.float32)
        hi = np.array([e_xy / 2, e_xy / 2, e_z - v[2] / 2], dtype=np.float32)

        hf = _height_field(kind, r, difficulty, rng, e_xy)
        hf = np.clip(hf, 0.0, e_z * 0.8)
        # voxelize: column (x, y) occupied up to height hf[x, y]
        z_centers = lo[2] + (np.arange(r) + 0.5) * (hi[2] - lo[2]) / r
        occ = (z_centers[None, None, :] <= hf[:, :, None]).astype(np.uint8)
        # keep z=0 layer occupied so every column has a ground face
        occ[:, :, 0] = 1

        surface = scene_lib._surface_from_solid(occ)
        grid_gt[i] = scene_lib._downsample_surface(surface, r, g)
        gt_points[i], gt_points_mask[i] = scene_lib._surface_points(
            surface, lo, (hi - lo) / r, max_gt_points, rng)
        render_occ[i] = occ.reshape(-1)
        box_lo[i], box_hi[i] = lo, hi
        voxel_size[i] = v
        range_gt[i] = range_i

    return scene_lib._to_device(dict(
        render_occ=render_occ, box_lo=box_lo, box_hi=box_hi, grid_gt=grid_gt,
        voxel_size=voxel_size, range_gt=range_gt,
        num_valid_voxel=grid_gt.sum(axis=(1, 2, 3)), gt_points=gt_points,
        gt_points_mask=gt_points_mask), r, g, device)
