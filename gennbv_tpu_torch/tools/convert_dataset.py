"""Convert a directory of OBJ meshes (Houses3K / OmniObject3D style) into the
scene format, with the native C++ voxelizer (the port's copy of
``tools/convert_dataset.py``: the same CLI and the same ``scenes.npz``).

Output: <out_dir>/scenes.npz with
    render_occ [S, R^3] uint8, box_lo/box_hi [S, 3], grid_gt [S, G, G, G],
    voxel_size [S, 3], range_gt [S, 6], gt_points [S, M, 3], gt_points_mask,
    grid_res, grid_size.

Usage:
    python -m gennbv_tpu_torch.tools.convert_dataset --mesh_dir meshes/ \
        --out data/houses3k --res 64 --grid_size 20

Then train on it with ``--set env.scene.dataset=data/houses3k``.  The
voxelizer is built into ``gennbv_tpu_torch/_build/`` at first use.
"""
from __future__ import annotations

import argparse
import glob
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from gennbv_tpu_torch.env.scene import _downsample_surface, _surface_from_solid
from gennbv_tpu_torch.utils import native


def convert(mesh_dir: str, out_dir: str, res: int, grid_size: int,
            scale: float, max_gt_points: int = 8192,
            verbose: bool = True) -> str:
    """Voxelize every ``*.obj`` of mesh_dir (sorted by name) at res^3 and
    write <out_dir>/scenes.npz; returns its path.  The meshes are
    voxelized on a pool of threads (the native call releases the GIL);
    the rest runs in mesh order, so the arrays do not depend on the
    thread count."""
    meshes = sorted(glob.glob(os.path.join(mesh_dir, "*.obj")))
    if not meshes:
        raise SystemExit(f"no .obj meshes in {mesh_dir}")
    s = len(meshes)
    g = grid_size
    rng = np.random.RandomState(0)

    render_occ = np.zeros((s, res ** 3), np.uint8)
    box_lo = np.zeros((s, 3), np.float32)
    box_hi = np.zeros((s, 3), np.float32)
    grid_gt = np.zeros((s, g, g, g), np.float32)
    voxel_size = np.zeros((s, 3), np.float32)
    range_gt = np.zeros((s, 6), np.float32)
    gt_points = np.zeros((s, max_gt_points, 3), np.float32)
    gt_mask = np.zeros((s, max_gt_points), bool)

    with ThreadPoolExecutor() as pool:
        voxelized = list(pool.map(
            lambda path: native.voxelize_obj(path, res, scale=scale), meshes))
    for i, (path, (occ, lo, hi)) in enumerate(zip(meshes, voxelized)):
        # re-center to the reference frame: object centered in x/y, ground z=0
        cx = (lo[:2] + hi[:2]) / 2
        lo[:2] -= cx
        hi[:2] -= cx
        hi[2] -= lo[2]
        lo[2] = 0.0
        surface = _surface_from_solid(occ)
        grid_gt[i] = _downsample_surface(surface, res, g)
        vs = (hi - lo) / g
        voxel_size[i] = vs
        range_gt[i] = [
            (hi[0] - lo[0] - vs[0]) / 2, -(hi[0] - lo[0] - vs[0]) / 2,
            (hi[1] - lo[1] - vs[1]) / 2, -(hi[1] - lo[1] - vs[1]) / 2,
            hi[2] - lo[2] - vs[2], 0.0,
        ]
        render_occ[i] = occ.reshape(-1)
        box_lo[i], box_hi[i] = lo, hi

        idx = np.argwhere(surface)
        pts = (idx + 0.5) * ((hi - lo) / res)[None, :] + lo[None, :]
        if len(pts) > max_gt_points:
            pts = pts[rng.choice(len(pts), max_gt_points, replace=False)]
        gt_points[i, : len(pts)] = pts
        gt_mask[i, : len(pts)] = True
        if verbose:
            print(f"[{i + 1}/{s}] {os.path.basename(path)}: "
                  f"{int(occ.sum())} render voxels, "
                  f"{int(grid_gt[i].sum())} GT voxels")

    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "scenes.npz")
    np.savez_compressed(
        out_path, render_occ=render_occ, box_lo=box_lo, box_hi=box_hi,
        grid_gt=grid_gt, voxel_size=voxel_size, range_gt=range_gt,
        gt_points=gt_points, gt_points_mask=gt_mask,
        grid_res=res, grid_size=g,
    )
    if verbose:
        print(f"wrote {out_path}")
    return out_path


def write_procedural_meshes(mesh_dir: str, num_scenes: int, seed: int,
                            res: int = 64) -> list:
    """Mesh the render grids of ``num_scenes`` procedural houses of `seed`
    into ``<mesh_dir>/house_<i>.obj`` with the native mesher: an OBJ
    dataset made inside the repo, for when no published meshes are at
    hand (as ``tools/rehearse_ingestion.py`` makes its own).  Returns the
    paths."""
    from gennbv_tpu_torch.config import SceneConfig
    from gennbv_tpu_torch.env.scene import generate_procedural

    scenes = generate_procedural(SceneConfig(num_scenes=num_scenes, seed=seed),
                                 res, device="cpu")
    os.makedirs(mesh_dir, exist_ok=True)
    paths = []
    for i in range(num_scenes):
        lo = scenes.box_lo[i].numpy()
        hi = scenes.box_hi[i].numpy()
        path = os.path.join(mesh_dir, f"house_{i:03d}.obj")
        native.mesh_voxels_to_obj(
            scenes.render_occ[i].numpy().reshape(res, res, res), lo,
            (hi - lo) / res, path)
        paths.append(path)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mesh_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--grid_size", type=int, default=20)
    p.add_argument("--scale", type=float, default=1.0)
    args = p.parse_args(argv)
    convert(args.mesh_dir, args.out, args.res, args.grid_size, args.scale)


if __name__ == "__main__":
    main()
