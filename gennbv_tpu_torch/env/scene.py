"""Scene sets: per-scene occupancy grids + ground-truth surface grids.

PyTorch port of ``gennbv_tpu/env/scene.py``.  The numpy procedural house
generator is copied unchanged, so for the same ``SceneConfig`` the port's
scenes are bit-identical to the JAX package's; only the finished arrays
become torch tensors, on the device the caller names.

A scene is:
- ``render_occ``  [S, R^3]: dense solid occupancy at render resolution R
  (collision tests);
- ``grid_gt``     [S, G, G, G]: GT *surface* occupancy at mapping resolution
  G=20 (occupied voxels adjacent to free space, below-ground counted as
  occupied);
- reference-layout metadata: ``voxel_size`` [S,3], ``range_gt`` [S,6]
  (x_max, x_min, y_max, y_min, z_max, z_min);
- ``surf_pts``/``surf_mask`` [S, Q, 3]/[S, Q]: the complete surface
  voxel-center set at render resolution, padded to a common count Q (a
  multiple of 1024), which the splat renderer projects.

The procedural families are ported: ``procedural`` (houses), ``objects``
(the zero-shot object family), ``convex`` (single convex primitives, the
chamfer-floor probe) and ``terrain`` (``env/terrain.py``).  So are dataset
directories: ``<dir>/scenes.npz`` as ``tools/convert_dataset.py`` writes
it (``load_npz``), else a reference-layout ``<dir>/gt_grid.npy``
(``load_reference_gt``).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from gennbv_tpu_torch.config import SceneConfig
from gennbv_tpu_torch.ops import fp32


# the scene families generate_procedural builds
PROCEDURAL_FAMILIES = ("procedural", "objects", "convex")


class SceneSet(NamedTuple):
    """Scene data on one device (leading axis = scene)."""
    render_occ: torch.Tensor    # [S, R^3] uint8
    box_lo: torch.Tensor        # [S, 3] render-box min corner
    box_hi: torch.Tensor        # [S, 3]
    grid_gt: torch.Tensor       # [S, G, G, G] float32 surface occupancy
    voxel_size: torch.Tensor    # [S, 3]
    range_gt: torch.Tensor      # [S, 6]
    num_valid_voxel: torch.Tensor  # [S] float32
    gt_points: torch.Tensor     # [S, M, 3] float32 GT surface point cloud
    gt_points_mask: torch.Tensor  # [S, M] bool
    surf_pts: torch.Tensor      # [S, Q, 3] float32
    surf_mask: torch.Tensor     # [S, Q] bool
    grid_res: int               # R
    grid_size: int              # G

    @property
    def num_scenes(self) -> int:
        return self.render_occ.shape[0]


def _surface_from_solid(occ: np.ndarray) -> np.ndarray:
    """Occupied voxels with at least one free 6-neighbour.  Out-of-grid
    neighbours count as free except below z=0 (ground-contact faces are
    unobservable and excluded from the GT surface)."""
    padded = np.pad(occ, 1, mode="constant", constant_values=0)
    padded[:, :, 0] = 1  # below ground = occupied
    free = padded == 0
    nb_free = (
        free[:-2, 1:-1, 1:-1] | free[2:, 1:-1, 1:-1]
        | free[1:-1, :-2, 1:-1] | free[1:-1, 2:, 1:-1]
        | free[1:-1, 1:-1, :-2] | free[1:-1, 1:-1, 2:]
    )
    return (occ > 0) & nb_free


def _downsample_surface(surface: np.ndarray, grid_res: int, grid_size: int) -> np.ndarray:
    """GT cell = 1 iff any surface render-voxel center falls inside it.

    Render and GT grids share the same world box, so the mapping is pure
    index arithmetic: render voxel i center -> GT index floor((i+0.5)*G/R).
    """
    idx = np.argwhere(surface)
    if len(idx) == 0:
        return np.zeros((grid_size,) * 3, dtype=np.float32)
    gt_idx = np.floor((idx + 0.5) * grid_size / grid_res).astype(np.int64)
    gt_idx = np.clip(gt_idx, 0, grid_size - 1)
    gt = np.zeros((grid_size,) * 3, dtype=np.float32)
    gt[gt_idx[:, 0], gt_idx[:, 1], gt_idx[:, 2]] = 1.0
    return gt


def _box_slices(lo: np.ndarray, hi: np.ndarray, box_lo: np.ndarray,
                vsize: np.ndarray, res: int):
    a = np.clip(np.floor((lo - box_lo) / vsize).astype(int), 0, res)
    b = np.clip(np.ceil((hi - box_lo) / vsize).astype(int), 0, res)
    return tuple(slice(a[i], b[i]) for i in range(3))


def _rasterize_oriented(occ: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                        yaw: float, center_xy: np.ndarray, add: bool,
                        box_lo: np.ndarray, vsize: np.ndarray) -> None:
    """Rasterize an axis box rotated by `yaw` about `center_xy` into `occ`:
    a voxel is inside iff its center, rotated back by -yaw, lies in
    [lo, hi].  Vectorized over the whole grid (res^3 point-in-box tests)."""
    res = occ.shape[0]
    ax = np.arange(res)
    cx = box_lo[0] + (ax + 0.5) * vsize[0]
    cy = box_lo[1] + (ax + 0.5) * vsize[1]
    cz = box_lo[2] + (ax + 0.5) * vsize[2]
    xx, yy = np.meshgrid(cx, cy, indexing="ij")
    c, s = np.cos(-yaw), np.sin(-yaw)
    rx = center_xy[0] + c * (xx - center_xy[0]) - s * (yy - center_xy[1])
    ry = center_xy[1] + s * (xx - center_xy[0]) + c * (yy - center_xy[1])
    in_xy = (rx >= lo[0]) & (rx <= hi[0]) & (ry >= lo[1]) & (ry <= hi[1])
    in_z = (cz >= lo[2]) & (cz <= hi[2])
    mask = in_xy[:, :, None] & in_z[None, None, :]
    occ[mask] = 1 if add else 0


def _gen_house(rng: np.random.RandomState, res: int, box_lo: np.ndarray,
               box_hi: np.ndarray) -> np.ndarray:
    """One procedural 'house': footprint plan (rect/L/T/U) + roof +
    extensions - openings, the whole structure rotated by a random yaw
    (oriented-box rasterization) so the training distribution is not
    axis-aligned.  Optionally a smaller detached outbuilding (multi-body
    scenes, like Houses3K's compound houses).

    Stands on the ground plane (z=0) inside the central region of the box,
    mimicking the building-scale Houses3K objects the reference trains on.
    """
    occ = np.zeros((res, res, res), dtype=np.uint8)
    vsize = (box_hi - box_lo) / res
    global_yaw = rng.uniform(0.0, 2.0 * np.pi)

    w = rng.uniform(2.5, 5.5)
    d = rng.uniform(2.5, 5.5)
    h = rng.uniform(1.8, 3.5)
    cx = rng.uniform(-1.0, 1.0)
    cy = rng.uniform(-1.0, 1.0)
    yaw_boxes = []  # list of (lo, hi, add)

    yaw_boxes.append((np.array([cx - w / 2, cy - d / 2, 0.0]),
                      np.array([cx + w / 2, cy + d / 2, h]), True))

    # footprint plan: keep a plain rectangle half the time; otherwise graft
    # perpendicular wings onto the base to make an L / T / U plan (concave
    # footprints need views from inside the notch, not just an orbit)
    plan = rng.choice(["rect", "L", "T", "U"], p=[0.5, 0.2, 0.15, 0.15])
    wing_h = h * rng.uniform(0.6, 1.0)
    ww = rng.uniform(0.8, 0.45 * w)      # wing width (along x; 0.45*w > 0.8
                                         # for the whole w range, so lo < hi)
    wd = rng.uniform(1.5, 3.0)           # wing protrusion (along y)
    wy = rng.choice([-1.0, 1.0])         # which side the wings stick out
    if plan in ("L", "U"):
        yaw_boxes.append((np.array([cx - w / 2, cy + wy * d / 2 - (wd if wy < 0 else 0), 0.0]),
                          np.array([cx - w / 2 + ww, cy + wy * d / 2 + (wd if wy > 0 else 0), wing_h]), True))
    if plan in ("T",):
        tx = cx + rng.uniform(-0.2, 0.2) * w
        yaw_boxes.append((np.array([tx - ww / 2, cy + wy * d / 2 - (wd if wy < 0 else 0), 0.0]),
                          np.array([tx + ww / 2, cy + wy * d / 2 + (wd if wy > 0 else 0), wing_h]), True))
    if plan == "U":
        yaw_boxes.append((np.array([cx + w / 2 - ww, cy + wy * d / 2 - (wd if wy < 0 else 0), 0.0]),
                          np.array([cx + w / 2, cy + wy * d / 2 + (wd if wy > 0 else 0), wing_h]), True))

    # roof: stepped pyramid or flat parapet
    style = rng.randint(3)
    if style == 0:  # stepped pyramid
        n_steps = rng.randint(3, 6)
        rh = rng.uniform(0.8, 2.0)
        for i in range(n_steps):
            f = 1.0 - (i + 1) / (n_steps + 1)
            yaw_boxes.append((
                np.array([cx - f * w / 2, cy - f * d / 2, h + i * rh / n_steps]),
                np.array([cx + f * w / 2, cy + f * d / 2, h + (i + 1) * rh / n_steps]),
                True,
            ))
    elif style == 1:  # gable approximation along x
        n_steps = 4
        rh = rng.uniform(0.8, 1.6)
        for i in range(n_steps):
            f = 1.0 - (i + 1) / (n_steps + 1)
            yaw_boxes.append((
                np.array([cx - w / 2, cy - f * d / 2, h + i * rh / n_steps]),
                np.array([cx + w / 2, cy + f * d / 2, h + (i + 1) * rh / n_steps]),
                True,
            ))

    # extensions (porch / wing)
    for _ in range(rng.randint(0, 3)):
        ew = rng.uniform(1.0, 2.5)
        ed = rng.uniform(1.0, 2.5)
        eh = rng.uniform(0.8, min(2.5, h))
        side = rng.randint(4)
        off = [(w / 2, 0), (-w / 2 - ew, 0), (0, d / 2), (0, -d / 2 - ed)][side]
        ex = cx + off[0] if side < 2 else cx + rng.uniform(-w / 3, w / 3)
        ey = cy + off[1] if side >= 2 else cy + rng.uniform(-d / 3, d / 3)
        if side < 2:
            yaw_boxes.append((np.array([ex, ey - ed / 2, 0.0]),
                              np.array([ex + ew, ey + ed / 2, eh]), True))
        else:
            yaw_boxes.append((np.array([ex - ew / 2, ey, 0.0]),
                              np.array([ex + ew / 2, ey + ed, eh]), True))

    # chimney
    if rng.rand() < 0.5:
        ch = rng.uniform(0.4, 1.0)
        cxx = cx + rng.uniform(-w / 3, w / 3)
        cyy = cy + rng.uniform(-d / 3, d / 3)
        yaw_boxes.append((np.array([cxx - 0.3, cyy - 0.3, h]),
                          np.array([cxx + 0.3, cyy + 0.3, h + 1.2 + ch]), True))

    # openings (doors / passages) - concavities that force low viewpoints
    for _ in range(rng.randint(0, 3)):
        ow = rng.uniform(0.6, 1.5)
        oh = rng.uniform(0.8, 1.6)
        axis = rng.randint(2)
        pos = rng.uniform(-0.3, 0.3)
        if axis == 0:
            yaw_boxes.append((np.array([cx - w, cy + pos * d - ow / 2, 0.0]),
                              np.array([cx + w, cy + pos * d + ow / 2, oh]), False))
        else:
            yaw_boxes.append((np.array([cx + pos * w - ow / 2, cy - d, 0.0]),
                              np.array([cx + pos * w + ow / 2, cy + d, oh]), False))

    # detached outbuilding (shed / garage): a second body occludes the main
    # one and forces the policy to split its view budget between structures
    if rng.rand() < 0.35:
        ow2 = rng.uniform(1.0, 2.2)
        od2 = rng.uniform(1.0, 2.2)
        oh2 = rng.uniform(0.8, 2.0)
        ang = rng.uniform(0.0, 2.0 * np.pi)
        dist = max(w, d) / 2 + max(ow2, od2) / 2 + rng.uniform(0.8, 2.0)
        ox = cx + dist * np.cos(ang)
        oy = cy + dist * np.sin(ang)
        yaw_boxes.append((np.array([ox - ow2 / 2, oy - od2 / 2, 0.0]),
                          np.array([ox + ow2 / 2, oy + od2 / 2, oh2]), True))

    center = np.array([cx, cy], dtype=np.float64)
    for lo, hi, add in yaw_boxes:
        _rasterize_oriented(occ, lo, hi, global_yaw, center, add,
                            box_lo, vsize)
    return occ


def _gen_object(rng: np.random.RandomState, res: int, box_lo: np.ndarray,
                box_hi: np.ndarray, convex: bool = False) -> np.ndarray:
    """One procedural 'object': 1-3 smooth primitives (ellipsoid, cylinder,
    cone, torus, rounded box) stacked/unioned, standing on the ground plane —
    a distribution-shifted scene family in the spirit of the reference's
    OmniObject3D zero-shot benchmark (everyday objects vs the Houses3K
    training houses, README.md:45).  Shares the coordinate/GT conventions of
    the house generator so a policy trained on houses evaluates unchanged.

    convex=True restricts to ONE convex primitive (no torus, no stacking):
    a cavity-free, exterior-visible family where every GT surface point is
    imageable from some reachable camera pose, so the chamfer metric's
    gt->scan unseen tail can actually vanish — the floor-reaching probe for
    the accuracy metric (r3 verdict weak #6: on houses a ~43% never-imaged
    interior tail keeps the headline number away from the sampling floor
    regardless of scan quality).
    """
    vsize = (box_hi - box_lo) / res
    ax = np.arange(res)
    cx = box_lo[0] + (ax + 0.5) * vsize[0]
    cy = box_lo[1] + (ax + 0.5) * vsize[1]
    cz = box_lo[2] + (ax + 0.5) * vsize[2]
    xx, yy, zz = np.meshgrid(cx, cy, cz, indexing="ij")
    occ = np.zeros((res, res, res), dtype=np.uint8)

    n_parts = 1 if convex else rng.randint(1, 4)
    base_z = 0.0
    ox, oy = rng.uniform(-1.0, 1.0, 2)
    kinds = ["ellipsoid", "cylinder", "cone", "box"] if convex else \
        ["ellipsoid", "cylinder", "cone", "torus", "box"]
    for _ in range(n_parts):
        kind = rng.choice(kinds)
        rx = rng.uniform(1.0, 2.8)
        ry = rx * rng.uniform(0.6, 1.4)
        h = rng.uniform(1.0, 2.8)
        px = ox + rng.uniform(-0.6, 0.6)
        py = oy + rng.uniform(-0.6, 0.6)
        dx, dy, dz = xx - px, yy - py, zz - (base_z + h / 2)
        if kind == "ellipsoid":
            m = (dx / rx) ** 2 + (dy / ry) ** 2 + (dz / (h / 2)) ** 2 <= 1.0
        elif kind == "cylinder":
            m = ((dx / rx) ** 2 + (dy / ry) ** 2 <= 1.0) & (np.abs(dz) <= h / 2)
        elif kind == "cone":
            frac = np.clip((h / 2 - dz) / h, 0.0, 1.0)  # 1 at base, 0 at tip
            m = ((dx ** 2 + dy ** 2) <= (rx * frac) ** 2) & (np.abs(dz) <= h / 2)
        elif kind == "torus":
            ring_r = max(rx, 0.8)
            tube_r = rng.uniform(0.3, 0.45) * ring_r
            q = np.sqrt(dx ** 2 + dy ** 2) - ring_r
            m = q ** 2 + dz ** 2 <= tube_r ** 2
        else:  # box with a random yaw
            yaw = rng.uniform(0, np.pi)
            c, s = np.cos(yaw), np.sin(yaw)
            rxx = c * dx - s * dy
            ryy = s * dx + c * dy
            m = (np.abs(rxx) <= rx) & (np.abs(ryy) <= ry) & (np.abs(dz) <= h / 2)
        occ[m] = 1
        base_z += h * rng.uniform(0.5, 0.9)   # stack with overlap
    # clamp below-ground (torus/ellipsoid centers can dip under z=0)
    occ[:, :, cz < 0.0] = 0
    return occ


def _harden_house(occ: np.ndarray, rng: np.random.RandomState,
                  box_lo: np.ndarray, box_hi: np.ndarray) -> np.ndarray:
    """Add concave structure that a top-down or orbit view cannot see:
    an interior courtyard (open-top shaft whose walls are only visible from
    above the opening), a covered tunnel through the base, and a deep
    overhang (surface beneath a cantilevered slab).  Raises the gap between
    random-policy and planned-view coverage (the easy generator's floor was
    ~93%; the reference benchmark's random floor is 58%, SURVEY §6)."""
    res = occ.shape[0]
    vsize = (box_hi - box_lo) / res
    solid_cols = occ.any(axis=2)
    xs, ys = np.nonzero(solid_cols)
    if len(xs) == 0:
        return occ

    def slices(lo, hi):
        return _box_slices(np.asarray(lo), np.asarray(hi), box_lo, vsize, res)

    cx_i, cy_i = int(xs.mean()), int(ys.mean())
    c = box_lo[:2] + (np.array([cx_i, cy_i]) + 0.5) * vsize[:2]

    # interior courtyard: hollow a shaft, keep a rim roof around its mouth
    top_z = occ[cx_i, cy_i].nonzero()[0]
    if len(top_z) > 0:
        top = (top_z.max() + 1) * vsize[2] + box_lo[2]
        side = rng.uniform(0.8, 1.6)
        occ[slices([c[0] - side, c[1] - side, 0.0],
                    [c[0] + side, c[1] + side, top - 0.4])] = 0

    # tunnel through the base along a random axis
    th = rng.uniform(0.6, 1.2)
    off = rng.uniform(-0.8, 0.8)
    if rng.rand() < 0.5:
        occ[slices([box_lo[0], c[1] + off - th / 2, 0.0],
                    [box_hi[0], c[1] + off + th / 2, th])] = 0
    else:
        occ[slices([c[0] + off - th / 2, box_lo[1], 0.0],
                    [c[0] + off + th / 2, box_hi[1], th])] = 0

    # cantilevered slab: roof plate larger than its support
    sh = rng.uniform(1.5, 2.5)
    ext = rng.uniform(1.0, 2.0)
    occ[slices([c[0] - ext - 1.0, c[1] - ext - 1.0, sh],
                [c[0] + ext + 1.0, c[1] + ext + 1.0, sh + 0.3])] = 1
    return occ


def _pack_surface_points(render_occ: np.ndarray, box_lo: np.ndarray,
                         box_hi: np.ndarray, grid_res: int):
    """Complete per-scene surface point sets, padded to a common count.

    render_occ: [S, R^3]; returns (surf_pts [S, P, 3], surf_mask [S, P]) with
    P = max surface count rounded up to a multiple of 1024.  Unlike the GT
    point cloud (which may subsample), this set is exhaustive — the splat
    renderer's hits derive from it, so dropping points would make surface
    regions unobservable and cap the coverage reward.
    """
    s = render_occ.shape[0]
    r = grid_res
    all_idx = []
    for i in range(s):
        occ = render_occ[i].reshape(r, r, r)
        all_idx.append(np.argwhere(_surface_from_solid(occ)))
    p = max(1024, -(-max(len(a) for a in all_idx) // 1024) * 1024)
    surf_pts = np.zeros((s, p, 3), np.float32)
    surf_mask = np.zeros((s, p), bool)
    for i, idx in enumerate(all_idx):
        vsize = (box_hi[i] - box_lo[i]) / r
        pts = (idx + 0.5) * vsize[None, :] + box_lo[i][None, :]
        surf_pts[i, : len(pts)] = pts
        surf_mask[i, : len(pts)] = True
    return surf_pts, surf_mask


def _surface_points(surface: np.ndarray, box_lo: np.ndarray, vsize: np.ndarray,
                    max_points: int, rng: np.random.RandomState):
    """Surface render-voxel centers as a padded GT point cloud."""
    idx = np.argwhere(surface)
    pts = (idx + 0.5) * vsize[None, :] + box_lo[None, :]
    if len(pts) > max_points:
        pts = pts[rng.choice(len(pts), max_points, replace=False)]
    mask = np.zeros(max_points, dtype=bool)
    mask[: len(pts)] = True
    out = np.zeros((max_points, 3), dtype=np.float32)
    out[: len(pts)] = pts
    return out, mask


def generate_procedural(cfg: SceneConfig, grid_res: int,
                        max_gt_points: int = 8192,
                        device: torch.device | str = "cuda") -> SceneSet:
    """Build a SceneSet of procedural scenes of the family cfg.dataset
    names: houses ("procedural"), "objects" or "convex" (host-side numpy,
    then one copy of each array to `device`, the card unless the caller
    asks for the CPU)."""
    if cfg.difficulty not in ("standard", "hard"):
        raise ValueError(
            f"unknown scene difficulty {cfg.difficulty!r}; one of standard|hard")
    rng = np.random.RandomState(cfg.seed)
    s, g, r = cfg.num_scenes, cfg.grid_size, grid_res

    render_occ = np.zeros((s, r ** 3), dtype=np.uint8)
    box_lo = np.zeros((s, 3), dtype=np.float32)
    box_hi = np.zeros((s, 3), dtype=np.float32)
    grid_gt = np.zeros((s, g, g, g), dtype=np.float32)
    voxel_size = np.zeros((s, 3), dtype=np.float32)
    range_gt = np.zeros((s, 6), dtype=np.float32)
    gt_points = np.zeros((s, max_gt_points, 3), dtype=np.float32)
    gt_points_mask = np.zeros((s, max_gt_points), dtype=bool)

    for i in range(s):
        e_xy = cfg.extent_xy * rng.uniform(0.85, 1.15)
        e_z = cfg.extent_z * rng.uniform(0.85, 1.15)
        v = np.array([e_xy / g, e_xy / g, e_z / g], dtype=np.float32)
        # reference layout: x/y centers symmetric about 0, first z center at 0
        range_i = np.array(
            [(e_xy - v[0]) / 2, -(e_xy - v[0]) / 2,
             (e_xy - v[1]) / 2, -(e_xy - v[1]) / 2,
             e_z - v[2], 0.0],
            dtype=np.float32,
        )
        lo = np.array([-e_xy / 2, -e_xy / 2, -v[2] / 2], dtype=np.float32)
        hi = np.array([e_xy / 2, e_xy / 2, e_z - v[2] / 2], dtype=np.float32)

        if cfg.dataset == "objects":
            occ = _gen_object(rng, r, lo, hi)
        elif cfg.dataset == "convex":
            occ = _gen_object(rng, r, lo, hi, convex=True)
        else:
            occ = _gen_house(rng, r, lo, hi)
            if cfg.difficulty == "hard":
                occ = _harden_house(occ, rng, lo, hi)
        surface = _surface_from_solid(occ)
        grid_gt[i] = _downsample_surface(surface, r, g)
        gt_points[i], gt_points_mask[i] = _surface_points(
            surface, lo, (hi - lo) / r, max_gt_points, rng
        )

        render_occ[i] = occ.reshape(-1)
        box_lo[i], box_hi[i] = lo, hi
        voxel_size[i] = v
        range_gt[i] = range_i

    surf_pts, surf_mask = _pack_surface_points(render_occ, box_lo, box_hi, r)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    return SceneSet(
        render_occ=dev(render_occ),
        box_lo=dev(box_lo),
        box_hi=dev(box_hi),
        grid_gt=dev(grid_gt),
        voxel_size=dev(voxel_size),
        range_gt=dev(range_gt),
        num_valid_voxel=dev(grid_gt.sum(axis=(1, 2, 3))),
        gt_points=dev(gt_points),
        gt_points_mask=dev(gt_points_mask),
        surf_pts=dev(surf_pts),
        surf_mask=dev(surf_mask),
        grid_res=r,
        grid_size=g,
    )


def _to_device(arrays: dict, grid_res: int, grid_size: int,
               device) -> SceneSet:
    """A SceneSet of numpy arrays (every field but the surface set), with
    the surface set packed from render_occ, each copied to `device`."""
    surf_pts, surf_mask = _pack_surface_points(
        arrays["render_occ"], arrays["box_lo"], arrays["box_hi"], grid_res)
    arrays = dict(arrays, surf_pts=surf_pts, surf_mask=surf_mask)
    return SceneSet(grid_res=grid_res, grid_size=grid_size, **{
        k: torch.from_numpy(np.ascontiguousarray(arrays[k])).to(device)
        for k in SceneSet._fields[:-2]})


def load_reference_gt(gt_grid: np.ndarray, grid_res: int,
                      device: torch.device | str = "cuda") -> SceneSet:
    """A SceneSet from a reference-format GT tensor ``[S, X, Y, Z, 4]``
    (channels 0-2 voxel-center coordinates, 3 occupancy), as
    _init_load_all builds it (env_train_gennbv.py:56-96).  The render grid
    is the GT occupancy upsampled to R (nearest), for training and eval
    where the meshes are not at hand; the GT point cloud is the occupied
    cells' centers, subsampled to 8,192 with ``RandomState(0)``."""
    s, g = gt_grid.shape[0], gt_grid.shape[1]
    occ_g = gt_grid[..., 3].astype(np.float32)
    voxel_size = np.stack(
        [gt_grid[:, 1, 0, 0, 0] - gt_grid[:, 0, 0, 0, 0],
         gt_grid[:, 0, 1, 0, 1] - gt_grid[:, 0, 0, 0, 1],
         gt_grid[:, 0, 0, 1, 2] - gt_grid[:, 0, 0, 0, 2]],
        axis=-1,
    ).astype(np.float32)
    x_range = gt_grid[:, -1, 0, 0, 0] - gt_grid[:, 0, 0, 0, 0]
    y_range = gt_grid[:, 0, -1, 0, 1] - gt_grid[:, 0, 0, 0, 1]
    z_range = gt_grid[:, 0, 0, -1, 2] - gt_grid[:, 0, 0, 0, 2]
    range_gt = np.stack(
        [x_range / 2, -x_range / 2, y_range / 2, -y_range / 2,
         z_range, np.zeros_like(z_range)],
        axis=-1,
    ).astype(np.float32)
    box_lo = np.stack([-x_range / 2, -y_range / 2, np.zeros_like(z_range)],
                      -1) - 0.5 * voxel_size
    box_hi = np.stack([x_range / 2, y_range / 2, z_range], -1) \
        + 0.5 * voxel_size

    r = grid_res
    if r % g == 0:
        scale = r // g
        render = np.repeat(np.repeat(np.repeat(
            occ_g.astype(np.uint8), scale, 1), scale, 2), scale, 3)
    else:
        idx = np.floor((np.arange(r) + 0.5) * g / r).astype(int)
        render = occ_g.astype(np.uint8)[:, idx][:, :, idx][:, :, :, idx]

    # GT point cloud: GT-voxel centers of occupied cells
    max_q = 8192
    gt_points = np.zeros((s, max_q, 3), dtype=np.float32)
    gt_points_mask = np.zeros((s, max_q), dtype=bool)
    rng = np.random.RandomState(0)
    for i in range(s):
        idx = np.argwhere(occ_g[i] > 0)
        mins = np.array([range_gt[i, 1], range_gt[i, 3], range_gt[i, 5]])
        pts = mins[None, :] + idx * voxel_size[i][None, :]
        if len(pts) > max_q:
            pts = pts[rng.choice(len(pts), max_q, replace=False)]
        gt_points[i, : len(pts)] = pts
        gt_points_mask[i, : len(pts)] = True

    return _to_device(dict(
        render_occ=render.reshape(s, -1),
        box_lo=box_lo.astype(np.float32),
        box_hi=box_hi.astype(np.float32),
        grid_gt=occ_g,
        voxel_size=voxel_size,
        range_gt=range_gt,
        num_valid_voxel=occ_g.sum(axis=(1, 2, 3)),
        gt_points=gt_points,
        gt_points_mask=gt_points_mask,
    ), r, g, device)


def load_npz(path: str, device: torch.device | str = "cuda") -> SceneSet:
    """Load a SceneSet written by ``tools/convert_dataset.py`` (or the
    port's ``gennbv_tpu_torch/tools/convert_dataset.py``)."""
    d = np.load(path)
    keys = ("render_occ", "box_lo", "box_hi", "grid_gt", "voxel_size",
            "range_gt", "gt_points", "gt_points_mask")
    arrays = {k: d[k] for k in keys}
    arrays["num_valid_voxel"] = arrays["grid_gt"].sum(axis=(1, 2, 3))
    return _to_device(arrays, int(d["grid_res"]), int(d["grid_size"]), device)


def make_scenes(cfg: SceneConfig, grid_res: int,
                device: torch.device | str = "cuda") -> SceneSet:
    """The scene set a config names, on `device`: a procedural family
    (houses, objects, convex, or terrain, ``env/terrain.py``), or a
    dataset directory holding ``scenes.npz`` (its own render
    resolution; `grid_res` is then unused) or else a reference-layout
    ``gt_grid.npy``.  Unlike the JAX package the port keeps no on-disk
    scene cache: it writes nothing outside the caller's control."""
    if cfg.dataset == "terrain":
        from gennbv_tpu_torch.env.terrain import generate_terrain
        return generate_terrain(cfg, grid_res, device=device)
    if cfg.dataset in PROCEDURAL_FAMILIES:
        return generate_procedural(cfg, grid_res, device=device)
    npz = os.path.join(cfg.dataset, "scenes.npz")
    if os.path.exists(npz):
        return load_npz(npz, device)
    gt = os.path.join(cfg.dataset, "gt_grid.npy")
    if not os.path.exists(gt):
        raise FileNotFoundError(
            f"scene.dataset={cfg.dataset!r} is neither a procedural family "
            f"{PROCEDURAL_FAMILIES} nor a directory holding scenes.npz or "
            "gt_grid.npy")
    return load_reference_gt(np.load(gt), grid_res, device)


def voxel_centers(range_gt: torch.Tensor, voxel_size: torch.Tensor,
                  g: int) -> torch.Tensor:
    """[..., G^3, 3] world coordinates of GT voxel centers, batched over
    the leading axes of range_gt [..., 6] and voxel_size [..., 3].
    ``min + i * size`` is one fused multiply-add, as XLA computes it in
    the JAX package's jitted step."""
    mins = torch.stack([range_gt[..., 1], range_gt[..., 3], range_gt[..., 5]],
                       dim=-1)                                   # [..., 3]
    ar = torch.arange(g, dtype=torch.float32, device=range_gt.device)
    axes = fp32.fma(ar, voxel_size[..., None], mins[..., None])  # [..., 3, G]
    cx, cy, cz = axes.unbind(-2)
    lead = cx.shape[:-1]
    xx = cx[..., :, None, None].expand(*lead, g, g, g)
    yy = cy[..., None, :, None].expand(*lead, g, g, g)
    zz = cz[..., None, None, :].expand(*lead, g, g, g)
    return torch.stack([xx, yy, zz], dim=-1).reshape(*lead, g ** 3, 3)
