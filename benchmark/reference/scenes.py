"""The procedural scene sets of the benchmark's configurations: a frozen
copy of the port's numpy house generator (``env/scene.py`` at the commit
that added the benchmark, itself a copy of the JAX package's), so that a
change to the program's generator cannot change the benchmark's scenes.

``generate(num_scenes, seed, grid_res, grid_size, extent_xy, extent_z)``
returns the scene arrays as numpy: what ``SceneSet`` holds, by its field
names.  Only the "procedural" family at "standard" difficulty (the houses
of both configurations) is kept.
"""
from __future__ import annotations

import numpy as np


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


def generate(num_scenes: int, seed: int, grid_res: int, grid_size: int,
             extent_xy: float = 10.0, extent_z: float = 6.0,
             max_gt_points: int = 8192) -> dict:
    """The arrays of `num_scenes` procedural houses from numpy's
    ``RandomState(seed)``, as the port's ``generate_procedural`` builds
    them for ``SceneConfig(dataset="procedural", difficulty="standard")``."""
    rng = np.random.RandomState(seed)
    s, g, r = num_scenes, grid_size, grid_res

    render_occ = np.zeros((s, r ** 3), dtype=np.uint8)
    box_lo = np.zeros((s, 3), dtype=np.float32)
    box_hi = np.zeros((s, 3), dtype=np.float32)
    grid_gt = np.zeros((s, g, g, g), dtype=np.float32)
    voxel_size = np.zeros((s, 3), dtype=np.float32)
    range_gt = np.zeros((s, 6), dtype=np.float32)
    gt_points = np.zeros((s, max_gt_points, 3), dtype=np.float32)
    gt_points_mask = np.zeros((s, max_gt_points), dtype=bool)

    for i in range(s):
        e_xy = extent_xy * rng.uniform(0.85, 1.15)
        e_z = extent_z * rng.uniform(0.85, 1.15)
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
        occ = _gen_house(rng, r, lo, hi)
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
    return dict(render_occ=render_occ, box_lo=box_lo, box_hi=box_hi,
                grid_gt=grid_gt, voxel_size=voxel_size, range_gt=range_gt,
                num_valid_voxel=grid_gt.sum(axis=(1, 2, 3)),
                gt_points=gt_points, gt_points_mask=gt_points_mask,
                surf_pts=surf_pts, surf_mask=surf_mask)
