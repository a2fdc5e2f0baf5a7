"""The GenNBV env step on the splat path, written as plain PyTorch over the
benchmark's scene arrays: discrete-pose decode, the two-digit splat
z-buffer with its 3x3 min-pool and visibility, the voxel hits, the z-test
carve, the occupancy and coverage update, collision, reward, termination
and auto-reset.

It follows the GenNBV task as the reference repo defines it
(zjwzcx/GenNBV ``env_train_gennbv.py``, ``env_train_base.py``) with the
JAX package's semantics for the depth source (``mxu.scatter_min_image``:
depths bucketed into two decimal digits over each frame's valid range),
and rounds where XLA rounds on the CPU (fused multiply-adds, reciprocal
products, the projection dot's order, correctly rounded cos/sin), so that
pixels and voxels land where the reference puts them.  No kernel, cache
or fusion: each product is an ordinary tensor op, the z-buffer a
``scatter_reduce`` and the hit grid a ``scatter_``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

PI = math.pi
ACTION_DIM = 6
NVEC = (81, 81, 51, 1, 13, 13)
CLIP_POSE_LOW = (-8.0, -8.0, 0.1, 0.0, -0.5 * PI, 0.0)
ACTION_UNIT = (0.2, 0.2, 0.2, 0.0, PI / 12.0, PI / 6.0)
INIT_ACTION = (40, 40, 50, 0, 12, 0)
INIT_POSE_BUF = (0.0, 0.0, 10.1, 0.0, 0.5 * PI, 0.0)
GRID_SIZE = 20
CARVE_DELTA = 0.05
OCCUPIED_VALUE = 1.0
TRI_OCC, TRI_FREE = 0.5, 0.0
SHORT_PATH_FREE_STEPS, SHORT_PATH_MAX_EXTRA = 30, 2
LEVELS = 10
EMPTY_KEY = LEVELS * LEVELS


# --- float32 rounding as XLA's CPU backend compiles the JAX reference -------

def const(c: float, device) -> torch.Tensor:
    return torch.full((), c, dtype=torch.float32, device=device)


def fma(a, b, c):
    """a * b + c rounded once (the float32 product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def cos_sin(x):
    x64 = x.double()
    return torch.cos(x64).float(), torch.sin(x64).float()


def rotate(d, r):
    """d [..., P, 3] @ r [..., 3, 3]: columns x, y summed left to right,
    column z a chain of fused multiply-adds."""
    d64, r64 = d.double(), r.double()[..., None, :, :]

    def prod(k, i):
        return d64[..., k] * r64[..., k, i]

    x = (prod(0, 0).float() + prod(1, 0).float()) + prod(2, 0).float()
    y = (prod(0, 1).float() + prod(1, 1).float()) + prod(2, 1).float()
    z = prod(0, 2).float()
    z = (prod(1, 2) + z.double()).float()
    z = (prod(2, 2) + z.double()).float()
    return torch.stack([x, y, z], dim=-1)


def div_const(x, c: float):
    return x * const(c, x.device).reciprocal()


def mean3(x):
    return div_const(x[..., 0] + x[..., 1] + x[..., 2], 3.0)


def mean3_of_scaled(x, c: float):
    r = const(c, x.device).reciprocal()
    acc = x[..., 0] * r
    acc = fma(x[..., 1], r, acc)
    acc = fma(x[..., 2], r, acc)
    return div_const(acc, 3.0)


# --- camera ----------------------------------------------------------------

def intrinsics(height: int, width: int, fov_deg: float) -> np.ndarray:
    fov_x = math.radians(fov_deg)
    fov_y = fov_x * height / width
    fx = 0.5 * width / math.tan(0.5 * fov_x)
    fy = 0.5 * height / math.tan(0.5 * fov_y)
    return np.array([[fx, 0.0, width / 2.0], [0.0, fy, height / 2.0],
                     [0.0, 0.0, 1.0]], dtype=np.float32)


def pose_to_c2w(pose, z_offset: float):
    cp, sp = cos_sin(pose[..., 4])
    cy, sy = cos_sin(pose[..., 5])
    bx = torch.stack([cy * cp, sy * cp, -sp], dim=-1)
    by = torch.stack([-sy, cy, torch.zeros_like(sy)], dim=-1)
    bz = torch.stack([cy * sp, sy * sp, cp], dim=-1)
    r = torch.stack([-by, -bz, bx], dim=-1)
    offset = torch.zeros(3, dtype=pose.dtype, device=pose.device)
    offset[2:].fill_(z_offset)
    return r, pose[..., 0:3] + offset


def pixel_index(coord, size: int):
    return torch.floor(coord).clamp_(-1, size).to(torch.int32)


def project(pts, k, r_c2w, t_c2w, height: int, width: int, near: float):
    """World points [N, P, 3] -> clipped (vi, ui), z and in-image [N, P]."""
    p_cam = rotate(pts - t_c2w[:, None, :], r_c2w)
    z = p_cam[..., 2]
    in_front = z > near
    safe_z = torch.where(in_front, z, 1.0)
    u = k[0, 0] * p_cam[..., 0] / safe_z + k[0, 2]
    v = k[1, 1] * p_cam[..., 1] / safe_z + k[1, 2]
    ui, vi = pixel_index(u, width), pixel_index(v, height)
    ok = in_front & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    return vi.clamp(0, height - 1), ui.clamp(0, width - 1), z, ok


def gather_bf16(img, vi, ui):
    """img [N, H, W] read at (vi, ui), rounded to bfloat16 first."""
    n, h, w = img.shape
    flat = img.to(torch.bfloat16).float().reshape(n, h * w)
    return torch.gather(flat, 1, vi.long() * w + ui.long())


def grayscale(depth, depth_max: float, rgb_h: int, rgb_w: int):
    gray = (1.0 - torch.clamp(depth / depth_max, 0.0, 1.0)) * 255.0
    out = F.interpolate(gray[:, None], size=(rgb_h, rgb_w), mode="bilinear",
                        align_corners=False, antialias=True)
    return out[:, 0]


# --- the splat depth source ------------------------------------------------

def splat(pts, mask, k, r_c2w, t_c2w, height: int, width: int,
          depth_max: float, voxel_eps, footprint: int):
    """(pooled z-buffer [N, H, W], visible [N, Q], valid point count [N]):
    the per-pixel minimum of the two-digit depth key, decoded to its
    bucket's midpoint, min-pooled over (2f+1)^2 pixels, and each point
    visible within voxel_eps + zrange / 100 of the pooled depth (read in
    bfloat16) at its pixel."""
    vi, ui, z, ok = project(pts, k, r_c2w, t_c2w, height, width, 1e-3)
    ok = ok & mask
    n = z.shape[0]
    inf = torch.tensor(float("inf"), device=z.device)
    zmin = torch.where(ok, z, inf).amin(-1)
    zmax = torch.where(ok, z, -inf).amax(-1)
    zrange = torch.clamp_min(zmax - zmin, 1e-3)
    t = torch.clamp((z - zmin[:, None]) / zrange[:, None] * LEVELS,
                    0.0, LEVELS - 1e-3)
    d1 = torch.floor(t)
    d2 = torch.floor((t - d1) * LEVELS)
    key = torch.where(ok, (d1 * LEVELS + d2).to(torch.int32), EMPTY_KEY)
    pix = (torch.arange(n, device=z.device)[:, None] * (height * width)
           + vi.long() * width + ui.long())
    keymin = torch.full((n * height * width,), EMPTY_KEY, dtype=torch.int32,
                        device=z.device)
    keymin.scatter_reduce_(0, pix.reshape(-1), key.reshape(-1), reduce="amin")
    keymin = keymin.reshape(n, height * width)
    m1 = (keymin // LEVELS).float()
    m2 = (keymin % LEVELS).float()
    frac10 = m1 + div_const(m2 + 0.5, LEVELS)
    zq = fma(frac10, div_const(zrange, LEVELS)[:, None], zmin[:, None])
    zbuf = torch.where(keymin < EMPTY_KEY, zq, depth_max).reshape(
        n, height, width)
    if footprint:
        f = footprint
        padded = F.pad(zbuf[:, None], (f, f, f, f), value=depth_max)
        zbuf = torch.clamp_max(-F.max_pool2d(-padded, 2 * f + 1, stride=1)[:, 0],
                               depth_max)
    eps = voxel_eps + div_const(zrange, LEVELS * LEVELS)
    visible = ok & (z <= gather_bf16(zbuf, vi, ui) + eps[:, None])
    return zbuf, visible, ok.sum(-1)


# --- mapping ---------------------------------------------------------------

def voxel_centers(range_gt, voxel_size, g: int):
    mins = torch.stack([range_gt[..., 1], range_gt[..., 3], range_gt[..., 5]],
                       dim=-1)
    ar = torch.arange(g, dtype=torch.float32, device=range_gt.device)
    cx, cy, cz = fma(ar, voxel_size[..., None], mins[..., None]).unbind(-2)
    lead = cx.shape[:-1]
    xx = cx[..., :, None, None].expand(*lead, g, g, g)
    yy = cy[..., None, :, None].expand(*lead, g, g, g)
    zz = cz[..., None, None, :].expand(*lead, g, g, g)
    return torch.stack([xx, yy, zz], dim=-1).reshape(*lead, g ** 3, 3)


def hit_grid(pts, visible, range_gt, vsize, g: int):
    """[N, G, G, G] with 1.0 at the cells of the visible points that lie
    within the half-voxel-widened GT box."""
    xyz_max = range_gt[..., None, 0::2]
    xyz_min = range_gt[..., None, 1::2]
    v = vsize[..., None, :]
    lo, hi = xyz_min - 0.5 * v, xyz_max + 0.5 * v
    idx = torch.floor((pts - lo) / v).clamp_(0, GRID_SIZE - 1).long()
    inside = ((pts > lo) & (pts < hi)).all(-1) & visible
    flat = (idx[..., 0] * g + idx[..., 1]) * g + idx[..., 2]
    flat = torch.where(inside, flat, g ** 3)
    grid = torch.zeros(pts.shape[0], g ** 3 + 1, device=pts.device)
    grid.scatter_(1, flat, 1.0)
    return grid[:, : g ** 3].reshape(-1, g, g, g)


def carve_ztest(centers, depth, k, r_c2w, t_c2w, margin, depth_max: float):
    """[N, G^3] {0, 1}: voxel centers in front of a foreground pixel's
    depth by more than `margin`."""
    h, w = depth.shape[-2:]
    vi, ui, z, in_img = project(centers, k, r_c2w, t_c2w, h, w, 1e-6)
    d_px = gather_bf16(depth, vi, ui)
    fg = d_px < depth_max * (1.0 - 1e-4)
    return (in_img & fg & (z < d_px - margin[:, None])).float()


def collision(render_occ, box_lo, box_hi, scene_id, pos, radius: float,
              r: int):
    """[N] bool: an occupied render voxel under any of the 27 probes on
    the cube of half-width `radius` around pos [N, 3]."""
    lo = box_lo[scene_id]
    vsize = div_const(box_hi[scene_id] - lo, r)
    offs = torch.arange(-1.0, 2.0, device=pos.device) * radius
    cube = torch.cartesian_prod(offs, offs, offs)
    probes = pos[:, None, :] + cube[None]
    idx = torch.floor((probes - lo[:, None]) / vsize[:, None])
    idx = idx.clamp_(-1, r).long()
    in_grid = ((idx >= 0) & (idx < r)).all(-1)
    idx = idx.clamp_(0, r - 1)
    flat = scene_id[:, None] * r ** 3 + (idx[..., 0] * r + idx[..., 1]) * r \
        + idx[..., 2]
    occ = render_occ.reshape(-1)[flat.reshape(-1)].reshape(pos.shape[0], -1)
    return ((occ > 0) & in_grid).any(-1)


class State(NamedTuple):
    pose_buf: torch.Tensor
    rgb_buf: torch.Tensor
    prob_grid: torch.Tensor
    scanned_gt: torch.Tensor
    coverage: torch.Tensor
    episode_len: torch.Tensor
    scene_id: torch.Tensor
    ep_reward: torch.Tensor


class Step(NamedTuple):
    obs: torch.Tensor        # [N, D] (pre-reset at a terminal step)
    reward: torch.Tensor     # [N]
    done: torch.Tensor       # [N] bool
    time_out: torch.Tensor   # [N] bool
    coverage: torch.Tensor   # [N]
    n_valid: torch.Tensor    # [N] points the splat projected into the image


class Env:
    """The task over the scene arrays `scenes` (tensors, ``scenes.py``'s
    names) under the configuration's "env" section `cfg` (a dict).  Only
    the splat renderer with the z-test carve, as both configurations
    run it."""

    def __init__(self, cfg: dict, scenes: dict, grid_res: int):
        rc = cfg["renderer"]
        if rc["mode"] != "splat" or cfg["carve_mode"] != "ztest" \
                or rc["zbuf_impl"] not in ("mxu", "pallas"):
            raise ValueError("the reference env runs the splat renderer's "
                             "two-digit z-buffer with the z-test carve only")
        self.cfg, self.sc, self.r = cfg, scenes, grid_res
        dev = self.dev = scenes["surf_pts"].device
        cam = cfg["camera"]
        self.h, self.w = cam["height"], cam["width"]

        def t(x, dtype=torch.float32):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        self.k = t(intrinsics(self.h, self.w, cam["horizontal_fov_deg"]))
        self.unit, self.low = t(ACTION_UNIT), t(CLIP_POSE_LOW)
        self.nvec = t(NVEC, torch.int32)
        self.init_action = t(INIT_ACTION, torch.int32)
        self.init_pose = t(INIT_POSE_BUF)
        # the JAX package's batched splat takes a fresh env's products from
        # a per-scene cache of the init view, whose pose it computes as a
        # product and a sum rounded apart
        self.cache = None
        if rc["zbuf_impl"] == "pallas" or rc["compact_cap_frac"] is not None \
                or (rc["band_split"] and self.h % rc["band_split"] == 0):
            s = scenes["surf_pts"].shape[0]
            pose = (self.init_action.float() * self.unit + self.low).expand(
                s, ACTION_DIM)
            hit, trav, gray, _ = self._products(
                torch.arange(s, device=dev), pose, None)
            self.cache = (hit > 0.5, trav > 0.5, gray)

    def _products(self, scene_id, poses, skip):
        cfg, sc = self.cfg, self.sc
        cam = cfg["camera"]
        g = GRID_SIZE
        r_c2w, t_c2w = pose_to_c2w(poses, cam["z_offset"])
        veps = mean3_of_scaled(sc["box_hi"][scene_id] - sc["box_lo"][scene_id],
                               self.r)
        pts = sc["surf_pts"][scene_id]
        mask = sc["surf_mask"][scene_id]
        if skip is not None:
            mask = mask & ~skip[:, None]
        zbuf, visible, n_valid = splat(
            pts, mask, self.k, r_c2w, t_c2w, self.h, self.w, cam["depth_max"],
            veps, cfg["renderer"]["footprint"])
        range_gt, vsize = sc["range_gt"][scene_id], sc["voxel_size"][scene_id]
        hit = hit_grid(pts, visible, range_gt, vsize, g)
        trav = carve_ztest(voxel_centers(range_gt, vsize, g), zbuf, self.k,
                           r_c2w, t_c2w, 0.5 * mean3(vsize), cam["depth_max"])
        gray = grayscale(zbuf, cam["depth_max"], cfg["rgb_h"], cfg["rgb_w"])
        return hit, trav.reshape(-1, g, g, g), gray, n_valid

    def init_state(self, scene_id) -> State:
        n = scene_id.shape[0]
        g, cfg, dev = GRID_SIZE, self.cfg, self.dev
        zeros = torch.zeros(n, device=dev)
        return State(
            pose_buf=self.init_pose.expand(n, cfg["pose_buf_len"],
                                           ACTION_DIM).clone(),
            rgb_buf=torch.zeros(n, cfg["rgb_k"], cfg["rgb_h"], cfg["rgb_w"],
                                device=dev),
            prob_grid=torch.zeros(n, g, g, g, device=dev),
            scanned_gt=torch.zeros(n, g, g, g, device=dev),
            coverage=zeros, episode_len=torch.zeros(n, dtype=torch.int32,
                                                    device=dev),
            scene_id=scene_id.long(), ep_reward=zeros)

    def reset(self, scene_id):
        state = self.init_state(scene_id)
        return self.step(state, self.init_action.expand(scene_id.shape[0],
                                                        ACTION_DIM))

    def step(self, state: State, actions):
        cfg, sc = self.cfg, self.sc
        n = state.episode_len.shape[0]
        actions = torch.clamp(actions.to(self.dev, torch.int32),
                              torch.zeros_like(self.nvec), self.nvec - 1)
        fresh = (state.episode_len == 0)[:, None]
        actions = torch.where(fresh, self.init_action, actions)
        poses = fma(actions.float(), self.unit, self.low)
        episode_len = state.episode_len + 1
        skip = fresh[:, 0] if self.cache is not None else None
        hit, trav, gray, n_valid = self._products(state.scene_id, poses, skip)
        if self.cache is not None:
            c_hit, c_trav, c_gray = self.cache
            f1 = fresh[:, None, None]
            sid = state.scene_id
            hit = torch.where(f1, c_hit[sid].float(), hit)
            trav = torch.where(f1, c_trav[sid].float(), trav)
            gray = torch.where(fresh[:, :, None], c_gray[sid], gray)
        prob = torch.where(hit > 0.5, OCCUPIED_VALUE,
                           state.prob_grid - CARVE_DELTA * trav)
        tri = (prob > TRI_OCC).float() - (prob < TRI_FREE).float()
        scanned = torch.clamp(state.scanned_gt + hit * sc["grid_gt"][state.scene_id],
                              0.0, 1.0)
        ratio = scanned.sum(dim=(-1, -2, -3)) / torch.clamp_min(
            sc["num_valid_voxel"][state.scene_id], 1.0)
        hit_wall = collision(sc["render_occ"], sc["box_lo"], sc["box_hi"],
                             state.scene_id, poses[:, :3],
                             cfg["collision_radius"], self.r)
        pose_buf = torch.cat([state.pose_buf[:, 1:], poses[:, None]], dim=1)
        rgb_buf = torch.cat([state.rgb_buf[:, 1:], gray[:, None]], dim=1)

        rw = cfg["reward"]
        cov_scale = const(rw["surface_coverage"] * rw["dt"], self.dev)
        extra = torch.clamp(episode_len - SHORT_PATH_FREE_STEPS, 0,
                            SHORT_PATH_MAX_EXTRA).float()
        rew = fma(ratio - state.coverage, cov_scale,
                  -extra * (rw["short_path"] * rw["dt"]))
        if rw["only_positive"]:
            rew = torch.clamp_min(rew, 0.0)
        time_out = episode_len >= cfg["max_episode_length"]
        done = hit_wall | time_out
        if cfg["coverage_done_threshold"] is not None:
            done = done | (ratio > cfg["coverage_done_threshold"])
        rew = rew + (done & ~time_out).float() * (rw["termination"] * rw["dt"])
        obs = torch.cat([pose_buf.reshape(n, -1), tri.reshape(n, -1),
                         rgb_buf.reshape(n, -1)], dim=-1)

        def reset_where(new, value):
            d = done.reshape((n,) + (1,) * (new.dim() - 1))
            return torch.where(d, value, new)

        new_state = State(
            pose_buf=reset_where(pose_buf, self.init_pose),
            rgb_buf=reset_where(rgb_buf, 0.0),
            prob_grid=reset_where(prob, 0.0),
            scanned_gt=reset_where(scanned, 0.0),
            coverage=reset_where(ratio, 0.0),
            episode_len=torch.where(done, 0, episode_len),
            scene_id=state.scene_id,
            ep_reward=reset_where(state.ep_reward + rew, 0.0))
        return new_state, Step(obs, rew, done, time_out, ratio, n_valid)
