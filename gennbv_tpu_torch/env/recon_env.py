"""The GenNBV task environment, batched over envs (port of
``gennbv_tpu/env/recon_env.py``).

``step(state, actions) -> (state', StepOutput)`` runs the whole env step on
the scenes' device: discrete-pose decode, depth render, hits, carve,
occupancy and coverage update, collision, reward, termination and
auto-reset.  The JAX package writes one env (``_splat_step_one``,
``_render_one`` / ``_mapping_one``) and vmaps it; here every op carries
the env axis itself.

``renderer.mode`` picks the depth source:
- "splat" (default): the surface splat, whose visible points are the
  hits, and the z-test carve against its z-buffer;
- "dda": the exact voxel ray march (ops/render.py), then back-projection,
  the hit scatter of every foreground pixel and the carve, z-test with the
  march's hit mask as foreground or ``carve_mode="bresenham"``;
- "replay" / "callback": the same mapping fed by a ``depth_source``
  (env/depth_sources.py).

Reference semantics kept (env_train_gennbv.py, env_train_base.py):
- teleport env: the action IS the next camera pose;
- fresh envs (episode_len == 0) have their action forced to INIT_ACTION;
- the obs returned at a terminal step is the PRE-reset observation; state
  buffers reset afterwards;
- reward = coverage delta + short-path penalty, clipped at 0
  (only_positive), then the termination bonus added after the clip;
- termination: collision | timeout | coverage > threshold.

Where the JAX package takes its batched splat path (``zbuf_impl="pallas"``,
survivor compaction or a row band split at this camera height), so does
the port: fresh envs are masked out of the splat and their products come
from the per-scene init-view cache (``_render``, ``_map``).  That is all those
settings select here: the splat itself runs the fused CUDA kernel on a
CUDA device and its plain version on the CPU on either path
(``ops/splat.py``); the JAX compaction and banding are bit-identical to
its dense splat by construction.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gennbv_tpu_torch import spec
from gennbv_tpu_torch.config import EXTERNAL_DEPTH_MODES, EnvConfig
from gennbv_tpu_torch.env import scene as scene_lib
from gennbv_tpu_torch.ops import (backproject, camera, carve, fp32, render,
                                  splat, voxel)
from gennbv_tpu_torch.utils import profiling


class EnvState(NamedTuple):
    pose_buf: torch.Tensor      # [N, L, 6] chronological pose history
    rgb_buf: torch.Tensor       # [N, K, h, w] grayscale history
    prob_grid: torch.Tensor     # [N, G, G, G]
    scanned_gt: torch.Tensor    # [N, G, G, G]
    tri_grid: torch.Tensor      # [N, G, G, G]
    coverage: torch.Tensor      # [N]
    episode_len: torch.Tensor   # [N] int32
    scene_id: torch.Tensor      # [N] int64
    ep_rew_coverage: torch.Tensor    # [N]
    ep_rew_short_path: torch.Tensor  # [N]
    ep_rew_termination: torch.Tensor  # [N]
    ep_reward: torch.Tensor     # [N]


class StepOutput(NamedTuple):
    obs: torch.Tensor           # [N, OBS_DIM] flat (state ++ grid ++ state_rgb)
    reward: torch.Tensor        # [N]
    done: torch.Tensor          # [N] bool
    time_out: torch.Tensor      # [N] bool
    coverage: torch.Tensor      # [N] coverage ratio after this step
    collision: torch.Tensor     # [N] bool
    # per-episode sums of terminated envs (0 elsewhere), for logging
    ep_reward: torch.Tensor
    ep_length: torch.Tensor
    ep_rew_coverage: torch.Tensor
    ep_rew_short_path: torch.Tensor
    ep_rew_termination: torch.Tensor


class ReconEnv:
    """Batched GenNBV environment over a SceneSet; runs on the scenes'
    device.  `step` does not modify its input state.  depth_source: the
    external depth feed that renderer.mode "replay" and "callback" need
    (env/depth_sources.py); the built-in renderers ignore it."""

    def __init__(self, cfg: EnvConfig, scenes: scene_lib.SceneSet,
                 depth_source=None):
        fp32.deterministic_fp32()
        if cfg.renderer.mode in EXTERNAL_DEPTH_MODES and depth_source is None:
            raise ValueError(f"renderer.mode={cfg.renderer.mode!r} needs a "
                             "depth_source")
        self.cfg = cfg
        self.scenes = scenes
        self.depth_source = depth_source
        self.device = scenes.surf_pts.device
        cam = cfg.camera

        def t(x, dtype=torch.float32):
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        self.cam_rays = t(camera.camera_rays(cam.height, cam.width,
                                             cam.horizontal_fov_deg))
        self.intrinsics = t(camera.intrinsics(cam.height, cam.width,
                                              cam.horizontal_fov_deg))
        self.action_unit = t(spec.ACTION_UNIT)
        self.pose_low = t(spec.CLIP_POSE_LOW)
        self.nvec = t(spec.NVEC, torch.int32)
        self.init_action = t(spec.INIT_ACTION, torch.int32)
        self.init_pose = t(spec.INIT_POSE_BUF)
        g = scenes.grid_size
        self.num_actions = spec.ACTION_DIM
        self.obs_dim = (cfg.pose_buf_len * spec.ACTION_DIM + g ** 3
                        + cfg.rgb_k * cfg.rgb_h * cfg.rgb_w)
        # Init-view cache (the JAX package's batched splat path, taken
        # under the same settings as there): fresh envs take the forced
        # top-down init view, which sees most of the scene; their splat
        # is masked out and their hit, carve and grayscale products come
        # from a per-scene cache built here, once.
        rc = cfg.renderer
        self._use_init_cache = rc.mode == "splat" and (
            rc.compact_cap_frac is not None
            or rc.band_split_for(cam.height) is not None
            or rc.zbuf_impl == "pallas")
        self._init_cache = None
        if self._use_init_cache:
            self._init_cache = self._build_init_step_cache()

    # ------------------------------------------------------------------
    def init_state(self, num_envs: int,
                   scene_id: Optional[torch.Tensor] = None) -> EnvState:
        cfg = self.cfg
        g = self.scenes.grid_size
        dev = self.device
        if scene_id is None:
            # env -> scene mapping: env_idx % num_scene (env_train_gennbv.py:87-90)
            scene_id = torch.arange(num_envs, device=dev) % self.scenes.num_scenes
        zeros_g = torch.zeros(num_envs, g, g, g, device=dev)
        zeros = torch.zeros(num_envs, device=dev)
        return EnvState(
            pose_buf=self.init_pose.expand(num_envs, cfg.pose_buf_len,
                                           spec.ACTION_DIM).clone(),
            rgb_buf=torch.zeros(num_envs, cfg.rgb_k, cfg.rgb_h, cfg.rgb_w,
                                device=dev),
            prob_grid=zeros_g,
            scanned_gt=zeros_g,
            tri_grid=zeros_g,
            coverage=zeros,
            episode_len=torch.zeros(num_envs, dtype=torch.int32, device=dev),
            scene_id=scene_id.to(dev).long(),
            ep_rew_coverage=zeros,
            ep_rew_short_path=zeros,
            ep_rew_termination=zeros,
            ep_reward=zeros,
        )

    def reset(self, num_envs: int, scene_id: Optional[torch.Tensor] = None):
        """Reference reset: clear all envs, then execute the forced initial
        top-down action once and return its observation
        (env_train_gennbv.py:229-244)."""
        state = self.init_state(num_envs, scene_id)
        actions = self.init_action.expand(num_envs, spec.ACTION_DIM)
        return self.step(state, actions)

    # ------------------------------------------------------------------
    def _render(self, scene_id, poses, fresh):
        """The step's depth and grayscale frame: (view, gray [N, rgb_h,
        rgb_w]), `view` what ``_map`` takes.  The splat's view is (r_c2w,
        t_c2w, zbuf [N, H*W], visible [N, Q]); the other sources' (r_c2w,
        t_c2w, depth [N, H*W], foreground [N, H*W]).  On the batched splat
        path, fresh envs [N] bool took the forced init view: their splat
        is masked out, and their frame comes from the per-scene cache."""
        cfg = self.cfg
        h, w = cfg.camera.height, cfg.camera.width
        r_c2w, t_c2w = camera.pose_to_c2w(poses, cfg.camera.z_offset)
        if cfg.renderer.mode == "splat":
            depth, mask = self._splat(
                scene_id, r_c2w, t_c2w,
                fresh if self._use_init_cache else None)
        elif cfg.renderer.mode == "dda":
            sc = self.scenes
            with profiling.device_span("env/render/raymarch", self.device):
                depth, mask = render.render_depth(
                    sc.render_occ[scene_id], sc.box_lo[scene_id],
                    sc.box_hi[scene_id], self.cam_rays, r_c2w, t_c2w,
                    sc.grid_res, 3 * sc.grid_res, cfg.camera.depth_max)
        else:
            depth, mask = self.depth_source.render_batch(scene_id, poses)
        gray = camera.depth_to_grayscale(depth.reshape(-1, h, w),
                                         cfg.camera.depth_max, cfg.rgb_h,
                                         cfg.rgb_w)
        if self._use_init_cache:
            gray = torch.where(fresh[:, None, None],
                               self._init_cache[2][scene_id], gray)
        return (r_c2w, t_c2w, depth, mask), gray

    def _splat(self, scene_id, r_c2w, t_c2w, skip_env=None):
        """The surface splat of every env, with the points of the envs in
        skip_env [N] bool masked out: (zbuf [N, H*W], visible [N, Q])."""
        cfg = self.cfg
        sc = self.scenes
        # visibility slack: the mean render-voxel size
        veps = fp32.mean3_of_scaled(sc.box_hi[scene_id] - sc.box_lo[scene_id],
                                    sc.grid_res)
        zbuf, _, visible = splat.splat_depth_batch(
            sc.surf_pts[scene_id], sc.surf_mask[scene_id], self.intrinsics,
            r_c2w, t_c2w, cfg.camera.height, cfg.camera.width,
            cfg.camera.depth_max, veps, cfg.renderer.footprint,
            skip_env=skip_env, zbuf_impl=cfg.renderer.zbuf_impl)
        return zbuf, visible

    def _map(self, scene_id, poses, fresh, view):
        """The mapping products of a ``_render`` view: (hit_grid [N, G, G,
        G], traversed [N, G, G, G]), fresh envs' from the init-view cache
        on the batched splat path."""
        if self.cfg.renderer.mode == "splat":
            hit, trav = self._hits_carve(scene_id, *view)
            if self._use_init_cache:
                c_hit, c_trav, _ = self._init_cache
                f1 = fresh[:, None, None, None]
                hit = torch.where(f1, c_hit[scene_id].to(hit.dtype), hit)
                trav = torch.where(f1, c_trav[scene_id].to(trav.dtype), trav)
            return hit, trav
        return self._depth_map(scene_id, poses, *view)

    def _hits_carve(self, scene_id, r_c2w, t_c2w, zbuf, visible):
        """Visible surface points -> hit grid; z-test carve mask.  Both
        [N, G, G, G] float."""
        cfg = self.cfg
        sc = self.scenes
        g = sc.grid_size
        h, w = cfg.camera.height, cfg.camera.width
        range_gt = sc.range_gt[scene_id]
        vsize = sc.voxel_size[scene_id]
        # visible surface points are the mapping hits
        idx, in_bounds = voxel.points_to_voxel_idx(sc.surf_pts[scene_id],
                                                   visible, range_gt, vsize)
        hit_grid = voxel.scatter_hits(g, idx, in_bounds)
        with profiling.device_span("env/map/carve", self.device):
            centers = scene_lib.voxel_centers(range_gt, vsize, g)
            traversed = carve.carve_ztest(
                centers, zbuf.reshape(-1, h, w), self.intrinsics, r_c2w,
                t_c2w, 0.5 * fp32.mean3(vsize),
                cfg.camera.depth_max).reshape(-1, g, g, g)
        return hit_grid, traversed

    def _depth_map(self, scene_id, poses, r_c2w, t_c2w, depth, fg):
        """The "dda", "replay" and "callback" steps' mapping: every
        foreground pixel's world point a hit, then the carve: (hit_grid
        [N, G, G, G], traversed [N, G, G, G])."""
        cfg = self.cfg
        sc = self.scenes
        g = sc.grid_size
        h, w = cfg.camera.height, cfg.camera.width
        range_gt = sc.range_gt[scene_id]
        vsize = sc.voxel_size[scene_id]
        pts, valid = backproject.backproject(depth, fg, self.cam_rays,
                                             r_c2w, t_c2w)
        idx, in_bounds = voxel.points_to_voxel_idx(pts, valid, range_gt, vsize)
        hit_grid = voxel.scatter_hits(g, idx, in_bounds)
        with profiling.device_span("env/map/carve", self.device):
            if cfg.carve_mode == "bresenham":
                cam_voxel = voxel.pose_to_voxel_idx(poses[:, :3], range_gt,
                                                    vsize)
                traversed = carve.carve_bresenham(hit_grid, cam_voxel, g)
            else:
                centers = scene_lib.voxel_centers(range_gt, vsize, g)
                traversed = carve.carve_ztest(
                    centers, depth.reshape(-1, h, w), self.intrinsics, r_c2w,
                    t_c2w, 0.5 * fp32.mean3(vsize),
                    fg=fg.reshape(-1, h, w)).reshape(-1, g, g, g)
        return hit_grid, traversed

    def _build_init_step_cache(self):
        """Splat + hits/carve of the forced init view of every scene:
        (hit_grid [S, G, G, G] bool, traversed [S, G, G, G] bool, gray
        [S, rgb_h, rgb_w] float)."""
        s = self.scenes.num_scenes
        # the JAX package computes this pose outside its jitted step, as a
        # product and a sum rounded apart
        pose = self.init_action.float() * self.action_unit + self.pose_low
        poses = pose.expand(s, spec.ACTION_DIM)
        sid = torch.arange(s, device=self.device)
        cfg = self.cfg
        r_c2w, t_c2w = camera.pose_to_c2w(poses, cfg.camera.z_offset)
        zbuf, visible = self._splat(sid, r_c2w, t_c2w)
        hit, trav = self._hits_carve(sid, r_c2w, t_c2w, zbuf, visible)
        gray = camera.depth_to_grayscale(
            zbuf.reshape(-1, cfg.camera.height, cfg.camera.width),
            cfg.camera.depth_max, cfg.rgb_h, cfg.rgb_w)
        return hit > 0.5, trav > 0.5, gray

    # ------------------------------------------------------------------
    def step(self, state: EnvState, actions: torch.Tensor):
        """actions: [N, 6] discrete pose indices.  The span ``env/step``
        (``env/render``, ``env/map``, ``env/reward``), counted in
        ``env/steps`` and, by its envs, ``env/env_steps``.  Inside them
        the device-timed spans ``env/render/raymarch`` (the "dda" march),
        ``env/render/zbuf`` (the splat's exact z-buffer under
        ``zbuf_impl="scatter"``) and ``env/map/carve`` (every path's
        carve)."""
        n = state.episode_len.shape[0]
        profiling.count("env/steps")
        profiling.count("env/env_steps", n)
        with profiling.span("env/step"):
            # clip + force init action on freshly-reset envs
            actions = torch.clamp(actions.to(self.device, torch.int32),
                                  torch.zeros_like(self.nvec), self.nvec - 1)
            fresh = (state.episode_len == 0)[:, None]
            actions = torch.where(fresh, self.init_action, actions)
            # index * unit + low, one fused multiply-add as in the reference
            poses = fp32.fma(actions.float(), self.action_unit, self.pose_low)
            with profiling.span("env/render"):
                view, gray = self._render(state.scene_id, poses, fresh[:, 0])
            with profiling.span("env/map"):
                sc = self.scenes
                hit_grid, traversed = self._map(state.scene_id, poses,
                                                fresh[:, 0], view)
                prob_grid = carve.update_prob_grid(state.prob_grid, hit_grid,
                                                   traversed)
                tri = voxel.tri_cls(prob_grid)
                scanned_gt, ratio = voxel.coverage_update(
                    state.scanned_gt, hit_grid, sc.grid_gt[state.scene_id],
                    sc.num_valid_voxel[state.scene_id])
            with profiling.span("env/reward"):
                return self._reward(state, poses, prob_grid, tri, scanned_gt,
                                    ratio, gray)

    def _reward(self, state, poses, prob_grid, tri, scanned_gt, ratio, gray):
        """Collision, the observation buffers, reward, termination, the
        PRE-reset observation and the auto-reset: (state', StepOutput)."""
        cfg = self.cfg
        sc = self.scenes
        n = state.episode_len.shape[0]
        episode_len = state.episode_len + 1
        collision = render.check_collision_batch(
            sc.render_occ, sc.box_lo, sc.box_hi, state.scene_id, poses[:, :3],
            cfg.collision_radius, sc.grid_res)

        # observation buffers
        pose_buf = torch.cat([state.pose_buf[:, 1:], poses[:, None, :]], dim=1)
        rgb_buf = torch.cat([state.rgb_buf[:, 1:], gray[:, None]], dim=1)

        # rewards (scale * dt semantics, config.RewardConfig)
        rc = cfg.reward
        d_cov = ratio - state.coverage
        cov_scale = fp32.const(rc.surface_coverage * rc.dt, self.device)
        extra = torch.clamp(episode_len - spec.SHORT_PATH_FREE_STEPS, 0,
                            spec.SHORT_PATH_MAX_EXTRA).float()
        r_sp = -extra * (rc.short_path * rc.dt)
        # coverage reward d_cov * scale, added into each sum as one fused
        # multiply-add, as XLA compiles the reference
        rew = fp32.fma(d_cov, cov_scale, r_sp)
        if rc.only_positive:
            rew = torch.clamp_min(rew, 0.0)

        # termination
        time_out = episode_len >= cfg.max_episode_length
        done = collision | time_out
        if cfg.coverage_done_threshold is not None:
            done = done | (ratio > cfg.coverage_done_threshold)
        r_term = (done & ~time_out).float() * (rc.termination * rc.dt)
        rew = rew + r_term

        # episode accounting (pre-reset values surfaced where done)
        ep_rew_cov = fp32.fma(d_cov, cov_scale, state.ep_rew_coverage)
        ep_rew_sp = state.ep_rew_short_path + r_sp
        ep_rew_term = state.ep_rew_termination + r_term
        ep_reward = state.ep_reward + rew
        d_f = done.float()

        # observation: PRE-reset (built from the updated buffers)
        obs = torch.cat([pose_buf.reshape(n, -1), tri.reshape(n, -1),
                         rgb_buf.reshape(n, -1)], dim=-1)

        # auto-reset terminated envs
        def mask(new, reset_val):
            d = done.reshape((n,) + (1,) * (new.dim() - 1))
            return torch.where(d, reset_val, new)

        new_state = EnvState(
            pose_buf=mask(pose_buf, self.init_pose),
            rgb_buf=mask(rgb_buf, 0.0),
            prob_grid=mask(prob_grid, 0.0),
            scanned_gt=mask(scanned_gt, 0.0),
            tri_grid=mask(tri, 0.0),
            coverage=mask(ratio, 0.0),
            episode_len=torch.where(done, 0, episode_len),
            scene_id=state.scene_id,
            ep_rew_coverage=mask(ep_rew_cov, 0.0),
            ep_rew_short_path=mask(ep_rew_sp, 0.0),
            ep_rew_termination=mask(ep_rew_term, 0.0),
            ep_reward=mask(ep_reward, 0.0),
        )
        out = StepOutput(
            obs=obs,
            reward=rew,
            done=done,
            time_out=time_out,
            coverage=ratio,
            collision=collision,
            ep_reward=ep_reward * d_f,
            ep_length=episode_len.float() * d_f,
            ep_rew_coverage=ep_rew_cov * d_f,
            ep_rew_short_path=ep_rew_sp * d_f,
            ep_rew_termination=ep_rew_term * d_f,
        )
        return new_state, out
