"""Held-out evaluation: one deterministic episode per env, coverage, reward
AUC and reconstruction accuracy (port of ``gennbv_tpu/algo/evaluation.py``).

The reference protocol (stable_baselines3/common/evaluation.py:136-378):
- ``env.reset`` performs the forced top-down init step; its reward is not
  counted (evaluation.py:216-221);
- each env runs exactly one episode, of at most ``max_episode_length``
  steps, with actions from the mode of the policy's distribution and the
  policy in eval mode (BatchNorm running statistics);
- the reward AUC weights each step's gain by the steps that remain, and
  the done step's gain counts zero (AUC_update, evaluation.py:358-378);
- accuracy: the chamfer distance x100 between the accumulated scanned
  points (deduped at 1 cm) and the GT point cloud
  (env_eval_gennbv.py:252-264).  As in the JAX package, the points come
  from a strided pixel subset (``point_stride``) of a ray-marched depth
  render of each view, the reset's forced view included.
Fresh envs (an auto-reset after an early done) have their action forced to
the init view inside ``env.step``, as in the reference.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from gennbv_tpu_torch.models import distributions
from gennbv_tpu_torch.ops import backproject, camera, chamfer, fp32, render
from gennbv_tpu_torch.utils import profiling

# point pairs of one NN pass: ~1 GB of squared-distance temporaries at
# ~40 bytes a pair (the rounding's float64 intermediates)
_NN_PAIRS_PER_PASS = 25_000_000
# the unit of each evaluate call's spans: its number in the process
_calls = itertools.count(1)


class EvalResult(NamedTuple):
    mean_reward: float
    std_reward: float
    mean_ep_length: float
    mean_auc: float
    mean_final_coverage: float
    mean_accuracy_cm: float
    per_env_coverage: np.ndarray
    per_env_auc: np.ndarray
    # coverage of the forced init view, whose reward is not counted
    mean_init_coverage: float = float("nan")
    # integral of the coverage-vs-step curve, init view included, each
    # env's coverage frozen at its final value after its done step
    mean_curve_auc: float = float("nan")
    # the accuracy decomposition, in the reference's x100 m^2 units:
    # mean_accuracy_cm = scan2gt + gt2scan.  scan2gt is bounded below by
    # ~accuracy_floor_gt_sampling/4 (the GT sampling density); gt2scan
    # splits into a seen part (GT points within 2 render voxels of a scan
    # sample) and a coverage-limited unseen tail whose share is
    # gt_unseen_frac.  NaN without the accuracy scan.
    accuracy_scan2gt: float = float("nan")
    accuracy_gt2scan: float = float("nan")
    accuracy_gt2scan_seen: float = float("nan")
    gt_unseen_frac: float = float("nan")
    accuracy_floor_gt_sampling: float = float("nan")


def scan_rays(env, point_stride: int) -> torch.Tensor:
    """[S, 3] camera-frame rays of the strided pixel subset."""
    h, w = env.cfg.camera.height, env.cfg.camera.width
    return env.cam_rays.reshape(h, w, 3)[::point_stride, ::point_stride
                                         ].reshape(-1, 3)


def scan_points(env, scene_id: torch.Tensor, poses: torch.Tensor,
                sub_rays: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Ray-marched depth of the rays sub_rays from poses [N, 6], back-
    projected: (pts [N, S, 3], valid [N, S])."""
    sc = env.scenes
    cam = env.cfg.camera
    r_c2w, t_c2w = camera.pose_to_c2w(poses, cam.z_offset)
    depth, fg = render.render_depth(
        sc.render_occ[scene_id], sc.box_lo[scene_id], sc.box_hi[scene_id],
        sub_rays, r_c2w, t_c2w, sc.grid_res, 3 * sc.grid_res, cam.depth_max)
    return backproject.backproject(depth, fg, sub_rays, r_c2w, t_c2w)


def init_pose(env) -> torch.Tensor:
    """The forced init view's pose.  The JAX package computes it from
    constants, which XLA folds as a product and a sum rounded apart (not
    the fused multiply-add of ``env.step``'s pose)."""
    return env.init_action.float() * env.action_unit + env.pose_low


def _init_points(env, scene_id: torch.Tensor, sub_rays: torch.Tensor):
    """Scan points of the forced init view, executed inside env.reset."""
    poses = init_pose(env).expand(scene_id.shape[0], -1)
    return scan_points(env, scene_id, poses, sub_rays)


def step_poses(env, state, actions: torch.Tensor) -> torch.Tensor:
    """The poses env.step will take for actions [N, 6]: index * unit + low
    as one fused multiply-add, fresh envs at the init view."""
    acts = torch.minimum(torch.clamp_min(actions, 0), env.nvec - 1).float()
    poses = fp32.fma(acts, env.action_unit, env.pose_low)
    fresh = (state.episode_len == 0)[:, None]
    return torch.where(fresh, init_pose(env), poses)


def batched_accuracy(deduped, gt_pts, gt_mask, vox, group: int | None = None,
                     device: torch.device | str = "cuda"):
    """Reconstruction-accuracy metrics over all envs' episode scans, on
    `device` (the card unless the caller asks for the CPU).

    Scan points are padded to a common count and masked; the NN pass
    chunks over query rows only, so each point's min over the whole target
    set, and every derived metric, equals the per-env form's.  Envs go in
    groups of `group` (None: the JAX package's choice from the padded
    point count); the query rows of a pass are sized so that its
    squared-distance transient stays near 1 GB.  The three passes, their
    copies to the host included, lie in the device-timed span
    ``eval/accuracy/nn``.

    Args: deduped - list of N [Pi, 3] arrays (rounded and deduped scan
    points, possibly empty); gt_pts/gt_mask - [N, Pg, 3]/[N, Pg]
    scene-gathered GT samples; vox - [N] render voxel size.

    Returns (mean_acc_cm, acc_s2g_cm, acc_g2s_cm, acc_g2s_seen_cm,
    gt_unseen_frac, gt_floor_cm); all NaN when no env has scan points.
    """
    n = len(deduped)
    gt_mask = np.asarray(gt_mask)
    has = np.array([len(p) > 0 for p in deduped])
    if not has.any():
        nan = float("nan")
        return nan, nan, nan, nan, nan, nan

    pmax = -(-max(len(p) for p in deduped) // 1024) * 1024
    if group is None:
        biggest = max(pmax, gt_pts.shape[1])
        group = max(1, min(8, int(2.5e8 // (128 * biggest * 4))))
    scan = np.zeros((n, pmax, 3), np.float32)
    smask = np.zeros((n, pmax), bool)
    for e, p in enumerate(deduped):
        scan[e, :len(p)] = p
        smask[e, :len(p)] = True

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    scan_t, smask_t = dev(scan), dev(smask)
    gt_t, gm_t = dev(gt_pts, np.float32), dev(gt_mask)

    def grouped(fn, a, am, b, bm):
        chunk = max(128, _NN_PAIRS_PER_PASS // (group * b.shape[1]) // 128 * 128)
        outs = [fn(a[s:s + group], am[s:s + group], b[s:s + group],
                   bm[s:s + group], chunk).cpu().numpy()
                for s in range(0, n, group)]
        return np.concatenate(outs)

    with profiling.device_span("eval/accuracy/nn", device):
        scan_nn = grouped(chamfer.nn_sq_dists, scan_t, smask_t, gt_t, gm_t)
        gt_nn = grouped(chamfer.nn_sq_dists, gt_t, gm_t, scan_t, smask_t)
        # floor of the scan->gt direction: the GT sampling's own NN^2.  A
        # surface-exact scan point still measures ~floor/4 to the nearest
        # GT sample.  Its mean is taken here on the host, as the others
        # are, so the card's result equals the CPU's (the JAX package sums
        # it on the device, in XLA's order).
        gt_self_nn = grouped(lambda a, am, b, bm, chunk:
                             chamfer.self_nn_sq_dists(a, am, chunk),
                             gt_t, gm_t, gt_t, gm_t)

    def mmean(d, m):
        return np.where(m.any(axis=1),
                        np.where(m, d, 0.0).sum(axis=1)
                        / np.maximum(m.sum(axis=1), 1), 0.0)

    floor = mmean(gt_self_nn, gt_mask)
    d_sg = mmean(scan_nn, smask)                            # [N]
    d_gs = mmean(gt_nn, gt_mask)
    # gt->scan splits into GT points near some scan sample (tracks the scan
    # sampling density) and GT points the episode never observed within 2
    # render voxels (the coverage-limited tail)
    vox = np.asarray(vox)
    seen = (gt_nn <= (2.0 * vox[:, None]) ** 2) & gt_mask
    n_gt = np.maximum(gt_mask.sum(axis=1), 1)
    unseen = 1.0 - seen.sum(axis=1) / n_gt
    g2s_seen = mmean(gt_nn, seen)

    return (float(((d_sg + d_gs)[has]).mean() * 100.0),
            float(d_sg[has].mean() * 100.0),
            float(d_gs[has].mean() * 100.0),
            float(g2s_seen[has].mean() * 100.0),
            float(unseen[has].mean()),
            float(floor[has].mean() * 100.0))


def episode_scans(pts: np.ndarray, valid: np.ndarray,
                  before_done: np.ndarray) -> list:
    """Each env's scan points of its episode, rounded to 1 cm and deduped:
    pts [T + 1, N, S, 3] and valid [T + 1, N, S] (the init view first),
    before_done [T, N]."""
    valid = valid.copy()
    valid[1:] &= before_done[:, :, None]
    return [chamfer.dedupe_round_cm(pts[:, e][valid[:, e]])
            for e in range(pts.shape[1])]


class Episodes(NamedTuple):
    """What one eval run of ``run_episodes`` brings to the host."""
    init_coverage: np.ndarray   # [N] coverage of the forced init view
    rewards: np.ndarray         # [T, N]
    dones: np.ndarray           # [T, N] bool
    coverage: np.ndarray        # [T, N]
    scene_id: torch.Tensor      # [N], on the env's device
    # the accuracy scan's points, init view first: [T + 1, N, S, 3] and
    # [T + 1, N, S]; None without the scan
    scan_pts: np.ndarray | None
    scan_valid: np.ndarray | None


def run_episodes(env, policy: torch.nn.Module, point_stride: int = 8,
                 compute_accuracy: bool = True) -> Episodes:
    """Reset ``env.cfg.num_envs`` envs and run ``max_episode_length``
    steps with the deterministic policy in eval mode (its mode is restored
    after).  With ``compute_accuracy`` each view's strided sub-rays are
    also ray-marched and back-projected before its step.  The spans
    ``eval/reset``, ``eval/step`` a step and ``eval/fetch`` (the copies to
    the host, the wait for the device); with ``compute_accuracy``,
    ``eval/scan`` (device-timed) around each view's scan, the reset's
    included."""
    n = env.cfg.num_envs
    was_training = policy.training
    policy.eval()
    scan_pts, scan_valid = [], []
    try:
        with torch.no_grad():
            with profiling.span("eval/reset"):
                state, reset_out = env.reset(n)
                obs = reset_out.obs
                if compute_accuracy:
                    sub_rays = scan_rays(env, point_stride)
                    with profiling.device_span("eval/scan", env.device):
                        pts, valid = _init_points(env, state.scene_id,
                                                  sub_rays)
                    scan_pts.append(pts)
                    scan_valid.append(valid)
            steps = []
            for _ in range(env.cfg.max_episode_length):
                with profiling.span("eval/step"):
                    actions = distributions.mode(policy(obs).logits)
                    if compute_accuracy:
                        with profiling.device_span("eval/scan", env.device):
                            pts, valid = scan_points(
                                env, state.scene_id,
                                step_poses(env, state, actions), sub_rays)
                        scan_pts.append(pts)
                        scan_valid.append(valid)
                    state, out = env.step(state, actions)
                    obs = out.obs
                    steps.append(torch.stack([out.reward, out.done.float(),
                                              out.coverage]))
            with profiling.span("eval/fetch"):
                rewards, dones, coverage = torch.stack(steps, 1).cpu().numpy()
                init_coverage = reset_out.coverage.cpu().numpy()
                scans = ((torch.stack(scan_pts).cpu().numpy(),
                          torch.stack(scan_valid).cpu().numpy())
                         if compute_accuracy else (None, None))
            return Episodes(
                init_coverage=init_coverage, rewards=rewards,
                dones=dones > 0.5, coverage=coverage,
                scene_id=state.scene_id, scan_pts=scans[0],
                scan_valid=scans[1])
    finally:
        policy.train(was_training)


def before_done_mask(dones: np.ndarray) -> np.ndarray:
    """[T, N] bool: the steps up to and including each env's first done
    (every episode ends by timeout within T)."""
    max_len = dones.shape[0]
    first_done = np.where(dones.any(axis=0), dones.argmax(axis=0), max_len - 1)
    return np.arange(max_len)[:, None] <= first_done[None, :]


def episode_accuracy(env, ep: Episodes):
    """The six accuracy metrics of batched_accuracy for the episodes'
    scans, on the env's device.  The span ``eval/accuracy`` (→
    ``eval/accuracy/dedupe``, the host's dedupe, and
    ``eval/accuracy/nn``, device-timed, the NN passes); the deduped
    points, summed over the envs, counted in ``accuracy/scan_points``."""
    sc = env.scenes
    sids = ep.scene_id
    with profiling.span("eval/accuracy"):
        with profiling.span("eval/accuracy/dedupe"):
            deduped = episode_scans(ep.scan_pts, ep.scan_valid,
                                    before_done_mask(ep.dones))
        profiling.count("accuracy/scan_points", sum(map(len, deduped)))
        box_lo = sc.box_lo[sids].cpu().numpy()
        box_hi = sc.box_hi[sids].cpu().numpy()
        vox = (box_hi - box_lo).max(axis=1) / sc.grid_res
        return batched_accuracy(
            deduped, sc.gt_points[sids].cpu().numpy(),
            sc.gt_points_mask[sids].cpu().numpy(), vox, device=env.device)


def evaluate(env, policy: torch.nn.Module, point_stride: int = 8,
             compute_accuracy: bool = True) -> EvalResult:
    """Run ``env.cfg.num_envs`` envs for ``env.cfg.max_episode_length``
    steps from one reset, with the deterministic policy.  With
    ``compute_accuracy`` the episode's scan points (``point_stride``) are
    also held to the scenes' GT point clouds.  The span ``eval/episode``,
    of the call's number in the process (``run_episodes``' spans, then
    ``eval/results``), counted in ``eval/episodes``."""
    profiling.count("eval/episodes")
    with profiling.span("eval/episode", next(_calls)):
        ep = run_episodes(env, policy, point_stride, compute_accuracy)
        with profiling.span("eval/results"):
            return _results(env, ep, compute_accuracy)


def _results(env, ep: Episodes, compute_accuracy: bool) -> EvalResult:
    n = env.cfg.num_envs
    max_len = env.cfg.max_episode_length
    rewards, coverage = ep.rewards, ep.coverage
    before_done = before_done_mask(ep.dones)
    first_done = before_done.sum(axis=0) - 1
    strictly_before = np.arange(max_len)[:, None] < first_done[None, :]

    ep_rewards = (rewards * before_done).sum(axis=0)
    ep_lengths = first_done + 1
    final_coverage = coverage[first_done, np.arange(n)]

    # AUC: the reference zeroes the done step's gain
    weights = (max_len - np.arange(max_len)) / max_len
    per_env_auc = (rewards * strictly_before * weights[:, None]).sum(axis=0)

    # the coverage curve, init view first, frozen after each env's done step
    # (its state auto-resets there)
    frozen = np.where(before_done, coverage, final_coverage[None, :])
    curve = np.concatenate([ep.init_coverage[None, :], frozen], axis=0)

    (mean_acc, acc_s2g, acc_g2s, acc_g2s_seen, gt_unseen_frac,
     gt_floor) = (episode_accuracy(env, ep) if compute_accuracy
                  else (float("nan"),) * 6)

    return EvalResult(
        mean_reward=float(ep_rewards.mean()),
        std_reward=float(ep_rewards.std()),
        mean_ep_length=float(ep_lengths.mean()),
        mean_auc=float(per_env_auc.mean()),
        mean_final_coverage=float(final_coverage.mean()),
        mean_accuracy_cm=mean_acc,
        per_env_coverage=final_coverage,
        per_env_auc=per_env_auc,
        mean_init_coverage=float(ep.init_coverage.mean()),
        mean_curve_auc=float(curve.mean(axis=0).mean()),
        accuracy_scan2gt=acc_s2g,
        accuracy_gt2scan=acc_g2s,
        accuracy_gt2scan_seen=acc_g2s_seen,
        gt_unseen_frac=gt_unseen_frac,
        accuracy_floor_gt_sampling=gt_floor,
    )
