"""Policy playback and export (port of ``gennbv_tpu/train/play.py``;
reference: legged_gym/scripts/play.py and export_policy_as_jit,
legged_gym/utils/helpers.py:728-767).

Loads a checkpoint, runs the deterministic policy through one eval
protocol (50 envs x 30 steps), prints coverage, AUC and accuracy, and
optionally writes:
- env 0's reconstruction as a PLY point cloud (the reference's save_pcd /
  open3d debug IO, gennbv/utils.py:363-367) and as a quad-mesh OBJ (the
  native C++ mesher);
- env 0's episode as an animated GIF (depth view and coverage map);
- the deterministic policy as a ``torch.export`` program (where the JAX
  package writes StableHLO): ``torch.export.load(path).module()`` runs it
  in any PyTorch process without this package's code.

    python -m gennbv_tpu_torch.train.play \\
        --ckpt runs/<exp>/models/rl_model_best_episode_reward \\
        --export policy.pt2 --ply recon.ply

Runs on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from gennbv_tpu_torch.models import distributions


class DeterministicPolicy(torch.nn.Module):
    """obs [B, obs_dim] -> the mode of the policy's action distribution
    [B, 6] int32, with the BatchNorms on their running statistics."""

    def __init__(self, policy: torch.nn.Module):
        super().__init__()
        self.policy = policy

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return distributions.mode(self.policy(obs).logits)


def export_policy(policy: torch.nn.Module, obs_dim: int, path: str,
                  batch: int = 50) -> int:
    """Write the deterministic inference function for [batch, obs_dim]
    float32 observations as a ``torch.export`` program on the policy's
    device; returns the file's size in bytes."""
    device = next(policy.parameters()).device
    was_training = policy.training
    policy.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(
                DeterministicPolicy(policy),
                (torch.zeros(batch, obs_dim, device=device),))
    finally:
        policy.train(was_training)
    torch.export.save(program, path)
    return os.path.getsize(path)


def export_recurrent_policy(model, params, obs_dim: int, path: str,
                            batch: int = 1):
    """The recurrent actor's export (``(obs, hidden) -> (action_mean,
    hidden')``) waits for the recurrent models."""
    raise NotImplementedError(
        "export_recurrent_policy: the recurrent models are not implemented "
        "in gennbv_tpu_torch yet (ROADMAP.md Queue 1 item 11)")


def load_exported_policy(path: str):
    """The callable of a program written by export_policy."""
    return torch.export.load(path).module()


def save_ply(path: str, pts: np.ndarray):
    """Minimal ASCII PLY writer (replaces open3d)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in pts:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint file (rl_model_* under runs/<exp>/models)")
    p.add_argument("--export", type=str, default=None,
                   help="write the deterministic policy as a torch.export "
                        "program to this path")
    p.add_argument("--ply", type=str, default=None,
                   help="write env 0's reconstruction point cloud to this path")
    p.add_argument("--gif", type=str, default=None,
                   help="record env 0's episode (depth view + coverage map) "
                        "as an animated GIF (vec_video_recorder analogue)")
    p.add_argument("--obj", type=str, default=None,
                   help="write env 0's reconstruction as a quad-mesh OBJ "
                        "(native C++ mesher)")
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    from gennbv_tpu_torch.algo import evaluation
    from gennbv_tpu_torch.config import Config, apply_overrides, eval_env_config
    from gennbv_tpu_torch.env import ReconEnv, make_scenes
    from gennbv_tpu_torch.models.policy import ActorCriticPolicy
    from gennbv_tpu_torch.utils.checkpoint import CheckpointManager

    device = torch.device(args.device)
    cfg = apply_overrides(Config(), tuple(args.set))
    env_cfg = eval_env_config(cfg.env)
    if args.num_envs:
        env_cfg = dataclasses.replace(env_cfg, num_envs=args.num_envs)
    # held-out scenes: another seed than training, like the reference's
    # batch-12 eval split (env_eval_gennbv.py:18-50)
    scene_cfg = dataclasses.replace(env_cfg.scene, num_scenes=env_cfg.num_envs,
                                    seed=env_cfg.scene.seed + 1000)
    env = ReconEnv(env_cfg, make_scenes(scene_cfg, env_cfg.renderer.resolution,
                                        device))
    policy = ActorCriticPolicy(
        cfg.model, torch.Generator(device=device).manual_seed(0), device)

    if args.ckpt:
        mgr = CheckpointManager(os.path.dirname(os.path.abspath(args.ckpt)))
        policy.load_state_dict(mgr.restore_policy(
            os.path.basename(args.ckpt), device))
        print(f"loaded checkpoint {args.ckpt}")

    res = evaluation.evaluate(env, policy)
    print(f"eval: coverage={res.mean_final_coverage:.4f} AUC={res.mean_auc:.4f} "
          f"reward={res.mean_reward:.3f} ep_len={res.mean_ep_length:.1f} "
          f"accuracy={res.mean_accuracy_cm:.3f}cm")

    if args.export:
        n = export_policy(policy, env.obs_dim, args.export,
                          batch=env_cfg.num_envs)
        print(f"exported torch.export policy ({n} bytes) -> {args.export}")

    if args.ply or args.gif or args.obj:
        # deterministic rollout of env 0, recording depth + coverage
        from gennbv_tpu_torch.utils.episode_video import EpisodeVideoRecorder
        rec = EpisodeVideoRecorder(env_cfg.camera.depth_max)
        rh, rw = env_cfg.rgb_h, env_cfg.rgb_w
        policy.eval()
        with torch.no_grad():
            state, out = env.reset(env_cfg.num_envs)
            for _ in range(env_cfg.max_episode_length):
                actions = distributions.mode(policy(out.obs).logits)
                state, out = env.step(state, actions)
                if args.gif:
                    # latest shaded-depth history frame of env 0 (the obs
                    # rgb slice is in [0, 255], bright = near)
                    gray = out.obs[0, -rh * rw:].cpu().numpy().reshape(rh, rw)
                    depth = (1.0 - gray / 255.0) * env_cfg.camera.depth_max
                    rec.add(depth, state.scanned_gt[0].cpu().numpy())
        grid = state.scanned_gt[0].cpu().numpy()
        sid = int(state.scene_id[0])
        rng = env.scenes.range_gt[sid].cpu().numpy()
        vs = env.scenes.voxel_size[sid].cpu().numpy()
        if args.gif:
            rec.write(args.gif)
            print(f"wrote {len(rec)}-frame episode gif -> {args.gif}")
        if args.obj:
            from gennbv_tpu_torch.utils.native import mesh_voxels_to_obj
            origin = rng[[1, 3, 5]] - 0.5 * vs  # voxel lower corners
            n = mesh_voxels_to_obj(grid, origin, vs, args.obj)
            print(f"wrote {n}-quad reconstruction mesh -> {args.obj}")
        if args.ply:
            idx = np.argwhere(grid > 0.5)
            # range_gt layout: (x_max, x_min, y_max, y_min, z_max, z_min)
            pts = (idx + 0.5) * vs[None, :] + rng[None, [1, 3, 5]]
            save_ply(args.ply, pts)
            print(f"wrote {len(pts)} scanned voxels -> {args.ply}")


if __name__ == "__main__":
    main()
