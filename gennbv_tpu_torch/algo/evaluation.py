"""Held-out evaluation: one deterministic episode per env, coverage and
reward AUC (port of ``gennbv_tpu/algo/evaluation.py``).

The reference protocol (stable_baselines3/common/evaluation.py:136-378):
- ``env.reset`` performs the forced top-down init step; its reward is not
  counted (evaluation.py:216-221);
- each env runs exactly one episode, of at most ``max_episode_length``
  steps, with actions from the mode of the policy's distribution and the
  policy in eval mode (BatchNorm running statistics);
- the reward AUC weights each step's gain by the steps that remain, and
  the done step's gain counts zero (AUC_update, evaluation.py:358-378).
Fresh envs (an auto-reset after an early done) have their action forced to
the init view inside ``env.step``, as in the reference.

Not ported yet (ROADMAP.md Queue 1 item 9): the accuracy scan, which needs
the ray-marched depth render, back-projection and the chamfer distance.
``evaluate`` refuses ``compute_accuracy=True``; the runner's in-train eval
does not ask for it (``runner.eval_accuracy=False``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gennbv_tpu_torch.models import distributions


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
    # the accuracy decomposition of the JAX package; NaN until the accuracy
    # scan is ported
    accuracy_scan2gt: float = float("nan")
    accuracy_gt2scan: float = float("nan")
    accuracy_gt2scan_seen: float = float("nan")
    gt_unseen_frac: float = float("nan")
    accuracy_floor_gt_sampling: float = float("nan")


def evaluate(env, policy: torch.nn.Module, point_stride: int = 8,
             compute_accuracy: bool = True) -> EvalResult:
    """Run ``env.cfg.num_envs`` envs for ``env.cfg.max_episode_length``
    steps from one reset, with the deterministic policy.  ``point_stride``
    is the accuracy scan's pixel stride, used once that scan is ported."""
    if compute_accuracy:
        raise NotImplementedError(
            "evaluate(compute_accuracy=True): the accuracy scan (render_depth, "
            "backproject, chamfer) is not implemented in gennbv_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 9); pass compute_accuracy=False")
    n = env.cfg.num_envs
    max_len = env.cfg.max_episode_length
    was_training = policy.training
    policy.eval()
    try:
        with torch.no_grad():
            state, reset_out = env.reset(n)
            obs = reset_out.obs
            steps = []
            for _ in range(max_len):
                actions = distributions.mode(policy(obs).logits)
                state, out = env.step(state, actions)
                obs = out.obs
                steps.append(torch.stack([out.reward, out.done.float(),
                                          out.coverage]))
            init_coverage = reset_out.coverage.cpu().numpy()      # [N]
            rewards, dones, coverage = torch.stack(steps, 1).cpu().numpy()
    finally:
        policy.train(was_training)
    dones = dones > 0.5                                          # [T, N]

    # first done step per env (every episode ends by timeout within T)
    first_done = np.where(dones.any(axis=0), dones.argmax(axis=0), max_len - 1)
    t_idx = np.arange(max_len)[:, None]
    before_done = t_idx <= first_done[None, :]
    strictly_before = t_idx < first_done[None, :]

    ep_rewards = (rewards * before_done).sum(axis=0)
    ep_lengths = first_done + 1
    final_coverage = coverage[first_done, np.arange(n)]

    # AUC: the reference zeroes the done step's gain
    weights = (max_len - np.arange(max_len)) / max_len
    per_env_auc = (rewards * strictly_before * weights[:, None]).sum(axis=0)

    # the coverage curve, init view first, frozen after each env's done step
    # (its state auto-resets there)
    frozen = np.where(before_done, coverage, final_coverage[None, :])
    curve = np.concatenate([init_coverage[None, :], frozen], axis=0)

    return EvalResult(
        mean_reward=float(ep_rewards.mean()),
        std_reward=float(ep_rewards.std()),
        mean_ep_length=float(ep_lengths.mean()),
        mean_auc=float(per_env_auc.mean()),
        mean_final_coverage=float(final_coverage.mean()),
        mean_accuracy_cm=float("nan"),
        per_env_coverage=final_coverage,
        per_env_auc=per_env_auc,
        mean_init_coverage=float(init_coverage.mean()),
        mean_curve_auc=float(curve.mean(axis=0).mean()),
    )
