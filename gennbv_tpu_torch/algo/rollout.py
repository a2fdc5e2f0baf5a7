"""Rollout collection: the env and the policy stepped together for n_steps
(port of ``gennbv_tpu/algo/rollout.py``).

Replaces collect_rollouts (on_policy_algorithm_grid_obs.py:128-221).  The
buffers stay on the env's device.  The timeout value bootstrap uses the
*next step's* policy values: the pre-reset obs at a terminal step is also
the obs the next action is computed from, so V(obs_{t+1}) == values[t+1]
and no second forward pass is needed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class RolloutBatch(NamedTuple):
    obs: torch.Tensor        # [T, N, D]
    actions: torch.Tensor    # [T, N, 6] int32
    rewards: torch.Tensor    # [T, N]  (bootstrap-adjusted)
    dones: torch.Tensor      # [T, N] bool
    values: torch.Tensor     # [T, N]
    log_probs: torch.Tensor  # [T, N]
    last_values: torch.Tensor  # [N]


class RolloutStats(NamedTuple):
    """Per-step env metrics for logging (reference extras["episode"],
    env_train_base.py:629-639)."""
    coverage: torch.Tensor            # [T, N]
    collision: torch.Tensor           # [T, N]
    ep_reward: torch.Tensor           # [T, N] (nonzero at terminal steps)
    ep_length: torch.Tensor           # [T, N]
    ep_rew_coverage: torch.Tensor     # [T, N]
    ep_rew_short_path: torch.Tensor   # [T, N]
    ep_rew_termination: torch.Tensor  # [T, N]
    num_dones: torch.Tensor           # [T, N]


@torch.no_grad()
def collect(env, policy, env_state, obs: torch.Tensor,
            generator: torch.Generator, n_steps: int, gamma: float):
    """Step `env` n_steps times with actions from ``policy.act(obs,
    generator)``; the policy runs in eval mode (BN running stats) and is
    put back in its previous mode afterwards.  Observations are stored in
    float32.  Returns (env_state', obs', RolloutBatch, RolloutStats)."""
    was_training = policy.training
    policy.eval()
    obs_seq = torch.empty((n_steps, *obs.shape), dtype=torch.float32,
                          device=obs.device)
    steps = []
    try:
        for t in range(n_steps):
            obs_seq[t] = obs
            actions, values, logp = policy.act(obs, generator)
            env_state, out = env.step(env_state, actions)
            steps.append((actions, values, logp, out._replace(obs=None)))
            obs = out.obs
        # final value for GAE + the last step's timeout bootstrap
        last_values = policy(obs).value
    finally:
        policy.train(was_training)

    actions, values, logps, outs = zip(*steps)
    actions, values, logps = map(torch.stack, (actions, values, logps))
    # [T, N] stacks of the StepOutput fields
    out = {f: torch.stack([o[i] for o in outs])
           for i, f in enumerate(outs[0]._fields) if f != "obs"}
    next_values = torch.cat([values[1:], last_values[None]], dim=0)
    rewards = out["reward"] + gamma * next_values * out["time_out"].float()
    batch = RolloutBatch(obs=obs_seq, actions=actions, rewards=rewards,
                         dones=out["done"], values=values, log_probs=logps,
                         last_values=last_values)
    stats = RolloutStats(
        coverage=out["coverage"],
        collision=out["collision"].float(),
        ep_reward=out["ep_reward"],
        ep_length=out["ep_length"],
        ep_rew_coverage=out["ep_rew_coverage"],
        ep_rew_short_path=out["ep_rew_short_path"],
        ep_rew_termination=out["ep_rew_termination"],
        num_dones=out["done"].float(),
    )
    return env_state, obs, batch, stats
