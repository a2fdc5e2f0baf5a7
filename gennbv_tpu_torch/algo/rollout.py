"""Rollout collection: the env and the policy stepped together for n_steps
(port of ``gennbv_tpu/algo/rollout.py``).

Replaces collect_rollouts (on_policy_algorithm_grid_obs.py:128-221).  The
buffers stay on the env's device.  The timeout value bootstrap uses the
*next step's* policy values: the pre-reset obs at a terminal step is also
the obs the next action is computed from, so V(obs_{t+1}) == values[t+1]
and no second forward pass is needed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gennbv_tpu_torch.utils import profiling


class RolloutBatch(NamedTuple):
    obs: torch.Tensor        # [T, N, D] float32 or bfloat16
    actions: torch.Tensor    # [T, N, 6] int32
    rewards: torch.Tensor    # [T, N]  (bootstrap-adjusted)
    dones: torch.Tensor      # [T, N] bool
    values: torch.Tensor     # [T, N]
    log_probs: torch.Tensor  # [T, N]
    last_values: torch.Tensor  # [N]


class RolloutBuffers(NamedTuple):
    """Storage a caller keeps from one rollout to the next
    (``collect(out=...)``): the fields the PPO update reads, which a
    captured update (``ppo.Learner``) finds at the same addresses every
    iteration."""
    obs: torch.Tensor        # [T, N, D]
    actions: torch.Tensor    # [T, N, 6]
    values: torch.Tensor     # [T, N]
    log_probs: torch.Tensor  # [T, N]

    @classmethod
    def of(cls, batch: "RolloutBatch") -> "RolloutBuffers":
        return cls(batch.obs, batch.actions, batch.values, batch.log_probs)


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
            generator: torch.Generator, n_steps: int, gamma: float,
            obs_dtype: torch.dtype = torch.float32,
            rows: Optional[slice] = None, width: Optional[int] = None,
            out: Optional[RolloutBuffers] = None):
    """Step `env` n_steps times with actions from ``policy.act(obs,
    generator)``; the policy runs in eval mode (BN running stats) and is
    put back in its previous mode afterwards.  Observations are stored in
    `obs_dtype` (float32, or bfloat16 to halve the rollout's largest
    buffer; ``runner.obs_dtype``).  A rank holding envs `rows` of `width`
    passes both: the actions are drawn at the full width
    (``distributions.sample``).  With `out` (a previous rollout's
    ``RolloutBuffers.of``) the observations, actions, values and
    log-probs are written into it, and the batch holds those tensors.
    Each step is the span ``rollout/step`` (``policy/act``, then
    ``env/step``); the last values' forward is ``rollout/last_value``.
    Returns (env_state', obs', RolloutBatch, RolloutStats)."""
    # a slice of the envs (a rank's) passes its place to act
    place = {} if rows is None else {"rows": rows, "width": width}
    was_training = policy.training
    policy.eval()
    dest = out if out is not None else RolloutBuffers(torch.empty(
        (n_steps, *obs.shape), dtype=obs_dtype, device=obs.device),
        None, None, None)
    obs_seq = dest.obs
    steps = []
    try:
        for t in range(n_steps):
            with profiling.span("rollout/step"):
                obs_seq[t] = obs
                with profiling.span("policy/act"):
                    actions, values, logp = policy.act(obs, generator,
                                                       **place)
                env_state, stepped = env.step(env_state, actions)
                steps.append((actions, values, logp,
                              stepped._replace(obs=None)))
                obs = stepped.obs
        # final value for GAE + the last step's timeout bootstrap
        with profiling.span("rollout/last_value"):
            last_values = policy(obs).value
    finally:
        policy.train(was_training)

    actions, values, logps, outs = zip(*steps)
    actions = torch.stack(actions, out=dest.actions)
    values = torch.stack(values, out=dest.values)
    logps = torch.stack(logps, out=dest.log_probs)
    # [T, N] stacks of the StepOutput fields
    fields = {f: torch.stack([o[i] for o in outs])
              for i, f in enumerate(outs[0]._fields) if f != "obs"}
    next_values = torch.cat([values[1:], last_values[None]], dim=0)
    rewards = (fields["reward"]
               + gamma * next_values * fields["time_out"].float())
    batch = RolloutBatch(obs=obs_seq, actions=actions, rewards=rewards,
                         dones=fields["done"], values=values, log_probs=logps,
                         last_values=last_values)
    stats = RolloutStats(
        coverage=fields["coverage"],
        collision=fields["collision"].float(),
        ep_reward=fields["ep_reward"],
        ep_length=fields["ep_length"],
        ep_rew_coverage=fields["ep_rew_coverage"],
        ep_rew_short_path=fields["ep_rew_short_path"],
        ep_rew_termination=fields["ep_rew_termination"],
        num_dones=fields["done"].float(),
    )
    return env_state, obs, batch, stats
