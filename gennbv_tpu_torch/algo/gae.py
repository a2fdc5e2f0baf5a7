"""Generalized Advantage Estimation (port of ``gennbv_tpu/algo/gae.py``).

Rewrite of TensorRolloutBuffer_Grid_Obs.compute_returns_and_advantage
(stable_baselines3/common/buffers.py:706-724).  Timeout value-bootstrapping
is already folded into the rewards upstream (rollout.py), matching
``rewards += gamma * V(new_obs) * time_outs``
(on_policy_algorithm_grid_obs.py:205-208).
"""
from __future__ import annotations

from typing import Optional

import torch


def compute_gae(
    rewards: torch.Tensor,      # [T, N]
    values: torch.Tensor,       # [T, N] V(obs_t)
    dones: torch.Tensor,        # [T, N] episode ended at step t
    last_values: torch.Tensor,  # [N] V(obs_T)
    gamma: float,
    gae_lambda: float,
    out: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages [T, N], returns [T, N] = adv + values), by a
    reverse loop over T on the inputs' device; written into `out` (two
    [T, N] tensors, a previous call's results) where given."""
    non_terminal = 1.0 - dones.float()
    advantages = torch.empty_like(values) if out is None else out[0]
    gae = torch.zeros_like(last_values)
    next_value = last_values
    for t in range(rewards.shape[0] - 1, -1, -1):
        nt = non_terminal[t]
        delta = rewards[t] + gamma * next_value * nt - values[t]
        gae = delta + gamma * gae_lambda * nt * gae
        advantages[t] = gae
        next_value = values[t]
    return advantages, torch.add(advantages, values,
                                 out=None if out is None else out[1])
