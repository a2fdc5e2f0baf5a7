"""Running-stats observation normalizer (port of
``gennbv_tpu/utils/normalizer.py``).

The reference's Normalizer / NormObsWithImg pair (gennbv/callback.py:103-162,
update_mean_var_count at :8): defined there but not wired on the main
training path; here an optional component that normalizes only the
pose-state slice of the flat observation (the reference variant normalizes
obs[:, :state_dim]).  Functions of a state tuple, on the tensors' device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gennbv_tpu_torch import spec


class NormalizerState(NamedTuple):
    mean: torch.Tensor   # [D]
    var: torch.Tensor    # [D]
    count: torch.Tensor  # scalar


def init(dim: int, epsilon: float = 1e-4,
         device: torch.device | str = "cuda") -> NormalizerState:
    return NormalizerState(
        mean=torch.zeros(dim, device=device),
        var=torch.ones(dim, device=device),
        count=torch.tensor(epsilon, dtype=torch.float32, device=device),
    )


def update(state: NormalizerState, batch: torch.Tensor) -> NormalizerState:
    """Chan et al. parallel update (callback.py:8-22).  The batch variance
    is the population one, as numpy's and jax's ``var``."""
    batch_var, batch_mean = torch.var_mean(batch, dim=0, correction=0)
    batch_count = torch.tensor(batch.shape[0], dtype=torch.float32,
                               device=batch.device)
    delta = batch_mean - state.mean
    tot = state.count + batch_count
    new_mean = state.mean + delta * batch_count / tot
    m_a = state.var * state.count
    m_b = batch_var * batch_count
    m2 = m_a + m_b + delta ** 2 * state.count * batch_count / tot
    return NormalizerState(mean=new_mean, var=m2 / tot, count=tot)


def normalize(state: NormalizerState, x: torch.Tensor,
              clip: float = 10.0) -> torch.Tensor:
    return torch.clamp((x - state.mean) / torch.sqrt(state.var + 1e-8),
                       -clip, clip)


def normalize_obs_state_slice(state: NormalizerState, obs: torch.Tensor,
                              state_dim: int = spec.STATE_DIM) -> torch.Tensor:
    """NormObsWithImg semantics: normalize only the pose slice, pass the
    grid/state_rgb slices through (callback.py:133-162)."""
    head = normalize(state, obs[..., :state_dim])
    return torch.cat([head, obs[..., state_dim:]], dim=-1)
