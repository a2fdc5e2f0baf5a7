"""Diagonal-Gaussian distribution helpers for the continuous-action family
(port of ``gennbv_tpu/models/gaussian.py``).

Functions over (mean, log_std) tensors, mirroring rsl_rl's use of
torch.distributions.Normal (rsl_rl/modules/actor_critic.py:119-133) and
SB3's DiagGaussianDistribution.  The KL used by the adaptive-LR rule is the
exact diagonal-Gaussian KL of rsl_rl/algorithms/ppo.py:147-155.
"""
from __future__ import annotations

import numpy as np
import torch

# log(2 pi) rounded to float32 as the JAX package's jnp.log(2 pi) is
_LOG_2PI = float(np.log(np.float32(2.0 * np.pi)))


def sample(mean: torch.Tensor, log_std: torch.Tensor,
           generator: torch.Generator) -> torch.Tensor:
    """mean + std * N(0, 1), the noise drawn from `generator` (on the
    mean's device)."""
    noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    return mean + torch.exp(log_std) * noise


def log_prob(mean: torch.Tensor, log_std: torch.Tensor,
             actions: torch.Tensor) -> torch.Tensor:
    """Summed per-dim log-density -> [...]."""
    var = torch.exp(2.0 * log_std)
    ll = -0.5 * ((actions - mean) ** 2 / var + 2.0 * log_std + _LOG_2PI)
    return ll.sum(dim=-1)


def entropy(log_std: torch.Tensor, num_dims_like: torch.Tensor) -> torch.Tensor:
    """[...] entropy, broadcast to the batch shape of `num_dims_like`."""
    ent = torch.sum(0.5 + 0.5 * _LOG_2PI + log_std)
    return ent.expand(num_dims_like.shape[:-1])


def kl(old_mean, old_log_std, new_mean, new_log_std) -> torch.Tensor:
    """Exact diagonal-Gaussian KL(old || new), summed over dims, mean over
    batch -- the adaptive-LR signal (rsl_rl/algorithms/ppo.py:149-154)."""
    old_std = torch.exp(old_log_std)
    new_std = torch.exp(new_log_std)
    per_dim = (new_log_std - old_log_std
               + (old_std ** 2 + (old_mean - new_mean) ** 2)
               / (2.0 * new_std ** 2)
               - 0.5)
    return per_dim.sum(dim=-1).mean()
