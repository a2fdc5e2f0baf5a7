"""Networks for the off-policy family: Q-critics, deterministic and
squashed-Gaussian actors (port of ``gennbv_tpu/models/off_policy_nets.py``).

Counterparts of SB3's policy classes for DQN/SAC/TD3/DDPG (td3/policies.py,
sac/policies.py, dqn/policies.py), as ReLU MLPs over flat observations.
Each Linear layer has the Flax module's name (``q{k}_{i}``, ``q{k}_out``,
``pi_{i}``, ``pi_out``, ``mean``, ``log_std``, ``q_{i}``, ``q_out``), which
``models/convert.py`` relies on, and Flax Dense's init (lecun-normal
weights, zero biases) drawn from the caller's generator.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gennbv_tpu_torch.models.actor_critic import _dense
from gennbv_tpu_torch.ops import fp32

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
# 0.5 * log(2 pi) and log(2) as the JAX expressions round them in float32
HALF_LOG_2PI = fp32.f32(np.float32(0.5) * np.log(np.float32(2.0 * math.pi)))
LOG_2 = fp32.f32(np.log(np.float32(2.0)))


class _MLP(nn.Module):
    """Dense layers named ``{name}_{i}`` with ReLU between them, and a head
    ``{name}_out`` (or the subclass's heads) read by ``_hidden``."""

    def _add_mlp(self, name: str, in_dim: int, hidden: Sequence[int],
                 device, generator) -> list[str]:
        names = []
        for i, h in enumerate(hidden):
            setattr(self, f"{name}_{i}", _dense(in_dim, h, device, generator))
            names.append(f"{name}_{i}")
            in_dim = h
        return names

    def _hidden(self, names: list[str], x: torch.Tensor) -> torch.Tensor:
        for n in names:
            x = F.relu(getattr(self, n)(x))
        return x


class QCritic(_MLP):
    """Twin Q(s, a) -> ([N], [N]) for SAC/TD3 (a single head for DDPG)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (256, 256), n_critics: int = 2,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.n_critics = n_critics
        self.layers = []
        for k in range(n_critics):
            names = self._add_mlp(f"q{k}", obs_dim + action_dim, hidden,
                                  device, generator)
            setattr(self, f"q{k}_out", _dense(hidden[-1], 1, device, generator))
            self.layers.append(names)

    def forward(self, obs: torch.Tensor, actions: torch.Tensor) -> tuple:
        x = torch.cat([obs, actions], dim=-1)
        return tuple(getattr(self, f"q{k}_out")(self._hidden(names, x))[..., 0]
                     for k, names in enumerate(self.layers))


class DeterministicActor(_MLP):
    """tanh-bounded deterministic policy (TD3/DDPG), action in
    [-max_action, max_action]."""

    def __init__(self, obs_dim: int, action_dim: int, max_action: float = 1.0,
                 hidden: Sequence[int] = (256, 256),
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.max_action = max_action
        self.layers = self._add_mlp("pi", obs_dim, hidden, device, generator)
        self.pi_out = _dense(hidden[-1], action_dim, device, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.max_action * torch.tanh(self.pi_out(self._hidden(self.layers,
                                                                     obs)))


class SquashedGaussianActor(_MLP):
    """SAC actor: tanh-squashed diagonal Gaussian with a state-dependent
    std; returns (mean, log_std) with log_std clipped to
    [LOG_STD_MIN, LOG_STD_MAX]."""

    def __init__(self, obs_dim: int, action_dim: int, max_action: float = 1.0,
                 hidden: Sequence[int] = (256, 256),
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.max_action = max_action
        self.layers = self._add_mlp("pi", obs_dim, hidden, device, generator)
        self.mean = _dense(hidden[-1], action_dim, device, generator)
        self.log_std = _dense(hidden[-1], action_dim, device, generator)

    def forward(self, obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        h = self._hidden(self.layers, obs)
        return self.mean(h), torch.clamp(self.log_std(h), LOG_STD_MIN,
                                         LOG_STD_MAX)


def squashed_sample(mean: torch.Tensor, log_std: torch.Tensor,
                    noise: torch.Tensor, max_action: float = 1.0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reparameterized sample with the standard-normal `noise` (shaped like
    `mean`) and its log-prob with the tanh correction, in the JAX form:
    the Gaussian term of ``(pre - mean) / std`` minus ``0.5 log(2 pi)``,
    then minus ``2 (log 2 - pre - softplus(-2 pre))``."""
    std = torch.exp(log_std)
    pre = mean + std * noise
    a = torch.tanh(pre)
    logp = (-0.5 * ((pre - mean) / std) ** 2 - log_std - HALF_LOG_2PI).sum(-1)
    logp = logp - (2.0 * (LOG_2 - pre - F.softplus(-2.0 * pre))).sum(-1)
    return max_action * a, logp


class DiscreteQNet(_MLP):
    """Q(s) -> [N, n_actions] for DQN."""

    def __init__(self, obs_dim: int, n_actions: int,
                 hidden: Sequence[int] = (256, 256),
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.layers = self._add_mlp("q", obs_dim, hidden, device, generator)
        self.q_out = _dense(hidden[-1], n_actions, device, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.q_out(self._hidden(self.layers, obs))
