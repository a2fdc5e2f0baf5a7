"""Generic actor-critic modules: the rsl_rl model family (port of
``gennbv_tpu/models/actor_critic.py``).

``GaussianActorCritic``: MLP actor + MLP critic with a learned,
state-independent log-std (rsl_rl/modules/actor_critic.py:42-97); it emits
(mean, log_std, value), and the Gaussian helpers live in
``models/gaussian.py``.  The recurrent family is not ported yet (ROADMAP,
Queue 1 item 11).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gennbv_tpu_torch.ops import fp32

_ACTIVATIONS = {
    "elu": F.elu,
    "relu": F.relu,
    "tanh": torch.tanh,
    # flax.linen.gelu is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "selu": F.selu,
}
# the standard deviation of a unit normal truncated to [-2, 2]
# (flax's variance_scaling divides by it)
_TRUNC_STD = 0.87962566103423978


class ACOutput(NamedTuple):
    mean: torch.Tensor     # [N, A]
    log_std: torch.Tensor  # [A] (state-independent)
    value: torch.Tensor    # [N]


def _dense(in_dim: int, out_dim: int, device, generator) -> nn.Linear:
    """A Linear layer with flax.linen.Dense's init: lecun_normal weights (a
    normal truncated at two standard deviations, variance 1 / fan_in) and
    zero biases, drawn from `generator`."""
    layer = nn.Linear(in_dim, out_dim, device=device)
    std = math.sqrt(1.0 / in_dim) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        layer.bias.zero_()
    return layer


class GaussianActorCritic(nn.Module):
    """MLP actor-critic with a diagonal-Gaussian policy.

    Defaults mirror rsl_rl's ActorCritic: hidden [256, 256, 256] elu actor
    and critic, init_noise_std=1.0 as a learned parameter
    (rsl_rl/modules/actor_critic.py:49-93).  Layers are named as the Flax
    module's (``actor_0`` ... ``actor_out``, ``critic_0`` ...
    ``critic_out``, ``log_std``), which ``models/convert.py`` relies on.
    The critic reads `critic_obs` of width `critic_obs_dim` where given,
    else the actor's obs.
    """

    def __init__(self, obs_dim: int, num_actions: int,
                 actor_hidden: Sequence[int] = (256, 256, 256),
                 critic_hidden: Sequence[int] = (256, 256, 256),
                 activation: str = "elu", init_noise_std: float = 1.0,
                 critic_obs_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        fp32.deterministic_fp32()
        self.activation = _ACTIVATIONS[activation]
        self.actor_layers = self._mlp("actor", obs_dim, actor_hidden,
                                      num_actions, device, generator)
        self.critic_layers = self._mlp(
            "critic", critic_obs_dim or obs_dim, critic_hidden, 1, device,
            generator)
        self.log_std = nn.Parameter(torch.full(
            (num_actions,), math.log(init_noise_std), device=device))

    def _mlp(self, name, in_dim, hidden, out_dim, device, generator):
        names = [f"{name}_{i}" for i in range(len(hidden))] + [f"{name}_out"]
        for layer_name, h in zip(names, (*hidden, out_dim)):
            setattr(self, layer_name, _dense(in_dim, h, device, generator))
            in_dim = h
        return names

    def _run(self, names, x):
        for layer_name in names[:-1]:
            x = self.activation(getattr(self, layer_name)(x))
        return getattr(self, names[-1])(x)

    def forward(self, obs: torch.Tensor,
                critic_obs: Optional[torch.Tensor] = None) -> ACOutput:
        mean = self._run(self.actor_layers, obs)
        c = critic_obs if critic_obs is not None else obs
        value = self._run(self.critic_layers, c)[..., 0]
        return ACOutput(mean=mean, log_std=self.log_std, value=value)
