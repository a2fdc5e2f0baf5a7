"""Generic actor-critic modules: the rsl_rl model family (port of
``gennbv_tpu/models/actor_critic.py``).

- ``GaussianActorCritic``: MLP actor + MLP critic with a learned,
  state-independent log-std (rsl_rl/modules/actor_critic.py:42-97).
- ``RecurrentActorCritic``: LSTM/GRU memory in front of the same heads
  (rsl_rl/modules/actor_critic_recurrent.py:101-124).  The hidden state is
  an explicit ``RNNState`` carried by the caller, reset where an episode
  ended by :func:`reset_hidden` (the reference's per-step
  `hidden_states[..., dones] = 0`).

Both emit (mean, log_std, value); the Gaussian helpers live in
``models/gaussian.py``.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Sequence

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


def _orthogonal(rows: int, cols: int, device, generator) -> torch.Tensor:
    """[rows, cols] with orthonormal columns or rows, drawn from
    `generator` (flax's orthogonal initializer, the recurrent kernels'
    default), as a torch weight [cols_out, rows_in] is laid out."""
    w = torch.empty(rows, cols, device=device)
    nn.init.orthogonal_(w, generator=generator)
    return w


def _lecun(out_dim: int, in_dim: int, device, generator) -> torch.Tensor:
    """[out_dim, in_dim] lecun_normal (flax's Dense kernel default)."""
    std = math.sqrt(1.0 / in_dim) / _TRUNC_STD
    w = torch.empty(out_dim, in_dim, device=device)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    return w


class LSTMCell(nn.Module):
    """flax.linen.OptimizedLSTMCell: gates i, f, g, o (in that order along
    the rows of each weight) from x W_i (no bias) + h W_h + b_h; carry
    (c, h), output the new h."""

    def __init__(self, in_dim: int, hidden: int, device, generator):
        super().__init__()
        self.weight_i = nn.Parameter(torch.cat(
            [_lecun(hidden, in_dim, device, generator) for _ in range(4)]))
        self.weight_h = nn.Parameter(torch.cat(
            [_orthogonal(hidden, hidden, device, generator) for _ in range(4)]))
        self.bias_h = nn.Parameter(torch.zeros(4 * hidden, device=device))

    def forward(self, carry, x):
        c, h = carry
        gates = (F.linear(h, self.weight_h, self.bias_h)
                 + F.linear(x, self.weight_i))
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        new_c = f * c + i * torch.tanh(g)
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h


class GRUCell(nn.Module):
    """flax.linen.GRUCell: r = s(x W_ir + b_ir + h W_hr), z = s(x W_iz +
    b_iz + h W_hz), n = tanh(x W_in + b_in + r (h W_hn + b_hn)),
    h' = (1 - z) n + z h (rows of each weight in the order r, z, n)."""

    def __init__(self, in_dim: int, hidden: int, device, generator):
        super().__init__()
        self.hidden = hidden
        self.weight_i = nn.Parameter(torch.cat(
            [_lecun(hidden, in_dim, device, generator) for _ in range(3)]))
        self.bias_i = nn.Parameter(torch.zeros(3 * hidden, device=device))
        self.weight_h = nn.Parameter(torch.cat(
            [_orthogonal(hidden, hidden, device, generator) for _ in range(3)]))
        self.bias_hn = nn.Parameter(torch.zeros(hidden, device=device))

    def forward(self, h, x):
        xi = F.linear(x, self.weight_i, self.bias_i)
        hw = F.linear(h, self.weight_h)
        xr, xz, xn = xi.chunk(3, dim=-1)
        hr, hz, hn = hw.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * (hn + self.bias_hn))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h


class RNNState(NamedTuple):
    actor: Any   # LSTM: (c, h) tuple; GRU: a tensor
    critic: Any


def hidden_leaves(state: RNNState) -> list:
    """The hidden state's tensors in ``jax.tree.flatten`` order of the JAX
    package's RNNState: LSTM [actor_c, actor_h, critic_c, critic_h], GRU
    [actor, critic]."""
    out = []
    for part in state:
        out.extend(part if isinstance(part, tuple) else (part,))
    return out


def hidden_from_leaves(leaves, rnn_type: str) -> RNNState:
    """The inverse of :func:`hidden_leaves`."""
    if rnn_type == "gru":
        return RNNState(leaves[0], leaves[1])
    return RNNState((leaves[0], leaves[1]), (leaves[2], leaves[3]))


def reset_hidden(state: RNNState, done: torch.Tensor) -> RNNState:
    """Zero the hidden state of terminated envs (the reference's
    `hidden_states[..., dones] = 0`, rsl_rl utils), as a product with the
    float keep mask, as the JAX package computes it."""
    keep = (~done).float()

    def mask(x):
        return x * keep.reshape((-1,) + (1,) * (x.dim() - 1))

    return RNNState(*(tuple(map(mask, p)) if isinstance(p, tuple) else mask(p)
                      for p in state))


class RecurrentActorCritic(GaussianActorCritic):
    """LSTM/GRU memory + Gaussian MLP heads (actor_critic_recurrent.py).

    Call with ``(obs, rnn_state)`` for one step; the hidden state is carried
    by the caller and reset where ``done`` by :func:`reset_hidden`.  The
    cells are ``memory_a`` and ``memory_c`` as in the Flax module; the
    heads read the cells' outputs (width `rnn_hidden`).
    """

    def __init__(self, obs_dim: int, num_actions: int, rnn_hidden: int = 256,
                 rnn_type: str = "lstm",
                 actor_hidden: Sequence[int] = (256, 256, 256),
                 critic_hidden: Sequence[int] = (256, 256, 256),
                 activation: str = "elu", init_noise_std: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cuda"):
        super().__init__(rnn_hidden, num_actions, actor_hidden, critic_hidden,
                         activation, init_noise_std, generator=generator,
                         device=device)
        if rnn_type not in ("lstm", "gru"):
            raise ValueError(f"unknown rnn_type {rnn_type!r}; one of lstm|gru")
        cell = GRUCell if rnn_type == "gru" else LSTMCell
        self.rnn_type = rnn_type
        self.rnn_hidden = rnn_hidden
        self.memory_a = cell(obs_dim, rnn_hidden, device, generator)
        self.memory_c = cell(obs_dim, rnn_hidden, device, generator)

    def forward(self, obs: torch.Tensor, state: RNNState):
        a_state, a_feat = self.memory_a(state.actor, obs)
        c_state, c_feat = self.memory_c(state.critic, obs)
        mean = self._run(self.actor_layers, a_feat)
        value = self._run(self.critic_layers, c_feat)[..., 0]
        return (ACOutput(mean=mean, log_std=self.log_std, value=value),
                RNNState(a_state, c_state))

    def initial_state(self, batch: int) -> RNNState:
        dev = self.log_std.device
        if self.rnn_type == "gru":
            zero = torch.zeros(batch, self.rnn_hidden, device=dev)
            return RNNState(zero, zero.clone())
        return RNNState(*((torch.zeros(batch, self.rnn_hidden, device=dev),
                           torch.zeros(batch, self.rnn_hidden, device=dev))
                          for _ in range(2)))
