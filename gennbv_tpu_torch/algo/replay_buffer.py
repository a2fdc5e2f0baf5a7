"""Device-resident ring replay buffer for the off-policy family (port of
``gennbv_tpu/algo/replay_buffer.py``; SB3's ReplayBuffer,
stable_baselines3/common/buffers.py:152).

A fixed-capacity set of tensors on the env's device: ``add_batch`` writes
a whole env batch at the ring position, ``sample`` gathers a uniform
minibatch.  Capacity is in transitions and must be a multiple of the env
batch, so a write never straddles the wrap point; the env axis is
flattened into the ring.

The arrays are written in place; ``pos`` and ``size`` are host ints, as
each write advances them by the batch size alone, so a runner decides
``learning_starts`` without reading anything back from the device.
``sample`` is ``draw_indices`` then ``gather``, so a test can feed the
indices of another generator.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ReplayState(NamedTuple):
    obs: torch.Tensor        # [C, D]
    actions: torch.Tensor    # [C, A] (float32 continuous, int32 discrete)
    rewards: torch.Tensor    # [C]
    next_obs: torch.Tensor   # [C, D]
    # 1.0 where the episode truly ended (timeouts excluded: the target
    # bootstraps through timeouts, SB3's handle_timeout_termination)
    terminals: torch.Tensor  # [C]
    pos: int                 # next write slot
    size: int                # filled slots


def init(capacity: int, obs_dim: int, action_dim: int,
         action_dtype: torch.dtype = torch.float32,
         device: torch.device | str = "cuda") -> ReplayState:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ReplayState(obs=zeros(capacity, obs_dim),
                       actions=zeros(capacity, action_dim, dtype=action_dtype),
                       rewards=zeros(capacity),
                       next_obs=zeros(capacity, obs_dim),
                       terminals=zeros(capacity), pos=0, size=0)


def add_batch(rb: ReplayState, obs, actions, rewards, next_obs, dones,
              time_outs: Optional[torch.Tensor] = None) -> ReplayState:
    """Writes one env batch of transitions at the ring position (in place)
    and returns the buffer with the advanced position and size."""
    n = obs.shape[0]
    c = rb.obs.shape[0]
    if c % n:
        raise ValueError(f"capacity {c} is not a multiple of the env batch {n}")
    terminals = dones.float()
    if time_outs is not None:
        terminals = terminals * (1.0 - time_outs.float())
    rows = slice(rb.pos, rb.pos + n)
    for buf, x in ((rb.obs, obs), (rb.actions, actions), (rb.rewards, rewards),
                   (rb.next_obs, next_obs), (rb.terminals, terminals)):
        buf[rows] = x.to(buf.dtype)
    return rb._replace(pos=(rb.pos + n) % c, size=min(rb.size + n, c))


class Batch(NamedTuple):
    obs: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    next_obs: torch.Tensor
    terminals: torch.Tensor


def draw_indices(size: int, batch_size: int,
                 generator: torch.Generator) -> torch.Tensor:
    """`batch_size` slots drawn uniformly from the `size` filled ones, on
    the generator's device."""
    return torch.randint(0, max(size, 1), (batch_size,), generator=generator,
                         device=generator.device)


def gather(rb: ReplayState, idx: torch.Tensor) -> Batch:
    return Batch(obs=rb.obs[idx], actions=rb.actions[idx],
                 rewards=rb.rewards[idx], next_obs=rb.next_obs[idx],
                 terminals=rb.terminals[idx])


def sample(rb: ReplayState, generator: torch.Generator,
           batch_size: int) -> Batch:
    return gather(rb, draw_indices(rb.size, batch_size, generator))
