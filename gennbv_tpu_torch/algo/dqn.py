"""DQN: discrete off-policy Q-learning with a target network (port of
``gennbv_tpu/algo/dqn.py``; stable_baselines3/dqn/).

A single-discrete action head over an env with ``nvec == (n,)``;
epsilon-greedy exploration with a linear decay over env steps; the Huber
loss (optax's ``huber_loss``, delta 1), ``clip_by_global_norm`` then Adam
(``algo/ppo.py``'s ``Optimizer``, the clip a select on the device); a hard
target sync every ``target_update_interval`` gradient steps.  The env and
gradient step counters are host ints, so epsilon and the sync are decided
on the host without reading the device.

The Q of the taken action is a product with the action's one-hot, not a
gather: exact in the forward pass, and its backward pass is a product too,
where a gather's backward would add into Q's gradient with atomics, in an
order that changes from run to run on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from gennbv_tpu_torch.algo import replay_buffer as rb
from gennbv_tpu_torch.algo.off_policy import (ADAM_EPS, Params, adam_step,
                                              copy_params, requiring_grad)
from gennbv_tpu_torch.algo.ppo import AdamState, Optimizer, global_norm
from gennbv_tpu_torch.models.off_policy_nets import DiscreteQNet
from gennbv_tpu_torch.ops import fp32


@dataclass(frozen=True)
class DQNConfig:
    gamma: float = 0.99
    learning_rate: float = 1e-3
    batch_size: int = 128
    buffer_capacity: int = 65536
    learning_starts: int = 500
    target_update_interval: int = 250    # gradient steps between hard syncs
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 5000          # env steps to reach eps_end
    max_grad_norm: float = 10.0


class DQNState(NamedTuple):
    params: Params
    target_params: Params
    opt_state: AdamState
    grad_steps: int
    env_steps: int


def huber_loss(predictions: torch.Tensor, targets: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    """optax's ``huber_loss``: ``0.5 * min(|e|, delta)**2 + delta * (|e| -
    min(|e|, delta))`` elementwise."""
    abs_errors = torch.abs(predictions - targets)
    quadratic = torch.clamp(abs_errors, max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_errors - quadratic)


class DQNRunner:
    def __init__(self, env, cfg: DQNConfig, num_envs: int, seed: int = 0):
        nvec = tuple(int(x) for x in env.nvec)
        if len(nvec) != 1:
            raise ValueError("DQN supports single-discrete action spaces")
        fp32.deterministic_fp32()
        self.n_actions = nvec[0]
        self.env = env
        self.cfg = cfg
        self.num_envs = num_envs
        self.device = torch.device(env.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.q = DiscreteQNet(env.obs_dim, self.n_actions,
                              generator=self.generator, device=self.device)
        self.opt = Optimizer(cfg.learning_rate, None, cfg.max_grad_norm,
                             ADAM_EPS)
        params = {k: v.detach() for k, v in self.q.named_parameters()}
        self.state = DQNState(params, copy_params(params), self.opt.init(self.q),
                              0, 0)
        self.buffer = rb.init(cfg.buffer_capacity, env.obs_dim, 1, torch.int32,
                              device=self.device)

    def _q(self, params: Params, obs) -> torch.Tensor:
        return functional_call(self.q, params, (obs,))

    def _eps(self, env_steps: int) -> float:
        """Epsilon after `env_steps` env steps, in float32 as XLA compiles
        the JAX runner's: the steps as float32 times the float32
        reciprocal of the decay steps, clipped to [0, 1], then ``eps_start
        + frac * (eps_end - eps_start)`` as one fused multiply-add."""
        cfg = self.cfg
        recip = np.float32(1) / np.float32(cfg.eps_decay_steps)
        frac = np.clip(np.float32(env_steps) * recip, np.float32(0),
                       np.float32(1))
        return fp32.f32(float(frac) * fp32.f32(cfg.eps_end - cfg.eps_start)
                        + fp32.f32(cfg.eps_start))

    def update(self, st: DQNState, batch: rb.Batch) -> DQNState:
        """One gradient step and the sync where it is due; a pure function
        of its arguments."""
        cfg = self.cfg
        with torch.no_grad():
            q_next = self._q(st.target_params, batch.next_obs)
            target = (batch.rewards + cfg.gamma * (1.0 - batch.terminals)
                      * q_next.max(-1).values)
        p = requiring_grad(st.params)
        q = self._q(p, batch.obs)
        onehot = F.one_hot(batch.actions[:, 0].long(), self.n_actions).to(q.dtype)
        q_a = (q * onehot).sum(-1)
        loss = huber_loss(q_a, target).mean()
        grads = torch.autograd.grad(loss, list(p.values()))
        params, opt_state = adam_step(self.opt, st.params, grads, st.opt_state,
                                      global_norm(grads))
        grad_steps = st.grad_steps + 1
        target_params = (copy_params(params)
                         if grad_steps % cfg.target_update_interval == 0
                         else st.target_params)
        return DQNState(params, target_params, opt_state, grad_steps,
                        st.env_steps)

    @torch.no_grad()
    def _act(self, obs, env_steps: int) -> torch.Tensor:
        """Epsilon-greedy actions [N, 1] int32."""
        greedy = self._q(self.state.params, obs).argmax(-1)
        rand = torch.randint(0, self.n_actions, greedy.shape,
                             generator=self.generator, device=self.device)
        take_rand = torch.rand(greedy.shape, generator=self.generator,
                               device=self.device) < self._eps(env_steps)
        return torch.where(take_rand, rand, greedy)[:, None].to(torch.int32)

    def _chunk(self, env_state, obs, steps: int):
        cfg = self.cfg
        rews = []
        for _ in range(steps):
            actions = self._act(obs, self.state.env_steps)
            env_state, out = self.env.step(env_state, actions)
            self.buffer = rb.add_batch(self.buffer, obs, actions, out.reward,
                                       out.obs, out.done, out.time_out)
            self.state = self.state._replace(
                env_steps=self.state.env_steps + self.num_envs)
            if self.buffer.size >= cfg.learning_starts:
                batch = rb.sample(self.buffer, self.generator, cfg.batch_size)
                self.state = self.update(self.state, batch)
            rews.append(out.reward.mean())
            obs = out.obs
        return env_state, obs, torch.stack(rews).mean()

    def learn(self, total_steps: int, chunk: int = 64) -> float:
        """Env steps in chunks from a fresh reset (as the JAX runner does
        at every call); returns the last chunk's mean reward."""
        env_state, out = self.env.reset(self.num_envs, self.generator)
        obs = out.obs
        mean_rew, done = 0.0, 0
        while done < total_steps:
            env_state, obs, mean_rew = self._chunk(env_state, obs, chunk)
            done += chunk
        return float(mean_rew)

    def greedy_policy(self):
        params = self.state.params

        @torch.no_grad()
        def policy(obs):
            return self._q(params, obs).argmax(-1)[:, None]
        return policy
