"""Synthetic fixture environments: the SB3 fake-env pattern (port of
``gennbv_tpu/env/synthetic.py``).

The reference vendors SB3's test fixtures (stable_baselines3/common/envs/:
IdentityEnv, IdentityEnvBox, IdentityEnvMultiDiscrete, ...) without tests.
These are their batched counterparts, used for PPO learnability tests and
by the env-contract check.  Each follows the contract of ReconEnv:

    state, out = env.reset(num_envs, rng)     # rng: a torch.Generator
    state, out = env.step(state, actions)

with fixed-shape outputs (obs, reward, done, time_out) on ``env.device``.
The state carries its own random state (``utils/rng.py``), so a step is a
function of (state, actions) alone.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from gennbv_tpu_torch.utils import rng as rng_lib


class SynthState(NamedTuple):
    target: torch.Tensor       # [N, D]
    episode_len: torch.Tensor  # [N] int32
    rng: torch.Tensor          # the step's generator state


class SynthOutput(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    time_out: torch.Tensor


class _Synth:
    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)

    def _uniform(self, g: torch.Generator, shape) -> torch.Tensor:
        """uniform(-1, 1) draws of `shape` from `g`."""
        return torch.rand(shape, generator=g, device=self.device) * 2.0 - 1.0

    def _first(self, num_envs: int, obs: torch.Tensor) -> SynthOutput:
        zeros = torch.zeros(num_envs, device=self.device)
        no = torch.zeros(num_envs, dtype=torch.bool, device=self.device)
        return SynthOutput(obs, zeros, no, no)


class IdentityEnvMultiDiscrete(_Synth):
    """Observation = one-hot of the current target per component; reward 1
    for matching it (SB3 IdentityEnvMultiDiscrete semantics).  The optimal
    policy copies the obs -> reward rate 1.0."""

    def __init__(self, nvec=(4, 4), ep_length: int = 10,
                 device: torch.device | str = "cuda"):
        super().__init__(device)
        self.nvec = tuple(nvec)
        self.ep_length = ep_length
        self.num_actions = len(self.nvec)
        self.obs_dim = sum(self.nvec)

    def _obs(self, target):
        parts = [F.one_hot(target[:, i].long(), n).float()
                 for i, n in enumerate(self.nvec)]
        return torch.cat(parts, dim=-1)

    def _sample_target(self, g, num_envs):
        cols = [torch.randint(0, n, (num_envs,), generator=g, device=self.device)
                for n in self.nvec]
        return torch.stack(cols, dim=-1).to(torch.int32)

    def reset(self, num_envs: int, rng: torch.Generator):
        target = self._sample_target(rng, num_envs)
        state = SynthState(
            target=target,
            episode_len=torch.zeros(num_envs, dtype=torch.int32,
                                    device=self.device),
            rng=rng_lib.fork(rng))
        return state, self._first(num_envs, self._obs(target))

    def step(self, state: SynthState, actions: torch.Tensor):
        match = torch.all(actions == state.target, dim=-1)
        reward = match.float()
        episode_len = state.episode_len + 1
        done = episode_len >= self.ep_length
        g = rng_lib.restore(state.rng, self.device)
        new_target = self._sample_target(g, done.shape[0])
        # SB3's IdentityEnv keeps the target fixed within the episode
        target = torch.where(done[:, None], new_target, state.target)
        state = SynthState(target=target,
                           episode_len=torch.where(done, 0, episode_len),
                           rng=g.get_state())
        return state, SynthOutput(self._obs(target), reward, done, done)


class PointGoalEnv(_Synth):
    """Continuous-control fixture: a point in R^D, action = displacement,
    reward = -||pos||; learnable by Gaussian PPO in a few iterations
    (optimal deterministic policy: action = -pos, exactly linear).  The
    continuous analog of SB3's IdentityEnvBox fixture.

    Actions are NOT clipped: a hard clip makes pushing the mean past the
    boundary free under the executed dynamics, which rewards unbounded
    means and degrades the sampled return.
    """

    def __init__(self, dim: int = 2, ep_length: int = 32,
                 device: torch.device | str = "cuda"):
        super().__init__(device)
        self.dim = dim
        self.ep_length = ep_length
        self.num_actions = dim
        self.obs_dim = dim

    def reset(self, num_envs: int, rng: torch.Generator):
        pos = self._uniform(rng, (num_envs, self.dim))
        state = SynthState(
            target=pos,
            episode_len=torch.zeros(num_envs, dtype=torch.int32,
                                    device=self.device),
            rng=rng_lib.fork(rng))
        return state, self._first(num_envs, pos)

    def step(self, state: SynthState, actions: torch.Tensor):
        pos = state.target + actions
        reward = -torch.linalg.vector_norm(pos, dim=-1)
        episode_len = state.episode_len + 1
        done = episode_len >= self.ep_length
        g = rng_lib.restore(state.rng, self.device)
        new_pos = self._uniform(g, pos.shape)
        pos = torch.where(done[:, None], new_pos, pos)
        state = SynthState(target=pos,
                           episode_len=torch.where(done, 0, episode_len),
                           rng=g.get_state())
        return state, SynthOutput(pos, reward, done, done)


class GoalPointEnv(_Synth):
    """Sparse-reward goal task: the point moves by the action; reward 0 iff
    within goal_eps of the desired goal, else -1.  obs = [pos | pos | goal]
    (core == achieved here).  Plain off-policy RL gets almost no signal;
    HER relabeling makes it learnable.

    Emits the PRE-reset observation at a done step (the ReconEnv contract);
    with ``terminate_on_success`` episodes end early on goal reach, giving
    variable-length episodes inside a fixed-shape rollout.  The state is
    (pos, goal, episode_len, rng)."""

    def __init__(self, dim: int = 2, ep_length: int = 8, goal_eps: float = 0.1,
                 terminate_on_success: bool = False,
                 device: torch.device | str = "cuda"):
        super().__init__(device)
        self.dim = dim
        self.ep_length = ep_length
        self.goal_eps = goal_eps
        self.terminate_on_success = terminate_on_success
        self.num_actions = dim
        self.goal_dim = dim
        self.obs_dim = 3 * dim

    def compute_reward(self, achieved, desired):
        d = torch.linalg.vector_norm(achieved - desired, dim=-1)
        return torch.where(d < self.goal_eps, 0.0, -1.0)

    def _obs(self, pos, goal):
        return torch.cat([pos, pos, goal], dim=-1)

    def reset(self, num_envs: int, rng: torch.Generator):
        pos = self._uniform(rng, (num_envs, self.dim))
        goal = self._uniform(rng, (num_envs, self.dim))
        state = (pos, goal,
                 torch.zeros(num_envs, dtype=torch.int32, device=self.device),
                 rng_lib.fork(rng))
        return state, self._first(num_envs, self._obs(pos, goal))

    def step(self, state, actions):
        pos, goal, ep_len, rng = state
        pos = pos + 0.25 * torch.clamp(actions, -1, 1)
        reward = self.compute_reward(pos, goal)
        ep_len = ep_len + 1
        time_out = ep_len >= self.ep_length
        success = reward == 0.0
        done = time_out | (success if self.terminate_on_success
                           else torch.zeros_like(time_out))
        obs = self._obs(pos, goal)  # PRE-reset observation
        g = rng_lib.restore(rng, self.device)
        new_pos = self._uniform(g, pos.shape)
        new_goal = self._uniform(g, goal.shape)
        pos = torch.where(done[:, None], new_pos, pos)
        goal = torch.where(done[:, None], new_goal, goal)
        state = (pos, goal, torch.where(done, 0, ep_len), g.get_state())
        return state, SynthOutput(obs, reward, done, time_out & done)
