"""Hindsight Experience Replay over the off-policy learners (port of
``gennbv_tpu/algo/her.py``; stable_baselines3/her/).

Goal-conditioned transitions are relabeled at sample time with the
'future' strategy: a fraction of the sampled transitions get their desired
goal replaced by an achieved goal from a later step of the same episode,
and the reward is recomputed (her_replay_buffer.py semantics).

The buffer stores fixed-shape rounds of T env steps ``[E, T, ...]`` on the
device; episodes inside a round may end early (auto-reset envs), so each
slot also stores the per-step done flags and the index of the last step of
each step's episode segment.  Sampling draws (round, t, future offset,
relabel uniform) and relabels with gathers: the future goal is clamped to
t's own segment, so relabeling never crosses a reset.

Variable-length semantics: envs emit the pre-reset terminal observation
at a done step (the ReconEnv contract), so ``obs[t+1]`` of a terminal
transition is the true terminal obs.  The transition at the start of a
follow-on segment has a stale obs (the previous episode's terminal):
sampling shifts such indices forward within the segment.

Goal-conditioned env protocol (SB3's GoalEnv dict obs, flattened):
    obs = concat([observation, achieved_goal, desired_goal])
    env.goal_dim, env.compute_reward(achieved, desired) -> reward

As in ``algo/replay_buffer.py``, the arrays are written in place and
``pos``/``size`` are host ints; ``sample_relabeled`` is
``draw_relabel_indices`` then ``relabel``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from gennbv_tpu_torch.algo import replay_buffer as rb
from gennbv_tpu_torch.algo.off_policy import (OffPolicyConfig, OffPolicyLearner,
                                              random_actions)


class EpisodeBuffer(NamedTuple):
    obs: torch.Tensor       # [E, T+1, D] (T+1 so next_obs is obs[:, t+1])
    actions: torch.Tensor   # [E, T, A]
    done: torch.Tensor      # [E, T] {0,1}: the episode ended at this step
    terminal: torch.Tensor  # [E, T] {0,1}: done and not a timeout (gamma mask)
    seg_end: torch.Tensor   # [E, T] int32: last transition of t's episode
    pos: int                # next round slot
    size: int               # filled rounds


def init_episode_buffer(capacity_episodes: int, ep_len: int, obs_dim: int,
                        action_dim: int, device: torch.device | str = "cuda"
                        ) -> EpisodeBuffer:
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return EpisodeBuffer(
        obs=zeros(capacity_episodes, ep_len + 1, obs_dim),
        actions=zeros(capacity_episodes, ep_len, action_dim),
        done=zeros(capacity_episodes, ep_len),
        terminal=zeros(capacity_episodes, ep_len),
        seg_end=torch.full((capacity_episodes, ep_len), ep_len - 1,
                           dtype=torch.int32, device=device),
        pos=0, size=0)


def segment_ends(done_seq: torch.Tensor) -> torch.Tensor:
    """[N, T] {0,1} dones -> [N, T] int32 index of the last transition of
    the episode segment holding each step: the first done at or after the
    step, or T-1 where the round's end cuts the segment (the JAX reverse
    scan, as a reverse running minimum)."""
    t_len = done_seq.shape[-1]
    idx = torch.arange(t_len, dtype=torch.int32, device=done_seq.device)
    ends = torch.where(done_seq > 0.5, idx, t_len - 1).to(torch.int32)
    return torch.cummin(ends.flip(-1), dim=-1).values.flip(-1)


def add_episodes(buf: EpisodeBuffer, obs_seq: torch.Tensor,
                 act_seq: torch.Tensor, done_seq: Optional[torch.Tensor] = None,
                 timeout_seq: Optional[torch.Tensor] = None) -> EpisodeBuffer:
    """obs_seq [N, T+1, D], act_seq [N, T, A]: one T-step round per env,
    written in place at the ring position.

    done_seq/timeout_seq [N, T] mark in-round episode boundaries; omitted =
    fixed-length episodes (one segment per round, the legacy contract)."""
    n, t_plus1, _ = obs_seq.shape
    t_len = t_plus1 - 1
    e = buf.obs.shape[0]
    if e % n:
        raise ValueError(f"round capacity {e} is not a multiple of num_envs {n}")
    if done_seq is None:
        done_seq = torch.zeros((n, t_len), device=obs_seq.device)
        done_seq[:, -1] = 1.0
        timeout_seq = done_seq
    elif timeout_seq is None:
        timeout_seq = torch.zeros((n, t_len), device=obs_seq.device)
    done_seq = done_seq.float()
    terminal = done_seq * (1.0 - timeout_seq.float())
    rows = slice(buf.pos, buf.pos + n)
    for dst, x in ((buf.obs, obs_seq), (buf.actions, act_seq),
                   (buf.done, done_seq), (buf.terminal, terminal),
                   (buf.seg_end, segment_ends(done_seq))):
        dst[rows] = x.to(dst.dtype)
    return buf._replace(pos=(buf.pos + n) % e, size=min(buf.size + n, e))


@dataclass(frozen=True)
class HERConfig:
    future_fraction: float = 0.8   # SB3 n_sampled_goal=4 -> 4/5 relabeled
    goal_eps: float = 0.1          # success threshold used by fixtures


class RelabelDraws(NamedTuple):
    ep: torch.Tensor       # [B] rounds, uniform over the filled ones
    t: torch.Tensor        # [B] steps, uniform over [0, T)
    offset: torch.Tensor   # [B] future offsets, uniform over [1, T]
    u: torch.Tensor        # [B] uniform [0, 1): relabeled where < fraction


def draw_relabel_indices(size: int, batch_size: int, t_len: int,
                         generator: torch.Generator) -> RelabelDraws:
    dev = generator.device

    def randint(lo, hi):
        return torch.randint(lo, hi, (batch_size,), generator=generator,
                             device=dev)

    ep = randint(0, max(size, 1))
    t = randint(0, t_len)
    offset = randint(1, t_len + 1)
    return RelabelDraws(ep, t, offset,
                        torch.rand(batch_size, generator=generator, device=dev))


def relabel(buf: EpisodeBuffer, draws: RelabelDraws, goal_dim: int,
            compute_reward, her_cfg: HERConfig) -> rb.Batch:
    """The transitions of `draws`, a fraction relabeled with future
    achieved goals.  Obs layout: [..., core | achieved(goal_dim) |
    desired(goal_dim)]."""
    _, t_plus1, d = buf.obs.shape
    t_len = t_plus1 - 1
    ep, t = draws.ep, draws.t

    # a transition whose obs index sits right after an in-round done has
    # the previous episode's pre-reset terminal obs (stale): shift forward
    # within the new segment (two hops cover consecutive 1-step episodes);
    # any index still stale falls back to t = 0, which is always valid
    def stale(tt):
        return (tt > 0) & (buf.done[ep, torch.clamp(tt - 1, min=0)] > 0.5)

    t = torch.where(stale(t), torch.clamp(t + 1, max=t_len - 1), t)
    t = torch.where(stale(t), torch.clamp(t + 1, max=t_len - 1), t)
    t = torch.where(stale(t), 0, t)

    seg_end = buf.seg_end[ep, t].long()
    # the future achieved goal's obs index in (t, seg_end + 1] (obs
    # seg_end + 1 is the segment's terminal observation)
    fut = torch.minimum(t + draws.offset, seg_end + 1)

    obs = buf.obs[ep, t]
    next_obs = buf.obs[ep, t + 1]
    actions = buf.actions[ep, t]
    achieved_fut = buf.obs[ep, fut, d - 2 * goal_dim: d - goal_dim]

    relabeled = draws.u < her_cfg.future_fraction
    new_goal = torch.where(relabeled[:, None], achieved_fut,
                           obs[:, d - goal_dim:])
    obs[:, d - goal_dim:] = new_goal
    next_obs[:, d - goal_dim:] = new_goal

    achieved_next = next_obs[:, d - 2 * goal_dim: d - goal_dim]
    rewards = compute_reward(achieved_next, new_goal)
    # gamma mask: env-flagged true terminals cut the bootstrap; timeouts
    # (and round-truncated segments) bootstrap as usual
    return rb.Batch(obs=obs, actions=actions, rewards=rewards,
                    next_obs=next_obs, terminals=buf.terminal[ep, t])


def sample_relabeled(buf: EpisodeBuffer, generator: torch.Generator,
                     batch_size: int, goal_dim: int, compute_reward,
                     her_cfg: HERConfig) -> rb.Batch:
    draws = draw_relabel_indices(buf.size, batch_size, buf.obs.shape[1] - 1,
                                 generator)
    return relabel(buf, draws, goal_dim, compute_reward, her_cfg)


class HERRunner:
    """Off-policy training with HER relabeling on a goal-conditioned env.
    Each round resets the envs, collects ``ep_length`` steps (episodes may
    end early inside it, with auto-reset), writes the round, then takes
    ``updates_per_round`` gradient steps once the buffer holds
    ``learning_starts`` transitions.  One ``torch.Generator`` on the env's
    device, seeded once with `seed`, draws everything."""

    def __init__(self, env, off_cfg: OffPolicyConfig, her_cfg: HERConfig,
                 num_envs: int, capacity_episodes: int = 1024, seed: int = 0,
                 updates_per_round: int = 0):
        self.env = env
        self.cfg = off_cfg
        self.her = her_cfg
        self.num_envs = num_envs
        # gradient steps per collected round; 0 = ep_length (one per env
        # step, SB3's train_freq=1 analogue)
        self.updates_per_round = updates_per_round or env.ep_length
        self.device = torch.device(env.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.learner = OffPolicyLearner(off_cfg, env.obs_dim, env.num_actions,
                                        self.generator)
        self.buffer = init_episode_buffer(capacity_episodes, env.ep_length,
                                          env.obs_dim, env.num_actions,
                                          device=self.device)
        self.metrics: dict = {}      # the last gradient step's

    def _round(self, random_policy: bool) -> None:
        cfg, env, learner = self.cfg, self.env, self.learner
        env_state, out = env.reset(self.num_envs, self.generator)
        obs_seq, act_seq, done_seq, to_seq = [out.obs], [], [], []
        for _ in range(env.ep_length):
            obs = obs_seq[-1]
            if random_policy:
                actions = random_actions(self.generator,
                                         (self.num_envs, env.num_actions),
                                         cfg.max_action)
            else:
                actions = learner.explore(learner.state.actor_params, obs,
                                          self.generator)
            env_state, out = env.step(env_state, actions)
            obs_seq.append(out.obs)
            act_seq.append(actions)
            done_seq.append(out.done)
            to_seq.append(out.time_out)
        self.buffer = add_episodes(
            self.buffer, torch.stack(obs_seq, 1), torch.stack(act_seq, 1),
            torch.stack(done_seq, 1), torch.stack(to_seq, 1))
        if (self.buffer.size * env.ep_length >= cfg.learning_starts
                and not random_policy):
            for _ in range(self.updates_per_round):
                batch = sample_relabeled(self.buffer, self.generator,
                                         cfg.batch_size, env.goal_dim,
                                         env.compute_reward, self.her)
                learner.state, self.metrics = learner.draw_update(
                    learner.state, batch, self.generator)

    def learn(self, num_episrounds: int) -> None:
        for i in range(num_episrounds):
            self._round(i * self.num_envs * self.env.ep_length
                        < self.cfg.learning_starts)

    def exploit_policy(self):
        params = self.learner.state.actor_params
        return lambda obs: self.learner.exploit(params, obs)
