"""Off-policy continuous-control learners: SAC, TD3, DDPG (port of
``gennbv_tpu/algo/off_policy.py``; stable_baselines3/{sac,td3,ddpg}/).

One env step of the runner = {act, step the envs, ring-buffer write, one
gradient step on a sampled minibatch once the buffer holds
``learning_starts`` transitions}, all on the env's device.

Semantics per SB3, as the JAX learner keeps them:
- SAC: twin Q, min-target with the entropy bonus, where the target's
  action and log-prob come from the *online* actor and the temperature is
  the *old* ``alpha = exp(log_alpha)``; alpha learned against the target
  entropy ``-action_dim``; polyak targets.
- TD3: twin Q, the actor updated on gradient steps with
  ``step % policy_delay == 0``, target-policy smoothing noise clipped to
  ``noise_clip``.
- DDPG: one critic, no delay, no smoothing.
- The critic loss is ``sum(mean((q - target)**2))`` over the critics; the
  actor's loss reads the *new* critic parameters; the target actor
  follows only on steps where the actor was updated.
- Timeout transitions bootstrap (terminals exclude time_outs), SB3's
  handle_timeout_termination.

The optimizers are plain ``optax.adam`` (no clipping), the port's
written-out Adam (``algo/ppo.py``) for the actor, the critics and the
scalar ``log_alpha``.  ``OffPolicyLearner.update`` is a pure function of
(state, batch, target noise, policy noise): it returns a new state and
leaves its arguments as they were, so a test can feed it another
generator's draws.  The gradient-step counter is a host int, so TD3's
delay is a plain branch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch.func import functional_call

from gennbv_tpu_torch.algo import replay_buffer as rb
from gennbv_tpu_torch.algo.ppo import AdamState, Optimizer
from gennbv_tpu_torch.models.off_policy_nets import (DeterministicActor, QCritic,
                                                     SquashedGaussianActor,
                                                     squashed_sample)
from gennbv_tpu_torch.ops import fp32

ADAM_EPS = 1e-8          # optax.adam's default


@dataclass(frozen=True)
class OffPolicyConfig:
    algo: str = "sac"              # "sac" | "td3" | "ddpg"
    gamma: float = 0.99
    tau: float = 0.005             # polyak
    learning_rate: float = 3e-4
    batch_size: int = 256
    buffer_capacity: int = 131072
    train_freq: int = 1            # env steps per gradient step
    learning_starts: int = 1000
    max_action: float = 1.0
    # TD3
    policy_delay: int = 2
    target_noise: float = 0.2
    noise_clip: float = 0.5
    exploration_noise: float = 0.1
    # SAC
    init_alpha: float = 1.0
    autotune_alpha: bool = True


Params = dict[str, torch.Tensor]


class OffPolicyState(NamedTuple):
    actor_params: Params
    critic_params: Params
    target_actor_params: Params  # unused by SAC (kept for a uniform state)
    target_critic_params: Params
    actor_opt: AdamState
    critic_opt: AdamState
    log_alpha: torch.Tensor      # float32 scalar (SAC)
    alpha_opt: AdamState         # keyed "log_alpha"
    step: int                    # gradient steps taken (TD3's delay)


def copy_params(params: Params) -> Params:
    """A copy of each tensor, in one multi-tensor copy."""
    out = {k: torch.empty_like(v) for k, v in params.items()}
    torch._foreach_copy_(list(out.values()), list(params.values()))
    return out


def adam_step(opt: Optimizer, params: Params, grads, state: AdamState,
              grad_norm=None) -> tuple[Params, AdamState]:
    """``opt``'s step on copies of `params` and of `state`'s moments;
    `grads` in the order of `params`, `grad_norm` as ``Optimizer.apply_``
    takes it."""
    p, mu, nu = copy_params(params), copy_params(state.mu), copy_params(state.nu)
    count = opt.apply_(list(p.values()), list(grads), [mu[k] for k in p],
                       [nu[k] for k in p], state.count, grad_norm)
    return p, AdamState(mu, nu, count)


def requiring_grad(params: Params) -> Params:
    """Aliases of `params` that autograd differentiates."""
    return {k: v.detach().requires_grad_() for k, v in params.items()}


def random_actions(generator: torch.Generator, shape,
                   max_action: float) -> torch.Tensor:
    """Actions drawn uniformly in [-max_action, max_action)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (2.0 * max_action) - max_action


def _polyak(target: Params, online: Params, tau: float) -> Params:
    """``(1 - tau) * t + tau * o``, each product rounded."""
    keys = list(target)
    out = torch._foreach_mul([target[k] for k in keys], 1.0 - tau)
    torch._foreach_add_(out, torch._foreach_mul([online[k] for k in keys], tau))
    return dict(zip(keys, out))


class OffPolicyLearner:
    """The networks of one algorithm and its update, on `generator`'s
    device; initial weights drawn from `generator`."""

    def __init__(self, cfg: OffPolicyConfig, obs_dim: int, action_dim: int,
                 generator: torch.Generator):
        if cfg.algo not in ("sac", "td3", "ddpg"):
            raise ValueError(f"unknown algo {cfg.algo!r}; one of sac|td3|ddpg")
        fp32.deterministic_fp32()
        self.cfg = cfg
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.device = generator.device
        dev = dict(generator=generator, device=self.device)
        actor_cls = (SquashedGaussianActor if cfg.algo == "sac"
                     else DeterministicActor)
        # the modules give the forward passes; the state holds the tensors
        self.actor = actor_cls(obs_dim, action_dim, cfg.max_action, **dev)
        self.critic = QCritic(obs_dim, action_dim,
                              n_critics=1 if cfg.algo == "ddpg" else 2, **dev)
        self.target_entropy = -float(action_dim)
        self.opt = Optimizer(cfg.learning_rate, None, math.inf, ADAM_EPS)

        actor_params = {k: v.detach() for k, v in self.actor.named_parameters()}
        critic_params = {k: v.detach() for k, v in self.critic.named_parameters()}
        log_alpha = torch.log(torch.tensor(cfg.init_alpha, dtype=torch.float32,
                                           device=self.device))
        self.state = OffPolicyState(
            actor_params=actor_params, critic_params=critic_params,
            target_actor_params=copy_params(actor_params),
            target_critic_params=copy_params(critic_params),
            actor_opt=self.opt.init(self.actor),
            critic_opt=self.opt.init(self.critic),
            log_alpha=log_alpha,
            alpha_opt=AdamState({"log_alpha": torch.zeros_like(log_alpha)},
                                {"log_alpha": torch.zeros_like(log_alpha)}, 0),
            step=0)

    def _actor(self, params: Params, obs):
        return functional_call(self.actor, params, (obs,))

    def _critic(self, params: Params, obs, actions) -> tuple:
        return functional_call(self.critic, params, (obs, actions))

    def _normal(self, shape, generator: torch.Generator) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=self.device)

    # ---------------------------------------------------------------- act
    @torch.no_grad()
    def explore(self, params: Params, obs, generator: torch.Generator):
        cfg = self.cfg
        if cfg.algo == "sac":
            mean, log_std = self._actor(params, obs)
            a, _ = squashed_sample(mean, log_std,
                                   self._normal(mean.shape, generator),
                                   cfg.max_action)
            return a
        a = self._actor(params, obs)
        noise = (cfg.exploration_noise * cfg.max_action
                 * self._normal(a.shape, generator))
        return torch.clamp(a + noise, -cfg.max_action, cfg.max_action)

    @torch.no_grad()
    def exploit(self, params: Params, obs):
        if self.cfg.algo == "sac":
            mean, _ = self._actor(params, obs)
            return self.cfg.max_action * torch.tanh(mean)
        return self._actor(params, obs)

    # ------------------------------------------------------------- update
    def draw_noises(self, batch_size: int, generator: torch.Generator
                    ) -> tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """The standard-normal draws ``update`` reads: the target's
        (SAC's next action, TD3's smoothing) and the policy's (SAC)."""
        shape = (batch_size, self.action_dim)
        algo = self.cfg.algo
        return (None if algo == "ddpg" else self._normal(shape, generator),
                self._normal(shape, generator) if algo == "sac" else None)

    def draw_update(self, st: OffPolicyState, batch: rb.Batch,
                    generator: torch.Generator) -> tuple[OffPolicyState, dict]:
        """``update`` with its noises drawn from `generator`."""
        return self.update(st, batch,
                           *self.draw_noises(batch.obs.shape[0], generator))

    def update(self, st: OffPolicyState, batch: rb.Batch,
               noise_tgt: Optional[torch.Tensor],
               noise_pi: Optional[torch.Tensor]) -> tuple[OffPolicyState, dict]:
        """One gradient step; returns the new state and the metrics
        (device scalars)."""
        cfg = self.cfg
        sac = cfg.algo == "sac"
        alpha = torch.exp(st.log_alpha)

        # ----- targets
        with torch.no_grad():
            if sac:
                mean_n, log_std_n = self._actor(st.actor_params, batch.next_obs)
                a_next, logp_next = squashed_sample(mean_n, log_std_n, noise_tgt,
                                                    cfg.max_action)
            else:
                a_next = self._actor(st.target_actor_params, batch.next_obs)
                if cfg.algo == "td3":
                    noise = torch.clamp(cfg.target_noise * noise_tgt,
                                        -cfg.noise_clip,
                                        cfg.noise_clip) * cfg.max_action
                    a_next = torch.clamp(a_next + noise, -cfg.max_action,
                                         cfg.max_action)
            qs_next = self._critic(st.target_critic_params, batch.next_obs,
                                   a_next)
            q_next = (qs_next[0] if len(qs_next) == 1
                      else torch.minimum(*qs_next))
            if sac:
                q_next = q_next - alpha * logp_next
            target = batch.rewards + cfg.gamma * (1.0 - batch.terminals) * q_next

        # ----- critic step
        cp = requiring_grad(st.critic_params)
        qs = self._critic(cp, batch.obs, batch.actions)
        c_loss = sum(((q - target) ** 2).mean() for q in qs)
        q_mean = qs[0].detach().mean()
        c_grads = torch.autograd.grad(c_loss, list(cp.values()))
        critic_params, critic_opt = adam_step(self.opt, st.critic_params,
                                              c_grads, st.critic_opt)

        # ----- actor (+alpha) step, against the new critic
        do_actor = cfg.algo != "td3" or st.step % cfg.policy_delay == 0
        ap = requiring_grad(st.actor_params) if do_actor else st.actor_params
        with torch.set_grad_enabled(do_actor):
            if sac:
                mean, log_std = self._actor(ap, batch.obs)
                a, logp = squashed_sample(mean, log_std, noise_pi, cfg.max_action)
                qs_pi = self._critic(critic_params, batch.obs, a)
                q = qs_pi[0] if len(qs_pi) == 1 else torch.minimum(*qs_pi)
                a_loss = (alpha * logp - q).mean()
                logp_mean = logp.detach().mean()
            else:
                a = self._actor(ap, batch.obs)
                a_loss = -self._critic(critic_params, batch.obs, a)[0].mean()
        if do_actor:
            a_grads = torch.autograd.grad(a_loss, list(ap.values()))
            actor_params, actor_opt = adam_step(self.opt, st.actor_params,
                                                a_grads, st.actor_opt)
        else:
            actor_params, actor_opt = st.actor_params, st.actor_opt

        # ----- alpha step (SAC autotune): the gradient of
        # -log_alpha * (logp_mean + target_entropy)
        log_alpha, alpha_opt = st.log_alpha, st.alpha_opt
        if sac and cfg.autotune_alpha:
            grad = -(logp_mean + self.target_entropy)
            new, alpha_opt = adam_step(self.opt, {"log_alpha": st.log_alpha},
                                       [grad], st.alpha_opt)
            log_alpha = new["log_alpha"]

        # ----- polyak targets (the actor's only where it was updated)
        with torch.no_grad():
            target_critic_params = _polyak(st.target_critic_params,
                                           critic_params, cfg.tau)
            target_actor_params = (_polyak(st.target_actor_params, actor_params,
                                           cfg.tau) if do_actor
                                   else st.target_actor_params)

        new_state = OffPolicyState(
            actor_params=actor_params, critic_params=critic_params,
            target_actor_params=target_actor_params,
            target_critic_params=target_critic_params,
            actor_opt=actor_opt, critic_opt=critic_opt, log_alpha=log_alpha,
            alpha_opt=alpha_opt, step=st.step + 1)
        metrics = {"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach(),
                   "q_mean": q_mean, "alpha": torch.exp(log_alpha)}
        return new_state, metrics


class OffPolicyRunner:
    """The collect -> store -> sample -> update loop over an env with the
    contract of env/synthetic.py (``reset(num_envs, rng)``,
    ``step(state, actions)``, outputs with ``.obs/.reward/.done/
    .time_out``, a ``device``).  Every random draw (initial weights, env
    resets, actions, minibatches, noises) comes from one
    ``torch.Generator`` on the env's device, seeded once with `seed`."""

    def __init__(self, env, cfg: OffPolicyConfig, num_envs: int, seed: int = 0):
        self.env = env
        self.cfg = cfg
        self.num_envs = num_envs
        self.device = torch.device(env.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.learner = OffPolicyLearner(cfg, env.obs_dim, env.num_actions,
                                        self.generator)
        self.buffer = rb.init(cfg.buffer_capacity, env.obs_dim,
                              env.num_actions, device=self.device)
        self.metrics: dict = {}      # the last gradient step's

    def _chunk(self, env_state, obs, steps: int, random_policy: bool):
        """`steps` env steps, each with its gradient step once the buffer
        is ready (and the policy is not the random one); returns the env
        state, the last obs and the mean reward (a device scalar)."""
        cfg, learner = self.cfg, self.learner
        rews = []
        for _ in range(steps):
            if random_policy:
                actions = random_actions(self.generator,
                                         (self.num_envs, self.env.num_actions),
                                         cfg.max_action)
            else:
                actions = learner.explore(learner.state.actor_params, obs,
                                          self.generator)
            env_state, out = self.env.step(env_state, actions)
            self.buffer = rb.add_batch(self.buffer, obs, actions, out.reward,
                                       out.obs, out.done, out.time_out)
            if self.buffer.size >= cfg.learning_starts and not random_policy:
                batch = rb.sample(self.buffer, self.generator, cfg.batch_size)
                learner.state, self.metrics = learner.draw_update(
                    learner.state, batch, self.generator)
            rews.append(out.reward.mean())
            obs = out.obs
        return env_state, obs, torch.stack(rews).mean()

    def learn(self, total_steps: int, chunk: int = 64) -> float:
        """Env steps in chunks from a fresh reset (as the JAX runner does
        at every call); a chunk acts at random while the env steps taken
        before it number under ``learning_starts``.  Returns the last
        chunk's mean reward."""
        env_state, out = self.env.reset(self.num_envs, self.generator)
        obs = out.obs
        mean_rew = 0.0
        done_steps = 0
        while done_steps < total_steps:
            random_phase = done_steps * self.num_envs < self.cfg.learning_starts
            env_state, obs, mean_rew = self._chunk(env_state, obs, chunk,
                                                   random_phase)
            done_steps += chunk
        return float(mean_rew)

    def exploit_policy(self):
        """The deterministic policy of the actor's parameters as they are
        now."""
        params = self.learner.state.actor_params
        return lambda obs: self.learner.exploit(params, obs)
