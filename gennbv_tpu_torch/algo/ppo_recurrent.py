"""Recurrent PPO: BPTT over whole rollout trajectories (port of
``gennbv_tpu/algo/ppo_recurrent.py``).

The training path for ``models.actor_critic.RecurrentActorCritic``,
mirroring rsl_rl's recurrent mini-batch generator semantics
(rsl_rl/storage/rollout_storage.py:195, utils.py:34-68): minibatches are
formed over the ENV axis (whole trajectories, never shuffled in time), the
network is re-unrolled from the rollout's initial hidden state with
done-masked resets at the stored episode boundaries, and gradients flow
through the unroll (truncated BPTT over the rollout window).  One
permutation of the envs is drawn an update and its env groups are taken in
the same order every epoch.

Shares the adaptive-KL learning rate (``adapt_lr``), the clipped losses
and the optimizer (``Optimizer``: global-norm clip + the injected-lr Adam)
with ``ppo_continuous`` (same reference: rsl_rl/algorithms/ppo.py).
"""
from __future__ import annotations

import copy
import time
from typing import NamedTuple, Optional

import torch

from gennbv_tpu_torch.algo import gae as gae_lib
from gennbv_tpu_torch.algo import ppo_continuous as ppoc
from gennbv_tpu_torch.models import gaussian
from gennbv_tpu_torch.models.actor_critic import (RecurrentActorCritic,
                                                  RNNState, reset_hidden)
from gennbv_tpu_torch.ops import fp32
from gennbv_tpu_torch.utils.profiling import PhaseTimer


class RecurrentRollout(NamedTuple):
    obs: torch.Tensor        # [T, N, D]
    actions: torch.Tensor    # [T, N, A]
    rewards: torch.Tensor    # [T, N] (with the timeout bootstrap)
    dones: torch.Tensor      # [T, N] bool
    values: torch.Tensor     # [T, N]
    log_probs: torch.Tensor  # [T, N]
    means: torch.Tensor      # [T, N, A]
    init_hidden: RNNState    # hidden at rollout start (per env)
    last_value: torch.Tensor  # [N]
    log_std: torch.Tensor    # [A]


@torch.no_grad()
def collect(model: RecurrentActorCritic, env, env_state, obs,
            hidden: RNNState, generator: torch.Generator, n_steps: int,
            gamma: float):
    """n_steps of the env carrying the RNN state, reset where done; the
    actions' noise drawn from `generator`.  Returns (env_state, obs,
    hidden, RecurrentRollout)."""
    init_hidden = hidden
    rec = {k: [] for k in ("obs", "actions", "rewards", "dones", "values",
                           "log_probs", "means", "time_outs")}
    for _ in range(n_steps):
        out, hidden = model(obs, hidden)
        actions = gaussian.sample(out.mean, out.log_std, generator)
        logp = gaussian.log_prob(out.mean, out.log_std, actions)
        env_state, step_out = env.step(env_state, actions)
        hidden = reset_hidden(hidden, step_out.done)
        for k, v in (("obs", obs), ("actions", actions),
                     ("rewards", step_out.reward), ("dones", step_out.done),
                     ("values", out.value), ("log_probs", logp),
                     ("means", out.mean), ("time_outs", step_out.time_out)):
            rec[k].append(v)
        obs = step_out.obs
    b = {k: torch.stack(v) for k, v in rec.items()}
    last_out, _ = model(obs, hidden)
    # timeout bootstrap with V(s_t), rsl_rl semantics (ppo.py:109-121)
    rewards = b["rewards"] + gamma * b["values"] * b["time_outs"].float()
    roll = RecurrentRollout(
        obs=b["obs"], actions=b["actions"], rewards=rewards, dones=b["dones"],
        values=b["values"], log_probs=b["log_probs"], means=b["means"],
        init_hidden=init_hidden, last_value=last_out.value,
        log_std=last_out.log_std.detach().clone())
    return env_state, obs, hidden, roll


def env_groups(cfg: ppoc.ContinuousPPOConfig, n: int,
               generator: torch.Generator) -> torch.Tensor:
    """[epochs * num_mini_batches, n / num_mini_batches] env indices: one
    permutation of the n envs cut into groups, the same groups in the same
    order every epoch."""
    mb_envs = n // cfg.num_mini_batches
    if mb_envs * cfg.num_mini_batches != n:
        raise ValueError("num_envs must divide by num_mini_batches")
    perm = torch.randperm(n, generator=generator, device=generator.device)
    return perm.reshape(cfg.num_mini_batches, mb_envs).repeat(
        cfg.num_learning_epochs, 1)


def _take_hidden(h: RNNState, idx: torch.Tensor) -> RNNState:
    return RNNState(*(tuple(x[idx] for x in p) if isinstance(p, tuple)
                      else p[idx] for p in h))


def _loss(model, cfg: ppoc.ContinuousPPOConfig, old_log_std, mb: dict):
    """The loss of one minibatch of whole trajectories, re-unrolled from
    its initial hidden state, and its detached [4] (surrogate, value loss,
    entropy, KL)."""
    hidden = mb["h0"]
    means, values = [], []
    for t in range(mb["obs"].shape[0]):
        out, hidden = model(mb["obs"][t], hidden)
        hidden = reset_hidden(hidden, mb["dones"][t])
        means.append(out.mean)
        values.append(out.value)
    mean, value, log_std = torch.stack(means), torch.stack(values), out.log_std
    logp = gaussian.log_prob(mean, log_std, mb["actions"])
    ent = gaussian.entropy(log_std, mb["actions"]).mean()

    ratio = torch.exp(logp - mb["old_log_probs"])
    surr1 = -mb["advantages"] * ratio
    surr2 = -mb["advantages"] * torch.clamp(ratio, 1.0 - cfg.clip_param,
                                            1.0 + cfg.clip_param)
    surrogate = torch.maximum(surr1, surr2).mean()

    old_values = mb["old_values"]
    v_clipped = old_values + torch.clamp(value - old_values, -cfg.clip_param,
                                         cfg.clip_param)
    value_loss = torch.maximum((value - mb["returns"]) ** 2,
                               (v_clipped - mb["returns"]) ** 2).mean()

    loss = surrogate + cfg.value_loss_coef * value_loss - cfg.entropy_coef * ent
    with torch.no_grad():
        kl = gaussian.kl(mb["old_mean"], old_log_std, mean, log_std)
    return loss, torch.stack([surrogate.detach(), value_loss.detach(),
                              ent.detach(), kl])


def update(model: RecurrentActorCritic, opt: ppoc.Optimizer,
           cfg: ppoc.ContinuousPPOConfig, state: ppoc.ContinuousOptState,
           roll: RecurrentRollout, generator: Optional[torch.Generator] = None,
           groups: Optional[torch.Tensor] = None):
    """Epochs x env-axis minibatches of whole trajectories, BPTT unroll.
    Changes the model's parameters and the moments of `state` in place and
    returns (the state with its new count and learning rate, the
    ContinuousUpdateMetrics).  `groups` (``env_groups``) fixes the
    minibatches; without it they are drawn from `generator`."""
    fp32.deterministic_fp32()
    t, n = roll.rewards.shape
    adv, ret = gae_lib.compute_gae(roll.rewards, roll.values, roll.dones,
                                   roll.last_value, cfg.gamma, cfg.lam)
    # the population std, as jnp.std's
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    if groups is None:
        groups = env_groups(cfg, n, generator)
    groups = groups.to(roll.rewards.device)

    names, params = zip(*model.named_parameters())
    params = list(params)
    mu = [state.mu[k] for k in names] if opt.kind == "adam" else []
    nu = [state.nu[k] for k in names]
    count, lr = state.count, state.learning_rate
    per_env = {"obs": roll.obs, "actions": roll.actions,
               "old_log_probs": roll.log_probs, "old_values": roll.values,
               "old_mean": roll.means, "advantages": adv, "returns": ret,
               "dones": roll.dones}
    sums = torch.zeros(4, device=roll.rewards.device)
    for idx in groups:
        mb = {k: v[:, idx] for k, v in per_env.items()}
        mb["h0"] = _take_hidden(roll.init_hidden, idx)
        loss, stats = _loss(model, cfg, roll.log_std, mb)
        grads = torch.autograd.grad(loss, params)
        if cfg.desired_kl is not None:
            lr = ppoc.adapt_lr(cfg, lr, stats[3])
        count = opt.apply_(params, list(grads), mu, nu, count, lr)
        sums = sums + stats
    means = sums / groups.shape[0]
    metrics = ppoc.ContinuousUpdateMetrics(*means, learning_rate=lr)
    return ppoc.ContinuousOptState(state.mu, state.nu, count, lr), metrics


# the metrics of an iteration, in the JAX runner's names
METRIC_KEYS = ("mean_reward", "mean_kl", "learning_rate", "entropy")


class RecurrentOnPolicyRunner:
    """OnPolicyRunner variant for the LSTM/GRU actor-critic.  Every random
    draw (initial weights, env resets, actions, the env permutation) comes
    from one ``torch.Generator`` on the env's device, seeded once with
    `seed`.  Like the JAX runner it keeps no checkpoints or log files."""

    def __init__(self, env, alg_cfg: ppoc.ContinuousPPOConfig,
                 num_steps_per_env: int, num_envs: int, seed: int = 1,
                 rnn_hidden: int = 256, rnn_type: str = "lstm",
                 actor_hidden=(256,), critic_hidden=(256,)):
        self.env = env
        self.cfg = alg_cfg
        self.n_steps = num_steps_per_env
        self.num_envs = num_envs
        self.device = torch.device(env.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model = RecurrentActorCritic(
            env.obs_dim, env.num_actions, rnn_hidden=rnn_hidden,
            rnn_type=rnn_type, actor_hidden=tuple(actor_hidden),
            critic_hidden=tuple(critic_hidden), generator=self.generator,
            device=self.device)
        self.opt = ppoc.make_optimizer(alg_cfg)
        self.opt_state = self.opt.init(self.model)
        self.iteration = 0
        self.timer = PhaseTimer()
        # one record an iteration: its metrics and phase seconds
        self.logged: list[dict] = []

    def variables(self) -> dict:
        """The model's parameters by name."""
        return self.model.state_dict()

    def _iteration(self, env_state, obs, hidden):
        """One iteration; returns (env_state, obs, hidden, metrics [4] on
        the device, in METRIC_KEYS order)."""
        with self.timer.phase("rollout", self.device):
            env_state, obs, hidden, roll = collect(
                self.model, self.env, env_state, obs, hidden, self.generator,
                self.n_steps, self.cfg.gamma)
        with self.timer.phase("update", self.device):
            self.opt_state, um = update(self.model, self.opt, self.cfg,
                                        self.opt_state, roll, self.generator)
        metrics = torch.stack([roll.rewards.mean(), um.mean_kl,
                               um.learning_rate, um.entropy])
        return env_state, obs, hidden, metrics

    def learn(self, num_iterations: int, log: bool = False) -> dict:
        """num_iterations iterations from a fresh reset of the envs and a
        zero hidden state (as the JAX runner does at every call); with
        `log`, prints each iteration's metrics and phase seconds.  Each
        iteration's record goes to ``self.logged``.  Returns the last
        iteration's metrics."""
        env_state, out = self.env.reset(self.num_envs, self.generator)
        obs = out.obs
        hidden = self.model.initial_state(self.num_envs)
        metrics = {}
        for _ in range(num_iterations):
            self.timer.reset()
            t0 = time.perf_counter()
            env_state, obs, hidden, dev = self._iteration(env_state, obs, hidden)
            metrics = dict(zip(METRIC_KEYS, dev.tolist()))
            secs = time.perf_counter() - t0
            self.iteration += 1
            rec = {"step": self.iteration, **metrics, **self.timer.metrics(),
                   "time/iter_seconds": secs,
                   "time/fps": self.n_steps * self.num_envs / secs}
            self.logged.append(rec)
            if log:
                print(f"it {self.iteration:5d} | rew {metrics['mean_reward']:+.4f}"
                      f" | kl {metrics['mean_kl']:.4f} | "
                      f"lr {metrics['learning_rate']:.2e} | {secs:.3f} s "
                      f"(rollout {rec['time/rollout']:.3f} s, update "
                      f"{rec['time/update']:.3f} s) | {rec['time/fps']:,.0f} "
                      "steps/s", flush=True)
        return metrics

    def get_inference_policy(self):
        """(obs, hidden) -> (mean action, hidden'): the deterministic actor
        of the parameters as they are now."""
        model = copy.deepcopy(self.model)

        @torch.no_grad()
        def policy(obs, hidden):
            out, hidden = model(obs, hidden)
            return out.mean, hidden

        return policy
