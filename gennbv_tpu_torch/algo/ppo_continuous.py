"""Continuous-action PPO with an adaptive-KL learning rate: the rsl_rl
algorithm family (port of ``gennbv_tpu/algo/ppo_continuous.py``;
rsl_rl/algorithms/ppo.py).

Differences from the discrete learner in ``algo/ppo.py``:
- diagonal-Gaussian policy (``models/gaussian.py``) instead of
  MultiCategorical;
- **adaptive learning rate** from the exact Gaussian KL: per minibatch,
  lr /= 1.5 if kl > 2 * desired_kl, lr *= 1.5 if 0 < kl < desired_kl / 2,
  clamped to [min_lr, max_lr], before the step
  (rsl_rl/algorithms/ppo.py:147-163).  The learning rate is a float32
  tensor on the device, as optax's injected hyperparameter is, so each
  change rounds in float32 and the update never waits on the host;
- advantage normalization over the whole rollout (by the runner) rather
  than per minibatch;
- loss = surrogate + vf_coef * value_loss - ent_coef * entropy (no x10);
- one permutation of the rollout shared by every epoch
  (rollout_storage.py:160-165).

The optimizer is what the JAX package's ``make_optimizer`` builds,
``chain(clip_by_global_norm, inject_hyperparams(adam | rmsprop))``,
written out.  ``inject_hyperparams`` turns every hyperparameter (b1, b2,
eps, decay, ...) into a float32 array, so ``1 - b1`` rounds in float32
here, unlike in the discrete learner's plain chain.  The RMSprop is
optax's with ``initial_scale=1``: the mean square starts at 1 and the step
is ``g * rsqrt(nu + eps)``.  ``torch.optim.RMSprop`` starts at 0 and
divides by ``sqrt(v) + eps``, which is another optimizer.

The timeout bootstrap (``rew += gamma * V * time_outs``,
rsl_rl/algorithms/ppo.py:109-121) is the runner's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from gennbv_tpu_torch.algo.ppo import global_norm
from gennbv_tpu_torch.models import gaussian
from gennbv_tpu_torch.ops import fp32


@dataclass(frozen=True)
class ContinuousPPOConfig:
    """Defaults = rsl_rl LeggedRobotCfgPPO.algorithm
    (legged_robot_config.py:241-284)."""
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    clip_param: float = 0.2
    gamma: float = 0.99
    lam: float = 0.95
    value_loss_coef: float = 1.0
    entropy_coef: float = 0.01
    learning_rate: float = 1e-3
    desired_kl: Optional[float] = 0.01
    max_grad_norm: float = 1.0
    use_clipped_value_loss: bool = True
    min_lr: float = 1e-5
    max_lr: float = 1e-2
    optimizer: str = "adam"   # "adam" | "rmsprop" (A2C uses rmsprop)


def a2c_config(learning_rate: float = 7e-4, **kw) -> ContinuousPPOConfig:
    """A2C as the degenerate PPO (SB3 docs: 'A2C is a special case of PPO'):
    one pass over the rollout, no ratio clipping (a large finite clip, as
    an infinite one would change the value clip too), no KL adaptation,
    RMSprop (stable_baselines3/a2c/a2c.py defaults)."""
    return ContinuousPPOConfig(
        num_learning_epochs=1, num_mini_batches=1, clip_param=100.0,
        desired_kl=None, learning_rate=learning_rate,
        use_clipped_value_loss=False, optimizer="rmsprop", **kw)


class ContinuousOptState(NamedTuple):
    """The optimizer's state, keyed by parameter name as
    ``named_parameters`` gives them."""
    mu: dict[str, torch.Tensor]   # Adam's first moments ({} under RMSprop)
    nu: dict[str, torch.Tensor]   # Adam's second moments / RMSprop's mean square
    count: int                    # applied updates
    learning_rate: torch.Tensor   # float32 scalar on the parameters' device


# the hyperparameters of the JAX package's make_optimizer: optax's Adam
# defaults, and the TF-style RMSprop (decay 0.99, eps 1e-5, mean square
# starting at 1) that keeps A2C's first steps small
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RMS_DECAY, RMS_EPS, RMS_INITIAL_SCALE = 0.99, 1e-5, 1.0


def _one_minus(x: float) -> float:
    """1 - x in float32, as ``1 - decay`` of an injected float32
    hyperparameter rounds."""
    return fp32.f32(np.float32(1) - np.float32(x))


@dataclass(frozen=True)
class Optimizer:
    """``chain(clip_by_global_norm(max_grad_norm),
    inject_hyperparams(adam | rmsprop)(learning_rate))``."""
    kind: str            # "adam" | "rmsprop"
    learning_rate: float
    max_grad_norm: float

    def init(self, model: torch.nn.Module) -> ContinuousOptState:
        named = list(model.named_parameters())
        dev = named[0][1].device
        if self.kind == "adam":
            mu = {n: torch.zeros_like(p) for n, p in named}
            nu = {n: torch.zeros_like(p) for n, p in named}
        else:
            mu = {}
            nu = {n: torch.full_like(p, RMS_INITIAL_SCALE) for n, p in named}
        lr = torch.tensor(self.learning_rate, dtype=torch.float32, device=dev)
        return ContinuousOptState(mu, nu, 0, lr)

    @torch.no_grad()
    def apply_(self, params: list, grads: list, mu: list, nu: list,
               count: int, lr: torch.Tensor) -> int:
        """One clipped step, in place on params, mu and nu, with the
        learning rate tensor `lr`; returns the new count.  Nothing here
        reads a value back to the host."""
        norm = global_norm(grads)
        keep = norm < self.max_grad_norm
        grads = [torch.where(keep, g, g / norm * self.max_grad_norm)
                 for g in grads]
        if self.kind == "adam":
            b1, b2 = fp32.f32(ADAM_B1), fp32.f32(ADAM_B2)
            c1, c2 = _one_minus(ADAM_B1), _one_minus(ADAM_B2)
            step = np.float32(count + 1)
            bc1 = _one_minus(np.float32(ADAM_B1) ** step)
            bc2 = _one_minus(np.float32(ADAM_B2) ** step)
            upd = []
            for g, m, v in zip(grads, mu, nu):
                m.copy_(g * c1 + m * b1)
                v.copy_((g * g) * c2 + v * b2)
                upd.append((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))
        else:
            d, c = fp32.f32(RMS_DECAY), _one_minus(RMS_DECAY)
            upd = []
            for g, v in zip(grads, nu):
                v.copy_((g * g) * c + v * d)
                upd.append(torch.rsqrt(v + RMS_EPS) * g)
        for p, u in zip(params, upd):
            p.add_(-lr * u)
        return count + 1


def make_optimizer(cfg: ContinuousPPOConfig) -> Optimizer:
    if cfg.optimizer not in ("adam", "rmsprop"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}; one of "
                         "adam|rmsprop")
    return Optimizer(cfg.optimizer, cfg.learning_rate, cfg.max_grad_norm)


def adapt_lr(cfg: ContinuousPPOConfig, lr: torch.Tensor,
             kl: torch.Tensor) -> torch.Tensor:
    """The adaptive-KL rule (rsl_rl/algorithms/ppo.py:147-163), in float32
    on the device.  ``lr / 1.5`` is a product with the float32 reciprocal
    of 1.5, as XLA compiles it (``fp32.div_const``)."""
    down = torch.clamp(fp32.div_const(lr, 1.5), min=cfg.min_lr)
    up = torch.clamp(lr * 1.5, max=cfg.max_lr)
    return torch.where(kl > cfg.desired_kl * 2.0, down,
                       torch.where((kl < cfg.desired_kl / 2.0) & (kl > 0.0),
                                   up, lr))


class ContinuousUpdateMetrics(NamedTuple):
    """Means over the update's minibatches (float32 scalars on the
    device) and the learning rate after it."""
    surrogate_loss: torch.Tensor
    value_loss: torch.Tensor
    entropy: torch.Tensor
    mean_kl: torch.Tensor
    learning_rate: torch.Tensor


def minibatch_indices(cfg: ContinuousPPOConfig, m: int,
                      generator: torch.Generator) -> torch.Tensor:
    """[epochs * num_mini_batches, m / num_mini_batches]: one permutation
    of the m rows, cut into minibatches, repeated for every epoch."""
    perm = torch.randperm(m, generator=generator, device=generator.device)
    return perm.reshape(cfg.num_mini_batches, -1).repeat(
        cfg.num_learning_epochs, 1)


def _loss(model, cfg: ContinuousPPOConfig, old_log_std, obs, critic_obs,
          actions, old_log_probs, old_values, old_mean, advantages, returns):
    """The loss of one minibatch and its detached [4] (surrogate, value
    loss, entropy, KL)."""
    out = model(obs, critic_obs)
    logp = gaussian.log_prob(out.mean, out.log_std, actions)
    ent = gaussian.entropy(out.log_std, actions).mean()

    ratio = torch.exp(logp - old_log_probs)
    surr1 = -advantages * ratio
    surr2 = -advantages * torch.clamp(ratio, 1.0 - cfg.clip_param,
                                      1.0 + cfg.clip_param)
    surrogate = torch.maximum(surr1, surr2).mean()

    if cfg.use_clipped_value_loss:
        v_clipped = old_values + torch.clamp(out.value - old_values,
                                             -cfg.clip_param, cfg.clip_param)
        value_loss = torch.maximum((out.value - returns) ** 2,
                                   (v_clipped - returns) ** 2).mean()
    else:
        value_loss = torch.mean((out.value - returns) ** 2)

    loss = surrogate + cfg.value_loss_coef * value_loss - cfg.entropy_coef * ent
    with torch.no_grad():
        kl = gaussian.kl(old_mean, old_log_std, out.mean, out.log_std)
    return loss, torch.stack([surrogate.detach(), value_loss.detach(),
                              ent.detach(), kl])


def update(
    model: torch.nn.Module,
    opt: Optimizer,
    cfg: ContinuousPPOConfig,
    state: ContinuousOptState,
    obs: torch.Tensor,                   # [M, D] flattened rollout
    critic_obs: Optional[torch.Tensor],  # [M, Dc] or None (== obs)
    actions: torch.Tensor,               # [M, A]
    old_log_probs: torch.Tensor,         # [M]
    old_values: torch.Tensor,            # [M]
    old_mean: torch.Tensor,              # [M, A]
    old_log_std: torch.Tensor,           # [A] (state-independent at collect time)
    advantages: torch.Tensor,            # [M] (already whole-batch normalized)
    returns: torch.Tensor,               # [M]
    generator: Optional[torch.Generator] = None,
    indices: Optional[torch.Tensor] = None,
) -> tuple[ContinuousOptState, ContinuousUpdateMetrics]:
    """num_learning_epochs x num_mini_batches steps over one rollout.
    Changes the model's parameters and the moments of `state` in place and
    returns the state with its new count and learning rate.  `indices`
    ([epochs * num_mini_batches, mb], ``minibatch_indices``) fixes the
    minibatches; without it they are drawn from `generator`."""
    m = obs.shape[0]
    mb_size = m // cfg.num_mini_batches
    if mb_size * cfg.num_mini_batches != m:
        raise ValueError(f"num_mini_batches {cfg.num_mini_batches} must "
                         f"divide the {m} rollout transitions")
    fp32.deterministic_fp32()
    if indices is None:
        indices = minibatch_indices(cfg, m, generator)
    indices = indices.to(obs.device)

    names, params = zip(*model.named_parameters())
    params = list(params)
    mu = [state.mu[n] for n in names] if opt.kind == "adam" else []
    nu = [state.nu[n] for n in names]
    count, lr = state.count, state.learning_rate
    # a copy: the caller may pass the log_std parameter itself, which the
    # steps below change in place
    old_log_std = old_log_std.detach().clone()
    data = (obs, critic_obs, actions, old_log_probs, old_values, old_mean,
            advantages, returns)
    sums = torch.zeros(4, device=obs.device)
    for rows in indices:
        loss, stats = _loss(model, cfg, old_log_std,
                            *(None if x is None else x[rows] for x in data))
        grads = torch.autograd.grad(loss, params)
        if cfg.desired_kl is not None:
            lr = adapt_lr(cfg, lr, stats[3])
        count = opt.apply_(params, list(grads), mu, nu, count, lr)
        sums = sums + stats
    means = sums / indices.shape[0]
    metrics = ContinuousUpdateMetrics(*means, learning_rate=lr)
    return ContinuousOptState(state.mu, state.nu, count, lr), metrics
