"""PPO learner: clipped surrogate + clipped value loss + entropy bonus
(port of ``gennbv_tpu/algo/ppo.py``).

The reference semantics (ppo_grid_obs.py:176-297), as the JAX learner keeps
them:
- loss = policy_loss * 10 + ent_coef * entropy_loss + vf_coef * value_loss
  (the x10 multiplier is ``policy_loss_mult``);
- per-minibatch advantage normalisation, with the population std;
- value clipping around the old values;
- target-KL early stop at 1.5x: the minibatch that breaches it is *not*
  applied (not its parameters, not its Adam state, not its BatchNorm
  running stats) and every later minibatch and epoch is skipped;
- grad-norm clip, then Adam(lr, eps=1e-5) with a constant or linear lr.

The clip and Adam are written here as functions over the parameter list
that compute what optax's ``clip_by_global_norm`` and ``adam`` compute:
the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``,
with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6); Adam's
bias correction counts from 1 and its denominator is ``sqrt(v_hat) +
eps``; the schedule reads the count of *applied* updates.

The update reads each minibatch's KL and gradient norm on the host, then
applies the minibatch or stops: the host decides what ``lax.cond`` decides
on the TPU, and the work after a stop is skipped, not masked.  On a CUDA
device the minibatch's forward and backward pass (~400 small kernels,
whose launches from Python would set the pace) is captured once per update
as a CUDA graph and replayed for each minibatch; on the CPU it runs
eagerly.  Either way it is the same PyTorch code.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.nn.modules.batchnorm import _BatchNorm

from gennbv_tpu_torch.config import PPOConfig
from gennbv_tpu_torch.models import distributions
from gennbv_tpu_torch.ops import fp32


class AdamState(NamedTuple):
    """Adam's moments, keyed by parameter name as ``named_parameters``
    gives them, and the count of applied updates (optax's
    ``ScaleByAdamState``; its schedule count is the same number)."""
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    count: int


@dataclass(frozen=True)
class Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, eps))``."""
    learning_rate: float
    # length of the linear anneal in applied updates; None: constant lr
    total_updates: Optional[int]
    max_grad_norm: float
    eps: float
    b1: float = 0.9
    b2: float = 0.999

    def lr(self, count: int) -> float:
        """The learning rate after `count` applied updates, in float32 as
        optax's ``linear_schedule`` computes it."""
        lr = np.float32(self.learning_rate)
        if self.total_updates is None:
            return float(lr)
        total = np.float32(self.total_updates)
        frac = np.float32(1) - np.float32(min(max(count, 0), self.total_updates)) / total
        return float(lr * frac)

    def init(self, policy: torch.nn.Module) -> AdamState:
        def zeros():
            return {n: torch.zeros_like(p) for n, p in policy.named_parameters()}
        return AdamState(zeros(), zeros(), 0)

    @torch.no_grad()
    def apply_(self, params: list, grads: list, mu: list, nu: list,
               count: int, grad_norm: float | torch.Tensor | None) -> int:
        """One clipped Adam step, in place on params, grads, mu and nu;
        `grad_norm` is the global norm of `grads` (``global_norm``): a
        host float, or a device scalar, which clips by a select on the
        device and never waits for it; None steps without the clip (a
        plain ``optax.adam``).  Returns the new count."""
        if isinstance(grad_norm, torch.Tensor):
            keep = grad_norm < self.max_grad_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / grad_norm * self.max_grad_norm))
        elif grad_norm is not None and not (
                np.float32(grad_norm) < np.float32(self.max_grad_norm)):
            torch._foreach_div_(grads, float(grad_norm))
            torch._foreach_mul_(grads, self.max_grad_norm)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - self.b2))
        step = count + 1
        bc1 = np.float32(1) - np.float32(self.b1) ** np.float32(step)
        bc2 = np.float32(1) - np.float32(self.b2) ** np.float32(step)
        upd = torch._foreach_div(mu, float(bc1))
        den = torch._foreach_div(nu, float(bc2))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -self.lr(count))
        torch._foreach_add_(params, upd)
        return step


def make_optimizer(cfg: PPOConfig, num_envs: int = 256) -> Optimizer:
    """Adam behind grad-norm clipping, with SB3-style lr schedules
    (stable_baselines3/common/utils.py get_schedule_fn): "constant" or
    "linear" anneal to 0 over the run's total gradient steps."""
    if cfg.lr_schedule == "linear":
        total = cfg.n_epochs * max(cfg.total_iters, 1) * max(
            (cfg.n_steps * num_envs) // max(cfg.batch_size, 1), 1)
    elif cfg.lr_schedule == "constant":
        total = None
    else:
        raise ValueError(
            f"unknown lr_schedule {cfg.lr_schedule!r}; one of constant|linear")
    return Optimizer(cfg.learning_rate, total, cfg.max_grad_norm, cfg.adam_eps)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every element of `grads`."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


class UpdateMetrics(NamedTuple):
    policy_loss: float
    value_loss: float
    entropy_loss: float
    approx_kl: float
    clip_fraction: float
    n_minibatches_done: float
    explained_variance: float


def _minibatch_shards(cfg: PPOConfig, num_envs: int) -> int:
    """Effective logical shard count S for minibatch sampling: minibatches
    are drawn balanced across S fixed env groups, with an independent
    permutation per group.  S is a config constant (never a device
    count), adapted downward to the largest divisor of both num_envs and
    batch_size."""
    s = max(1, cfg.minibatch_shards)
    while num_envs % s or cfg.batch_size % s:
        s -= 1
    return s


def minibatch_indices(cfg: PPOConfig, m: int, num_envs: Optional[int],
                      generator: torch.Generator) -> torch.Tensor:
    """[E * n_mb, S, BL] int64: one fresh permutation of each shard's ML =
    m / S transitions per (epoch, shard), cut into n_mb minibatches of BL =
    batch_size / S rows a shard.  Positions index the shard-major layout
    of ``update``; drawn on the generator's device."""
    n_mb = m // cfg.batch_size
    s = _minibatch_shards(cfg, num_envs) if num_envs else 1
    ml, bl = m // s, cfg.batch_size // s
    perms = torch.stack([
        torch.randperm(ml, generator=generator, device=generator.device)
        for _ in range(cfg.n_epochs * s)]).reshape(cfg.n_epochs, s, ml)
    return (perms.reshape(cfg.n_epochs, s, n_mb, bl).transpose(1, 2)
            .reshape(cfg.n_epochs * n_mb, s, bl))


def flat_rows(indices: torch.Tensor, m: int,
              num_envs: Optional[int]) -> torch.Tensor:
    """Minibatch positions [K, S, BL] -> rows [K, S * BL] of the flat
    [M = T * N] rollout.  Shard s holds, in shard-major order, the
    transitions of envs [s * N/S, (s+1) * N/S) over all T steps (the JAX
    learner's relayout, ``ppo.py:103-129``); mapping the positions back
    gathers the same rows without copying the rollout into that layout."""
    k, s, bl = indices.shape
    if s == 1:
        return indices.reshape(k, bl)
    nl = num_envs // s
    shard = torch.arange(s, device=indices.device)[None, :, None]
    rows = (indices // nl) * num_envs + shard * nl + indices % nl
    return rows.reshape(k, s * bl)


def _loss(policy, cfg: PPOConfig, obs, actions, old_log_probs, old_values,
          advantages, returns):
    """The loss of one minibatch and its detached (policy, value, entropy
    loss, approx KL, clip fraction)."""
    out = policy(obs.float())
    logp = distributions.log_prob(out.logits, actions)
    ent = distributions.entropy(out.logits)
    values = out.value

    adv = advantages
    if cfg.normalize_advantage:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)

    log_ratio = logp - old_log_probs
    ratio = torch.exp(log_ratio)
    pg1 = adv * ratio
    pg2 = adv * torch.clamp(ratio, 1.0 - cfg.clip_range, 1.0 + cfg.clip_range)
    policy_loss = -torch.minimum(pg1, pg2).mean()

    if cfg.clip_range_vf is None:
        values_pred = values
    else:
        values_pred = old_values + torch.clamp(
            values - old_values, -cfg.clip_range_vf, cfg.clip_range_vf)
    value_loss = torch.mean((returns - values_pred) ** 2)

    entropy_loss = -ent.mean()
    loss = (policy_loss * cfg.policy_loss_mult + cfg.ent_coef * entropy_loss
            + cfg.vf_coef * value_loss)
    if cfg.ent_floor is not None:
        # hinge bonus once the batch-mean entropy drops below the floor
        loss = loss + cfg.ent_floor_coef * torch.relu(cfg.ent_floor - ent.mean())
    with torch.no_grad():
        approx_kl = torch.mean(torch.expm1(log_ratio) - log_ratio)
        clip_frac = torch.mean((torch.abs(ratio - 1.0) > cfg.clip_range).float())
    return loss, (policy_loss.detach(), value_loss.detach(),
                  entropy_loss.detach(), approx_kl, clip_frac)


def _minibatch_step(policy, cfg: PPOConfig, params: list, data: tuple,
                    rows: torch.Tensor):
    """The gradients of the loss of the minibatch at `rows` of the flat
    rollout `data`, and one [6] tensor of its (policy, value, entropy
    loss, approx KL, clip fraction, gradient norm)."""
    loss, metrics = _loss(policy, cfg, *(x[rows] for x in data))
    grads = list(torch.autograd.grad(loss, params))
    return grads, torch.stack([*metrics, global_norm(grads)])


class _CapturedStep:
    """``_minibatch_step`` as one CUDA graph: each call copies the rows in
    and replays it, writing the gradients and metrics into the same
    tensors (which stay valid until the next call).  The capture follows
    two warm-up steps on a side stream (cuDNN, cuBLAS and autograd set
    themselves up outside the capture), whose BatchNorm updates are undone."""

    def __init__(self, policy, cfg: PPOConfig, params: list, data: tuple,
                 rows: torch.Tensor, stats: list):
        self.rows = rows.clone()
        saved = [b.clone() for b in stats]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                _minibatch_step(policy, cfg, params, data, self.rows)
        torch.cuda.current_stream().wait_stream(side)
        if stats:
            torch._foreach_copy_(stats, saved)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.grads, self.out = _minibatch_step(policy, cfg, params, data,
                                                   self.rows)

    def __call__(self, rows: torch.Tensor):
        self.rows.copy_(rows)
        self.graph.replay()
        return self.grads, self.out


def update(
    policy: torch.nn.Module,
    opt: Optimizer,
    cfg: PPOConfig,
    state: AdamState,
    obs: torch.Tensor,            # [M, D] flattened rollout (t-major)
    actions: torch.Tensor,        # [M, 6]
    old_log_probs: torch.Tensor,  # [M]
    old_values: torch.Tensor,     # [M]
    advantages: torch.Tensor,     # [M]
    returns: torch.Tensor,        # [M]
    generator: Optional[torch.Generator] = None,
    num_envs: Optional[int] = None,
    indices: Optional[torch.Tensor] = None,
) -> tuple[AdamState, UpdateMetrics]:
    """n_epochs passes of minibatched PPO over one rollout.  Changes the
    policy's parameters and BatchNorm running stats and the moments of
    `state` in place, and returns the state with its new count.
    `indices` ([E * n_mb, S, BL], ``minibatch_indices``) fixes the
    minibatches; without it they are drawn from `generator`."""
    m = obs.shape[0]
    n_mb = m // cfg.batch_size
    if n_mb * cfg.batch_size != m:
        raise ValueError(f"batch_size {cfg.batch_size} must divide the "
                         f"{m} rollout transitions")
    if cfg.apply_mode not in ("select", "cond"):
        raise ValueError(f"ppo.apply_mode={cfg.apply_mode!r}: "
                         "expected 'select' or 'cond'")
    fp32.deterministic_fp32()
    if indices is None:
        indices = minibatch_indices(cfg, m, num_envs, generator)
    rows = flat_rows(indices.to(obs.device), m, num_envs)
    kl_threshold = (np.float32(1.5 * cfg.target_kl)
                    if cfg.target_kl is not None else None)

    names, params = zip(*policy.named_parameters())
    params = list(params)
    mu = [state.mu[n] for n in names]
    nu = [state.nu[n] for n in names]
    count = state.count
    # BatchNorm running stats, restored when a minibatch is discarded
    stats = [b for mod in policy.modules() if isinstance(mod, _BatchNorm)
             for b in (mod.running_mean, mod.running_var)]
    saved = [b.clone() for b in stats]
    # float32 sums of (policy, value, entropy loss, KL, clip fraction, 1)
    sums = np.zeros(6, np.float32)

    data = (obs, actions, old_log_probs, old_values, advantages, returns)
    was_training = policy.training
    policy.train()
    try:
        step = (_CapturedStep(policy, cfg, params, data, rows[0], stats)
                if obs.is_cuda else
                functools.partial(_minibatch_step, policy, cfg, params, data))
        for r in rows:
            if kl_threshold is not None and stats:
                torch._foreach_copy_(saved, stats)
            grads, out = step(r)
            # one host fetch: the five metrics and the gradient norm
            host = out.cpu().numpy()
            if kl_threshold is not None and not host[3] <= kl_threshold:
                if stats:
                    torch._foreach_copy_(stats, saved)
                break
            sums += np.append(host[:5], np.float32(1))
            count = opt.apply_(params, grads, mu, nu, count, host[5])
    finally:
        policy.train(was_training)

    with torch.no_grad():
        var_ret = returns.var(correction=0)
        ev = torch.where(
            var_ret > 0, 1.0 - (returns - old_values).var(correction=0) / var_ret,
            torch.zeros_like(var_ret))
    n_done = max(sums[5], np.float32(1))
    metrics = UpdateMetrics(
        *(float(x / n_done) for x in sums[:5]),
        n_minibatches_done=float(sums[5]),
        explained_variance=float(ev))
    return AdamState(state.mu, state.nu, count), metrics
