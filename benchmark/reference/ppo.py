"""Generalized advantage estimation and the PPO minibatch step as plain
PyTorch, after SB3's PPO as the reference repo runs it
(``ppo_grid_obs.py:176-297``, ``buffers.py:706-724``):

- loss = 10 * clipped surrogate + ent_coef * (-entropy) + vf_coef *
  value loss with the values clipped around the old ones; advantages
  normalised per minibatch with the population std;
- the KL stop at 1.5 x target_kl: the breaching minibatch is not applied;
- the global gradient norm clipped to max_grad_norm (no epsilon, only
  where the norm reaches it), then Adam (b1 0.9, b2 0.999, eps added to
  sqrt of the corrected second moment) at a linear or constant rate read
  at the count of applied steps.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import policy as ref_policy


def gae(rewards, values, dones, last_values, gamma: float, lam: float):
    """(advantages, returns) [T, N]; the timeout bootstrap is already in
    the rewards."""
    non_terminal = 1.0 - dones.float()
    adv = torch.empty_like(values)
    run = torch.zeros_like(last_values)
    next_value = last_values
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_value * non_terminal[t] - values[t]
        run = delta + gamma * lam * non_terminal[t] * run
        adv[t] = run
        next_value = values[t]
    return adv, adv + values


def learning_rate(ppo: dict, num_envs: int, count: int) -> float:
    lr = np.float32(ppo["learning_rate"])
    if ppo["lr_schedule"] == "constant":
        return float(lr)
    total = ppo["n_epochs"] * max(ppo["total_iters"], 1) * max(
        ppo["n_steps"] * num_envs // ppo["batch_size"], 1)
    return float(lr * (np.float32(1) - np.float32(min(count, total))
                       / np.float32(total)))


def minibatch_loss(pol, ppo: dict, obs, actions, old_logp, old_values, adv,
                   returns):
    """(loss, [policy loss, value loss, entropy loss, approx KL, clip
    fraction]) of one minibatch, the policy in train mode."""
    logits, values = pol(obs)
    logp = ref_policy.log_prob(logits, actions)
    if ppo["normalize_advantage"]:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    log_ratio = logp - old_logp
    ratio = torch.exp(log_ratio)
    clip = ppo["clip_range"]
    policy_loss = -torch.minimum(adv * ratio,
                                 adv * torch.clamp(ratio, 1 - clip, 1 + clip)).mean()
    if ppo["clip_range_vf"] is not None:
        values = old_values + torch.clamp(values - old_values,
                                          -ppo["clip_range_vf"],
                                          ppo["clip_range_vf"])
    value_loss = ((returns - values) ** 2).mean()
    entropy_loss = -ref_policy.entropy(logits).mean()
    loss = (ppo["policy_loss_mult"] * policy_loss
            + ppo["ent_coef"] * entropy_loss + ppo["vf_coef"] * value_loss)
    with torch.no_grad():
        kl = (torch.expm1(log_ratio) - log_ratio).mean()
        clip_frac = ((ratio - 1).abs() > clip).float().mean()
    return loss, [policy_loss.detach(), value_loss.detach(),
                  entropy_loss.detach(), kl, clip_frac]


def steps(pol, ppo: dict, num_envs: int, data: tuple, rows, mu=None,
          nu=None, count: int = 0, b1=0.9, b2=0.999):
    """Runs the minibatches `rows` ([K, B] rows of the flat rollout
    `data`) through PPO's step, in place on `pol`, from the Adam moments
    `mu` and `nu` (dicts by parameter name; zero where None) after
    `count` applied steps.  Returns, per minibatch, its five loss terms,
    whether it was applied, and Adam's first moment after it (a dict by
    parameter name)."""
    names, params = zip(*pol.named_parameters())
    mu = [torch.zeros_like(p) if mu is None else mu[n].clone()
          for n, p in zip(names, params)]
    nu = [torch.zeros_like(p) if nu is None else nu[n].clone()
          for n, p in zip(names, params)]
    out = []
    pol.train()
    for r in rows:
        stats = [b.clone() for n, b in pol.named_buffers()]
        loss, terms = minibatch_loss(pol, ppo, *(x[r] for x in data))
        grads = torch.autograd.grad(loss, params)
        applied = ppo["target_kl"] is None or \
            float(terms[3]) <= float(np.float32(1.5 * ppo["target_kl"]))
        if not applied:
            for b, s in zip(pol.buffers(), stats):
                b.copy_(s)
            out.append((terms, False, {n: m.clone() for n, m in zip(names, mu)}))
            break
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            if float(norm) >= ppo["max_grad_norm"]:
                grads = [g / norm * ppo["max_grad_norm"] for g in grads]
            lr = learning_rate(ppo, num_envs, count)
            count += 1
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
            for p, g, m, v in zip(params, grads, mu, nu):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                p.add_(-lr * (m / bc1) / (torch.sqrt(v / bc2) + ppo["adam_eps"]))
        out.append((terms, True, {n: m.clone() for n, m in zip(names, mu)}))
    return out
