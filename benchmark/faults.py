"""Faults planted in the program, to show that ``correct`` catches each
fault a cell can have (``tests/test_benchmark_reference.py`` on the CPU)
and to read, on the card, what each does to the compared numbers
(``calibrate.py --fault``).  Each is a context manager that patches the
program for its duration.  Never used by a benchmark run."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def update_unchanged():
    """The PPO step keeps the parameters as they were (the count still
    advances)."""
    from gennbv_tpu_torch.algo import ppo

    def unchanged(self, params, grads, mu, nu, count, grad_norm, tables,
                  go=None):
        count.add_(1)
    return _patched(ppo.Optimizer, "gated_apply_", unchanged)


def half_batch():
    """Each minibatch's loss and gradients over the first half of its
    rows, its means over those."""
    from gennbv_tpu_torch.algo import ppo
    step = ppo._minibatch_step

    def half(policy, cfg, params, data, rows, mesh=None):
        return step(policy, cfg, params, data, rows[: rows.shape[0] // 2], mesh)
    return _patched(ppo, "_minibatch_step", half)


def reward_altered():
    """Env 0's reward raised by 1e-3 at every step, where the env step
    produces it."""
    from gennbv_tpu_torch.env import ReconEnv
    step = ReconEnv.step

    def altered(self, state, actions):
        state, out = step(self, state, actions)
        bump = torch.zeros_like(out.reward)
        bump[:1] = 1e-3
        return state, out._replace(reward=out.reward + bump)
    return _patched(ReconEnv, "step", altered)


def state_unchanged():
    """The env step returns the state it was given (but at a reset)."""
    from gennbv_tpu_torch.env import ReconEnv
    step = ReconEnv.step

    def unchanged(self, state, actions):
        new, out = step(self, state, actions)
        fresh = bool((state.episode_len == 0).all())
        return (new if fresh else state), out
    return _patched(ReconEnv, "step", unchanged)


def half_envs():
    """The env step updates the coverage of the first half of the envs
    only."""
    from gennbv_tpu_torch.env import ReconEnv
    step = ReconEnv.step

    def half(self, state, actions):
        new, out = step(self, state, actions)
        n = out.coverage.shape[0] // 2
        cov = torch.cat([out.coverage[:n], state.coverage[n:]])
        return new._replace(coverage=cov), out._replace(coverage=cov)
    return _patched(ReconEnv, "step", half)


def logit_altered():
    """The policy's first logit of env 0 raised by 1 where the forward
    produces it."""
    from gennbv_tpu_torch.models.policy import ActorCriticPolicy
    forward = ActorCriticPolicy.forward

    def altered(self, obs):
        out = forward(self, obs)
        bump = torch.zeros_like(out.logits)
        bump[0, 0] = 1.0
        return out._replace(logits=out.logits + bump)
    return _patched(ActorCriticPolicy, "forward", altered)


# the faults each traffic's cells can have (one card: no exchange
# between chips to leave out)
BY_LOOP = {
    "train": {"update_unchanged": update_unchanged, "half_batch": half_batch,
              "reward_altered": reward_altered},
    "eval": {"state_unchanged": state_unchanged, "half_envs": half_envs,
             "logit_altered": logit_altered},
}
