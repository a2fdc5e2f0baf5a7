"""Environment contract checker (port of ``gennbv_tpu/utils/env_checker.py``,
the counterpart of SB3's ``common/env_checker.py``) for the port's
functional env protocol.

Checks that an env behaves like the contract the learners assume
(ReconEnv, env/synthetic.py, env/drone_robot.py, env/wrappers.py):

    state, out = env.reset(num_envs[, rng])        # or reset(num_envs)
    state, out = env.step(state, actions)
    out.obs [N, obs_dim] float, out.reward [N] float,
    out.done [N] bool, out.time_out [N] bool

plus stable state shapes and dtypes across steps, auto-reset sanity (done
envs keep stepping), value finiteness, and a step that is a function of
(state, actions).  The JAX checker also jits the step; the port has no
counterpart of that.  Raises AssertionError with a precise message on the
first violation.  Runs on ``env.device``.
"""
from __future__ import annotations

import inspect

import torch


def _sample_actions(env, n, g):
    """Discrete envs expose `nvec`; continuous expose `num_actions`."""
    nvec = getattr(env, "nvec", None)
    if nvec is not None:
        nvec = torch.as_tensor(nvec, device=g.device)
        u = torch.rand((n, nvec.shape[0]), generator=g, device=g.device)
        return (u * nvec[None, :]).to(torch.int32)
    return torch.randn((n, env.num_actions), generator=g, device=g.device)


def _layout(x):
    """The shapes, dtypes and devices of a state tree's tensors."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype, x.device
    if isinstance(x, dict):
        return {k: _layout(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x).__name__, tuple(_layout(v) for v in x)
    return x


def check_env(env, num_envs: int = 4, steps: int = 8, seed: int = 0) -> None:
    g = torch.Generator(device=env.device).manual_seed(seed)

    # --- reset signature: (num_envs) or (num_envs, rng) -- match by name,
    # not arity (ReconEnv's second param is scene_id, not rng)
    params = inspect.signature(env.reset).parameters
    if "rng" in params or "key" in params:
        state, out = env.reset(num_envs, g)
    else:
        state, out = env.reset(num_envs)

    assert hasattr(out, "obs") and hasattr(out, "reward"), \
        "step output must have .obs and .reward"
    assert hasattr(out, "done") and hasattr(out, "time_out"), \
        "step output must have .done and .time_out"

    obs = out.obs
    assert obs.ndim == 2 and obs.shape[0] == num_envs, \
        f"obs must be [num_envs, obs_dim], got {tuple(obs.shape)}"
    obs_dim = getattr(env, "obs_dim", obs.shape[1])
    assert obs.shape[1] == obs_dim, \
        f"obs dim {obs.shape[1]} != env.obs_dim {obs_dim}"
    assert obs.dtype.is_floating_point, f"obs dtype {obs.dtype}"

    # --- shape/dtype stability over steps
    layout0 = _layout(state)
    saw_done = False
    for t in range(steps):
        actions = _sample_actions(env, num_envs, g)
        state, out = env.step(state, actions)

        assert _layout(state) == layout0, \
            f"state shapes/dtypes changed at step {t}"
        assert tuple(out.reward.shape) == (num_envs,), tuple(out.reward.shape)
        assert out.done.dtype == torch.bool, f"done dtype {out.done.dtype}"
        assert out.time_out.dtype == torch.bool, out.time_out.dtype
        assert bool(torch.isfinite(out.obs).all()), f"non-finite obs at {t}"
        assert bool(torch.isfinite(out.reward).all()), \
            f"non-finite reward at {t}"
        # time_out must imply done (the bootstrap relies on it)
        assert bool((~out.time_out | out.done).all()), \
            "time_out must be a subset of done"
        saw_done = saw_done or bool(out.done.any())

    # --- auto-reset: envs must keep producing valid steps after done
    if saw_done:
        state, out = env.step(state, _sample_actions(env, num_envs, g))
        assert bool(torch.isfinite(out.obs).all()), \
            "obs broken after auto-reset"

    # --- the same (state, actions) gives the same step
    a = _sample_actions(env, num_envs, g)
    _, o1 = env.step(state, a)
    _, o2 = env.step(state, a)
    assert torch.equal(o1.obs, o2.obs), "step is not deterministic"
