"""Composable functional env wrappers -- the vec_env family
(stable_baselines3/common/vec_env/*), port of ``gennbv_tpu/env/wrappers.py``.

Each wrapper follows the contract of the env it wraps
(``reset(num_envs[, rng])``, ``step(state, actions)``) with its own state
carried inside a :class:`WrapState`, so wrapped envs stay functional and
pass ``utils.env_checker.check_env``.

| SB3 vec_env            | Here                 |
|------------------------|----------------------|
| VecNormalize           | NormalizeWrapper     |
| VecFrameStack          | FrameStackWrapper    |
| VecMonitor             | MonitorWrapper       |
| VecCheckNan            | CheckNanWrapper      |
| (gym ClipAction)       | ClipActionWrapper    |
| noise-scale vector     | ObsNoiseWrapper      |

Obs-flattening (EnvWrapperGenNBVTrain/Eval) has no counterpart because
ReconEnv emits the flat obs layout natively (spec.py).
"""
from __future__ import annotations

import inspect
from typing import Any, NamedTuple, Optional

import torch

from gennbv_tpu_torch.utils import normalizer as norm_lib
from gennbv_tpu_torch.utils import rng as rng_lib


class WrapState(NamedTuple):
    inner: Any
    extra: Any


class _Wrapper:
    """Base: forwards protocol attributes (num_actions, obs_dim, device,
    ...) of the wrapped env."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def _reset_inner(self, num_envs, rng):
        params = inspect.signature(self.env.reset).parameters
        if rng is not None and ("rng" in params or "key" in params):
            return self.env.reset(num_envs, rng)
        return self.env.reset(num_envs)


class NormalizeWrapper(_Wrapper):
    """VecNormalize: running-stats obs normalization + optional reward
    normalization by the std of the discounted return estimate
    (vec_normalize.py semantics), on the env's device."""

    def __init__(self, env, norm_obs: bool = True, norm_reward: bool = True,
                 clip_obs: float = 10.0, clip_reward: float = 10.0,
                 gamma: float = 0.99):
        super().__init__(env)
        self.norm_obs = norm_obs
        self.norm_reward = norm_reward
        self.clip_obs = clip_obs
        self.clip_reward = clip_reward
        self.gamma = gamma

    def reset(self, num_envs: int, rng: Optional[torch.Generator] = None):
        state, out = self._reset_inner(num_envs, rng)
        dev = out.obs.device
        extra = {
            "obs": norm_lib.init(out.obs.shape[-1], device=dev),
            "ret": norm_lib.init(1, device=dev),
            "returns": torch.zeros(num_envs, device=dev),
        }
        extra["obs"] = norm_lib.update(extra["obs"], out.obs)
        obs = norm_lib.normalize(extra["obs"], out.obs, self.clip_obs) \
            if self.norm_obs else out.obs
        return WrapState(state, extra), out._replace(obs=obs)

    def step(self, ws: WrapState, actions):
        state, out = self.env.step(ws.inner, actions)
        extra = dict(ws.extra)
        extra["obs"] = norm_lib.update(extra["obs"], out.obs)
        obs = norm_lib.normalize(extra["obs"], out.obs, self.clip_obs) \
            if self.norm_obs else out.obs
        returns = extra["returns"] * self.gamma + out.reward
        extra["ret"] = norm_lib.update(extra["ret"], returns[:, None])
        extra["returns"] = torch.where(out.done, 0.0, returns)
        reward = out.reward
        if self.norm_reward:
            reward = torch.clamp(
                out.reward / torch.sqrt(extra["ret"].var[0] + 1e-8),
                -self.clip_reward, self.clip_reward)
        return WrapState(state, extra), out._replace(obs=obs, reward=reward)


class FrameStackWrapper(_Wrapper):
    """VecFrameStack: obs = concat of the last k observations (oldest
    first); reset/done fills the stack with the current frame."""

    def __init__(self, env, k: int = 4):
        super().__init__(env)
        self.k = k
        self.obs_dim = env.obs_dim * k

    def reset(self, num_envs: int, rng: Optional[torch.Generator] = None):
        state, out = self._reset_inner(num_envs, rng)
        frames = out.obs[:, None, :].repeat(1, self.k, 1)
        return WrapState(state, frames), out._replace(
            obs=frames.reshape(num_envs, -1))

    def step(self, ws: WrapState, actions):
        state, out = self.env.step(ws.inner, actions)
        frames = torch.cat([ws.extra[:, 1:], out.obs[:, None, :]], dim=1)
        # done: restart the stack from the post-reset frame
        frames = torch.where(out.done[:, None, None],
                             out.obs[:, None, :].expand_as(frames), frames)
        return WrapState(state, frames), out._replace(
            obs=frames.reshape(frames.shape[0], -1))


class MonitorWrapper(_Wrapper):
    """VecMonitor: per-env episode return/length accounting surfaced at
    terminal steps (0 elsewhere) as extra fields ``ep_return``/``ep_len``
    appended to the step output tuple."""

    class Output(NamedTuple):
        obs: torch.Tensor
        reward: torch.Tensor
        done: torch.Tensor
        time_out: torch.Tensor
        ep_return: torch.Tensor
        ep_len: torch.Tensor

    def reset(self, num_envs: int, rng: Optional[torch.Generator] = None):
        state, out = self._reset_inner(num_envs, rng)
        dev = out.obs.device
        extra = {"ret": torch.zeros(num_envs, device=dev),
                 "len": torch.zeros(num_envs, dtype=torch.int32, device=dev)}
        z = torch.zeros(num_envs, device=dev)
        return WrapState(state, extra), self.Output(
            out.obs, out.reward, out.done, out.time_out, z, z)

    def step(self, ws: WrapState, actions):
        state, out = self.env.step(ws.inner, actions)
        ret = ws.extra["ret"] + out.reward
        ln = ws.extra["len"] + 1
        d = out.done
        extra = {"ret": torch.where(d, 0.0, ret),
                 "len": torch.where(d, 0, ln)}
        # `ret * d` in the JAX wrapper, which XLA compiles to a select: a
        # non-finite return of a running episode stays out of the output
        return WrapState(state, extra), self.Output(
            out.obs, out.reward, out.done, out.time_out,
            torch.where(d, ret, 0.0), torch.where(d, ln.float(), 0.0))


class CheckNanWrapper(_Wrapper):
    """VecCheckNan: appends an ``invalid`` flag (any non-finite obs/reward
    this step).  The functional stand-in for the reference's raise-on-NaN:
    callers assert on the flag where they read it."""

    class Output(NamedTuple):
        obs: torch.Tensor
        reward: torch.Tensor
        done: torch.Tensor
        time_out: torch.Tensor
        invalid: torch.Tensor

    def reset(self, num_envs: int, rng: Optional[torch.Generator] = None):
        state, out = self._reset_inner(num_envs, rng)
        return WrapState(state, ()), self.Output(
            out.obs, out.reward, out.done, out.time_out,
            ~torch.isfinite(out.obs).all(dim=-1))

    def step(self, ws: WrapState, actions):
        state, out = self.env.step(ws.inner, actions)
        invalid = (~torch.isfinite(out.obs).all(dim=-1)
                   | ~torch.isfinite(out.reward))
        return WrapState(state, ()), self.Output(
            out.obs, out.reward, out.done, out.time_out, invalid)


class ObsNoiseWrapper(_Wrapper):
    """Additive observation noise: ``obs += uniform(-1, 1) * noise_vec``.

    The reference's noise-scale vector (drone_robot.py:532-553,
    LeggedRobotCfg.noise): per-component scales times a global noise_level,
    defined by the framework and left OFF on the GenNBV path -- a wrapper
    any robot task can opt into.  `noise_vec` may be a scalar or a
    per-component [obs_dim] array.  Its random state rides in the
    WrapState; without a generator, reset seeds one with 0."""

    def __init__(self, env, noise_vec, noise_level: float = 1.0):
        super().__init__(env)
        self.noise_vec = torch.as_tensor(noise_vec, dtype=torch.float32,
                                         device=env.device) * noise_level

    def _noisy(self, obs, g):
        u = torch.rand(obs.shape, generator=g, device=obs.device) * 2.0 - 1.0
        return obs + self.noise_vec * u

    def reset(self, num_envs: int, rng: Optional[torch.Generator] = None):
        if rng is None:
            rng = torch.Generator(device=self.env.device).manual_seed(0)
        state, out = self._reset_inner(num_envs, rng)
        obs = self._noisy(out.obs, rng)
        return WrapState(state, rng_lib.fork(rng)), out._replace(obs=obs)

    def step(self, ws: WrapState, actions):
        state, out = self.env.step(ws.inner, actions)
        g = rng_lib.restore(ws.extra, out.obs.device)
        obs = self._noisy(out.obs, g)
        return WrapState(state, g.get_state()), out._replace(obs=obs)


class ClipActionWrapper(_Wrapper):
    """Clip continuous actions to [lo, hi] before the env sees them."""

    def __init__(self, env, lo: float = -1.0, hi: float = 1.0):
        super().__init__(env)
        self.lo = lo
        self.hi = hi

    def reset(self, num_envs: int, rng: Optional[torch.Generator] = None):
        state, out = self._reset_inner(num_envs, rng)
        return WrapState(state, ()), out

    def step(self, ws: WrapState, actions):
        state, out = self.env.step(ws.inner,
                                   torch.clamp(actions, self.lo, self.hi))
        return WrapState(state, ()), out
