"""Incremental timing of the port's training pipeline (counterpart of
``tools/profile_train.py``).

Prints the wall-clock of the scene build, the env step (first call, then
3 steps), the rollout collect (128 steps), the 5-epoch PPO update and the
whole training iteration (first, then 3 in a row), each first call apart
from the steady state, to locate where an iteration's time goes.  Each
phase is a device-timed span (``utils/profiling.span``: CUDA events on
the card, read before the next phase starts).

Usage: python -m gennbv_tpu_torch.tools.profile_train [num_envs] [cam] [res]
       [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib

import torch

from gennbv_tpu_torch.algo import gae, ppo, rollout
from gennbv_tpu_torch.algo.runner import Runner
from gennbv_tpu_torch.config import (CameraConfig, Config, EnvConfig,
                                     PPOConfig, RendererConfig, RunnerConfig,
                                     SceneConfig)
from gennbv_tpu_torch.utils import profiling


def main(argv=None) -> dict:
    """Runs the phases in turn; returns their seconds (``time/<phase>``)
    and the steady iterations' env-steps/s."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("num_envs", type=int, nargs="?", default=256)
    p.add_argument("cam", type=int, nargs="?", default=128)
    p.add_argument("res", type=int, nargs="?", default=64)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    n = args.num_envs
    cfg = Config(
        env=EnvConfig(num_envs=n,
                      camera=CameraConfig(height=args.cam, width=args.cam),
                      renderer=RendererConfig(resolution=args.res),
                      scene=SceneConfig(num_scenes=n, seed=0)),
        ppo=PPOConfig(n_steps=128, batch_size=128, n_epochs=5),
        runner=RunnerConfig(seed=0, save_freq=0),
    )
    print(f"device={dev} num_envs={n} cam={args.cam} res={args.res}",
          flush=True)
    seconds: dict = {}

    @contextlib.contextmanager
    def phase(name: str, msg: str):
        with profiling.span(name, "profile_train", dev):
            yield
        seconds.update(profiling.phases("profile_train").metrics())
        print(f"[{seconds[f'time/{name}']:8.2f}s] {msg}", flush=True)

    with phase("scene_build", "Runner init (scene build)"):
        runner = Runner(cfg, device=dev)
    print(f"  surface points Q={runner.scenes.surf_pts.shape[1]}", flush=True)

    env = runner.env
    state, out = env.reset(n)
    actions = env.init_action.expand(n, -1)
    with phase("env_step_first", "env.step #1"):
        state, out = env.step(state, actions)
    with phase("env_step", "env.step x3 steady-state"):
        for _ in range(3):
            state, out = env.step(state, actions)

    def collect(env_state, obs):
        return rollout.collect(env, runner.policy, env_state, obs,
                               runner.generator, cfg.ppo.n_steps,
                               cfg.ppo.gamma)

    with phase("rollout_first", "rollout.collect (128 steps) #1"):
        env_state, obs, batch, _ = collect(state, out.obs)
    with phase("rollout", "rollout.collect steady-state"):
        env_state, obs, batch, _ = collect(env_state, obs)

    adv, ret = gae.compute_gae(batch.rewards, batch.values,
                               batch.dones.float(), batch.last_values,
                               cfg.ppo.gamma, cfg.ppo.gae_lambda)
    m = cfg.ppo.n_steps * n
    flat = [x.reshape((m,) + x.shape[2:]) for x in (
        batch.obs, batch.actions, batch.log_probs, batch.values, adv, ret)]

    def update():
        runner.opt_state, _ = ppo.update(
            runner.policy, runner.opt, cfg.ppo, runner.opt_state, *flat,
            runner.generator, num_envs=n)

    with phase("update_first", "ppo.update (5 epochs) #1"):
        update()
    with phase("update", "ppo.update steady-state"):
        update()

    env_state, obs = runner.setup()
    with phase("iteration_first", "train iteration #1"):
        env_state, obs, _ = runner.train_iteration(env_state, obs)
    with phase("iteration", "train iteration x3 steady-state"):
        for _ in range(3):
            env_state, obs, _ = runner.train_iteration(env_state, obs)
    seconds["iteration_fps"] = 3 * m / seconds["time/iteration"]
    print(f"  -> {seconds['iteration_fps']:,.0f} env-steps/s", flush=True)
    return seconds


if __name__ == "__main__":
    main()
