"""CLI entry for the rsl_rl-family tasks (physics robots, continuous PPO);
port of ``gennbv_tpu/train/train_rsl.py``.

The counterpart of `legged_gym/scripts/train.py:41-49` +
`task_registry.make_alg_runner` (legged_gym/utils/task_registry.py:107-165):
pick a registered velocity task, build the env and an OnPolicyRunner
(adaptive-KL Gaussian PPO, algo/ppo_continuous.py), and run
`learn(max_iterations)` with per-iteration console logging and periodic
model saves -- the reference's runner behavior
(rsl_rl/runners/on_policy_runner.py:82-226).  The tasks are
`drone_velocity`, `a1_velocity` (the default), `anymal_b_velocity`,
`anymal_c_velocity` and `cassie_velocity`.  Runs on the CUDA card unless
`--device cpu` is given.

Usage:
    python -m gennbv_tpu_torch.train.train_rsl --task a1_velocity \
        --num_envs 4096 --max_iterations 1500 [--log_dir runs/a1] [--resume]

`--recurrent` swaps in the LSTM actor-critic family
(rsl_rl/modules/actor_critic_recurrent.py analogue, algo/ppo_recurrent.py)
at its runner's own widths (LSTM 256, heads 256): like the JAX CLI it
ignores --hidden, --log_dir, --save_interval and --resume.
"""
from __future__ import annotations

import argparse
import os
import re

# a checkpoint's file name: model_<iteration>.pt
_CKPT = re.compile(r"model_(\d+)\.pt")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--task", default="a1_velocity",
                   help="registered task name (see gennbv_tpu_torch.registry)")
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--max_iterations", type=int, default=1500,
                   help="TOTAL iterations (a resumed run does the remainder)")
    p.add_argument("--num_steps_per_env", type=int, default=24)
    p.add_argument("--learning_rate", type=float, default=1e-3,
                   help="initial LR; adapted online from the KL target")
    p.add_argument("--log_dir", default=None,
                   help="checkpoint/log directory (default runs/<task>)")
    p.add_argument("--resume", action="store_true",
                   help="load the newest model_*.pt from --log_dir")
    p.add_argument("--save_interval", type=int, default=50)
    p.add_argument("--hidden", type=int, nargs="+", default=[512, 256, 128],
                   help="actor/critic MLP widths (rsl_rl default zoo sizes)")
    p.add_argument("--recurrent", action="store_true",
                   help="LSTM actor-critic (algo/ppo_recurrent.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (default: the CUDA card)")
    return p.parse_args(argv)


def newest_checkpoint(log_dir: str):
    """get_load_path semantics (legged_gym/utils/helpers.py:108-131):
    the highest-numbered model_<iter>.pt in the run dir, or None."""
    if not log_dir or not os.path.isdir(log_dir):
        return None
    iters = [int(m.group(1)) for m in map(_CKPT.fullmatch, os.listdir(log_dir))
             if m]
    if not iters:
        return None
    return os.path.join(log_dir, f"model_{max(iters)}.pt")


def main(argv=None):
    args = parse_args(argv)
    from gennbv_tpu_torch import registry
    from gennbv_tpu_torch.algo import ppo_continuous as ppoc
    from gennbv_tpu_torch.algo.on_policy_runner import (OnPolicyRunner,
                                                        OnPolicyRunnerConfig)

    env, _ = registry.make_env(args.task, None, device=args.device)
    log_dir = args.log_dir or os.path.join("runs", args.task)
    alg_cfg = ppoc.ContinuousPPOConfig(learning_rate=args.learning_rate)

    if args.recurrent:
        from gennbv_tpu_torch.algo.ppo_recurrent import RecurrentOnPolicyRunner
        runner = RecurrentOnPolicyRunner(
            env, alg_cfg, num_steps_per_env=args.num_steps_per_env,
            num_envs=args.num_envs, seed=args.seed)
        print(f"task={args.task} envs={args.num_envs} recurrent LSTM policy "
              f"device={args.device}", flush=True)
        runner.learn(args.max_iterations, log=True)
        return runner

    runner = OnPolicyRunner(
        env, alg_cfg,
        OnPolicyRunnerConfig(num_steps_per_env=args.num_steps_per_env,
                             save_interval=args.save_interval),
        num_envs=args.num_envs, log_dir=log_dir, seed=args.seed,
        actor_hidden=tuple(args.hidden), critic_hidden=tuple(args.hidden))

    if args.resume:
        ckpt = newest_checkpoint(log_dir)
        if ckpt is None:
            print(f"--resume: no model_*.pt under {log_dir}; starting fresh",
                  flush=True)
        else:
            runner.load(ckpt)
            print(f"resumed from {ckpt} (iteration {runner.iteration})",
                  flush=True)

    remaining = args.max_iterations - runner.iteration
    print(f"task={args.task} envs={args.num_envs} obs={env.obs_dim} "
          f"act={env.num_actions} iters={runner.iteration}"
          f"->{args.max_iterations} device={args.device}", flush=True)
    if remaining > 0:
        runner.learn(remaining, log=True)
        runner.save(os.path.join(log_dir, f"model_{runner.iteration}.pt"))
    else:
        print("nothing to do: already past --max_iterations", flush=True)
    return runner


if __name__ == "__main__":
    main()
