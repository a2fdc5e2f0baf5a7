"""Training entry point of the PyTorch port (reference:
gennbv/train/train_gennbv.py; port of ``gennbv_tpu/train/train_gennbv.py``).

    python -m gennbv_tpu_torch.train.train_gennbv --num_envs 256 --max_iterations 1000

Any config field can be overridden with `--set a.b.c=value`.  Runs on the
CUDA card unless `--device cpu` is given.

On several ranks (``runner.num_devices``, ``num_slices``, ``model_axis``;
``parallel/mesh.py``), one process a rank under torchrun, e.g.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m gennbv_tpu_torch.train.train_gennbv --set runner.num_devices=2

Each rank takes cuda:LOCAL_RANK over nccl, or the CPU over gloo with
``--device cpu``.  Rank 0 prints, logs and writes the checkpoints.
"""
from __future__ import annotations

import argparse

from gennbv_tpu_torch.config import Config, apply_overrides


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--max_iterations", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max_episode_length", type=int, default=None)
    p.add_argument("--num_scenes", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--exp_name", type=str, default=None)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--eval_freq", type=int, default=None,
                   help="iterations between in-training evals (train_eval entry)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="dotted-path config override, e.g. env.camera.height=400")
    p.add_argument("--resume", type=str, default=None, metavar="MODELS_DIR",
                   help="resume from the latest rl_model_*_steps checkpoint "
                        "in this directory (reference: --resume/get_load_path, "
                        "legged_gym/utils/helpers.py:108-131)")
    p.add_argument("--resume_params", type=str, default=None,
                   metavar="MODELS_DIR",
                   help="warm-start {params, batch_stats} only from the "
                        "latest checkpoint; fresh optimizer + step counter "
                        "(fine-tune mode; reference: model.set_parameters, "
                        "gennbv/train/train_gennbv.py:218-220)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (default: the CUDA card)")
    return p


# each flag and the config field it sets
_FLAGS = (("num_envs", "env.num_envs"), ("max_iterations", "ppo.total_iters"),
          ("seed", "runner.seed"), ("max_episode_length", "env.max_episode_length"),
          ("num_scenes", "env.scene.num_scenes"),
          ("learning_rate", "ppo.learning_rate"), ("log_dir", "runner.log_dir"),
          ("exp_name", "runner.experiment_name"), ("eval_freq", "runner.eval_freq"))


def config_from_args(args) -> Config:
    overrides = [f"{key}={getattr(args, flag)}" for flag, key in _FLAGS
                 if getattr(args, flag) is not None]
    if args.wandb:
        overrides.append("runner.wandb=true")
    return apply_overrides(Config(), (*overrides, *args.set))


def run(runner, args) -> None:
    """Restores what --resume or --resume_params names, trains to
    ppo.total_iters iterations in all, prints the last metrics and closes
    the runner."""
    if args.resume:
        step = runner.restore(args.resume)
        print(f"resumed from {args.resume} at step {step}")
    elif args.resume_params:
        runner.restore(args.resume_params, params_only=True)
        print(f"warm-started params from {args.resume_params}")
    try:
        metrics = runner.train(runner.cfg.ppo.total_iters)
        if runner.rank == 0:
            print("final:", {k: round(v, 4) for k, v in metrics.items()})
    finally:
        runner.close()


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cfg = config_from_args(args)

    from gennbv_tpu_torch.algo.runner import Runner
    from gennbv_tpu_torch.parallel.mesh import torchrun_group

    with torchrun_group(args.device) as device:
        run(Runner(cfg, device=device), args)


if __name__ == "__main__":
    main()
