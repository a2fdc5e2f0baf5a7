"""Train the flagship next-best-view policy at a tiny size (port of
``examples/01_train_nbv_policy.py``).

    python -m gennbv_tpu_torch.examples.train_nbv_policy [--device cpu]

Production settings are the defaults (``python -m
gennbv_tpu_torch.train.train_gennbv`` with no flags is the reference's
256-env configuration); this example shrinks everything, as the JAX one
does: 8 envs at a 16x16 camera, 3 iterations.  Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

from gennbv_tpu_torch.algo.runner import Runner
from gennbv_tpu_torch.config import (CameraConfig, Config, EnvConfig,
                                     PPOConfig, RendererConfig, RunnerConfig,
                                     SceneConfig)


def main(argv=None) -> dict:
    """Trains the example's run; returns its last metrics."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    device = p.parse_args(argv).device
    cfg = Config(
        env=EnvConfig(
            num_envs=8,
            camera=CameraConfig(height=16, width=16),
            renderer=RendererConfig(resolution=16),
            scene=SceneConfig(num_scenes=4, seed=0),
            max_episode_length=8,
        ),
        ppo=PPOConfig(n_steps=8, batch_size=16, n_epochs=2, total_iters=3),
        runner=RunnerConfig(seed=0, save_freq=0),
    )
    runner = Runner(cfg, device=device)
    metrics = runner.train(cfg.ppo.total_iters, log=False)
    print(f"final coverage: {metrics['rollout/final_coverage']:.3f}  "
          f"reward: {metrics['rollout/episode_reward']:.2f}")
    runner.close()
    return metrics


if __name__ == "__main__":
    main()
