"""Entry points of the PyTorch port (counterpart of the root
``__graft_entry__.py``, which stays the JAX package's):

- ``entry()``: the flagship policy forward and an example batch;
- ``dryrun_multichip(n)``: one full training iteration (rollout, GAE and
  the 5-epoch PPO update's loop at 2 epochs) on n ranks at tiny shapes,
  then, for an even n of at least 4, its tensor-parallel variant (env n/2
  x model 2).

    python -m gennbv_tpu_torch.graft_entry [n] [--device cpu]

A rank is a process (``parallel.mesh.launch``), so the JAX version's
re-execution on a forced virtual CPU mesh has no counterpart.  The ranks
run over nccl where the host has a card for each, else over gloo, sharing
the card or the CPU; tensor parallelism on a shared card raises
(``parallel.mesh.make_mesh_tp``).
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from gennbv_tpu_torch import spec
from gennbv_tpu_torch.config import (CameraConfig, Config, EnvConfig,
                                     ModelConfig, PPOConfig, RendererConfig,
                                     RunnerConfig, SceneConfig)
from gennbv_tpu_torch.models.policy import ActorCriticPolicy
from gennbv_tpu_torch.parallel import mesh as mesh_lib


def entry(device: str = "cuda"):
    """Returns (fn, example_args): ``fn(policy, obs) -> (logits, value)``,
    the eval-mode forward of the full-width ActorCriticPolicy (weights
    from seed 0), and (that policy, zeros [8, OBS_DIM])."""
    policy = ActorCriticPolicy(
        ModelConfig(), torch.Generator(device).manual_seed(0), device).eval()

    @torch.no_grad()
    def fn(policy, obs):
        out = policy(obs)
        return out.logits, out.value

    return fn, (policy, torch.zeros(8, spec.OBS_DIM, device=device))


def dryrun_config(n_devices: int, model_axis: int = 1) -> Config:
    """The JAX dryrun's tiny config (``__graft_entry__.py``): 2 envs a
    rank, 16x16 camera and render grid, 4 steps, 2 epochs."""
    num_envs = 2 * n_devices
    return Config(
        env=EnvConfig(
            num_envs=num_envs,
            camera=CameraConfig(height=16, width=16),
            renderer=RendererConfig(resolution=16, zbuf_impl="mxu"),
            scene=SceneConfig(num_scenes=num_envs, seed=0),
            max_episode_length=6,
        ),
        ppo=PPOConfig(n_steps=4, batch_size=2 * num_envs, n_epochs=2,
                      total_iters=1),
        runner=RunnerConfig(seed=0, save_freq=0, num_devices=n_devices,
                            model_axis=model_axis),
    )


def _train_rank(device: torch.device, cfg: Config) -> dict:
    from gennbv_tpu_torch.algo.runner import Runner
    metrics = Runner(cfg, device=device).train(1, log=False)
    bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"non-finite metrics {bad}")
    return metrics


def dryrun_multichip(n_devices: int, device: str | None = None) -> list:
    """Trains one iteration of ``dryrun_config`` on `n_devices` ranks and,
    for an even count of at least 4, on env n/2 x model 2; asserts every
    metric finite and prints one line a run.  Returns each run's metrics
    (rank 0's; every rank holds the same summed values).  `device`:
    "cuda" (the default) or "cpu"."""
    device = torch.device(device or "cuda")
    backend = mesh_lib.backend_for(device, n_devices)
    runs = [("", 1)]
    if n_devices % 2 == 0 and n_devices >= 4:
        runs.append((f" TP (env={n_devices // 2} x model=2)", 2))
    out = []
    for label, model_axis in runs:
        t0 = time.perf_counter()
        metrics = mesh_lib.launch(_train_rank, n_devices,
                                  dryrun_config(n_devices, model_axis),
                                  device=str(device), backend=backend)[0]
        secs = time.perf_counter() - t0
        print(f"dryrun_multichip({n_devices}){label} OK on {device.type} over "
              f"{backend} in {secs:.1f} s:",
              {k: round(float(v), 4) for k, v in list(metrics.items())[:4]},
              flush=True)
        out.append({**metrics, "seconds": secs})
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, nargs="?", default=2,
                   help="ranks of the dry run (default 2)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    fn, example = entry(args.device)
    logits, value = fn(*example)
    print("entry logits/value:", tuple(logits.shape), tuple(value.shape))
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
