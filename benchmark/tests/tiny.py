"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
harness's tests: the same loops, references and comparisons, with the
configuration's and the mix's sizes made small."""
from __future__ import annotations

import copy

import torch

from benchmark import harness

# limits of the tiny cells on the CPU, where program and reference run
# the same plain operations: every comparison exact or at rounding
LIMITS = {"env_mismatches": 0, "value_gap": 1e-4,
          "adv_gap": 1e-4, "loss_gap": 1e-4, "grad_gap": 1e-3,
          "step_gap": 1e-3, "logit_gap": 1e-4}


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.find_cell(harness.load_spec(), name)
    config = copy.deepcopy(cell.config)
    env = config["config"]["env"]
    env["num_envs"] = 4
    env["camera"]["height"] = env["camera"]["width"] = 16
    env["renderer"]["resolution"] = 16
    env["scene"]["num_scenes"] = 4
    ppo = config["config"]["ppo"]
    ppo.update(n_steps=4, batch_size=8)
    traffic = copy.deepcopy(cell.traffic)
    if traffic["loop"] == "eval":
        traffic["eval_env"].update(num_envs=4, max_episode_length=5)
        traffic["eval_scenes"]["count"] = 4
    return cell._replace(config=config, traffic=traffic, limits=dict(LIMITS))


def run_tiny(name: str, seed: int = 3, traced: bool = False,
             precision: str = "float32") -> dict:
    """One run of the tiny cell on the CPU."""
    from benchmark import run
    torch.set_num_threads(1)
    return run.run_cell(tiny_cell(name), seed, 0.05, traced, device="cpu",
                        precision=precision)
