"""Checkpoints of {policy, optimizer state, step} (port of
``gennbv_tpu/utils/checkpoint.py``).

The writer policy is the reference's (gennbv/callback.py:25-70), under the
JAX package's names: periodic ``rl_model_<steps>_steps`` saves plus
``rl_model_best_<metric>``.  Each checkpoint is one ``torch.save`` file of
host tensors: the policy's state_dict, the Adam state (mu and nu keyed by
parameter name, and the count as a Python int) and the global step.  A
save takes a module or its state_dict: the Runner saves the snapshot of
the iteration it processes, whose policy has moved on.  It is written beside
its name and then renamed, so a reader never sees a partial file.

In a process group every rank calls ``save`` (under tensor parallelism the
sharded tensors are gathered whole, a collective) and rank 0 writes; every
rank loads.  A checkpoint therefore holds whole tensors whatever the mesh.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from gennbv_tpu_torch.algo.ppo import AdamState
from gennbv_tpu_torch.parallel import mesh as mesh_lib


def _host(tensors: dict) -> dict:
    return {k: mesh_lib.full(v.detach()).cpu() for k, v in tensors.items()}


class CheckpointManager:
    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = os.path.abspath(ckpt_dir)

    def _path(self, name: str) -> str:
        return os.path.join(self.ckpt_dir, name)

    def save(self, name: str, policy: torch.nn.Module | dict,
             opt_state: AdamState, step: int):
        """Writes `policy` (a module, or a state_dict) and `opt_state`
        (whose count is an int or a 0-d tensor) as checkpoint `name`."""
        if isinstance(policy, torch.nn.Module):
            policy = policy.state_dict()
        payload = {"policy": _host(policy),
                   "opt_state": {"mu": _host(opt_state.mu),
                                 "nu": _host(opt_state.nu),
                                 "count": int(opt_state.count)},
                   "step": step}
        if dist.is_initialized() and dist.get_rank() != 0:
            return
        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = self._path(name)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)

    def save_step(self, step: int, policy, opt_state: AdamState):
        self.save(f"rl_model_{step}_steps", policy, opt_state, step)

    def save_best(self, metric_name: str, policy, opt_state: AdamState,
                  step: int):
        self.save(f"rl_model_best_{metric_name}", policy, opt_state, step)

    def restore(self, name: str, device: torch.device | str = "cpu"
                ) -> tuple[dict, AdamState, int]:
        """(policy state_dict, AdamState, step) of a checkpoint, on
        `device`; the count a 0-d int64 tensor there, as ``ppo.update``
        keeps it."""
        raw = torch.load(self._path(name), map_location=device,
                         weights_only=True)
        opt = raw["opt_state"]
        count = torch.tensor(opt["count"], dtype=torch.int64, device=device)
        return raw["policy"], AdamState(opt["mu"], opt["nu"], count), \
            raw["step"]

    def restore_policy(self, name: str, device: torch.device | str = "cpu"
                       ) -> dict:
        """Only the policy's state_dict -- for play/eval/export, or a
        warm start that keeps a fresh optimizer."""
        return self.restore(name, device)[0]

    def latest_step(self) -> Optional[int]:
        steps = []
        if not os.path.isdir(self.ckpt_dir):
            return None
        for d in os.listdir(self.ckpt_dir):
            parts = d.split("_")
            if d.startswith("rl_model_") and d.endswith("_steps"):
                try:
                    steps.append(int(parts[2]))
                except ValueError:
                    pass
        return max(steps) if steps else None
