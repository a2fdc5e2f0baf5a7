"""Metrics logger: stdout + CSV + JSONL, optional TensorBoard / wandb
(a copy of ``gennbv_tpu/utils/logger.py``, which the port cannot import:
importing it runs the JAX package's ``__init__``).

Replaces the SB3 Logger + KVWriter stack (stable_baselines3/common/
logger.py:121-350) and the wandb callback (wandb_utils/wandb_callback.py).
Key names mirror the reference (`rollout/*`, `train/*`, `eval/*`, `time/*`)
so training curves are directly comparable.
"""
from __future__ import annotations

import csv
import json
import os
import sys
import time
from typing import Dict, Optional


class Logger:
    def __init__(self, log_dir: str, config: Optional[dict] = None,
                 use_wandb: bool = False, project: str = "gennbv-tpu",
                 run_name: Optional[str] = None):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._csv_path = os.path.join(log_dir, "metrics.csv")
        self._csv_file = None
        self._csv_writer = None
        self._csv_keys = None
        self._tb = None
        self._wandb = None

        if config is not None:
            with open(os.path.join(log_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

        try:  # TensorBoard is optional
            from torch.utils.tensorboard import SummaryWriter  # type: ignore
            self._tb = SummaryWriter(log_dir=os.path.join(log_dir, "tb"))
        except Exception:
            self._tb = None

        if use_wandb:
            try:
                import wandb  # type: ignore
                self._wandb = wandb.init(
                    project=project, name=run_name, config=config, dir=log_dir
                )
            except Exception as e:  # offline or not logged in: go on without
                print(f"[logger] wandb unavailable ({e}); continuing without", file=sys.stderr)
                self._wandb = None

    def log(self, metrics: Dict[str, float], step: int):
        record = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

        if self._csv_writer is None:
            self._csv_keys = list(record.keys())
            self._csv_file = open(self._csv_path, "a", newline="")
            self._csv_writer = csv.DictWriter(self._csv_file, fieldnames=self._csv_keys,
                                              extrasaction="ignore")
            if self._csv_file.tell() == 0:
                self._csv_writer.writeheader()
        self._csv_writer.writerow(record)
        self._csv_file.flush()

        if self._tb is not None:
            for k, v in record.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(record, step=step)

    def print_table(self, metrics: Dict[str, float], step: int, width: int = 46):
        """Human stdout block, SB3 HumanOutputFormat-style (logger.py:121)."""
        lines = ["-" * width]
        lines.append(f"| {'iteration':<26} | {step:<13} |")
        for k in sorted(metrics):
            v = metrics[k]
            sv = f"{v:.4g}" if isinstance(v, float) else str(v)
            lines.append(f"| {k[:26]:<26} | {sv:<13} |")
        lines.append("-" * width)
        print("\n".join(lines), flush=True)

    def close(self):
        self._jsonl.close()
        if self._csv_file:
            self._csv_file.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
