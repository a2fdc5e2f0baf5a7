"""A trained policy's weights for a cell that evaluates one in place of the
seed's random weights (a configuration's ``"weights"`` file, under
``policies/``), and the training that made them: the port's ``Runner``
on a configuration's recipe, its own initialisation from ``--seed``, the
benchmark's procedural training scenes.  The file is JSON: the recipe,
each iteration's rollout reward and coverage, and the state_dict's
tensors as their bytes in base64 (float32, and the BatchNorms' int64
counts).  ``policies/flagship128_it100.json`` was made by

    python3 -m benchmark.trained --config gennbv_flagship128 \\
        --iterations 100 --seed 20 --out benchmark/policies/flagship128_it100.json

Runs on a CUDA card; never part of a benchmark run."""
from __future__ import annotations

import argparse
import base64
import json
import os
import sys
import tempfile

import numpy as np
import torch

from benchmark import harness


def load(path: str, device) -> dict:
    """The state_dict held in the file `path` (relative to the repo's
    root), on `device`."""
    with open(harness.ROOT / path) as f:
        held = json.load(f)["state_dict"]
    return {k: torch.from_numpy(np.frombuffer(
        base64.b64decode(v["data"]), dtype=v["dtype"]).reshape(v["shape"])
        .copy()).to(device) for k, v in held.items()}


def dump(state_dict: dict, path: str, about: dict) -> None:
    """Writes `state_dict` (float32 tensors and integer BatchNorm counts)
    with `about` to the file `path`."""
    held = {}
    for k, v in state_dict.items():
        a = v.detach().cpu().contiguous().numpy()
        held[k] = {"dtype": a.dtype.name, "shape": list(a.shape),
                   "data": base64.b64encode(a.tobytes()).decode("ascii")}
    with open(path, "w") as f:
        json.dump(dict(about, state_dict=held), f)
        f.write("\n")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--iterations", type=int, required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("trained: needs a CUDA card", file=sys.stderr)
        return 1
    from gennbv_tpu_torch.algo.runner import Runner
    spec = harness.load_spec()
    entry = next(c for c in spec["configs"] if c["name"] == args.config)
    cfg = json.loads((harness.ROOT / entry["file"]).read_text())["config"]
    env = cfg["env"]
    arrays = harness.scene_arrays(env, env["scene"]["num_scenes"],
                                  env["scene"]["seed"])
    log_dir = tempfile.mkdtemp(prefix="benchmark_trained_")
    runner = Runner(harness.port_config(cfg, args.seed),
                    scenes=harness.program_scenes(
                        harness.to_device(arrays, "cuda"), env),
                    log_dir=log_dir, device="cuda")
    runner.train(args.iterations)
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        curve = [[m["rollout/episode_reward"], m["rollout/final_coverage"]]
                 for m in map(json.loads, f)]
    dump(runner.policy.state_dict(), args.out, {
        "config": args.config, "iterations": args.iterations,
        "seed": args.seed, "card": torch.cuda.get_device_name(),
        "rollout_reward_and_coverage": curve})
    return 0


if __name__ == "__main__":
    sys.exit(main())
