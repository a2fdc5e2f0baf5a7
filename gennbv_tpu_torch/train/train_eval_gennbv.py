"""Training with periodic held-out-scene evaluation, in the PyTorch port
(reference: gennbv/train/train_eval_gennbv.py -- 256 train envs + 50 eval
envs; port of ``gennbv_tpu/train/train_eval_gennbv.py``).  The eval batch
is a second env on the same device.

    python -m gennbv_tpu_torch.train.train_eval_gennbv --num_envs 256 \\
        --set env.camera.height=128 --set env.camera.width=128 \\
        --set runner.eval_camera=400

On converted meshes (``gennbv_tpu_torch/tools/convert_dataset.py``):
``--set env.scene.dataset=<train dir> --eval_dataset <held-out dir>``.
The eval dataset is recorded in the run's config.json (``eval_dataset``),
where ``tools/post_run.py`` takes its held-out family from.  Under
torchrun (see ``train_gennbv``) rank 0 runs the eval.
"""
from __future__ import annotations

import dataclasses
import os

from gennbv_tpu_torch import spec
from gennbv_tpu_torch.config import apply_overrides
from gennbv_tpu_torch.env import make_scenes
from gennbv_tpu_torch.train.train_gennbv import (build_argparser,
                                                 config_from_args, run)


def main(argv=None):
    p = build_argparser()
    p.add_argument("--eval_seed", type=int, default=100)
    p.add_argument("--eval_dataset", type=str, default=None,
                   help="scene dataset for the held-out eval batch (default: "
                        "the training dataset, correct for procedural "
                        "generators, where the eval seed yields unseen "
                        "scenes; a converted-mesh directory needs its own "
                        "held-out directory: the reference's batch-12 "
                        "setA split, env_eval_gennbv.py:16-50)")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    if cfg.runner.eval_freq == 0:
        # reference eval_freq = 500000 / num_envs env-steps ~= every 15 iters
        cfg = apply_overrides(cfg, ("runner.eval_freq=15",))

    from gennbv_tpu_torch.algo.runner import Runner
    from gennbv_tpu_torch.parallel.mesh import torchrun_group

    # held-out eval scenes: one per eval env, another generator seed (or a
    # separate converted-mesh directory via --eval_dataset)
    eval_scene_cfg = dataclasses.replace(
        cfg.env.scene, num_scenes=spec.EVAL_NUM_ENVS, seed=args.eval_seed,
        **({"dataset": args.eval_dataset} if args.eval_dataset else {}))
    eval_dataset = (os.path.abspath(args.eval_dataset) if args.eval_dataset
                    else None)
    with torchrun_group(args.device) as device:
        eval_scenes = make_scenes(eval_scene_cfg, cfg.env.renderer.resolution,
                                  device)
        run(Runner(cfg, eval_scenes=eval_scenes, device=device,
                   eval_dataset=eval_dataset), args)


if __name__ == "__main__":
    main()
