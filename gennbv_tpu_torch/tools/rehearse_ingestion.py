"""Rehearse the reference-format ingestion pipeline at production scale on
the port (counterpart of ``tools/rehearse_ingestion.py``).

The Houses3K/OmniObject3D meshes cannot be fetched here, so this proves the
mesh-ingestion path at the real shapes instead: it meshes the render grids
of 256 procedural houses (seed 0, the reference's training scale,
env_train_gennbv.py:21-54) and of 50 held-out ones (seed 100, the batch-12
analogue, env_eval_gennbv.py:16) into OBJs with the native mesher
(``convert_dataset.write_procedural_meshes``) and converts them
(``convert_dataset.convert``); then trains a short 256-env run on the
converted scenes with ``train_eval_gennbv --eval_dataset`` and reports its
held-out family with ``post_run``.  The same recipe on the procedural
scenes the meshes came from is the reference: the converted run's eval
coverage must lie within COVERAGE_TOL of it and, on the card, its
throughput within FPS_RATIO.  Both runs are the port's own: the JAX tool's
TPU numbers are not targets.

  python -m gennbv_tpu_torch.tools.rehearse_ingestion --stage synth  # OBJs + scenes.npz
  python -m gennbv_tpu_torch.tools.rehearse_ingestion --stage train  # both runs + post_run

``--smoke`` runs both stages at a tiny size on the CPU (8 + 50 houses at
R=16, 8 envs, a 16x16 camera), where no throughput is compared.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from gennbv_tpu_torch import spec
from gennbv_tpu_torch.algo.repro import read_logged
from gennbv_tpu_torch.tools import convert_dataset, post_run
from gennbv_tpu_torch.train import train_eval_gennbv

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_ROOT = os.path.join(ROOT, "data_rehearsal", "torch")
# the converter rescales each mesh into the scene box, so a converted house
# is not its procedural grid: the eval's final coverage was 0.6267 on the
# converted held-out houses against 0.7194 on the procedural ones in
# chip_smoke.py's runs on an H100 (phases 10 and 7), 0.084 against 0.184
# at the smoke size; an ingestion fault (an empty or misplaced house)
# costs far more
COVERAGE_TOL = 0.15
# the converted scenes hold more surface points (their Q), which only the
# splat sees (under 1% of an iteration on the card)
FPS_RATIO = 0.5
SIZES = {  # houses to train on and hold out, render resolution, the run
    "full": dict(num_train=256, num_eval=spec.EVAL_NUM_ENVS, res=64,
                 overrides=("env.num_envs=256", "env.scene.num_scenes=256")),
    "smoke": dict(num_train=8, num_eval=spec.EVAL_NUM_ENVS, res=16, overrides=(
        "env.num_envs=8", "env.scene.num_scenes=8", "env.camera.height=16",
        "env.camera.width=16", "env.renderer.resolution=16", "ppo.n_steps=4",
        "ppo.batch_size=16")),
}


def synth(out: str, num_train: int, num_eval: int, res: int) -> dict:
    """Meshes and converts the training and held-out houses into
    `out`/train and `out`/eval; returns their seconds."""
    secs = {}
    for tag, n, seed in (("train", num_train, 0), ("eval", num_eval, 100)):
        t0 = time.perf_counter()
        meshes = os.path.join(out, f"meshes_{tag}")
        convert_dataset.write_procedural_meshes(meshes, n, seed, res)
        convert_dataset.convert(meshes, os.path.join(out, tag), res,
                                spec.GRID_SIZE, 1.0, verbose=False)
        secs[tag] = time.perf_counter() - t0
        print(f"meshed and converted {n} {tag} houses at R={res} in "
              f"{secs[tag]:.1f} s", flush=True)
    return secs


def _train(out: str, name: str, iters: int, overrides, device: str,
           dataset_args: list) -> dict:
    log_dir = os.path.join(out, "runs", name)
    argv = ["--device", device, "--log_dir", log_dir, "--exp_name", name,
            "--max_iterations", str(iters), "--eval_freq", str(iters),
            "--set", "runner.save_freq=0", *dataset_args]
    for item in overrides:
        argv += ["--set", item]
    train_eval_gennbv.main(argv)
    (run,) = os.listdir(log_dir)
    logged = read_logged(os.path.join(log_dir, run))
    steady = logged[1:] or logged
    return {"run_dir": os.path.join(log_dir, run),
            "fps": sum(r["time/fps"] for r in steady) / len(steady),
            "train_final_coverage": logged[-1]["rollout/final_coverage"],
            "eval_final_coverage": logged[-1]["eval/final_coverage"],
            "eval_mean_AUC": logged[-1]["eval/mean_AUC"]}


def train(out: str, iters: int, size: str, device: str) -> dict:
    """Both runs and the converted run's post_run; raises unless the
    converted path holds to the procedural one.  Writes and returns
    `out`/report.json."""
    overrides = SIZES[size]["overrides"]
    converted = _train(out, "converted", iters, overrides, device, [
        "--set", f"env.scene.dataset={os.path.join(out, 'train')}",
        "--eval_dataset", os.path.join(out, "eval")])
    procedural = _train(out, "procedural", iters, overrides, device, [])
    report = post_run.main([converted["run_dir"], "--only", "held_out_houses",
                            "--no-artifacts", "--device", device])
    gap = abs(converted["eval_final_coverage"]
              - procedural["eval_final_coverage"])
    if gap > COVERAGE_TOL:
        raise AssertionError(f"converted eval coverage "
                             f"{converted['eval_final_coverage']:.4f} is "
                             f"{gap:.4f} from the procedural run's")
    # a CPU run gives no device rate to compare
    if device != "cpu" and converted["fps"] < FPS_RATIO * procedural["fps"]:
        raise AssertionError(f"converted {converted['fps']:.1f} env-steps/s "
                             f"against procedural {procedural['fps']:.1f}")
    result = {"iters": iters, "size": size, "device": device,
              "converted": converted, "procedural": procedural,
              "held_out_houses": report["held_out_houses"],
              "scenes": (f"converted-mesh (native voxelizer), "
                         f"{SIZES[size]['num_train']} train + "
                         f"{SIZES[size]['num_eval']} eval")}
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", choices=("synth", "train", "all"), default="all")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out", default=OUT_ROOT)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes on the CPU (see the module's docstring)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    size = "smoke" if args.smoke else "full"
    device = "cpu" if args.smoke else args.device
    out = {}
    if args.stage in ("synth", "all"):
        out["synth_seconds"] = synth(
            args.out, *(SIZES[size][k] for k in ("num_train", "num_eval",
                                                  "res")))
    if args.stage in ("train", "all"):
        out.update(train(args.out, args.iters, size, device))
    return out


if __name__ == "__main__":
    main()
