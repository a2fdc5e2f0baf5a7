"""Post-training report of a run of the PyTorch port: the held-out eval,
the objects zero-shot family and the convex floor probe, plus artifacts
(port of ``tools/post_run.py``).

Runs the reference's eval protocol (50 scenes x 30 steps, coverage, AUC
and the chamfer accuracy decomposition) on a finished run's
best-by-eval checkpoint (falling back to best-by-train-reward, then the
latest), for three scene families:

  1. held_out_houses: the run's training family under the eval seed;
  2. objects_zero_shot: dataset='objects' (the OmniObject3D analogue),
     eval seed + 1;
  3. convex_floor_probe: dataset='convex' (single cavity-free primitives,
     where every GT surface point is imageable), eval seed + 2;

then, unless --no-artifacts, env 0's episode GIF and reconstruction
PLY/OBJ through ``train/play.py``.

    python -m gennbv_tpu_torch.tools.post_run runs/<exp>/ --eval_cam 400
    python -m gennbv_tpu_torch.tools.post_run runs/<exp>/ --device cpu

The run directory is one written by the port's Runner (config.json,
models/).  Prints the report as JSON and writes it to
<run_dir>/report.json, with the JAX report's keys and two more: the
held-out family's dataset (``held_out_dataset``) and ``eval_cam``.
The held-out family runs on --holdout_dataset, else on the eval dataset
the run recorded (``train_eval_gennbv --eval_dataset``), else on the
run's training dataset under the eval seed.  --export NAME also
copies the claim-backing artifacts (report.json, config.json, an
eval-curve CSV and the last metrics row) into the tracked reports/NAME/.
Runs on the CUDA card unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import shutil
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CKPT_PREFERENCE = ("rl_model_best_eval_coverage", "rl_model_best_episode_reward")

# metrics.jsonl keys kept in the exported eval-curve CSV
_CURVE_KEYS = (
    "step", "global_step", "eval/final_coverage", "eval/mean_AUC",
    "eval/coverage_curve_AUC", "eval/init_coverage", "eval/mean_reward",
    "eval/mean_ep_length", "rollout/episode_reward_rolling",
    "rollout/final_coverage", "train/learning_rate", "time/fps",
)


def export_report(run_dir: str, name: str, root: str = ROOT) -> str:
    """Copy a run's claim-backing artifacts into <root>/reports/<name>/:
    report.json (if post_run wrote one), config.json, an eval-curve CSV
    distilled from metrics.jsonl (the rows with an eval, plus the last
    row) and last_metrics.json (the last full metrics row)."""
    out_dir = os.path.join(root, "reports", name)
    os.makedirs(out_dir, exist_ok=True)
    for fname in ("report.json", "config.json"):
        src = os.path.join(run_dir, fname)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(out_dir, fname))

    jsonl = os.path.join(run_dir, "metrics.jsonl")
    if os.path.exists(jsonl):
        rows = []
        with open(jsonl) as f:
            for line in f:
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        if rows:
            eval_rows = [r for r in rows if "eval/final_coverage" in r]
            keep = eval_rows if eval_rows else rows[-10:]
            if rows[-1] is not keep[-1]:
                keep = keep + [rows[-1]]
            with open(os.path.join(out_dir, "eval_curve.csv"), "w",
                      newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(_CURVE_KEYS),
                                   extrasaction="ignore")
                w.writeheader()
                for r in keep:
                    w.writerow({k: r.get(k, "") for k in _CURVE_KEYS})
            with open(os.path.join(out_dir, "last_metrics.json"), "w") as f:
                json.dump(rows[-1], f, indent=1)
    return out_dir


def pick_checkpoint(models_dir: str) -> str:
    """The checkpoint to report: best by held-out eval, else best by
    training reward, else the latest periodic one."""
    for name in CKPT_PREFERENCE:
        if os.path.isfile(os.path.join(models_dir, name)):
            return name
    steps = [int(d.split("_")[2]) for d in os.listdir(models_dir)
             if d.startswith("rl_model_") and d.endswith("_steps")]
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {models_dir}")
    return f"rl_model_{max(steps)}_steps"


def run_env_config(raw: dict, eval_cam: int = 0):
    """The eval env config of a run from its config.json: camera, renderer
    and top-level env settings restored over ``eval_env_config``, keeping
    the eval protocol's episode cap, env count and no coverage
    termination (the reference eval drops it, env_eval_gennbv.py:338-351);
    eval_cam > 0 swaps in a square camera of that resolution."""
    from gennbv_tpu_torch.config import Config, eval_env_config, with_camera

    env_cfg = eval_env_config(Config().env)
    env_raw = raw.get("env", {})
    cam = env_raw.get("camera", {})
    ren = env_raw.get("renderer", {})
    env_cfg = dataclasses.replace(
        env_cfg,
        camera=dataclasses.replace(env_cfg.camera, **{
            k: v for k, v in cam.items() if hasattr(env_cfg.camera, k)}),
        renderer=dataclasses.replace(env_cfg.renderer, **{
            k: v for k, v in ren.items() if hasattr(env_cfg.renderer, k)}),
        **{k: v for k, v in env_raw.items()
           if isinstance(v, (int, float, str, bool))
           and hasattr(env_cfg, k)
           and k not in ("num_envs", "max_episode_length",
                         "coverage_done_threshold")},
    )
    return with_camera(env_cfg, eval_cam) if eval_cam else env_cfg


def families(raw: dict, eval_seed: int, holdout_dataset=None):
    """(tag, dataset, seed) of the report's three scene families.  The
    held-out family's dataset is holdout_dataset, else the eval dataset
    the run recorded (train_eval_gennbv --eval_dataset), else the run's
    training dataset under the eval seed (the JAX post_run's rule)."""
    holdout = (holdout_dataset or raw.get("eval_dataset")
               or raw.get("env", {}).get("scene", {}).get("dataset",
                                                          "procedural"))
    return (("held_out_houses", holdout, eval_seed),
            ("objects_zero_shot", "objects", eval_seed + 1),
            ("convex_floor_probe", "convex", eval_seed + 2))


def family_env(env_cfg, raw: dict, dataset: str, seed: int, device):
    """The eval env of one family: the run's scene settings, one scene per
    eval env, the family's dataset and seed."""
    from gennbv_tpu_torch import spec
    from gennbv_tpu_torch.env import ReconEnv, make_scenes

    scn = raw.get("env", {}).get("scene", {})
    scene_cfg = dataclasses.replace(env_cfg.scene, **{
        k: v for k, v in scn.items()
        if hasattr(env_cfg.scene, k) and k not in ("num_scenes", "seed", "dataset")})
    scene_cfg = dataclasses.replace(scene_cfg, num_scenes=spec.EVAL_NUM_ENVS,
                                    seed=seed, dataset=dataset)
    scenes = make_scenes(scene_cfg, env_cfg.renderer.resolution, device)
    return ReconEnv(dataclasses.replace(env_cfg, scene=scene_cfg), scenes)


def load_policy(raw: dict, models_dir: str, ckpt_name: str, device):
    """The run's policy (its config.json's model settings) with the
    checkpoint's parameters and BatchNorm statistics."""
    from gennbv_tpu_torch.config import ModelConfig
    from gennbv_tpu_torch.models.policy import ActorCriticPolicy
    from gennbv_tpu_torch.utils.checkpoint import CheckpointManager

    policy = ActorCriticPolicy(ModelConfig(**raw.get("model", {})),
                               device=device)
    policy.load_state_dict(
        CheckpointManager(models_dir).restore_policy(ckpt_name, device))
    return policy


def play_overrides(raw: dict, eval_cam: int = 0) -> list:
    """``--set`` arguments that give play.main the run's env settings, so
    the playback env matches the checkpoint (play.main would otherwise
    build the default Config); eval_cam > 0 swaps in its camera."""
    overrides = []
    for section in ("camera", "renderer", "scene"):
        for k, v in raw.get("env", {}).get(section, {}).items():
            if isinstance(v, (int, float, str, bool)):
                overrides += ["--set", f"env.{section}.{k}={v}"]
    for k, v in raw.get("env", {}).items():
        if isinstance(v, (int, float, str, bool)) and k != "num_envs":
            overrides += ["--set", f"env.{k}={v}"]
    if eval_cam:  # appended last: a later --set wins
        overrides += ["--set", f"env.camera.height={eval_cam}",
                      "--set", f"env.camera.width={eval_cam}"]
    return overrides


def family_report(res) -> dict:
    """One family's entry of the report, rounded as the JAX report is."""
    return {
        "final_coverage": round(res.mean_final_coverage, 4),
        "mean_AUC": round(res.mean_auc, 4),
        "mean_accuracy_x100m2": round(res.mean_accuracy_cm, 3),
        # accuracy decomposition: scan2gt is GT-sampling-bound (floor/4);
        # gt2scan splits into a seen part (scan-sampling-bound) and an
        # unseen coverage tail (gt_unseen_frac of GT points)
        "accuracy_scan2gt": round(res.accuracy_scan2gt, 3),
        "accuracy_gt2scan": round(res.accuracy_gt2scan, 3),
        "accuracy_gt2scan_seen": round(res.accuracy_gt2scan_seen, 3),
        "gt_unseen_frac": round(res.gt_unseen_frac, 4),
        "accuracy_floor_gt_sampling": round(res.accuracy_floor_gt_sampling, 3),
        "mean_reward": round(res.mean_reward, 4),
        "mean_ep_length": round(res.mean_ep_length, 2),
        # reward-AUC is benchmark-relative (the forced init view's coverage
        # is uncounted); these make the init-view share and the plotted
        # curve's integral explicit
        "init_coverage": round(res.mean_init_coverage, 4),
        "coverage_curve_AUC": round(res.mean_curve_auc, 4),
    }


def main(argv=None) -> dict:
    """Writes and returns the report."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir")
    ap.add_argument("--no-artifacts", action="store_true")
    ap.add_argument("--export", type=str, default=None, metavar="NAME",
                    help="copy report.json/config.json/eval-curve CSV into "
                         "the tracked reports/NAME/ directory")
    ap.add_argument("--eval_seed", type=int, default=100)
    ap.add_argument("--eval_cam", type=int, default=0,
                    help="evaluate under this camera resolution instead of "
                         "the run's training camera (0 = run's)")
    ap.add_argument("--point_stride", type=int, default=8,
                    help="pixel stride of the scan points accumulated for "
                         "the chamfer accuracy (the reference accumulates "
                         "every foreground pixel, i.e. stride 1)")
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated eval-family tags to run "
                         "(held_out_houses,objects_zero_shot,"
                         "convex_floor_probe); default all")
    ap.add_argument("--holdout_dataset", type=str, default=None,
                    help="scene dataset for the held_out_houses family "
                         "(default: the eval dataset the run recorded in "
                         "config.json, else the run's training dataset + "
                         "eval seed, correct for procedural generators)")
    ap.add_argument("--report_name", type=str, default="report.json",
                    help="file name of the report inside run_dir")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from gennbv_tpu_torch.algo import evaluation

    run_dir = args.run_dir.rstrip("/")
    models_dir = os.path.join(run_dir, "models")
    ckpt_name = pick_checkpoint(models_dir)
    # the run's config (written by its Logger) restores camera, renderer
    # and scene settings
    with open(os.path.join(run_dir, "config.json")) as f:
        raw = json.load(f)
    env_cfg = run_env_config(raw, args.eval_cam)
    fams = families(raw, args.eval_seed, args.holdout_dataset)
    policy = load_policy(raw, models_dir, ckpt_name, args.device)

    # beside the JAX report's keys: what the held-out family ran on
    report = {"checkpoint": ckpt_name, "held_out_dataset": fams[0][1],
              "eval_cam": args.eval_cam}
    only = set(args.only.split(",")) if args.only else None
    for tag, dataset, seed in fams:
        if only is not None and tag not in only:
            continue
        env = family_env(env_cfg, raw, dataset, seed, args.device)
        t0 = time.perf_counter()
        res = evaluation.evaluate(env, policy, point_stride=args.point_stride)
        report[tag] = family_report(res)
        print(f"{tag}: {report[tag]} ({time.perf_counter() - t0:.3f} s)",
              flush=True)

    if not args.no_artifacts:
        from gennbv_tpu_torch.train import play
        art_dir = os.path.join(run_dir, "artifacts")
        os.makedirs(art_dir, exist_ok=True)
        play.main([
            "--ckpt", os.path.join(models_dir, ckpt_name),
            "--gif", os.path.join(art_dir, "episode.gif"),
            "--ply", os.path.join(art_dir, "recon.ply"),
            "--obj", os.path.join(art_dir, "recon.obj"),
            "--device", args.device,
        ] + play_overrides(raw, args.eval_cam))
        report["artifacts"] = art_dir

    if args.point_stride != 8:
        report["point_stride"] = args.point_stride
    with open(os.path.join(run_dir, args.report_name), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    if args.export:
        out_dir = export_report(run_dir, args.export)
        print(f"exported evidence to {out_dir}", flush=True)
    return report


if __name__ == "__main__":
    main()
