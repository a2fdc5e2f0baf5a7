"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --cache-pairs 10    # only the cache A/B, below

Phases, in order; any failure raises and the script exits non-zero:
1. a CUDA card must be present; print its name and power limit, the torch
   version and nvcc's;
2. build the three kernels from gennbv_tpu_torch/csrc, one nvcc process per
   source, all started together (each timed);
3. hold each kernel bit-equal to its plain PyTorch version at the shapes of
   the paths below and time both, with the bound of the card and one
   PyTorch library call where one computes the same function; check under
   torch.profiler that each wrapper call is one device launch of its
   kernel:
   - the 400x400 held-out eval (50 envs, the 50 eval scenes' surface
     capacity Q, 20^3 grid): the fused splat z-buffer + visibility, the hit
     scatter and the carve gather;
   - the 128x128 flagship rollout (256 envs, Q = 11264): the same three;
   - the 128x128 DDA step of phase 9: the hit scatter of every pixel
     ([256, 16384] points) and the gather of the foreground mask (a {0,1}
     image, 256 x 128^2 x 8000);
   - phase 10's converted scenes: the three at the training set's Q
     (256 envs, 128x128) and at Q - 3 (the gather's scalar path), and at
     the held-out set's Q (50 envs, 400x400);
   and the gather once more on an image with planted values (bf16 ties,
   -0.0, a negative, empty pixels), and, without timing, at its edge
   cases at both image sizes: q of 1, 3 and 4, a ragged q and index
   arrays that are contiguous views off 16-byte alignment (the scalar
   path);
4. run the mapping golden on the card (tests/goldens/mapping_golden.npz,
   tests/test_goldens.py's tolerances) through the three kernels;
5. the rollout at the flagship size: 256 procedural scenes, 256 envs,
   128x128 camera, R=64 render grid, full-width HybridEncoder policy from a
   seeded generator, reset + collect(n_steps=128).  Checks the outputs and
   that each kernel ran once per env step; prints env-steps/s and the
   device-time breakdown of 8 steps (torch.profiler);
6. the held-out eval at full size: 50 procedural scenes of seed 100, R=64,
   400x400 camera, eval_env_config (30-step episodes, coverage reward
   only), renderer.zbuf_impl=pallas and scatter_impl=pallas, the policy in
   deterministic mode.  Checks the exact launch count of each kernel
   (init-view cache, reset, 30 steps), the results, and that the same eval
   with zbuf_impl=mxu (no init-view cache; the same kernels) gives
   identical per-env coverage, AUC and rewards; prints eval env-steps/s and
   the device-time breakdown of one eval;
7. training at the flagship recipe's full size
   (reports/r5_refbudget128/config.json: 256 envs, 128x128 camera, R=64,
   PPO n_steps 128, batch 128, 5 epochs, target_kl 0.05, the linear
   schedule over 1000 iterations, 8 minibatch shards, seed 1), on phase
   5's scenes, with the 50 eval scenes of phase 6 under
   runner.eval_camera=400: Runner.train for 3 iterations (the first is
   the warm-up) with an eval and a checkpoint at the third.  Checks that
   the metrics are finite, the minibatch count and learning rate, that the
   parameters and both BatchNorms' running stats moved, each kernel's
   exact launch count, and that a fresh Runner restored from the
   checkpoint holds the same parameters, optimizer state and step bit for
   bit, and that a second Runner from the same seed on the same scenes
   ends with the same parameters, BatchNorm stats, Adam state and logged
   metrics (but time/*) bit for bit; prints each timed iteration's seconds
   by phase, env-steps/s, update minibatches/s, peak memory, and the
   update's device-busy share, top device ops and device activities per
   minibatch over 32 minibatches;
8. the post-training report on phase 7's run directory:
   gennbv_tpu_torch/tools/post_run.py's main with --eval_cam 400
   --point_stride 8 --no-artifacts, at full size (held-out houses, objects
   zero-shot and the convex probe, 50 scenes each, reset + 30 steps, R=64,
   the full-width HybridEncoder from the phase-7 checkpoint).  Checks each
   kernel's exact launch count, that the report has the JAX report's keys
   (reports/r5_refbudget128/report.json) with finite values, and that each
   family's coverage, AUC and reward equal evaluate's without the accuracy
   scan on the same env and policy; holds batched_accuracy and the ray
   march on 2 envs bit-equal to the same functions on the CPU, and the
   card's accuracy to float64 scipy cKDTree nearest neighbours (1e-3
   relative); prints each family's evaluate seconds with and without the
   scan, the ray march's device time per view, the seconds of the dedupe
   and of batched_accuracy, and peak memory.  Then train/play.py's main
   with --ply, --obj and --export on the card: the files are non-empty and
   the loaded torch.export program's actions equal the eager policy's.
9. the DDA, replay and callback env paths at full width: phase 5's 256
   scenes, 256 envs, 128x128, R=64, the full-width HybridEncoder from a
   seeded generator, reset + 16 collected steps with renderer.mode=dda,
   once with carve_mode=ztest and once with bresenham.  Checks each
   kernel's exact launches a step (the hit scatter once, the gather twice
   with ztest and never with bresenham, the splat never), holds 2 envs'
   step outputs and states to the port on the CPU over the same steps,
   records a replay bank at the visited poses with the card's DDA and
   requires a replay env to equal the dda env bit for bit, and a
   callback env over the same frames to agree too; prints env-steps/s,
   the DDA's and the Bresenham carve's device ms a step, device
   activities a step and peak memory;
10. the dataset pipeline at full width: 256 procedural houses of seed 0
   and 50 held-out ones of seed 100, meshed into OBJs in a temporary
   directory by the native mesher and converted by the port's
   convert_dataset (the voxelizer built into gennbv_tpu_torch/_build/);
   then 2 iterations of the flagship recipe on the training directory
   through train_eval_gennbv.main --eval_dataset <held-out directory>
   with an eval under runner.eval_camera=400, and post_run.main
   --eval_cam 400 --only held_out_houses --no-artifacts, which must take
   its held-out family from the run's config.json.  Checks each kernel's
   exact launch count and finite metrics; prints the convert's seconds,
   Q, iteration seconds, env-steps/s and peak memory.
11. the continuous-control path at the CLI's full width, which launches
   none of the three kernels: train_rsl.main --task drone_velocity
   --num_envs 4096 --num_steps_per_env 24 --hidden 512 256 128 (the
   default ContinuousPPOConfig: 5 epochs x 4 minibatches of 24,576 rows,
   adaptive KL) for 3 iterations into a temporary log dir, saving each,
   then --resume to 4.  Checks that every logged metric is finite and
   the learning rate within [min_lr, max_lr], that the resumed run
   starts at iteration 3 from the parameters saved there, that no kernel
   launched, that two OnPolicyRunners from one seed end 2 iterations with
   the same parameters, optimizer state and logged metrics (but time/*)
   bit for bit, and that 256 drones stepped 8 times on the CPU from the
   card's state, with the same actions, agree with the card within
   tests/test_torch_drone.py's tolerance (the trained policy's forward
   within tests/test_torch_continuous.py's); prints each iteration's env-steps/s
   with its rollout and update seconds, the device-busy share and device
   activities per env step of an iteration under torch.profiler, and
   peak memory.
The meshes are converted before phase 3, which times the kernels at
their Q.  The last two lines of stdout are the kernel summary with the card's name
and power limit before them, then the result line
{"ok": true, "device": {...}}.  Imports nothing of JAX.

With --cache-pairs N the script runs phases 1-2 and then only N interleaved
pairs of the full-size eval with and without the init-view cache, and
prints their env-steps/s; it prints no result line.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from gennbv_tpu_torch import config, spec
from gennbv_tpu_torch.algo import evaluation, gae, on_policy_runner, ppo, rollout
from gennbv_tpu_torch.algo import ppo_continuous as ppoc
from gennbv_tpu_torch.algo.repro import first_difference, read_logged, snapshot
from gennbv_tpu_torch.algo.runner import _METRIC_KEYS, Runner
from gennbv_tpu_torch.env import ReconEnv, make_scenes
from gennbv_tpu_torch.env import scene as scene_lib
from gennbv_tpu_torch.env.drone_robot import DroneRobot
from gennbv_tpu_torch.env.depth_sources import (CallbackDepthSource,
                                                ReplayBank,
                                                ReplayDepthSource,
                                                record_replay_bank)
from gennbv_tpu_torch.models.actor_critic import GaussianActorCritic
from gennbv_tpu_torch.models.policy import ActorCriticPolicy
from gennbv_tpu_torch.models import distributions
from gennbv_tpu_torch.ops import (_cuda, backproject, camera, carve, fp32,
                                  fused_splat, gather, render, scatter, splat,
                                  voxel)
from gennbv_tpu_torch.tools import convert_dataset, post_run
from gennbv_tpu_torch.train import play, train_eval_gennbv, train_rsl

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "mapping_golden.npz")
FLAGSHIP = os.path.join(ROOT, "reports", "r5_refbudget128", "config.json")
# the JAX package's report of the flagship run: the keys the port's must have
REFERENCE_REPORT = os.path.join(ROOT, "reports", "r5_refbudget128",
                                "report.json")
TRAIN_ITERS = 3
N_ENVS, HW, RES, N_STEPS, GAMMA = 256, 128, 64, 128, 0.99
# surface capacity Q of the 256 seed-0 scenes at R=64 (the fused splat's points)
ROLLOUT_Q = 11264
EVAL_HW, EVAL_SEED = 400, 100
POINT_STRIDE = 8                         # the accuracy scan's pixel stride
DDA_STEPS = 16                           # phase 9's collected steps a run
CPU_ENVS = 2                             # envs held to the CPU in phase 9
N_MESHES = 256                           # phase 10's training meshes
DATASET_ITERS = 2                        # phase 10's training iterations
G = spec.GRID_SIZE                       # the 20^3 grid; the carve gathers G^3
# phase 11: train_rsl's iterations before the resume, its width, and the
# drones and steps held to the CPU
RSL_ITERS, RSL_ENVS, RSL_STEPS, RSL_HIDDEN = 3, 4096, 24, (512, 256, 128)
RSL_CPU_ENVS, RSL_CPU_STEPS = 256, 8
# tests/test_torch_drone.py's tolerance of the drone's state and obs, and
# tests/test_torch_continuous.py's of the MLP forward
DRONE_RTOL, DRONE_ATOL = 1e-5, 1e-5
MLP_RTOL, MLP_ATOL = 1e-5, 1e-6
# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM bytes/s,
# and float32 operations/s outside the tensor cores, the rate the bounds
# below charge every arithmetic, compare and integer operation at
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the profiler's own kernels on each side of a profiled run, their
# length, the takes of a profile, and the most pads a profile lost on
# each side (see _profiled)
PROFILE_PADS, PAD_CYCLES, PROFILE_TAKES = 256, 50_000, 5
PADS_LOST = {"leading": 0, "trailing": 0}

KERNELS = {
    "gather_image": ("gennbv_tpu_torch/csrc/gather_image.cu",
                     "gennbv_tpu/ops/pallas_gather.py:37", gather.gather_image),
    "scatter_cells_any": ("gennbv_tpu_torch/csrc/scatter_cells_any.cu",
                          "gennbv_tpu/ops/pallas_scatter.py:47",
                          scatter.scatter_cells_any),
    "zbuf_visible": ("gennbv_tpu_torch/csrc/zbuf_visible.cu",
                     "gennbv_tpu/ops/pallas_splat.py:80",
                     fused_splat.zbuf_visible),
}


# the __global__ function each wrapper launches, once a call (csrc/*.cu)
PORT_KERNEL_FUNCTIONS = {
    "gather_image": "gather_image_kernel",
    "scatter_cells_any": "scatter_cells_any_kernel",
    "zbuf_visible": "zbuf_visible_cluster_kernel",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def reset_launches() -> None:
    for _, _, fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, (_, _, fn) in KERNELS.items()}


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    card = card_line()
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], check=True,
                          capture_output=True, text=True, timeout=60).stdout
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{nvcc.strip().splitlines()[-1]}")
    return card


def phase_build() -> dict:
    """Each kernel's library built afresh from the checkout, the three nvcc
    processes at once; returns the seconds each build took."""
    def build(name: str) -> float:
        so = _cuda.library_path(name)
        if so.exists():
            so.unlink()
        t0 = time.perf_counter()
        _cuda.load_library(name)
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        secs = dict(zip(KERNELS, pool.map(build, KERNELS)))
    for name, s in secs.items():
        print(f"build: {name}.cu in {s:.2f} s (three builds at once)")
    return secs


def _time_ms(fn, trials: int = 21, calls: int = 10) -> float:
    """Median over trials of the mean time of `calls` back-to-back calls,
    from CUDA events, after a warm-up.  Back to back, the inputs stay in
    L2 where they fit, as they do when the env step has just made them."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time in ms: the larger of the bytes over the HBM rate and
    the operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _equal(label, got, want) -> float:
    """Raises unless the kernel's outputs equal the plain version's bit
    for bit; returns the largest difference (0.0)."""
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(
                f"{label}: kernel differs from plain: max "
                f"{float((g.float() - w.float()).abs().max())}")
        err = max(err, float((g.float() - w.float()).abs().max()))
    return err


def _profiled(label: str, run):
    """Runs `run` under torch.profiler; returns its value and its device
    activities (user annotations excluded) in the order of their device
    start.

    On the card, a profile taken in a process that has worked for a while
    can lose device records at either end of its session, more of them
    the older the process, now and then all of them (measured by
    gennbv_tpu_torch/tools/profile_loss.py).  So PROFILE_PADS spin
    kernels of the profiler's own, each spinning PAD_CYCLES, are launched
    and finished on each side of `run`: its activities are those between
    the last leading pad and the first trailing one.  A profile that kept
    no pad on one side lost more than that: the profiler's fault, not the
    program's, so it is taken again, up to PROFILE_TAKES times, each take
    printed.  PADS_LOST keeps the most pads lost on each side."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    def pads():
        for _ in range(PROFILE_PADS):
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()

    for take in range(1, PROFILE_TAKES + 1):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            pads()
            value = run()
            torch.cuda.synchronize()
            pads()
        spans = sorted((e for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and not e.is_user_annotation),
                       key=lambda e: e.time_range.start)
        is_pad = ["spin_kernel" in e.name for e in spans]
        lead = next((i for i, p in enumerate(is_pad) if not p), len(spans))
        tail = len(spans) - next((i for i, p in enumerate(reversed(is_pad))
                                  if not p), len(spans))
        if 0 < lead <= tail < len(spans) and not any(is_pad[lead:tail]):
            PADS_LOST["leading"] = max(PADS_LOST["leading"], PROFILE_PADS - lead)
            PADS_LOST["trailing"] = max(PADS_LOST["trailing"],
                                        PROFILE_PADS - (len(spans) - tail))
            return value, spans[lead:tail]
        print(f"{label}: profile {take} of {PROFILE_TAKES} lost the device's "
              f"records: {len(spans)} device activities, {sum(is_pad)} of "
              f"the {2 * PROFILE_PADS} pads, {lead} leading, "
              f"{len(spans) - tail} trailing")
    raise AssertionError(f"{label}: the profiler lost the device's records "
                         f"{PROFILE_TAKES} times")


def profile_calls(fn, calls: int = 20) -> tuple[float, float, set]:
    """Runs fn `calls` times back to back under torch.profiler, after one
    call outside it; returns the device activities per call, their device
    time per call in ms, and their names."""
    def run():
        for _ in range(calls):
            fn()

    fn()
    _, spans = _profiled("profile_calls", run)
    return (len(spans) / calls,
            sum(e.time_range.end - e.time_range.start for e in spans) / calls / 1e3,
            {e.name for e in spans})


def _case(label, name, kernel, plain, library, nbytes, ops) -> dict:
    """Kernel vs plain version, bit for bit; one device launch of the
    kernel per wrapper call; then timed beside the library call and the
    bound."""
    err = _equal(label, kernel(), plain())
    per_call, device_ms, names = profile_calls(kernel)
    if per_call != 1 or not all(PORT_KERNEL_FUNCTIONS[name] in n for n in names):
        raise AssertionError(
            f"{label}: {per_call} device launches a call ({sorted(names)}), "
            f"expected one launch of {PORT_KERNEL_FUNCTIONS[name]}")
    bound_ms, bound_by = _bound(nbytes, ops)
    res = {"max_abs_err": err, "ms": _time_ms(kernel), "plain_ms": _time_ms(plain),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None if library is None else _time_ms(library),
           "device_launches_per_call": per_call, "kernel_device_ms": device_ms,
           # the library call's own device time, profiled as the kernel's
           "library_device_ms": (None if library is None
                                 else profile_calls(library)[1])}
    lib = ("none" if library is None else
           f"{res['library_ms']:.4f} ms (device {res['library_device_ms']:.4f} ms)")
    print(f"{label}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
          f"library {lib}, bound {bound_ms:.4f} ms ({bound_by}) "
          f"(median, CUDA events); {per_call:g} device launch a call, "
          f"{device_ms:.4f} ms of device time (profiler)")
    return res


def gather_case(label, img, vi, ui) -> dict:
    n, h, w = img.shape
    q = vi.shape[1]
    flat = vi.long() * w + ui.long()
    img16 = img.to(torch.bfloat16).float().reshape(n, h * w)
    # what the data needs: each distinct pixel read once (4 B), the two
    # index arrays (8 B a point), the output (4 B a point)
    env = torch.arange(n, device=img.device)[:, None] * (h * w)
    distinct = torch.unique(flat + env).numel()
    return _case(
        label, "gather_image",
        lambda: (gather.gather_image(img, vi, ui),),
        lambda: (gather.gather_image_ref(img, vi, ui),),
        # library: one torch.gather on the image already rounded to bf16,
        # with the flat indices precomputed (excludes both)
        lambda: torch.gather(img16, 1, flat),
        4 * distinct + 12 * n * q, 2 * n * q)


def scatter_case(label, idx, valid) -> dict:
    n, q, _ = idx.shape
    flat = (idx[..., 0].long() * G + idx[..., 1]) * G + idx[..., 2]
    flat = torch.where(valid, flat, G ** 3)
    grid = torch.zeros(n, G ** 3 + 1, device=idx.device)
    nvalid = int(valid.sum())
    # the validity of every point (1 B), the indices of the valid ones
    # (12 B), the grid written once (4 B a cell); a flat index and a
    # store per valid point
    return _case(
        label, "scatter_cells_any",
        lambda: (scatter.scatter_cells_any(idx, valid, G),),
        lambda: (scatter.scatter_cells_any_ref(idx, valid, G),),
        # library: one scatter_ of 1.0 into a zeroed grid with a spare
        # cell, the flat indices precomputed (excludes both)
        lambda: grid.scatter_(1, flat, 1.0),
        n * q + 12 * nvalid + 4 * n * G ** 3, 5 * nvalid)


def splat_case(label, vic, uic, z, ok, veps, h, w, depth_max) -> dict:
    n, q = z.shape
    nvalid = int(ok.sum())
    # bytes: the validity of every point, pixel and depth of the valid ones,
    # the slack; the z-buffer and the visibility written once.  Operations:
    # 19 per valid point (z range, digits, key, visibility compare) and 16
    # per pixel (9-key min, decode)
    return _case(
        label, "zbuf_visible",
        lambda: fused_splat.zbuf_visible(vic, uic, z, ok, veps, h, w, depth_max),
        lambda: fused_splat.zbuf_visible_ref(vic, uic, z, ok, veps, h, w,
                                             depth_max),
        None,            # no single PyTorch call computes this function
        n * q + 12 * nvalid + 4 * n + 4 * n * h * w + n * q,
        19 * nvalid + 16 * n * h * w)


def _step_poses(scenes, cam: config.CameraConfig):
    """Every scene seen from a pose of the discrete action grid drawn from
    a seeded numpy generator: (poses, r_c2w, t_c2w, intrinsics)."""
    n = scenes.num_scenes
    dev = scenes.surf_pts.device
    rng = np.random.default_rng(0)
    acts = np.stack([rng.integers(0, k, n) for k in spec.NVEC], -1)
    poses = fp32.fma(torch.as_tensor(acts, dtype=torch.float32, device=dev),
                     torch.as_tensor(spec.ACTION_UNIT, device=dev),
                     torch.as_tensor(spec.CLIP_POSE_LOW, device=dev))
    r, t = camera.pose_to_c2w(poses, cam.z_offset)
    k = torch.as_tensor(camera.intrinsics(cam.height, cam.width,
                                          cam.horizontal_fov_deg), device=dev)
    return poses, r, t, k


def _step_inputs(scenes, cam: config.CameraConfig):
    """What a splat env step hands the three kernels (_step_poses)."""
    n = scenes.num_scenes
    _, r, t, k = _step_poses(scenes, cam)
    vic, uic, z, ok = splat.project_px(scenes.surf_pts, scenes.surf_mask, k,
                                       r, t, cam.height, cam.width)
    z = z.contiguous()
    veps = fp32.mean3_of_scaled(scenes.box_hi - scenes.box_lo, scenes.grid_res)
    zbuf, visible = fused_splat.zbuf_visible_ref(vic, uic, z, ok, veps,
                                                 cam.height, cam.width,
                                                 cam.depth_max)
    idx, in_bounds = voxel.points_to_voxel_idx(
        scenes.surf_pts, visible, scenes.range_gt, scenes.voxel_size)
    centers = scene_lib.voxel_centers(scenes.range_gt, scenes.voxel_size, G)
    cvi, cui, _, _ = carve.project_centers_px(centers, k, r, t, cam.height,
                                              cam.width)
    return ((vic, uic, z, ok, veps), (idx.contiguous(), in_bounds.contiguous()),
            (zbuf.reshape(n, cam.height, cam.width), cvi, cui))


def _dda_step_inputs(scenes, cam: config.CameraConfig):
    """What a DDA env step (renderer.mode=dda, carve_mode=ztest) hands the
    hit scatter and the foreground gather (_step_poses): the cells of all
    H*W back-projected pixels, and the ray march's hit mask as a {0,1}
    float image with the carve's G^3 voxel pixels."""
    n = scenes.num_scenes
    _, r, t, k = _step_poses(scenes, cam)
    rays = torch.as_tensor(camera.camera_rays(cam.height, cam.width,
                                              cam.horizontal_fov_deg),
                           device=r.device)
    depth, fg = render.render_depth(scenes.render_occ, scenes.box_lo,
                                    scenes.box_hi, rays, r, t, scenes.grid_res,
                                    3 * scenes.grid_res, cam.depth_max)
    pts, valid = backproject.backproject(depth, fg, rays, r, t)
    idx, in_bounds = voxel.points_to_voxel_idx(pts, valid, scenes.range_gt,
                                               scenes.voxel_size)
    centers = scene_lib.voxel_centers(scenes.range_gt, scenes.voxel_size, G)
    cvi, cui, _, _ = carve.project_centers_px(centers, k, r, t, cam.height,
                                              cam.width)
    return ((idx.contiguous(), in_bounds.contiguous()),
            (fg.float().reshape(n, cam.height, cam.width), cvi, cui))


def planted_gather_inputs(q: int):
    """The rollout's image shape [256, 128, 128] and q random in-range
    pixels, on an image with planted values: bf16 round-to-even ties
    (1 + 2^-8, 1 + 3 * 2^-8), -0.0, a negative, and a block of empty
    pixels at depth_max."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    img = torch.rand(N_ENVS, HW, HW, device="cuda", generator=gen) * 30.0
    img[:, :8, :8] = 50.0                                    # empty pixels
    img[:, 8, :4] = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -0.0, -3.7])
    vi, ui = (torch.randint(0, HW, (N_ENVS, q), device="cuda",
                            dtype=torch.int32, generator=gen) for _ in range(2))
    # every env reads an empty pixel and each planted value
    vi[:, :5] = torch.tensor([0, 8, 8, 8, 8], dtype=torch.int32)
    ui[:, :5] = torch.tensor([0, 0, 1, 2, 3], dtype=torch.int32)
    return img, vi, ui


def planted_gather_case(q: int) -> dict:
    return gather_case(f"gather_image [{N_ENVS}x{HW}x{HW}] x [{N_ENVS}x{q}] "
                       "(planted values)", *planted_gather_inputs(q))


# the gather's edge cases at both paths' image shapes: (envs, image side,
# queries an env, offset of the index arrays in int32s); a ragged q and an
# offset view take the scalar path, the rest the vector path
GATHER_EDGES = [(n, hw, q, offset)
                for n, hw in ((spec.EVAL_NUM_ENVS, EVAL_HW), (N_ENVS, HW))
                for q, offset in ((1, 0), (3, 0), (4, 0), (G ** 3 + 1, 0),
                                  (G ** 3, 1), (ROLLOUT_Q, 1), (ROLLOUT_Q, 0))]


def gather_edge_inputs(n: int, hw: int, q: int, offset: int):
    """Planted-style images [n, hw, hw] and random in-range indices, the
    index arrays `offset` int32s into their buffers (contiguous views that
    are not 16-byte aligned where offset % 4 != 0)."""
    gen = torch.Generator(device="cuda").manual_seed(n * q + hw + offset)
    img = torch.rand(n, hw, hw, device="cuda", generator=gen) * 30.0
    img[:, 0, :4] = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -0.0, 50.0])

    def indices():
        buf = torch.randint(0, hw, (n * q + offset,), device="cuda",
                            dtype=torch.int32, generator=gen)
        return buf[offset:].view(n, q)

    vi, ui = indices(), indices()
    vi[:, : min(q, 4)] = 0
    ui[:, : min(q, 4)] = torch.arange(min(q, 4), dtype=torch.int32)
    return img, vi, ui


def gather_edge_case(n: int, hw: int, q: int, offset: int) -> str:
    """The wrapper bit-equal to gather_image_ref on one edge case, with
    one launch a call (counted, and one device launch under the
    profiler); returns the path the geometry took."""
    img, vi, ui = gather_edge_inputs(n, hw, q, offset)
    geo = gather.launch_geometry(n, q, vi.data_ptr(), ui.data_ptr())
    label = (f"gather_image [{n}x{hw}x{hw}] x [{n}x{q}], index offset "
             f"{offset} ({geo.path} path)")
    if geo.path != ("scalar" if q % gather.VECTOR or offset % 4 else "vector"):
        raise AssertionError(f"{label}: the wrong path")
    before = gather.gather_image.launches
    got = gather.gather_image(img, vi, ui)
    if gather.gather_image.launches != before + 1:
        raise AssertionError(f"{label}: counted "
                             f"{gather.gather_image.launches - before} launches")
    _equal(label, (got,), (gather.gather_image_ref(img, vi, ui),))
    per_call, _, names = profile_calls(lambda: gather.gather_image(img, vi, ui),
                                       calls=3)
    if per_call != 1 or not all("gather_image_kernel" in x for x in names):
        raise AssertionError(f"{label}: {per_call} device launches a call "
                             f"({sorted(names)})")
    return geo.path


def _ragged(inputs, q: int):
    """The first q points of [N, Q, ...] step inputs (a [N] slack kept)."""
    return tuple(x if x.dim() == 1 else x[:, :q].contiguous() for x in inputs)


def phase_kernels(eval_scenes, rollout_scenes, dataset_scenes) -> dict:
    """Each kernel against its plain version on the inputs of a step of
    the eval, of the rollout, of the DDA step and of the converted
    scenes (dataset_scenes: {label: (scenes, image side)}); returns
    {kernel: {path: timings}}.  The gather is also held bit-equal on an
    image with planted values."""
    out = {name: {} for name in KERNELS}
    cam = config.CameraConfig(height=HW, width=HW)
    n = rollout_scenes.num_scenes
    scatter_in, fg_in = _dda_step_inputs(rollout_scenes, cam)
    out["scatter_cells_any"]["dda"] = scatter_case(
        f"dda: scatter_cells_any [{n}x{HW * HW}] -> [{n}x{G}^3]", *scatter_in)
    out["gather_image"]["dda_fg"] = gather_case(
        f"dda: gather_image of the fg mask [{n}x{HW}x{HW}] x [{n}x{G ** 3}]",
        *fg_in)
    for path, (scenes, hw) in dataset_scenes.items():
        cam = config.CameraConfig(height=hw, width=hw)
        n, q = scenes.surf_mask.shape
        splat_in, scatter_in, (zbuf, _, _) = _step_inputs(scenes, cam)
        for label, qq in ((path, q), (f"{path}_ragged", q - 3)):
            if qq != q and hw != HW:
                continue           # the ragged Q on the training set only
            sp = _ragged(splat_in, qq)
            sc = _ragged(scatter_in, qq)
            out["zbuf_visible"][label] = splat_case(
                f"{label}: zbuf_visible [{n}x{qq}] -> [{n}x{hw}x{hw}]", *sp,
                hw, hw, cam.depth_max)
            out["scatter_cells_any"][label] = scatter_case(
                f"{label}: scatter_cells_any [{n}x{qq}] -> [{n}x{G}^3]", *sc)
            # the visibility gather's shape: the points' own pixels
            out["gather_image"][label] = gather_case(
                f"{label}: gather_image [{n}x{hw}x{hw}] x [{n}x{qq}]", zbuf,
                sp[0], sp[1])
    for path, scenes, hw in (("eval", eval_scenes, EVAL_HW),
                             ("rollout", rollout_scenes, HW)):
        cam = config.CameraConfig(height=hw, width=hw)
        n, q = scenes.surf_mask.shape
        splat_in, scatter_in, gather_in = _step_inputs(scenes, cam)
        out["zbuf_visible"][path] = splat_case(
            f"{path}: zbuf_visible [{n}x{q}] -> [{n}x{hw}x{hw}]", *splat_in,
            hw, hw, cam.depth_max)
        out["scatter_cells_any"][path] = scatter_case(
            f"{path}: scatter_cells_any [{n}x{q}] -> [{n}x{G}^3]", *scatter_in)
        out["gather_image"][path] = gather_case(
            f"{path}: gather_image [{n}x{hw}x{hw}] x [{n}x{G ** 3}]", *gather_in)
    planted_gather_case(G ** 3)
    paths = [gather_edge_case(*case) for case in GATHER_EDGES]
    print(f"gather_image: bit-equal to the plain version with one device "
          f"launch a call at {len(GATHER_EDGES)} edge cases (q 1, 3, 4, "
          f"{G ** 3 + 1}, offset views; {paths.count('scalar')} on the scalar "
          "path) at both image sizes")
    return out


def phase_golden() -> None:
    """tools/make_goldens.py's run on the card, held to the golden."""
    cfg = config.EnvConfig(
        num_envs=4, camera=config.CameraConfig(height=24, width=24),
        renderer=config.RendererConfig(resolution=24),
        scene=config.SceneConfig(num_scenes=2, seed=7), max_episode_length=6)
    env = ReconEnv(cfg, make_scenes(cfg.scene, cfg.renderer.resolution))
    want = np.load(GOLDEN)
    reset_launches()
    state, out = env.reset(4)
    obs, rew, cov = [out.obs], [], []
    for a in want["actions"]:
        state, out = env.step(state, torch.as_tensor(a, device="cuda")[None]
                              .repeat(4, 1))
        obs.append(out.obs)
        rew.append(out.reward)
        cov.append(out.coverage)
    torch.cuda.synchronize()
    expect = {name: 1 + len(want["actions"]) for name in KERNELS}
    if launches() != expect:
        raise AssertionError(f"golden run launched {launches()}, expected {expect}")
    got = {"obs": obs, "rewards": rew, "coverage": cov}
    for name, tol in (("coverage", 1e-6), ("rewards", 1e-4), ("obs", 1e-4)):
        np.testing.assert_allclose(torch.stack(got[name]).cpu().numpy(),
                                   want[name], rtol=0, atol=tol, err_msg=name)
    np.testing.assert_allclose(state.prob_grid.cpu().numpy(), want["prob_grid"],
                               rtol=0, atol=1e-6, err_msg="prob_grid")
    print("golden: matches tests/goldens/mapping_golden.npz on the card")


def profile(label: str, fn, unprofiled_s: float | None = None) -> dict:
    """Runs fn once under torch.profiler and prints the device's busy
    share of the wall time and the kernels that took the most of it.  The
    profiler slows the host; given the wall time of fn without it, the
    busy share is also printed against that.  Returns the device time in
    microseconds of each of the port's kernels, by kernel function
    ("kernels"), the number of device activities ("activities") and the
    busy and wall milliseconds."""
    def run():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    # fn is run again only where its first profile lost the device's records
    wall_us, events = _profiled(label, run)
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events]
    busy, end = 0.0, float("-inf")
    by_name: dict[str, float] = {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    unprofiled = ("" if unprofiled_s is None else
                  f"; {100 * busy / (unprofiled_s * 1e6):.1f}% of the "
                  f"{unprofiled_s * 1e3:.3f} ms it takes unprofiled")
    print(f"{label}: device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"wall ({100 * busy / wall_us:.1f}%{unprofiled}), {len(spans)} device "
          "activities; top by device time:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  {name[:90]}")
    # the port's own kernels, demangled as "(anonymous namespace)::fn(args)"
    # or, for a template, "void (anonymous namespace)::fn<...>(args)";
    # some of PyTorch's kernels sit in anonymous namespaces too
    ports = set(PORT_KERNEL_FUNCTIONS.values())
    ours: dict[str, list[float]] = {}
    for s, e, name in spans:
        fn = name.removeprefix("void ").removeprefix("(anonymous namespace)::")
        fn = fn.split("(")[0].split("<")[0]
        if fn in ports:
            ours.setdefault(fn, []).append(e - s)
    for name, times in ours.items():
        print(f"  port kernel {name}: {len(times)} launches, "
              f"{sum(times) / 1e3:.3f} ms device time, "
              f"{sum(times) / len(times) / 1e3:.4f} ms each")
    return {"kernels": {name: sum(times) for name, times in ours.items()},
            "activities": len(spans), "busy_ms": busy / 1e3,
            "wall_ms": wall_us / 1e3}


def _device_ms_per_call(device_us: dict, calls: int) -> dict:
    """The profiled device time of each wrapper over `calls` calls, per
    call."""
    return {name: device_us.get(fn, 0.0) / calls / 1e3
            for name, fn in PORT_KERNEL_FUNCTIONS.items()}


def flagship_config() -> config.EnvConfig:
    return config.EnvConfig(
        num_envs=N_ENVS, camera=config.CameraConfig(height=HW, width=HW),
        renderer=config.RendererConfig(resolution=RES),
        scene=config.SceneConfig(num_scenes=N_ENVS, seed=0))


def make_path_scenes(cfg: config.EnvConfig, label: str):
    t0 = time.perf_counter()
    scenes = make_scenes(cfg.scene, RES)
    print(f"scenes: {scenes.num_scenes} {label} procedural (seed "
          f"{cfg.scene.seed}) at R={RES}, Q={scenes.surf_pts.shape[1]} in "
          f"{time.perf_counter() - t0:.1f} s")
    return scenes


def phase_rollout(card: str, scenes) -> tuple[dict, dict]:
    cfg = flagship_config()
    if scenes.surf_pts.shape[1] != ROLLOUT_Q:
        raise AssertionError(f"the flagship scenes' Q is "
                             f"{scenes.surf_pts.shape[1]}, not {ROLLOUT_Q}")
    env = ReconEnv(cfg, scenes)
    policy = ActorCriticPolicy(config.ModelConfig(),
                               torch.Generator(device="cuda").manual_seed(1))
    # warm-up (allocator, cuDNN algorithm choice), outside the counted run
    state, out = env.reset(N_ENVS)
    rollout.collect(env, policy, state, out.obs,
                    torch.Generator(device="cuda").manual_seed(3), 2, GAMMA)
    torch.cuda.synchronize()

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, out = env.reset(N_ENVS)
    t1 = time.perf_counter()
    state, obs, batch, stats = rollout.collect(
        env, policy, state, out.obs, torch.Generator(device="cuda").manual_seed(2),
        N_STEPS, GAMMA)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = launches()

    expect = {name: 1 + N_STEPS for name in KERNELS}
    if counts != expect:
        raise AssertionError(f"rollout launched {counts}, expected {expect}")
    for name, x in (*batch._asdict().items(), *stats._asdict().items()):
        if x.is_floating_point() and not torch.isfinite(x).all():
            raise AssertionError(f"non-finite {name}")
    assert batch.obs.shape == (N_STEPS, N_ENVS, env.obs_dim)
    assert batch.obs.dtype == torch.float32
    assert ((stats.coverage >= 0) & (stats.coverage <= 1)).all()
    assert (stats.coverage > 0).any(), "the cameras see the houses"
    next_values = torch.cat([batch.values[1:], batch.last_values[None]])
    time_outs = (stats.ep_length == cfg.max_episode_length).float()
    raw = batch.rewards - GAMMA * next_values * time_outs
    assert (raw >= 0).all(), "only_positive rewards are never negative"
    tri = batch.obs[..., 600:8600]
    assert ((tri == -1) | (tri == 0) | (tri == 1)).all()

    n_env_steps = N_ENVS * N_STEPS
    print(f"rollout: reset {t1 - t0:.3f} s, collect {N_STEPS} steps x {N_ENVS} "
          f"envs in {t2 - t1:.3f} s = {n_env_steps / (t2 - t1):.1f} env-steps/s "
          f"[{card}]; mean coverage at the last step "
          f"{float(stats.coverage[-1].mean()):.4f}, "
          f"{int(stats.num_dones.sum())} episodes ended, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    device_us = profile("rollout, 8 collect steps", lambda: rollout.collect(
        env, policy, state, obs, torch.Generator(device="cuda").manual_seed(4),
        8, GAMMA), (t2 - t1) * 8 / N_STEPS)
    return counts, _device_ms_per_call(device_us["kernels"], 8)


def eval_config(zbuf_impl: str) -> config.EnvConfig:
    """The held-out eval of the flagship recipe under the reference's
    400x400 camera (train_eval_gennbv.py, runner.eval_camera)."""
    train = config.EnvConfig(
        camera=config.CameraConfig(height=EVAL_HW, width=EVAL_HW),
        renderer=config.RendererConfig(resolution=RES, zbuf_impl=zbuf_impl,
                                       scatter_impl="pallas"),
        scene=config.SceneConfig(num_scenes=spec.EVAL_NUM_ENVS, seed=EVAL_SEED))
    return config.eval_env_config(train)


def run_eval(cfg: config.EnvConfig, scenes, policy):
    """Builds the env (and its init-view cache) and evaluates; returns
    (result, kernel launches, seconds of the evaluate call)."""
    reset_launches()
    env = ReconEnv(cfg, scenes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = evaluation.evaluate(env, policy, compute_accuracy=False)
    secs = time.perf_counter() - t0            # evaluate ends on the host
    return res, launches(), secs


def check_eval(res: evaluation.EvalResult, max_len: int) -> None:
    for name, x in res._asdict().items():
        if name.startswith("accuracy") or name in ("mean_accuracy_cm",
                                                    "gt_unseen_frac"):
            continue
        if not np.isfinite(x).all():
            raise AssertionError(f"eval: non-finite {name}")
    cov = res.per_env_coverage
    assert ((cov >= 0) & (cov <= 1)).all(), "coverage in [0, 1]"
    assert 0 < res.mean_init_coverage <= res.mean_final_coverage <= 1
    assert 1 <= res.mean_ep_length <= max_len
    # the eval reward is the coverage gain; the init step's is not counted
    assert res.mean_reward <= res.mean_final_coverage + 1e-4


def phase_eval(card: str, scenes) -> tuple[dict, dict]:
    cfg = eval_config("pallas")
    max_len = cfg.max_episode_length
    policy = ActorCriticPolicy(config.ModelConfig(),
                               torch.Generator(device="cuda").manual_seed(1))
    run_eval(cfg, scenes, policy)                  # warm-up, not counted
    res, counts, secs = run_eval(cfg, scenes, policy)
    # init-view cache, reset, and one launch per step
    expect = {name: 2 + max_len for name in KERNELS}
    if counts != expect:
        raise AssertionError(f"eval launched {counts}, expected {expect}")
    check_eval(res, max_len)
    steps = 1 + max_len
    n_env_steps = cfg.num_envs * steps
    print(f"eval: {cfg.num_envs} envs x (reset + {max_len} steps) at "
          f"{EVAL_HW}x{EVAL_HW}, R={RES}, in {secs:.3f} s = "
          f"{n_env_steps / secs:.1f} env-steps/s [{card}]; mean reward "
          f"{res.mean_reward:.4f}, AUC {res.mean_auc:.4f}, final coverage "
          f"{res.mean_final_coverage:.4f}, init coverage "
          f"{res.mean_init_coverage:.4f}, curve AUC {res.mean_curve_auc:.4f}, "
          f"episode length {res.mean_ep_length:.1f}")

    # without the init-view cache: the same kernels, once per step
    mxu, mxu_counts, mxu_secs = run_eval(eval_config("mxu"), scenes, policy)
    expect = {name: steps for name in KERNELS}
    if mxu_counts != expect:
        raise AssertionError(f"mxu eval launched {mxu_counts}, expected {expect}")
    for name in ("per_env_coverage", "per_env_auc", "mean_reward",
                 "std_reward", "mean_ep_length", "mean_init_coverage"):
        if not np.array_equal(getattr(res, name), getattr(mxu, name)):
            raise AssertionError(f"eval: zbuf_impl=pallas and mxu differ in "
                                 f"{name}")
    print(f"eval: zbuf_impl=mxu (no init-view cache) on the same scenes and "
          f"weights gives identical per-env coverage, AUC and rewards "
          f"({n_env_steps / mxu_secs:.1f} env-steps/s [{card}])")

    env = ReconEnv(cfg, scenes)
    device_us = profile(
        "eval, one evaluate call (pallas)",
        lambda: evaluation.evaluate(env, policy, compute_accuracy=False), secs)
    return counts, _device_ms_per_call(device_us["kernels"], steps)


def train_config() -> config.Config:
    """The flagship recipe, reports/r5_refbudget128/config.json, with an
    eval and a checkpoint every TRAIN_ITERS iterations."""
    with open(FLAGSHIP) as f:
        raw = json.load(f)

    def leaves(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}={v}"

    return config.apply_overrides(config.Config(), (
        *leaves(raw, ""), f"runner.eval_freq={TRAIN_ITERS}",
        f"runner.save_freq={TRAIN_ITERS}"))


def _profile_update(card: str, runner: Runner) -> dict:
    """The update alone over 32 minibatches of 128 rows (a 16-step rollout
    of the 256 envs, one epoch, no KL stop; the CUDA graph's capture
    included), timed and then under the profiler."""
    cfg = dataclasses.replace(runner.cfg.ppo, n_steps=16, n_epochs=1,
                              target_kl=None)
    _, _, batch, _ = rollout.collect(
        runner.env, runner.policy, runner._final_env_state, runner._final_obs,
        runner.generator, cfg.n_steps, cfg.gamma)
    adv, ret = gae.compute_gae(batch.rewards, batch.values, batch.dones.float(),
                               batch.last_values, cfg.gamma, cfg.gae_lambda)
    m = N_ENVS * cfg.n_steps
    args = [x.reshape((m,) + x.shape[2:]) for x in (
        batch.obs, batch.actions, batch.log_probs, batch.values, adv, ret)]

    def run():
        return ppo.update(runner.policy, runner.opt, cfg, runner.opt_state,
                          *args, runner.generator, num_envs=N_ENVS)

    run()                                           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, upd = run()
    secs = time.perf_counter() - t0                 # the update ends on the host
    n_mb = upd.n_minibatches_done
    assert n_mb == m // cfg.batch_size
    res = profile(f"update, {n_mb:g} minibatches of {cfg.batch_size} rows", run,
                  secs)
    print(f"update: {n_mb / secs:.1f} minibatches/s unprofiled "
          f"({secs * 1e3 / n_mb:.3f} ms each), {res['activities'] / n_mb:.1f} "
          f"device activities a minibatch [{card}]")
    return res


def reproduce(card: str, cfg: config.Config, scenes, eval_scenes,
              first: dict) -> None:
    """A second Runner from the same seed trains the same iterations on
    the same scenes; raises unless its parameters, BatchNorm statistics,
    Adam state and logged metrics (but time/*) equal the first run's
    snapshot bit for bit."""
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_repro_")
    try:
        twin = Runner(cfg, scenes=scenes, eval_scenes=eval_scenes,
                      log_dir=log_dir)
        t0 = time.perf_counter()
        twin.train(TRAIN_ITERS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        second = snapshot(twin, read_logged(log_dir))
        twin.close()
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    diff = first_difference(first, second)
    if diff:
        raise AssertionError(f"train: a second Runner from seed "
                             f"{cfg.runner.seed} differs first in {diff}")
    iters = ", ".join(f"{rec['time/iter_seconds']:.3f} s" for rec in
                      second["logged"])
    print(f"train: a second Runner from seed {cfg.runner.seed} on the same "
          f"scenes ends {TRAIN_ITERS} iterations with the same parameters, "
          f"BatchNorm stats, Adam state and logged metrics (but time/*), bit "
          f"for bit, in {secs:.3f} s (iterations {iters}) [{card}]")


def phase_train(card: str, scenes, eval_scenes, log_dir: str) -> dict:
    """Runner.train at the flagship recipe's full size, into the run
    directory log_dir; returns each kernel's launches in that run."""
    cfg = train_config()
    assert (cfg.env.num_envs, cfg.env.camera.height, cfg.env.renderer.resolution,
            cfg.ppo.lr_schedule, cfg.runner.eval_camera) == (
        N_ENVS, HW, RES, "linear", EVAL_HW)
    runner = Runner(cfg, scenes=scenes, eval_scenes=eval_scenes, log_dir=log_dir)
    try:
        before = {k: v.clone() for k, v in runner.variables().items()}
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = runner.train(TRAIN_ITERS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launches()
        peak = torch.cuda.max_memory_allocated()

        # setup reset, 128 steps an iteration, one eval (reset + 30 steps;
        # zbuf_impl=mxu builds no init-view cache)
        n_eval = 1 + runner.eval_env.cfg.max_episode_length
        expect = {name: 1 + TRAIN_ITERS * cfg.ppo.n_steps + n_eval
                  for name in KERNELS}
        if counts != expect:
            raise AssertionError(f"train launched {counts}, expected {expect}")
        logged = read_logged(log_dir)
        assert [rec["step"] for rec in logged] == list(range(1, TRAIN_ITERS + 1))
        total = cfg.ppo.n_epochs * cfg.ppo.total_iters * (
            cfg.ppo.n_steps * N_ENVS // cfg.ppo.batch_size)
        for rec in logged:
            for k in _METRIC_KEYS:
                if not math.isfinite(rec[k]):
                    raise AssertionError(f"train: non-finite {k} at iteration "
                                         f"{rec['step']}")
            if not 1 <= rec["train/n_minibatches"] <= total // cfg.ppo.total_iters:
                raise AssertionError(f"train: {rec['train/n_minibatches']} "
                                     "minibatches")
        count = runner.opt_state.count
        assert count == sum(rec["train/n_minibatches"] for rec in logged)
        lr = metrics["train/learning_rate"]
        if not (lr == runner.opt.lr(count) and
                math.isclose(lr, cfg.ppo.learning_rate * (1 - count / total),
                             rel_tol=1e-6)):
            raise AssertionError(f"train: learning rate {lr} at count {count}")
        # every parameter and running stat, but the BN counters (always 0)
        # and the conv biases ahead of a BN, whose gradient is 0 in exact
        # arithmetic (Adam moves them by rounding noise, or not at all)
        after = runner.variables()
        for k, v in after.items():
            if torch.equal(before[k], v) and not k.endswith((
                    "num_batches_tracked", "grid_conv1.bias", "grid_conv2.bias")):
                raise AssertionError(f"train: {k} did not change")
        assert math.isfinite(metrics["eval/final_coverage"])

        for rec in logged:
            mb = rec["train/n_minibatches"]
            print(f"train: iteration {rec['step']}"
                  f"{' (warm-up)' if rec['step'] == 1 else ''}: "
                  f"{rec['time/iter_seconds']:.3f} s = rollout "
                  f"{rec['time/rollout']:.3f} + gae {rec['time/gae']:.4f} + "
                  f"update {rec['time/update']:.3f} s (+ fetch); "
                  f"{rec['time/fps']:.1f} env-steps/s; update {mb:g} "
                  f"minibatches, {mb / rec['time/update']:.1f}/s; approx_kl "
                  f"{rec['train/approx_kl']:.5f}, episode reward "
                  f"{rec['rollout/episode_reward']:.3f} [{card}]")
        print(f"train: {TRAIN_ITERS} iterations + eval + checkpoints in "
              f"{secs:.3f} s, eval {metrics['time/eval_seconds']:.3f} s "
              f"(final coverage {metrics['eval/final_coverage']:.4f}); Adam "
              f"count {count}, learning rate {lr:.6g}; peak memory "
              f"{peak / 2 ** 30:.2f} GiB [{card}]")

        # a fresh Runner restored from the checkpoint written at the end
        models = os.path.join(log_dir, "models")
        fresh = Runner(cfg, scenes=scenes, log_dir=log_dir)
        step = fresh.restore(models)
        if step != runner.global_step or fresh.global_step != step:
            raise AssertionError(f"restored step {step}, ran {runner.global_step}")
        restored = fresh.variables()
        for k, v in after.items():
            if not torch.equal(restored[k], v):
                raise AssertionError(f"restored {k} differs")
        for moment in ("mu", "nu"):
            for k, v in getattr(runner.opt_state, moment).items():
                if not torch.equal(getattr(fresh.opt_state, moment)[k], v):
                    raise AssertionError(f"restored Adam {moment} {k} differs")
        assert fresh.opt_state.count == count
        print(f"train: a fresh Runner restored from rl_model_{step}_steps holds "
              "the same parameters, BatchNorm stats, Adam state and step")
        del fresh
        reproduce(card, cfg, scenes, eval_scenes, snapshot(runner, logged))

        _profile_update(card, runner)
    finally:
        runner.close()
    return counts


def _kdtree_accuracy(deduped, gt_pts, gt_mask) -> dict:
    """The accuracy metrics from float64 nearest neighbours of
    scipy.spatial.cKDTree, an independent check of batched_accuracy:
    mean squared distances x100, averaged over the envs with scan points."""
    from scipy.spatial import cKDTree
    s2g, g2s, floor = [], [], []
    for e, scan in enumerate(deduped):
        if len(scan) == 0:
            continue
        gt = gt_pts[e][gt_mask[e]].astype(np.float64)
        scan = scan.astype(np.float64)
        gt_tree = cKDTree(gt)
        s2g.append(np.mean(gt_tree.query(scan)[0] ** 2))
        g2s.append(np.mean(cKDTree(scan).query(gt)[0] ** 2))
        # the nearest OTHER GT point: the second neighbour of each
        floor.append(np.mean(gt_tree.query(gt, k=2)[0][:, 1] ** 2))
    s2g, g2s, floor = (np.array(x) * 100.0 for x in (s2g, g2s, floor))
    return {"mean_accuracy": float((s2g + g2s).mean()),
            "scan2gt": float(s2g.mean()), "gt2scan": float(g2s.mean()),
            "floor": float(floor.mean())}


def _report_pieces(card: str, env, policy, report: dict) -> dict:
    """The held-out family's accuracy scan piece by piece on the card:
    the episodes with their scan, the host dedupe and batched_accuracy,
    each timed; batched_accuracy and the ray march on 2 envs held equal to
    the same functions on the CPU; the card's accuracy held to float64 KD
    trees; the ray march's device time per view."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ep = evaluation.run_episodes(env, policy, POINT_STRIDE)
    t_episodes = time.perf_counter() - t0          # ends with host copies
    t0 = time.perf_counter()
    deduped = evaluation.episode_scans(ep.scan_pts, ep.scan_valid,
                                       evaluation.before_done_mask(ep.dones))
    t_dedupe = time.perf_counter() - t0
    sc = env.scenes
    sids = ep.scene_id
    gt = sc.gt_points[sids].cpu().numpy()
    gm = sc.gt_points_mask[sids].cpu().numpy()
    vox = ((sc.box_hi[sids] - sc.box_lo[sids]).cpu().numpy().max(axis=1)
           / sc.grid_res)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = evaluation.batched_accuracy(deduped, gt, gm, vox, device="cuda")
    t_accuracy = time.perf_counter() - t0          # ends on the host
    want = report["held_out_houses"]
    for key, value, digits in (("mean_accuracy_x100m2", acc[0], 3),
                               ("gt_unseen_frac", acc[4], 4),
                               ("accuracy_floor_gt_sampling", acc[5], 3)):
        if round(value, digits) != want[key]:
            raise AssertionError(f"report: batched_accuracy {key} {value} "
                                 f"against the report's {want[key]}")
    points = [len(p) for p in deduped]
    print(f"report: held_out_houses piece by piece: episodes with the scan "
          f"{t_episodes:.3f} s, host dedupe {t_dedupe:.3f} s, batched_accuracy "
          f"{t_accuracy:.3f} s on the card; deduped scan points a scene "
          f"{min(points)}-{max(points)} (mean {np.mean(points):.0f}), GT "
          f"points {int(gm.sum(axis=1).max())} at most [{card}]")

    # the card against the CPU on 2 envs: batched_accuracy, and the ray
    # march of the init view and of a step's view
    two = dict(deduped=deduped[:2], gt_pts=gt[:2], gt_mask=gm[:2], vox=vox[:2])
    on_card = evaluation.batched_accuracy(**two, device="cuda")
    t0 = time.perf_counter()
    on_cpu = evaluation.batched_accuracy(**two, device="cpu")
    t_cpu = time.perf_counter() - t0
    if on_card != on_cpu:
        raise AssertionError(f"report: batched_accuracy on 2 envs: card "
                             f"{on_card}, CPU {on_cpu}")
    sub_rays = evaluation.scan_rays(env, POINT_STRIDE)
    rng = np.random.default_rng(0)
    acts = torch.as_tensor(np.stack([rng.integers(0, k, 2) for k in spec.NVEC],
                                    -1), dtype=torch.int32, device="cuda")
    for label, poses in (
            ("init view", evaluation.init_pose(env).expand(2, -1)),
            ("step view", evaluation.step_poses(
                env, env.init_state(2)._replace(
                    episode_len=torch.ones(2, dtype=torch.int32,
                                           device="cuda")), acts))):
        r_c2w, t_c2w = camera.pose_to_c2w(poses, env.cfg.camera.z_offset)
        args = (sc.render_occ[sids[:2]], sc.box_lo[sids[:2]],
                sc.box_hi[sids[:2]], sub_rays, r_c2w, t_c2w)
        static = (sc.grid_res, 3 * sc.grid_res, env.cfg.camera.depth_max)
        card_out = render.render_depth(*args, *static)
        cpu_out = render.render_depth(*(a.cpu() for a in args), *static)
        for name, c, h in zip(("depth", "hit"), card_out, cpu_out):
            if not torch.equal(c.cpu(), h):
                raise AssertionError(f"report: raymarch {label} {name}: card "
                                     "differs from the CPU")
    print(f"report: on 2 envs, batched_accuracy and the ray march of the init "
          f"and a step's view are bit-equal on the card and the CPU "
          f"(tolerance 0; the CPU's batched_accuracy took {t_cpu:.3f} s)")

    kd = _kdtree_accuracy(deduped, gt, gm)
    for key, value in (("mean_accuracy", acc[0]), ("scan2gt", acc[1]),
                       ("gt2scan", acc[2]), ("floor", acc[5])):
        if not math.isclose(value, kd[key], rel_tol=1e-3):
            raise AssertionError(f"report: {key} {value} on the card against "
                                 f"{kd[key]} from float64 KD trees")
    print(f"report: held_out_houses accuracy on the card {acc[0]:.6f} "
          f"(scan2gt {acc[1]:.6f}, gt2scan {acc[2]:.6f}, floor {acc[5]:.6f}) "
          f"against float64 cKDTree {kd['mean_accuracy']:.6f} "
          f"({kd['scan2gt']:.6f}, {kd['gt2scan']:.6f}, {kd['floor']:.6f}), "
          "within 1e-3 relative")

    # the ray march of one view of every env (the init view), timed
    n = env.cfg.num_envs
    r_c2w, t_c2w = camera.pose_to_c2w(evaluation.init_pose(env).expand(n, -1),
                                      env.cfg.camera.z_offset)

    def view():
        return render.render_depth(
            sc.render_occ[sids], sc.box_lo[sids], sc.box_hi[sids], sub_rays,
            r_c2w, t_c2w, sc.grid_res, 3 * sc.grid_res, env.cfg.camera.depth_max)

    per_call, device_ms, _ = profile_calls(view, calls=5)
    wall_ms = _time_ms(view, trials=5, calls=2)
    print(f"report: raymarch of one view of {n} envs x {sub_rays.shape[0]} rays "
          f"(R={sc.grid_res}, at most {3 * sc.grid_res} steps): "
          f"{device_ms:.4f} ms of device time in {per_call:g} device "
          f"activities (profiler), {wall_ms:.3f} ms a call (CUDA events) "
          f"[{card}]")
    return {"episodes_s": t_episodes, "dedupe_s": t_dedupe,
            "batched_accuracy_s": t_accuracy, "raymarch_view_device_ms": device_ms,
            "raymarch_view_ms": wall_ms, "raymarch_view_activities": per_call}


def phase_report(card: str, run_dir: str) -> dict:
    """The port's post_run on phase 7's run directory at full size (three
    families x 50 scenes x (reset + 30 steps) under the 400x400 camera,
    point_stride 8), then play with --ply, --obj and --export; returns each
    kernel's launches in the post_run call."""
    argv = [run_dir, "--eval_cam", str(EVAL_HW), "--point_stride",
            str(POINT_STRIDE), "--no-artifacts"]
    with open(os.path.join(run_dir, "config.json")) as f:
        raw = json.load(f)
    env_cfg = post_run.run_env_config(raw, EVAL_HW)
    fams = post_run.families(raw, 100)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = post_run.main(argv)
    secs = time.perf_counter() - t0                # ends on the host
    counts = launches()
    peak = torch.cuda.max_memory_allocated()

    # each family: its env's init-view cache where zbuf_impl=pallas, the
    # reset and one launch a step
    per_family = (1 + env_cfg.max_episode_length
                  + (env_cfg.renderer.zbuf_impl == "pallas"))
    expect = {name: len(fams) * per_family for name in KERNELS}
    if counts != expect:
        raise AssertionError(f"report launched {counts}, expected {expect}")
    with open(REFERENCE_REPORT) as f:
        reference = json.load(f)
    # the JAX report's keys, and what the held-out family ran on
    if set(report) != {"checkpoint", "held_out_dataset", "eval_cam",
                       *(tag for tag, _, _ in fams)}:
        raise AssertionError(f"report: keys {sorted(report)}")
    if (report["held_out_dataset"], report["eval_cam"]) != (fams[0][1],
                                                            EVAL_HW):
        raise AssertionError(f"report: held-out family on "
                             f"{report['held_out_dataset']!r} at "
                             f"{report['eval_cam']}")
    for tag, _, _ in fams:
        if set(report[tag]) != set(reference[tag]):
            raise AssertionError(f"report: {tag} has keys {sorted(report[tag])}, "
                                 f"the JAX report {sorted(reference[tag])}")
        if not all(math.isfinite(v) for v in report[tag].values()):
            raise AssertionError(f"report: {tag} not finite: {report[tag]}")
    print(f"report: post_run.main {' '.join(argv[1:])} on phase 7's run "
          f"({report['checkpoint']}) in {secs:.3f} s, {len(fams)} families x "
          f"{env_cfg.num_envs} scenes x (reset + {env_cfg.max_episode_length} "
          f"steps); peak memory {peak / 2 ** 30:.2f} GiB [{card}]")

    models = os.path.join(run_dir, "models")
    policy = post_run.load_policy(raw, models, report["checkpoint"], "cuda")
    envs = {}
    for tag, dataset, seed in fams:
        env = post_run.family_env(env_cfg, raw, dataset, seed, "cuda")
        envs[tag] = env
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = evaluation.evaluate(env, policy, POINT_STRIDE,
                                    compute_accuracy=False)
        t_plain = time.perf_counter() - t0
        t0 = time.perf_counter()
        full = evaluation.evaluate(env, policy, POINT_STRIDE)
        t_full = time.perf_counter() - t0
        # the scan does not disturb the env, and the report is reproducible
        for key, value in (("final_coverage", plain.mean_final_coverage),
                           ("mean_AUC", plain.mean_auc),
                           ("mean_reward", plain.mean_reward)):
            if round(value, 4) != report[tag][key]:
                raise AssertionError(f"report: {tag} {key} {value} without the "
                                     f"scan, {report[tag][key]} in the report")
        if post_run.family_report(full) != report[tag]:
            raise AssertionError(f"report: {tag} differs on a second run")
        print(f"report: {tag}: {report[tag]}; evaluate {t_full:.3f} s with the "
              f"accuracy scan, {t_plain:.3f} s without [{card}]")
    pieces = _report_pieces(card, envs["held_out_houses"], policy, report)

    # play: the PLY, the OBJ and the exported policy, on the card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_play_") as d:
        out = {k: os.path.join(d, f"recon.{k}") for k in ("ply", "obj")}
        exported = os.path.join(d, "policy.pt2")
        t0 = time.perf_counter()
        play.main(["--ckpt", os.path.join(models, report["checkpoint"]),
                   "--ply", out["ply"], "--obj", out["obj"],
                   "--export", exported, "--device", "cuda"]
                  + post_run.play_overrides(raw, EVAL_HW))
        t_play = time.perf_counter() - t0
        with open(out["ply"]) as f:
            n_pts = int(f.read().splitlines()[2].split()[-1])
        with open(out["obj"]) as f:
            n_faces = sum(line.startswith("f ") for line in f)
        if n_pts == 0 or n_faces == 0:
            raise AssertionError(f"play: {n_pts} PLY points, {n_faces} OBJ faces")
        env = envs["held_out_houses"]
        _, reset_out = env.reset(env.cfg.num_envs)
        policy.eval()
        with torch.no_grad():
            eager = distributions.mode(policy(reset_out.obs).logits)
        got = play.load_exported_policy(exported)(reset_out.obs)
        if not torch.equal(got, eager):
            raise AssertionError("play: the exported policy's actions differ "
                                 "from the eager policy's")
    print(f"play: --ply ({n_pts} points), --obj ({n_faces} faces) and --export "
          f"in {t_play:.3f} s; the loaded torch.export program's actions equal "
          f"the eager policy's on a {tuple(reset_out.obs.shape)} observation "
          f"batch [{card}]")
    return counts, pieces


def dda_config(carve_mode: str, mode: str = "dda") -> config.EnvConfig:
    """The flagship rollout's env (256 envs, 128x128, R=64) on the ray
    march or an external depth feed, with the given carve."""
    cfg = flagship_config()
    return dataclasses.replace(cfg, carve_mode=carve_mode,
                               renderer=dataclasses.replace(cfg.renderer,
                                                            mode=mode))


def dda_expect(carve_mode: str) -> dict:
    """Each kernel's launches a step of the DDA, replay and callback paths:
    the hit scatter once; the gather of the depth and of the hit mask with
    the z-test carve, none with Bresenham's; no splat."""
    return {"gather_image": 2 if carve_mode == "ztest" else 0,
            "scatter_cells_any": 1, "zbuf_visible": 0}


def _step_counted(env, state, actions, expect: dict, label: str):
    before = launches()
    state, out = env.step(state, actions)
    got = {k: v - before[k] for k, v in launches().items()}
    if got != expect:
        raise AssertionError(f"{label}: a step launched {got}, expected {expect}")
    return state, out


def _same_step(label, a, b, gray_tol: float = 0.0) -> float:
    """Raises unless two (state, StepOutput) pairs are equal: every field
    bit for bit, the grayscale frames (rgb_buf, the obs tail) within
    gray_tol.  Returns the largest grayscale difference."""
    (sa, oa), (sb, ob) = a, b
    n_state = 600 + G ** 3
    gray = 0.0
    for name, x, y in [*((f"out.{f}", getattr(oa, f), getattr(ob, f))
                         for f in oa._fields),
                       *((f"state.{f}", getattr(sa, f), getattr(sb, f))
                         for f in sa._fields)]:
        x, y = x.cpu(), y.cpu()
        if name == "out.obs":
            gray = max(gray, float((x[:, n_state:] - y[:, n_state:]).abs().max()))
            x, y = x[:, :n_state], y[:, :n_state]
        elif name == "state.rgb_buf":
            gray = max(gray, float((x - y).abs().max()))
            continue
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: {name} differs")
    if gray > gray_tol:
        raise AssertionError(f"{label}: grayscale frames differ by {gray}")
    return gray


def _first_envs(x: torch.Tensor, k: int = CPU_ENVS) -> torch.Tensor:
    return x[:k].clone()


def drive_dda(card: str, scenes, policy, carve_mode: str):
    """Reset + DDA_STEPS steps of the 256-env DDA env with actions from
    the policy, timed; returns (actions [T, N, 6], poses [N, T + 1, 6] of
    each env's views, the first CPU_ENVS envs' (state, out) after reset
    and each step, the env)."""
    cfg = dda_config(carve_mode)
    env = ReconEnv(cfg, scenes)
    expect = dda_expect(carve_mode)
    gen = torch.Generator(device="cuda").manual_seed(5)
    env.reset(N_ENVS)                                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state, out = env.reset(N_ENVS)
    counts = launches()
    if counts != expect:
        raise AssertionError(f"dda {carve_mode}: reset launched {counts}")
    keep = [tuple(type(x)(*map(_first_envs, x)) for x in (state, out))]
    # the obs opens with the pose history; its last pose is the step's view
    end = cfg.pose_buf_len * spec.ACTION_DIM
    poses, acts = [out.obs[:, end - spec.ACTION_DIM:end]], []
    with torch.no_grad():
        for t in range(DDA_STEPS):
            a, _, _ = policy.act(out.obs, gen)
            state, out = _step_counted(env, state, a, expect,
                                       f"dda {carve_mode} step {t}")
            acts.append(a)
            poses.append(out.obs[:, end - spec.ACTION_DIM:end])
            keep.append(tuple(type(x)(*map(_first_envs, x))
                              for x in (state, out)))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for name, x in out._asdict().items():
        if x.is_floating_point() and not torch.isfinite(x).all():
            raise AssertionError(f"dda {carve_mode}: non-finite {name}")
    assert ((out.coverage >= 0) & (out.coverage <= 1)).all()
    assert (out.coverage > 0).any(), "the cameras see the houses"
    print(f"dda {carve_mode}: reset + {DDA_STEPS} steps x {N_ENVS} envs at "
          f"{HW}x{HW}, R={RES} in {secs:.3f} s = "
          f"{N_ENVS * (1 + DDA_STEPS) / secs:.1f} env-steps/s [{card}]; mean "
          f"coverage at the last step {float(out.coverage.mean()):.4f}; "
          f"launches a step {expect}; peak memory {peak / 2 ** 30:.2f} GiB")
    return (torch.stack(acts), torch.stack(poses, 1), keep, env,
            {k: v * (1 + DDA_STEPS) for k, v in expect.items()})


def _cpu_scenes(scenes, k: int = CPU_ENVS):
    """The first k scenes of a SceneSet, on the CPU."""
    return scene_lib.SceneSet(
        *(getattr(scenes, f)[:k].cpu() for f in scene_lib.SceneSet._fields[:-2]),
        grid_res=scenes.grid_res, grid_size=scenes.grid_size)


def check_dda_on_cpu(carve_mode: str, scenes, actions, keep) -> float:
    """The first CPU_ENVS envs through the port on the CPU with the card
    run's actions: every step's outputs and states equal the card's."""
    env = ReconEnv(dataclasses.replace(dda_config(carve_mode),
                                       num_envs=CPU_ENVS), _cpu_scenes(scenes))
    state, out = env.reset(CPU_ENVS)
    gray = _same_step(f"dda {carve_mode} reset, card vs CPU", keep[0],
                      (state, out), 1e-4)
    for t in range(DDA_STEPS):
        state, out = env.step(state, actions[t, :CPU_ENVS].cpu())
        gray = max(gray, _same_step(f"dda {carve_mode} step {t}, card vs CPU",
                                    keep[t + 1], (state, out), 1e-4))
    return gray


def _profile_dda_pieces(card: str, env, actions) -> dict:
    """Device time and activities of one DDA step and of its ray march and
    Bresenham carve alone (torch.profiler), on the last step's inputs."""
    sc = env.scenes
    state, out = env.reset(N_ENVS)
    a = actions[-1]
    step = profile(f"dda {env.cfg.carve_mode}: one env step",
                   lambda: env.step(state, a))
    poses = fp32.fma(a.float(), env.action_unit, env.pose_low)
    r, t = camera.pose_to_c2w(poses, env.cfg.camera.z_offset)
    sid = state.scene_id
    march = profile("dda: the ray march of one step", lambda: render.render_depth(
        sc.render_occ[sid], sc.box_lo[sid], sc.box_hi[sid], env.cam_rays, r, t,
        sc.grid_res, 3 * sc.grid_res, env.cfg.camera.depth_max))
    res = {"step": step, "march": march}
    if env.cfg.carve_mode == "bresenham":
        gen = torch.Generator(device="cuda").manual_seed(0)
        hit = (torch.rand(state.tri_grid.shape, device="cuda", generator=gen)
               < 0.05).float()
        cam_voxel = voxel.pose_to_voxel_idx(poses[:, :3], sc.range_gt[sid],
                                            sc.voxel_size[sid])
        res["carve"] = profile(
            "dda: the Bresenham carve of one step (5% of cells hit)",
            lambda: carve.carve_bresenham(hit, cam_voxel, G))
    return res


def phase_dda(card: str, scenes) -> dict:
    """renderer.mode=dda with both carves, then replay and callback, at
    full width; returns each kernel's launches by run."""
    policy = ActorCriticPolicy(config.ModelConfig(),
                               torch.Generator(device="cuda").manual_seed(1))
    policy.eval()
    counts, runs = {}, {}
    for carve_mode in ("ztest", "bresenham"):
        actions, poses, keep, env, counts[f"dda_{carve_mode}"] = drive_dda(
            card, scenes, policy, carve_mode)
        t0 = time.perf_counter()
        gray = check_dda_on_cpu(carve_mode, scenes, actions, keep)
        print(f"dda {carve_mode}: envs 0-{CPU_ENVS - 1} equal the port on the "
              f"CPU over reset + {DDA_STEPS} steps, every output and state "
              f"field bit for bit but the grayscale frames "
              f"({'also bit for bit' if gray == 0 else f'max diff {gray:.3g}'}) "
              f"({time.perf_counter() - t0:.1f} s)")
        pieces = _profile_dda_pieces(card, env, actions)
        runs[carve_mode] = (actions, poses, env)
        print(f"dda {carve_mode}: a step {pieces['step']['busy_ms']:.3f} ms of "
              f"device time in {pieces['step']['activities']} activities; the "
              f"ray march {pieces['march']['busy_ms']:.3f} ms in "
              f"{pieces['march']['activities']}"
              + (f"; the Bresenham carve {pieces['carve']['busy_ms']:.3f} ms in "
                 f"{pieces['carve']['activities']}" if "carve" in pieces else "")
              + f" [{card}]")

    # replay and callback over the frames of the ztest run's views
    actions, poses, dda_env = runs["ztest"]
    t0 = time.perf_counter()
    bank = record_replay_bank(scenes, dda_env.cfg.camera, poses)
    replay = ReplayDepthSource(bank)
    thr = dda_env.cfg.camera.depth_max * (1.0 - 1e-4)
    far_hits = int((bank.fg & (bank.frames >= thr)).sum())

    def host_render(sids, p):
        d, _ = replay.render_batch(torch.from_numpy(sids).cuda(),
                                   torch.from_numpy(p).cuda())
        return d.cpu().numpy()

    envs = {
        "dda": dda_env,
        "replay": ReconEnv(dda_config("ztest", "replay"), scenes, replay),
        "callback": ReconEnv(dda_config("ztest", "callback"), scenes,
                             CallbackDepthSource(host_render, HW, HW,
                                                 dda_env.cfg.camera.depth_max)),
    }
    # the callback derives foreground from the depth: where the ray march
    # hit at or beyond depth_max (1 - 1e-4) it differs from the hit mask,
    # so it is held to a replay bank whose mask is derived alike
    if far_hits:
        envs["derived"] = ReconEnv(
            dda_config("ztest", "replay"), scenes, ReplayDepthSource(
                ReplayBank(bank.poses, bank.frames, bank.frames < thr)))
    expect = dda_expect("ztest")
    reset_launches()
    trace = {name: env.reset(N_ENVS) for name, env in envs.items()}
    for t in range(DDA_STEPS + 1):
        _same_step(f"replay vs dda, step {t}", trace["replay"], trace["dda"])
        _same_step(f"callback, step {t}", trace["callback"],
                   trace["derived" if far_hits else "dda"])
        if t == DDA_STEPS:
            break
        trace = {name: _step_counted(env, trace[name][0], actions[t], expect,
                                     f"{name} step {t}")
                 for name, env in envs.items()}
    per_env = {k: v * (1 + DDA_STEPS) for k, v in expect.items()}
    if launches() != {k: v * len(envs) for k, v in per_env.items()}:
        raise AssertionError(f"replay/callback run launched {launches()}")
    counts["replay"] = counts["callback"] = per_env
    print(f"replay: a bank of {poses.shape[1]} views of each of "
          f"{scenes.num_scenes} scenes recorded by the card's DDA; the replay "
          f"env equals the dda env bit for bit over reset + {DDA_STEPS} steps, "
          f"and the callback env equals "
          f"{'a replay env with the mask derived from the depth' if far_hits else 'the dda env'} "
          f"({far_hits} hits at or beyond depth_max (1 - 1e-4)) "
          f"({time.perf_counter() - t0:.1f} s) [{card}]")
    return counts


def phase_convert(root: str) -> dict:
    """N_MESHES procedural houses of seed 0 and the eval's 50 of its seed,
    meshed into OBJs under root by the native mesher and converted by the
    port's convert_dataset; returns {"train"/"held_out": directory}."""
    dirs, t_mesh, t_conv = {}, 0.0, 0.0
    for tag, n, seed in (("train", N_MESHES, 0),
                         ("held_out", spec.EVAL_NUM_ENVS, EVAL_SEED)):
        t0 = time.perf_counter()
        meshes = os.path.join(root, f"meshes_{tag}")
        convert_dataset.write_procedural_meshes(meshes, n, seed, RES)
        t1 = time.perf_counter()
        dirs[tag] = os.path.join(root, tag)
        convert_dataset.convert(meshes, dirs[tag], RES, G, 1.0, verbose=False)
        t_mesh += t1 - t0
        t_conv += time.perf_counter() - t1
    print(f"dataset: {N_MESHES} + {spec.EVAL_NUM_ENVS} houses meshed into "
          f"OBJs in {t_mesh:.1f} s and converted at R={RES} in {t_conv:.1f} s "
          f"({os.cpu_count()} CPUs)")
    return dirs


def phase_dataset(card: str, dirs: dict, root: str) -> dict:
    """Training on the converted scenes with the held-out directory as the
    eval dataset, then post_run's held-out family; returns each kernel's
    launches by run."""
    with open(FLAGSHIP) as f:
        raw = json.load(f)

    def leaves(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            elif f"{prefix}{k}" not in ("runner.log_dir",
                                        "runner.experiment_name"):
                yield f"{prefix}{k}={v}"

    log_dir = os.path.join(root, "runs")
    argv = ["--device", "cuda", "--log_dir", log_dir, "--exp_name", "dataset",
            "--eval_dataset", dirs["held_out"]]
    for leaf in (*leaves(raw, ""), f"env.scene.dataset={dirs['train']}",
                 f"ppo.total_iters={DATASET_ITERS}",
                 f"runner.eval_freq={DATASET_ITERS}",
                 f"runner.save_freq={DATASET_ITERS}"):
        argv += ["--set", leaf]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    train_eval_gennbv.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    train_counts = launches()
    peak = torch.cuda.max_memory_allocated()
    (run,) = os.listdir(log_dir)
    run_dir = os.path.join(log_dir, run)
    with open(os.path.join(run_dir, "config.json")) as f:
        recorded = json.load(f)
    if recorded.get("eval_dataset") != os.path.abspath(dirs["held_out"]):
        raise AssertionError(f"config.json records eval_dataset "
                             f"{recorded.get('eval_dataset')!r}")
    # setup reset, 128 steps an iteration, one eval (reset + 30 steps)
    n_steps = recorded["ppo"]["n_steps"]
    expect = {name: 1 + DATASET_ITERS * n_steps + 1 + spec.MAX_EPISODE_LENGTH_EVAL
              for name in KERNELS}
    if train_counts != expect:
        raise AssertionError(f"dataset training launched {train_counts}, "
                             f"expected {expect}")
    logged = read_logged(run_dir)
    for rec in logged:
        for k in _METRIC_KEYS:
            if not math.isfinite(rec[k]):
                raise AssertionError(f"dataset training: non-finite {k}")
    assert math.isfinite(logged[-1]["eval/final_coverage"])
    train_q = scene_lib.load_npz(os.path.join(dirs["train"], "scenes.npz"),
                                 "cpu").surf_pts.shape[1]
    for rec in logged:
        print(f"dataset: iteration {rec['step']}"
              f"{' (warm-up)' if rec['step'] == 1 else ''}: "
              f"{rec['time/iter_seconds']:.3f} s = rollout "
              f"{rec['time/rollout']:.3f} + update {rec['time/update']:.3f} s; "
              f"{rec['time/fps']:.1f} env-steps/s [{card}]")
    print(f"dataset: train_eval_gennbv on {N_MESHES} converted scenes "
          f"(Q={train_q}), eval on {dirs['held_out']} under {EVAL_HW}x{EVAL_HW} "
          f"(final coverage {logged[-1]['eval/final_coverage']:.4f}) in "
          f"{secs:.3f} s; peak memory {peak / 2 ** 30:.2f} GiB [{card}]")

    reset_launches()
    t0 = time.perf_counter()
    report = post_run.main([run_dir, "--eval_cam", str(EVAL_HW), "--only",
                            "held_out_houses", "--no-artifacts"])
    t_report = time.perf_counter() - t0
    report_counts = launches()
    expect = {name: 1 + spec.MAX_EPISODE_LENGTH_EVAL for name in KERNELS}
    if report_counts != expect:
        raise AssertionError(f"dataset post_run launched {report_counts}, "
                             f"expected {expect}")
    if (report["held_out_dataset"], report["eval_cam"]) != (
            os.path.abspath(dirs["held_out"]), EVAL_HW):
        raise AssertionError(f"post_run's held-out family ran on "
                             f"{report['held_out_dataset']!r}")
    fam = report["held_out_houses"]
    if not all(math.isfinite(v) for v in fam.values()):
        raise AssertionError(f"dataset post_run: non-finite {fam}")
    held_q = scene_lib.load_npz(os.path.join(dirs["held_out"], "scenes.npz"),
                                "cpu").surf_pts.shape[1]
    print(f"dataset: post_run --eval_cam {EVAL_HW} took its held-out family "
          f"from config.json ({held_q=}): final coverage "
          f"{fam['final_coverage']}, accuracy {fam['mean_accuracy_x100m2']} "
          f"in {t_report:.3f} s [{card}]")
    return {"dataset_train": train_counts, "dataset_report": report_counts}


def rsl_args(log_dir: str, iters: int, *extra: str) -> list:
    """train_rsl's arguments at the CLI's full width on the drone."""
    return ["--task", "drone_velocity", "--num_envs", str(RSL_ENVS),
            "--num_steps_per_env", str(RSL_STEPS),
            "--hidden", *map(str, RSL_HIDDEN), "--max_iterations", str(iters),
            "--log_dir", log_dir, "--save_interval", "1", *extra]


def check_rsl_logged(card: str, logged: list, cfg) -> None:
    """Every metric finite, the learning rate in [min_lr, max_lr]; prints
    each iteration's rates."""
    steps = RSL_ENVS * RSL_STEPS
    for rec in logged:
        for k in on_policy_runner.METRIC_KEYS:
            if not math.isfinite(rec[k]):
                raise AssertionError(f"rsl: non-finite {k} at iteration "
                                     f"{rec['step']}")
        # the learning rate is float32, clamped to the bounds in float32
        if not (np.float32(cfg.min_lr) <= np.float32(rec["learning_rate"])
                <= np.float32(cfg.max_lr)):
            raise AssertionError(f"rsl: learning rate {rec['learning_rate']} "
                                 f"at iteration {rec['step']}")
        print(f"rsl: iteration {rec['step']}: {rec['time/iter_seconds']:.4f} s "
              f"= rollout + GAE {rec['time/rollout']:.4f} s "
              f"({steps / rec['time/rollout']:.1f} env-steps/s) + update "
              f"{rec['time/update']:.4f} s (+ fetch); {rec['time/fps']:.1f} "
              f"env-steps/s; reward {rec['mean_reward']:+.5f}, kl "
              f"{rec['mean_kl']:.5f}, lr {rec['learning_rate']:.6g} [{card}]")


def resume_rsl(card: str, log_dir: str, first) -> None:
    """train_rsl --resume to RSL_ITERS + 1: raises unless it starts at
    iteration RSL_ITERS from the parameters and optimizer state saved
    there, which are the first run's."""
    at_start = {}
    learn = on_policy_runner.OnPolicyRunner.learn

    def spy(runner, *args, **kw):
        at_start.update(iteration=runner.iteration, snap=snapshot(runner, []),
                        lr=runner.opt_state.learning_rate.clone())
        return learn(runner, *args, **kw)

    on_policy_runner.OnPolicyRunner.learn = spy
    try:
        resumed = train_rsl.main(rsl_args(log_dir, RSL_ITERS + 1, "--resume"))
    finally:
        on_policy_runner.OnPolicyRunner.learn = learn
    if at_start["iteration"] != RSL_ITERS or resumed.iteration != RSL_ITERS + 1:
        raise AssertionError(f"rsl: resumed at {at_start['iteration']}, "
                             f"ended at {resumed.iteration}")
    diff = first_difference(snapshot(first, []), at_start["snap"])
    saved = torch.load(os.path.join(log_dir, f"model_{RSL_ITERS}.pt"),
                       map_location="cuda", weights_only=True)
    if diff or not torch.equal(at_start["lr"], first.opt_state.learning_rate) \
            or any(not torch.equal(v, saved["params"][k])
                   for k, v in at_start["snap"]["variables"].items()):
        raise AssertionError(f"rsl: the resumed runner differs from "
                             f"model_{RSL_ITERS}.pt ({diff})")
    if [r["step"] for r in read_logged(log_dir)] != list(range(1, RSL_ITERS + 2)):
        raise AssertionError("rsl: the resumed run's log")
    print(f"rsl: --resume loaded model_{RSL_ITERS}.pt: iteration {RSL_ITERS}, "
          "the saved parameters and optimizer state bit for bit; ran to "
          f"{resumed.iteration} [{card}]")


def reproduce_rsl(card: str) -> None:
    """Two OnPolicyRunners from seed 1 at phase 11's width end 2 iterations
    with the same parameters, optimizer state and logged metrics (but
    time/*), bit for bit."""
    snaps = []
    for _ in range(2):
        log_dir = tempfile.mkdtemp(prefix="chip_smoke_rsl_repro_")
        try:
            runner = on_policy_runner.OnPolicyRunner(
                DroneRobot(), ppoc.ContinuousPPOConfig(),
                on_policy_runner.OnPolicyRunnerConfig(
                    num_steps_per_env=RSL_STEPS, save_interval=0),
                num_envs=RSL_ENVS, log_dir=log_dir, seed=1,
                actor_hidden=RSL_HIDDEN, critic_hidden=RSL_HIDDEN)
            runner.learn(2, log=True)
            snaps.append(snapshot(runner, read_logged(log_dir)))
        finally:
            shutil.rmtree(log_dir, ignore_errors=True)
    diff = first_difference(*snaps)
    if diff:
        raise AssertionError(f"rsl: a second OnPolicyRunner from seed 1 "
                             f"differs first in {diff}")
    print("rsl: two OnPolicyRunners from seed 1 end 2 iterations with the "
          "same parameters, optimizer state and logged metrics (but time/*), "
          f"bit for bit [{card}]")


def drone_on_cpu(card: str, runner) -> None:
    """RSL_CPU_ENVS drones from a fresh spawn on the card, copied to the
    CPU, stepped RSL_CPU_STEPS times on both with the same actions, drawn
    uniformly in +-0.3 as tests/test_torch_drone.py's are (a policy of a
    few iterations flips most drones within 8 steps).  At each step the
    CPU's copy of the trained policy must give the card's mean actions on
    the same observations within MLP_RTOL/ATOL, and the CPU's drones the
    card's step outputs and states within DRONE_RTOL/ATOL.  A drone whose
    episode ends is re-spawned from its device's generator, which draws
    differently on the two devices, so it leaves the comparison after that
    step's outputs; three quarters of the drones must stay in it to the
    end."""
    env = runner.env
    cpu_env = DroneRobot(env.cfg, device="cpu")
    cpu_model = GaussianActorCritic(env.obs_dim, env.num_actions, RSL_HIDDEN,
                                    RSL_HIDDEN, device="cpu")
    cpu_model.load_state_dict(runner.model.state_dict())
    policy = runner.get_inference_policy()
    state, out = env.reset(RSL_CPU_ENVS,
                           torch.Generator(device="cuda").manual_seed(5))
    cs = state._replace(**{f: getattr(state, f).cpu() for f in state._fields
                           if f != "rng"},
                        rng=torch.Generator().manual_seed(5).get_state())
    co_obs = out.obs.cpu()
    live = torch.ones(RSL_CPU_ENVS, dtype=torch.bool)
    worst = {"actions": 0.0, "state": 0.0, "obs": 0.0, "reward": 0.0}

    def held(label, got, want, rtol, atol, key):
        got, want = got[live], want.cpu()[live]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"rsl: {label}")
        worst[key] = max(worst[key], float((got - want).abs().max()))

    draws = torch.Generator().manual_seed(6)
    for k in range(RSL_CPU_STEPS):
        with torch.no_grad():
            held(f"the policy on the CPU at step {k}", cpu_model(co_obs).mean,
                 policy(out.obs), MLP_RTOL, MLP_ATOL, "actions")
        actions = 0.6 * torch.rand(RSL_CPU_ENVS, env.num_actions,
                                   generator=draws) - 0.3
        state, out = env.step(state, actions.cuda())
        cs, co = cpu_env.step(cs, actions)
        if not torch.equal(co.done[live], out.done.cpu()[live]):
            raise AssertionError(f"rsl: done differs at step {k}")
        held(f"obs at step {k}", co.obs, out.obs, DRONE_RTOL, DRONE_ATOL, "obs")
        held(f"reward at step {k}", co.reward, out.reward, DRONE_RTOL, 1e-6,
             "reward")
        live &= ~co.done
        for f in ("pos", "quat", "lin_vel", "ang_vel", "rotor_vel",
                  "ep_reward"):
            held(f"{f} at step {k}", getattr(cs, f), getattr(state, f),
                 DRONE_RTOL, DRONE_ATOL, "state")
        co_obs = co.obs
    if live.sum() < 3 * RSL_CPU_ENVS // 4:
        raise AssertionError(f"rsl: only {int(live.sum())} drones flew "
                             f"{RSL_CPU_STEPS} steps")
    print(f"rsl: {RSL_CPU_ENVS} drones x {RSL_CPU_STEPS} steps on the CPU from "
          f"the card's state agree with the card ({int(live.sum())} flew all "
          "steps): max abs differences "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" [{card}]")


def profile_rsl(card: str, runner) -> None:
    """One iteration of the runner at full width (rollout, GAE, update),
    timed and then under the profiler: the device-busy share and device
    activities per env step (one step of all RSL_ENVS drones)."""
    state, out = runner.env.reset(RSL_ENVS, runner.generator)
    obs = out.obs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, obs, metrics = runner._train_iteration(state, obs)
    metrics.tolist()
    secs = time.perf_counter() - t0
    res = profile(f"rsl: an iteration ({RSL_STEPS} steps of {RSL_ENVS} drones, "
                  "the update)", lambda: runner._train_iteration(state, obs)[2]
                  .tolist(), secs)
    print(f"rsl: {res['activities'] / RSL_STEPS:.1f} device activities per env "
          f"step, device busy {res['busy_ms']:.3f} ms of the {secs * 1e3:.3f} ms "
          f"unprofiled iteration [{card}]")
    rollout_res = profile(f"rsl: a rollout ({RSL_STEPS} steps)",
                          lambda: runner._rollout(state, obs))
    print(f"rsl: rollout {rollout_res['activities'] / RSL_STEPS:.1f} device "
          f"activities and {rollout_res['busy_ms'] / RSL_STEPS:.3f} ms device "
          f"time per env step [{card}]")


def phase_rsl(card: str) -> dict:
    """train_rsl on the drone at the CLI's full width, a resume, a second
    runner from the seed, the CPU against the card and the profile;
    returns each kernel's launches in the training run (all 0)."""
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_rsl_")
    try:
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = train_rsl.main(rsl_args(log_dir, RSL_ITERS))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launches()
        peak = torch.cuda.max_memory_allocated()
        if any(counts.values()):
            raise AssertionError(f"rsl launched {counts}, expected none")
        cfg = first.alg_cfg
        assert (cfg.num_learning_epochs, cfg.num_mini_batches, cfg.desired_kl,
                first.device.type) == (5, 4, 0.01, "cuda")
        logged = read_logged(log_dir)
        if [r["step"] for r in logged] != list(range(1, RSL_ITERS + 1)):
            raise AssertionError("rsl: logged iterations")
        check_rsl_logged(card, logged, cfg)
        print(f"rsl: train_rsl {RSL_ITERS} iterations of {RSL_ENVS} envs x "
              f"{RSL_STEPS} steps, update 5 x 4 minibatches of "
              f"{RSL_ENVS * RSL_STEPS // 4} rows, in {secs:.3f} s with the "
              f"saves; peak memory {peak / 2 ** 30:.3f} GiB [{card}]")
        resume_rsl(card, log_dir, first)
        reproduce_rsl(card)
        drone_on_cpu(card, first)
        profile_rsl(card, first)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    return counts


def phase_cache_pairs(card: str, scenes, pairs: int) -> None:
    """The full-size eval with the init-view cache (zbuf_impl=pallas) and
    without it (mxu), the same kernels on both, in interleaved pairs."""
    policy = ActorCriticPolicy(config.ModelConfig(),
                               torch.Generator(device="cuda").manual_seed(1))
    envs = {impl: ReconEnv(eval_config(impl), scenes) for impl in ("pallas", "mxu")}
    n_env_steps = spec.EVAL_NUM_ENVS * (1 + envs["pallas"].cfg.max_episode_length)
    for env in envs.values():                      # warm-up
        evaluation.evaluate(env, policy, compute_accuracy=False)
    rates = {impl: [] for impl in envs}
    for pair in range(pairs):
        for impl in (("pallas", "mxu") if pair % 2 == 0 else ("mxu", "pallas")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluation.evaluate(envs[impl], policy, compute_accuracy=False)
            rates[impl].append(n_env_steps / (time.perf_counter() - t0))
    for impl, r in rates.items():
        q = statistics.quantiles(r, n=4)
        print(f"cache A/B, {impl} ({'with' if impl == 'pallas' else 'without'} "
              f"the init-view cache): {pairs} runs, median "
              f"{statistics.median(r):.1f} env-steps/s, quartiles {q[0]:.1f} / "
              f"{q[2]:.1f} [{card}]: {', '.join(f'{x:.1f}' for x in r)}")
    wins = sum(p > m for p, m in zip(rates["pallas"], rates["mxu"]))
    print(f"cache A/B: with the cache faster in {wins} of {pairs} pairs")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cache-pairs", type=int, default=0,
                        help="run only this many interleaved pairs of the "
                        "eval with and without the init-view cache")
    args = parser.parse_args()
    card = phase_device()
    t_start = time.perf_counter()
    phase_build()
    eval_scenes = make_path_scenes(eval_config("pallas"), "held-out")
    if args.cache_pairs:
        phase_cache_pairs(card, eval_scenes, args.cache_pairs)
        return
    rollout_scenes = make_path_scenes(flagship_config(), "flagship")
    data_root = tempfile.mkdtemp(prefix="chip_smoke_dataset_")
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        dirs = phase_convert(data_root)
        dataset_scenes = {
            "dataset": (scene_lib.load_npz(
                os.path.join(dirs["train"], "scenes.npz")), HW),
            "dataset_held_out": (scene_lib.load_npz(
                os.path.join(dirs["held_out"], "scenes.npz")), EVAL_HW)}
        timing = phase_kernels(eval_scenes, rollout_scenes, dataset_scenes)
        del dataset_scenes
        phase_golden()
        rollout_counts, rollout_ms = phase_rollout(card, rollout_scenes)
        eval_counts, eval_ms = phase_eval(card, eval_scenes)
        train_counts = phase_train(card, rollout_scenes, eval_scenes, run_dir)
        report_counts, _ = phase_report(card, run_dir)
        dda_counts = phase_dda(card, rollout_scenes)
        dataset_counts = phase_dataset(card, dirs, data_root)
        rsl_counts = phase_rsl(card)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        shutil.rmtree(data_root, ignore_errors=True)
    by_path = {"rollout": rollout_counts, "eval": eval_counts,
               "train": train_counts, "report": report_counts, **dda_counts,
               **dataset_counts, "rsl": rsl_counts}
    kernels = []
    for name, (source, replaces, _) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            # times at the eval's shapes; the rollout's beside them
            **timing[name]["eval"],
            # the profiler's device time per call in each path's run
            "device_ms": eval_ms[name],
            "rollout": {**timing[name]["rollout"],
                        "device_ms": rollout_ms[name]},
            # phase 3 at the DDA step's and the converted scenes' shapes
            **{path: t for path, t in timing[name].items()
               if path not in ("eval", "rollout")}})
    print(f"profiler: at most {PADS_LOST['leading']} leading and "
          f"{PADS_LOST['trailing']} trailing of the {PROFILE_PADS} pads on "
          "each side of a profiled run lost")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the device "
          "check")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
